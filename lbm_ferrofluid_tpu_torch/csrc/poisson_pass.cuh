// The pass of B11b's channel-form Poisson sweeps, shared by its kernels:
// the walk of k sweep stages over an (x, y) tile and a z chunk and, with
// TRAIL, B7's trailing stage (emit="hint" and emit="h2").  csrc/poisson.cu
// instantiates the passes and the slab form and describes the design;
// csrc/poisson_trail.cu instantiates the trailing stage's pass, so the build
// compiles the two beside each other.
#pragma once
#include <type_traits>

#include "common.cuh"

#define PP_EX 32  // extended tile width
// floats a stage ring keeps a cell: 9 channels x 2 planes + 5 x 3 + 5 x 1
#define PP_RING 38
// planes of the trailing stage's psi and flags rings: the 3 its taps read
// and the one stage k fills beside it
#define PP_TRAIL_SLOTS 4
// the most shared memory a block may take on an H100
// (ops/kernels/poisson.py:SMEM_BLOCK_MAX), and the devices a process tracks
#define PP_SMEM_MAX 232448
#define PP_MAX_DEVICES 64

// The trailing stage's mode and constants: H2 (1 channel) or H_int (3), the
// z clamp, f32(-1 / (12 dx)), and h_ext rounded to float with its nonzero
// components.
struct LbmTrail {
  int h2, zlo, zhi;
  float m;
  float hx[3];
  int hnz[3];
};

// _GRAD_TAPS (lbm_ferrofluid_tpu/ops/pallas/stencil3d.py:47-57): per
// component, ten (z, y, x) offsets and weights, summed in this order.
#define LBM_GRAD_TAPS                                                                            \
  {{{0, 0, 1, 2}, {0, 0, -1, -2}, {1, 0, 1, 1}, {-1, 0, -1, -1}, {-1, 0, 1, 1},                 \
    {1, 0, -1, -1}, {0, 1, 1, 1}, {0, -1, -1, -1}, {0, -1, 1, 1}, {0, 1, -1, -1}},              \
   {{0, 1, 0, 2}, {0, -1, 0, -2}, {1, 1, 0, 1}, {-1, -1, 0, -1}, {-1, 1, 0, 1},                 \
    {1, -1, 0, -1}, {0, 1, 1, 1}, {0, -1, -1, -1}, {0, 1, -1, 1}, {0, -1, 1, -1}},              \
   {{1, 0, 0, 2}, {-1, 0, 0, -2}, {1, 1, 0, 1}, {-1, -1, 0, -1}, {1, -1, 0, 1},                 \
    {-1, 1, 0, -1}, {1, 0, 1, 1}, {-1, 0, -1, -1}, {1, 0, -1, 1}, {-1, 0, 1, -1}}}

// First channel plane of each channel group in a stage ring: channels
// 0..8 (e_z = 0) of plane p (p >= 0, counted from the block's first plane)
// in one of 2 slots, 9..13 (e_z = +1) in one of 3 slots, 14..18 (e_z = -1)
// in the only slot.
__device__ __forceinline__ int lbm_ring_z0(int p) { return (p % 2) * 9; }
__device__ __forceinline__ int lbm_ring_zp(int p) { return 18 + (p % 3) * 5; }
#define LBM_RING_ZM 33

// Channel q of a source whose groups (e_z = 0, +1, -1) start at g0, gp,
// gm: a compile-time offset from one of three pointers, so a load or store
// of it is one instruction with an immediate offset.
template <class T>
__device__ __forceinline__ T* lbm_group_channel(T* g0, T* gp, T* gm, int q, int plane) {
  return q < 9 ? g0 + q * plane : (q < 14 ? gp + (q - 9) * plane : gm + (q - 14) * plane);
}

// Tile width of a pass of k sweeps (a multiple of 8 floats, at most 32 -
// 2k) and the halo columns left of it in the extended tile.
__host__ __device__ __forceinline__ int lbm_pass_tx(int k) { return (PP_EX - 2 * k) / 8 * 8; }
__host__ __device__ __forceinline__ int lbm_pass_hx(int k) { return (PP_EX - lbm_pass_tx(k)) / 2; }

// Registers a thread holds for the input of a tick it has loaded ahead (h
// as stored).
template <class T>
struct LbmPassInput {
  T h[19];
  float rhs;
  uint8_t flag;
};

// The same in the trailing stage's pass, whose first and last warps also
// load the 5 channels that stage 1 reads of the halo row beside them.
template <class T>
struct LbmTrailInput : LbmPassInput<T> {
  T halo[5];
};

// EY is a template parameter, so every shared-memory offset of a channel
// is an immediate of the load or store instead of a multiply by the plane
// size, and the register bound follows the block's size; the host picks
// the instance (lbm_poisson_pass_instance).  T is h's storage type, which
// the input plane and the stage rings keep.  SLAB: the slab form (planes
// -G..-1 from glo and Z..Z + G - 1 from ghi, no wrap, the bands written to
// blo and bhi), its own kernel so that the one-device kernel's code is as
// it was.  TRAIL: the trailing stage writes H_int or H2 (tr) to psi_out in
// place of psi, on the geometry of a pass of k + 1 sweeps with a warp per
// row 0..EY - 1 (EY warps, not EY + 2: csrc/poisson.cu's header).  zblk is the
// block's z chunk (blockIdx.z, or its part of it where the launch folds a
// batch into gridDim.z: LBM_PASS_ELEM).
template <class T, bool TAU1, int EY, bool SLAB, bool TRAIL>
__device__ __forceinline__ void lbm_poisson_pass_body(
    const T* __restrict__ h, const uint8_t* __restrict__ flags, const float* __restrict__ rhs,
    T* __restrict__ out, float* __restrict__ psi_out, int Z, int Y, int X, int k, int LZ,
    float inv_tau, float a, const T* __restrict__ glo, const T* __restrict__ ghi, int G,
    T* __restrict__ blo, T* __restrict__ bhi, const LbmTrail& tr, int zblk) {
  // 4 elements of padding (edge lanes read one element before and after a
  // plane), the input plane (19 channels), the k - 1 stage rings, 4 more,
  // all in T; then, in float, the (k + 1)-plane rhs ring, the wrapped grid
  // x of the extended columns and y * X of the rows -1..EY, then the flags
  // ring; with TRAIL the final sweep's psi (float) and obstacle flags
  // (bytes) of PP_TRAIL_SLOTS planes.  Every channel plane of the input and
  // the rings holds rows -1..EY (PI elements, row e at (e + 1) * 32; the rings leave
  // rows -1 and EY unused), so each stage reads its source the same way.
  extern __shared__ float smem[];
  constexpr int P = PP_EX * EY, PI = PP_EX * (EY + 2);
  // the depth of the pass's geometry: the trailing stage is one more stage
  const int KG = TRAIL ? k + 1 : k;
  const int TX = lbm_pass_tx(KG), HX = lbm_pass_hx(KG), TY = EY - 2 * (KG - 1);
  T* inp = reinterpret_cast<T*>(smem) + 4;
  T* rings = inp + 19 * PI;
  float* rhr = reinterpret_cast<float*>(rings + (k - 1) * PP_RING * PI + 4);
  int* colx = reinterpret_cast<int*>(rhr + (k + 1) * P);
  int* rowy = colx + PP_EX;
  uint8_t* flr = reinterpret_cast<uint8_t*>(rowy + EY + 2);
  float* psr = reinterpret_cast<float*>(flr + (k + 1) * P);
  uint8_t* obr = reinterpret_cast<uint8_t*>(psr + PP_TRAIL_SLOTS * P);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int z0 = zblk * LZ, z1 = min(z0 + LZ, Z);
  const long long XY = static_cast<long long>(X) * Y, N = XY * Z, GN = XY * G;
  if (warp == 0) colx[lane] = lbm_mod(x0 - HX + lane, X);
  if (lane == 0) rowy[warp] = lbm_mod(y0 - KG + warp, Y) * X;  // a warp per row -1..EY
  // (TRAIL: a warp per row -1..EY - 2, the first warp rows EY - 1 and EY)
  if (TRAIL && warp == 0 && (lane == 1 || lane == 2))
    rowy[EY - 1 + lane] = lbm_mod(y0 - KG + EY - 1 + lane, Y) * X;
  __syncthreads();
  const int ex[19] = LBM_D3Q19_EX;
  const int ey[19] = LBM_D3Q19_EY;
  const int ez[19] = LBM_D3Q19_EZ;
  // plane p of the block is grid plane zb + p (wrapped); tick r runs stage
  // j at p = r - j + 1, over p in [j - 1, n_ticks - j + 1), so stage KG
  // covers [z0, z1) (with TRAIL the trailing stage, and stage k covers
  // [z0 - 1, z1 + 1))
  const int zb = z0 - KG + 1, n_ticks = z1 - z0 + 2 * KG - 2;

  // the warp's input row (row warp - 1 of the extended tile; with TRAIL row
  // warp) and, for rows 0..EY - 1, its cell of the flags and rhs plane, at
  // in-plane offsets of the grid
  const int in_row = TRAIL ? warp + 1 : warp;
  const int in_off = rowy[in_row] + colx[lane];
  const bool has_cell = TRAIL || (warp >= 1 && warp <= EY);
  // TRAIL: the halo row the first (last) warp also loads, row -1 (EY), and
  // its channels, those with e_y = +1 (-1), which stage 1 reads there
  const bool has_halo = TRAIL && (warp == 0 || warp == EY - 1);
  const int halo_row = warp == 0 ? 0 : EY + 1;
  const int halo_off = TRAIL ? rowy[halo_row] + colx[lane] : 0;
  // (both lists' e_z are 0, 0, 0, +1, -1: halo_ez, a compile-time index
  // where the channel is chosen at run time)
  constexpr int halo_up[5] = {2, 5, 6, 11, 16}, halo_dn[5] = {4, 7, 8, 13, 18};
  constexpr int halo_ez[5] = {0, 0, 0, 1, -1};
  // stage 1 reads the halo row above the extended tile only in the 5
  // channels with e_y = +1 and the row below only in those with e_y = -1
  auto needs = [&](int q) {
    if constexpr (TRAIL) return true;
    return warp == 0 ? ey[q] == 1 : (warp == EY + 1 ? ey[q] == -1 : true);
  };
  using Input = std::conditional_t<TRAIL, LbmTrailInput<T>, LbmPassInput<T>>;
  // the input of the tick whose stage 1 computes grid plane zr: channel q
  // of plane zr - e_z(q), flags and rhs of plane zr; on a slab, planes
  // -G..-1 of h from the lo band and Z..Z + G - 1 from the hi band, read in
  // place, and flags and rhs of plane zr + G of the extended pair
  auto fetch = [&](int zr, Input& b) {
    if constexpr (!SLAB) {
      const long long zc[3] = {(zr == 0 ? Z - 1 : zr - 1) * XY, zr * XY,
                               (zr == Z - 1 ? 0 : zr + 1) * XY};
#pragma unroll
      for (int q = 0; q < 19; ++q)
        if (needs(q)) b.h[q] = h[q * N + zc[1 - ez[q]] + in_off];
      if constexpr (TRAIL) {
        if (has_halo) {
#pragma unroll
          for (int i = 0; i < 5; ++i) {
            const int q = warp == 0 ? halo_up[i] : halo_dn[i];
            b.halo[i] = h[q * N + zc[1 - halo_ez[i]] + halo_off];
          }
        }
      }
      if (has_cell) {
        b.rhs = rhs[zc[1] + in_off];
        b.flag = flags[zc[1] + in_off];
      }
    } else {
      const T* base[3];
      long long cs[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const int p = zr - 1 + d;
        base[d] = p < 0 ? glo + (p + G) * XY : (p >= Z ? ghi + (p - Z) * XY : h + p * XY);
        cs[d] = p < 0 || p >= Z ? GN : N;
      }
#pragma unroll
      for (int q = 0; q < 19; ++q)
        if (needs(q)) b.h[q] = base[1 - ez[q]][q * cs[1 - ez[q]] + in_off];
      if constexpr (TRAIL) {
        if (has_halo) {
#pragma unroll
          for (int i = 0; i < 5; ++i) {
            const int q = warp == 0 ? halo_up[i] : halo_dn[i];
            b.halo[i] = base[1 - halo_ez[i]][q * cs[1 - halo_ez[i]] + halo_off];
          }
        }
      }
      if (has_cell) {
        const long long fz = (zr + G) * XY + in_off;
        b.rhs = rhs[fz];
        b.flag = flags[fz];
      }
    }
  };
  auto put = [&](int slot, const Input& b) {
#pragma unroll
    for (int q = 0; q < 19; ++q)
      if (needs(q)) inp[q * PI + in_row * PP_EX + lane] = b.h[q];
    if constexpr (TRAIL) {
      if (has_halo) {
#pragma unroll
        for (int i = 0; i < 5; ++i)
          inp[(warp == 0 ? halo_up[i] : halo_dn[i]) * PI + halo_row * PP_EX + lane] = b.halo[i];
      }
    }
    if (has_cell) {
      const int c = (in_row - 1) * PP_EX + lane;
      rhr[slot * P + c] = b.rhs;
      flr[slot * P + c] = b.flag;
    }
  };
  // whether this thread's cell of extended row e lies in the tile (with
  // TRAIL also the last grid column or row where the tile ends just before
  // it); its grid column and row
  const int xo = x0 + lane - HX;
  const bool col_in = lane >= HX && xo < X &&
                      (lane < HX + TX || (TRAIL && lane == HX + TX && xo == X - 1));
  auto row_in = [&](int e) {
    const int yo = y0 + e - (KG - 1);
    return e >= KG - 1 && yo < Y && (e < KG - 1 + TY || (TRAIL && e == KG - 1 + TY && yo == Y - 1));
  };

  // the trailing stage at block plane ps (grid plane zs = z0 + ps - k),
  // from the psi and flags rings' planes ps - 1, ps, ps + 1: a warp a row of
  // the tile and the row after it
  auto trail = [&](int ps) {
    const int zs = z0 + ps - k;
    // a plane off [zlo, zhi] is written by its source's stage
    if (zs < tr.zlo || zs > tr.zhi || warp > TY) return;
    const int e = k + warp, yo = y0 + warp;
    if (!col_in || !row_in(e)) return;
    // the source: the interior cell nearest to the output cell, at
    // extended row es and lane ls
    const int sy = max(min(yo, Y - 2), 1), sx = max(min(xo, X - 2), 1);
    const int cs = (e + sy - yo) * PP_EX + lane + sx - xo;
    // ring slots of planes zs - 1, zs, zs + 1, and of the planes the
    // substitution clamps them to
    const int sl[3] = {(ps - 1) % PP_TRAIL_SLOTS, ps % PP_TRAIL_SLOTS,
                       (ps + 1) % PP_TRAIL_SLOTS};
    const int sc[3] = {zs == tr.zlo ? sl[1] : sl[0], sl[1], zs == tr.zhi ? sl[1] : sl[2]};
    constexpr int taps[3][10][4] = LBM_GRAD_TAPS;
    float H[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < 10; ++t) {
        const int oz = taps[d][t][0], oy = taps[d][t][1], ox = taps[d][t][2];
        const int c = cs + oy * PP_EX + ox;
        float v = psr[sl[oz + 1] * P + c];
        if (obr[sl[oz + 1] * P + c]) {
          const int yy = sy + oy, xx = sx + ox;
          v = psr[sc[oz + 1] * P + c + (max(min(yy, Y - 2), 1) - yy) * PP_EX +
                  max(min(xx, X - 2), 1) - xx];
        }
        const float tp = __fmul_rn(static_cast<float>(taps[d][t][3]), v);
        acc = t == 0 ? tp : __fadd_rn(acc, tp);
      }
      H[d] = __fmul_rn(acc, tr.m);
    }
    float h2 = 0.f;
    if (tr.h2) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float tot = tr.hnz[d] ? __fadd_rn(H[d], tr.hx[d]) : H[d];
        const float sq = __fmul_rn(tot, tot);
        h2 = d == 0 ? sq : __fadd_rn(h2, sq);
      }
    }
    // the output planes whose source is zs: zs, and zs - 1 (zs + 1) where
    // zs is the clamp's lower (upper) end, within the chunk
    const long long ip = static_cast<long long>(yo) * X + xo;
    for (int zw = zs == tr.zlo ? max(zs - 1, z0) : zs;
         zw <= (zs == tr.zhi ? min(zs + 1, z1 - 1) : zs); ++zw) {
      const long long n = zw * XY + ip;
      if (tr.h2) {
        __stcs(psi_out + n, h2);
      } else {
#pragma unroll
        for (int d = 0; d < 3; ++d) __stcs(psi_out + d * N + n, H[d]);
      }
    }
  };

  // tick r, with rk = r % (k + 1) and zr its stage 1's grid plane (kept by
  // the loop, so no stage divides by a runtime value)
  auto tick = [&](int r, int rk, int zr, Input& b) {
    // tick r's input over what stage 1 read last tick, plane r's flags and
    // rhs into the slot of plane r - k - 1, which stage k read two ticks
    // ago; then tick r + 1's loads into the registers just emptied, in
    // flight while the stages compute
    put(rk, b);
    if (r + 1 < n_ticks) fetch(!SLAB && zr == Z - 1 ? 0 : zr + 1, b);
    __syncthreads();
    // the trailing stage one plane behind what stage k finished last tick,
    // beside stage 1: its planes are in the rings before this tick's
    // barrier, and stage k fills the ring's fourth slot (the same for the
    // whole block)
    if constexpr (TRAIL) {
      if (r - k - 1 >= k) trail(r - k - 1);
    }
    for (int j = 1; j <= k; ++j) {
      const int p = r - j + 1;
      if (p < j - 1 || p >= n_ticks - j + 1) continue;  // the same for the whole block
      // a warp a row: row e of [j - 1, EY - j + 1)
      const int e = j - 1 + warp;
      if (e < EY - j + 1) {
        const int c = e * PP_EX + lane, c1 = c + PP_EX;
        // the source's channel groups: the input plane for stage 1, else
        // stage j - 1's ring at planes p (e_z = 0), p - 1 (e_z = +1; (p +
        // 2) % 3 == (p - 1) % 3) and p + 1 (e_z = -1, made this tick)
        T* src = j == 1 ? inp : rings + (j - 2) * PP_RING * PI;
        T* g0 = src + (j == 1 ? 0 : lbm_ring_z0(p)) * PI + c1;
        T* gp = src + (j == 1 ? 9 : lbm_ring_zp(p + 2)) * PI + c1;
        T* gm = src + (j == 1 ? 14 : LBM_RING_ZM) * PI + c1;
        float s[19];
#pragma unroll
        for (int q = 0; q < 19; ++q)
          s[q] = lbm_ld(lbm_group_channel(g0, gp, gm, q, PI) - ey[q] * PP_EX - ex[q]);
        const int fs = (rk >= j - 1 ? rk - j + 1 : rk - j + 2 + k) * P + c;
        const bool obstacle = flr[fs] == LBM_OBSTACLE;
        // the sweep's outputs to stage j's ring, or (stage k) the tile's
        // cells inside the grid to device memory, each rounded to T
        auto finish = [&](const float(&o)[19], float psi) {
          if (j < k) {
            T* dst = rings + (j - 1) * PP_RING * PI + c1;
            T* d0 = dst + lbm_ring_z0(p) * PI;
            T* dp = dst + lbm_ring_zp(p) * PI;
            T* dm = dst + LBM_RING_ZM * PI;
#pragma unroll
            for (int q = 0; q < 19; ++q) lbm_st(lbm_group_channel(d0, dp, dm, q, PI), o[q]);
            return;
          }
          if constexpr (TRAIL) {
            psr[(p % PP_TRAIL_SLOTS) * P + c] = psi;
            obr[(p % PP_TRAIL_SLOTS) * P + c] = obstacle;
            if (p < k || p >= n_ticks - k) return;  // the planes either side of the chunk
          }
          if (col_in && row_in(e)) {
            int zw = zr - (j - 1);
            while (zw < 0) zw += Z;
            const long long ip = rowy[e + 1] + colx[lane], n = zw * XY + ip;
#pragma unroll
            for (int q = 0; q < 19; ++q) lbm_stcs(out + q * N + n, o[q]);
            if (!TRAIL && psi_out != nullptr) __stcs(psi_out + n, psi);
            // a slab's boundary bands, the next exchange's planes: its
            // first and its last G planes again
            if constexpr (SLAB) {
              if (blo != nullptr && zw < G) {
#pragma unroll
                for (int q = 0; q < 19; ++q) lbm_stcs(blo + q * GN + zw * XY + ip, o[q]);
              }
              if (bhi != nullptr && zw >= Z - G) {
#pragma unroll
                for (int q = 0; q < 19; ++q)
                  lbm_stcs(bhi + q * GN + (zw - Z + G) * XY + ip, o[q]);
              }
            }
          }
        };
        // a row without an obstacle (almost every one) computes its outputs
        // without a select per channel
        float o[19];
        if (__any_sync(0xffffffffu, obstacle)) {
          const float psi = lbm_poisson_cell<TAU1>(s, obstacle, rhr[fs], inv_tau, a, o);
          finish(o, psi);
        } else {
          const float psi = lbm_poisson_cell<TAU1>(s, false, rhr[fs], inv_tau, a, o);
          finish(o, psi);
        }
      }
      // stage 1 of a one-sweep pass reads the input plane that the next
      // put overwrites; a later stage reads nothing the next tick's put
      // or stage 1 writes before its barrier
      if (j < k || k == 1) __syncthreads();
    }
  };

  Input b{};
  int zr = SLAB ? zb : lbm_mod(zb, Z);
  fetch(zr, b);
  for (int r = 0, rk = 0; r < n_ticks; ++r) {
    tick(r, rk, zr, b);
    rk = rk == k ? 0 : rk + 1;
    zr = !SLAB && zr == Z - 1 ? 0 : zr + 1;
  }
  // the trailing stage of the chunk's last plane, after stage k's last tick
  if constexpr (TRAIL) {
    __syncthreads();
    trail(n_ticks - k - 1);
  }
}

// A one-device pass on a batch: B elements of nzb z chunks each on
// gridDim.z.  Declares zblk, the block's z chunk, and moves h, flags, rhs,
// out and psi_out (PC channels: psi or H2 1, H_int 3) to the block's
// element (a macro: the kernels' pointer parameters are __restrict__).
#define LBM_PASS_ELEM(PC)                                                                    \
  long long pass_b;                                                                          \
  int zblk;                                                                                  \
  lbm_fold_z((Z + LZ - 1) / LZ, pass_b, zblk);                                               \
  {                                                                                          \
    const long long pass_n = static_cast<long long>(Z) * Y * X;                              \
    h = lbm_elem(h, pass_b, 19, pass_n), flags = lbm_elem(flags, pass_b, 1, pass_n);         \
    rhs = lbm_elem(rhs, pass_b, 1, pass_n), out = lbm_elem(out, pass_b, 19, pass_n);         \
    psi_out = lbm_elem(psi_out, pass_b, (PC), pass_n);                                       \
  }

// Shared memory of a pass block in bytes with h stored in elements of es
// bytes, with the trailing stage's psi and flags rings where trail is set
// (ops/kernels/poisson.py:smem_bytes counts the same), and the most a block
// may take on an H100 (SMEM_BLOCK_MAX there).
static int lbm_poisson_pass_smem(int k, int EY, int es, bool trail) {
  const int P = PP_EX * EY, PI = PP_EX * (EY + 2);
  return es * (8 + 19 * PI + (k - 1) * PP_RING * PI) + 4 * ((k + 1) * P + PP_EX + EY + 2) +
         (k + 1) * P + (trail ? 5 * PP_TRAIL_SLOTS * P : 0);
}

struct LbmPassArgs {
  const void* h;
  const uint8_t* flags;
  const float* rhs;
  void* out;
  float* psi_out;  // psi, or with trail the trailing stage's output
  int B, Z, Y, X, k, TY, LZ;  // B: batch elements (one device only)
  float inv_tau, a;
  const void *glo, *ghi;  // a slab's bands (null on one device)
  int G;
  void *blo, *bhi;  // a slab's emitted bands (null: none)
  int trail;        // 0: none, 1: H_int, 2: H2
  LbmTrail tr;
};

// Lets ``kernel`` take PP_SMEM_MAX bytes of dynamic shared memory on the
// current device, one attribute call a device (``allowed``: the kernel's own
// record of the devices done).
static inline cudaError_t lbm_pass_allow_smem(const void* kernel, bool* allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= PP_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PP_SMEM_MAX);
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  return cudaSuccess;
}

// The last pass with the trailing stage (csrc/poisson_trail.cu), its
// arguments checked by lbm_poisson_pass: launches it (stream non-null) or
// reports its resident blocks an SM (blocks non-null).
cudaError_t lbm_poisson_trail_run(const LbmPassArgs& g, double tau, int bf16,
                                  cudaStream_t stream, int* blocks);
// The bfloat16 instances of the pass and of the trailing stage's pass,
// each a translation unit of its own (csrc/poisson_bf16.cu,
// csrc/poisson_trail_bf16.cu: the two storages compile in parallel).
cudaError_t lbm_poisson_pass_bf16(const LbmPassArgs& g, double tau, cudaStream_t stream,
                                  int* blocks);
cudaError_t lbm_poisson_trail_bf16(const LbmPassArgs& g, bool tau1, cudaStream_t stream,
                                   int* blocks);
