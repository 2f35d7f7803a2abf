// Channel-form magnetic Poisson sweeps: replaces the TPU kernel
// lbm_ferrofluid_tpu/ops/pallas/poisson.py:poisson_sweeps (:200,
// _sweep_kernel :120, arithmetic _sweep_math :69).  The TPU's temporally
// blocked variants (poisson_multisweep2 :700, poisson_multisweep :413) and
// its time-skewed wavefront with psi emission (poisson_wavefront :1301,
// _wavefront_kernel :866) compute the same sweeps, so this kernel serves
// them too.
//
// A sweep, at every cell (common.cuh:lbm_poisson_cell):
//   streamed_q = h_q(x - e_q), periodic wrap on every axis
//   psi        = f32(1/(1-w0)) * (streamed_1 + ... + streamed_18)
//                (summed before bounce-back, in ascending q)
//   obstacle:  out_q = streamed_opp(q)
//   otherwise: t = psi / tau, u = t + rhs,
//              out_q = (1 - 1/tau) streamed_q + w_q u, minus t at q = 0
// with the tau == 1 specialisation of _sweep_math (out_q = w_q u).
//
// Bound on an H100: a call (n sweeps) must read h (76 B), the flags (1 B)
// and rhs at non-obstacle cells (4 B), and write h' (76 B) and psi (4 B):
// 161 B per cell, 0.81 ms at 256^3 over 3.35 TB/s.  A sweep needs 39 flops
// per non-obstacle cell at tau == 1 and 78 otherwise: 0.29 / 0.59 ms at
// 67 TFLOP/s for 30 sweeps, so bytes bound it.  A launch per sweep streams
// the whole distribution through device memory once a sweep, 157 B per
// cell, and no tuning of such a launch gets under 0.79 ms a sweep at 256^3.
//
// lbm_poisson_pass runs k sweeps in one launch: the TPU's z-wavefront, its
// window in VMEM, rethought for a 227 KB SM (ops/kernels/poisson.py:plan):
//   - a block owns a TX x TY (x, y) tile and a chunk [z0, z1) of z.  It
//     holds the tile with its halo, an extended tile 32 cells wide (a warp
//     computes a row) and EY = TY + 2(k - 1) high, and walks the chunk's
//     window one plane a tick, reading planes with wrap.  TX is 32 - 2k
//     rounded down to a multiple of 8 (24 for k <= 4), so every tile
//     starts on a 32-byte sector and a block stores whole sectors: with
//     tiles 26 wide, neighbouring blocks wrote parts of one sector, and the
//     stores cost a third of the pass;
//   - stage j computes sweep j at plane t - j + 1 on rows [j - 1, EY - j +
//     1), one plane behind stage j - 1.  Stage 1 reads its 19 pulled
//     values from the input plane: for each channel q the grid plane it
//     pulls from (z + 1, z or z - 1 by e_z), rows -1..EY of the extended
//     tile, so its whole height is right and the tile needs k - 1 rows of
//     halo in y (k columns in x);
//   - the input plane arrives through registers: each warp loads one of
//     its EY + 2 rows, 19 channels, during the tick before, so device
//     memory streams while the stages compute (read inside stage 1, the
//     loads left every stage after it without a byte in flight; loading two
//     ticks ahead, or by 4-byte cp.async into shared memory, ran slower);
//   - each stage below k keeps its output in a ring of shared memory that
//     holds a channel only as long as the next stage reads it: the 5
//     channels with e_z = -1 for 1 plane (stage j + 1 reads them in the
//     tick they are made), the 9 with e_z = 0 for 2 and the 5 with e_z = +1
//     for 3, 38 floats a cell where three whole planes would take 57.  Its
//     channel planes are laid out as the input plane's, so every stage
//     reads a channel at a compile-time offset from one of three pointers;
//     Edge columns a stage computes from wrong neighbours are never read by
//     a valid cell;
//   - flags and rhs of the extended plane sit in (k + 1)-plane rings,
//     loaded through registers one tick ahead as well: nothing the next
//     tick's loads overwrite is read by stage k (for k >= 2), so stage k
//     ends without a barrier and its stores overlap the next tick's start;
//   - stage k writes h' (and, on the last pass, psi) of the tile, with
//     streaming (evict-first) stores, so they do not push the input's
//     halo rows, which neighbouring blocks read again, out of L2.
// Passes write out of place, so no input is overwritten during a pass; the
// k = 1 pass is the one-sweep kernel, and every pass computes each cell with
// lbm_poisson_cell, so every plan gives the same bits.  A pass of k = 3 at
// 256^3 takes about twice its trip through device memory (157 B a cell).
// What holds it there is not measured per instruction; the suspects: with
// one block an SM its loads, stages and stores overlap little, and every
// byte of the input, the rings and the stores crosses the SM's
// shared-memory and L1 path (PERF.md, section 7).
//
// In bfloat16 storage of h (T = __nv_bfloat16) the pass reads and writes h
// in bfloat16, and the input plane and the stage rings hold bfloat16 too:
// each stage below k stores its sweep's outputs rounded to bfloat16 (to
// nearest even), as the TPU wavefront keeps its stage rings in the storage
// dtype and as the one-sweep loop stores every sweep, so every plan gives
// the plain one-sweep loop's bits at bfloat16 as well.  Rings of float32
// values already rounded would give the same bits; bfloat16 rings halve the
// block's shared memory (97 KiB at k = 3 on 9-row tiles instead of 186 KiB),
// so shared memory leaves room for two blocks an SM where it left room for
// one (ops/kernels/poisson.py:smem_bytes and plan count the element size;
// whether registers allow two is what the card reports).  A call then must
// move 85 B per cell: 0.43 ms at 256^3.
#include "common.cuh"

#define PP_EX 32  // extended tile width
#define PP_MAX_K 4
// the extended heights EY = TY + 2(k - 1) the kernel is built for (a block
// has a warp per input row, EY + 2): those of ops/kernels/poisson.py:plan's
// passes (9, 11, 13) and of the plans chip_smoke.py --poisson-plans times
// (EXT_HEIGHTS there)
#define PP_EXT_HEIGHTS(M) M(5) M(7) M(8) M(9) M(10) M(11) M(12) M(13) M(14) M(15) M(18)
// floats a stage ring keeps a cell: 9 channels x 2 planes + 5 x 3 + 5 x 1
#define PP_RING 38

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

// EY is a template parameter, so every shared-memory offset of a channel
// is an immediate of the load or store instead of a multiply by the plane
// size, and the register bound follows the block's size; the host picks
// the instance (lbm_poisson_pass_instance).  T is h's storage type, which
// the input plane and the stage rings keep.
template <class T, bool TAU1, int EY>
__global__ void __launch_bounds__(PP_EX*(EY + 2), 1) lbm_poisson_pass_kernel(
    const T* __restrict__ h, const uint8_t* __restrict__ flags, const float* __restrict__ rhs,
    T* __restrict__ out, float* __restrict__ psi_out, int Z, int Y, int X, int k, int LZ,
    float inv_tau, float a) {
  // 4 elements of padding (edge lanes read one element before and after a
  // plane), the input plane (19 channels), the k - 1 stage rings, 4 more,
  // all in T; then, in float, the (k + 1)-plane rhs ring, the wrapped grid
  // x of the extended columns and y * X of the rows -1..EY, then the flags
  // ring.  Every channel plane of the input and the rings holds rows
  // -1..EY (PI elements, row e at (e + 1) * 32; the rings leave rows -1
  // and EY unused), so each stage reads its source the same way.
  extern __shared__ float smem[];
  constexpr int P = PP_EX * EY, PI = PP_EX * (EY + 2);
  const int TX = lbm_pass_tx(k), HX = lbm_pass_hx(k), TY = EY - 2 * (k - 1);
  T* inp = reinterpret_cast<T*>(smem) + 4;
  T* rings = inp + 19 * PI;
  float* rhr = reinterpret_cast<float*>(rings + (k - 1) * PP_RING * PI + 4);
  int* colx = reinterpret_cast<int*>(rhr + (k + 1) * P);
  int* rowy = colx + PP_EX;
  uint8_t* flr = reinterpret_cast<uint8_t*>(rowy + EY + 2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int z0 = blockIdx.z * LZ, z1 = min(z0 + LZ, Z);
  const long long XY = static_cast<long long>(X) * Y, N = XY * Z;
  if (warp == 0) colx[lane] = lbm_mod(x0 - HX + lane, X);
  if (lane == 0) rowy[warp] = lbm_mod(y0 - k + warp, Y) * X;  // a warp per row -1..EY
  __syncthreads();
  const int ex[19] = LBM_D3Q19_EX;
  const int ey[19] = LBM_D3Q19_EY;
  const int ez[19] = LBM_D3Q19_EZ;
  // plane p of the block is grid plane zb + p (wrapped); tick r runs stage
  // j at p = r - j + 1, over p in [j - 1, n_ticks - j + 1), so stage k
  // covers [z0, z1)
  const int zb = z0 - k + 1, n_ticks = z1 - z0 + 2 * k - 2;

  // the warp's input row (row warp - 1 of the extended tile) and, for rows
  // 0..EY - 1, its cell of the flags and rhs plane, at in-plane offsets of
  // the grid
  const int in_off = rowy[warp] + colx[lane];
  const bool has_cell = warp >= 1 && warp <= EY;
  // stage 1 reads the halo row above the extended tile only in the 5
  // channels with e_y = +1 and the row below only in those with e_y = -1
  auto needs = [&](int q) {
    return warp == 0 ? ey[q] == 1 : (warp == EY + 1 ? ey[q] == -1 : true);
  };
  // the input of the tick whose stage 1 computes grid plane zr: channel q
  // of plane zr - e_z(q), flags and rhs of plane zr
  auto fetch = [&](int zr, LbmPassInput<T>& b) {
    const long long zc[3] = {(zr == 0 ? Z - 1 : zr - 1) * XY, zr * XY,
                             (zr == Z - 1 ? 0 : zr + 1) * XY};
#pragma unroll
    for (int q = 0; q < 19; ++q)
      if (needs(q)) b.h[q] = h[q * N + zc[1 - ez[q]] + in_off];
    if (has_cell) {
      b.rhs = rhs[zc[1] + in_off];
      b.flag = flags[zc[1] + in_off];
    }
  };
  auto put = [&](int slot, const LbmPassInput<T>& b) {
#pragma unroll
    for (int q = 0; q < 19; ++q)
      if (needs(q)) inp[q * PI + warp * PP_EX + lane] = b.h[q];
    if (has_cell) {
      const int c = (warp - 1) * PP_EX + lane;
      rhr[slot * P + c] = b.rhs;
      flr[slot * P + c] = b.flag;
    }
  };

  // tick r, with rk = r % (k + 1) and zr its stage 1's grid plane (kept by
  // the loop, so no stage divides by a runtime value)
  auto tick = [&](int r, int rk, int zr, LbmPassInput<T>& b) {
    // tick r's input over what stage 1 read last tick, plane r's flags and
    // rhs into the slot of plane r - k - 1, which stage k read two ticks
    // ago; then tick r + 1's loads into the registers just emptied, in
    // flight while the stages compute
    put(rk, b);
    if (r + 1 < n_ticks) fetch(zr == Z - 1 ? 0 : zr + 1, b);
    __syncthreads();
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
          } else if (lane >= HX && lane < HX + TX && x0 + lane - HX < X &&
                     y0 + e - (k - 1) < Y) {
            int zw = zr - (j - 1);
            while (zw < 0) zw += Z;
            const long long n = zw * XY + rowy[e + 1] + colx[lane];
#pragma unroll
            for (int q = 0; q < 19; ++q) lbm_stcs(out + q * N + n, o[q]);
            if (psi_out != nullptr) __stcs(psi_out + n, psi);
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

  LbmPassInput<T> b{};
  int zr = lbm_mod(zb, Z);
  fetch(zr, b);
  for (int r = 0, rk = 0; r < n_ticks; ++r) {
    tick(r, rk, zr, b);
    rk = rk == k ? 0 : rk + 1;
    zr = zr == Z - 1 ? 0 : zr + 1;
  }
}

// Shared memory of a pass block in bytes with h stored in elements of es
// bytes (ops/kernels/poisson.py:smem_bytes counts the same), and the most
// a block may take on an H100 (SMEM_BLOCK_MAX there).
static int lbm_poisson_pass_smem(int k, int EY, int es) {
  const int P = PP_EX * EY, PI = PP_EX * (EY + 2);
  return es * (8 + 19 * PI + (k - 1) * PP_RING * PI) + 4 * ((k + 1) * P + PP_EX + EY + 2) +
         (k + 1) * P;
}
#define PP_SMEM_MAX 232448
#define PP_MAX_DEVICES 64

struct LbmPassArgs {
  const void* h;
  const uint8_t* flags;
  const float* rhs;
  void* out;
  float* psi_out;
  int Z, Y, X, k, TY, LZ;
  float inv_tau, a;
};

// One instance of the pass kernel: lets it take PP_SMEM_MAX bytes of
// dynamic shared memory on the current device (one attribute call a
// device), then launches it (stream non-null) or reports its resident
// blocks an SM (blocks non-null).
template <class T, bool TAU1, int EY>
static cudaError_t lbm_poisson_pass_instance(const LbmPassArgs& g, cudaStream_t stream,
                                             int* blocks) {
  static bool allowed[PP_MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= PP_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(lbm_poisson_pass_kernel<T, TAU1, EY>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, PP_SMEM_MAX);
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  const int smem = lbm_poisson_pass_smem(g.k, EY, sizeof(T)), threads = PP_EX * (EY + 2);
  if (blocks != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, lbm_poisson_pass_kernel<T, TAU1, EY>, threads, smem);
  const int TX = lbm_pass_tx(g.k);
  const dim3 grid((g.X + TX - 1) / TX, (g.Y + g.TY - 1) / g.TY, (g.Z + g.LZ - 1) / g.LZ);
  lbm_poisson_pass_kernel<T, TAU1, EY><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(g.h), g.flags, g.rhs, static_cast<T*>(g.out), g.psi_out, g.Z, g.Y,
      g.X, g.k, g.LZ, g.inv_tau, g.a);
  return cudaGetLastError();
}

template <class T, bool TAU1>
static cudaError_t lbm_poisson_pass_dispatch(const LbmPassArgs& g, cudaStream_t stream,
                                             int* blocks) {
  switch (g.TY + 2 * (g.k - 1)) {
#define PP_CASE(E) \
  case E:          \
    return lbm_poisson_pass_instance<T, TAU1, E>(g, stream, blocks);
    PP_EXT_HEIGHTS(PP_CASE)
#undef PP_CASE
  }
  return cudaErrorInvalidValue;
}

template <class T>
static cudaError_t lbm_poisson_pass_run(const LbmPassArgs& g, double tau, cudaStream_t stream,
                                        int* blocks) {
  if (g.k < 1 || g.k > PP_MAX_K || g.TY < 1 || g.LZ < 1) return cudaErrorInvalidValue;
  if (lbm_poisson_pass_smem(g.k, g.TY + 2 * (g.k - 1), sizeof(T)) > PP_SMEM_MAX)
    return cudaErrorInvalidValue;
  return 1.0 / tau == 1.0 ? lbm_poisson_pass_dispatch<T, true>(g, stream, blocks)
                          : lbm_poisson_pass_dispatch<T, false>(g, stream, blocks);
}

static cudaError_t lbm_poisson_pass_any(const LbmPassArgs& g, double tau, int bf16,
                                        cudaStream_t stream, int* blocks) {
  return bf16 ? lbm_poisson_pass_run<__nv_bfloat16>(g, tau, stream, blocks)
              : lbm_poisson_pass_run<float>(g, tau, stream, blocks);
}

// k sweeps on h -> out (sweep k) and, unless null, psi_out (psi of sweep
// k), on tiles lbm_pass_tx(k) x TY and z chunks of LZ planes, with a warp per
// row of the extended tile and its two halo rows; 1 <= k <= PP_MAX_K,
// TY + 2(k - 1) one of PP_EXT_HEIGHTS, and the block's shared memory within
// PP_SMEM_MAX (cudaErrorInvalidValue otherwise).  h and out in float32, or
// in bfloat16 where bf16 is nonzero; psi_out in float32.
extern "C" int lbm_poisson_pass(const void* h, const uint8_t* flags, const float* rhs,
                                void* out, float* psi_out, int Z, int Y, int X, int k, int TY,
                                int LZ, double tau, int bf16, void* stream) {
  const double inv_tau = 1.0 / tau;
  const LbmPassArgs g{h, flags, rhs, out, psi_out, Z, Y, X, k, TY, LZ,
                      static_cast<float>(inv_tau), static_cast<float>(1.0 - inv_tau)};
  const cudaError_t err =
      lbm_poisson_pass_any(g, tau, bf16, static_cast<cudaStream_t>(stream), nullptr);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// Blocks of lbm_poisson_pass_kernel (the tau == 1 form unless tau1 is 0,
// the bfloat16 instance where bf16 is nonzero) resident on one SM at a
// plan's k and TY (for reports).
extern "C" int lbm_poisson_pass_occupancy(int k, int TY, int tau1, int bf16, int* blocks) {
  const LbmPassArgs g{nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, 1, k, TY, 1, 1.f, 0.f};
  return static_cast<int>(lbm_poisson_pass_any(g, tau1 ? 1.0 : 0.5, bf16, nullptr, blocks));
}
