// Scalar tau == 1 magnetic Poisson solve: replaces the TPU kernel
// lbm_ferrofluid_tpu/ops/pallas/scalar_poisson.py:scalar_wavefront (:562,
// _scalar_wavefront_kernel :111) with emit="h2".
//
// A sweep is
//   psi' = W1 * (sum of the 6 axis neighbours of s)
//        + W2 * (sum of the 12 diagonal neighbours of s) + c * s_prev
//   s'   = cmask >= 0 ? psi' + rhs : 0
// with periodic wrap on every axis, W1 = f32(1.5/18), W2 = f32(1.5/36),
// c = max(cmask, 0): the grouped tap order of the TPU kernel and of
// _cmask_sweeps_jnp (:527-559).
//
// Bound on an H100: a call (30 sweeps + H2) must read s and cmask at every
// cell, s_prev only where c > 0 and rhs only at fluid cells, and write s',
// s_prev' and H2: 20 B per cell plus 4 B per fluid and per wall-adjacent
// cell, 0.12 ms at 256^3 over 3.35 TB/s.  A sweep needs 20 flops per fluid
// cell and 2 more where c > 0; H2 needs 36 per interior cell (the
// gradient) and 8 per cell: at 30 sweeps 0.16 ms at 67 TFLOP/s, so
// operations bound it.  A launch per sweep would stream the volume through
// device memory 30 times; the passes below keep k sweeps on chip.
//
// lbm_scalar_pass runs k sweeps in one launch, the TPU's z-wavefront
// rethought for a 227 KB SM (ops/kernels/scalar_poisson.py:plan: k = 3,
// TY = 28, and the z chunk that fills the card's SMs):
//   - a block owns a TX x TY (x, y) tile, TX = 32 - 2k, and a chunk
//     [z0, z1) of z.  It holds the tile with a halo of k cells (periodic
//     wrap), 32 cells wide, so a warp covers a row, and walks the extended
//     window [z0 - k, z1 + k) one plane a tick, reading planes with wrap:
//     z's periodic wrap and the chunk seams need no stash;
//   - stage 0 is the input s (loaded through registers one tick ahead);
//     stage j (1..k) computes sweep j at plane t - j on rows [j, EY - j),
//     one plane behind stage j - 1.  Each stage below k keeps a 3-plane
//     ring in shared memory; stage j's s_prev at plane w is stage j - 2's
//     output at w, still in its ring.  Columns outside [j, 32 - j) of a
//     stage are computed too, from wrong neighbours: no valid cell reads
//     them, and the warp stays whole;
//   - a thread computes SP_R cells of a column, so the taps they share are
//     read from shared memory once: 14.5 reads a cell and sweep instead
//     of 21;
//   - cmask and rhs sit in (k + 2)-plane rings and the input s_prev (stage
//     1's s_prev) in a 3-plane ring, filled by cp.async two ticks before a
//     stage first reads them, so no stage waits on device memory;
//   - stage k writes s' (and, on the last pass, psi) of the tile, and
//     stage k - 1's plane as s_prev'.
// Passes write out of place, so no input is overwritten during a pass.
// What bounds it now: shared-memory reads (a tick is a few rounds of
// them, each stage ending at a block-wide barrier), the halo's
// recomputation (32 / TX in x, 1 + 2(k - j) / TY in y at stage j), and each
// pass's trip through device memory, about 24 B a cell.
//
// lbm_scalar_h2 composes the Kelvin magnitude from the last psi: obstacle
// psi is replaced by the edge-replicated interior value, the 19-point
// isotropic gradient is taken at the interior cell nearest to each cell
// (replicate edges), and H2 = |h_ext - grad psi|^2 (ops/magnetic.py
// solve_H_int_scalar :236-241 and _maybe_h2 :104).  It walks z through a
// 3-plane ring of the substituted psi (common.cuh:lbm_zwalk), so each tap
// is one shared-memory read.
#include "common.cuh"

#define SP_THREADS 256
#define SP_WARPS (SP_THREADS / 32)
#define SP_EX 32     // extended tile width
#define SP_R 4       // cells of a column a thread computes at once
#define SP_MAX_K 6
#define SP_MAX_EY 48 // TY + 2k
// cells of an extended plane a thread loads
#define SP_LOADS (SP_EX * SP_MAX_EY / SP_THREADS)

// 4-byte copy from device to shared memory that bypasses registers.  A
// thread's copies issued since its last lbm_cp_async_commit form a group;
// lbm_cp_async_wait_prior waits for all its groups but the newest.
__device__ __forceinline__ void lbm_cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void lbm_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void lbm_cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__global__ void __launch_bounds__(SP_THREADS, 2) lbm_scalar_pass_kernel(
    const float* __restrict__ s, const float* __restrict__ sp, const float* __restrict__ cmask,
    const float* __restrict__ rhs, float* __restrict__ s_out, float* __restrict__ sp_out,
    float* __restrict__ psi_out, int Z, int Y, int X, int k, int TY, int LZ) {
  // 4 floats of padding (the edge lanes of row 0 read one float before it),
  // k 3-plane stage rings, the cmask and rhs rings, the s_prev ring, then
  // the wrapped grid x of each extended column and y * X of each row
  extern __shared__ float smem[];
  const int TX = SP_EX - 2 * k, EY = TY + 2 * k, P = SP_EX * EY;
  float* rings = smem + 4;
  float* cmr = rings + 3 * k * P;
  float* rhr = cmr + (k + 2) * P;
  float* spr = rhr + (k + 2) * P;
  int* colx = reinterpret_cast<int*>(spr + 3 * P);
  int* rowy = colx + SP_EX;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int z0 = blockIdx.z * LZ, z1 = min(z0 + LZ, Z);
  const long long XY = static_cast<long long>(X) * Y;
  if (tid < SP_EX) colx[tid] = lbm_mod(x0 - k + tid, X);
  for (int e = tid; e < EY; e += SP_THREADS) rowy[e] = lbm_mod(y0 - k + e, Y) * X;
  __syncthreads();
  // tick t's residues mod 3 (stage and s_prev rings), k + 2 (cmask and
  // rhs rings) and Z (its grid plane), advanced each tick, so no ring slot
  // costs a division
  int r3 = lbm_mod(z0 - k, 3), rk = lbm_mod(z0 - k, k + 2);
  int rz = lbm_mod(z0 - k, Z);

  // the thread's cells of an extended plane: e = tid + m SP_THREADS, row
  // e / 32, column lane, at in-plane offset off[m] of the grid
  int off[SP_LOADS];
#pragma unroll
  for (int m = 0; m < SP_LOADS; ++m) {
    const int row = (tid + m * SP_THREADS) / SP_EX;
    off[m] = row < EY ? rowy[row] + colx[lane] : 0;
  }
  float pre[SP_LOADS];
  auto fetch = [&](long long base) {
#pragma unroll
    for (int m = 0; m < SP_LOADS; ++m)
      if (tid + m * SP_THREADS < P) pre[m] = s[base + off[m]];
  };
  auto put = [&]() {
    float* d = rings + r3 * P;
#pragma unroll
    for (int m = 0; m < SP_LOADS; ++m)
      if (tid + m * SP_THREADS < P) d[tid + m * SP_THREADS] = pre[m];
  };
  // plane z of cmask, rhs and s_prev into cmask/rhs slot ks, s_prev slot ss
  auto fetch_async = [&](int z, int ks, int ss) {
    const long long base = z * XY;
    float *c = cmr + ks * P, *r = rhr + ks * P, *q = spr + ss * P;
#pragma unroll
    for (int m = 0; m < SP_LOADS; ++m) {
      const int e = tid + m * SP_THREADS;
      if (e < P) {
        lbm_cp_async4(c + e, cmask + base + off[m]);
        lbm_cp_async4(r + e, rhs + base + off[m]);
        lbm_cp_async4(q + e, sp + base + off[m]);
      }
    }
    lbm_cp_async_commit();
  };

  const float w1 = static_cast<float>(1.5 / 18.0), w2 = static_cast<float>(1.5 / 36.0);
  const int t_end = z1 + k;
  fetch(rz * XY);
  fetch_async(rz, rk, r3);
  for (int t = z0 - k; t < t_end; ++t) {
    put();
    const int z_next = rz + 1 == Z ? 0 : rz + 1;
    if (t + 1 < t_end) fetch(z_next * XY);
    lbm_cp_async_wait_prior();  // planes up to t - 1 of cmask, rhs, s_prev
    __syncthreads();
    // plane t + 1, read from tick t + 2 on: two ticks to land, into slots
    // that no stage reads this tick
    fetch_async(z_next, rk == k + 1 ? 0 : rk + 1, r3 == 2 ? 0 : r3 + 1);
    // stage j reads planes t - j + 1, t - j, t - j - 1 of stage j - 1, in
    // slots sa, sb, sc (rotated each stage), cmask/rhs slot ck and grid
    // plane zw of t - j
    int sa = r3, sb = r3 == 0 ? 2 : r3 - 1, sc = r3 == 2 ? 0 : r3 + 1;
    int ck = rk == 0 ? k + 1 : rk - 1, zw = rz == 0 ? Z - 1 : rz - 1;
    float* rb = rings;  // stage j - 1's ring
    for (int j = 1; j <= k; ++j) {
      const int w = t - j;
      // the same for the whole block
      if (w >= z0 - k + j && w < z1 + k - j) {
        const float* am = rb + sc * P;
        const float* a0 = rb + sb * P;
        const float* ap = rb + sa * P;
        const float* prev = (j >= 2 ? rb - 3 * P : spr) + sb * P;
        const float* cmw = cmr + ck * P;
        const float* rhw = rhr + ck * P;
        const float* last = rings + (3 * (k - 1) + sb) * P;
        float* dst = rb + (3 + sb) * P;
        const long long base = zw * XY;
        // groups of SP_R rows of [j, EY - j), the last one moved up to end
        // at EY - j (its overlap is computed twice, to the same values)
        const int groups = (EY - 2 * j + SP_R - 1) / SP_R;
        for (int gi = warp; gi < groups; gi += SP_WARPS) {
          const int ey0 = min(j + gi * SP_R, EY - j - SP_R);
          const int e = ey0 * SP_EX + lane;
          // column lane - 1, lane, lane + 1 of stage j - 1 at plane w, rows
          // ey0 - 1 .. ey0 + SP_R; at planes w -+ 1 column lane over the same
          // rows and columns lane -+ 1 over rows ey0 .. ey0 + SP_R - 1
          float l[SP_R + 2], c[SP_R + 2], r[SP_R + 2], mc[SP_R + 2], pc[SP_R + 2];
          float ml[SP_R], mr[SP_R], pl[SP_R], pr[SP_R];
#pragma unroll
          for (int i = 0; i < SP_R + 2; ++i) {
            const int o = e + (i - 1) * SP_EX;
            l[i] = a0[o - 1];
            c[i] = a0[o];
            r[i] = a0[o + 1];
            mc[i] = am[o];
            pc[i] = ap[o];
          }
#pragma unroll
          for (int i = 0; i < SP_R; ++i) {
            const int o = e + i * SP_EX;
            ml[i] = am[o - 1];
            mr[i] = am[o + 1];
            pl[i] = ap[o - 1];
            pr[i] = ap[o + 1];
          }
#pragma unroll
          for (int i = 0; i < SP_R; ++i) {
            const int o = e + i * SP_EX;
            // axis taps in the order of _cmask_sweeps_jnp's axis_sh, then the
            // diagonal taps in the order of diag_sh
            const float A = l[i + 1] + r[i + 1] + c[i] + c[i + 2] + mc[i + 1] + pc[i + 1];
            const float D = l[i] + r[i] + l[i + 2] + r[i + 2] + ml[i] + mr[i] + pl[i] + pr[i] +
                            mc[i] + mc[i + 2] + pc[i] + pc[i + 2];
            const float cm = cmw[o];
            const float psi = A * w1 + D * w2 + fmaxf(cm, 0.f) * prev[o];
            const float snew = cm >= 0.f ? psi + rhw[o] : 0.f;
            if (j < k) {
              dst[o] = snew;
            } else if (lane >= k && lane < SP_EX - k && x0 + lane - k < X &&
                       y0 + ey0 + i - k < Y) {
              // the tile, inside the grid: no wrap
              const long long n = base + rowy[ey0 + i] + colx[lane];
              s_out[n] = snew;
              sp_out[n] = last[o];
              if (psi_out != nullptr) psi_out[n] = psi;
            }
          }
        }
        __syncthreads();
      }
      const int s_old = sa;
      sa = sb, sb = sc, sc = s_old;
      ck = ck == 0 ? k + 1 : ck - 1;
      zw = zw == 0 ? Z - 1 : zw - 1;
      rb += 3 * P;
    }
    r3 = r3 == 2 ? 0 : r3 + 1;
    rk = rk == k + 1 ? 0 : rk + 1;
    rz = rz == Z - 1 ? 0 : rz + 1;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

#define H2_TX 32
#define H2_TY 8
#define H2_ZB 16

__global__ void __launch_bounds__(H2_TX* H2_TY) lbm_scalar_h2_kernel(
    const float* __restrict__ psi, const float* __restrict__ cmask, float* __restrict__ h2,
    int Z, int Y, int X, float d12, float hx, float hy, float hz) {
  // psi of three planes of the tile and its halo, replaced at obstacles by
  // the value at the nearest interior cell
  __shared__ float ring[3][H2_TY + 2][H2_TX + 2];
  const int x0 = blockIdx.x * H2_TX, y0 = blockIdx.y * H2_TY;
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  const int z0 = blockIdx.z * H2_ZB, z1 = min(z0 + H2_ZB, Z);
  auto load = [&](int p) {
    lbm_halo_cells<H2_TX, H2_TY>(p, x0, y0, Z, Y, X, [&](int ey, int ex, long long n,
                                                        long long c) {
      ring[p % 3][ey][ex] = psi[cmask[n] < 0.f ? c : n];
    });
  };
  const int xl = lbm_clamp(x, 1, X - 2) - lbm_ring_origin(x0, X);
  const int yl = lbm_clamp(y, 1, Y - 2) - lbm_ring_origin(y0, Y);
  lbm_zwalk(z0, z1, Z, x < X && y < Y, load, [&](int z, int sm, int s0, int sp) {
    float g[3];
    lbm_iso_grad(
        [&](int oz, int oy, int ox) {
          return ring[oz < 0 ? sm : (oz > 0 ? sp : s0)][yl + oy][xl + ox];
        },
        d12, g);
    const float tx = -g[0] + hx, ty = -g[1] + hy, tz = -g[2] + hz;
    h2[(static_cast<long long>(z) * Y + y) * X + x] = tx * tx + ty * ty + tz * tz;
  });
}

// Shared memory of a pass block in bytes (ops/kernels/scalar_poisson.py:
// smem_bytes counts the same), and the most a block may take on an H100
// (SMEM_BLOCK_MAX there).
static int lbm_scalar_pass_smem(int k, int TY) {
  return 4 * (4 + SP_EX * (TY + 2 * k) * (3 * k + 2 * (k + 2) + 3) + SP_EX + TY + 2 * k);
}
#define SP_SMEM_MAX 232448
#define SP_MAX_DEVICES 64

// Lets lbm_scalar_pass_kernel take SP_SMEM_MAX bytes of dynamic shared
// memory on the current device: one attribute call a device, not a launch.
static cudaError_t lbm_scalar_pass_allow_smem() {
  static bool allowed[SP_MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= SP_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(lbm_scalar_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SP_SMEM_MAX);
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  return cudaSuccess;
}

// k sweeps on (s, sp) -> s_out (sweep k), sp_out (sweep k - 1) and, unless
// null, psi_out (psi of sweep k), on tiles (32 - 2k) x TY and z chunks of
// LZ planes; 1 <= k <= SP_MAX_K, SP_R <= TY <= SP_MAX_EY - 2k, and the
// block's shared memory within SP_SMEM_MAX.
extern "C" int lbm_scalar_pass(const float* s, const float* sp, const float* cmask,
                               const float* rhs, float* s_out, float* sp_out, float* psi_out,
                               int Z, int Y, int X, int k, int TY, int LZ, void* stream) {
  if (k < 1 || k > SP_MAX_K || TY < SP_R || TY + 2 * k > SP_MAX_EY || LZ < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = lbm_scalar_pass_smem(k, TY);
  if (smem > SP_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = lbm_scalar_pass_allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int TX = SP_EX - 2 * k;
  const dim3 grid((X + TX - 1) / TX, (Y + TY - 1) / TY, (Z + LZ - 1) / LZ);
  lbm_scalar_pass_kernel<<<grid, SP_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      s, sp, cmask, rhs, s_out, sp_out, psi_out, Z, Y, X, k, TY, LZ);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of lbm_scalar_pass_kernel resident on one SM at a plan's k and TY
// (for reports).
extern "C" int lbm_scalar_pass_occupancy(int k, int TY, int* blocks) {
  const cudaError_t err = lbm_scalar_pass_allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, lbm_scalar_pass_kernel, SP_THREADS, lbm_scalar_pass_smem(k, TY)));
}

extern "C" int lbm_scalar_h2(const float* psi, const float* cmask, float* h2, int Z, int Y, int X,
                             double dx, double hx, double hy, double hz, void* stream) {
  const dim3 grid((X + H2_TX - 1) / H2_TX, (Y + H2_TY - 1) / H2_TY, (Z + H2_ZB - 1) / H2_ZB);
  lbm_scalar_h2_kernel<<<grid, dim3(H2_TX, H2_TY), 0, static_cast<cudaStream_t>(stream)>>>(
      psi, cmask, h2, Z, Y, X, static_cast<float>(12.0 * dx), static_cast<float>(hx),
      static_cast<float>(hy), static_cast<float>(hz));
  return static_cast<int>(cudaGetLastError());
}
