// Scalar tau == 1 magnetic Poisson solve: replaces the TPU kernel
// lbm_ferrofluid_tpu/ops/pallas/scalar_poisson.py:scalar_wavefront (:562,
// _scalar_wavefront_kernel :111) with emit="h2".
//
// lbm_scalar_sweep runs one sweep over the volume, one thread per cell:
//   psi' = W1 * (sum of the 6 axis neighbours of s)
//        + W2 * (sum of the 12 diagonal neighbours of s) + c * s_prev
//   s'   = cmask >= 0 ? psi' + rhs : 0
// with periodic wrap on every axis, W1 = f32(1.5/18), W2 = f32(1.5/36),
// c = max(cmask, 0): the grouped tap order of the TPU kernel and of
// _cmask_sweeps_jnp (:527-559).  A sweep reads 18 neighbours of s, so it
// cannot run in place: the wrapper rotates three buffers, and the last
// sweep also writes psi.  The TPU schedule (z-wavefront of k sweeps through
// VMEM rings, seam stash) is not carried over.
//
// lbm_scalar_h2 composes the Kelvin magnitude from the last psi: obstacle
// psi is replaced by the edge-replicated interior value, the 19-point
// isotropic gradient is taken at the interior cell nearest to each cell
// (replicate edges), and H2 = |h_ext - grad psi|^2 (ops/magnetic.py
// solve_H_int_scalar :236-241 and _maybe_h2 :104).
//
// Bound on an H100: a call (30 sweeps + H2) must read s and cmask at every
// cell, s_prev only where c > 0 and rhs only at fluid cells, and write s',
// s_prev' and H2: 20 B per cell plus 4 B per fluid and per wall-adjacent
// cell, 0.12 ms at 256^3 over 3.35 TB/s.  A sweep needs 20 flops per fluid
// cell and 2 more where c > 0; H2 needs 36 per interior cell (the
// gradient) and 8 per cell: at 30 sweeps 0.16 ms at 67 TFLOP/s, so
// operations bound it.  This first version streams the volume once per
// sweep (about 5 x 4 B per cell and sweep), so it sits far above that
// bound; temporal blocking in shared memory is later work.
#include "common.cuh"

__global__ void lbm_scalar_sweep_kernel(const float* __restrict__ s, const float* __restrict__ sp,
                                        const float* __restrict__ cmask,
                                        const float* __restrict__ rhs, float* __restrict__ s_out,
                                        float* __restrict__ psi_out, int Z, int Y, int X) {
  const long long N = static_cast<long long>(Z) * Y * X;
  const long long i = lbm_cell();
  if (i >= N) return;
  const int x = static_cast<int>(i % X);
  const int y = static_cast<int>((i / X) % Y);
  const int z = static_cast<int>(i / (static_cast<long long>(X) * Y));
  const int xm = lbm_wrap(x - 1, X), xp = lbm_wrap(x + 1, X);
  const int ym = lbm_wrap(y - 1, Y), yp = lbm_wrap(y + 1, Y);
  const int zm = lbm_wrap(z - 1, Z), zp = lbm_wrap(z + 1, Z);
#define S(zz, yy, xx) s[lbm_index(zz, yy, xx, Y, X)]
  // axis taps in the order of _cmask_sweeps_jnp's axis_sh
  const float A = S(z, y, xm) + S(z, y, xp) + S(z, ym, x) + S(z, yp, x) + S(zm, y, x) + S(zp, y, x);
  // diagonal taps in the order of diag_sh
  const float D = S(z, ym, xm) + S(z, ym, xp) + S(z, yp, xm) + S(z, yp, xp) + S(zm, y, xm) +
                  S(zm, y, xp) + S(zp, y, xm) + S(zp, y, xp) + S(zm, ym, x) + S(zm, yp, x) +
                  S(zp, ym, x) + S(zp, yp, x);
#undef S
  const float cm = cmask[i];
  const float psi = A * static_cast<float>(1.5 / 18.0) + D * static_cast<float>(1.5 / 36.0) +
                    fmaxf(cm, 0.f) * sp[i];
  s_out[i] = cm >= 0.f ? psi + rhs[i] : 0.f;
  if (psi_out != nullptr) psi_out[i] = psi;
}

__global__ void lbm_scalar_h2_kernel(const float* __restrict__ psi,
                                     const float* __restrict__ cmask, float* __restrict__ h2,
                                     int Z, int Y, int X, double dx, double hx, double hy,
                                     double hz) {
  const long long N = static_cast<long long>(Z) * Y * X;
  const long long i = lbm_cell();
  if (i >= N) return;
  const int zc = lbm_clamp(static_cast<int>(i / (static_cast<long long>(X) * Y)), 1, Z - 2);
  const int yc = lbm_clamp(static_cast<int>((i / X) % Y), 1, Y - 2);
  const int xc = lbm_clamp(static_cast<int>(i % X), 1, X - 2);
  // psi at center + (oz, oy, ox), replaced at obstacles by the value at
  // the nearest interior cell
  auto S = [&](int oz, int oy, int ox) -> float {
    const int z = zc + oz, y = yc + oy, x = xc + ox;
    const long long n = lbm_index(z, y, x, Y, X);
    if (cmask[n] < 0.f)
      return psi[lbm_index(lbm_clamp(z, 1, Z - 2), lbm_clamp(y, 1, Y - 2), lbm_clamp(x, 1, X - 2),
                           Y, X)];
    return psi[n];
  };
  float g[3];
  lbm_iso_grad(S, static_cast<float>(12.0 * dx), g);
  const float tx = -g[0] + static_cast<float>(hx);
  const float ty = -g[1] + static_cast<float>(hy);
  const float tz = -g[2] + static_cast<float>(hz);
  h2[i] = tx * tx + ty * ty + tz * tz;
}

extern "C" int lbm_scalar_sweep(const float* s, const float* sp, const float* cmask,
                                const float* rhs, float* s_out, float* psi_out, int Z, int Y,
                                int X, void* stream) {
  const long long N = static_cast<long long>(Z) * Y * X;
  lbm_scalar_sweep_kernel<<<lbm_blocks(N), LBM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      s, sp, cmask, rhs, s_out, psi_out, Z, Y, X);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lbm_scalar_h2(const float* psi, const float* cmask, float* h2, int Z, int Y, int X,
                             double dx, double hx, double hy, double hz, void* stream) {
  const long long N = static_cast<long long>(Z) * Y * X;
  lbm_scalar_h2_kernel<<<lbm_blocks(N), LBM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      psi, cmask, h2, Z, Y, X, dx, hx, hy, hz);
  return static_cast<int>(cudaGetLastError());
}
