// Isotropic gradients of N fields: replaces the TPU kernel
// lbm_ferrofluid_tpu/ops/pallas/stencil3d.py:grad_fields (:176,
// _grad_kernel :90) in its single-device form (no ghost planes, Z >= 4).
//
// lbm_grad_fields writes, for each field f and each cell, the 19-point
// isotropic gradient (gx, gy, gz) into output channels 3f, 3f+1, 3f+2.  The
// TPU kernel replicates the output's boundary ring from the nearest
// interior cell (x edges, then y, then z); that equals evaluating the
// stencil at the clamped interior cell, where every tap is in range, so one
// thread per output cell evaluates lbm_iso_grad (common.cuh, shared with the
// B1 H2 stage and the capillary stages) around (clamp(z, 1, Z-2),
// clamp(y, 1, Y-2), clamp(x, 1, X-2)).  The caller substitutes obstacle
// values first, as on the TPU.
//
// Bound on an H100: 4 B read and 12 B written per cell and field, 0.080 ms
// at 256^3 for one field over 3.35 TB/s; 33 flops per interior cell and
// field.  The taps read neighbouring rows of the same planes, which stay in
// L1/L2, so the one pass over the volume is near its bytes.
#include "common.cuh"

__global__ void lbm_grad_fields_kernel(const float* __restrict__ in, float* __restrict__ out,
                                       int nf, int Z, int Y, int X, float d12) {
  const long long N = static_cast<long long>(Z) * Y * X;
  const long long i = lbm_cell();
  if (i >= N) return;
  const int zc = lbm_clamp(static_cast<int>(i / (static_cast<long long>(X) * Y)), 1, Z - 2);
  const int yc = lbm_clamp(static_cast<int>((i / X) % Y), 1, Y - 2);
  const int xc = lbm_clamp(static_cast<int>(i % X), 1, X - 2);
  for (int f = 0; f < nf; ++f) {
    const float* __restrict__ F = in + f * N;
    float g[3];
    lbm_iso_grad([&](int oz, int oy, int ox) { return F[lbm_index(zc + oz, yc + oy, xc + ox, Y, X)]; },
                 d12, g);
#pragma unroll
    for (int d = 0; d < 3; ++d) out[(3 * f + d) * N + i] = g[d];
  }
}

extern "C" int lbm_grad_fields(const float* in, float* out, int nf, int Z, int Y, int X,
                               double dx, void* stream) {
  const long long N = static_cast<long long>(Z) * Y * X;
  lbm_grad_fields_kernel<<<lbm_blocks(N), LBM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, nf, Z, Y, X, static_cast<float>(12.0 * dx));
  return static_cast<int>(cudaGetLastError());
}
