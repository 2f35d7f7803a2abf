// Capillary stencils: replaces the TPU kernels of
// lbm_ferrofluid_tpu/ops/pallas/stencil3d.py in their single-device form
// (no ghost planes): grad_fields (:176, _grad_kernel :90) and
// laplacian_field (:242, _lap_kernel :131).
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
// lbm_laplacian_field writes the 19-point Laplacian with a zero boundary ring
// (x/y edges everywhere, whole z edge planes).  The TPU kernel reads its
// edge taps replicated and then zeroes the ring, so those reads never reach
// the output; here one thread per cell writes 0 on the ring and evaluates
// common.cuh's lbm_laplacian (the capillary stages' own) elsewhere.
//
// Bound on an H100: bytes.  Gradients: 4 B read and 12 B written per cell
// and field, 0.080 ms at 256^3 for one field over 3.35 TB/s; 33 flops per
// interior cell and field.  Laplacian: 4 B read and 4 B written per cell,
// 0.040 ms at 256^3; 21 flops per interior cell.  The taps read
// neighbouring rows of the same planes, which stay in L1/L2, so the one
// pass over the volume is near its bytes.
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

__global__ void lbm_laplacian_kernel(const float* __restrict__ in, float* __restrict__ out, int Z,
                                     int Y, int X, double dx) {
  const long long N = static_cast<long long>(Z) * Y * X;
  const long long i = lbm_cell();
  if (i >= N) return;
  const int x = static_cast<int>(i % X);
  const int y = static_cast<int>((i / X) % Y);
  const int z = static_cast<int>(i / (static_cast<long long>(X) * Y));
  if (z == 0 || z == Z - 1 || y == 0 || y == Y - 1 || x == 0 || x == X - 1) {
    out[i] = 0.f;
    return;
  }
  out[i] = lbm_laplacian(
      [&](int oz, int oy, int ox) { return in[lbm_index(z + oz, y + oy, x + ox, Y, X)]; }, dx);
}

extern "C" int lbm_grad_fields(const float* in, float* out, int nf, int Z, int Y, int X,
                               double dx, void* stream) {
  const long long N = static_cast<long long>(Z) * Y * X;
  lbm_grad_fields_kernel<<<lbm_blocks(N), LBM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, nf, Z, Y, X, static_cast<float>(12.0 * dx));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lbm_laplacian_field(const float* in, float* out, int Z, int Y, int X, double dx,
                                   void* stream) {
  const long long N = static_cast<long long>(Z) * Y * X;
  lbm_laplacian_kernel<<<lbm_blocks(N), LBM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, Z, Y, X, dx);
  return static_cast<int>(cudaGetLastError());
}
