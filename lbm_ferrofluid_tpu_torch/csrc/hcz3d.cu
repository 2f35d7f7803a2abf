// HCZ collide: replaces the TPU kernel
// lbm_ferrofluid_tpu/ops/pallas/hcz3d.py:hcz_collide_fused (:142; _f_kernel
// :77 and _g_kernel :100, two pallas_calls because all inputs of one tile
// exceeded VMEM), the LBGK collide of the post-stream f and g with Guo
// forcing, feq, geq and Gamma computed in registers.
//
// Here one thread per cell updates both f and g in one launch, out of place
// into f', g'.  Fluid cells read the seven macro fields and run common.cuh's
// collide (lbm_hcz_prepare / lbm_hcz_collide_f / lbm_hcz_collide_g: per-cell
// scalars, feq and Gamma recomputed per channel, reciprocals of the launch
// constants; the capillogue's and the epilogue's collide run the same device
// code); other cells copy their streamed (bounced) values and read no macro
// field.
//
// Bound on an H100: bytes.  Read and write f and g (304 B per cell), read
// flags (1 B), and at fluid cells rho, density, pressure, vel, force, dfai
// and dprho (60 B): about 1.8 ms at 256^3 over 3.35 TB/s; ~900 flops per
// fluid cell take about 0.2 ms at 67 TFLOP/s.  In bfloat16 storage (T =
// __nv_bfloat16) f, g, f' and g' take half: 153 B per cell plus 60 B per
// fluid cell, about 1.1 ms; the collide rounds once, on the store.
#include "common.cuh"

template <class T>
__global__ void __launch_bounds__(LBM_THREADS) lbm_hcz_collide_kernel(
    const T* __restrict__ f, const T* __restrict__ g, const uint8_t* __restrict__ flags,
    const float* __restrict__ rho, const float* __restrict__ vel, const float* __restrict__ den,
    const float* __restrict__ pres, const float* __restrict__ force,
    const float* __restrict__ dfai, const float* __restrict__ dprho, T* __restrict__ f_out,
    T* __restrict__ g_out, long long N, LbmHczK k) {
  const long long i = lbm_cell();
  if (i >= N) return;
  if (flags[i] != LBM_FLUID) {
#pragma unroll
    for (int q = 0; q < 19; ++q) f_out[q * N + i] = f[q * N + i];
#pragma unroll
    for (int q = 0; q < 19; ++q) g_out[q * N + i] = g[q * N + i];
    return;
  }
  float u[3], fo[3], df[3], dp[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    u[d] = vel[d * N + i];
    fo[d] = force[d * N + i];
    df[d] = dfai[d * N + i];
    dp[d] = dprho[d * N + i];
  }
  LbmHczCell h;
  lbm_hcz_prepare(h, k, rho[i], den[i], pres[i], u, fo, df, dp);
  float p[19];
#pragma unroll
  for (int q = 0; q < 19; ++q) p[q] = lbm_ld(f + q * N + i);
  lbm_hcz_collide_f(h, k, p);
#pragma unroll
  for (int q = 0; q < 19; ++q) lbm_st(f_out + q * N + i, p[q]);
#pragma unroll
  for (int q = 0; q < 19; ++q) p[q] = lbm_ld(g + q * N + i);
  lbm_hcz_collide_g(h, k, p);
#pragma unroll
  for (int q = 0; q < 19; ++q) lbm_st(g_out + q * N + i, p[q]);
}

template <class T>
static void lbm_hcz_collide_launch(const void* f, const void* g, const uint8_t* flags,
                                   const float* rho, const float* vel, const float* den,
                                   const float* pres, const float* force, const float* dfai,
                                   const float* dprho, void* f_out, void* g_out, long long N,
                                   LbmHczK k, cudaStream_t stream) {
  lbm_hcz_collide_kernel<T><<<lbm_blocks(N), LBM_THREADS, 0, stream>>>(
      static_cast<const T*>(f), static_cast<const T*>(g), flags, rho, vel, den, pres, force, dfai,
      dprho, static_cast<T*>(f_out), static_cast<T*>(g_out), N, k);
}

// f, g, f_out and g_out in float32, or in bfloat16 where bf16 is nonzero
extern "C" int lbm_hcz_collide(const void* f, const void* g, const uint8_t* flags,
                               const float* rho, const float* vel, const float* den,
                               const float* pres, const float* force, const float* dfai,
                               const float* dprho, void* f_out, void* g_out, int Z, int Y, int X,
                               double dx, double dt, double tau_f, double tau_g, int bf16,
                               void* stream) {
  const long long N = static_cast<long long>(Z) * Y * X;
  const LbmHczK k = lbm_hcz_consts(dx, dt, tau_f, tau_g);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    lbm_hcz_collide_launch<__nv_bfloat16>(f, g, flags, rho, vel, den, pres, force, dfai, dprho,
                                          f_out, g_out, N, k, st);
  else
    lbm_hcz_collide_launch<float>(f, g, flags, rho, vel, den, pres, force, dfai, dprho, f_out,
                                  g_out, N, k, st);
  return static_cast<int>(cudaGetLastError());
}
