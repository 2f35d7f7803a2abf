// Stream + bounce of one distribution: replaces the TPU kernels
// lbm_ferrofluid_tpu/ops/pallas/stream3d.py:stream_bounce_moments (:164,
// _kernel :126) and stream_bounce_macro (:231, _macro_kernel :83).
//
// One thread per cell pulls its 19 values with periodic wrap on every axis
// (the TPU kernel wraps z through its BlockSpec index maps and y, x with
// pltpu.roll), bounces them at obstacles (common.cuh's lbm_pull_at, as
// the prologue does), writes them (the TPU kernels' out_ref) and then
//   lbm_stream_moments3d: the raw moments m0 = sum_q f_q, m1 = sum_q f_q e_q;
//   lbm_stream_macro3d:   rho = m0 and vel = m1 c / rho (both frozen at
//                         obstacles to rho_old, vel_old) and density(rho).
// Two entry points, as the JAX package calls them separately.
//
// Bound on an H100: bytes.  Per cell, read f (76 B) and flags (1 B) and
// write f_post (76 B) and the moments (16 B): 169 B; the macro kernel also
// reads rho_old and vel_old at obstacles (16 B there) and writes density
// (4 B): 173 B.  At 256^3 that is about 0.85 and 0.87 ms over 3.35 TB/s;
// ~50 flops per cell are far below the float32 rate.  The pulls of
// neighbouring threads are neighbouring addresses within each channel, so
// reads and writes coalesce.
#include "common.cuh"

__global__ void lbm_stream_moments3d_kernel(const float* __restrict__ f,
                                            const uint8_t* __restrict__ flags,
                                            float* __restrict__ f_post, float* __restrict__ m0,
                                            float* __restrict__ m1, int Z, int Y, int X) {
  const long long N = static_cast<long long>(Z) * Y * X;
  const long long i = lbm_cell();
  if (i >= N) return;
  const int x = static_cast<int>(i % X);
  const int y = static_cast<int>((i / X) % Y);
  const int z = static_cast<int>(i / (static_cast<long long>(X) * Y));
  float post[19];
  lbm_pull_at(f, N, i, lbm_pull_offsets(z, y, x, Z, Y, X), flags[i] == LBM_OBSTACLE, post);
#pragma unroll
  for (int q = 0; q < 19; ++q) f_post[q * N + i] = post[q];
  float s, m[3];
  lbm_moments(post, s, m);
  m0[i] = s;
#pragma unroll
  for (int d = 0; d < 3; ++d) m1[d * N + i] = m[d];
}

__global__ void lbm_stream_macro3d_kernel(const float* __restrict__ f,
                                          const uint8_t* __restrict__ flags,
                                          const float* __restrict__ rho_old,
                                          const float* __restrict__ vel_old,
                                          float* __restrict__ f_post, float* __restrict__ rho,
                                          float* __restrict__ vel, float* __restrict__ den, int Z,
                                          int Y, int X, double c, LbmGas gas) {
  const long long N = static_cast<long long>(Z) * Y * X;
  const long long i = lbm_cell();
  if (i >= N) return;
  const int x = static_cast<int>(i % X);
  const int y = static_cast<int>((i / X) % Y);
  const int z = static_cast<int>(i / (static_cast<long long>(X) * Y));
  const bool obs = flags[i] == LBM_OBSTACLE;
  float post[19];
  lbm_pull_at(f, N, i, lbm_pull_offsets(z, y, x, Z, Y, X), obs, post);
#pragma unroll
  for (int q = 0; q < 19; ++q) f_post[q * N + i] = post[q];
  float m0, m1[3];
  lbm_moments(post, m0, m1);
  const float r = obs ? rho_old[i] : m0;
  const float inv_rho = static_cast<float>(c) / r;
  rho[i] = r;
#pragma unroll
  for (int d = 0; d < 3; ++d) vel[d * N + i] = obs ? vel_old[d * N + i] : m1[d] * inv_rho;
  den[i] = lbm_density_of(r, gas);
}

extern "C" int lbm_stream_moments3d(const float* f, const uint8_t* flags, float* f_post, float* m0,
                                    float* m1, int Z, int Y, int X, void* stream) {
  const long long N = static_cast<long long>(Z) * Y * X;
  lbm_stream_moments3d_kernel<<<lbm_blocks(N), LBM_THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(f, flags, f_post, m0, m1, Z,
                                                                     Y, X);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lbm_stream_macro3d(const float* f, const uint8_t* flags, const float* rho_old,
                                  const float* vel_old, float* f_post, float* rho, float* vel,
                                  float* den, int Z, int Y, int X, double c, double rho_gas,
                                  double rho_fluid, double den_gas, double den_fluid,
                                  void* stream) {
  const long long N = static_cast<long long>(Z) * Y * X;
  lbm_stream_macro3d_kernel<<<lbm_blocks(N), LBM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      f, flags, rho_old, vel_old, f_post, rho, vel, den, Z, Y, X, c,
      lbm_gas(rho_gas, rho_fluid, den_gas, den_fluid));
  return static_cast<int>(cudaGetLastError());
}
