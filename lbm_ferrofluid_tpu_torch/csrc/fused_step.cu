// Prologue kernel: replaces the TPU kernel
// lbm_ferrofluid_tpu/ops/pallas/fused_step.py:lbm_prologue (:721,
// _prologue_kernel :188).  The capillogue's emission (capillogue.cu, step
// (c)) launches the same entry point on the collided f'/g'.
//
// One thread per cell pulls its 19 + 19 f and g values (periodic wrap on
// every axis: channels 9-13 come from z-1, 14-18 from z+1), bounces them
// at obstacles, and writes only the macro fields: rho (frozen at
// obstacles), vel = m1f * c / rho (frozen at obstacles), density(rho),
// m0g, m1g.  The post-stream distributions never reach device memory.
//
// Bound on an H100: bytes.  Per cell it must read f and g (76 B each) and
// flags (1 B), rho_old and vel_old only at obstacle cells (16 B there), and
// write 9 float channels (36 B): 189 B per cell plus 16 B per obstacle
// cell, 0.948 ms at 256^3 (2.3 % obstacles) over 3.35 TB/s; about 100 flops
// per cell is far below the float32 rate.  The pulls of neighbouring
// threads are neighbouring addresses within each channel, so the reads
// coalesce; the z+-1 and y+-1 planes are re-read by other blocks from L2.
#include "common.cuh"

extern "C" const char* lbm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

__global__ void lbm_stream_macro_kernel(const float* __restrict__ f, const float* __restrict__ g,
                                        const uint8_t* __restrict__ flags,
                                        const float* __restrict__ rho_old,
                                        const float* __restrict__ vel_old, float* __restrict__ rho,
                                        float* __restrict__ vel, float* __restrict__ den,
                                        float* __restrict__ m0g, float* __restrict__ m1g, int Z,
                                        int Y, int X, double c, double rho_gas, double rho_fluid,
                                        double den_gas, double den_fluid) {
  const long long N = static_cast<long long>(Z) * Y * X;
  const long long i = lbm_cell();
  if (i >= N) return;
  const int x = static_cast<int>(i % X);
  const int y = static_cast<int>((i / X) % Y);
  const int z = static_cast<int>(i / (static_cast<long long>(X) * Y));
  const bool obs = flags[i] == LBM_OBSTACLE;

  float post[19];
  float m0f, m1f[3];
  lbm_pull_cell(f, N, z, y, x, Z, Y, X, obs, post);
  lbm_moments(post, m0f, m1f);
  float m0, m1[3];
  lbm_pull_cell(g, N, z, y, x, Z, Y, X, obs, post);
  lbm_moments(post, m0, m1);

  const float r = obs ? rho_old[i] : m0f;
  const float inv_rho = static_cast<float>(c) / r;
  rho[i] = r;
#pragma unroll
  for (int d = 0; d < 3; ++d) vel[d * N + i] = obs ? vel_old[d * N + i] : m1f[d] * inv_rho;
  den[i] = lbm_density_of(r, rho_gas, rho_fluid, den_gas, den_fluid);
  m0g[i] = m0;
#pragma unroll
  for (int d = 0; d < 3; ++d) m1g[d * N + i] = m1[d];
}

extern "C" int lbm_prologue(const float* f, const float* g, const uint8_t* flags,
                            const float* rho_old, const float* vel_old, float* rho, float* vel,
                            float* den, float* m0g, float* m1g, int Z, int Y, int X, double c,
                            double rho_gas, double rho_fluid, double den_gas, double den_fluid,
                            void* stream) {
  const long long N = static_cast<long long>(Z) * Y * X;
  lbm_stream_macro_kernel<<<lbm_blocks(N), LBM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      f, g, flags, rho_old, vel_old, rho, vel, den, m0g, m1g, Z, Y, X, c, rho_gas, rho_fluid,
      den_gas, den_fluid);
  return static_cast<int>(cudaGetLastError());
}
