// Prologue and epilogue kernels.  The epilogue (B5) is described above its
// kernel below.
//
// Prologue: replaces the TPU kernel
// lbm_ferrofluid_tpu/ops/pallas/fused_step.py:lbm_prologue (:721,
// _prologue_kernel :188).  The capillogue's emission (capillogue.cu, step
// (c)) and the epilogue's (emit_mac) launch the same entry point on the
// collided f'/g'.
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
// In bfloat16 storage (T = __nv_bfloat16) f and g take 38 B a cell each:
// 113 B per cell plus 16 B per obstacle cell, 0.57 ms at 256^3.
#include "common.cuh"

extern "C" const char* lbm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

template <class T>
__global__ void lbm_stream_macro_kernel(const T* __restrict__ f, const T* __restrict__ g,
                                        const uint8_t* __restrict__ flags,
                                        const float* __restrict__ rho_old,
                                        const float* __restrict__ vel_old, float* __restrict__ rho,
                                        float* __restrict__ vel, float* __restrict__ den,
                                        float* __restrict__ m0g, float* __restrict__ m1g, int Z,
                                        int Y, int X, double c, LbmGas gas) {
  const long long N = static_cast<long long>(Z) * Y * X;
  const long long i = lbm_cell();
  if (i >= N) return;
  const int x = static_cast<int>(i % X);
  const int y = static_cast<int>((i / X) % Y);
  const int z = static_cast<int>(i / (static_cast<long long>(X) * Y));
  const bool obs = flags[i] == LBM_OBSTACLE;
  const LbmPullOffsets po = lbm_pull_offsets(z, y, x, Z, Y, X);

  float post[19];
  float m0f, m1f[3];
  lbm_pull_at(f, N, i, po, obs, post);
  lbm_moments(post, m0f, m1f);
  float m0, m1[3];
  lbm_pull_at(g, N, i, po, obs, post);
  lbm_moments(post, m0, m1);

  const float r = obs ? rho_old[i] : m0f;
  const float inv_rho = static_cast<float>(c) / r;
  rho[i] = r;
#pragma unroll
  for (int d = 0; d < 3; ++d) vel[d * N + i] = obs ? vel_old[d * N + i] : m1f[d] * inv_rho;
  den[i] = lbm_density_of(r, gas);
  m0g[i] = m0;
#pragma unroll
  for (int d = 0; d < 3; ++d) m1g[d * N + i] = m1[d];
}

// Epilogue: replaces the TPU kernel
// lbm_ferrofluid_tpu/ops/pallas/fused_step.py:lbm_epilogue (:779,
// _epilogue_kernel :300): re-stream and bounce f and g, then the HCZ LBGK
// collide with the capillary stage's 15 macro channels (rho, vel, density,
// pressure, force, dfai, dprho).  The TPU kernel collides in place, which is
// safe there only because its z-ring reads lead its writes; GPU blocks run in
// no order, so one thread per cell pulls its 19 + 19 values and writes f'
// and g' to a second buffer pair.  Non-fluid cells keep their bounced
// values and read no macro field.  The collide is common.cuh's, shared with
// B3 and B9.  With emit_mac the wrapper launches lbm_prologue on f'/g' (the
// TPU kernel's trailing in-kernel stage), with rho_old = rho, vel_old = vel.
//
// Bound on an H100: bytes.  Read f and g and write f' and g' (304 B per
// cell), flags (1 B), and the 15 macro channels at fluid cells (60 B):
// about 1.8 ms at 256^3 over 3.35 TB/s, as B9; the emission adds 36 B per
// cell written and 16 B per obstacle cell read.  About 900 flops per fluid
// cell take about 0.2 ms at 67 TFLOP/s.  In bfloat16 storage f, g, f' and
// g' take half: 153 B per cell plus 60 B per fluid cell, about 1.1 ms; the
// collide rounds once, on the store of f' and g'.
template <class T>
__global__ void __launch_bounds__(LBM_THREADS) lbm_epilogue_kernel(
    const T* __restrict__ f, const T* __restrict__ g, const uint8_t* __restrict__ flags,
    const float* __restrict__ rho, const float* __restrict__ vel, const float* __restrict__ den,
    const float* __restrict__ pres, const float* __restrict__ force,
    const float* __restrict__ dfai, const float* __restrict__ dprho, T* __restrict__ f_out,
    T* __restrict__ g_out, int Z, int Y, int X, LbmHczK k) {
  const long long N = static_cast<long long>(Z) * Y * X;
  const long long i = lbm_cell();
  if (i >= N) return;
  const int x = static_cast<int>(i % X);
  const int y = static_cast<int>((i / X) % Y);
  const int z = static_cast<int>(i / (static_cast<long long>(X) * Y));
  const uint8_t flag = flags[i];
  const LbmPullOffsets po = lbm_pull_offsets(z, y, x, Z, Y, X);
  float post[19];
  if (flag != LBM_FLUID) {
    const bool obs = flag == LBM_OBSTACLE;
    lbm_pull_at(f, N, i, po, obs, post);
#pragma unroll
    for (int q = 0; q < 19; ++q) lbm_st(f_out + q * N + i, post[q]);
    lbm_pull_at(g, N, i, po, obs, post);
#pragma unroll
    for (int q = 0; q < 19; ++q) lbm_st(g_out + q * N + i, post[q]);
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
  lbm_pull_at(f, N, i, po, false, post);
  lbm_hcz_collide_f(h, k, post);
#pragma unroll
  for (int q = 0; q < 19; ++q) lbm_st(f_out + q * N + i, post[q]);
  lbm_pull_at(g, N, i, po, false, post);
  lbm_hcz_collide_g(h, k, post);
#pragma unroll
  for (int q = 0; q < 19; ++q) lbm_st(g_out + q * N + i, post[q]);
}

template <class T>
static void lbm_epilogue_launch(const void* f, const void* g, const uint8_t* flags,
                                const float* rho, const float* vel, const float* den,
                                const float* pres, const float* force, const float* dfai,
                                const float* dprho, void* f_out, void* g_out, int Z, int Y, int X,
                                LbmHczK k, cudaStream_t stream) {
  const long long N = static_cast<long long>(Z) * Y * X;
  lbm_epilogue_kernel<T><<<lbm_blocks(N), LBM_THREADS, 0, stream>>>(
      static_cast<const T*>(f), static_cast<const T*>(g), flags, rho, vel, den, pres, force, dfai,
      dprho, static_cast<T*>(f_out), static_cast<T*>(g_out), Z, Y, X, k);
}

// f, g, f_out and g_out in float32, or in bfloat16 where bf16 is nonzero
extern "C" int lbm_epilogue(const void* f, const void* g, const uint8_t* flags, const float* rho,
                            const float* vel, const float* den, const float* pres,
                            const float* force, const float* dfai, const float* dprho,
                            void* f_out, void* g_out, int Z, int Y, int X, double dx, double dt,
                            double tau_f, double tau_g, int bf16, void* stream) {
  const LbmHczK k = lbm_hcz_consts(dx, dt, tau_f, tau_g);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    lbm_epilogue_launch<__nv_bfloat16>(f, g, flags, rho, vel, den, pres, force, dfai, dprho,
                                       f_out, g_out, Z, Y, X, k, st);
  else
    lbm_epilogue_launch<float>(f, g, flags, rho, vel, den, pres, force, dfai, dprho, f_out,
                               g_out, Z, Y, X, k, st);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
static void lbm_prologue_launch(const void* f, const void* g, const uint8_t* flags,
                                const float* rho_old, const float* vel_old, float* rho,
                                float* vel, float* den, float* m0g, float* m1g, int Z, int Y,
                                int X, double c, LbmGas gas, cudaStream_t stream) {
  const long long N = static_cast<long long>(Z) * Y * X;
  lbm_stream_macro_kernel<T><<<lbm_blocks(N), LBM_THREADS, 0, stream>>>(
      static_cast<const T*>(f), static_cast<const T*>(g), flags, rho_old, vel_old, rho, vel, den,
      m0g, m1g, Z, Y, X, c, gas);
}

// f and g in float32, or in bfloat16 where bf16 is nonzero
extern "C" int lbm_prologue(const void* f, const void* g, const uint8_t* flags,
                            const float* rho_old, const float* vel_old, float* rho, float* vel,
                            float* den, float* m0g, float* m1g, int Z, int Y, int X, double c,
                            double rho_gas, double rho_fluid, double den_gas, double den_fluid,
                            int bf16, void* stream) {
  const LbmGas gas = lbm_gas(rho_gas, rho_fluid, den_gas, den_fluid);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    lbm_prologue_launch<__nv_bfloat16>(f, g, flags, rho_old, vel_old, rho, vel, den, m0g, m1g,
                                       Z, Y, X, c, gas, st);
  else
    lbm_prologue_launch<float>(f, g, flags, rho_old, vel_old, rho, vel, den, m0g, m1g, Z, Y, X,
                               c, gas, st);
  return static_cast<int>(cudaGetLastError());
}
