// Channel-form magnetic Poisson sweeps: replaces the TPU kernel
// lbm_ferrofluid_tpu/ops/pallas/poisson.py:poisson_sweeps (:200,
// _sweep_kernel :120, arithmetic _sweep_math :69).  The TPU's temporally
// blocked variants (poisson_multisweep2 :700, poisson_multisweep :413) and
// its time-skewed wavefront with psi emission (poisson_wavefront :1301)
// compute the same sweeps bit-identically, so this kernel serves them too.
//
// lbm_poisson_sweep runs one sweep over the volume, one thread per cell
// (x fastest, so each of the 19 pulls is a coalesced row):
//   streamed_q = h_q(x - e_q), periodic wrap on every axis
//   psi        = f32(1/(1-w0)) * (streamed_1 + ... + streamed_18)
//                (summed before bounce-back, in ascending q)
//   obstacle:  out_q = streamed_opp(q)
//   otherwise: t = psi / tau, u = t + rhs,
//              out_q = (1 - 1/tau) streamed_q + w_q u, minus t at q = 0
// with the tau == 1 specialisation of _sweep_math (out_q = w_q u, no
// a * streamed_q term), so the arithmetic follows the TPU kernel's.  A sweep
// reads 18 neighbours of every channel, so it cannot run in place: the
// wrapper alternates two buffers so that the last sweep lands in the output
// and the input h is never written; the last sweep also writes psi.
//
// Bound on an H100: a call (n sweeps) must read h (76 B), the flags (1 B)
// and rhs at non-obstacle cells (4 B), and write h' (76 B) and psi (4 B):
// 161 B per cell, 0.81 ms at 256^3 over 3.35 TB/s.  A sweep needs 39 flops
// per non-obstacle cell at tau == 1 and 78 otherwise: 0.29 / 0.59 ms at
// 67 TFLOP/s for 30 sweeps, so bytes bound it.  This first version streams
// the whole distribution once per sweep (157 B per cell and sweep, 23.6 ms
// at 256^3 and 30 sweeps), 29x that bound; keeping k sweeps of a z-window
// in shared memory, as the TPU's multisweep and wavefront do in VMEM, is
// later work.
#include "common.cuh"

template <bool TAU1>
__global__ void lbm_poisson_sweep_kernel(const float* __restrict__ h,
                                         const uint8_t* __restrict__ flags,
                                         const float* __restrict__ rhs, float* __restrict__ out,
                                         float* __restrict__ psi_out, int Z, int Y, int X,
                                         float inv_tau, float a) {
  const long long N = static_cast<long long>(Z) * Y * X;
  const long long i = lbm_cell();
  if (i >= N) return;
  const int x = static_cast<int>(i % X);
  const int y = static_cast<int>((i / X) % Y);
  const int z = static_cast<int>(i / (static_cast<long long>(X) * Y));
  float s[19];
  lbm_pull_cell(h, N, z, y, x, Z, Y, X, false, s);
  float psum = s[1];
#pragma unroll
  for (int q = 2; q < 19; ++q) psum += s[q];
  const float psi = psum * static_cast<float>(1.0 / (1.0 - 1.0 / 3.0));
  if (psi_out != nullptr) psi_out[i] = psi;
  if (flags[i] == LBM_OBSTACLE) {
    const int opp[19] = LBM_D3Q19_OPP;
#pragma unroll
    for (int q = 0; q < 19; ++q) out[q * N + i] = s[opp[q]];
    return;
  }
  const float t = TAU1 ? psi : psi * inv_tau;
  const float u = t + rhs[i];
#pragma unroll
  for (int q = 0; q < 19; ++q) {
    float c = TAU1 ? lbm_weight(q) * u : a * s[q] + lbm_weight(q) * u;
    if (q == 0) c = c - t;
    out[q * N + i] = c;
  }
}

extern "C" int lbm_poisson_sweep(const float* h, const uint8_t* flags, const float* rhs,
                                 float* out, float* psi_out, int Z, int Y, int X, double tau,
                                 void* stream) {
  const long long N = static_cast<long long>(Z) * Y * X;
  const double inv_tau = 1.0 / tau;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (inv_tau == 1.0)
    lbm_poisson_sweep_kernel<true><<<lbm_blocks(N), LBM_THREADS, 0, st>>>(
        h, flags, rhs, out, psi_out, Z, Y, X, 1.f, 0.f);
  else
    lbm_poisson_sweep_kernel<false><<<lbm_blocks(N), LBM_THREADS, 0, st>>>(
        h, flags, rhs, out, psi_out, Z, Y, X, static_cast<float>(inv_tau),
        static_cast<float>(1.0 - inv_tau));
  return static_cast<int>(cudaGetLastError());
}
