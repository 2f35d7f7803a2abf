// Capillogue: replaces the TPU kernel
// lbm_ferrofluid_tpu/ops/pallas/capillogue.py:lbm_capillogue (:809,
// _capillogue_kernel :99), which runs in one pass the capillary stage, the
// HCZ collide of f and g and the emission of the next step's macros and
// Poisson source term.
//
// The TPU kernel collides in place and emits from collided neighbours held
// in its z-ring.  GPU blocks run in any order with no grid-wide barrier, so
// here the pass is a chain of four launches, and f'/g' go to a second
// buffer pair:
//   (a) lbm_cap_derived (capmac.cu, the capillary stage's first launch):
//       fai = eos(rho) - rho RT, prho = p - RT density, chi(phi(density)),
//       and the 19-point Laplacian of density(rho_ca) with its zero
//       boundary ring, into scratch;
//   (b) lbm_cap_collide: the 19-point gradients of lap, fai, prho and chi
//       (reads clamped to the interior, lap/chi substituted at obstacles,
//       outputs replicated from the nearest interior cell), the force
//       kappa rho grad lap + g rho - mu0/2 H2 grad chi, velocity and
//       pressure recovery, then the pull-stream, bounce-back and HCZ LBGK
//       collide of f and g at the cell; dfai and dprho stay in registers.
//       The capillary stage and the per-cell collide are common.cuh's
//       lbm_capillary_cell and lbm_hcz_*, shared with capmac.cu and
//       hcz3d.cu;
//   (c) lbm_prologue (fused_step.cu) on f'/g' with rho_old = rho_ca and
//       vel_old = the recovered velocity: the next step's rho, vel,
//       density, m0g, m1g;
//   (d) lbm_cap_rhs: the next step's pre-scaled Poisson source from the
//       emitted density (it needs the emitted density at the neighbours).
//
// Bound on an H100: bytes.  The function must read f and g (152 B per
// cell), the two flag fields, rho_pre, density_pre, pressure_old and rho_ca
// at every cell (18 B), H2, g_sum and g_mom only at fluid cells (20 B
// there) and vel_old only at the others (12 B there), and write f', g'
// (152 B) and 15 float channels (60 B): 382 B per cell plus 20 B per fluid
// and 12 B per other cell, 2.01 ms at 256^3 over 3.35 TB/s; its ~1240
// flops per cell take 0.31 ms at 67 TFLOP/s.  The chain reads f and g
// twice (collide, emission) and round-trips 4 scratch fields, about 1.6x
// the bound's bytes.
#include "common.cuh"

__global__ void __launch_bounds__(LBM_THREADS) lbm_cap_collide_kernel(
    const float* __restrict__ f, const float* __restrict__ g, const uint8_t* __restrict__ flags,
    const float* __restrict__ rho_ca, const float* __restrict__ h2,
    const float* __restrict__ gsum, const float* __restrict__ gmom,
    const float* __restrict__ vel_old, const float* __restrict__ pres_old,
    const float* __restrict__ fai, const float* __restrict__ prho,
    const float* __restrict__ chi, const float* __restrict__ lap, float* __restrict__ f_out,
    float* __restrict__ g_out, float* __restrict__ vel_out, float* __restrict__ pres_out,
    float* __restrict__ den_out, int Z, int Y, int X, LbmCapConsts k, double tau_f,
    double tau_g) {
  const long long N = static_cast<long long>(Z) * Y * X;
  const long long i = lbm_cell();
  if (i >= N) return;
  const int x = static_cast<int>(i % X);
  const int y = static_cast<int>((i / X) % Y);
  const int z = static_cast<int>(i / (static_cast<long long>(X) * Y));

  const LbmCapIn in{flags, rho_ca, h2, gsum, gmom, vel_old, pres_old, fai, prho, chi, lap};
  LbmCapCell o;
  lbm_capillary_cell<true>(in, k, i, N, z, y, x, Z, Y, X, o);
  den_out[i] = o.dens;
  pres_out[i] = o.pres;
#pragma unroll
  for (int d = 0; d < 3; ++d) vel_out[d * N + i] = o.u[d];

  const bool fluid = o.flag == LBM_FLUID;
  const bool obs = o.flag == LBM_OBSTACLE;
  LbmHcz h;
  lbm_hcz_prepare(h, o.rho, o.dens, o.pres, o.u, o.force, o.dfai, o.dprho, k.dx, k.dt, tau_f,
                  tau_g);
  float post[19];
  lbm_pull_cell(f, N, z, y, x, Z, Y, X, obs, post);
  if (fluid) lbm_hcz_collide_f(h, post);
#pragma unroll
  for (int q = 0; q < 19; ++q) f_out[q * N + i] = post[q];
  lbm_pull_cell(g, N, z, y, x, Z, Y, X, obs, post);
  if (fluid) lbm_hcz_collide_g(h, post);
#pragma unroll
  for (int q = 0; q < 19; ++q) g_out[q * N + i] = post[q];
}

// Next step's pre-scaled Poisson source from the emitted density, for a
// static field of magnitude hm along the in-plane axis (0 = x, 1 = y):
// exactly ops/magnetic.py:poisson_rhs_scaled with h2_ext.
__global__ void lbm_cap_rhs_kernel(const float* __restrict__ den,
                                   const uint8_t* __restrict__ mflags, float* __restrict__ rhs,
                                   int Z, int Y, int X, int axis, double hm, double tau,
                                   double dx, double dt, double den_gas, double den_fluid) {
  const long long N = static_cast<long long>(Z) * Y * X;
  const long long i = lbm_cell();
  if (i >= N) return;
  const int x = static_cast<int>(i % X);
  const int y = static_cast<int>((i / X) % Y);
  const int j = axis == 0 ? x : y;
  const int n = axis == 0 ? X : Y;
  const long long step = axis == 0 ? 1 : X;
  const long long ip = j < n - 1 ? i + step : i;
  const long long im = j > 0 ? i - step : i;
  const float ch = lbm_chi(den[i], dx, den_gas, den_fluid);
  const float chp = lbm_chi(den[ip], dx, den_gas, den_fluid);
  const float chm = lbm_chi(den[im], dx, den_gas, den_fluid);
  const float h = static_cast<float>(hm);
  float d = (0.5f * (ch + chp)) * h - (0.5f * (chm + ch)) * h;
  if (j == 0 || j == n - 1) d = 0.f;
  float r = d * static_cast<float>(dx) / (1.f + ch);
  if (mflags[i] != LBM_FLUID) r = 0.f;
  const double cs2 = (dx / dt) * (dx / dt) / 3.0;
  rhs[i] = (static_cast<float>(dt) * r) * static_cast<float>(cs2 * (0.5 - tau) * dt);
}

extern "C" int lbm_cap_collide(const float* f, const float* g, const uint8_t* flags,
                               const float* rho_ca, const float* h2, const float* gsum,
                               const float* gmom, const float* vel_old, const float* pres_old,
                               const float* fai, const float* prho, const float* chi,
                               const float* lap, float* f_out, float* g_out, float* vel_out,
                               float* pres_out, float* den_out, int Z, int Y, int X,
                               double kappa, double grav_x, double grav_y, double grav_z,
                               double mu0_half, double tau_f, double tau_g, double dx, double dt,
                               double rho_gas, double rho_fluid, double den_gas,
                               double den_fluid, void* stream) {
  const long long N = static_cast<long long>(Z) * Y * X;
  const LbmCapConsts k{kappa, {grav_x, grav_y, grav_z}, mu0_half, dx, dt,
                       LbmGas{rho_gas, rho_fluid, den_gas, den_fluid}};
  lbm_cap_collide_kernel<<<lbm_blocks(N), LBM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      f, g, flags, rho_ca, h2, gsum, gmom, vel_old, pres_old, fai, prho, chi, lap, f_out, g_out,
      vel_out, pres_out, den_out, Z, Y, X, k, tau_f, tau_g);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lbm_cap_rhs(const float* den, const uint8_t* mflags, float* rhs, int Z, int Y,
                           int X, int axis, double hm, double tau, double dx, double dt,
                           double den_gas, double den_fluid, void* stream) {
  const long long N = static_cast<long long>(Z) * Y * X;
  lbm_cap_rhs_kernel<<<lbm_blocks(N), LBM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      den, mflags, rhs, Z, Y, X, axis, hm, tau, dx, dt, den_gas, den_fluid);
  return static_cast<int>(cudaGetLastError());
}
