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
//   (a) lbm_cap_derived: fai = eos(rho) - rho RT, prho = p - RT density,
//       chi(phi(density)), and the 19-point Laplacian of density(rho_ca)
//       with its zero boundary ring, into scratch;
//   (b) lbm_cap_collide: the 19-point gradients of lap, fai, prho and chi
//       (reads clamped to the interior, lap/chi substituted at obstacles,
//       outputs replicated from the nearest interior cell), the force
//       kappa rho grad lap + g rho - mu0/2 H2 grad chi, velocity and
//       pressure recovery, then the pull-stream, bounce-back and HCZ LBGK
//       collide of f and g at the cell; dfai and dprho stay in registers;
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

#define LBM_CHI_K 0.33

struct LbmGas {
  double rho_gas, rho_fluid, den_gas, den_fluid;
};

// Carnahan-Starling pressure minus rho RT (ops/moments.py:eos_pressure)
__device__ __forceinline__ float lbm_fai(float rho, double RT) {
  const float eta = 4.f * rho / 4.f;
  const float om = 1.f - eta;
  const float rt = static_cast<float>(RT);
  const float p = rho * rt * (4.f * eta - 2.f * eta * eta) / (om * om * om) + rho * rt -
                  static_cast<float>(12.0 * RT) * rho * rho;
  return p - rho * rt;
}

// chi = CHI_K (1 - smooth_phi(phi, 0.1 dx)) with phi from the density
// (models/ferrofluid.py phi; ops/collide.py:smooth_phi)
__device__ __forceinline__ float lbm_chi(float den, double dx, double den_gas, double den_fluid) {
  const float phi = -(2.f * (den - static_cast<float>(den_gas)) /
                          static_cast<float>(den_fluid - den_gas) -
                      1.f);
  const double eps = 0.1 * dx;
  const float ramp = 0.5f + static_cast<float>(0.5 / eps) * phi +
                     static_cast<float>(0.5 / 3.141592653589793) *
                         sinf(static_cast<float>(3.141592653589793 / eps) * phi);
  const float sm = (phi > static_cast<float>(eps) ? 1.f : 0.f) +
                   (fabsf(phi) <= static_cast<float>(eps) ? ramp : 0.f);
  return static_cast<float>(LBM_CHI_K) * (1.f - sm);
}

__global__ void lbm_cap_derived_kernel(const float* __restrict__ rho_pre,
                                       const float* __restrict__ den_pre,
                                       const float* __restrict__ pres_old,
                                       const float* __restrict__ rho_ca, float* __restrict__ fai,
                                       float* __restrict__ prho, float* __restrict__ chi,
                                       float* __restrict__ lap, int Z, int Y, int X, double dx,
                                       double dt, LbmGas gas) {
  const long long N = static_cast<long long>(Z) * Y * X;
  const long long i = lbm_cell();
  if (i >= N) return;
  const int x = static_cast<int>(i % X);
  const int y = static_cast<int>((i / X) % Y);
  const int z = static_cast<int>(i / (static_cast<long long>(X) * Y));
  const double c = dx / dt;
  const double RT = c * c / 3.0;
  fai[i] = lbm_fai(rho_pre[i], RT);
  prho[i] = pres_old[i] - static_cast<float>(RT) * den_pre[i];
  chi[i] = lbm_chi(den_pre[i], dx, gas.den_gas, gas.den_fluid);
  float l = 0.f;
  if (z >= 1 && z <= Z - 2 && y >= 1 && y <= Y - 2 && x >= 1 && x <= X - 2) {
    auto S = [&](int oz, int oy, int ox) -> float {
      return lbm_density_of(rho_ca[lbm_index(z + oz, y + oy, x + ox, Y, X)], gas.rho_gas,
                            gas.rho_fluid, gas.den_gas, gas.den_fluid);
    };
    const float faces = S(0, 0, 1) + S(0, 0, -1) + S(0, 1, 0) + S(0, -1, 0) + S(1, 0, 0) +
                        S(-1, 0, 0);
    const float edges = S(0, 1, 1) + S(0, 1, -1) + S(0, -1, 1) + S(0, -1, -1) + S(1, 0, 1) +
                        S(1, 0, -1) + S(-1, 0, 1) + S(-1, 0, -1) + S(1, 1, 0) + S(1, -1, 0) +
                        S(-1, 1, 0) + S(-1, -1, 0);
    l = (2.f * faces + edges - 24.f * S(0, 0, 0)) / static_cast<float>(6.0 * dx * dx);
  }
  lap[i] = l;
}

// 19-point isotropic gradient at the interior cell (zc, yc, xc); S(oz, oy,
// ox) returns the (substituted) field value at an offset from it.
template <class F>
__device__ __forceinline__ void lbm_iso_grad(F S, float d12, float g[3]) {
  g[0] = (2.f * (S(0, 0, 1) - S(0, 0, -1)) +
          (S(1, 0, 1) - S(-1, 0, -1) + S(-1, 0, 1) - S(1, 0, -1) + S(0, 1, 1) - S(0, -1, -1) +
           S(0, -1, 1) - S(0, 1, -1))) /
         d12;
  g[1] = (2.f * (S(0, 1, 0) - S(0, -1, 0)) +
          (S(1, 1, 0) - S(-1, -1, 0) + S(-1, 1, 0) - S(1, -1, 0) + S(0, 1, 1) - S(0, -1, -1) +
           S(0, 1, -1) - S(0, -1, 1))) /
         d12;
  g[2] = (2.f * (S(1, 0, 0) - S(-1, 0, 0)) +
          (S(1, 1, 0) - S(-1, -1, 0) + S(1, -1, 0) - S(-1, 1, 0) + S(1, 0, 1) - S(-1, 0, -1) +
           S(1, 0, -1) - S(-1, 0, 1))) /
         d12;
}

__global__ void __launch_bounds__(LBM_THREADS) lbm_cap_collide_kernel(
    const float* __restrict__ f, const float* __restrict__ g, const uint8_t* __restrict__ flags,
    const float* __restrict__ rho_ca, const float* __restrict__ h2,
    const float* __restrict__ gsum, const float* __restrict__ gmom,
    const float* __restrict__ vel_old, const float* __restrict__ pres_old,
    const float* __restrict__ fai, const float* __restrict__ prho,
    const float* __restrict__ chi, const float* __restrict__ lap, float* __restrict__ f_out,
    float* __restrict__ g_out, float* __restrict__ vel_out, float* __restrict__ pres_out,
    float* __restrict__ den_out, int Z, int Y, int X, double kappa, double grav_x,
    double grav_y, double grav_z, double mu0_half, double tau_f, double tau_g, double dx,
    double dt, LbmGas gas) {
  const long long N = static_cast<long long>(Z) * Y * X;
  const long long i = lbm_cell();
  if (i >= N) return;
  const int x = static_cast<int>(i % X);
  const int y = static_cast<int>((i / X) % Y);
  const int z = static_cast<int>(i / (static_cast<long long>(X) * Y));
  const int zc = lbm_clamp(z, 1, Z - 2), yc = lbm_clamp(y, 1, Y - 2), xc = lbm_clamp(x, 1, X - 2);
  const double c = dx / dt;
  const double cs2 = c * c / 3.0;
  const double RT = cs2;
  const float d12 = static_cast<float>(12.0 * dx);

  // ---- capillary stage -------------------------------------------------
  // fai/prho are replicate-padded from the interior, so every tap reads the
  // clamped cell; lap/chi are replaced by that value only at obstacles
  auto clamped = [&](int zz, int yy, int xx) {
    return lbm_index(lbm_clamp(zz, 1, Z - 2), lbm_clamp(yy, 1, Y - 2), lbm_clamp(xx, 1, X - 2),
                     Y, X);
  };
  auto sub = [&](const float* F, int oz, int oy, int ox) -> float {
    const int zz = zc + oz, yy = yc + oy, xx = xc + ox;
    const long long n = lbm_index(zz, yy, xx, Y, X);
    return flags[n] == LBM_OBSTACLE ? F[clamped(zz, yy, xx)] : F[n];
  };
  float glap[3], gchi[3], dfai[3], dprho[3];
  lbm_iso_grad([&](int a, int b, int e) { return sub(lap, a, b, e); }, d12, glap);
  lbm_iso_grad([&](int a, int b, int e) { return sub(chi, a, b, e); }, d12, gchi);
  lbm_iso_grad([&](int a, int b, int e) { return fai[clamped(zc + a, yc + b, xc + e)]; }, d12,
               dfai);
  lbm_iso_grad([&](int a, int b, int e) { return prho[clamped(zc + a, yc + b, xc + e)]; }, d12,
               dprho);

  const float rho = rho_ca[i];
  const float dens = lbm_density_of(rho, gas.rho_gas, gas.rho_fluid, gas.den_gas, gas.den_fluid);
  const float hh = h2[i];
  const float grav[3] = {static_cast<float>(grav_x), static_cast<float>(grav_y),
                         static_cast<float>(grav_z)};
  const uint8_t fl = flags[i];
  const bool fluid = fl == LBM_FLUID;
  float force[3], u[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    force[d] = static_cast<float>(kappa) * dens * glap[d] + grav[d] * dens -
               static_cast<float>(mu0_half) * hh * gchi[d];
    u[d] = fluid ? (gmom[d * N + i] * static_cast<float>(c) +
                    static_cast<float>(0.5 * dt * RT) * force[d]) /
                       static_cast<float>(RT) / dens
                 : vel_old[d * N + i];
  }
  const float pres = fluid ? gsum[i] - static_cast<float>(0.5 * dt) *
                                           (u[0] * dprho[0] + u[1] * dprho[1] + u[2] * dprho[2])
                           : pres_old[i];
  den_out[i] = dens;
  pres_out[i] = pres;
#pragma unroll
  for (int d = 0; d < 3; ++d) vel_out[d * N + i] = u[d];

  // ---- HCZ LBGK collide (ops/pallas/hcz3d.py:_feq_rows, _gamma_rows) ----
  const int ex[19] = LBM_D3Q19_EX;
  const int ey[19] = LBM_D3Q19_EY;
  const int ez[19] = LBM_D3Q19_EZ;
  const bool obs = fl == LBM_OBSTACLE;
  const float cf = static_cast<float>(c);
  const float cs2f = static_cast<float>(cs2);
  float tax[3], plus[3], minus[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float un = u[d] / cf;
    tax[d] = sqrtf(1.f + 3.f * un * un);
    plus[d] = (2.f * un + tax[d]) / (1.f - un);
    minus[d] = 1.f / plus[d];
  }
  const float base = rho * (2.f - tax[0]) * (2.f - tax[1]) * (2.f - tax[2]);
  const float uv = u[0] * u[0] + u[1] * u[1] + u[2] * u[2];
  const float gx = -dfai[0], gy = -dfai[1], gz = -dfai[2];
  const float px = -dprho[0], py = -dprho[1], pz = -dprho[2];
  const float pref_f = static_cast<float>(dt * dt * (1.0 - 0.5 / tau_f) / cs2);
  const float pref_g = static_cast<float>(dt * (1.0 - 0.5 / tau_g));
  const float u_dot_g = u[0] * gx + u[1] * gy + u[2] * gz;
  const float u_dot_f = u[0] * force[0] + u[1] * force[1] + u[2] * force[2];
  const float u_dot_p = u[0] * px + u[1] * py + u[2] * pz;
  const float dens_term = cs2f * dens / rho;
  const float p_term = pres - cs2f * dens;
  const float tauf = static_cast<float>(tau_f), taug = static_cast<float>(tau_g);

  float post[19];
  float feq[19], gam[19];
#pragma unroll
  for (int q = 0; q < 19; ++q) {
    float v = base * lbm_weight(q);
    if (ex[q] == 1) v = v * plus[0];
    if (ex[q] == -1) v = v * minus[0];
    if (ey[q] == 1) v = v * plus[1];
    if (ey[q] == -1) v = v * minus[1];
    if (ez[q] == 1) v = v * plus[2];
    if (ez[q] == -1) v = v * minus[2];
    feq[q] = v;
    const float eu = (static_cast<float>(ex[q]) * u[0] + static_cast<float>(ey[q]) * u[1] +
                      static_cast<float>(ez[q]) * u[2]) *
                     cf;
    gam[q] = lbm_weight(q) *
             (1.f + eu / cs2f + 0.5f * eu * eu / (cs2f * cs2f) - 0.5f * uv / cs2f);
  }
  lbm_pull_cell(f, N, z, y, x, Z, Y, X, obs, post);
#pragma unroll
  for (int q = 0; q < 19; ++q) {
    const float e_dot_g = (static_cast<float>(ex[q]) * gx + static_cast<float>(ey[q]) * gy +
                           static_cast<float>(ez[q]) * gz) *
                          cf;
    const float fq = post[q];
    const float coll = fq + (feq[q] - fq) / tauf + pref_f * gam[q] * (e_dot_g - u_dot_g);
    f_out[q * N + i] = fluid ? coll : fq;
  }
  lbm_pull_cell(g, N, z, y, x, Z, Y, X, obs, post);
#pragma unroll
  for (int q = 0; q < 19; ++q) {
    const float wq = lbm_weight(q);
    const float e_dot_f = (static_cast<float>(ex[q]) * force[0] +
                           static_cast<float>(ey[q]) * force[1] +
                           static_cast<float>(ez[q]) * force[2]) *
                          cf;
    const float e_dot_p = (static_cast<float>(ex[q]) * px + static_cast<float>(ey[q]) * py +
                           static_cast<float>(ez[q]) * pz) *
                          cf;
    const float gq = post[q];
    const float geq = wq * p_term + dens_term * feq[q];
    const float coll = gq + (geq - gq) / taug +
                       pref_g * (gam[q] * (e_dot_f - u_dot_f) + (gam[q] - wq) * (e_dot_p - u_dot_p));
    g_out[q * N + i] = fluid ? coll : gq;
  }
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

extern "C" int lbm_cap_derived(const float* rho_pre, const float* den_pre, const float* pres_old,
                               const float* rho_ca, float* fai, float* prho, float* chi,
                               float* lap, int Z, int Y, int X, double dx, double dt,
                               double rho_gas, double rho_fluid, double den_gas,
                               double den_fluid, void* stream) {
  const long long N = static_cast<long long>(Z) * Y * X;
  lbm_cap_derived_kernel<<<lbm_blocks(N), LBM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      rho_pre, den_pre, pres_old, rho_ca, fai, prho, chi, lap, Z, Y, X, dx, dt,
      LbmGas{rho_gas, rho_fluid, den_gas, den_fluid});
  return static_cast<int>(cudaGetLastError());
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
  lbm_cap_collide_kernel<<<lbm_blocks(N), LBM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      f, g, flags, rho_ca, h2, gsum, gmom, vel_old, pres_old, fai, prho, chi, lap, f_out, g_out,
      vel_out, pres_out, den_out, Z, Y, X, kappa, grav_x, grav_y, grav_z, mu0_half, tau_f, tau_g,
      dx, dt, LbmGas{rho_gas, rho_fluid, den_gas, den_fluid});
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
