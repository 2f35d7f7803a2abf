// Shared pieces of the port's CUDA kernels (compiled for sm_90a).
//
// Layout: every field is a contiguous [C, Z, Y, X] float32 array (the
// batch dimension is 1), channel c of cell i at c * N + i with
// N = Z * Y * X and i = (z * Y + y) * X + x.  Flags are uint8 as stored.
//
// Scalar parameters arrive as doubles and are rounded to float at the
// point of use, which is how the JAX package's Python-float constants
// enter its float32 arithmetic.  Every C entry point returns
// cudaGetLastError() after its launch so that the Python wrapper can raise
// (with the text of lbm_error_string, defined once in fused_step.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define LBM_OBSTACLE 2
#define LBM_FLUID 1
#define LBM_THREADS 256

// D3Q19 velocity set in the reference's order (lattice.py), components x, y, z.
#define LBM_D3Q19_EX {0, 1, 0, -1, 0, 1, -1, -1, 1, 0, 1, 0, -1, 0, 0, 1, 0, -1, 0}
#define LBM_D3Q19_EY {0, 0, 1, 0, -1, 1, 1, -1, -1, 0, 0, 1, 0, -1, 0, 0, 1, 0, -1}
#define LBM_D3Q19_EZ {0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1}
#define LBM_D3Q19_OPP {0, 3, 4, 1, 2, 7, 8, 5, 6, 14, 17, 18, 15, 16, 9, 12, 13, 10, 11}

static inline unsigned lbm_blocks(long long n) {
  return static_cast<unsigned>((n + LBM_THREADS - 1) / LBM_THREADS);
}

__device__ __forceinline__ long long lbm_cell() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int lbm_wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

__device__ __forceinline__ int lbm_clamp(int i, int lo, int hi) {
  return i < lo ? lo : (i > hi ? hi : i);
}

__device__ __forceinline__ long long lbm_index(int z, int y, int x, int Y, int X) {
  return (static_cast<long long>(z) * Y + y) * X + x;
}

// float32-rounded D3Q19 weight of channel q (1/3, 1/18 on the axes, 1/36
// on the diagonals), as lat.w_bcast cast to float32.
__device__ __forceinline__ float lbm_weight(int q) {
  return q == 0 ? static_cast<float>(1.0 / 3.0)
                : ((q <= 4 || q == 9 || q == 14) ? static_cast<float>(1.0 / 18.0)
                                                 : static_cast<float>(1.0 / 36.0));
}

// Linear order-parameter -> density map (ops/moments.py:rho_to_density).
__device__ __forceinline__ float lbm_density_of(float rho, double rho_gas, double rho_fluid,
                                                double den_gas, double den_fluid) {
  return static_cast<float>(den_gas) +
         static_cast<float>(den_fluid - den_gas) *
             ((rho - static_cast<float>(rho_gas)) / static_cast<float>(rho_fluid - rho_gas));
}

// Pull-stream one cell's 19 channels with periodic wrap on every axis, then
// full-way bounce-back at obstacles (ops/stream.py:stream + bounce_back).
__device__ __forceinline__ void lbm_pull_cell(const float* __restrict__ d, long long N, int z,
                                              int y, int x, int Z, int Y, int X, bool obs,
                                              float post[19]) {
  const int ex[19] = LBM_D3Q19_EX;
  const int ey[19] = LBM_D3Q19_EY;
  const int ez[19] = LBM_D3Q19_EZ;
  const int opp[19] = LBM_D3Q19_OPP;
  float s[19];
#pragma unroll
  for (int q = 0; q < 19; ++q) {
    const long long src =
        lbm_index(lbm_wrap(z - ez[q], Z), lbm_wrap(y - ey[q], Y), lbm_wrap(x - ex[q], X), Y, X);
    s[q] = d[q * N + src];
  }
#pragma unroll
  for (int q = 0; q < 19; ++q) post[q] = obs ? s[opp[q]] : s[q];
}

// Raw moments Σ_q p_q and Σ_q p_q e_q, in ascending channel order.
__device__ __forceinline__ void lbm_moments(const float p[19], float& m0, float m1[3]) {
  const int ex[19] = LBM_D3Q19_EX;
  const int ey[19] = LBM_D3Q19_EY;
  const int ez[19] = LBM_D3Q19_EZ;
  m0 = p[0];
#pragma unroll
  for (int q = 1; q < 19; ++q) m0 += p[q];
  float ax = 0.f, ay = 0.f, az = 0.f;
#pragma unroll
  for (int q = 1; q < 19; ++q) {
    if (ex[q] != 0) ax += ex[q] == 1 ? p[q] : -p[q];
    if (ey[q] != 0) ay += ey[q] == 1 ? p[q] : -p[q];
    if (ez[q] != 0) az += ez[q] == 1 ? p[q] : -p[q];
  }
  m1[0] = ax;
  m1[1] = ay;
  m1[2] = az;
}

struct LbmGas {
  double rho_gas, rho_fluid, den_gas, den_fluid;
};

#define LBM_CHI_K 0.33

// Carnahan-Starling pressure minus rho RT (ops/moments.py:eos_pressure)
__device__ __forceinline__ float lbm_fai(float rho, double RT) {
  const float eta = 4.f * rho / 4.f;
  const float om = 1.f - eta;
  const float rt = static_cast<float>(RT);
  const float p = rho * rt * (4.f * eta - 2.f * eta * eta) / (om * om * om) + rho * rt -
                  static_cast<float>(12.0 * RT) * rho * rho;
  return p - rho * rt;
}

// Order parameter phi of a density (ops/moments.py:phi_from_density)
__device__ __forceinline__ float lbm_phi_of(float den, double den_gas, double den_fluid) {
  return -(2.f * (den - static_cast<float>(den_gas)) / static_cast<float>(den_fluid - den_gas) -
           1.f);
}

// chi = CHI_K (1 - smooth_phi(phi, 0.1 dx)) (ops/collide.py:smooth_phi)
__device__ __forceinline__ float lbm_chi_of_phi(float phi, double dx) {
  const double eps = 0.1 * dx;
  const float ramp = 0.5f + static_cast<float>(0.5 / eps) * phi +
                     static_cast<float>(0.5 / 3.141592653589793) *
                         sinf(static_cast<float>(3.141592653589793 / eps) * phi);
  const float sm = (phi > static_cast<float>(eps) ? 1.f : 0.f) +
                   (fabsf(phi) <= static_cast<float>(eps) ? ramp : 0.f);
  return static_cast<float>(LBM_CHI_K) * (1.f - sm);
}

// chi with phi taken from the density (models/ferrofluid.py phi)
__device__ __forceinline__ float lbm_chi(float den, double dx, double den_gas, double den_fluid) {
  return lbm_chi_of_phi(lbm_phi_of(den, den_gas, den_fluid), dx);
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

// 19-point Laplacian (2 faces + edges - 24 centre) / (6 dx^2) at an
// interior cell; S(oz, oy, ox) returns the field at an offset from it
// (ops/stencils.py:isotropic_laplacian).
template <class F>
__device__ __forceinline__ float lbm_laplacian(F S, double dx) {
  const float faces = S(0, 0, 1) + S(0, 0, -1) + S(0, 1, 0) + S(0, -1, 0) + S(1, 0, 0) +
                      S(-1, 0, 0);
  const float edges = S(0, 1, 1) + S(0, 1, -1) + S(0, -1, 1) + S(0, -1, -1) + S(1, 0, 1) +
                      S(1, 0, -1) + S(-1, 0, 1) + S(-1, 0, -1) + S(1, 1, 0) + S(1, -1, 0) +
                      S(-1, 1, 0) + S(-1, -1, 0);
  return (2.f * faces + edges - 24.f * S(0, 0, 0)) / static_cast<float>(6.0 * dx * dx);
}

// ---- capillary stage (ops/collide.py:hcz_capillary) ----------------------
// Inputs: flags, rho_ca, and the derived fields fai, prho, lap (and chi)
// of the capmac.cu derived launch; h2 and chi only with HAS_CHI.  Kernels
// take these as separate __restrict__ parameters and build the struct
// inside: passed as one struct parameter, B3 ran 6 % slower.
struct LbmCapIn {
  const uint8_t* __restrict__ flags;
  const float* __restrict__ rho_ca;
  const float* __restrict__ h2;
  const float* __restrict__ gsum;
  const float* __restrict__ gmom;
  const float* __restrict__ vel_old;
  const float* __restrict__ pres_old;
  const float* __restrict__ fai;
  const float* __restrict__ prho;
  const float* __restrict__ chi;
  const float* __restrict__ lap;
};

struct LbmCapConsts {
  double kappa, grav[3], mu0_half, dx, dt;
  LbmGas gas;
};

struct LbmCapCell {
  float rho, dens, pres;
  float force[3], u[3], dfai[3], dprho[3];
  uint8_t flag;
};

// The capillary stage at cell i = (z, y, x): the 19-point gradients of lap,
// fai, prho (and chi), read around the clamped interior cell (so outputs are
// replicated from the nearest interior cell; z is clamped, not periodic);
// lap and chi are substituted at obstacles by their value at the clamped
// cell, fai and prho are interior-padded already so every tap reads the
// clamped cell.  Then force = kappa dens grad lap + g dens (- mu0/2 H2 grad
// chi) with dens = density(rho_ca), and velocity/pressure recovery at fluid
// cells (the old values elsewhere).
template <bool HAS_CHI>
__device__ __forceinline__ void lbm_capillary_cell(const LbmCapIn& in, const LbmCapConsts& k,
                                                   long long i, long long N, int z, int y, int x,
                                                   int Z, int Y, int X, LbmCapCell& o) {
  const int zc = lbm_clamp(z, 1, Z - 2), yc = lbm_clamp(y, 1, Y - 2), xc = lbm_clamp(x, 1, X - 2);
  const double c = k.dx / k.dt;
  const double RT = c * c / 3.0;
  const float d12 = static_cast<float>(12.0 * k.dx);

  auto clamped = [&](int zz, int yy, int xx) {
    return lbm_index(lbm_clamp(zz, 1, Z - 2), lbm_clamp(yy, 1, Y - 2), lbm_clamp(xx, 1, X - 2),
                     Y, X);
  };
  auto sub = [&](const float* F, int oz, int oy, int ox) -> float {
    const int zz = zc + oz, yy = yc + oy, xx = xc + ox;
    const long long n = lbm_index(zz, yy, xx, Y, X);
    return in.flags[n] == LBM_OBSTACLE ? F[clamped(zz, yy, xx)] : F[n];
  };
  float glap[3], gchi[3];
  lbm_iso_grad([&](int a, int b, int e) { return sub(in.lap, a, b, e); }, d12, glap);
  if (HAS_CHI) lbm_iso_grad([&](int a, int b, int e) { return sub(in.chi, a, b, e); }, d12, gchi);
  lbm_iso_grad([&](int a, int b, int e) { return in.fai[clamped(zc + a, yc + b, xc + e)]; }, d12,
               o.dfai);
  lbm_iso_grad([&](int a, int b, int e) { return in.prho[clamped(zc + a, yc + b, xc + e)]; }, d12,
               o.dprho);

  o.rho = in.rho_ca[i];
  o.dens = lbm_density_of(o.rho, k.gas.rho_gas, k.gas.rho_fluid, k.gas.den_gas, k.gas.den_fluid);
  const float hh = HAS_CHI ? in.h2[i] : 0.f;
  o.flag = in.flags[i];
  const bool fluid = o.flag == LBM_FLUID;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float fd = static_cast<float>(k.kappa) * o.dens * glap[d] + static_cast<float>(k.grav[d]) * o.dens;
    if (HAS_CHI) fd = fd - static_cast<float>(k.mu0_half) * hh * gchi[d];
    o.force[d] = fd;
    o.u[d] = fluid ? (in.gmom[d * N + i] * static_cast<float>(c) +
                      static_cast<float>(0.5 * k.dt * RT) * fd) /
                         static_cast<float>(RT) / o.dens
                   : in.vel_old[d * N + i];
  }
  o.pres = fluid ? in.gsum[i] - static_cast<float>(0.5 * k.dt) *
                                    (o.u[0] * o.dprho[0] + o.u[1] * o.dprho[1] +
                                     o.u[2] * o.dprho[2])
                 : in.pres_old[i];
}

// ---- HCZ LBGK collide (ops/collide.py:hcz_collide) ------------------------
// Per-cell equilibria and forcing terms (ops/pallas/hcz3d.py:_feq_rows,
// _gamma_rows), then the in-place update of one cell's 19 post-stream f or
// g values.  The callers apply it at fluid cells only.
struct LbmHcz {
  float feq[19], gam[19];
  float u[3], force[3], gx, gy, gz, px, py, pz;
  float cf, cs2f, pref_f, pref_g, u_dot_g, u_dot_f, u_dot_p, dens_term, p_term, tauf, taug;
};

__device__ __forceinline__ void lbm_hcz_prepare(LbmHcz& k, float rho, float dens, float pres,
                                                const float u[3], const float force[3],
                                                const float dfai[3], const float dprho[3],
                                                double dx, double dt, double tau_f,
                                                double tau_g) {
  const int ex[19] = LBM_D3Q19_EX;
  const int ey[19] = LBM_D3Q19_EY;
  const int ez[19] = LBM_D3Q19_EZ;
  const double c = dx / dt;
  const double cs2 = c * c / 3.0;
  k.cf = static_cast<float>(c);
  k.cs2f = static_cast<float>(cs2);
  float tax[3], plus[3], minus[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    k.u[d] = u[d];
    k.force[d] = force[d];
    const float un = u[d] / k.cf;
    tax[d] = sqrtf(1.f + 3.f * un * un);
    plus[d] = (2.f * un + tax[d]) / (1.f - un);
    minus[d] = 1.f / plus[d];
  }
  const float base = rho * (2.f - tax[0]) * (2.f - tax[1]) * (2.f - tax[2]);
  const float uv = u[0] * u[0] + u[1] * u[1] + u[2] * u[2];
  k.gx = -dfai[0], k.gy = -dfai[1], k.gz = -dfai[2];
  k.px = -dprho[0], k.py = -dprho[1], k.pz = -dprho[2];
  k.pref_f = static_cast<float>(dt * dt * (1.0 - 0.5 / tau_f) / cs2);
  k.pref_g = static_cast<float>(dt * (1.0 - 0.5 / tau_g));
  k.u_dot_g = u[0] * k.gx + u[1] * k.gy + u[2] * k.gz;
  k.u_dot_f = u[0] * force[0] + u[1] * force[1] + u[2] * force[2];
  k.u_dot_p = u[0] * k.px + u[1] * k.py + u[2] * k.pz;
  k.dens_term = k.cs2f * dens / rho;
  k.p_term = pres - k.cs2f * dens;
  k.tauf = static_cast<float>(tau_f);
  k.taug = static_cast<float>(tau_g);
#pragma unroll
  for (int q = 0; q < 19; ++q) {
    float v = base * lbm_weight(q);
    if (ex[q] == 1) v = v * plus[0];
    if (ex[q] == -1) v = v * minus[0];
    if (ey[q] == 1) v = v * plus[1];
    if (ey[q] == -1) v = v * minus[1];
    if (ez[q] == 1) v = v * plus[2];
    if (ez[q] == -1) v = v * minus[2];
    k.feq[q] = v;
    const float eu = (static_cast<float>(ex[q]) * u[0] + static_cast<float>(ey[q]) * u[1] +
                      static_cast<float>(ez[q]) * u[2]) *
                     k.cf;
    k.gam[q] = lbm_weight(q) *
               (1.f + eu / k.cs2f + 0.5f * eu * eu / (k.cs2f * k.cs2f) - 0.5f * uv / k.cs2f);
  }
}

__device__ __forceinline__ void lbm_hcz_collide_f(const LbmHcz& k, float p[19]) {
  const int ex[19] = LBM_D3Q19_EX;
  const int ey[19] = LBM_D3Q19_EY;
  const int ez[19] = LBM_D3Q19_EZ;
#pragma unroll
  for (int q = 0; q < 19; ++q) {
    const float e_dot_g = (static_cast<float>(ex[q]) * k.gx + static_cast<float>(ey[q]) * k.gy +
                           static_cast<float>(ez[q]) * k.gz) *
                          k.cf;
    const float fq = p[q];
    p[q] = fq + (k.feq[q] - fq) / k.tauf + k.pref_f * k.gam[q] * (e_dot_g - k.u_dot_g);
  }
}

__device__ __forceinline__ void lbm_hcz_collide_g(const LbmHcz& k, float p[19]) {
  const int ex[19] = LBM_D3Q19_EX;
  const int ey[19] = LBM_D3Q19_EY;
  const int ez[19] = LBM_D3Q19_EZ;
#pragma unroll
  for (int q = 0; q < 19; ++q) {
    const float wq = lbm_weight(q);
    const float e_dot_f = (static_cast<float>(ex[q]) * k.force[0] +
                           static_cast<float>(ey[q]) * k.force[1] +
                           static_cast<float>(ez[q]) * k.force[2]) *
                          k.cf;
    const float e_dot_p = (static_cast<float>(ex[q]) * k.px + static_cast<float>(ey[q]) * k.py +
                           static_cast<float>(ez[q]) * k.pz) *
                          k.cf;
    const float gq = p[q];
    const float geq = wq * k.p_term + k.dens_term * k.feq[q];
    p[q] = gq + (geq - gq) / k.taug +
           k.pref_g * (k.gam[q] * (e_dot_f - k.u_dot_f) + (k.gam[q] - wq) * (e_dot_p - k.u_dot_p));
  }
}
