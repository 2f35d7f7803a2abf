// Shared pieces of the port's CUDA kernels (compiled for sm_90a).
//
// Layout: every field is a contiguous [C, Z, Y, X] float32 array (the
// batch dimension is 1), channel c of cell i at c * N + i with
// N = Z * Y * X and i = (z * Y + y) * X + x.  Flags are uint8 as stored.
// The distributions f, g and h are stored in float32 or, in the JAX
// package's turbo mode, in bfloat16: kernels that read or write them are
// templates on the storage type T, load through lbm_ld (exact widening to
// float) and store through lbm_st (round to nearest even, as JAX's astype),
// and compute in float32 either way.  Entry points take such pointers as
// void* with an int bf16 that picks the instance.
//
// Scalar parameters arrive as doubles and are rounded to float, which is
// how the JAX package's Python-float constants enter its float32
// arithmetic: at the point of use, or once on the host into the constant
// structs below (LbmGas, LbmCapF, LbmHczK) where a kernel would otherwise
// divide by them or do double arithmetic per thread; a division by such a
// constant becomes a product with its reciprocal, which moves the term by
// at most an ulp.  Every C entry point returns
// cudaGetLastError() after its launch so that the Python wrapper can raise
// (with the text of lbm_error_string, defined once in fused_step.cu).
#pragma once

#include <cuda_bf16.h>
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

// ---- storage of f, g and h --------------------------------------------------
__device__ __forceinline__ float lbm_ld(const float* p) { return *p; }
__device__ __forceinline__ float lbm_ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void lbm_st(float* p, float v) { *p = v; }
__device__ __forceinline__ void lbm_st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// A streaming (evict-first) store, rounded as lbm_st rounds.
__device__ __forceinline__ void lbm_stcs(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void lbm_stcs(__nv_bfloat16* p, float v) {
  __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

static inline unsigned lbm_blocks(long long n) {
  return static_cast<unsigned>((n + LBM_THREADS - 1) / LBM_THREADS);
}

__device__ __forceinline__ long long lbm_cell() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int lbm_clamp(int i, int lo, int hi) {
  return i < lo ? lo : (i > hi ? hi : i);
}

__device__ __forceinline__ long long lbm_index(int z, int y, int x, int Y, int X) {
  return (static_cast<long long>(z) * Y + y) * X + x;
}

// a mod n in [0, n), for the periodic wrap of an index that may be negative
__device__ __forceinline__ int lbm_mod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// float32-rounded D3Q19 weight of channel q (1/3, 1/18 on the axes, 1/36
// on the diagonals), as lat.w_bcast cast to float32.
__device__ __forceinline__ float lbm_weight(int q) {
  return q == 0 ? static_cast<float>(1.0 / 3.0)
                : ((q <= 4 || q == 9 || q == 14) ? static_cast<float>(1.0 / 18.0)
                                                 : static_cast<float>(1.0 / 36.0));
}

static inline float lbm_f32(double v) { return static_cast<float>(v); }

// Constants of the linear order-parameter -> density map, rounded to float
// once on the host: rho_gas, rho_fluid - rho_gas, den_gas, den_fluid - den_gas.
struct LbmGas {
  float rho_gas, drho, den_gas, dden;
};

static inline LbmGas lbm_gas(double rho_gas, double rho_fluid, double den_gas, double den_fluid) {
  return LbmGas{lbm_f32(rho_gas), lbm_f32(rho_fluid - rho_gas), lbm_f32(den_gas),
                lbm_f32(den_fluid - den_gas)};
}

// Linear order-parameter -> density map (ops/moments.py:rho_to_density).
__device__ __forceinline__ float lbm_density_of(float rho, const LbmGas& g) {
  return g.den_gas + g.dden * ((rho - g.rho_gas) / g.drho);
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

// Order parameter phi of a density (ops/moments.py:phi_from_density), with
// den_gas and dden = den_fluid - den_gas as LbmGas holds them
__device__ __forceinline__ float lbm_phi_of(float den, float den_gas, float dden) {
  return -(2.f * (den - den_gas) / dden - 1.f);
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
__device__ __forceinline__ float lbm_chi(float den, double dx, float den_gas, float dden) {
  return lbm_chi_of_phi(lbm_phi_of(den, den_gas, dden), dx);
}

// Numerators of the 19-point isotropic gradient at the interior cell
// (zc, yc, xc); S(oz, oy, ox) returns the (substituted) field value at an
// offset from it.  The gradient is these sums over 12 dx.
template <class F>
__device__ __forceinline__ void lbm_iso_sums(F S, float g[3]) {
  g[0] = 2.f * (S(0, 0, 1) - S(0, 0, -1)) +
         (S(1, 0, 1) - S(-1, 0, -1) + S(-1, 0, 1) - S(1, 0, -1) + S(0, 1, 1) - S(0, -1, -1) +
          S(0, -1, 1) - S(0, 1, -1));
  g[1] = 2.f * (S(0, 1, 0) - S(0, -1, 0)) +
         (S(1, 1, 0) - S(-1, -1, 0) + S(-1, 1, 0) - S(1, -1, 0) + S(0, 1, 1) - S(0, -1, -1) +
          S(0, 1, -1) - S(0, -1, 1));
  g[2] = 2.f * (S(1, 0, 0) - S(-1, 0, 0)) +
         (S(1, 1, 0) - S(-1, -1, 0) + S(1, -1, 0) - S(-1, 1, 0) + S(1, 0, 1) - S(-1, 0, -1) +
          S(1, 0, -1) - S(-1, 0, 1));
}

// a / b; with ZERO, a zero numerator is returned as it is, the quotient's
// value and sign for b > 0.  The IEEE division takes a slow path for a zero
// numerator, which B10a and B10b meet wherever a field is uniform; the
// other kernels divide as they are (ZERO false).
template <bool ZERO>
__device__ __forceinline__ float lbm_div(float a, float b) {
  return ZERO && a == 0.f ? a : a / b;
}

// The 19-point isotropic gradient, the sums divided by d12 = f32(12 dx).
template <bool ZERO = false, class F>
__device__ __forceinline__ void lbm_iso_grad(F S, float d12, float g[3]) {
  lbm_iso_sums(S, g);
#pragma unroll
  for (int d = 0; d < 3; ++d) g[d] = lbm_div<ZERO>(g[d], d12);
}

// 19-point Laplacian (2 faces + edges - 24 centre) / d6 at an interior
// cell, with d6 = f32(6 dx^2) rounded once on the host; S(oz, oy, ox)
// returns the field at an offset from it (ops/stencils.py:
// isotropic_laplacian).
template <bool ZERO = false, class F>
__device__ __forceinline__ float lbm_laplacian(F S, float d6) {
  const float faces = S(0, 0, 1) + S(0, 0, -1) + S(0, 1, 0) + S(0, -1, 0) + S(1, 0, 0) +
                      S(-1, 0, 0);
  const float edges = S(0, 1, 1) + S(0, 1, -1) + S(0, -1, 1) + S(0, -1, -1) + S(1, 0, 1) +
                      S(1, 0, -1) + S(-1, 0, 1) + S(-1, 0, -1) + S(1, 1, 0) + S(1, -1, 0) +
                      S(-1, 1, 0) + S(-1, -1, 0);
  return lbm_div<ZERO>(2.f * faces + edges - 24.f * S(0, 0, 0), d6);
}

// ---- capillary stage (ops/collide.py:hcz_capillary) ----------------------
// The inputs the stage reads at the cell itself; h2 only with HAS_CHI.  The
// stencil fields (lap, chi, fai, prho) come through a tap.  Kernels take
// these as separate __restrict__ parameters and build the struct inside:
// passed as one struct parameter, B3 ran 6 % slower.
struct LbmCapIn {
  const uint8_t* __restrict__ flags;
  const float* __restrict__ rho_ca;
  const float* __restrict__ h2;
  const float* __restrict__ gsum;
  const float* __restrict__ gmom;
  const float* __restrict__ vel_old;
  const float* __restrict__ pres_old;
};

// What the stage reads at cell i with flag fl: rho_ca, h2, and g_sum and
// g_mom at a fluid cell or the old pressure and velocity, which the stage
// keeps, elsewhere.  A kernel may load it before its taps (lbm_cap_point).
struct LbmCapPoint {
  float rho, h2, s, m[3];  // s, m: g_sum, g_mom (fluid) or pres_old, vel_old
  uint8_t flag;
};

template <bool HAS_CHI>
__device__ __forceinline__ LbmCapPoint lbm_cap_point(const LbmCapIn& in, long long i,
                                                     long long N, uint8_t fl) {
  LbmCapPoint p;
  const bool fluid = fl == LBM_FLUID;
  p.flag = fl;
  p.rho = in.rho_ca[i];
  p.h2 = HAS_CHI ? in.h2[i] : 0.f;
  p.s = fluid ? in.gsum[i] : in.pres_old[i];
#pragma unroll
  for (int d = 0; d < 3; ++d) p.m[d] = fluid ? in.gmom[d * N + i] : in.vel_old[d * N + i];
  return p;
}

struct LbmCapF {
  float kappa, grav[3], mu0_half, c, inv_d12, half_dt_rt, inv_rt, half_dt;
  LbmGas gas;
};

static inline LbmCapF lbm_cap_consts(double kappa, double grav_x, double grav_y, double grav_z,
                                     double mu0_half, double dx, double dt, LbmGas gas) {
  const double c = dx / dt;
  const double RT = c * c / 3.0;
  LbmCapF k;
  k.kappa = lbm_f32(kappa);
  k.grav[0] = lbm_f32(grav_x);
  k.grav[1] = lbm_f32(grav_y);
  k.grav[2] = lbm_f32(grav_z);
  k.mu0_half = lbm_f32(mu0_half);
  k.c = lbm_f32(c);
  k.inv_d12 = lbm_f32(1.0 / (12.0 * dx));
  k.half_dt_rt = lbm_f32(0.5 * dt * RT);
  k.inv_rt = lbm_f32(1.0 / RT);
  k.half_dt = lbm_f32(0.5 * dt);
  k.gas = gas;
  return k;
}

struct LbmCapCell {
  float rho, dens, pres;
  float force[3], u[3], dfai[3], dprho[3];
  uint8_t flag;
};

// The capillary stage at a cell whose inputs are pt.  tap(field, oz, oy,
// ox) returns field 0 (lap), 1 (chi), 2 (fai) or 3 (prho) at an offset from
// the interior cell nearest to the cell, read as the TPU kernel reads it:
// lap and chi substituted at obstacles by their value at the clamped cell,
// fai and prho (interior-padded already) at the clamped tap.  So outputs
// are replicated from the nearest interior cell, and z is clamped, not
// periodic.  Then force = kappa dens grad lap + g dens (- mu0/2 H2 grad chi)
// with dens = density(rho_ca), and velocity/pressure recovery at fluid
// cells (the old values elsewhere).
template <bool HAS_CHI, class Tap>
__device__ __forceinline__ void lbm_capillary_cell(const LbmCapPoint& pt, const LbmCapF& k,
                                                   Tap tap, LbmCapCell& o) {
  float glap[3], gchi[3];
  lbm_iso_sums([&](int a, int b, int e) { return tap(0, a, b, e); }, glap);
  if (HAS_CHI) lbm_iso_sums([&](int a, int b, int e) { return tap(1, a, b, e); }, gchi);
  lbm_iso_sums([&](int a, int b, int e) { return tap(2, a, b, e); }, o.dfai);
  lbm_iso_sums([&](int a, int b, int e) { return tap(3, a, b, e); }, o.dprho);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    glap[d] = glap[d] * k.inv_d12;
    if (HAS_CHI) gchi[d] = gchi[d] * k.inv_d12;
    o.dfai[d] = o.dfai[d] * k.inv_d12;
    o.dprho[d] = o.dprho[d] * k.inv_d12;
  }
  o.rho = pt.rho;
  o.dens = lbm_density_of(o.rho, k.gas);
  o.flag = pt.flag;
  const bool fluid = o.flag == LBM_FLUID;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float fd = k.kappa * o.dens * glap[d] + k.grav[d] * o.dens;
    if (HAS_CHI) fd = fd - k.mu0_half * pt.h2 * gchi[d];
    o.force[d] = fd;
    o.u[d] = fluid ? (pt.m[d] * k.c + k.half_dt_rt * fd) * k.inv_rt / o.dens : pt.m[d];
  }
  o.pres = fluid ? pt.s - k.half_dt * (o.u[0] * o.dprho[0] + o.u[1] * o.dprho[1] +
                                       o.u[2] * o.dprho[2])
                 : pt.s;
}

// ---- pull-stream -----------------------------------------------------------
// Pull-stream one cell's 19 channels with periodic wrap on every axis, then
// full-way bounce-back at obstacles (ops/stream.py:stream + bounce_back).
// The source of channel q at cell i is i plus the offsets along -e_q,
// computed once per cell (lbm_pull_offsets) and shared by its pulls.
struct LbmPullOffsets {
  int xm, xp, ym, yp;
  long long zm, zp;
};

__device__ __forceinline__ LbmPullOffsets lbm_pull_offsets(int z, int y, int x, int Z, int Y,
                                                           int X) {
  const long long XY = static_cast<long long>(X) * Y;
  return LbmPullOffsets{x == 0 ? X - 1 : -1,
                        x == X - 1 ? 1 - X : 1,
                        y == 0 ? (Y - 1) * X : -X,
                        y == Y - 1 ? (1 - Y) * X : X,
                        z == 0 ? (Z - 1) * XY : -XY,
                        z == Z - 1 ? (1 - Z) * XY : XY};
}

template <class T>
__device__ __forceinline__ void lbm_pull_at(const T* __restrict__ d, long long N, long long i,
                                            const LbmPullOffsets& o, bool obs, float post[19]) {
  const int ex[19] = LBM_D3Q19_EX;
  const int ey[19] = LBM_D3Q19_EY;
  const int ez[19] = LBM_D3Q19_EZ;
  const int opp[19] = LBM_D3Q19_OPP;
  float s[19];
#pragma unroll
  for (int q = 0; q < 19; ++q) {
    long long src = i;
    if (ex[q] != 0) src += ex[q] == 1 ? o.xm : o.xp;
    if (ey[q] != 0) src += ey[q] == 1 ? o.ym : o.yp;
    if (ez[q] != 0) src += ez[q] == 1 ? o.zm : o.zp;
    s[q] = lbm_ld(d + q * N + src);
  }
#pragma unroll
  for (int q = 0; q < 19; ++q) post[q] = obs ? s[opp[q]] : s[q];
}

// ---- channel-form Poisson sweep (ops/pallas/poisson.py:_sweep_math :69) ----
// One sweep at a cell from its 19 pulled, pre-bounce values s: psi =
// f32(1/(1 - w0)) (s_1 + ... + s_18), summed in ascending q; then at an
// obstacle out_q = s_opp(q); elsewhere t = psi/tau (psi at tau == 1), u =
// t + rhs and out_q = (1 - 1/tau) s_q + w_q u (w_q u at tau == 1), minus t
// at q = 0.  Every product and sum is rounded on its own, in the plain
// version's order (the __f*_rn intrinsics keep nvcc from contracting them
// into FMAs), so any schedule of the sweeps gives poisson_sweeps_plain's
// outputs bit for bit.  Returns psi.
template <bool TAU1>
__device__ __forceinline__ float lbm_poisson_cell(const float s[19], bool obstacle, float rhs,
                                                  float inv_tau, float a, float out[19]) {
  float psum = s[1];
#pragma unroll
  for (int q = 2; q < 19; ++q) psum = __fadd_rn(psum, s[q]);
  const float psi = __fmul_rn(psum, static_cast<float>(1.0 / (1.0 - 1.0 / 3.0)));
  if (obstacle) {
    const int opp[19] = LBM_D3Q19_OPP;
#pragma unroll
    for (int q = 0; q < 19; ++q) out[q] = s[opp[q]];
    return psi;
  }
  const float t = TAU1 ? psi : __fmul_rn(psi, inv_tau);
  const float u = __fadd_rn(t, rhs);
#pragma unroll
  for (int q = 0; q < 19; ++q) {
    const float wu = __fmul_rn(lbm_weight(q), u);
    const float c = TAU1 ? wu : __fadd_rn(__fmul_rn(a, s[q]), wu);
    out[q] = q == 0 ? __fsub_rn(c, t) : c;
  }
  return psi;
}

// ---- HCZ LBGK collide (ops/collide.py:hcz_collide) ------------------------
// Replaces the per-cell work of the TPU kernels' _feq_rows and _gamma_rows
// (ops/pallas/hcz3d.py), which build 19 equilibria and 19 forcing weights
// per cell.  Held as arrays through both the f and the g update, with the
// 19 post-stream values, those cost about 157 registers a thread: one
// 256-thread block an SM.  Here a cell keeps only scalars (LbmHczCell), and
// each channel's feq_q and Gamma_q are recomputed where they are used, in
// the f loop and again in the g loop: feq_q = base w_q times the plus/minus
// factor of each nonzero velocity component, Gamma_q = w_q (1 + eu/cs2 +
// eu^2/(2 cs2^2) - uv/(2 cs2)) with eu = (e_q . u) c.  The divisions by the
// launch constants c, cs2, tau_f and tau_g are products with reciprocals
// (LbmHczK); what is left is 7 IEEE divisions a fluid cell, none per
// channel.  Callers apply it at fluid cells only.
struct LbmHczK {
  float c, inv_c, cs2, inv_cs2, inv_cs2sq, inv_tauf, inv_taug, pref_f, pref_g;
};

static inline LbmHczK lbm_hcz_consts(double dx, double dt, double tau_f, double tau_g) {
  const double c = dx / dt;
  const double cs2 = c * c / 3.0;
  LbmHczK k;
  k.c = lbm_f32(c);
  k.inv_c = lbm_f32(1.0 / c);
  k.cs2 = lbm_f32(cs2);
  k.inv_cs2 = lbm_f32(1.0 / cs2);
  k.inv_cs2sq = lbm_f32(1.0 / (cs2 * cs2));
  k.inv_tauf = lbm_f32(1.0 / tau_f);
  k.inv_taug = lbm_f32(1.0 / tau_g);
  k.pref_f = lbm_f32(dt * dt * (1.0 - 0.5 / tau_f) / cs2);
  k.pref_g = lbm_f32(dt * (1.0 - 0.5 / tau_g));
  return k;
}

struct LbmHczCell {
  float base, plus[3], minus[3], u[3], uvt;                      // feq_q, Gamma_q
  float gx, gy, gz, u_dot_g;                                     // f: -grad fai
  float force[3], px, py, pz, u_dot_f, u_dot_p, dens_term, p_term;  // g
};

// e_q . (a0, a1, a2) summed over the nonzero components of e_q in x, y, z
// order: the value of the full sum of products, without its zero terms.
__device__ __forceinline__ float lbm_edot(int q, float a0, float a1, float a2) {
  const int ex[19] = LBM_D3Q19_EX;
  const int ey[19] = LBM_D3Q19_EY;
  const int ez[19] = LBM_D3Q19_EZ;
  float s = 0.f;
  bool first = true;
  auto add = [&](int e, float a) {
    if (e != 0) {
      const float t = e > 0 ? a : -a;
      s = first ? t : s + t;
      first = false;
    }
  };
  add(ex[q], a0);
  add(ey[q], a1);
  add(ez[q], a2);
  return s;
}

__device__ __forceinline__ void lbm_hcz_prepare(LbmHczCell& h, const LbmHczK& k, float rho,
                                                float dens, float pres, const float u[3],
                                                const float force[3], const float dfai[3],
                                                const float dprho[3]) {
  float tax[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    h.u[d] = u[d];
    h.force[d] = force[d];
    const float un = u[d] * k.inv_c;
    tax[d] = sqrtf(1.f + 3.f * un * un);
    h.plus[d] = (2.f * un + tax[d]) / (1.f - un);
    h.minus[d] = 1.f / h.plus[d];
  }
  h.base = rho * (2.f - tax[0]) * (2.f - tax[1]) * (2.f - tax[2]);
  h.uvt = 0.5f * (u[0] * u[0] + u[1] * u[1] + u[2] * u[2]) * k.inv_cs2;
  h.gx = -dfai[0], h.gy = -dfai[1], h.gz = -dfai[2];
  h.px = -dprho[0], h.py = -dprho[1], h.pz = -dprho[2];
  h.u_dot_g = u[0] * h.gx + u[1] * h.gy + u[2] * h.gz;
  h.u_dot_f = u[0] * force[0] + u[1] * force[1] + u[2] * force[2];
  h.u_dot_p = u[0] * h.px + u[1] * h.py + u[2] * h.pz;
  h.dens_term = k.cs2 * dens / rho;
  h.p_term = pres - k.cs2 * dens;
}

__device__ __forceinline__ float lbm_feq_q(const LbmHczCell& h, int q) {
  const int ex[19] = LBM_D3Q19_EX;
  const int ey[19] = LBM_D3Q19_EY;
  const int ez[19] = LBM_D3Q19_EZ;
  float v = h.base * lbm_weight(q);
  if (ex[q] == 1) v = v * h.plus[0];
  if (ex[q] == -1) v = v * h.minus[0];
  if (ey[q] == 1) v = v * h.plus[1];
  if (ey[q] == -1) v = v * h.minus[1];
  if (ez[q] == 1) v = v * h.plus[2];
  if (ez[q] == -1) v = v * h.minus[2];
  return v;
}

__device__ __forceinline__ float lbm_gam_q(const LbmHczCell& h, const LbmHczK& k, int q) {
  const float eu = lbm_edot(q, h.u[0], h.u[1], h.u[2]) * k.c;
  return lbm_weight(q) * (1.f + eu * k.inv_cs2 + 0.5f * eu * eu * k.inv_cs2sq - h.uvt);
}

__device__ __forceinline__ void lbm_hcz_collide_f(const LbmHczCell& h, const LbmHczK& k,
                                                  float p[19]) {
#pragma unroll
  for (int q = 0; q < 19; ++q) {
    const float e_dot_g = lbm_edot(q, h.gx, h.gy, h.gz) * k.c;
    const float fq = p[q];
    p[q] = fq + (lbm_feq_q(h, q) - fq) * k.inv_tauf +
           k.pref_f * lbm_gam_q(h, k, q) * (e_dot_g - h.u_dot_g);
  }
}

__device__ __forceinline__ void lbm_hcz_collide_g(const LbmHczCell& h, const LbmHczK& k,
                                                  float p[19]) {
#pragma unroll
  for (int q = 0; q < 19; ++q) {
    const float wq = lbm_weight(q);
    const float e_dot_f = lbm_edot(q, h.force[0], h.force[1], h.force[2]) * k.c;
    const float e_dot_p = lbm_edot(q, h.px, h.py, h.pz) * k.c;
    const float gam = lbm_gam_q(h, k, q);
    const float gq = p[q];
    const float geq = wq * h.p_term + h.dens_term * lbm_feq_q(h, q);
    p[q] = gq + (geq - gq) * k.inv_taug +
           k.pref_g * (gam * (e_dot_f - h.u_dot_f) + (gam - wq) * (e_dot_p - h.u_dot_p));
  }
}

// ---- z-walk of a tile with a 3-plane shared-memory ring --------------------
// For stencils evaluated at the interior cell nearest to each cell (the
// TPU kernels' ring rule).  A block owns a TX x TY (x, y) tile at (x0, y0)
// and walks the planes [z0, z1).  A cell at z taps the planes zc - 1, zc,
// zc + 1 with zc = clamp(z, 1, Z - 2); the ring keeps plane p in slot p % 3.
// load(p) fills slot p % 3 with plane p of the tile and its 1-cell halo
// (the whole block takes part: see lbm_halo_cells); cell(z, sm, s0, sp)
// runs for the block's cells inside the grid (active), with the slots of
// zc - 1, zc and zc + 1.
template <class Load, class Cell>
__device__ __forceinline__ void lbm_zwalk(int z0, int z1, int Z, bool active, Load load,
                                          Cell cell) {
  int hi = lbm_clamp(z0, 1, Z - 2) + 1;
  load(hi - 2);
  load(hi - 1);
  load(hi);
  __syncthreads();
  for (int z = z0; z < z1; ++z) {
    const int zc = lbm_clamp(z, 1, Z - 2);
    if (zc + 1 > hi) {  // the same for the whole block
      __syncthreads();
      load(++hi);
      __syncthreads();
    }
    if (active) cell(z, (zc - 1) % 3, zc % 3, (zc + 1) % 3);
  }
}

// The ring's first row (or column) for a tile starting at t0 on an axis of
// n cells: one before the first interior cell the tile's cells tap around.
// A tile holding only the last cell taps around cell n - 2, which is
// outside it, so the ring does not simply start at t0 - 1.
__device__ __forceinline__ int lbm_ring_origin(int t0, int n) { return lbm_clamp(t0, 1, n - 2) - 1; }

// The (TY + 2) x (TX + 2) cells of plane p that the ring holds for the tile
// at (x0, y0), spread over the block's TX x TY threads: f(ey, ex, n, c) with
// the cell's index n and the index c of the interior cell nearest to it.
// Ring cells outside the grid are never tapped; they stand on the nearest
// grid cell.
template <int TX, int TY, class F>
__device__ __forceinline__ void lbm_halo_cells(int p, int x0, int y0, int Z, int Y, int X, F f) {
  const int pc = lbm_clamp(p, 1, Z - 2);
  const int rx0 = lbm_ring_origin(x0, X), ry0 = lbm_ring_origin(y0, Y);
  for (int e = threadIdx.y * TX + threadIdx.x; e < (TY + 2) * (TX + 2); e += TX * TY) {
    const int ey = e / (TX + 2), ex = e - ey * (TX + 2);
    const int gy = lbm_clamp(ry0 + ey, 0, Y - 1), gx = lbm_clamp(rx0 + ex, 0, X - 1);
    f(ey, ex, lbm_index(p, gy, gx, Y, X),
      lbm_index(pc, lbm_clamp(gy, 1, Y - 2), lbm_clamp(gx, 1, X - 2), Y, X));
  }
}
