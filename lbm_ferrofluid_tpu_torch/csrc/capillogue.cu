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
// The box form (the TPU kernel's bounds=, emit_rhs=None, emit_force=True;
// models/ferrofluid.py:549-571 of the JAX package) serves an OBSTACLE-padded
// array whose physical box is [:, :by, :bx] (params.phys_extent), and an
// out-of-plane field.  The in-plane ring fixes move to the box faces: (a)
// zeroes the Laplacian at rows 0, by - 1 and columns 0, bx - 1 (and past
// the box takes it with in-plane reads clamped to the array, as the TPU's
// shifted reads do), and (b) takes the replicated fai/prho and the
// obstacle substitutes of lap/chi from rows 1, by - 2 and columns 1,
// bx - 2 (common.cuh:lbm_box_rep); the gradients' output ring stays at the
// array faces, as on the TPU.  (b) also writes force, and (d) does not run.
// With (by, bx) = (Y, X) both launches compute what they compute without
// the box.
//
// Launch (b) carries most of the chain's work.  Its design for Hopper:
//   - a block owns a 32 x 8 (x, y) tile and walks a strip of CAP_ZB planes
//     of z, from a 3D grid: no cell divides a 64-bit index;
//   - lap, chi, fai and prho of the tile and its 1-cell halo sit in a
//     3-plane shared-memory ring that rotates as the block walks z; the
//     substitution at obstacles and the clamp of fai/prho are applied once
//     per cell at load, so each of the 4 x 18 taps is one shared-memory
//     read with 32-bit arithmetic;
//   - the pulls of f and g use wrapped neighbour offsets computed once per
//     cell (common.cuh:lbm_pull_at);
//   - the collide keeps per-cell scalars only and recomputes feq_q and
//     Gamma_q per channel, with reciprocals of the launch constants
//     (common.cuh, HCZ collide), so __launch_bounds__(256, 2) holds it at
//     128 registers without spills: two blocks (16 warps) an SM.  Held
//     in 19-value arrays with a division per channel, it took 157
//     registers and one block an SM.
// The capillary stage, the collide and the pull are common.cuh's, shared
// with capmac.cu, hcz3d.cu and fused_step.cu.
//
// Bound on an H100: bytes.  The function must read f and g (152 B per
// cell), the two flag fields, rho_pre, density_pre, pressure_old and rho_ca
// at every cell (18 B), H2, g_sum and g_mom only at fluid cells (20 B
// there) and vel_old only at the others (12 B there), and write f', g'
// (152 B) and 15 float channels (60 B): 382 B per cell plus 20 B per fluid
// and 12 B per other cell, 2.01 ms at 256^3 over 3.35 TB/s; its ~1240
// flops per cell take 0.31 ms at 67 TFLOP/s.  What keeps the chain above
// it: (c) reads f' and g' again, (a) and (d) round-trip scratch fields,
// and (b) moves its own bytes below the memory's rate, with 16 warps an
// SM to hide the latency of 38 pulls a cell.
//
// In bfloat16 storage (the JAX package's turbo mode) launches (b) and (c)
// are the T = __nv_bfloat16 instances: (b) pulls bfloat16 f and g, widens
// them exactly, collides in float32 and rounds once, on the store of f'
// and g'; (c) reads those stored bfloat16 values, as the TPU kernel's
// emission re-streams f'/g' through the storage dtype (capillogue.py
// :593-594).  (a) and (d) read only float32 fields.  f, g, f' and g' then
// take 38 B a cell each: 230 B per cell plus 20 B per fluid and 12 B per
// other cell, 1.23 ms at 256^3.
//
// Slab form (the TPU kernel's ghosts=, cap_ghosts= and clamp=,
// capillogue.py:809, :844-858, for a z-slab of a domain decomposed along z
// over ranks): (a) runs over the slab and one plane a side (scratch of
// Z + 2 planes), reading rho_pre, density_pre and pressure_old of the
// neighbours' edge planes and two rho_ca planes a side, so that (b) sees
// the neighbours' Laplacian of density(rho_ca); (b) walks the slab with its
// ring filled from that scratch and the neighbours' flags, its z clamp
// [zlo, zhi] (1 and Z-2 at the domain's true edges, -1 and Z where the
// slab has a neighbour: then the ghost planes are tapped), and pulls f and
// g across the slab's faces from their ghost planes; (c) is the prologue's
// slab form on f'/g' with the neighbours' collided edge planes, which the
// caller exchanges between (b) and (c), so every plane's macros are
// emitted here; (d) reads only in-plane neighbours and runs as it is.  A
// slab's outputs equal those of the same planes of the whole domain.
#include "common.cuh"

// SLAB: output plane e holds slab plane e - 1, for e in [0, Z + 2); plane
// -1 and Z of rho_pre, den_pre and pres_old come from *_lo/*_hi ([Y, X]
// each), planes -2..-1 and Z..Z+1 of rho_ca from rc_lo/rc_hi ([2, Y, X]).
// The Laplacian is taken at the planes [lz0, lz1] (slab coordinates) and
// is zero elsewhere: [1, Z-2] on the whole domain.
template <bool SLAB>
__global__ void lbm_cap_derived_kernel(const float* __restrict__ rho_pre,
                                       const float* __restrict__ den_pre,
                                       const float* __restrict__ pres_old,
                                       const float* __restrict__ rho_ca, float* __restrict__ fai,
                                       float* __restrict__ prho, float* __restrict__ chi,
                                       float* __restrict__ lap, int Z, int Y, int X, int by,
                                       int bx, double dx, double dt, float d6, LbmGas gas,
                                       const float* __restrict__ rp_lo,
                                       const float* __restrict__ rp_hi,
                                       const float* __restrict__ dp_lo,
                                       const float* __restrict__ dp_hi,
                                       const float* __restrict__ po_lo,
                                       const float* __restrict__ po_hi,
                                       const float* __restrict__ rc_lo,
                                       const float* __restrict__ rc_hi, int lz0, int lz1) {
  const long long NP = static_cast<long long>(Y) * X;
  const long long N = (Z + (SLAB ? 2 : 0)) * NP;
  const long long i = lbm_cell();
  if (i >= N) return;
  const int x = static_cast<int>(i % X);
  const int y = static_cast<int>((i / X) % Y);
  const int z = static_cast<int>(i / NP) - (SLAB ? 1 : 0);
  const long long ip = static_cast<long long>(y) * X + x;
  auto at = [&](const float* v, const float* lo, const float* hi, int depth, int zz,
                long long jp) {
    return SLAB ? lbm_slab_at(v, lo, hi, depth, zz, Z, jp, NP) : v[zz * NP + jp];
  };
  const double c = dx / dt;
  const double RT = c * c / 3.0;
  const float rp = at(rho_pre, rp_lo, rp_hi, 1, z, ip);
  const float dp = at(den_pre, dp_lo, dp_hi, 1, z, ip);
  fai[i] = lbm_fai(rp, RT);
  prho[i] = at(pres_old, po_lo, po_hi, 1, z, ip) - static_cast<float>(RT) * dp;
  chi[i] = lbm_chi(dp, dx, gas.den_gas, gas.dden);
  float l = 0.f;
  if (z >= lz0 && z <= lz1 && y != 0 && y != by - 1 && x != 0 && x != bx - 1) {
    // in-plane reads clamp at the array faces, which only cells past the box reach
    l = lbm_laplacian(
        [&](int oz, int oy, int ox) {
          return lbm_density_of(
              at(rho_ca, rc_lo, rc_hi, 2, z + oz,
                 static_cast<long long>(lbm_clamp(y + oy, 0, Y - 1)) * X +
                     lbm_clamp(x + ox, 0, X - 1)),
              gas);
        },
        d6);
  }
  lap[i] = l;
}

extern "C" int lbm_cap_derived(const float* rho_pre, const float* den_pre, const float* pres_old,
                               const float* rho_ca, float* fai, float* prho,
                               float* chi, float* lap, int Z, int Y, int X, int by, int bx,
                               double dx, double dt, double rho_gas, double rho_fluid,
                               double den_gas, double den_fluid, void* stream) {
  const long long N = static_cast<long long>(Z) * Y * X;
  lbm_cap_derived_kernel<false>
      <<<lbm_blocks(N), LBM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          rho_pre, den_pre, pres_old, rho_ca, fai, prho, chi, lap, Z, Y, X, by, bx, dx, dt,
          lbm_f32(6.0 * dx * dx), lbm_gas(rho_gas, rho_fluid, den_gas, den_fluid), nullptr,
          nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, Z - 2);
  return static_cast<int>(cudaGetLastError());
}

// The slab form of (a): fai, prho, chi and lap [Z + 2, Y, X] each; lz0 and
// lz1 are the z clamp of (b).
extern "C" int lbm_cap_derived_slab(const float* rho_pre, const float* den_pre,
                                    const float* pres_old, const float* rho_ca, float* fai,
                                    float* prho, float* chi, float* lap, int Z, int Y, int X,
                                    int by, int bx, double dx, double dt, double rho_gas,
                                    double rho_fluid, double den_gas, double den_fluid,
                                    const float* rp_lo, const float* rp_hi, const float* dp_lo,
                                    const float* dp_hi, const float* po_lo, const float* po_hi,
                                    const float* rc_lo, const float* rc_hi, int lz0, int lz1,
                                    void* stream) {
  const long long N = static_cast<long long>(Z + 2) * Y * X;
  lbm_cap_derived_kernel<true>
      <<<lbm_blocks(N), LBM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          rho_pre, den_pre, pres_old, rho_ca, fai, prho, chi, lap, Z, Y, X, by, bx, dx, dt,
          lbm_f32(6.0 * dx * dx), lbm_gas(rho_gas, rho_fluid, den_gas, den_fluid), rp_lo, rp_hi,
          dp_lo, dp_hi, po_lo, po_hi, rc_lo, rc_hi, lz0, lz1);
  return static_cast<int>(cudaGetLastError());
}

#define CAP_TX 32
#define CAP_TY 8
#define CAP_ZB 16
#define CAP_EX (CAP_TX + 2)
#define CAP_EY (CAP_TY + 2)

// SLAB: fai, prho, chi and lap come with a plane a side (lbm_cap_derived
// slab form: scratch plane p + 1 holds plane p); the ring's flags of planes
// -1 and Z from fl_lo/fl_hi ([Y, X]); f and g pulled across the slab's
// faces from f_lo/f_hi and g_lo/g_hi ([5, Y, X]).  [zlo, zhi] is the z
// clamp: [1, Z-2] on the whole domain.
template <class T, bool SLAB>
__global__ void __launch_bounds__(CAP_TX* CAP_TY, 2) lbm_cap_collide_kernel(
    const T* __restrict__ f, const T* __restrict__ g, const uint8_t* __restrict__ flags,
    const float* __restrict__ rho_ca, const float* __restrict__ h2,
    const float* __restrict__ gsum, const float* __restrict__ gmom,
    const float* __restrict__ vel_old, const float* __restrict__ pres_old,
    const float* __restrict__ fai, const float* __restrict__ prho,
    const float* __restrict__ chi, const float* __restrict__ lap, T* __restrict__ f_out,
    T* __restrict__ g_out, float* __restrict__ vel_out, float* __restrict__ pres_out,
    float* __restrict__ den_out, float* __restrict__ force_out, int Z, int Y, int X, int by,
    int bx, LbmCapF kc, LbmHczK kh, const T* __restrict__ f_lo, const T* __restrict__ f_hi,
    const T* __restrict__ g_lo, const T* __restrict__ g_hi, const uint8_t* __restrict__ fl_lo,
    const uint8_t* __restrict__ fl_hi, int zlo, int zhi) {
  // lap, chi, fai, prho of three z planes of the tile and its halo, as the
  // taps read them
  __shared__ float ring[3][4][CAP_EY][CAP_EX];
  const int x0 = blockIdx.x * CAP_TX, y0 = blockIdx.y * CAP_TY;
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  const int z0 = blockIdx.z * CAP_ZB, z1 = min(z0 + CAP_ZB, Z);
  const long long NP = static_cast<long long>(Y) * X;
  const long long N = Z * NP;
  const long long so = SLAB ? NP : 0;  // the scratch's offset of plane 0

  const LbmCapIn in{flags, rho_ca, h2, gsum, gmom, vel_old, pres_old};
  auto load = [&](int p) {
    float(*dst)[CAP_EY][CAP_EX] = ring[lbm_mod(p, 3)];
    lbm_halo_cells_clamped<CAP_TX, CAP_TY>(
        p, x0, y0, zlo, zhi, Y, X, by, bx, [&](int ey, int ex, long long n, long long c) {
          const uint8_t fl = SLAB ? lbm_slab_at(flags, fl_lo, fl_hi, 1, p, Z, n - p * NP, NP)
                                  : flags[n];
          const bool obs = fl == LBM_OBSTACLE;
          dst[0][ey][ex] = lap[so + (obs ? c : n)];
          dst[1][ey][ex] = chi[so + (obs ? c : n)];
          dst[2][ey][ex] = fai[so + c];
          dst[3][ey][ex] = prho[so + c];
        });
  };
  const int xl = lbm_clamp(x, 1, X - 2) - lbm_ring_origin(x0, X);
  const int yl = lbm_clamp(y, 1, Y - 2) - lbm_ring_origin(y0, Y);
  lbm_zwalk(z0, z1, zlo, zhi, x < X && y < Y, load, [&](int z, int sm, int s0, int sp) {
    auto tap = [&](int fld, int oz, int oy, int ox) -> float {
      return ring[oz < 0 ? sm : (oz > 0 ? sp : s0)][fld][yl + oy][xl + ox];
    };
    const long long i = (static_cast<long long>(z) * Y + y) * X + x;
    LbmCapCell o;
    lbm_capillary_cell<true>(lbm_cap_point<true>(in, i, N, flags[i]), kc, tap, o);
    den_out[i] = o.dens;
    pres_out[i] = o.pres;
#pragma unroll
    for (int d = 0; d < 3; ++d) vel_out[d * N + i] = o.u[d];
    if (force_out != nullptr) {
#pragma unroll
      for (int d = 0; d < 3; ++d) force_out[d * N + i] = o.force[d];
    }

    const bool fluid = o.flag == LBM_FLUID;
    const bool obs = o.flag == LBM_OBSTACLE;
    LbmHczCell h;
    lbm_hcz_prepare(h, kh, o.rho, o.dens, o.pres, o.u, o.force, o.dfai, o.dprho);
    const LbmPullOffsets po = lbm_pull_offsets(z, y, x, Z, Y, X);
    float post[19];
    if (SLAB)
      lbm_pull_slab(f, f_lo, f_hi, N, NP, i, z, Z, po, obs, post);
    else
      lbm_pull_at(f, N, i, po, obs, post);
    if (fluid) lbm_hcz_collide_f(h, kh, post);
#pragma unroll
    for (int q = 0; q < 19; ++q) lbm_st(f_out + q * N + i, post[q]);
    if (SLAB)
      lbm_pull_slab(g, g_lo, g_hi, N, NP, i, z, Z, po, obs, post);
    else
      lbm_pull_at(g, N, i, po, obs, post);
    if (fluid) lbm_hcz_collide_g(h, kh, post);
#pragma unroll
    for (int q = 0; q < 19; ++q) lbm_st(g_out + q * N + i, post[q]);
  });
}

// Next step's pre-scaled Poisson source from the emitted density, for a
// static field of magnitude hm along the in-plane axis (0 = x, 1 = y):
// exactly ops/magnetic.py:poisson_rhs_scaled with h2_ext.
__global__ void lbm_cap_rhs_kernel(const float* __restrict__ den,
                                   const uint8_t* __restrict__ mflags, float* __restrict__ rhs,
                                   int Z, int Y, int X, int axis, double hm, double tau,
                                   double dx, double dt, float den_gas, float dden) {
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
  const float ch = lbm_chi(den[i], dx, den_gas, dden);
  const float chp = lbm_chi(den[ip], dx, den_gas, dden);
  const float chm = lbm_chi(den[im], dx, den_gas, dden);
  const float h = static_cast<float>(hm);
  float d = (0.5f * (ch + chp)) * h - (0.5f * (chm + ch)) * h;
  if (j == 0 || j == n - 1) d = 0.f;
  float r = d * static_cast<float>(dx) / (1.f + ch);
  if (mflags[i] != LBM_FLUID) r = 0.f;
  const double cs2 = (dx / dt) * (dx / dt) / 3.0;
  rhs[i] = (static_cast<float>(dt) * r) * static_cast<float>(cs2 * (0.5 - tau) * dt);
}

// The ghost arguments of (b)'s slab form (null on the whole domain)
struct LbmCapGhosts {
  const void *f_lo, *f_hi, *g_lo, *g_hi;
  const uint8_t *fl_lo, *fl_hi;
  int zlo, zhi;
};

template <class T>
static void lbm_cap_collide_launch(const void* f, const void* g, const uint8_t* flags,
                                   const float* rho_ca, const float* h2, const float* gsum,
                                   const float* gmom, const float* vel_old, const float* pres_old,
                                   const float* fai, const float* prho, const float* chi,
                                   const float* lap, void* f_out, void* g_out, float* vel_out,
                                   float* pres_out, float* den_out, float* force_out, int Z,
                                   int Y, int X, int by, int bx, const LbmCapF& kc,
                                   const LbmHczK& kh, const LbmCapGhosts& gh,
                                   cudaStream_t stream) {
  const dim3 grid((X + CAP_TX - 1) / CAP_TX, (Y + CAP_TY - 1) / CAP_TY, (Z + CAP_ZB - 1) / CAP_ZB);
  const T *flo = static_cast<const T*>(gh.f_lo), *fhi = static_cast<const T*>(gh.f_hi);
  const T *glo = static_cast<const T*>(gh.g_lo), *ghi = static_cast<const T*>(gh.g_hi);
  if (gh.f_lo != nullptr)
    lbm_cap_collide_kernel<T, true><<<grid, dim3(CAP_TX, CAP_TY), 0, stream>>>(
        static_cast<const T*>(f), static_cast<const T*>(g), flags, rho_ca, h2, gsum, gmom,
        vel_old, pres_old, fai, prho, chi, lap, static_cast<T*>(f_out), static_cast<T*>(g_out),
        vel_out, pres_out, den_out, force_out, Z, Y, X, by, bx, kc, kh, flo, fhi, glo, ghi,
        gh.fl_lo, gh.fl_hi, gh.zlo, gh.zhi);
  else
    lbm_cap_collide_kernel<T, false><<<grid, dim3(CAP_TX, CAP_TY), 0, stream>>>(
        static_cast<const T*>(f), static_cast<const T*>(g), flags, rho_ca, h2, gsum, gmom,
        vel_old, pres_old, fai, prho, chi, lap, static_cast<T*>(f_out), static_cast<T*>(g_out),
        vel_out, pres_out, den_out, force_out, Z, Y, X, by, bx, kc, kh, flo, fhi, glo, ghi,
        nullptr, nullptr, 1, Z - 2);
}

static int lbm_cap_collide_any(const void* f, const void* g, const uint8_t* flags,
                               const float* rho_ca, const float* h2, const float* gsum,
                               const float* gmom, const float* vel_old, const float* pres_old,
                               const float* fai, const float* prho, const float* chi,
                               const float* lap, void* f_out, void* g_out, float* vel_out,
                               float* pres_out, float* den_out, float* force_out, int Z, int Y,
                               int X, int by, int bx, double kappa, double grav_x, double grav_y,
                               double grav_z, double mu0_half, double tau_f, double tau_g,
                               double dx, double dt, double rho_gas, double rho_fluid,
                               double den_gas, double den_fluid, int bf16,
                               const LbmCapGhosts& gh, void* stream) {
  const LbmCapF kc = lbm_cap_consts(kappa, grav_x, grav_y, grav_z, mu0_half, dx, dt,
                                    lbm_gas(rho_gas, rho_fluid, den_gas, den_fluid));
  const LbmHczK kh = lbm_hcz_consts(dx, dt, tau_f, tau_g);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    lbm_cap_collide_launch<__nv_bfloat16>(f, g, flags, rho_ca, h2, gsum, gmom, vel_old, pres_old,
                                          fai, prho, chi, lap, f_out, g_out, vel_out, pres_out,
                                          den_out, force_out, Z, Y, X, by, bx, kc, kh, gh, st);
  else
    lbm_cap_collide_launch<float>(f, g, flags, rho_ca, h2, gsum, gmom, vel_old, pres_old, fai,
                                  prho, chi, lap, f_out, g_out, vel_out, pres_out, den_out,
                                  force_out, Z, Y, X, by, bx, kc, kh, gh, st);
  return static_cast<int>(cudaGetLastError());
}

// f, g, f_out and g_out in float32, or in bfloat16 where bf16 is nonzero;
// force_out (3 channels) may be null, and then force is not written
extern "C" int lbm_cap_collide(const void* f, const void* g, const uint8_t* flags,
                               const float* rho_ca, const float* h2, const float* gsum,
                               const float* gmom, const float* vel_old, const float* pres_old,
                               const float* fai, const float* prho, const float* chi,
                               const float* lap, void* f_out, void* g_out, float* vel_out,
                               float* pres_out, float* den_out, float* force_out, int Z, int Y,
                               int X, int by, int bx,
                               double kappa, double grav_x, double grav_y, double grav_z,
                               double mu0_half, double tau_f, double tau_g, double dx, double dt,
                               double rho_gas, double rho_fluid, double den_gas,
                               double den_fluid, int bf16, void* stream) {
  const LbmCapGhosts none{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, Z - 2};
  return lbm_cap_collide_any(f, g, flags, rho_ca, h2, gsum, gmom, vel_old, pres_old, fai, prho,
                             chi, lap, f_out, g_out, vel_out, pres_out, den_out, force_out, Z, Y,
                             X, by, bx, kappa, grav_x, grav_y, grav_z, mu0_half, tau_f, tau_g, dx,
                             dt, rho_gas, rho_fluid, den_gas, den_fluid, bf16, none, stream);
}

// The slab form of (b): fai, prho, chi and lap from lbm_cap_derived_slab
// ([Z + 2, Y, X] each), the ghost planes of f and g ([5, Y, X] each, in
// their storage type) and of the flags ([Y, X] each), and the z clamp.
extern "C" int lbm_cap_collide_slab(
    const void* f, const void* g, const uint8_t* flags, const float* rho_ca, const float* h2,
    const float* gsum, const float* gmom, const float* vel_old, const float* pres_old,
    const float* fai, const float* prho, const float* chi, const float* lap, void* f_out,
    void* g_out, float* vel_out, float* pres_out, float* den_out, float* force_out, int Z, int Y,
    int X, int by, int bx, double kappa, double grav_x, double grav_y, double grav_z,
    double mu0_half, double tau_f, double tau_g, double dx, double dt, double rho_gas,
    double rho_fluid, double den_gas, double den_fluid, int bf16, const void* f_lo,
    const void* f_hi, const void* g_lo, const void* g_hi, const uint8_t* fl_lo,
    const uint8_t* fl_hi, int zlo, int zhi, void* stream) {
  if (f_lo == nullptr || zlo < -1 || zhi > Z || zlo > 1 || zhi < Z - 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const LbmCapGhosts gh{f_lo, f_hi, g_lo, g_hi, fl_lo, fl_hi, zlo, zhi};
  return lbm_cap_collide_any(f, g, flags, rho_ca, h2, gsum, gmom, vel_old, pres_old, fai, prho,
                             chi, lap, f_out, g_out, vel_out, pres_out, den_out, force_out, Z, Y,
                             X, by, bx, kappa, grav_x, grav_y, grav_z, mu0_half, tau_f, tau_g, dx,
                             dt, rho_gas, rho_fluid, den_gas, den_fluid, bf16, gh, stream);
}

extern "C" int lbm_cap_rhs(const float* den, const uint8_t* mflags, float* rhs, int Z, int Y,
                           int X, int axis, double hm, double tau, double dx, double dt,
                           double den_gas, double den_fluid, void* stream) {
  const long long N = static_cast<long long>(Z) * Y * X;
  lbm_cap_rhs_kernel<<<lbm_blocks(N), LBM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      den, mflags, rhs, Z, Y, X, axis, hm, tau, dx, dt, lbm_f32(den_gas),
      lbm_f32(den_fluid - den_gas));
  return static_cast<int>(cudaGetLastError());
}

// Blocks of lbm_cap_collide_kernel (its bfloat16 instance where bf16 is
// nonzero) resident on one SM (for reports).
extern "C" int lbm_cap_collide_occupancy(int bf16, int* blocks) {
  return static_cast<int>(
      bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 blocks, lbm_cap_collide_kernel<__nv_bfloat16, false>, CAP_TX * CAP_TY, 0)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 blocks, lbm_cap_collide_kernel<float, false>, CAP_TX * CAP_TY, 0));
}
