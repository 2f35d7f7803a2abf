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
#include "common.cuh"

__global__ void lbm_cap_derived_kernel(const float* __restrict__ rho_pre,
                                       const float* __restrict__ den_pre,
                                       const float* __restrict__ pres_old,
                                       const float* __restrict__ rho_ca, float* __restrict__ fai,
                                       float* __restrict__ prho, float* __restrict__ chi,
                                       float* __restrict__ lap, int Z, int Y, int X, double dx,
                                       double dt, float d6, LbmGas gas) {
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
  chi[i] = lbm_chi(den_pre[i], dx, gas.den_gas, gas.dden);
  float l = 0.f;
  if (z >= 1 && z <= Z - 2 && y >= 1 && y <= Y - 2 && x >= 1 && x <= X - 2) {
    l = lbm_laplacian(
        [&](int oz, int oy, int ox) {
          return lbm_density_of(rho_ca[lbm_index(z + oz, y + oy, x + ox, Y, X)], gas);
        },
        d6);
  }
  lap[i] = l;
}

extern "C" int lbm_cap_derived(const float* rho_pre, const float* den_pre, const float* pres_old,
                               const float* rho_ca, float* fai, float* prho,
                               float* chi, float* lap, int Z, int Y, int X, double dx, double dt,
                               double rho_gas, double rho_fluid, double den_gas,
                               double den_fluid, void* stream) {
  const long long N = static_cast<long long>(Z) * Y * X;
  lbm_cap_derived_kernel<<<lbm_blocks(N), LBM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      rho_pre, den_pre, pres_old, rho_ca, fai, prho, chi, lap, Z, Y, X, dx, dt,
      lbm_f32(6.0 * dx * dx), lbm_gas(rho_gas, rho_fluid, den_gas, den_fluid));
  return static_cast<int>(cudaGetLastError());
}

#define CAP_TX 32
#define CAP_TY 8
#define CAP_ZB 16
#define CAP_EX (CAP_TX + 2)
#define CAP_EY (CAP_TY + 2)

__global__ void __launch_bounds__(CAP_TX* CAP_TY, 2) lbm_cap_collide_kernel(
    const float* __restrict__ f, const float* __restrict__ g, const uint8_t* __restrict__ flags,
    const float* __restrict__ rho_ca, const float* __restrict__ h2,
    const float* __restrict__ gsum, const float* __restrict__ gmom,
    const float* __restrict__ vel_old, const float* __restrict__ pres_old,
    const float* __restrict__ fai, const float* __restrict__ prho,
    const float* __restrict__ chi, const float* __restrict__ lap, float* __restrict__ f_out,
    float* __restrict__ g_out, float* __restrict__ vel_out, float* __restrict__ pres_out,
    float* __restrict__ den_out, int Z, int Y, int X, LbmCapF kc, LbmHczK kh) {
  // lap, chi, fai, prho of three z planes of the tile and its halo, as the
  // taps read them
  __shared__ float ring[3][4][CAP_EY][CAP_EX];
  const int x0 = blockIdx.x * CAP_TX, y0 = blockIdx.y * CAP_TY;
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  const int z0 = blockIdx.z * CAP_ZB, z1 = min(z0 + CAP_ZB, Z);
  const long long N = static_cast<long long>(Z) * Y * X;

  const LbmCapIn in{flags, rho_ca, h2, gsum, gmom, vel_old, pres_old};
  auto load = [&](int p) {
    float(*dst)[CAP_EY][CAP_EX] = ring[p % 3];
    lbm_halo_cells<CAP_TX, CAP_TY>(p, x0, y0, Z, Y, X, [&](int ey, int ex, long long n,
                                                          long long c) {
      const bool obs = flags[n] == LBM_OBSTACLE;
      dst[0][ey][ex] = lap[obs ? c : n];
      dst[1][ey][ex] = chi[obs ? c : n];
      dst[2][ey][ex] = fai[c];
      dst[3][ey][ex] = prho[c];
    });
  };
  const int xl = lbm_clamp(x, 1, X - 2) - lbm_ring_origin(x0, X);
  const int yl = lbm_clamp(y, 1, Y - 2) - lbm_ring_origin(y0, Y);
  lbm_zwalk(z0, z1, Z, x < X && y < Y, load, [&](int z, int sm, int s0, int sp) {
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

    const bool fluid = o.flag == LBM_FLUID;
    const bool obs = o.flag == LBM_OBSTACLE;
    LbmHczCell h;
    lbm_hcz_prepare(h, kh, o.rho, o.dens, o.pres, o.u, o.force, o.dfai, o.dprho);
    const LbmPullOffsets po = lbm_pull_offsets(z, y, x, Z, Y, X);
    float post[19];
    lbm_pull_at(f, N, i, po, obs, post);
    if (fluid) lbm_hcz_collide_f(h, kh, post);
#pragma unroll
    for (int q = 0; q < 19; ++q) f_out[q * N + i] = post[q];
    lbm_pull_at(g, N, i, po, obs, post);
    if (fluid) lbm_hcz_collide_g(h, kh, post);
#pragma unroll
    for (int q = 0; q < 19; ++q) g_out[q * N + i] = post[q];
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
  const LbmCapF kc = lbm_cap_consts(kappa, grav_x, grav_y, grav_z, mu0_half, dx, dt,
                                    lbm_gas(rho_gas, rho_fluid, den_gas, den_fluid));
  const dim3 grid((X + CAP_TX - 1) / CAP_TX, (Y + CAP_TY - 1) / CAP_TY, (Z + CAP_ZB - 1) / CAP_ZB);
  lbm_cap_collide_kernel<<<grid, dim3(CAP_TX, CAP_TY), 0, static_cast<cudaStream_t>(stream)>>>(
      f, g, flags, rho_ca, h2, gsum, gmom, vel_old, pres_old, fai, prho, chi, lap, f_out, g_out,
      vel_out, pres_out, den_out, Z, Y, X, kc, lbm_hcz_consts(dx, dt, tau_f, tau_g));
  return static_cast<int>(cudaGetLastError());
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

// Blocks of lbm_cap_collide_kernel resident on one SM (for reports).
extern "C" int lbm_cap_collide_occupancy(int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, lbm_cap_collide_kernel, CAP_TX * CAP_TY, 0));
}
