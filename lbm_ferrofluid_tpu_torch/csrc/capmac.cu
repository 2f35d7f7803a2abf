// Capillary stage: replaces the TPU kernel
// lbm_ferrofluid_tpu/ops/pallas/capmac.py:hcz_capillary_gradmac (:383,
// _kernel :67), the HCZ capillary stage alone: the 19-point gradients of
// lap = Laplacian(density(rho_ca)), fai, prho (and chi), the force
// kappa dens grad lap + g dens (- mu0/2 H2 grad chi) and the velocity and
// pressure recovery, emitting vel, pressure, force, dfai and dprho.
//
// The TPU kernel keeps a 5-plane z-ring in VMEM and builds the Laplacian
// one body ahead of the gradients.  The gradient of a Laplacian is a
// two-hop stencil and GPU blocks have no order, so here it is two
// launches:
//   (a) lbm_cap_derived: fai = eos(rho_pre) - rho_pre RT, prho = p - RT
//       density_pre, chi (from phi, or from density_pre for the
//       capillogue) and the Laplacian of density(rho_ca) with its zero
//       boundary ring, into scratch.  The capillogue (capillogue.cu)
//       launches the same entry point as its stage (a);
//   (b) lbm_capmac: common.cuh's lbm_capillary_cell at every cell (the
//       capillogue's collide launch runs the same device code), writing the
//       five outputs.
// Semantics kept from the TPU kernel (capmac.py:14-25): fai and prho use
// the pre-contact-angle fields, lap and the force density(rho_ca); only lap
// and chi are substituted at obstacles; z is clamped, not periodic; the
// Laplacian has a zero ring; gradient outputs replicate the nearest
// interior cell.
//
// Bound on an H100: bytes (see ops/kernels/capmac.py:cost): without H2,
// about 69 B per cell plus 16 B per fluid and 12 B per other cell, about
// 0.39 ms at 256^3 over 3.35 TB/s.  The two launches round-trip 3 (or 4)
// scratch fields and re-read the stencil inputs from L2.
#include "common.cuh"

__global__ void lbm_cap_derived_kernel(const float* __restrict__ rho_pre,
                                       const float* __restrict__ den_pre,
                                       const float* __restrict__ pres_old,
                                       const float* __restrict__ rho_ca,
                                       const float* __restrict__ phi, float* __restrict__ fai,
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
  if (chi != nullptr)
    chi[i] = phi != nullptr ? lbm_chi_of_phi(phi[i], dx)
                            : lbm_chi(den_pre[i], dx, gas.den_gas, gas.dden);
  float l = 0.f;
  if (z >= 1 && z <= Z - 2 && y >= 1 && y <= Y - 2 && x >= 1 && x <= X - 2) {
    l = lbm_laplacian(
        [&](int oz, int oy, int ox) {
          return lbm_density_of(rho_ca[lbm_index(z + oz, y + oy, x + ox, Y, X)], gas);
        },
        dx);
  }
  lap[i] = l;
}

template <bool HAS_CHI>
__global__ void __launch_bounds__(LBM_THREADS) lbm_capmac_kernel(
    const uint8_t* __restrict__ flags, const float* __restrict__ rho_ca,
    const float* __restrict__ h2, const float* __restrict__ gsum, const float* __restrict__ gmom,
    const float* __restrict__ vel_old, const float* __restrict__ pres_old,
    const float* __restrict__ fai, const float* __restrict__ prho, const float* __restrict__ chi,
    const float* __restrict__ lap, LbmCapF k, float* __restrict__ vel_out,
    float* __restrict__ pres_out, float* __restrict__ force_out, float* __restrict__ dfai_out,
    float* __restrict__ dprho_out, int Z, int Y, int X) {
  const long long N = static_cast<long long>(Z) * Y * X;
  const long long i = lbm_cell();
  if (i >= N) return;
  const int x = static_cast<int>(i % X);
  const int y = static_cast<int>((i / X) % Y);
  const int z = static_cast<int>(i / (static_cast<long long>(X) * Y));
  const LbmCapIn in{flags, rho_ca, h2, gsum, gmom, vel_old, pres_old, fai, prho, chi, lap};
  LbmCapCell o;
  lbm_capillary_cell<HAS_CHI>(in, k, i, N, lbm_cap_global_taps(in, z, y, x, Z, Y, X), o);
  pres_out[i] = o.pres;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    vel_out[d * N + i] = o.u[d];
    force_out[d * N + i] = o.force[d];
    dfai_out[d * N + i] = o.dfai[d];
    dprho_out[d * N + i] = o.dprho[d];
  }
}

// phi may be null (chi then comes from den_pre); chi may be null (no chi).
extern "C" int lbm_cap_derived(const float* rho_pre, const float* den_pre, const float* pres_old,
                               const float* rho_ca, const float* phi, float* fai, float* prho,
                               float* chi, float* lap, int Z, int Y, int X, double dx, double dt,
                               double rho_gas, double rho_fluid, double den_gas,
                               double den_fluid, void* stream) {
  const long long N = static_cast<long long>(Z) * Y * X;
  lbm_cap_derived_kernel<<<lbm_blocks(N), LBM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      rho_pre, den_pre, pres_old, rho_ca, phi, fai, prho, chi, lap, Z, Y, X, dx, dt,
      lbm_gas(rho_gas, rho_fluid, den_gas, den_fluid));
  return static_cast<int>(cudaGetLastError());
}

// h2 and chi both null selects the variant without the Kelvin term.
extern "C" int lbm_capmac(const uint8_t* flags, const float* rho_ca, const float* h2,
                          const float* gsum, const float* gmom, const float* vel_old,
                          const float* pres_old, const float* fai, const float* prho,
                          const float* chi, const float* lap, float* vel_out, float* pres_out,
                          float* force_out, float* dfai_out, float* dprho_out, int Z, int Y,
                          int X, double kappa, double grav_x, double grav_y, double grav_z,
                          double mu0_half, double dx, double dt, double rho_gas,
                          double rho_fluid, double den_gas, double den_fluid, void* stream) {
  const long long N = static_cast<long long>(Z) * Y * X;
  const LbmCapF k = lbm_cap_consts(kappa, grav_x, grav_y, grav_z, mu0_half, dx, dt,
                                   lbm_gas(rho_gas, rho_fluid, den_gas, den_fluid));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h2 != nullptr)
    lbm_capmac_kernel<true><<<lbm_blocks(N), LBM_THREADS, 0, st>>>(
        flags, rho_ca, h2, gsum, gmom, vel_old, pres_old, fai, prho, chi, lap, k, vel_out,
        pres_out, force_out, dfai_out, dprho_out, Z, Y, X);
  else
    lbm_capmac_kernel<false><<<lbm_blocks(N), LBM_THREADS, 0, st>>>(
        flags, rho_ca, h2, gsum, gmom, vel_old, pres_old, fai, prho, chi, lap, k, vel_out,
        pres_out, force_out, dfai_out, dprho_out, Z, Y, X);
  return static_cast<int>(cudaGetLastError());
}
