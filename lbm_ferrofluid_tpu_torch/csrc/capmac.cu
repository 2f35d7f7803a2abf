// Capillary stage: replaces the TPU kernel
// lbm_ferrofluid_tpu/ops/pallas/capmac.py:hcz_capillary_gradmac (:383,
// _kernel :67), the HCZ capillary stage alone: the 19-point gradients of
// lap = Laplacian(density(rho_ca)), fai, prho (and chi), the force
// kappa dens grad lap + g dens (- mu0/2 H2 grad chi) and the velocity and
// pressure recovery, emitting vel, pressure, force, dfai and dprho.
//
// The TPU kernel keeps a 5-plane z-ring in VMEM and builds the Laplacian
// one body ahead of the gradients.  Here it is one launch, lbm_capmac, with
// no scratch field in device memory:
//   - a block owns a TX x TY (x, y) tile and walks a strip of zb planes of
//     z, from a 3D grid: no cell divides a 64-bit index;
//   - a 4-plane shared-memory ring holds density(rho_ca) of the tile and a
//     2-cell halo, one plane ahead of what the Laplacian needs: the load of
//     plane q + 2 shares a phase with building plane q's derived fields;
//   - a 3-plane ring holds lap, chi (with H2), fai and prho of the tile and
//     a 1-cell halo, built at load as the taps read them (B3's collide
//     launch reads the same ring from device memory): fai and prho at the
//     nearest interior cell c, chi from phi, lap from the density ring
//     with its zero boundary ring, lap and chi taken at c at obstacles;
//   - each cell then runs common.cuh's lbm_capillary_cell with a ring tap,
//     as B3's collide launch does, on its own inputs, which it loads before
//     the barrier and the derived plane that precede its taps.
// Semantics kept from the TPU kernel (capmac.py:14-25): fai and prho use
// the pre-contact-angle fields, lap and the force density(rho_ca); only lap
// and chi are substituted at obstacles; z is clamped, not periodic; the
// Laplacian has a zero ring; gradient outputs replicate the nearest
// interior cell.  The per-cell functions and their order of taps are those
// of the two-launch form this replaced.
//
// Bound on an H100: bytes (see ops/kernels/capmac.py:cost): without H2,
// about 69 B per cell plus 16 B per fluid and 12 B per other cell, about
// 0.42 ms at 256^3 over 3.35 TB/s.  A block reloads its halo, 1.33x the
// tile's cells for the 1-halo fields and 1.69x for rho_ca at 32 x 8,
// mostly from L2.  Each plane's phases wait on device memory between
// barriers, so what hides that is blocks: the launch bounds hold a block
// of 256 threads to 48 registers, five an SM, and ops/kernels/capmac.py:
// plan picks the strip that fills whole waves of them.
//
// Slab form (the TPU kernel's ghosts= and clamp=, capmac.py:383, for a
// z-slab of a domain decomposed along z over ranks: parallel/step3d.py),
// lbm_capmac_slab: as on the TPU, the Laplacian comes in as an input (B10b's
// slab form, stencil3d.cu), so no density ring is needed.  The block walks
// its strip with a 3-plane ring of lap, chi, fai and prho (common.cuh:
// lbm_zwalk and lbm_halo_cells_clamped, as B3's collide launch walks its
// slab), whose planes -1 and Z come from the neighbours' edge planes of
// lap, rho_pre, density_pre, pressure, phi and flags (one plane a side
// each), and the z clamp is [zlo, zhi]: [1, Z-2] at the domain's true
// edges, [-1, Z] where the slab has a neighbour.  The substitutions, the
// per-cell stage (lbm_capillary_cell) and its order of taps are the
// single-device kernel's, so a slab's outputs equal the single-device
// kernel's on the same lap bit for bit.  Its bound adds the lap field and
// the ghost planes' reads, and drops the Laplacian's flops.
//
// Batch ([B, ...] states on one device): one launch of lbm_capmac for the
// B elements, gridDim.z = B nzb with nzb an element's strips
// (common.cuh:lbm_fold_z); a block moves its fields to its element
// (lbm_elem), so its rings and z clamp are an element's and the plan
// (tile, strip) is the one-element plan.  The slab form takes one element.
#include "common.cuh"

// (TX, TY) tiles lbm_capmac is built for: ops/kernels/capmac.py:TILES (a
// CPU test reads this line)
#define CM_TILES(M) M(32, 8) M(64, 4)
// threads an SM the launch bounds ask room for: registers <= 65536 / this
#define CM_SM_THREADS 1280

template <int TX, int TY, bool HAS_CHI>
__global__ void __launch_bounds__(TX* TY, CM_SM_THREADS / (TX * TY)) lbm_capmac_kernel(
    const uint8_t* __restrict__ flags, const float* __restrict__ rho_pre,
    const float* __restrict__ den_pre, const float* __restrict__ pres_old,
    const float* __restrict__ rho_ca, const float* __restrict__ phi,
    const float* __restrict__ h2, const float* __restrict__ gsum, const float* __restrict__ gmom,
    const float* __restrict__ vel_old, float* __restrict__ vel_out,
    float* __restrict__ pres_out, float* __restrict__ force_out, float* __restrict__ dfai_out,
    float* __restrict__ dprho_out, int Z, int Y, int X, int zb, LbmCapF k, double dx,
    float d6, double RT) {
  constexpr int EX = TX + 2, EY = TY + 2;  // the derived ring: tile and 1-cell halo
  constexpr int DX = TX + 4, DY = TY + 4;  // the density ring: tile and 2-cell halo
  constexpr int NF = HAS_CHI ? 4 : 3;      // lap, (chi), fai, prho
  __shared__ float ring[3][NF][EY][EX];
  __shared__ float dens[4][DY][DX];
  const long long N = static_cast<long long>(Z) * Y * X;
  // the batch element and the strip: B elements of nzb strips on gridDim.z
  long long b;
  int zs;
  lbm_fold_z((Z + zb - 1) / zb, b, zs);
  flags = lbm_elem(flags, b, 1, N), rho_pre = lbm_elem(rho_pre, b, 1, N);
  den_pre = lbm_elem(den_pre, b, 1, N), pres_old = lbm_elem(pres_old, b, 1, N);
  rho_ca = lbm_elem(rho_ca, b, 1, N), phi = lbm_elem(phi, b, 1, N), h2 = lbm_elem(h2, b, 1, N);
  gsum = lbm_elem(gsum, b, 1, N), gmom = lbm_elem(gmom, b, 3, N);
  vel_old = lbm_elem(vel_old, b, 3, N), vel_out = lbm_elem(vel_out, b, 3, N);
  pres_out = lbm_elem(pres_out, b, 1, N), force_out = lbm_elem(force_out, b, 3, N);
  dfai_out = lbm_elem(dfai_out, b, 3, N), dprho_out = lbm_elem(dprho_out, b, 3, N);
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  const int z0 = zs * zb, z1 = min(z0 + zb, Z);
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int rx0 = lbm_ring_origin(x0, X), ry0 = lbm_ring_origin(y0, Y);

  // density(rho_ca) of plane q, rows ry0 - 1.. and columns rx0 - 1.. (cells
  // outside the grid stand on the nearest grid cell and are never tapped)
  auto load_density = [&](int q) {
    float(*dst)[DX] = dens[q & 3];
    const float* __restrict__ src = rho_ca + static_cast<long long>(q) * Y * X;
    for (int e = tid; e < DY * DX; e += TX * TY) {
      const int dy = e / DX, ex = e - dy * DX;
      const int gy = lbm_clamp(ry0 - 1 + dy, 0, Y - 1), gx = lbm_clamp(rx0 - 1 + ex, 0, X - 1);
      dst[dy][ex] = lbm_density_of(src[gy * X + gx], k.gas);
    }
  };
  // the derived fields of plane p as the taps read them; the Laplacian at m
  // (n, or c at an obstacle) reads density planes pc - 1..pc + 1
  auto derive = [&](int p) {
    float(*dst)[EY][EX] = ring[p % 3];
    lbm_halo_cells<TX, TY>(p, x0, y0, Z, Y, X, [&](int ey, int ex, long long n, long long c) {
      const bool obs = flags[n] == LBM_OBSTACLE;
      const int pc = lbm_clamp(p, 1, Z - 2);
      const int gy = lbm_clamp(ry0 + ey, 0, Y - 1), gx = lbm_clamp(rx0 + ex, 0, X - 1);
      const int mz = obs ? pc : p;
      const int my = obs ? lbm_clamp(gy, 1, Y - 2) : gy, mx = obs ? lbm_clamp(gx, 1, X - 2) : gx;
      float l = 0.f;
      if (mz >= 1 && mz <= Z - 2 && my >= 1 && my <= Y - 2 && mx >= 1 && mx <= X - 2) {
        const int ly = my - ry0 + 1, lx = mx - rx0 + 1;
        l = lbm_laplacian(
            [&](int oz, int oy, int ox) { return dens[(mz + oz) & 3][ly + oy][lx + ox]; }, d6);
      }
      dst[0][ey][ex] = l;
      // phi at both cells, so that its load does not wait for the flag's
      if (HAS_CHI) {
        const float phn = phi[n], phc = phi[c];
        dst[1][ey][ex] = lbm_chi_of_phi(obs ? phc : phn, dx);
      }
      dst[NF - 2][ey][ex] = lbm_fai(rho_pre[c], RT);
      dst[NF - 1][ey][ex] = pres_old[c] - static_cast<float>(RT) * den_pre[c];
    });
  };
  // The walk.  Derived plane p needs density planes pc - 1..pc + 1 (pc =
  // clamp(p, 1, Z - 2)); dhi is the last density plane loaded and dmax the
  // last one the strip needs.  advance(p) runs between barriers: it loads
  // what plane p still lacks (only at the strip's start, behind a barrier
  // of its own), then loads plane pc + 2, which derive(p) does not read,
  // while it builds plane p.
  const int hi_last = lbm_clamp(z1 - 1, 1, Z - 2) + 1;
  const int dmax = lbm_clamp(hi_last, 1, Z - 2) + 1;
  int hi = lbm_clamp(z0, 1, Z - 2) + 1;
  int dhi = lbm_clamp(hi - 2, 1, Z - 2) - 2;
  auto advance = [&](int p) {
    const int pc = lbm_clamp(p, 1, Z - 2);
    if (dhi < pc + 1) {  // the same for the whole block
      while (dhi < pc + 1) load_density(++dhi);
      __syncthreads();
    }
    if (dhi == pc + 1 && dhi < dmax) load_density(++dhi);
    derive(p);
  };
  for (int p = hi - 2; p <= hi; ++p) {
    advance(p);
    __syncthreads();
  }

  // A cell's own inputs are loaded before the barrier and the derived plane
  // that precede its taps, and its flag, which selects them, one plane
  // earlier still, so that their trips to device memory overlap that work.
  const LbmCapIn in{flags, rho_ca, h2, gsum, gmom, vel_old, pres_old};
  const bool active = x < X && y < Y;
  const int xl = lbm_clamp(x, 1, X - 2) - rx0, yl = lbm_clamp(y, 1, Y - 2) - ry0;
  const long long XY = static_cast<long long>(X) * Y;
  long long i = (static_cast<long long>(z0) * Y + y) * X + x;
  uint8_t fl_next = active ? flags[i] : 0;
  for (int z = z0; z < z1; ++z, i += XY) {
    LbmCapPoint pt;
    if (active) {
      const uint8_t fl = fl_next;
      if (z + 1 < z1) fl_next = flags[i + XY];
      pt = lbm_cap_point<HAS_CHI>(in, i, N, fl);
    }
    const int zc = lbm_clamp(z, 1, Z - 2);
    if (zc + 1 > hi) {  // the same for the whole block
      __syncthreads();
      advance(++hi);
      __syncthreads();
    }
    if (!active) continue;
    const int sm = (zc - 1) % 3, s0 = zc % 3, sp = (zc + 1) % 3;
    auto tap = [&](int fld, int oz, int oy, int ox) -> float {
      const int f = HAS_CHI || fld == 0 ? fld : fld - 1;
      return ring[oz < 0 ? sm : (oz > 0 ? sp : s0)][f][yl + oy][xl + ox];
    };
    LbmCapCell o;
    lbm_capillary_cell<HAS_CHI>(pt, k, tap, o);
    pres_out[i] = o.pres;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      vel_out[d * N + i] = o.u[d];
      force_out[d * N + i] = o.force[d];
      dfai_out[d * N + i] = o.dfai[d];
      dprho_out[d * N + i] = o.dprho[d];
    }
  }
}

// The neighbours' edge planes of the slab form ([Y, X] each): lo from the
// plane below the slab, hi from the plane above it.
struct LbmCmGhosts {
  const float *lap_lo, *lap_hi, *rho_lo, *rho_hi, *den_lo, *den_hi, *pres_lo, *pres_hi,
      *phi_lo, *phi_hi;
  const uint8_t *fl_lo, *fl_hi;
};

template <int TX, int TY, bool HAS_CHI>
__global__ void __launch_bounds__(TX* TY, CM_SM_THREADS / (TX * TY)) lbm_capmac_slab_kernel(
    const uint8_t* __restrict__ flags, const float* __restrict__ lap,
    const float* __restrict__ rho_pre, const float* __restrict__ den_pre,
    const float* __restrict__ pres_old, const float* __restrict__ rho_ca,
    const float* __restrict__ phi, const float* __restrict__ h2, const float* __restrict__ gsum,
    const float* __restrict__ gmom, const float* __restrict__ vel_old,
    float* __restrict__ vel_out, float* __restrict__ pres_out, float* __restrict__ force_out,
    float* __restrict__ dfai_out, float* __restrict__ dprho_out, int Z, int Y, int X, int zb,
    LbmCapF k, double dx, double RT, LbmCmGhosts gh, int zlo, int zhi) {
  constexpr int EX = TX + 2, EY = TY + 2;  // the ring: tile and 1-cell halo
  constexpr int NF = HAS_CHI ? 4 : 3;      // lap, (chi), fai, prho
  __shared__ float ring[3][NF][EY][EX];
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  const int z0 = blockIdx.z * zb, z1 = min(z0 + zb, Z);
  const long long NP = static_cast<long long>(Y) * X, N = Z * NP;

  // a field's value at cell n of plane p (p may be -1 or Z)
  auto at = [&](const float* v, const float* lo, const float* hi, int p, long long n) {
    return lbm_slab_at(v, lo, hi, 1, p, Z, n - p * NP, NP);
  };
  // the derived fields of plane p as the taps read them: lap and chi taken
  // at c (the nearest interior cell) at an obstacle, fai and prho at c
  auto load = [&](int p) {
    float(*dst)[EY][EX] = ring[lbm_mod(p, 3)];
    const int pc = lbm_clamp(p, zlo, zhi);
    lbm_halo_cells_clamped<TX, TY>(
        p, x0, y0, zlo, zhi, Y, X, Y, X, [&](int ey, int ex, long long n, long long c) {
          const bool obs =
              lbm_slab_at(flags, gh.fl_lo, gh.fl_hi, 1, p, Z, n - p * NP, NP) == LBM_OBSTACLE;
          dst[0][ey][ex] = obs ? at(lap, gh.lap_lo, gh.lap_hi, pc, c)
                               : at(lap, gh.lap_lo, gh.lap_hi, p, n);
          if (HAS_CHI) {
            const float phn = at(phi, gh.phi_lo, gh.phi_hi, p, n);
            const float phc = at(phi, gh.phi_lo, gh.phi_hi, pc, c);
            dst[1][ey][ex] = lbm_chi_of_phi(obs ? phc : phn, dx);
          }
          dst[NF - 2][ey][ex] = lbm_fai(at(rho_pre, gh.rho_lo, gh.rho_hi, pc, c), RT);
          dst[NF - 1][ey][ex] = at(pres_old, gh.pres_lo, gh.pres_hi, pc, c) -
                                static_cast<float>(RT) * at(den_pre, gh.den_lo, gh.den_hi, pc, c);
        });
  };
  const LbmCapIn in{flags, rho_ca, h2, gsum, gmom, vel_old, pres_old};
  const int xl = lbm_clamp(x, 1, X - 2) - lbm_ring_origin(x0, X);
  const int yl = lbm_clamp(y, 1, Y - 2) - lbm_ring_origin(y0, Y);
  lbm_zwalk(z0, z1, zlo, zhi, x < X && y < Y, load, [&](int z, int sm, int s0, int sp) {
    auto tap = [&](int fld, int oz, int oy, int ox) -> float {
      const int f = HAS_CHI || fld == 0 ? fld : fld - 1;
      return ring[oz < 0 ? sm : (oz > 0 ? sp : s0)][f][yl + oy][xl + ox];
    };
    const long long i = (static_cast<long long>(z) * Y + y) * X + x;
    LbmCapCell o;
    lbm_capillary_cell<HAS_CHI>(lbm_cap_point<HAS_CHI>(in, i, N, flags[i]), k, tap, o);
    pres_out[i] = o.pres;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      vel_out[d * N + i] = o.u[d];
      force_out[d * N + i] = o.force[d];
      dfai_out[d * N + i] = o.dfai[d];
      dprho_out[d * N + i] = o.dprho[d];
    }
  });
}

// The capillary stage in one launch on (tx, ty) tiles (one of CM_TILES)
// and strips of zb planes.  h2 and phi both null select the variant
// without the Kelvin term.
extern "C" int lbm_capmac(const uint8_t* flags, const float* rho_pre, const float* den_pre,
                          const float* pres_old, const float* rho_ca, const float* phi,
                          const float* h2, const float* gsum, const float* gmom,
                          const float* vel_old, float* vel_out, float* pres_out,
                          float* force_out, float* dfai_out, float* dprho_out, int B, int Z,
                          int Y, int X, int tx, int ty, int zb, double kappa, double grav_x,
                          double grav_y, double grav_z, double mu0_half, double dx, double dt,
                          double rho_gas, double rho_fluid, double den_gas, double den_fluid,
                          void* stream) {
  const LbmCapF k = lbm_cap_consts(kappa, grav_x, grav_y, grav_z, mu0_half, dx, dt,
                                   lbm_gas(rho_gas, rho_fluid, den_gas, den_fluid));
  const double c = dx / dt;
  const double RT = c * c / 3.0;
  const float d6 = lbm_f32(6.0 * dx * dx);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (zb < 1 || B < 1 || static_cast<long long>(B) * ((Z + zb - 1) / zb) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
#define CM_LAUNCH(TX_, TY_)                                                                    \
  if (tx == TX_ && ty == TY_) {                                                                \
    const dim3 grid((X + TX_ - 1) / TX_, (Y + TY_ - 1) / TY_, B * ((Z + zb - 1) / zb));       \
    if (h2 != nullptr)                                                                         \
      lbm_capmac_kernel<TX_, TY_, true><<<grid, dim3(TX_, TY_), 0, st>>>(                      \
          flags, rho_pre, den_pre, pres_old, rho_ca, phi, h2, gsum, gmom, vel_old, vel_out,    \
          pres_out, force_out, dfai_out, dprho_out, Z, Y, X, zb, k, dx, d6, RT);               \
    else                                                                                       \
      lbm_capmac_kernel<TX_, TY_, false><<<grid, dim3(TX_, TY_), 0, st>>>(                     \
          flags, rho_pre, den_pre, pres_old, rho_ca, phi, h2, gsum, gmom, vel_old, vel_out,    \
          pres_out, force_out, dfai_out, dprho_out, Z, Y, X, zb, k, dx, d6, RT);               \
    return static_cast<int>(cudaGetLastError());                                               \
  }
  CM_TILES(CM_LAUNCH)
#undef CM_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The slab form in one launch on (tx, ty) tiles (one of CM_TILES) and
// strips of zb planes: lap the Laplacian of density(rho_ca) on the slab;
// g[0..11] the ghost planes ([Y, X] each) of lap, rho_pre, density_pre,
// pressure and phi (below, above) as floats, then flags (below, above) as
// uint8; [zlo, zhi] the z clamp.  h2 and phi both null select the variant
// without the Kelvin term.
extern "C" int lbm_capmac_slab(const uint8_t* flags, const float* lap, const float* rho_pre,
                               const float* den_pre, const float* pres_old,
                               const float* rho_ca, const float* phi, const float* h2,
                               const float* gsum, const float* gmom, const float* vel_old,
                               float* vel_out, float* pres_out, float* force_out,
                               float* dfai_out, float* dprho_out, int Z, int Y, int X, int tx,
                               int ty, int zb, double kappa, double grav_x, double grav_y,
                               double grav_z, double mu0_half, double dx, double dt,
                               double rho_gas, double rho_fluid, double den_gas,
                               double den_fluid, const float* lap_lo, const float* lap_hi,
                               const float* rho_lo, const float* rho_hi, const float* den_lo,
                               const float* den_hi, const float* pres_lo, const float* pres_hi,
                               const float* phi_lo, const float* phi_hi, const uint8_t* fl_lo,
                               const uint8_t* fl_hi, int zlo, int zhi, void* stream) {
  const LbmCapF k = lbm_cap_consts(kappa, grav_x, grav_y, grav_z, mu0_half, dx, dt,
                                   lbm_gas(rho_gas, rho_fluid, den_gas, den_fluid));
  const double c = dx / dt;
  const double RT = c * c / 3.0;
  const LbmCmGhosts gh{lap_lo, lap_hi, rho_lo, rho_hi, den_lo, den_hi, pres_lo, pres_hi,
                       phi_lo, phi_hi, fl_lo, fl_hi};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (zb < 1 || zlo > zhi) return static_cast<int>(cudaErrorInvalidValue);
#define CM_SLAB_LAUNCH(TX_, TY_)                                                               \
  if (tx == TX_ && ty == TY_) {                                                                \
    const dim3 grid((X + TX_ - 1) / TX_, (Y + TY_ - 1) / TY_, (Z + zb - 1) / zb);             \
    if (h2 != nullptr)                                                                         \
      lbm_capmac_slab_kernel<TX_, TY_, true><<<grid, dim3(TX_, TY_), 0, st>>>(                 \
          flags, lap, rho_pre, den_pre, pres_old, rho_ca, phi, h2, gsum, gmom, vel_old,        \
          vel_out, pres_out, force_out, dfai_out, dprho_out, Z, Y, X, zb, k, dx, RT, gh, zlo,  \
          zhi);                                                                                \
    else                                                                                       \
      lbm_capmac_slab_kernel<TX_, TY_, false><<<grid, dim3(TX_, TY_), 0, st>>>(                \
          flags, lap, rho_pre, den_pre, pres_old, rho_ca, phi, h2, gsum, gmom, vel_old,        \
          vel_out, pres_out, force_out, dfai_out, dprho_out, Z, Y, X, zb, k, dx, RT, gh, zlo,  \
          zhi);                                                                                \
    return static_cast<int>(cudaGetLastError());                                               \
  }
  CM_TILES(CM_SLAB_LAUNCH)
#undef CM_SLAB_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of lbm_capmac's (tx, ty) instance, with H2 (has_chi 1) or without,
// resident on one SM (for reports).
extern "C" int lbm_capmac_occupancy(int tx, int ty, int has_chi, int* blocks) {
#define CM_OCC(TX_, TY_)                                                                     \
  if (tx == TX_ && ty == TY_)                                                                \
    return static_cast<int>(                                                                 \
        has_chi ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(                             \
                      blocks, lbm_capmac_kernel<TX_, TY_, true>, TX_ * TY_, 0)               \
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(                             \
                      blocks, lbm_capmac_kernel<TX_, TY_, false>, TX_ * TY_, 0));
  CM_TILES(CM_OCC)
#undef CM_OCC
  return static_cast<int>(cudaErrorInvalidValue);
}
