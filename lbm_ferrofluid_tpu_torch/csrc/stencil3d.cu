// Capillary stencils: replaces the TPU kernels of
// lbm_ferrofluid_tpu/ops/pallas/stencil3d.py, grad_fields (:176,
// _grad_kernel :90) and laplacian_field (:242, _lap_kernel :131), in their
// single-device form and, for a z-slab, their ghost-plane form (below).
//
// lbm_grad_fields writes, for each field f and each cell, the 19-point
// isotropic gradient (gx, gy, gz) into output channels 3f, 3f+1, 3f+2.  The
// TPU kernel replicates the output's boundary ring from the nearest
// interior cell (x edges, then y, then z); that equals evaluating the
// stencil at the clamped interior cell (clamp(z, 1, Z-2), clamp(y, 1, Y-2),
// clamp(x, 1, X-2)), where every tap is in range.  The caller substitutes
// obstacle values first, as on the TPU.  lbm_laplacian_field writes the
// 19-point Laplacian with a zero boundary ring (x/y edges everywhere, whole
// z edge planes); the TPU kernel reads its edge taps replicated and then
// zeroes the ring, so those reads never reach the output.  The per-cell
// functions are common.cuh's lbm_iso_grad (shared with the B1 H2 stage and
// the capillary stages) and lbm_laplacian, with their tap order.
//
// Both are one kernel template, lbm_stencil_kernel: a block owns a TX x TY
// (x, y) tile and walks a strip of zb planes of z, from a 3D grid, so no
// cell divides an index.  A 4-plane shared-memory ring holds the tile and a
// 1-cell halo of each of the NF fields (slot p % 4 for plane p); its rows and
// columns start at lbm_ring_origin, so a tile holding only the last cell of
// an axis taps around cell n - 2.  Each thread loads RY cells of a plane (a
// column x, rows ty, ty + TY/RY, ...) and at most one halo cell, at fixed
// positions found once: no division per element.  The loads of plane
// zc + 2 go to registers before the barrier that precedes plane zc's
// taps, and reach the ring one plane later, so each plane's trip to device
// memory overlaps a plane of taps and stores.  With four slots the plane
// stored at a step replaces one that no thread reads after the previous
// step's barrier: one barrier a plane.
//
// Bound on an H100: bytes.  Gradients: 4 B read and 12 B written per cell
// and field, 0.080 ms at 256^3 for one field over 3.35 TB/s; 33 flops per
// interior cell and field.  Laplacian: 4 B read and 4 B written per cell,
// 0.040 ms at 256^3; 21 flops per interior cell.  The halo columns and rows
// a block loads again (1.16-1.33x the tile) come mostly from L2.  What
// holds the kernel back on the card is the throughput of its integer and
// shared-memory instructions and the latency between a plane's barrier and
// its stores, not the bytes: the design loads a plane ahead, gives each
// instance the launch bounds' room for ST_MIN_BLOCKS blocks an SM (the
// registers against the warps that hide latency), and takes strips that
// fill whole waves of them (ops/kernels/stencil3d.py:plan).  Uniform
// fields give zero numerators, which the IEEE division sends down its slow
// path; the per-cell functions' ZERO form (common.cuh:lbm_div) returns
// those as they are.
//
// Slab form of the gradients (the TPU kernel's ghost_lo/ghost_hi with its
// caller's fix, parallel/step3d.py:grad_fields_sharded): the walk's planes
// -1 and Z are the neighbours' edge planes of each field, and the z clamp
// is [zlo, zhi] as for the Laplacian below, so the output replicate runs in
// x and y on every slab and in z only at the domain's true edges, where the
// clamped taps reproduce the whole domain's ring bit for bit.
//
// Slab form of the Laplacian (the TPU kernel's ghost_lo/ghost_hi, for a
// z-slab of a domain decomposed along z over ranks: parallel/step3d.py):
// the walk's planes -1 and Z are the neighbours' edge planes (glo, ghi:
// [Y, X] each) instead of the clamped reads, and the z clamp is [zlo, zhi]:
// [1, Z-2] at the domain's true edges, whose planes 0 and Z-1 then take
// the zero ring, and [-1, Z] where the slab has a neighbour, whose planes
// are then tapped across the face.  The y/x ring is zeroed as on the whole
// domain.  The taps and their order are the same, so a slab's planes equal
// the whole domain's bit for bit (the TPU caller zeroes the true edges'
// planes after its kernel, parallel/step3d.py:laplacian_field_sharded).
// Its bound adds the two ghost planes' reads.  Either form may take rho and
// map each value through the linear density map as it loads it (MAP,
// common.cuh:lbm_density_of): the Laplacian of density(rho_ca), as B6's
// single-device kernel builds it from its own density map (capmac.cu), so
// that the z-slab route's Laplacian, which B6's slab form takes as an
// input, is the single-device route's bit for bit (PyTorch's map of the
// same values rounds twice where the kernels' contracts an FMA).
#include "common.cuh"

// (TX, TY, RY) tiles the kernel is built for, RY rows a thread:
// ops/kernels/stencil3d.py:TILES (a CPU test reads this line).  An
// instance whose ring exceeds ST_SMEM_MAX bytes of static shared memory is
// not built, and its launch returns cudaErrorInvalidValue.
#define ST_TILES(M) M(32, 8, 1) M(64, 8, 2) M(64, 16, 4)
#define ST_SMEM_MAX 49152
// fields one launch of lbm_grad_fields takes at most (MAX_FIELDS there)
#define ST_MAX_FIELDS 4
// blocks an SM the launch bounds ask room for, for the Laplacian and for
// the gradients of NF fields (registers <= 65536 / (this x threads)):
// ops/kernels/stencil3d.py:min_blocks
#define ST_MIN_BLOCKS(NF, LAP) ((LAP) ? 6 : (NF) <= 2 ? 8 : 5)

template <int TX, int TY, int NF>
constexpr bool lbm_stencil_fits() {
  return 4 * 4 * NF * (TY + 2) * (TX + 2) <= ST_SMEM_MAX;
}

// SLAB: the slab form (planes -1 and Z from glo and ghi, the z clamp
// [zlo, zhi]); the whole domain's instances ignore those four arguments.
// MAP: each loaded value is rho, mapped through gas's density map.
template <int TX, int TY, int RY, int NF, bool LAP, bool SLAB, bool MAP>
__global__ void __launch_bounds__(TX* TY / RY, ST_MIN_BLOCKS(NF, LAP)) lbm_stencil_kernel(
    const float* __restrict__ in, float* __restrict__ out, int Z, int Y, int X, int zb,
    float k, const float* __restrict__ glo, const float* __restrict__ ghi, int zlo, int zhi,
    LbmGas gas) {
  constexpr int TT = TY / RY;             // thread rows
  constexpr int EX = TX + 2, EY = TY + 2;  // the ring: tile and 1-cell halo
  constexpr int PLANE = EY * EX;
  constexpr int NH = 2 * TX + 2 * EY;  // halo cells of a ring plane
  static_assert(TY % RY == 0 && NH <= TX * TT, "one halo cell a thread at most");
  __shared__ float ring[4 * NF * PLANE];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int z0 = blockIdx.z * zb, z1 = min(z0 + zb, Z);
  const int rx0 = lbm_ring_origin(x0, X), ry0 = lbm_ring_origin(y0, Y);
  const long long XY = static_cast<long long>(X) * Y, N = XY * Z;
  const int clo = SLAB ? zlo : 1, chi = SLAB ? zhi : Z - 2;  // the z clamp

  // What this thread loads of each plane: ring cells (r tt + ty + 1, tx + 1)
  // for r < RY, and halo cell (hy, hx) if tid < NH (rows 0 and EY - 1, then
  // columns 0 and EX - 1).  src: offset in the plane (ring cells outside
  // the grid stand on the nearest grid cell and are never tapped); dst:
  // offset in a ring plane.
  int src[RY + 1], dst[RY + 1];
  const int gx = lbm_clamp(rx0 + tx + 1, 0, X - 1);
#pragma unroll
  for (int r = 0; r < RY; ++r) {
    const int ey = r * TT + ty + 1;
    src[r] = lbm_clamp(ry0 + ey, 0, Y - 1) * X + gx;
    dst[r] = ey * EX + tx + 1;
  }
  const bool halo = tid < NH;
  {
    int hy, hx;
    if (tid < 2 * TX) {
      hy = tid < TX ? 0 : EY - 1;
      hx = (tid < TX ? tid : tid - TX) + 1;
    } else {
      const int c = tid - 2 * TX;
      hy = c < EY ? c : c - EY;
      hx = c < EY ? 0 : EX - 1;
    }
    src[RY] = lbm_clamp(ry0 + hy, 0, Y - 1) * X + lbm_clamp(rx0 + hx, 0, X - 1);
    dst[RY] = hy * EX + hx;
  }
  // a field's planes lie N apart in the slab and XY apart in a ghost
  // plane ([NF, Y, X])
  auto fetch = [&](int p, float (&v)[NF][RY + 1]) {
    const bool ghost = SLAB && (p < 0 || p >= Z);
    const float* __restrict__ s = ghost ? (p < 0 ? glo : ghi) : in + p * XY;
    const long long fs = ghost ? XY : N;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
#pragma unroll
      for (int r = 0; r < RY; ++r) {
        v[f][r] = s[f * fs + src[r]];
        if (MAP) v[f][r] = lbm_density_of(v[f][r], gas);
      }
      if (halo) {
        v[f][RY] = s[f * fs + src[RY]];
        if (MAP) v[f][RY] = lbm_density_of(v[f][RY], gas);
      }
    }
  };
  auto put = [&](int p, const float (&v)[NF][RY + 1]) {
    float* d = ring + (p & 3) * NF * PLANE;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
#pragma unroll
      for (int r = 0; r < RY; ++r) d[f * PLANE + dst[r]] = v[f][r];
      if (halo) d[f * PLANE + dst[RY]] = v[f][RY];
    }
  };

  // The cells of this thread: column x, rows y0 + r tt + ty, written at
  // o + r tt X (o advances a plane a step); taps around the nearest
  // interior cell, at offset at[r] of a ring plane.
  const int x = x0 + tx;
  const int xl = lbm_clamp(x, 1, X - 2) - rx0;
  const int row = TT * X;
  float* __restrict__ o = out + (static_cast<long long>(z0) * Y + y0 + ty) * X + x;
  int at[RY];
  bool act[RY], ring_xy[RY];
#pragma unroll
  for (int r = 0; r < RY; ++r) {
    const int y = y0 + r * TT + ty;
    act[r] = x < X && y < Y;
    at[r] = (lbm_clamp(y, 1, Y - 2) - ry0) * EX + xl;
    ring_xy[r] = x == 0 || x == X - 1 || y == 0 || y == Y - 1;
  }

  // The walk: planes lo..last, where a cell at z taps zc - 1..zc + 1 with
  // zc = clamp(z, clo, chi); hi is the last plane in the ring, v holds
  // plane hi + 1 (when the strip needs it).  Slot p & 3 holds plane p
  // (plane -1 of a slab in slot 3).
  const int lo = lbm_clamp(z0, clo, chi) - 1, last = lbm_clamp(z1 - 1, clo, chi) + 1;
  float v[NF][RY + 1];
  {
    float w[NF][RY + 1];
    fetch(lo, v);
    fetch(lo + 1, w);
    put(lo, v);
    put(lo + 1, w);
  }
  fetch(lo + 2, v);
  int hi = lo + 1;
  for (int z = z0; z < z1; ++z, o += XY) {
    const int zc = lbm_clamp(z, clo, chi);
    if (zc + 1 > hi) {  // the same for the whole block
      put(++hi, v);
      if (hi + 1 <= last) fetch(hi + 1, v);
      __syncthreads();
    }
    // ring offsets of the three planes' slots
    const int bm = ((zc - 1) & 3) * NF * PLANE, b0 = (zc & 3) * NF * PLANE,
              bp = ((zc + 1) & 3) * NF * PLANE;
#pragma unroll
    for (int r = 0; r < RY; ++r) {
      if (!act[r]) continue;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        auto tap = [&](int oz, int oy, int ox) {
          return ring[(oz < 0 ? bm : (oz > 0 ? bp : b0)) + at[r] + f * PLANE + oy * EX + ox];
        };
        if constexpr (LAP) {
          o[r * row] = ring_xy[r] || z != zc ? 0.f : lbm_laplacian<true>(tap, k);
        } else {
          float g[3];
          lbm_iso_grad<true>(tap, k, g);
#pragma unroll
          for (int d = 0; d < 3; ++d) o[(3 * f + d) * N + r * row] = g[d];
        }
      }
    }
  }
}

#define ST_FIELDS(M, TX_, TY_, RY_) M(TX_, TY_, RY_, 1) M(TX_, TY_, RY_, 2) \
  M(TX_, TY_, RY_, 3) M(TX_, TY_, RY_, 4)

// One launch of an instance on strips of zb planes, if it is built (SLAB:
// the slab form, with glo, ghi, zlo and zhi; MAP: the density map gas).
template <int TX, int TY, int RY, int NF, bool LAP, bool SLAB = false, bool MAP = false>
static int lbm_stencil_launch(const float* in, float* out, int Z, int Y, int X, int zb,
                              float k, cudaStream_t st, const float* glo = nullptr,
                              const float* ghi = nullptr, int zlo = 1, int zhi = 0,
                              LbmGas gas = LbmGas{}) {
  if constexpr (lbm_stencil_fits<TX, TY, NF>()) {
    const dim3 grid((X + TX - 1) / TX, (Y + TY - 1) / TY, (Z + zb - 1) / zb);
    lbm_stencil_kernel<TX, TY, RY, NF, LAP, SLAB, MAP><<<grid, dim3(TX, TY / RY), 0, st>>>(
        in, out, Z, Y, X, zb, k, glo, ghi, zlo, zhi, gas);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Resident blocks an SM of an instance, if it is built.
template <int TX, int TY, int RY, int NF, bool LAP>
static int lbm_stencil_blocks(int* blocks) {
  if constexpr (lbm_stencil_fits<TX, TY, NF>())
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, lbm_stencil_kernel<TX, TY, RY, NF, LAP, false, false>, TX * TY / RY, 0));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The gradients of nf <= ST_MAX_FIELDS fields in one launch on (tx, ty)
// tiles (one of ST_TILES) and strips of zb planes: the slab form where glo
// is not null (glo and ghi the neighbours' edge planes of each field, [nf,
// Y, X] each; [zlo, zhi] the z clamp, 1 and Z-2 at the domain's true edges,
// whose planes then take the z replicate, -1 and Z where the slab has a
// neighbour), the whole domain's otherwise (zlo and zhi unused).
extern "C" int lbm_grad_fields(const float* in, const float* glo, const float* ghi, float* out,
                               int nf, int Z, int Y, int X, int tx, int ty, int zb, int zlo,
                               int zhi, double dx, void* stream) {
  const bool slab = glo != nullptr;
  if (zb < 1 || (slab && zlo > zhi)) return static_cast<int>(cudaErrorInvalidValue);
  const float d12 = lbm_f32(12.0 * dx);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ST_GRAD(TX_, TY_, RY_, NF_)                                                         \
  if (nf == NF_) {                                                                          \
    if (slab)                                                                               \
      return lbm_stencil_launch<TX_, TY_, RY_, NF_, false, true>(in, out, Z, Y, X, zb, d12, \
                                                                 st, glo, ghi, zlo, zhi);   \
    return lbm_stencil_launch<TX_, TY_, RY_, NF_, false>(in, out, Z, Y, X, zb, d12, st);    \
  }
#define ST_GRAD_TILE(TX_, TY_, RY_) \
  if (tx == TX_ && ty == TY_) {     \
    ST_FIELDS(ST_GRAD, TX_, TY_, RY_) \
  }
  ST_TILES(ST_GRAD_TILE)
#undef ST_GRAD_TILE
#undef ST_GRAD
  return static_cast<int>(cudaErrorInvalidValue);
}

// The Laplacian in one launch on (tx, ty) tiles (one of ST_TILES) and
// strips of zb planes: the slab form where glo is not null (glo and ghi
// the neighbours' edge planes, [Y, X] each; [zlo, zhi] the z clamp, 1 and
// Z-2 at the domain's true edges, -1 and Z where the slab has a
// neighbour), the whole domain's otherwise (zlo and zhi unused); with map
// nonzero, of density(in) (in, glo and ghi hold rho).
extern "C" int lbm_laplacian_field(const float* in, const float* glo, const float* ghi,
                                   float* out, int Z, int Y, int X, int tx, int ty, int zb,
                                   int zlo, int zhi, double dx, int map, double rho_gas,
                                   double rho_fluid, double den_gas, double den_fluid,
                                   void* stream) {
  const bool slab = glo != nullptr;
  if (zb < 1 || (slab && zlo > zhi)) return static_cast<int>(cudaErrorInvalidValue);
  const float d6 = lbm_f32(6.0 * dx * dx);
  const LbmGas gas = lbm_gas(rho_gas, rho_fluid, den_gas, den_fluid);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ST_LAP(TX_, TY_, RY_)                                                           \
  if (tx == TX_ && ty == TY_) {                                                            \
    if (slab && map)                                                                       \
      return lbm_stencil_launch<TX_, TY_, RY_, 1, true, true, true>(in, out, Z, Y, X, zb,  \
                                                                    d6, st, glo, ghi, zlo, \
                                                                    zhi, gas);             \
    if (slab)                                                                              \
      return lbm_stencil_launch<TX_, TY_, RY_, 1, true, true, false>(in, out, Z, Y, X, zb, \
                                                                     d6, st, glo, ghi, zlo, \
                                                                     zhi);                  \
    if (map)                                                                               \
      return lbm_stencil_launch<TX_, TY_, RY_, 1, true, false, true>(                      \
          in, out, Z, Y, X, zb, d6, st, nullptr, nullptr, 1, 0, gas);                      \
    return lbm_stencil_launch<TX_, TY_, RY_, 1, true>(in, out, Z, Y, X, zb, d6, st);       \
  }
  ST_TILES(ST_LAP)
#undef ST_LAP
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the (tx, ty) instance for nf fields (lap 1: the Laplacian)
// resident on one SM (for reports).
extern "C" int lbm_stencil_occupancy(int tx, int ty, int nf, int lap, int* blocks) {
#define ST_OCC(TX_, TY_, RY_, NF_) \
  if (!lap && nf == NF_) return lbm_stencil_blocks<TX_, TY_, RY_, NF_, false>(blocks);
#define ST_OCC_TILE(TX_, TY_, RY_)                                            \
  if (tx == TX_ && ty == TY_) {                                               \
    if (lap) return lbm_stencil_blocks<TX_, TY_, RY_, 1, true>(blocks);       \
    ST_FIELDS(ST_OCC, TX_, TY_, RY_)                                          \
  }
  ST_TILES(ST_OCC_TILE)
#undef ST_OCC_TILE
#undef ST_OCC
  return static_cast<int>(cudaErrorInvalidValue);
}
