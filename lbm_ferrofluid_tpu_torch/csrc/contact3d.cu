// Contact-angle surgery on rho: replaces the TPU kernel
// lbm_ferrofluid_tpu/ops/pallas/contact3d.py:contact_angle_3d (:309,
// _kernel :145).
//
// The reference's surgery (HCZ_3d.py:84-211, ops/collide.py
// contact_angle_boundary) is sequential: x faces, then y faces reading the
// updated x borders, z faces (plain interior copies), the z-edge lines,
// the x/y edge lines of planes 0 and Z-1, then the 8 corners, each reading
// the faces and edges before it.  Every read across stages resolves either
// to a pre-update value or to a value an earlier stage wrote at a
// neighbouring cell (the TPU kernel's docstring, contact3d.py:15-27), which
// is itself a closed-form function of rho and flags.  So one launch does it
// all: some blocks copy the interior cells, others take one boundary cell a
// thread, which evaluates its stage's expression with every input an
// earlier stage wrote recomputed in registers:
//   x face (z, y interior)   from rho;
//   y face (z, x interior)   from rho and the x-face values at
//                            (z, 1 or Y-2, x +- 1);
//   z face (y, x interior)   rho at plane 2 or Z-3 (no stage writes it);
//   z-edge line              a y-face and an x-face value;
//   plane-edge line          a z-face value and the neighbour plane's x- or
//                            y-face value;
//   corner                   three edge-line values.
// The chain is at most four deep (corner -> edge line -> y face -> x face
// -> rho).  The face terms round each product and sum on its own (__f*_rn:
// nvcc may not contract them into FMAs), so the result equals the plain
// version bit for bit.  It needs Z, Y, X >= 4: below that a face reads
// cells the same stage writes, and the sequential order decides.  Flags are
// read as the uint8 they are stored as, at face cells only.
//
// Bound on an H100: bytes.  The function must read rho (4 B) and write
// rho_ca (4 B) at every cell, and read flags only at face cells (1 B
// there): 8 B per cell plus 1 B per face cell, 0.040 ms at 256^3 over
// 3.35 TB/s.  The boundary cells' reads of neighbouring rows and planes
// hit L2 because a plane's ring blocks follow its copy blocks.
//
// Slab form (the TPU kernel's ghosts= and clamp=, contact3d.py:25-37, for a
// z-slab of a domain decomposed along z): every read across planes is of a
// pre-update rho, so one neighbour plane a side (lo, hi) is all a slab
// needs; bot and top say whether its planes 0 and Z-1 are the domain's true
// edges.  Only those take the edge surgery (z-face copy, edge lines,
// corners; full-plane blocks); a slab-boundary plane with a neighbour is an
// interior plane (copy and ring blocks) whose face terms read z-1 or z+1
// from the ghost.  Flags of the ghosts are never read.  The whole domain is
// the slab with bot = top = 1.
//
// Batch ([B, ...] states on one device): one launch, the plane-ordered
// blocks of an element on a row of gridDim.y each; a block moves rho,
// flags and rho_ca to its element (common.cuh:lbm_elem) and indexes its
// cells in 32 bits within it.  The slab form takes one element.
#include "common.cuh"

// blocks an SM the launch bounds ask room for (registers <= 40): the copy
// needs bytes in flight; the boundary cells' deep chains may spill
#define CA_MIN_BLOCKS 6

struct LbmCa {
  const float* __restrict__ rho;
  const uint8_t* __restrict__ flags;
  int Z, Y, X;
  float t;
  const float* __restrict__ lo;  // plane -1 and plane Z of a slab (else null)
  const float* __restrict__ hi;
  bool bot, top;                 // planes 0 and Z-1 are the domain's edges
  __device__ float r(int z, int y, int x) const {
    const long long ip = static_cast<long long>(y) * X + x;
    return z < 0 ? lo[ip] : (z >= Z ? hi[ip] : rho[lbm_index(z, y, x, Y, X)]);
  }
  __device__ bool edge(int z) const { return (z == 0 && bot) || (z == Z - 1 && top); }
  __device__ bool obs(int z, int y, int x) const {
    return flags[lbm_index(z, y, x, Y, X)] == LBM_OBSTACLE;
  }
};

// rho[s] + t sqrt(1e-6 + (a - b)^2 + (c - d)^2), each step rounded
__device__ __forceinline__ float lbm_ca_face(const LbmCa& a, float s, float p, float m, float q,
                                             float w) {
  const float d1 = p - m, d2 = q - w;
  const float hlp = sqrtf(__fadd_rn(__fadd_rn(1e-6f, __fmul_rn(d1, d1)), __fmul_rn(d2, d2)));
  return __fadd_rn(s, __fmul_rn(a.t, hlp));
}

// x face (z, y interior; x = 0 or X-1), from rho
__device__ float lbm_ca_xface(const LbmCa& a, int z, int y, int x) {
  if (!a.obs(z, y, x)) return a.r(z, y, x);
  const int xi = x == 0 ? 1 : a.X - 2, xs = x == 0 ? 2 : a.X - 3;
  return lbm_ca_face(a, a.r(z, y, xs), a.r(z + 1, y, xi), a.r(z - 1, y, xi), a.r(z, y + 1, xi),
                     a.r(z, y - 1, xi));
}

// the value after the x-face stage at (z, y, x), z and y interior
__device__ float lbm_ca_after_x(const LbmCa& a, int z, int y, int x) {
  return x == 0 || x == a.X - 1 ? lbm_ca_xface(a, z, y, x) : a.r(z, y, x);
}

// y face (z, x interior; y = 0 or Y-1): its hlp reads row 1 or Y-2 after
// the x faces
__device__ float lbm_ca_yface(const LbmCa& a, int z, int y, int x) {
  if (!a.obs(z, y, x)) return a.r(z, y, x);
  const int yi = y == 0 ? 1 : a.Y - 2, ys = y == 0 ? 2 : a.Y - 3;
  return lbm_ca_face(a, a.r(z, ys, x), a.r(z + 1, yi, x), a.r(z - 1, yi, x),
                     lbm_ca_after_x(a, z, yi, x + 1), lbm_ca_after_x(a, z, yi, x - 1));
}

// z face (y, x interior; z = 0 or Z-1): a plain interior copy
__device__ float lbm_ca_zface(const LbmCa& a, int z, int y, int x) {
  return a.obs(z, y, x) ? a.r(z == 0 ? 2 : a.Z - 3, y, x) : a.r(z, y, x);
}

// edge line of plane z = 0 or Z-1 at (y, x): an x border (y interior) or
// a y border (x interior), from the plane's own z face and the neighbour
// plane's face
__device__ float lbm_ca_plane_edge(const LbmCa& a, int z, int y, int x) {
  const int zn = z == 0 ? 1 : a.Z - 2;
  if (y >= 1 && y <= a.Y - 2)
    return 0.5f * (lbm_ca_zface(a, z, y, x == 0 ? 1 : a.X - 2) + lbm_ca_xface(a, zn, y, x));
  return 0.5f * (lbm_ca_zface(a, z, y == 0 ? 1 : a.Y - 2, x) + lbm_ca_yface(a, zn, y, x));
}

// z-edge line (z interior; y = 0 or Y-1, x = 0 or X-1)
__device__ float lbm_ca_z_edge(const LbmCa& a, int z, int y, int x) {
  return 0.5f * (lbm_ca_yface(a, z, y, x == 0 ? 1 : a.X - 2) +
                 lbm_ca_xface(a, z, y == 0 ? 1 : a.Y - 2, x));
}

// rho_ca at a cell whose rho is v
__device__ float lbm_ca_cell(const LbmCa& a, int z, int y, int x, float v) {
  const bool bz = a.edge(z), by = y == 0 || y == a.Y - 1, bx = x == 0 || x == a.X - 1;
  const int nb = bz + by + bx;
  if (nb == 0) return v;
  if (nb == 1) return bx ? lbm_ca_xface(a, z, y, x)
                         : (by ? lbm_ca_yface(a, z, y, x) : lbm_ca_zface(a, z, y, x));
  if (nb == 2) return bz ? lbm_ca_plane_edge(a, z, y, x) : lbm_ca_z_edge(a, z, y, x);
  const int zn = z == 0 ? 1 : a.Z - 2, yn = y == 0 ? 1 : a.Y - 2, xn = x == 0 ? 1 : a.X - 2;
  return (lbm_ca_plane_edge(a, z, y, xn) + lbm_ca_plane_edge(a, z, yn, x) +
          lbm_ca_z_edge(a, zn, y, x)) /
         3.0f;
}

// One launch, its blocks in plane order so that a plane's boundary cells
// are evaluated while its rows are still in L2: the edge planes (0 if bot,
// Z-1 if top) take F blocks of one boundary cell a thread; every other
// plane takes P copy blocks, 4 consecutive cells of the plane a thread (a
// 16-byte load and store where VEC: X Y % 4 == 0 and rho and out 16-byte
// aligned), which skip the plane's ring, then R blocks of one ring cell a
// thread.  The wrapper keeps N below 2^31, so cell indices are 32-bit.
template <bool VEC>
__global__ void __launch_bounds__(LBM_THREADS, CA_MIN_BLOCKS) lbm_contact_angle_kernel(
    const float* __restrict__ rho, const uint8_t* __restrict__ flags, float* __restrict__ out,
    int Z, int Y, int X, float t, int F, int P, int R, const float* __restrict__ lo,
    const float* __restrict__ hi, int bot, int top) {
  const int plane = Y * X;
  // the batch element: a row of blocks an element (a slab form's launch has one)
  const long long eb = blockIdx.y, N = static_cast<long long>(Z) * plane;
  rho = lbm_elem(rho, eb, 1, N), flags = lbm_elem(flags, eb, 1, N), out = lbm_elem(out, eb, 1, N);
  const int Fb = bot ? F : 0, zm = bot ? 1 : 0, nm = Z - zm - (top ? 1 : 0);
  int b = blockIdx.x, z, k;
  bool copy = false;
  if (b < Fb) {
    z = 0, k = b * LBM_THREADS + threadIdx.x;
  } else if (b < Fb + nm * (P + R)) {
    b -= Fb;
    z = zm + b / (P + R);
    b -= (z - zm) * (P + R);
    copy = b < P;
    k = (copy ? b : b - P) * LBM_THREADS + threadIdx.x;
  } else {
    z = Z - 1, k = (b - Fb - nm * (P + R)) * LBM_THREADS + threadIdx.x;
  }
  const LbmCa a{rho, flags, Z, Y, X, t, lo, hi, bot != 0, top != 0};
  const int base = z * plane;
  if (!copy) {
    int y, x;
    if (a.edge(z)) {
      if (k >= plane) return;
      y = k / X, x = k - y * X;
    } else {
      if (k >= 2 * X + 2 * (Y - 2)) return;
      if (k < 2 * X) {
        y = k < X ? 0 : Y - 1;
        x = k < X ? k : k - X;
      } else {
        k -= 2 * X;
        y = 1 + (k >> 1);
        x = (k & 1) ? X - 1 : 0;
      }
    }
    const int i = base + y * X + x;
    out[i] = lbm_ca_cell(a, z, y, x, rho[i]);
    return;
  }
  const int c0 = 4 * k;  // the group's first cell in the plane
  if (c0 >= plane) return;
  const int i0 = base + c0;
  int y = c0 / X, x = c0 - y * X;
  if (VEC) {
    const float4 q = *reinterpret_cast<const float4*>(rho + i0);
    if (y >= 1 && y <= Y - 2 && x >= 1 && x + 3 <= X - 2) {
      *reinterpret_cast<float4*>(out + i0) = q;
      return;
    }
    const float v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (y >= 1 && y <= Y - 2 && x >= 1 && x <= X - 2) out[i0 + j] = v[j];
      if (++x == X) x = 0, ++y;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (c0 + j < plane && y >= 1 && y <= Y - 2 && x >= 1 && x <= X - 2)
      out[i0 + j] = rho[i0 + j];
    if (++x == X) x = 0, ++y;
  }
}

// The whole domain with lo = hi = null and bot = top = 1; a slab with its
// neighbours' edge planes lo and hi ([Y, X] each) and the flags of its
// true edges.
extern "C" int lbm_contact_angle(const float* rho, const uint8_t* flags, float* out, int B, int Z,
                                 int Y, int X, double t, int vec, const float* lo, const float* hi,
                                 int bot, int top, void* stream) {
  if (B < 1 || B > 65535 || (lo != nullptr && B != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long plane = static_cast<long long>(Y) * X;
  const int F = static_cast<int>(lbm_blocks(plane));
  const int P = static_cast<int>(lbm_blocks((plane + 3) / 4));
  const int R = static_cast<int>(lbm_blocks(2LL * X + 2LL * (Y - 2)));
  const int nm = Z - (bot ? 1 : 0) - (top ? 1 : 0);
  const unsigned blocks = (bot ? F : 0) + (top ? F : 0) + nm * (P + R);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    lbm_contact_angle_kernel<true><<<dim3(blocks, B), LBM_THREADS, 0, st>>>(
        rho, flags, out, Z, Y, X, static_cast<float>(t), F, P, R, lo, hi, bot, top);
  else
    lbm_contact_angle_kernel<false><<<dim3(blocks, B), LBM_THREADS, 0, st>>>(
        rho, flags, out, Z, Y, X, static_cast<float>(t), F, P, R, lo, hi, bot, top);
  return static_cast<int>(cudaGetLastError());
}
