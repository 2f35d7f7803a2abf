// Contact-angle surgery on rho: replaces the TPU kernel
// lbm_ferrofluid_tpu/ops/pallas/contact3d.py:contact_angle_3d (:309,
// _kernel :145).
//
// The reference's surgery (HCZ_3d.py:84-211, ops/collide.py
// contact_angle_boundary) is sequential: x faces, then y faces reading the
// updated x borders, z faces (plain interior copies), the z-edge lines,
// the x/y edge lines of planes 0 and Z-1, then the 8 corners, each reading
// the faces and edges before it.  GPU blocks have no grid-wide barrier, so
// each dependency stage is its own launch over the cells it writes; the
// launches are the barriers.  Within a stage no thread reads a cell that
// another thread of the same stage writes (true for Z, Y, X >= 4).
//   stage 0: rho_ca = rho everywhere, x faces from rho (the whole volume)
//   stage 1: y faces                 stage 2: z faces
//   stage 3: z-edge lines            stage 4: edge lines of planes 0, Z-1
//   stage 5: corners
// Flags are read as the uint8 they are stored as.
//
// Bound on an H100: bytes.  The function must read rho (4 B) and write
// rho_ca (4 B) at every cell, and read flags only at face cells (1 B
// there): 8 B per cell plus 1 B per face cell, 0.040 ms at 256^3 over
// 3.35 TB/s.  Stage 0 moves about that; stages 1-5 touch only the
// boundary and cost mostly their launch.
#include "common.cuh"

__device__ __forceinline__ float lbm_face_hlp(float a, float b, float c, float d) {
  return sqrtf(1e-6f + (a - b) * (a - b) + (c - d) * (c - d));
}

// stage 0: copy plus x faces (z, y interior; x = 0 or X-1) from rho
__global__ void lbm_ca_x_faces(const float* __restrict__ rho, const uint8_t* __restrict__ flags,
                               float* __restrict__ out, int Z, int Y, int X, double t) {
  const long long N = static_cast<long long>(Z) * Y * X;
  const long long i = lbm_cell();
  if (i >= N) return;
  const int x = static_cast<int>(i % X);
  const int y = static_cast<int>((i / X) % Y);
  const int z = static_cast<int>(i / (static_cast<long long>(X) * Y));
  float v = rho[i];
  const bool face = (x == 0 || x == X - 1) && z >= 1 && z <= Z - 2 && y >= 1 && y <= Y - 2;
  if (face && flags[i] == LBM_OBSTACLE) {
    const int xi = x == 0 ? 1 : X - 2;   // the column the hlp reads
    const int xs = x == 0 ? 2 : X - 3;   // the column the value copies
#define R(zz, yy, xx) rho[lbm_index(zz, yy, xx, Y, X)]
    const float hlp = lbm_face_hlp(R(z + 1, y, xi), R(z - 1, y, xi), R(z, y + 1, xi),
                                   R(z, y - 1, xi));
    v = R(z, y, xs) + static_cast<float>(t) * hlp;
#undef R
  }
  out[i] = v;
}

// stage 1: y faces (z, x interior; y = 0 or Y-1), reading stage 0's output
__global__ void lbm_ca_y_faces(const uint8_t* __restrict__ flags, float* __restrict__ out, int Z,
                               int Y, int X, double t) {
  const long long per = static_cast<long long>(Z - 2) * (X - 2);
  const long long k = lbm_cell();
  if (k >= 2 * per) return;
  const int y = k < per ? 0 : Y - 1;
  const long long r = k % per;
  const int z = 1 + static_cast<int>(r / (X - 2));
  const int x = 1 + static_cast<int>(r % (X - 2));
  const long long i = lbm_index(z, y, x, Y, X);
  if (flags[i] != LBM_OBSTACLE) return;
  const int yi = y == 0 ? 1 : Y - 2;
  const int ys = y == 0 ? 2 : Y - 3;
#define R(zz, yy, xx) out[lbm_index(zz, yy, xx, Y, X)]
  const float hlp = lbm_face_hlp(R(z + 1, yi, x), R(z - 1, yi, x), R(z, yi, x + 1),
                                 R(z, yi, x - 1));
  out[i] = R(z, ys, x) + static_cast<float>(t) * hlp;
#undef R
}

// stage 2: z faces (y, x interior; z = 0 or Z-1): plain interior copies
__global__ void lbm_ca_z_faces(const uint8_t* __restrict__ flags, float* __restrict__ out, int Z,
                               int Y, int X) {
  const long long per = static_cast<long long>(Y - 2) * (X - 2);
  const long long k = lbm_cell();
  if (k >= 2 * per) return;
  const int z = k < per ? 0 : Z - 1;
  const long long r = k % per;
  const int y = 1 + static_cast<int>(r / (X - 2));
  const int x = 1 + static_cast<int>(r % (X - 2));
  const long long i = lbm_index(z, y, x, Y, X);
  if (flags[i] == LBM_OBSTACLE) out[i] = out[lbm_index(z == 0 ? 2 : Z - 3, y, x, Y, X)];
}

// stage 3: the 4 z-edge lines of each interior plane
__global__ void lbm_ca_z_lines(float* __restrict__ out, int Z, int Y, int X) {
  const long long k = lbm_cell();
  if (k >= 4LL * (Z - 2)) return;
  const int z = 1 + static_cast<int>(k >> 2);
  const int y = (k & 2) ? Y - 1 : 0, x = (k & 1) ? X - 1 : 0;
  const int yn = y == 0 ? 1 : Y - 2, xn = x == 0 ? 1 : X - 2;
  out[lbm_index(z, y, x, Y, X)] =
      0.5f * (out[lbm_index(z, y, xn, Y, X)] + out[lbm_index(z, yn, x, Y, X)]);
}

// stage 4: x-border lines (y interior) and y-border lines (x interior) of
// planes 0 and Z-1, each averaging its own plane's inward neighbour and
// the neighbour plane's face cell
__global__ void lbm_ca_plane_edges(float* __restrict__ out, int Z, int Y, int X) {
  const long long nx = 4LL * (Y - 2), ny = 4LL * (X - 2);
  const long long k = lbm_cell();
  if (k >= nx + ny) return;
  int z, y, x, yn, xn;
  if (k < nx) {
    const int side = static_cast<int>(k / (Y - 2));
    y = 1 + static_cast<int>(k % (Y - 2));
    z = (side & 2) ? Z - 1 : 0;
    x = (side & 1) ? X - 1 : 0;
    yn = y;
    xn = x == 0 ? 1 : X - 2;
  } else {
    const long long kk = k - nx;
    const int side = static_cast<int>(kk / (X - 2));
    x = 1 + static_cast<int>(kk % (X - 2));
    z = (side & 2) ? Z - 1 : 0;
    y = (side & 1) ? Y - 1 : 0;
    xn = x;
    yn = y == 0 ? 1 : Y - 2;
  }
  const int zn = z == 0 ? 1 : Z - 2;
  out[lbm_index(z, y, x, Y, X)] =
      0.5f * (out[lbm_index(z, yn, xn, Y, X)] + out[lbm_index(zn, y, x, Y, X)]);
}

// stage 5: the 8 corners, (x-neighbour + y-neighbour + z-neighbour) / 3
__global__ void lbm_ca_corners(float* __restrict__ out, int Z, int Y, int X) {
  const int k = static_cast<int>(lbm_cell());
  if (k >= 8) return;
  const int z = (k & 4) ? Z - 1 : 0, y = (k & 2) ? Y - 1 : 0, x = (k & 1) ? X - 1 : 0;
  const int zn = z == 0 ? 1 : Z - 2, yn = y == 0 ? 1 : Y - 2, xn = x == 0 ? 1 : X - 2;
  out[lbm_index(z, y, x, Y, X)] = (out[lbm_index(z, y, xn, Y, X)] +
                                   out[lbm_index(z, yn, x, Y, X)] +
                                   out[lbm_index(zn, y, x, Y, X)]) /
                                  3.0f;
}

extern "C" int lbm_contact_angle_stage(int stage, const float* rho, const uint8_t* flags,
                                       float* out, int Z, int Y, int X, double t, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long N = static_cast<long long>(Z) * Y * X;
  switch (stage) {
    case 0:
      lbm_ca_x_faces<<<lbm_blocks(N), LBM_THREADS, 0, st>>>(rho, flags, out, Z, Y, X, t);
      break;
    case 1:
      lbm_ca_y_faces<<<lbm_blocks(2LL * (Z - 2) * (X - 2)), LBM_THREADS, 0, st>>>(flags, out, Z,
                                                                                 Y, X, t);
      break;
    case 2:
      lbm_ca_z_faces<<<lbm_blocks(2LL * (Y - 2) * (X - 2)), LBM_THREADS, 0, st>>>(flags, out, Z,
                                                                                 Y, X);
      break;
    case 3:
      lbm_ca_z_lines<<<lbm_blocks(4LL * (Z - 2)), LBM_THREADS, 0, st>>>(out, Z, Y, X);
      break;
    case 4:
      lbm_ca_plane_edges<<<lbm_blocks(4LL * (Y - 2) + 4LL * (X - 2)), LBM_THREADS, 0, st>>>(
          out, Z, Y, X);
      break;
    case 5:
      lbm_ca_corners<<<1, 32, 0, st>>>(out, Z, Y, X);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
