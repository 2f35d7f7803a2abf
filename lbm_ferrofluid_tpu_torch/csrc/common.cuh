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
