// Stream + bounce of one distribution: replaces the TPU kernels
// lbm_ferrofluid_tpu/ops/pallas/stream3d.py:stream_bounce_moments (:164,
// _kernel :126) and stream_bounce_macro (:231, _macro_kernel :83).
//
// One thread per cell pulls its 19 values with periodic wrap on every axis
// (the TPU kernel wraps z through its BlockSpec index maps and y, x with
// pltpu.roll), bounces them at obstacles (common.cuh's lbm_pull_at, as
// the prologue does), writes them (the TPU kernels' out_ref) and then
//   lbm_stream_moments3d: the raw moments m0 = sum_q f_q, m1 = sum_q f_q e_q;
//   lbm_stream_macro3d:   rho = m0 and vel = m1 c / rho (both frozen at
//                         obstacles to rho_old, vel_old) and density(rho).
// Two entry points, as the JAX package calls them separately.
//
// Bound on an H100: bytes.  Per cell, read f (76 B) and flags (1 B) and
// write f_post (76 B) and the moments (16 B): 169 B; the macro kernel also
// reads rho_old and vel_old at obstacles (16 B there) and writes density
// (4 B): 173 B.  At 256^3 that is about 0.85 and 0.87 ms over 3.35 TB/s;
// ~50 flops per cell are far below the float32 rate.  The pulls of
// neighbouring threads are neighbouring addresses within each channel, so
// reads and writes coalesce.  In bfloat16 storage (T = __nv_bfloat16) f
// and f_post take 38 B a cell each: 93 B and 97 B per cell, 0.47 and
// 0.49 ms at 256^3.  The streamed values are permuted, not rounded, so
// f_post holds the same bfloat16 bits as the input.
//
// Slab forms (the TPU kernels' up_ghost/dn_ghost, stream3d.py:46-80, for a
// z-slab of a domain decomposed along z over ranks): plane 0 pulls its z-1
// channels (9-13) from the neighbour's plane lo and plane Z-1 its z+1
// channels (14-18) from hi, 5 channels of one plane a side, instead of the
// wrap (common.cuh:lbm_pull_slab, as B4's slab form pulls).  Everything else
// is the same, so a slab's outputs equal those of the same planes of the
// whole domain bit for bit.  Their bound adds the ghost planes' 2 x 5 values
// a plane cell.
//
// Batch ([B, ...] states on one device): one launch for the B elements, a
// row of lbm_blocks(N) blocks an element on gridDim.y.  Each block moves
// its fields' pointers to its element (common.cuh:lbm_elem) before it
// pulls, so the periodic wrap stays within the element and a batched
// call's bits are those of B calls on one element each.  The bound is B
// times an element's.  The slab forms take one element.
#include "common.cuh"

// The 19 pulled and bounced values of cell i at (z, y, x): across the
// slab's faces from lo and hi where SLAB, else with the periodic wrap.
template <class T, bool SLAB>
__device__ __forceinline__ void lbm_stream_pull(const T* __restrict__ f, const T* __restrict__ lo,
                                                const T* __restrict__ hi, long long N, long long i,
                                                int z, int y, int x, int Z, int Y, int X,
                                                bool obs, float post[19]) {
  const LbmPullOffsets po = lbm_pull_offsets(z, y, x, Z, Y, X);
  if (SLAB)
    lbm_pull_slab(f, lo, hi, N, static_cast<long long>(Y) * X, i, z, Z, po, obs, post);
  else
    lbm_pull_at(f, N, i, po, obs, post);
}

template <class T, bool SLAB>
__global__ void lbm_stream_moments3d_kernel(const T* __restrict__ f,
                                            const uint8_t* __restrict__ flags,
                                            T* __restrict__ f_post, float* __restrict__ m0,
                                            float* __restrict__ m1, int Z, int Y, int X,
                                            const T* __restrict__ lo, const T* __restrict__ hi) {
  const long long N = static_cast<long long>(Z) * Y * X;
  const long long i = lbm_cell();
  if (i >= N) return;
  const long long b = blockIdx.y;  // the batch element
  f = lbm_elem(f, b, 19, N), flags = lbm_elem(flags, b, 1, N);
  f_post = lbm_elem(f_post, b, 19, N), m0 = lbm_elem(m0, b, 1, N), m1 = lbm_elem(m1, b, 3, N);
  const int x = static_cast<int>(i % X);
  const int y = static_cast<int>((i / X) % Y);
  const int z = static_cast<int>(i / (static_cast<long long>(X) * Y));
  float post[19];
  lbm_stream_pull<T, SLAB>(f, lo, hi, N, i, z, y, x, Z, Y, X, flags[i] == LBM_OBSTACLE, post);
#pragma unroll
  for (int q = 0; q < 19; ++q) lbm_st(f_post + q * N + i, post[q]);
  float s, m[3];
  lbm_moments(post, s, m);
  m0[i] = s;
#pragma unroll
  for (int d = 0; d < 3; ++d) m1[d * N + i] = m[d];
}

template <class T, bool SLAB>
__global__ void lbm_stream_macro3d_kernel(const T* __restrict__ f,
                                          const uint8_t* __restrict__ flags,
                                          const float* __restrict__ rho_old,
                                          const float* __restrict__ vel_old,
                                          T* __restrict__ f_post, float* __restrict__ rho,
                                          float* __restrict__ vel, float* __restrict__ den, int Z,
                                          int Y, int X, double c, LbmGas gas,
                                          const T* __restrict__ lo, const T* __restrict__ hi) {
  const long long N = static_cast<long long>(Z) * Y * X;
  const long long i = lbm_cell();
  if (i >= N) return;
  const long long b = blockIdx.y;  // the batch element
  f = lbm_elem(f, b, 19, N), flags = lbm_elem(flags, b, 1, N);
  rho_old = lbm_elem(rho_old, b, 1, N), vel_old = lbm_elem(vel_old, b, 3, N);
  f_post = lbm_elem(f_post, b, 19, N), rho = lbm_elem(rho, b, 1, N);
  vel = lbm_elem(vel, b, 3, N), den = lbm_elem(den, b, 1, N);
  const int x = static_cast<int>(i % X);
  const int y = static_cast<int>((i / X) % Y);
  const int z = static_cast<int>(i / (static_cast<long long>(X) * Y));
  const bool obs = flags[i] == LBM_OBSTACLE;
  float post[19];
  lbm_stream_pull<T, SLAB>(f, lo, hi, N, i, z, y, x, Z, Y, X, obs, post);
#pragma unroll
  for (int q = 0; q < 19; ++q) lbm_st(f_post + q * N + i, post[q]);
  float m0, m1[3];
  lbm_moments(post, m0, m1);
  const float r = obs ? rho_old[i] : m0;
  const float inv_rho = static_cast<float>(c) / r;
  rho[i] = r;
#pragma unroll
  for (int d = 0; d < 3; ++d) vel[d * N + i] = obs ? vel_old[d * N + i] : m1[d] * inv_rho;
  den[i] = lbm_density_of(r, gas);
}

template <class T>
static void lbm_stream_moments3d_launch(const void* f, const uint8_t* flags, void* f_post,
                                        float* m0, float* m1, int B, int Z, int Y, int X,
                                        const void* lo, const void* hi, cudaStream_t stream) {
  const long long N = static_cast<long long>(Z) * Y * X;
  const T *tlo = static_cast<const T*>(lo), *thi = static_cast<const T*>(hi);
  if (lo != nullptr)
    lbm_stream_moments3d_kernel<T, true><<<dim3(lbm_blocks(N), B), LBM_THREADS, 0, stream>>>(
        static_cast<const T*>(f), flags, static_cast<T*>(f_post), m0, m1, Z, Y, X, tlo, thi);
  else
    lbm_stream_moments3d_kernel<T, false><<<dim3(lbm_blocks(N), B), LBM_THREADS, 0, stream>>>(
        static_cast<const T*>(f), flags, static_cast<T*>(f_post), m0, m1, Z, Y, X, tlo, thi);
}

// f and f_post in float32, or in bfloat16 where bf16 is nonzero; lo and hi
// (5 channels of one plane each, f's type) give the slab form, null the
// whole domain's
extern "C" int lbm_stream_moments3d(const void* f, const uint8_t* flags, void* f_post, float* m0,
                                    float* m1, int B, int Z, int Y, int X, int bf16,
                                    const void* lo, const void* hi, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((lo == nullptr) != (hi == nullptr) || B < 1 || B > 65535 || (lo != nullptr && B != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    lbm_stream_moments3d_launch<__nv_bfloat16>(f, flags, f_post, m0, m1, B, Z, Y, X, lo, hi, st);
  else
    lbm_stream_moments3d_launch<float>(f, flags, f_post, m0, m1, B, Z, Y, X, lo, hi, st);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
static void lbm_stream_macro3d_launch(const void* f, const uint8_t* flags, const float* rho_old,
                                      const float* vel_old, void* f_post, float* rho, float* vel,
                                      float* den, int B, int Z, int Y, int X, double c,
                                      LbmGas gas, const void* lo, const void* hi,
                                      cudaStream_t stream) {
  const long long N = static_cast<long long>(Z) * Y * X;
  const T *tlo = static_cast<const T*>(lo), *thi = static_cast<const T*>(hi);
  if (lo != nullptr)
    lbm_stream_macro3d_kernel<T, true><<<dim3(lbm_blocks(N), B), LBM_THREADS, 0, stream>>>(
        static_cast<const T*>(f), flags, rho_old, vel_old, static_cast<T*>(f_post), rho, vel,
        den, Z, Y, X, c, gas, tlo, thi);
  else
    lbm_stream_macro3d_kernel<T, false><<<dim3(lbm_blocks(N), B), LBM_THREADS, 0, stream>>>(
        static_cast<const T*>(f), flags, rho_old, vel_old, static_cast<T*>(f_post), rho, vel,
        den, Z, Y, X, c, gas, tlo, thi);
}

// f and f_post in float32, or in bfloat16 where bf16 is nonzero; lo and hi
// (5 channels of one plane each, f's type) give the slab form, null the
// whole domain's
extern "C" int lbm_stream_macro3d(const void* f, const uint8_t* flags, const float* rho_old,
                                  const float* vel_old, void* f_post, float* rho, float* vel,
                                  float* den, int B, int Z, int Y, int X, double c,
                                  double rho_gas, double rho_fluid, double den_gas,
                                  double den_fluid, int bf16, const void* lo, const void* hi,
                                  void* stream) {
  const LbmGas gas = lbm_gas(rho_gas, rho_fluid, den_gas, den_fluid);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((lo == nullptr) != (hi == nullptr) || B < 1 || B > 65535 || (lo != nullptr && B != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    lbm_stream_macro3d_launch<__nv_bfloat16>(f, flags, rho_old, vel_old, f_post, rho, vel, den,
                                             B, Z, Y, X, c, gas, lo, hi, st);
  else
    lbm_stream_macro3d_launch<float>(f, flags, rho_old, vel_old, f_post, rho, vel, den, B, Z, Y,
                                     X, c, gas, lo, hi, st);
  return static_cast<int>(cudaGetLastError());
}
