// B7's trailing stage (emit="hint" and emit="h2") in the last pass of B11b's
// channel-form Poisson sweeps: the instances of that pass, on one device and
// in the slab form, and their dispatch.  The design is in csrc/poisson.cu's
// header comment; ops/kernels/poisson.py:trail_pass plans the pass.
#include "poisson_pass.cuh"

// the extended heights ty + 2k the trailing stage's pass is built for, on one
// device and on a slab: k = 1..PP_TRAIL_MAX_K on ty = 9 rows
// (ops/kernels/poisson.py:TRAIL_EXT_HEIGHTS, trail_pass)
#define PP_TRAIL_HEIGHTS(M) M(11) M(13) M(15)
#define PP_TRAIL_MAX_K 3

// The last pass with the trailing stage, on one device or (SLAB) on a slab;
// BATCH: on one device, a batch of more than one element (its own
// instance, as csrc/poisson.cu's batch instances of the pass).  A warp per
// row of the extended tile, EY: at EY = 15, 15 warps fit 128 registers a
// thread where 17 got 96 (4 warps a quarter of the SM's register file).
template <class T, bool TAU1, int EY, bool SLAB, bool BATCH>
__global__ void __launch_bounds__(PP_EX * EY, 1) lbm_poisson_trail_kernel(
    const T* __restrict__ h, const uint8_t* __restrict__ flags, const float* __restrict__ rhs,
    T* __restrict__ out, float* __restrict__ psi_out, int Z, int Y, int X, int k, int LZ,
    float inv_tau, float a, const T* __restrict__ glo, const T* __restrict__ ghi, int G,
    LbmTrail tr) {
  if constexpr (BATCH) {
    // the block's batch element (H2 one channel, H_int three)
    LBM_PASS_ELEM(tr.h2 ? 1 : 3)
    lbm_poisson_pass_body<T, TAU1, EY, SLAB, true>(h, flags, rhs, out, psi_out, Z, Y, X, k, LZ,
                                                   inv_tau, a, glo, ghi, G, nullptr, nullptr,
                                                   tr, zblk);
  } else {
    lbm_poisson_pass_body<T, TAU1, EY, SLAB, true>(h, flags, rhs, out, psi_out, Z, Y, X, k, LZ,
                                                   inv_tau, a, glo, ghi, G, nullptr, nullptr,
                                                   tr, blockIdx.z);
  }
}

template <class T, bool TAU1, int EY, bool SLAB, bool BATCH>
static cudaError_t lbm_poisson_trail_instance(const LbmPassArgs& g, cudaStream_t stream,
                                              int* blocks) {
  static bool allowed[PP_MAX_DEVICES] = {};
  const void* kernel =
      reinterpret_cast<const void*>(lbm_poisson_trail_kernel<T, TAU1, EY, SLAB, BATCH>);
  cudaError_t err = lbm_pass_allow_smem(kernel, allowed);
  if (err != cudaSuccess) return err;
  const int smem = lbm_poisson_pass_smem(g.k, EY, sizeof(T), true), threads = PP_EX * EY;
  if (blocks != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
  // the last column and row go with the tile before them (tiles over X - 1
  // and Y - 1 cells)
  const int TX = lbm_pass_tx(g.k + 1);
  const dim3 grid((g.X - 1 + TX - 1) / TX, (g.Y - 1 + g.TY - 1) / g.TY,
                  g.B * ((g.Z + g.LZ - 1) / g.LZ));
  lbm_poisson_trail_kernel<T, TAU1, EY, SLAB, BATCH><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(g.h), g.flags, g.rhs, static_cast<T*>(g.out), g.psi_out, g.Z, g.Y,
      g.X, g.k, g.LZ, g.inv_tau, g.a, static_cast<const T*>(g.glo),
      static_cast<const T*>(g.ghi), g.G, g.tr);
  return cudaGetLastError();
}

template <class T, bool TAU1, bool SLAB, bool BATCH>
static cudaError_t lbm_poisson_trail_dispatch(const LbmPassArgs& g, cudaStream_t stream,
                                              int* blocks) {
  switch (g.TY + 2 * g.k) {
#define PP_CASE(E) \
  case E:          \
    return lbm_poisson_trail_instance<T, TAU1, E, SLAB, BATCH>(g, stream, blocks);
    PP_TRAIL_HEIGHTS(PP_CASE)
#undef PP_CASE
  }
  return cudaErrorInvalidValue;
}

template <class T, bool TAU1>
static cudaError_t lbm_poisson_trail_form(const LbmPassArgs& g, cudaStream_t stream,
                                          int* blocks) {
  if (g.glo != nullptr) return lbm_poisson_trail_dispatch<T, TAU1, true, false>(g, stream, blocks);
  return g.B > 1 ? lbm_poisson_trail_dispatch<T, TAU1, false, true>(g, stream, blocks)
                 : lbm_poisson_trail_dispatch<T, TAU1, false, false>(g, stream, blocks);
}

#ifdef PP_BF16_PART
cudaError_t lbm_poisson_trail_bf16(const LbmPassArgs& g, bool tau1, cudaStream_t stream,
                                   int* blocks) {
  return tau1 ? lbm_poisson_trail_form<__nv_bfloat16, true>(g, stream, blocks)
              : lbm_poisson_trail_form<__nv_bfloat16, false>(g, stream, blocks);
}
#else
cudaError_t lbm_poisson_trail_run(const LbmPassArgs& g, double tau, int bf16,
                                  cudaStream_t stream, int* blocks) {
  if (g.k > PP_TRAIL_MAX_K || g.Y < 3 || g.X < 3 || g.tr.zlo > g.tr.zhi || g.blo != nullptr ||
      g.bhi != nullptr)
    return cudaErrorInvalidValue;
  const bool tau1 = 1.0 / tau == 1.0;
  if (bf16) return lbm_poisson_trail_bf16(g, tau1, stream, blocks);
  return tau1 ? lbm_poisson_trail_form<float, true>(g, stream, blocks)
              : lbm_poisson_trail_form<float, false>(g, stream, blocks);
}
#endif  // PP_BF16_PART
