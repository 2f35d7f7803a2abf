// The psi-refreshed ghost band of the meshed channel-form solve at tau == 1:
// replaces jnp glue, not a Pallas kernel, the reconstruction and splice of
// lbm_ferrofluid_tpu/parallel/step3d.py:_psi_ghost_bands (recon and splice
// :959-1011; :872-930 in the extended flow's _psi_refresh_ghosts).
//
// At tau == 1 a swept non-obstacle cell stores h_q = w_q (psi + rhs), minus
// psi at q = 0 (common.cuh:lbm_poisson_out), a function of its psi and its
// source alone.  So the rounds after the first of the meshed solve
// (parallel/step3d.py:poisson_sweeps_sharded) need not receive the
// neighbour's G 19-channel band planes: they receive its innermost plane of
// h, the G - 1 outer planes' psi, and those planes' two x-edge columns of h,
// where the magnetic obstacles of the declared shell sit (mag_flags_shell:
// obstacles only in the x-edge columns and the z-edge planes; G < Zl keeps
// a z-edge plane out of the outer planes).  This kernel writes the band
// [19, G, Y, X] in h's storage type: the innermost plane copied, the edge
// columns copied, every other value rebuilt through lbm_poisson_out<true>
// with B11b's rounding (each operation rounded on its own, then lbm_st),
// so the band equals the neighbour's stored planes bit for bit.  A lo band
// (from the rank below) has its innermost plane last, a hi band first.
//
// One thread a cell of the band, its 19 channels; one element (the slab
// forms step one element a rank).  Bound on an H100: bytes, the four inputs
// read once and the band written once.
#include "common.cuh"

template <class T>
__global__ void __launch_bounds__(LBM_THREADS) lbm_psi_ghost_band_kernel(
    const float* __restrict__ psi, const float* __restrict__ rhs, const T* __restrict__ inner,
    const T* __restrict__ cols, T* __restrict__ band, int G, int Y, int X, int hi) {
  const long long P = static_cast<long long>(Y) * X;
  const long long GP = G * P;
  const long long i = lbm_cell();
  if (i >= GP) return;
  const int j = static_cast<int>(i / P);
  const long long p = i - j * P;
  if (j == (hi ? 0 : G - 1)) {
#pragma unroll
    for (int q = 0; q < 19; ++q) band[q * GP + i] = inner[q * P + p];
    return;
  }
  const int o = hi ? j - 1 : j;  // the plane's index among the G - 1 outer planes
  const int x = static_cast<int>(p % X);
  if (x == 0 || x == X - 1) {
    const long long CN = 2LL * (G - 1) * Y;  // one channel's column values
    const long long c = (static_cast<long long>(o) * Y + p / X) * 2 + (x != 0);
#pragma unroll
    for (int q = 0; q < 19; ++q) band[q * GP + i] = cols[q * CN + c];
    return;
  }
  const float t = psi[o * P + p];
  const float u = __fadd_rn(t, rhs[o * P + p]);
#pragma unroll
  for (int q = 0; q < 19; ++q) lbm_st(band + q * GP + i, lbm_poisson_out<true>(q, t, u, 0.f, 0.f));
}

template <class T>
static void lbm_psi_ghost_band_launch(const float* psi, const float* rhs, const void* inner,
                                      const void* cols, void* band, int G, int Y, int X, int hi,
                                      cudaStream_t stream) {
  const long long n = static_cast<long long>(G) * Y * X;
  lbm_psi_ghost_band_kernel<T><<<lbm_blocks(n), LBM_THREADS, 0, stream>>>(
      psi, rhs, static_cast<const T*>(inner), static_cast<const T*>(cols), static_cast<T*>(band),
      G, Y, X, hi);
}

// psi, rhs: [G - 1, Y, X] float32; inner: [19, Y, X]; cols: [19, G - 1, Y,
// 2] (x = 0, X - 1); band: [19, G, Y, X]; inner, cols and band in float32,
// or in bfloat16 where bf16 is nonzero; hi: the band above the slab
extern "C" int lbm_psi_ghost_band(const float* psi, const float* rhs, const void* inner,
                                  const void* cols, void* band, int G, int Y, int X, int hi,
                                  int bf16, void* stream) {
  if (G < 2 || Y < 1 || X < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    lbm_psi_ghost_band_launch<__nv_bfloat16>(psi, rhs, inner, cols, band, G, Y, X, hi, st);
  else
    lbm_psi_ghost_band_launch<float>(psi, rhs, inner, cols, band, G, Y, X, hi, st);
  return static_cast<int>(cudaGetLastError());
}
