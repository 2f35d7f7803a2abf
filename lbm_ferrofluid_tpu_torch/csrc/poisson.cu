// Channel-form magnetic Poisson sweeps: replaces the TPU kernel
// lbm_ferrofluid_tpu/ops/pallas/poisson.py:poisson_sweeps (:200,
// _sweep_kernel :120, arithmetic _sweep_math :69).  The TPU's temporally
// blocked variants (poisson_multisweep2 :700, poisson_multisweep :413) and
// its time-skewed wavefront with psi emission (poisson_wavefront :1301,
// _wavefront_kernel :866) compute the same sweeps, so this kernel serves
// them too.
//
// A sweep, at every cell (common.cuh:lbm_poisson_cell):
//   streamed_q = h_q(x - e_q), periodic wrap on every axis
//   psi        = f32(1/(1-w0)) * (streamed_1 + ... + streamed_18)
//                (summed before bounce-back, in ascending q)
//   obstacle:  out_q = streamed_opp(q)
//   otherwise: t = psi / tau, u = t + rhs,
//              out_q = (1 - 1/tau) streamed_q + w_q u, minus t at q = 0
// with the tau == 1 specialisation of _sweep_math (out_q = w_q u).
//
// Bound on an H100: a call (n sweeps) must read h (76 B), the flags (1 B)
// and rhs at non-obstacle cells (4 B), and write h' (76 B) and psi (4 B):
// 161 B per cell, 0.81 ms at 256^3 over 3.35 TB/s.  A sweep needs 39 flops
// per non-obstacle cell at tau == 1 and 78 otherwise: 0.29 / 0.59 ms at
// 67 TFLOP/s for 30 sweeps, so bytes bound it.  A launch per sweep streams
// the whole distribution through device memory once a sweep, 157 B per
// cell, and no tuning of such a launch gets under 0.79 ms a sweep at 256^3.
//
// lbm_poisson_pass runs k sweeps in one launch: the TPU's z-wavefront, its
// window in VMEM, rethought for a 227 KB SM (ops/kernels/poisson.py:plan):
//   - a block owns a TX x TY (x, y) tile and a chunk [z0, z1) of z.  It
//     holds the tile with its halo, an extended tile 32 cells wide (a warp
//     computes a row) and EY = TY + 2(k - 1) high, and walks the chunk's
//     window one plane a tick, reading planes with wrap.  TX is 32 - 2k
//     rounded down to a multiple of 8 (24 for k <= 4), so every tile
//     starts on a 32-byte sector and a block stores whole sectors: with
//     tiles 26 wide, neighbouring blocks wrote parts of one sector, and the
//     stores cost a third of the pass;
//   - stage j computes sweep j at plane t - j + 1 on rows [j - 1, EY - j +
//     1), one plane behind stage j - 1.  Stage 1 reads its 19 pulled
//     values from the input plane: for each channel q the grid plane it
//     pulls from (z + 1, z or z - 1 by e_z), rows -1..EY of the extended
//     tile, so its whole height is right and the tile needs k - 1 rows of
//     halo in y (k columns in x);
//   - the input plane arrives through registers: each warp loads one of
//     its EY + 2 rows, 19 channels, during the tick before, so device
//     memory streams while the stages compute (read inside stage 1, the
//     loads left every stage after it without a byte in flight; loading two
//     ticks ahead, or by 4-byte cp.async into shared memory, ran slower);
//   - each stage below k keeps its output in a ring of shared memory that
//     holds a channel only as long as the next stage reads it: the 5
//     channels with e_z = -1 for 1 plane (stage j + 1 reads them in the
//     tick they are made), the 9 with e_z = 0 for 2 and the 5 with e_z = +1
//     for 3, 38 floats a cell where three whole planes would take 57.  Its
//     channel planes are laid out as the input plane's, so every stage
//     reads a channel at a compile-time offset from one of three pointers;
//     Edge columns a stage computes from wrong neighbours are never read by
//     a valid cell;
//   - flags and rhs of the extended plane sit in (k + 1)-plane rings,
//     loaded through registers one tick ahead as well: nothing the next
//     tick's loads overwrite is read by stage k (for k >= 2), so stage k
//     ends without a barrier and its stores overlap the next tick's start;
//   - stage k writes h' (and, on the last pass, psi) of the tile, with
//     streaming (evict-first) stores, so they do not push the input's
//     halo rows, which neighbouring blocks read again, out of L2.
// The slab form (lbm_poisson_slab_kernel, the TPU wavefront's ghost-ref mode,
// poisson.py:881-888, for a z-slab of a domain decomposed along z) is the
// same walk over the slab's planes -k..Z + k - 1 without a wrap: the slab's
// own planes come from h, the G >= k planes a side from two band arrays,
// each read in place (no copy of the slab into an extended array), and the
// valid region shrinks a plane a sweep, so the k sweeps leave the real planes
// exact; stage k also writes the first and last G planes to the bands the
// next exchange sends.  Its bound adds the bands' reads and writes.
//
// The trailing stage (lbm_poisson_trail_kernel, the TPU wavefront's emit="hint"
// and emit="h2", poisson.py:1150-1162 and :1203-1266) takes the place of the
// psi store on the last pass of a call: psi never reaches device memory.  The
// block keeps the final sweep's psi and obstacle flag of its last three planes
// in a ring of shared memory and, one plane behind stage k, computes at each
// cell of the tile the field at the interior cell nearest to it (its source:
// x and y clamped to [1, X-2] and [1, Y-2], z to [zlo, zhi]), which is the TPU
// stage's boundary-ring replication of its output:
//   - the substituted psi of the source's 18 neighbours: at a magnetic
//     obstacle psi of the nearest interior cell, ring-replicated in x and y
//     and with z clamped to [zlo, zhi] (_ring_replicate_plane and the clamp
//     of the TPU's trailing stage), elsewhere psi itself;
//   - H_int_d = (the taps of _GRAD_TAPS[d], ops/pallas/stencil3d.py:47-57,
//     summed in that order) * f32(-1 / (12 dx));
//   - with h2, H2 = sum_d (H_int_d + h_ext_d)^2 in channel order, a zero h_ext
//     component not added;
// and writes H_int (3 channels) or H2 (1 channel).  The stage needs psi one
// cell past the tile: the pass takes the geometry of a pass of k + 1 sweeps
// (tiles lbm_pass_tx(k + 1) wide, ty + 2k rows extended, and a z walk one
// plane longer at each end of its chunk), and the last grid column and row
// are written by the tile that ends just before them where no tile starts
// there (the grid has ceil((X - 1) / tx) x ceil((Y - 1) / ty) tiles), so every
// source lies in its output's tile.  In z the stage at source plane zlo also
// writes plane zlo - 1 and at zhi plane zhi + 1 (ops/kernels/poisson.py:
// trail_pass keeps each in its source's chunk).  On one device [zlo, zhi] =
// [1, Z - 2]; the slab form clamps only at the domain's true edges (1 or -1,
// Zl - 2 or Zl), and reads psi of the planes either side of the slab, which
// its G >= k + 1 band planes keep exact after k sweeps.
//
// The trailing pass's block (PERF.md section 6 has the measurements, at
// 256^3 on an H100).  Its own work is small beside its geometry: with a warp
// per input row a pass of k + 1 sweeps at k = 3 on 9-row tiles has 17 warps,
// and ptxas then allots 96 registers a thread where a regular pass's 15
// warps get 128 (a regular pass on 17 warps is 19 % slower a cell).  So:
//   - a warp per row 0..EY - 1 of the extended tile, EY warps; the first
//     and the last also load the 5 channels stage 1 reads of halo rows -1
//     and EY (LbmTrailInput): 15 warps and 128 registers at k = 3;
//   - psi and the flags in rings of PP_TRAIL_SLOTS = 4 planes: the stage for
//     plane ps runs in the next tick, beside stage 1, on planes ps - 1..ps +
//     1 that stage k finished before that tick's barrier, while stage k
//     fills the fourth slot, so no barrier follows stage k.  Each tap loads
//     psi and the obstacle flag, and at an obstacle psi of its clamped cell.
// Slower than this in the same comparison, and not kept: a ring of psi
// substituted once a cell by stage k (the TPU kernel's select: stage k's
// extra work outweighed the flag loads saved), the stage on the warps that
// stage k or every stage leaves idle, a path without flags for blocks off
// the boundary, and 8-row tiles.
//
// Passes write out of place, so no input is overwritten during a pass; the
// k = 1 pass is the one-sweep kernel, and every pass computes each cell with
// lbm_poisson_cell, so every plan gives the same bits.  A pass of k = 3 at
// 256^3 takes about twice its trip through device memory (157 B a cell).
// What holds it there is not measured per instruction; the suspects: with
// one block an SM its loads, stages and stores overlap little, and every
// byte of the input, the rings and the stores crosses the SM's
// shared-memory and L1 path (PERF.md, section 7).
//
// In bfloat16 storage of h (T = __nv_bfloat16) the pass reads and writes h
// in bfloat16, and the input plane and the stage rings hold bfloat16 too:
// each stage below k stores its sweep's outputs rounded to bfloat16 (to
// nearest even), as the TPU wavefront keeps its stage rings in the storage
// dtype and as the one-sweep loop stores every sweep, so every plan gives
// the plain one-sweep loop's bits at bfloat16 as well.  Rings of float32
// values already rounded would give the same bits; bfloat16 rings halve the
// block's shared memory (97 KiB at k = 3 on 9-row tiles instead of 186 KiB),
// so shared memory leaves room for two blocks an SM where it left room for
// one (ops/kernels/poisson.py:smem_bytes and plan count the element size;
// whether registers allow two is what the card reports).  A call then must
// move 85 B per cell: 0.43 ms at 256^3.
//
// The pass body, with the trailing stage, is csrc/poisson_pass.cuh; the
// trailing stage's instances are csrc/poisson_trail.cu.
//
// Batch ([B, ...] states on one device): every pass (and the trailing
// pass, csrc/poisson_trail.cu) runs the B elements in one launch,
// gridDim.z = B nzb with nzb an element's z chunks (LBM_PASS_ELEM in
// csrc/poisson_pass.cuh); a block moves h, flags, rhs, out and psi (or
// H_int, H2) to its element, so its walk, its z wrap and its bits are
// those of a one-element pass under the same plan.  The plan stays an
// element's (ops/kernels/poisson.py:plan), B times the blocks.  These are
// instances of their own (BATCH), at the extended heights of plan's passes
// only (PP_BATCH_HEIGHTS): moving the pointers in the one-element kernel
// cost it 0.85 ms a call of 30 sweeps at 256^3 (15.75 -> 16.6 ms), the
// same registers, so a call of one element keeps its kernel as it was.
// The slab form takes one element.
#include "poisson_pass.cuh"

#define PP_MAX_K 4
// the extended heights EY = TY + 2(k - 1) the kernel is built for (a block
// has a warp per input row, EY + 2): those of ops/kernels/poisson.py:plan's
// passes (9, 11, 13) and of the plans chip_smoke.py --poisson-plans times
// (EXT_HEIGHTS there)
#define PP_EXT_HEIGHTS(M) M(5) M(7) M(8) M(9) M(10) M(11) M(12) M(13) M(14) M(15) M(18)
// the extended heights the slab form is built for: those of its passes of
// k = 1..PP_MAX_K sweeps (ops/kernels/poisson.py:SLAB_EXT_HEIGHTS, slab_plan)
#define PP_SLAB_HEIGHTS(M) M(9) M(11) M(13) M(15)
// the extended heights the batch instances are built for: those of plan's
// passes of k = 1..3 sweeps on 9-row tiles (ops/kernels/poisson.py:
// BATCH_EXT_HEIGHTS)
#define PP_BATCH_HEIGHTS(M) M(9) M(11) M(13)
// (as in poisson_pass.cuh: ops/kernels/poisson.py:SMEM_BLOCK_MAX)
#define PP_SMEM_MAX 232448

// BATCH: the instance of a batch of more than one element (LBM_PASS_ELEM)
template <class T, bool TAU1, int EY, bool BATCH>
__global__ void __launch_bounds__(PP_EX*(EY + 2), 1) lbm_poisson_pass_kernel(
    const T* __restrict__ h, const uint8_t* __restrict__ flags, const float* __restrict__ rhs,
    T* __restrict__ out, float* __restrict__ psi_out, int Z, int Y, int X, int k, int LZ,
    float inv_tau, float a) {
  if constexpr (BATCH) {
    LBM_PASS_ELEM(1)
    lbm_poisson_pass_body<T, TAU1, EY, false, false>(h, flags, rhs, out, psi_out, Z, Y, X, k,
                                                     LZ, inv_tau, a, nullptr, nullptr, 0,
                                                     nullptr, nullptr, LbmTrail{}, zblk);
  } else {
    lbm_poisson_pass_body<T, TAU1, EY, false, false>(h, flags, rhs, out, psi_out, Z, Y, X, k,
                                                     LZ, inv_tau, a, nullptr, nullptr, 0,
                                                     nullptr, nullptr, LbmTrail{}, blockIdx.z);
  }
}

template <class T, bool TAU1, int EY>
__global__ void __launch_bounds__(PP_EX*(EY + 2), 1) lbm_poisson_slab_kernel(
    const T* __restrict__ h, const uint8_t* __restrict__ flags, const float* __restrict__ rhs,
    T* __restrict__ out, float* __restrict__ psi_out, int Z, int Y, int X, int k, int LZ,
    float inv_tau, float a, const T* __restrict__ glo, const T* __restrict__ ghi, int G,
    T* __restrict__ blo, T* __restrict__ bhi) {
  lbm_poisson_pass_body<T, TAU1, EY, true, false>(h, flags, rhs, out, psi_out, Z, Y, X, k, LZ,
                                                  inv_tau, a, glo, ghi, G, blo, bhi,
                                                  LbmTrail{}, blockIdx.z);
}

// One instance of the pass kernel (SLAB the slab form, BATCH the batch
// instance): lets it take PP_SMEM_MAX bytes of dynamic shared memory on the
// current device (one attribute call a device), then launches it (stream
// non-null) or reports its resident blocks an SM (blocks non-null).
template <class T, bool TAU1, int EY, bool SLAB, bool BATCH = false>
static cudaError_t lbm_poisson_pass_instance(const LbmPassArgs& g, cudaStream_t stream,
                                             int* blocks) {
  static bool allowed[PP_MAX_DEVICES] = {};
  const void* kernel;
  if constexpr (SLAB)
    kernel = reinterpret_cast<const void*>(lbm_poisson_slab_kernel<T, TAU1, EY>);
  else
    kernel = reinterpret_cast<const void*>(lbm_poisson_pass_kernel<T, TAU1, EY, BATCH>);
  cudaError_t err = lbm_pass_allow_smem(kernel, allowed);
  if (err != cudaSuccess) return err;
  const int smem = lbm_poisson_pass_smem(g.k, EY, sizeof(T), false), threads = PP_EX * (EY + 2);
  if (blocks != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
  const int TX = lbm_pass_tx(g.k);
  const dim3 grid((g.X + TX - 1) / TX, (g.Y + g.TY - 1) / g.TY,
                  g.B * ((g.Z + g.LZ - 1) / g.LZ));
  if constexpr (SLAB)
    lbm_poisson_slab_kernel<T, TAU1, EY><<<grid, threads, smem, stream>>>(
        static_cast<const T*>(g.h), g.flags, g.rhs, static_cast<T*>(g.out), g.psi_out, g.Z,
        g.Y, g.X, g.k, g.LZ, g.inv_tau, g.a, static_cast<const T*>(g.glo),
        static_cast<const T*>(g.ghi), g.G, static_cast<T*>(g.blo), static_cast<T*>(g.bhi));
  else
    lbm_poisson_pass_kernel<T, TAU1, EY, BATCH><<<grid, threads, smem, stream>>>(
        static_cast<const T*>(g.h), g.flags, g.rhs, static_cast<T*>(g.out), g.psi_out, g.Z,
        g.Y, g.X, g.k, g.LZ, g.inv_tau, g.a);
  return cudaGetLastError();
}

template <class T, bool TAU1>
static cudaError_t lbm_poisson_pass_dispatch(const LbmPassArgs& g, cudaStream_t stream,
                                             int* blocks) {
  const int ey = g.TY + 2 * (g.k - 1);
  if (g.glo != nullptr) {
    switch (ey) {
#define PP_CASE(E) \
  case E:          \
    return lbm_poisson_pass_instance<T, TAU1, E, true>(g, stream, blocks);
      PP_SLAB_HEIGHTS(PP_CASE)
#undef PP_CASE
    }
    return cudaErrorInvalidValue;
  }
  if (g.B > 1) {
    switch (ey) {
#define PP_CASE(E) \
  case E:          \
    return lbm_poisson_pass_instance<T, TAU1, E, false, true>(g, stream, blocks);
      PP_BATCH_HEIGHTS(PP_CASE)
#undef PP_CASE
    }
    return cudaErrorInvalidValue;
  }
  switch (ey) {
#define PP_CASE(E) \
  case E:          \
    return lbm_poisson_pass_instance<T, TAU1, E, false>(g, stream, blocks);
    PP_EXT_HEIGHTS(PP_CASE)
#undef PP_CASE
  }
  return cudaErrorInvalidValue;
}

template <class T>
static cudaError_t lbm_poisson_pass_run(const LbmPassArgs& g, double tau, cudaStream_t stream,
                                        int* blocks) {
  return 1.0 / tau == 1.0 ? lbm_poisson_pass_dispatch<T, true>(g, stream, blocks)
                          : lbm_poisson_pass_dispatch<T, false>(g, stream, blocks);
}

#ifdef PP_BF16_PART
cudaError_t lbm_poisson_pass_bf16(const LbmPassArgs& g, double tau, cudaStream_t stream,
                                  int* blocks) {
  return lbm_poisson_pass_run<__nv_bfloat16>(g, tau, stream, blocks);
}
#else
static cudaError_t lbm_poisson_pass_any(const LbmPassArgs& g, double tau, int bf16,
                                        cudaStream_t stream, int* blocks) {
  const bool trail = g.trail != 0;
  if (g.k < 1 || g.k > PP_MAX_K || g.TY < 1 || g.LZ < 1 || g.B < 1 ||
      static_cast<long long>(g.B) * ((g.Z + g.LZ - 1) / g.LZ) > 65535 ||
      (g.glo != nullptr && g.B != 1))
    return cudaErrorInvalidValue;
  if (g.glo != nullptr && (g.ghi == nullptr || g.k + trail > g.G || g.G > g.Z))
    return cudaErrorInvalidValue;
  if (lbm_poisson_pass_smem(g.k, g.TY + 2 * (g.k - 1) + 2 * trail, bf16 ? 2 : 4, trail) >
      PP_SMEM_MAX)
    return cudaErrorInvalidValue;
  if (trail) return lbm_poisson_trail_run(g, tau, bf16, stream, blocks);
  return bf16 ? lbm_poisson_pass_bf16(g, tau, stream, blocks)
              : lbm_poisson_pass_run<float>(g, tau, stream, blocks);
}

// k sweeps on h -> out (sweep k) and, unless null, psi_out (psi of sweep
// k), on tiles lbm_pass_tx(k) x TY and z chunks of LZ planes, with a warp per
// row of the extended tile and its two halo rows; 1 <= k <= PP_MAX_K,
// TY + 2(k - 1) one of PP_EXT_HEIGHTS, and the block's shared memory within
// PP_SMEM_MAX (cudaErrorInvalidValue otherwise).  h and out in float32, or
// in bfloat16 where bf16 is nonzero; psi_out in float32.
//
// The slab form (glo not null): h holds the Z real planes of a z-slab,
// glo and ghi the G planes of the neighbours below and above ([19, G, Y, X]
// each, read in place), and flags and rhs the Z + 2G planes of the slab
// extended by G a side; k <= G <= Z.  The walk covers planes -k..Z + k - 1
// without a wrap, so the real planes are exact after the k sweeps (the
// valid region shrinks a plane a sweep), and only they are written; blo and
// bhi, unless null, take the first and the last G planes of out again, the
// bands the next exchange sends.
//
// trail (1: H_int, 2: H2): the trailing stage writes H_int [3, Z, Y, X]
// (or H2 [1, Z, Y, X]) to psi_out, float32, in place of psi, with the
// gradient's and the substitution's z clamp [zlo, zhi] (1 <= zlo <= zhi <=
// Z - 2 on one device; on a slab 1 or -1 and Z - 2 or Z), dx, and for H2
// the constant field (hx, hy, hz); k <= PP_TRAIL_MAX_K, TY + 2k one of
// PP_TRAIL_HEIGHTS, Y, X >= 3, G >= k + 1 on a slab, no bands, and LZ such
// that the chunk holding plane zlo - 1 (zhi + 1) holds zlo (zhi).
extern "C" int lbm_poisson_pass(const void* h, const uint8_t* flags, const float* rhs,
                                void* out, float* psi_out, int B, int Z, int Y, int X, int k,
                                int TY, int LZ, double tau, int bf16, const void* glo,
                                const void* ghi, int G, void* blo, void* bhi, int trail, int zlo,
                                int zhi, double dx, double hx, double hy, double hz,
                                void* stream) {
  const double inv_tau = 1.0 / tau;
  const LbmTrail tr{trail == 2, zlo, zhi, static_cast<float>(-1.0 / (12.0 * dx)),
                    {static_cast<float>(hx), static_cast<float>(hy), static_cast<float>(hz)},
                    {hx != 0.0, hy != 0.0, hz != 0.0}};
  const LbmPassArgs g{h, flags, rhs, out, psi_out, B, Z, Y, X, k, TY, LZ,
                      static_cast<float>(inv_tau), static_cast<float>(1.0 - inv_tau),
                      glo, ghi, glo != nullptr ? G : 0, blo, bhi, trail, tr};
  if (trail && psi_out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      lbm_poisson_pass_any(g, tau, bf16, static_cast<cudaStream_t>(stream), nullptr);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// Blocks of lbm_poisson_pass_kernel (the tau == 1 form unless tau1 is 0,
// the bfloat16 instance where bf16 is nonzero, lbm_poisson_trail_kernel on
// one device where trail is nonzero) resident on one SM at a plan's k and
// TY (for reports).
extern "C" int lbm_poisson_pass_occupancy(int k, int TY, int tau1, int bf16, int trail,
                                          int* blocks) {
  const LbmPassArgs g{nullptr, nullptr, nullptr, nullptr, nullptr, 1, 3, 3, 3, k, TY, 1, 1.f,
                      0.f, nullptr, nullptr, 0, nullptr, nullptr, trail, LbmTrail{0, 1, 1}};
  return static_cast<int>(lbm_poisson_pass_any(g, tau1 ? 1.0 : 0.5, bf16, nullptr, blocks));
}
#endif  // PP_BF16_PART
