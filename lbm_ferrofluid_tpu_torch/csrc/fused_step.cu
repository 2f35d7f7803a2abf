// Prologue and epilogue kernels.  The epilogue (B5) is described above its
// kernels below.
//
// Prologue: replaces the TPU kernel
// lbm_ferrofluid_tpu/ops/pallas/fused_step.py:lbm_prologue (:721,
// _prologue_kernel :188).  The capillogue's emission (capillogue.cu, step
// (c)) and the epilogue's (emit_mac) launch the same entry point on the
// collided f'/g'.
//
// One thread per cell pulls its 19 + 19 f and g values (periodic wrap on
// every axis: channels 9-13 come from z-1, 14-18 from z+1), bounces them
// at obstacles, and writes only the macro fields: rho (frozen at
// obstacles), vel = m1f * c / rho (frozen at obstacles), density(rho),
// m0g, m1g.  The post-stream distributions never reach device memory.
//
// Bound on an H100: bytes.  Per cell it must read f and g (76 B each) and
// flags (1 B), rho_old and vel_old only at obstacle cells (16 B there), and
// write 9 float channels (36 B): 189 B per cell plus 16 B per obstacle
// cell, 0.948 ms at 256^3 (2.3 % obstacles) over 3.35 TB/s; about 100 flops
// per cell is far below the float32 rate.  The pulls of neighbouring
// threads are neighbouring addresses within each channel, so the reads
// coalesce; the z+-1 and y+-1 planes are re-read by other blocks from L2.
// In bfloat16 storage (T = __nv_bfloat16) f and g take 38 B a cell each:
// 113 B per cell plus 16 B per obstacle cell, 0.57 ms at 256^3.
//
// Slab form (the TPU kernel's ghosts=, fused_step.py:26-31, for a z-slab of
// a domain decomposed along z over ranks): plane 0 pulls its z-1 channels
// (9-13) and plane Z-1 its z+1 channels (14-18) from the neighbours' edge
// planes instead of the wrap (common.cuh:lbm_pull_slab), 5 channels of one
// plane a side.  Everything else is the same, so a slab's outputs equal
// those of the same planes of the whole domain bit for bit.  Its bound adds
// the ghost planes' 2 x 5 values a plane cell of f and of g.
//
// Batch ([B, ...] states on one device): each kernel here steps the B
// elements in one launch, B4 and B5's cell form with a row of blocks an
// element on gridDim.y, B5's stage form with an element on gridDim.z
// (its blocks along y are an element's strips, as at B = 1).  A block
// moves its fields' pointers to its element (common.cuh:lbm_elem), so no
// pull crosses from one element to the next; the emission (emit_mac)
// launches B4 on the whole batch.  The slab forms take one element.
#include "common.cuh"

extern "C" const char* lbm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// SLAB: the slab form, whose z-1 pulls of plane 0 and z+1 pulls of plane
// Z-1 read the ghost planes f_lo/f_hi and g_lo/g_hi ([5, Y, X] each).
template <class T, bool SLAB>
__global__ void lbm_stream_macro_kernel(const T* __restrict__ f, const T* __restrict__ g,
                                        const uint8_t* __restrict__ flags,
                                        const float* __restrict__ rho_old,
                                        const float* __restrict__ vel_old, float* __restrict__ rho,
                                        float* __restrict__ vel, float* __restrict__ den,
                                        float* __restrict__ m0g, float* __restrict__ m1g, int Z,
                                        int Y, int X, double c, LbmGas gas,
                                        const T* __restrict__ f_lo, const T* __restrict__ f_hi,
                                        const T* __restrict__ g_lo, const T* __restrict__ g_hi) {
  const long long N = static_cast<long long>(Z) * Y * X;
  const long long i = lbm_cell();
  if (i >= N) return;
  const long long b = blockIdx.y;  // the batch element
  f = lbm_elem(f, b, 19, N), g = lbm_elem(g, b, 19, N), flags = lbm_elem(flags, b, 1, N);
  rho_old = lbm_elem(rho_old, b, 1, N), vel_old = lbm_elem(vel_old, b, 3, N);
  rho = lbm_elem(rho, b, 1, N), vel = lbm_elem(vel, b, 3, N), den = lbm_elem(den, b, 1, N);
  m0g = lbm_elem(m0g, b, 1, N), m1g = lbm_elem(m1g, b, 3, N);
  const int x = static_cast<int>(i % X);
  const int y = static_cast<int>((i / X) % Y);
  const int z = static_cast<int>(i / (static_cast<long long>(X) * Y));
  const bool obs = flags[i] == LBM_OBSTACLE;
  const LbmPullOffsets po = lbm_pull_offsets(z, y, x, Z, Y, X);

  float post[19];
  float m0f, m1f[3];
  const long long NP = static_cast<long long>(Y) * X;
  if (SLAB)
    lbm_pull_slab(f, f_lo, f_hi, N, NP, i, z, Z, po, obs, post);
  else
    lbm_pull_at(f, N, i, po, obs, post);
  lbm_moments(post, m0f, m1f);
  float m0, m1[3];
  if (SLAB)
    lbm_pull_slab(g, g_lo, g_hi, N, NP, i, z, Z, po, obs, post);
  else
    lbm_pull_at(g, N, i, po, obs, post);
  lbm_moments(post, m0, m1);

  const float r = obs ? rho_old[i] : m0f;
  const float inv_rho = static_cast<float>(c) / r;
  rho[i] = r;
#pragma unroll
  for (int d = 0; d < 3; ++d) vel[d * N + i] = obs ? vel_old[d * N + i] : m1f[d] * inv_rho;
  den[i] = lbm_density_of(r, gas);
  m0g[i] = m0;
#pragma unroll
  for (int d = 0; d < 3; ++d) m1g[d * N + i] = m1[d];
}

// Epilogue (B5): replaces the TPU kernel
// lbm_ferrofluid_tpu/ops/pallas/fused_step.py:lbm_epilogue (:779,
// _epilogue_kernel :300): re-stream and bounce f and g, then the HCZ LBGK
// collide with the capillary stage's 15 macro channels (rho, vel, density,
// pressure, force, dfai, dprho).  The TPU kernel collides in place behind
// its z-ring; here f' and g' go to a second buffer pair.  Non-fluid cells
// keep their bounced values.  The per-cell work is lbm_epilogue_cell below:
// common.cuh's pull (periodic wrap on every axis, bounce at obstacles) and
// collide, shared with B3 and B9.  With emit_mac the wrapper then launches
// lbm_prologue on f'/g' (the TPU kernel's emit_mac_plane :464, which reads
// its VMEM store rings), with rho_old = rho and vel_old = vel.
//
// Two forms (ops/kernels/fused_step.py:FORMS); each runs lbm_epilogue_cell
// on the same values, so both give the same bits:
//   - "cell" (lbm_epilogue_kernel, the earlier form): one thread a cell, which
//     pulls its values through L1/L2.  Only chip_smoke.py's comparisons and
//     its plan sweep select it, never the step.
//   - "stage" (lbm_epilogue_stage, the step's): a block owns EP_NT
//     consecutive cells of a plane, one thread a cell, and walks a strip of
//     zb planes (ops/kernels/fused_step.py:plan).  At each plane a thread
//     first copies all its loads (19 + 19 pulls, the 15 macro channels) by
//     cp.async into its own slots of shared memory, then waits for them and
//     collides.  The cell form holds its loads in registers, which the
//     collide's 128 leave room for only a part of at once; here all 53 are
//     in flight together.  A pulled value is read by one cell only (f_q at
//     c goes to c + e_q), so nothing is shared between threads or planes
//     and the stage needs no barrier.  In bfloat16 storage each copy takes
//     the aligned 4-byte pair that holds the value (cp.async moves 4 bytes
//     at least), with a bit a value that says which half; a pair that would
//     reach outside the array (at its first or last value) is loaded
//     instead.
// The collide takes 128 registers without spills (ptxas), so the launch
// bounds leave it 128: two blocks of 256 threads an SM (forced to fewer, it
// spilled and ran slower).
//
// Bound on an H100: bytes.  Read f and g and write f' and g' (304 B per
// cell), flags (1 B), and the 15 macro channels at fluid cells (60 B):
// about 1.8 ms at 256^3 over 3.35 TB/s, as B9; the emission adds 36 B per
// cell written and 16 B per obstacle cell read (2.0 ms).  The stage form
// reads the macro channels at non-fluid cells too.  About 900 flops per fluid
// cell take about 0.2 ms at 67 TFLOP/s.  In bfloat16 storage f, g, f' and
// g' take half: 153 B per cell plus 60 B per fluid cell, about 1.1 ms (1.24
// ms with the emission); the collide rounds once, on the store of f' and
// g'.
//
// B5's slab form (the TPU kernel's ghosts=, fused_step.py:779, for a z-slab
// of a domain decomposed along z over ranks: parallel/step3d.py): the
// stage form whose plane 0 copies its z-1 channels (9-13) and plane Z-1
// its z+1 channels (14-18) from the neighbours' pre-stream edge planes
// instead of the wrap, 5 channels of one plane a side, as B4's slab form
// pulls them (common.cuh:lbm_pull_slab).  The collide is local, so
// nothing else changes and a slab's f'/g' equal those of the same planes
// of the whole domain bit for bit.  With emit_mac the wrapper exchanges
// the collided edge planes and launches B4's slab form on f'/g' (where the
// TPU's wrapper rebuilds the two edge planes' macros in jnp,
// parallel/step3d.py:_mac_plane_jnp), so every plane's macros come from
// the kernels.  Its bound adds the ghost planes' reads.

// The 15 macro channels: channel c of cell i is lbm_ep_macro(m, c, N)[i],
// c = 0 rho, 1-3 vel, 4 density, 5 pressure, 6-8 force, 9-11 dfai, 12-14
// dprho.
struct LbmEpMacros {
  const float *rho, *vel, *den, *pres, *force, *dfai, *dprho;
};

// The macro channels of batch element b.
__device__ __forceinline__ LbmEpMacros lbm_ep_elem(const LbmEpMacros& m, long long b,
                                                   long long N) {
  return LbmEpMacros{lbm_elem(m.rho, b, 1, N),   lbm_elem(m.vel, b, 3, N),
                     lbm_elem(m.den, b, 1, N),   lbm_elem(m.pres, b, 1, N),
                     lbm_elem(m.force, b, 3, N), lbm_elem(m.dfai, b, 3, N),
                     lbm_elem(m.dprho, b, 3, N)};
}

__device__ __forceinline__ const float* lbm_ep_macro(const LbmEpMacros& m, int c, long long N) {
  return c == 0    ? m.rho
         : c <= 3  ? m.vel + (c - 1) * N
         : c == 4  ? m.den
         : c == 5  ? m.pres
         : c <= 8  ? m.force + (c - 6) * N
         : c <= 11 ? m.dfai + (c - 9) * N
                   : m.dprho + (c - 12) * N;
}

// B5's work at a cell with flags value flag: pull(d, obs, post) pulls and
// bounces f (d = 0) or g (d = 1); at a fluid cell mac(c) reads macro
// channel c and the collide runs; put(d, q, v) takes channel q of f' or g'.
template <class Pull, class Mac, class Put>
__device__ __forceinline__ void lbm_epilogue_cell(uint8_t flag, Pull pull, Mac mac,
                                                  const LbmHczK& k, Put put) {
  float post[19];
  if (flag != LBM_FLUID) {
    const bool obs = flag == LBM_OBSTACLE;
    pull(0, obs, post);
#pragma unroll
    for (int q = 0; q < 19; ++q) put(0, q, post[q]);
    pull(1, obs, post);
#pragma unroll
    for (int q = 0; q < 19; ++q) put(1, q, post[q]);
    return;
  }
  float u[3], fo[3], df[3], dp[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    u[d] = mac(1 + d);
    fo[d] = mac(6 + d);
    df[d] = mac(9 + d);
    dp[d] = mac(12 + d);
  }
  LbmHczCell h;
  lbm_hcz_prepare(h, k, mac(0), mac(4), mac(5), u, fo, df, dp);
  pull(0, false, post);
  lbm_hcz_collide_f(h, k, post);
#pragma unroll
  for (int q = 0; q < 19; ++q) put(0, q, post[q]);
  pull(1, false, post);
  lbm_hcz_collide_g(h, k, post);
#pragma unroll
  for (int q = 0; q < 19; ++q) put(1, q, post[q]);
}

// The "cell" plan: one thread a cell.
template <class T>
__global__ void __launch_bounds__(LBM_THREADS) lbm_epilogue_kernel(
    const T* __restrict__ f, const T* __restrict__ g, const uint8_t* __restrict__ flags,
    LbmEpMacros m, T* __restrict__ f_out, T* __restrict__ g_out, int Z, int Y, int X, LbmHczK k) {
  const long long N = static_cast<long long>(Z) * Y * X;
  const long long i = lbm_cell();
  if (i >= N) return;
  const long long b = blockIdx.y;  // the batch element
  f = lbm_elem(f, b, 19, N), g = lbm_elem(g, b, 19, N), flags = lbm_elem(flags, b, 1, N);
  m = lbm_ep_elem(m, b, N);
  f_out = lbm_elem(f_out, b, 19, N), g_out = lbm_elem(g_out, b, 19, N);
  const int x = static_cast<int>(i % X);
  const int y = static_cast<int>((i / X) % Y);
  const int z = static_cast<int>(i / (static_cast<long long>(X) * Y));
  const LbmPullOffsets po = lbm_pull_offsets(z, y, x, Z, Y, X);
  lbm_epilogue_cell(
      flags[i],
      [&](int d, bool obs, float* post) { lbm_pull_at(d ? g : f, N, i, po, obs, post); },
      [&](int c) { return lbm_ep_macro(m, c, N)[i]; }, k,
      [&](int d, int q, float v) { lbm_st((d ? g_out : f_out) + q * N + i, v); });
}

// Cells a block of the stage form owns, consecutive in a plane
// (ops/kernels/fused_step.py:NT; a CPU test reads these lines)
#define EP_NT 256
// registers a thread the launch bounds leave: blocks an SM = 65536 /
// (EP_REGS x EP_NT) (ops/kernels/fused_step.py:blocks_per_sm)
#define EP_REGS 128
// words of a thread's stage: 19 + 19 pulled f and g values (in bfloat16
// storage the pair that holds each), in bfloat16 a word of half bits each
// for f and g, and the 15 macro channels (ops/kernels/fused_step.py:
// STAGE_WORDS)
#define EP_WORDS 55
#define EP_STAGE_BYTES (EP_WORDS * EP_NT * 4)

// cp.async of the 4-byte word that holds *p into *dst; returns whether *p
// is its high half.  In bfloat16, where edge is set, a pair that starts
// before begin or ends after end is loaded instead.
__device__ __forceinline__ bool lbm_cp_word(uint32_t* dst, const float* p, const float*,
                                            const float*, bool) {
  lbm_cp_async4(dst, p);
  return false;
}
__device__ __forceinline__ bool lbm_cp_word(uint32_t* dst, const __nv_bfloat16* p,
                                            const __nv_bfloat16* begin,
                                            const __nv_bfloat16* end, bool edge) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const bool hi = (a & 2) != 0;
  const __nv_bfloat16* w = reinterpret_cast<const __nv_bfloat16*>(a & ~uintptr_t(3));
  if (edge && (w < begin || w + 2 > end)) {
    const uint32_t v = __bfloat16_as_ushort(*p);
    *dst = hi ? v << 16 : v;
  } else {
    lbm_cp_async4(dst, w);
  }
  return hi;
}

// A stage word as the value it holds (in bfloat16, the half that hi names).
__device__ __forceinline__ float lbm_stage_val(uint32_t w, bool, const float*) {
  return __uint_as_float(w);
}
__device__ __forceinline__ float lbm_stage_val(uint32_t w, bool hi, const __nv_bfloat16*) {
  return __uint_as_float(hi ? w & 0xffff0000u : w << 16);
}

// The pre-stream edge planes of the slab form's neighbours ([5, Y, X] each):
// channels 9-13 of the plane below the slab (lo), 14-18 of the plane above
// it (hi), of f and g.
template <class T>
struct LbmEpGhosts {
  const T *f_lo, *f_hi, *g_lo, *g_hi;
};

// Issues the copies of cell i (plane z, in-plane index i - z NP) into the
// stage st (this thread's word 0; word w at st[w * EP_NT]) and commits
// them as one group: lbm_pull_at's sources of f and g (SLAB: plane 0's z-1
// and plane Z-1's z+1 channels from the ghost planes gh, lbm_pull_slab's
// sources), then the macro channels.
template <class T, bool SLAB>
__device__ __forceinline__ void lbm_stage_issue(uint32_t* st, const T* __restrict__ f,
                                                const T* __restrict__ g, const LbmEpMacros& m,
                                                long long N, long long i,
                                                const LbmPullOffsets& o, const LbmEpGhosts<T>& gh,
                                                int z, int Z, long long NP) {
  const int ex[19] = LBM_D3Q19_EX;
  const int ey[19] = LBM_D3Q19_EY;
  const int ez[19] = LBM_D3Q19_EZ;
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const T* __restrict__ a = d ? g : f;
    uint32_t bits = 0;
#pragma unroll
    for (int q = 0; q < 19; ++q) {
      long long src = i;
      if (ex[q] != 0) src += ex[q] == 1 ? o.xm : o.xp;
      if (ey[q] != 0) src += ey[q] == 1 ? o.ym : o.yp;
      bool hi;
      if (SLAB && ((ez[q] == 1 && z == 0) || (ez[q] == -1 && z == Z - 1))) {
        const T* __restrict__ b = ez[q] == 1 ? (d ? gh.g_lo : gh.f_lo) : (d ? gh.g_hi : gh.f_hi);
        hi = lbm_cp_word(st + (19 * d + q) * EP_NT,
                         b + (ez[q] == 1 ? q - 9 : q - 14) * NP + (src - z * NP), b, b + 5 * NP,
                         true);
      } else {
        if (ez[q] != 0) src += ez[q] == 1 ? o.zm : o.zp;
        hi = lbm_cp_word(st + (19 * d + q) * EP_NT, a + q * N + src, a, a + 19 * N,
                         q == 0 || q == 18);
      }
      bits |= static_cast<uint32_t>(hi) << q;
    }
    if (sizeof(T) == 2) st[(38 + d) * EP_NT] = bits;
  }
#pragma unroll
  for (int c = 0; c < 15; ++c) lbm_cp_async4(st + (40 + c) * EP_NT, lbm_ep_macro(m, c, N) + i);
  lbm_cp_async_commit();
}

// The stage form (the step's): EP_STAGE_BYTES of dynamic shared memory a
// block.  SLAB: the slab form, its pulls across the slab's faces from gh.
template <class T, bool SLAB>
__global__ void __launch_bounds__(EP_NT, 65536 / (EP_REGS * EP_NT)) lbm_epilogue_stage(
    const T* __restrict__ f, const T* __restrict__ g, const uint8_t* __restrict__ flags,
    LbmEpMacros m, T* __restrict__ f_out, T* __restrict__ g_out, int Z, int Y, int X, int zb,
    LbmHczK k, LbmEpGhosts<T> gh) {
  extern __shared__ uint32_t lbm_ep_stage[];
  const long long XY = static_cast<long long>(X) * Y, N = XY * Z;
  const long long l = static_cast<long long>(blockIdx.x) * EP_NT + threadIdx.x;
  if (l >= XY) return;
  // the batch element (a slab form's launch has one)
  const long long b = blockIdx.z;
  f = lbm_elem(f, b, 19, N), g = lbm_elem(g, b, 19, N), flags = lbm_elem(flags, b, 1, N);
  m = lbm_ep_elem(m, b, N);
  f_out = lbm_elem(f_out, b, 19, N), g_out = lbm_elem(g_out, b, 19, N);
  const int y = static_cast<int>(l / X), x = static_cast<int>(l - static_cast<long long>(y) * X);
  const int z0 = static_cast<int>(blockIdx.y) * zb, z1 = min(z0 + zb, Z);
  const int opp[19] = LBM_D3Q19_OPP;
  uint32_t* const st = lbm_ep_stage + threadIdx.x;
  for (int z = z0; z < z1; ++z) {
    const long long i = z * XY + l;
    lbm_stage_issue<T, SLAB>(st, f, g, m, N, i, lbm_pull_offsets(z, y, x, Z, Y, X), gh, z, Z,
                             XY);
    const uint8_t flag = flags[i];
    lbm_cp_async_wait_all();
    lbm_epilogue_cell(
        flag,
        [&](int d, bool obs, float* post) {
          const uint32_t bits = sizeof(T) == 2 ? st[(38 + d) * EP_NT] : 0u;
          float s[19];
#pragma unroll
          for (int q = 0; q < 19; ++q)
            s[q] = lbm_stage_val(st[(19 * d + q) * EP_NT], (bits >> q) & 1u, f);
#pragma unroll
          for (int q = 0; q < 19; ++q) post[q] = obs ? s[opp[q]] : s[q];
        },
        [&](int c) { return __uint_as_float(st[(40 + c) * EP_NT]); }, k,
        [&](int d, int q, float v) { lbm_st((d ? g_out : f_out) + q * N + i, v); });
  }
}

// Lets the stage form's instance for T take EP_STAGE_BYTES of dynamic
// shared memory on the current device (one attribute call a device).
#define EP_MAX_DEVICES 64
template <class T, bool SLAB>
static cudaError_t lbm_ep_stage_allow() {
  static bool allowed[EP_MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= EP_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(lbm_epilogue_stage<T, SLAB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, EP_STAGE_BYTES);
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  return cudaSuccess;
}

// form: 0 the cell plan, 1 the stage form in strips of zb planes.  With
// blocks non-null, reports the form's resident blocks an SM instead of
// launching.  gh non-null: the slab form's ghost planes (f_lo, f_hi, g_lo,
// g_hi), the stage form only.
template <class T>
static int lbm_epilogue_launch(const void* f, const void* g, const uint8_t* flags,
                               const LbmEpMacros& m, void* f_out, void* g_out, int B, int Z,
                               int Y, int X, int form, int zb, LbmHczK k, cudaStream_t st,
                               int* blocks, const void* const* gh = nullptr) {
  const T* fi = static_cast<const T*>(f);
  const T* gi = static_cast<const T*>(g);
  T* fo = static_cast<T*>(f_out);
  T* go = static_cast<T*>(g_out);
  const long long XY = static_cast<long long>(X) * Y;
  if (B < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (gh != nullptr) {
    if (zb < 1 || form != 1 || B != 1) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = lbm_ep_stage_allow<T, true>();
    if (err != cudaSuccess) return static_cast<int>(err);
    const LbmEpGhosts<T> g4{static_cast<const T*>(gh[0]), static_cast<const T*>(gh[1]),
                            static_cast<const T*>(gh[2]), static_cast<const T*>(gh[3])};
    const dim3 grid(static_cast<unsigned>((XY + EP_NT - 1) / EP_NT), (Z + zb - 1) / zb);
    lbm_epilogue_stage<T, true><<<grid, EP_NT, EP_STAGE_BYTES, st>>>(fi, gi, flags, m, fo, go,
                                                                     Z, Y, X, zb, k, g4);
    return static_cast<int>(cudaGetLastError());
  }
  if (form == 0) {
    if (blocks != nullptr)
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, lbm_epilogue_kernel<T>, LBM_THREADS, 0));
    lbm_epilogue_kernel<T><<<dim3(lbm_blocks(XY * Z), B), LBM_THREADS, 0, st>>>(
        fi, gi, flags, m, fo, go, Z, Y, X, k);
    return static_cast<int>(cudaGetLastError());
  }
  if (zb < 1 || form != 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = lbm_ep_stage_allow<T, false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks != nullptr)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, lbm_epilogue_stage<T, false>, EP_NT, EP_STAGE_BYTES));
  const dim3 grid(static_cast<unsigned>((XY + EP_NT - 1) / EP_NT), (Z + zb - 1) / zb, B);
  lbm_epilogue_stage<T, false><<<grid, EP_NT, EP_STAGE_BYTES, st>>>(
      fi, gi, flags, m, fo, go, Z, Y, X, zb, k, LbmEpGhosts<T>{});
  return static_cast<int>(cudaGetLastError());
}

// f, g, f_out and g_out in float32, or in bfloat16 where bf16 is nonzero;
// (form, zb): the plan (lbm_epilogue_launch).
extern "C" int lbm_epilogue(const void* f, const void* g, const uint8_t* flags, const float* rho,
                            const float* vel, const float* den, const float* pres,
                            const float* force, const float* dfai, const float* dprho,
                            void* f_out, void* g_out, int B, int Z, int Y, int X, int form,
                            int zb, double dx, double dt, double tau_f, double tau_g, int bf16,
                            void* stream) {
  const LbmHczK k = lbm_hcz_consts(dx, dt, tau_f, tau_g);
  const LbmEpMacros m{rho, vel, den, pres, force, dfai, dprho};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return lbm_epilogue_launch<__nv_bfloat16>(f, g, flags, m, f_out, g_out, B, Z, Y, X, form,
                                              zb, k, st, nullptr);
  return lbm_epilogue_launch<float>(f, g, flags, m, f_out, g_out, B, Z, Y, X, form, zb, k, st,
                                    nullptr);
}

// B5's slab form: the stage form in strips of zb planes, f_lo, f_hi, g_lo
// and g_hi the neighbours' pre-stream edge planes ([5, Y, X] each, in the
// storage type).
extern "C" int lbm_epilogue_slab(const void* f, const void* g, const uint8_t* flags,
                                 const float* rho, const float* vel, const float* den,
                                 const float* pres, const float* force, const float* dfai,
                                 const float* dprho, void* f_out, void* g_out, int Z, int Y,
                                 int X, int zb, double dx, double dt, double tau_f,
                                 double tau_g, int bf16, const void* f_lo, const void* f_hi,
                                 const void* g_lo, const void* g_hi, void* stream) {
  const LbmHczK k = lbm_hcz_consts(dx, dt, tau_f, tau_g);
  const LbmEpMacros m{rho, vel, den, pres, force, dfai, dprho};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* gh[4] = {f_lo, f_hi, g_lo, g_hi};
  if (bf16)
    return lbm_epilogue_launch<__nv_bfloat16>(f, g, flags, m, f_out, g_out, 1, Z, Y, X, 1, zb,
                                              k, st, nullptr, gh);
  return lbm_epilogue_launch<float>(f, g, flags, m, f_out, g_out, 1, Z, Y, X, 1, zb, k, st,
                                    nullptr, gh);
}

// Blocks of B5's form (lbm_epilogue_launch) resident on one SM, in bfloat16
// storage (bf16 1) or float32 (for reports).
extern "C" int lbm_epilogue_occupancy(int form, int bf16, int* blocks) {
  const LbmEpMacros m{};
  const LbmHczK k{};
  return bf16 ? lbm_epilogue_launch<__nv_bfloat16>(nullptr, nullptr, nullptr, m, nullptr,
                                                   nullptr, 1, 4, 4, 4, form, 1, k, nullptr,
                                                   blocks)
              : lbm_epilogue_launch<float>(nullptr, nullptr, nullptr, m, nullptr, nullptr, 1, 4,
                                           4, 4, form, 1, k, nullptr, blocks);
}

template <class T>
static void lbm_prologue_launch(const void* f, const void* g, const uint8_t* flags,
                                const float* rho_old, const float* vel_old, float* rho,
                                float* vel, float* den, float* m0g, float* m1g, int B, int Z,
                                int Y, int X, double c, LbmGas gas, const void* f_lo,
                                const void* f_hi, const void* g_lo, const void* g_hi,
                                cudaStream_t stream) {
  const long long N = static_cast<long long>(Z) * Y * X;
  const T *tf = static_cast<const T*>(f), *tg = static_cast<const T*>(g);
  const T *flo = static_cast<const T*>(f_lo), *fhi = static_cast<const T*>(f_hi);
  const T *glo = static_cast<const T*>(g_lo), *ghi = static_cast<const T*>(g_hi);
  if (f_lo != nullptr)
    lbm_stream_macro_kernel<T, true><<<dim3(lbm_blocks(N), B), LBM_THREADS, 0, stream>>>(
        tf, tg, flags, rho_old, vel_old, rho, vel, den, m0g, m1g, Z, Y, X, c, gas, flo, fhi, glo,
        ghi);
  else
    lbm_stream_macro_kernel<T, false><<<dim3(lbm_blocks(N), B), LBM_THREADS, 0, stream>>>(
        tf, tg, flags, rho_old, vel_old, rho, vel, den, m0g, m1g, Z, Y, X, c, gas, flo, fhi, glo,
        ghi);
}

// f and g in float32, or in bfloat16 where bf16 is nonzero; the slab form
// where f_lo is not null (f_lo, f_hi, g_lo, g_hi: [5, Y, X] ghost planes in
// the storage type)
extern "C" int lbm_prologue(const void* f, const void* g, const uint8_t* flags,
                            const float* rho_old, const float* vel_old, float* rho, float* vel,
                            float* den, float* m0g, float* m1g, int B, int Z, int Y, int X,
                            double c, double rho_gas, double rho_fluid, double den_gas,
                            double den_fluid, int bf16, const void* f_lo, const void* f_hi,
                            const void* g_lo, const void* g_hi, void* stream) {
  const LbmGas gas = lbm_gas(rho_gas, rho_fluid, den_gas, den_fluid);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || (f_lo != nullptr && B != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    lbm_prologue_launch<__nv_bfloat16>(f, g, flags, rho_old, vel_old, rho, vel, den, m0g, m1g,
                                       B, Z, Y, X, c, gas, f_lo, f_hi, g_lo, g_hi, st);
  else
    lbm_prologue_launch<float>(f, g, flags, rho_old, vel_old, rho, vel, den, m0g, m1g, B, Z, Y,
                               X, c, gas, f_lo, f_hi, g_lo, g_hi, st);
  return static_cast<int>(cudaGetLastError());
}
