// Encoder values stage: computeValues3D for every (tile, LUT) and the LUT
// selection scan.
//
// Replaces yaik_tpu/ops/pallas_kernels.py `values48` and the XLA form it
// twins, yaik_tpu/encoder/jax_scoring.py `_values_core` /
// `tile3d_values_device`. Per tile t and LUT e (pattern mode = mode48[t,e]):
//
//   mf[o]  = float(flip[s] ? b_c[s] : a_c[s]),  s = SWAP3D[mode >> 3][o],
//            flip[s] = (mode >> s) & 1
//   for each bit-depth window bi = 0..3 (64/32/16/8 points of pts[e, ::2^bi]):
//     idx  = first argmin_n ((mf0 - sf0)^2 + (mf1 - sf1)^2) + (mf2 - sf2)^2
//     fx_o = flip[s] ? 128 - f[s] : f[s],  f = factors[3 - bi][e][idx]
//     ld   = max_o |mn[o] + ((fx_o * d[o]) >> 7) - tile[o]|  (0 when dead)
//     if count(ld > 5) <= 3 over the tile: mode = 3 - bi, diff = sum(ld)
//   scan over e: a LUT with a mode and diff <= best takes the tile (a later
//   LUT wins ties; best starts at 1215752191).
//   tile_type = mode48 | e << 6 | min(mode, 3) << 14, and idx of the chosen
//   window. A tile no LUT takes gets e = 0, mode 3 and e 0's window-0 idx,
//   as the XLA form's tail gives it.
//
// Two facts shape the design. The tile's decision reads alive pixels only
// (a dead pixel's ld is 0 whatever its idx), and a pixel's output idx is
// its first-min point in ONE window: window 3 - mode of the chosen LUT.
// So the work splits in two phases:
//
// Phase 1, the decision, on alive pixels only. One CTA takes a group of
// whole tiles (at most 512 pixels, 32 tiles); their alive pixels are
// compacted in order into shared memory (a block-wide prefix sum of warp
// ballots, every alive flag loaded before its one barrier). The LUTs go in
// chunks of 16: the chunk's packed window points are staged in shared
// memory (30 KB; a group with no alive pixel stages nothing). Each thread
// takes (LUT, alive pixel) items, LUT-major so that a warp reads one LUT's
// points (broadcasts) and its lanes run over one tile's pixels, and runs
// the four window searches. Per (tile, LUT, window) the count of ld > 5 and
// the sum of ld are integer warp-segmented reductions (__match_any_sync +
// __reduce_add_sync) added into shared-memory counters with atomics:
// integer sums do not depend on their order, so the result is
// deterministic. After each chunk one thread per tile runs the scan over
// its LUTs in order, keeping the scan state in shared memory; no table
// holds all E LUTs, so any E <= 128 runs. A tile with no alive pixel reads
// counts of 0: window 3 of every LUT takes it with diff 0, and the last
// LUT wins.
//
// Phase 2, every pixel's idx, is a second kernel: a thread per pixel reads
// its tile's type word (which names the chosen LUT and window) and searches
// only that window (64, 32, 16 or 8 points), read from the packed table in
// device memory (L1-resident, a broadcast per tile). A third, tiny kernel
// packs the tables first. All three run on the caller's stream.
//
// Exactness. The reference distance is float32 ((d0^2 + d1^2) + d2^2),
// rounded at each step. Where a pixel's |a_c| and |b_c| are at most 2048
// (every alive pixel: its normalizations lie in 0..63) and the points lie
// in 0..255 (the wrapper's precondition: a bank's points are u8),
// |mf - s| <= 2303 and 3 * 2303^2 < 2^24: every float step is exact, so the
// float distance IS the integer one, and any integer formulation gives the
// same first-min index. The integer path uses the expanded |s|^2 - 2 m.s
// with the per-pixel |m|^2 dropped, as the packed key
//   128 * (|s|^2 - 2 m.s) + n  =  key0[n] + sum_o (-256 m_o) s_o,
// key0[n] = 128 |s|^2 + n precomputed per point; |key| < 2^29, so int32
// holds it, and its minimum is the least distance with the least n. Other
// pixels (dead ones whose normalization wrapped, |value| up to 2^31) take
// the reference's float order, pinned with __fsub_rn/__fmul_rn/__fadd_rn so
// nvcc contracts nothing into an FMA. Both phases use this per-pixel
// condition, and the branch is warp-uniform (__any_sync): a warp with one
// such pixel searches in float, which is exact for the others too.
//
// Bound on the H100: the bytes of the per-pixel operands (a_c, b_c of every
// pixel, idx written) on sparse passes; the alive pixels' E * 120 window
// points (4 integer ops each) on dense ones.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPoints = 120;       // 64 + 32 + 16 + 8 window points
constexpr int kGroupPx = 512;      // pixels per CTA at most
constexpr int kMaxTiles = 32;      // tiles per CTA at most
constexpr int kRounds = kGroupPx / kThreads;   // of staging
constexpr int kChunkE = 16;        // LUTs per staged table chunk
constexpr int kExact = 2048;       // |a_c|, |b_c| bound of the integer path
constexpr int kSkip = 4;
constexpr int kInit = 1215752191;  // (int)99999999999, EncoderContext:6459
// SWAP3D[k][o] as 2-bit fields at bit 6k + 2o
constexpr unsigned long long kSwap =
    (0ull | 1ull << 2 | 2ull << 4) | (0ull | 2ull << 2 | 1ull << 4) << 6 |
    (1ull | 0ull << 2 | 2ull << 4) << 12 |
    (1ull | 2ull << 2 | 0ull << 4) << 18 |
    (2ull | 0ull << 2 | 1ull << 4) << 24 |
    (2ull | 1ull << 2 | 0ull << 4) << 30;

__device__ __forceinline__ int sel3(int a0, int a1, int a2, int i) {
  return i == 0 ? a0 : (i == 1 ? a1 : a2);
}

// window bi's first point in the packed [120] table: 0, 64, 96, 112
__device__ __forceinline__ int win_off(int bi) { return 128 - (128 >> bi); }

// A pattern mode's frame: flip bits and the channel order.
struct Frame {
  int fl[3], s[3];
  __device__ __forceinline__ explicit Frame(int m48) {
    const unsigned sw = (unsigned)(kSwap >> (6 * (m48 >> 3)));
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      fl[o] = (m48 >> o) & 1;
      s[o] = (sw >> (2 * o)) & 3;
    }
  }
  // the searched coordinates m[o] from the pixel's two normalizations
  __device__ __forceinline__ void coords(const int* ac, const int* bc,
                                         int* m) const {
    const int m0 = fl[0] ? bc[0] : ac[0], m1 = fl[1] ? bc[1] : ac[1],
              m2 = fl[2] ? bc[2] : ac[2];
#pragma unroll
    for (int o = 0; o < 3; ++o) m[o] = sel3(m0, m1, m2, s[o]);
  }
  // max_o |mn[o] + ((fx_o * d[o]) >> 7) - tile[o]| for factors f
  __device__ __forceinline__ int ldiff(int4 f, const int* mn, const int* d,
                                       const int* tl) const {
    const int fx0 = fl[0] ? 128 - f.x : f.x, fx1 = fl[1] ? 128 - f.y : f.y,
              fx2 = fl[2] ? 128 - f.z : f.z;
    int ld = 0;
#pragma unroll
    for (int o = 0; o < 3; ++o)
      ld = max(ld, abs(mn[o] + ((sel3(fx0, fx1, fx2, s[o]) * d[o]) >> 7)
                       - tl[o]));
    return ld;
  }
};

// First-min point of a kN-point window, integer path (see the exactness
// note).
template <int kN, bool kGlobal>
__device__ __forceinline__ int search_int(const int4* __restrict__ w,
                                          const int* m) {
  const int k0 = -256 * m[0], k1 = -256 * m[1], k2 = -256 * m[2];
  int best = INT_MAX;
#pragma unroll 8
  for (int n = 0; n < kN; ++n) {
    const int4 s = kGlobal ? __ldg(w + n) : w[n];
    best = min(best, s.w + k0 * s.x + k1 * s.y + k2 * s.z);
  }
  return best & 127;
}

// First-min point of a kN-point window in the reference's float32 order.
template <int kN, bool kGlobal>
__device__ __forceinline__ int search_float(const int4* __restrict__ w,
                                            const int* m) {
  const float mf0 = (float)m[0], mf1 = (float)m[1], mf2 = (float)m[2];
  float bd = 0.f;
  int bn = 0;
#pragma unroll 8
  for (int n = 0; n < kN; ++n) {
    const int4 s = kGlobal ? __ldg(w + n) : w[n];
    const float d0 = __fsub_rn(mf0, (float)s.x),
                d1 = __fsub_rn(mf1, (float)s.y),
                d2 = __fsub_rn(mf2, (float)s.z);
    const float dist = __fadd_rn(
        __fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
    if (n == 0 || dist < bd) {         // the first minimum wins
      bd = dist;
      bn = n;
    }
  }
  return bn;
}

// First-min point of window kBi of a LUT's packed points `lut` (device or,
// with !kGlobal, shared memory); `flt` (warp-uniform) takes the float order.
template <int kBi, bool kGlobal>
__device__ __forceinline__ int first_min(const int4* lut, const int* m,
                                         bool flt) {
  const int4* w = lut + (128 - (128 >> kBi));
  return flt ? search_float<(64 >> kBi), kGlobal>(w, m)
             : search_int<(64 >> kBi), kGlobal>(w, m);
}

// |a_c| and |b_c| <= 2048 in every channel (unsigned, so INT_MIN fails)
__device__ __forceinline__ bool exact(const int* ac, const int* bc) {
  bool ok = true;
#pragma unroll
  for (int o = 0; o < 3; ++o)
    ok = ok && (unsigned)ac[o] + kExact <= 2u * kExact &&
         (unsigned)bc[o] + kExact <= 2u * kExact;
  return ok;
}

// The packed window tables, [E * 120] each: points (s0, s1, s2,
// 128 |s|^2 + n) and factors (f0, f1, f2, 0) of window bi's n-th point.
__global__ void pack_tables(const int* __restrict__ pts,
                            const int* __restrict__ factors, int E,
                            int4* __restrict__ sp, int4* __restrict__ fp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= E * kPoints) return;
  const int e = i / kPoints, j = i % kPoints;
  const int bi = j < 64 ? 0 : (j < 96 ? 1 : (j < 112 ? 2 : 3));
  const int n = j - win_off(bi);
  const int* p = pts + ((size_t)e * 64 + (n << bi)) * 3;
  const int* f = factors + (((size_t)(3 - bi) * E + e) * 64 + n) * 3;
  sp[i] = make_int4(p[0], p[1], p[2],
                    128 * (p[0] * p[0] + p[1] * p[1] + p[2] * p[2]) + n);
  fp[i] = make_int4(f[0], f[1], f[2], 0);
}

__global__ void __launch_bounds__(kThreads, 3)
values48_kernel(const int* __restrict__ tiles,
                const uint8_t* __restrict__ alive, const int* __restrict__ a_c,
                const int* __restrict__ b_c, const int* __restrict__ mode48,
                const int* __restrict__ mn, const int* __restrict__ d,
                const int4* __restrict__ sp, const int4* __restrict__ fp,
                long long T, int P, int E, uint8_t* __restrict__ accept,
                int* __restrict__ tile_type) {
  extern __shared__ int4 tab[];     // the chunk's points, [kChunkE * 120]
  __shared__ int4 qa[kGroupPx];    // alive pixel: a_c
  __shared__ int4 qb[kGroupPx];    // b_c, its tile in the group
  __shared__ int4 qt[kGroupPx];    // its pixel, 1 where the integer path holds
  // per (LUT of the chunk, window, tile) at (el * 4 + bi) * kMaxTiles + t:
  // the scan's threads (one per tile) read consecutive words
  __shared__ int cnt[kChunkE * 4 * kMaxTiles];
  __shared__ int sum[kChunkE * 4 * kMaxTiles];
  __shared__ int tmn[kMaxTiles][3], td[kMaxTiles][3];
  __shared__ int best_diff[kMaxTiles], best_e[kMaxTiles], best_acc[kMaxTiles];
  __shared__ int wcnt[kRounds][kWarps];
  const int tpg = min(kGroupPx / P, kMaxTiles);
  const long long t0 = (long long)blockIdx.x * tpg;
  const int nt = (int)min((long long)tpg, T - t0);
  const int npx = nt * P;
  const long long g0 = t0 * P;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (threadIdx.x < nt) {
    const long long t = t0 + threadIdx.x;
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      tmn[threadIdx.x][o] = __ldg(mn + t * 3 + o);
      td[threadIdx.x][o] = __ldg(d + t * 3 + o);
    }
    best_diff[threadIdx.x] = kInit;
    best_e[threadIdx.x] = -1;
    best_acc[threadIdx.x] = kSkip;
  }
  for (int i = threadIdx.x; i < kChunkE * 4 * kMaxTiles; i += kThreads)
    cnt[i] = sum[i] = 0;

  // compact the alive pixels, in order: the thread's alive flags of every
  // round load together, and one barrier publishes the rounds' warp counts
  unsigned flags = 0;                   // bit r: pixel r * kThreads + tid
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = r * kThreads + threadIdx.x;
    if (i < npx && __ldg(alive + g0 + i) != 0) flags |= 1u << r;
  }
  unsigned bal[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    bal[r] = __ballot_sync(0xffffffffu, (flags >> r) & 1u);
    if (lane == 0) wcnt[r][warp] = __popc(bal[r]);
  }
  __syncthreads();
  int nalive = 0;                       // alive pixels before this round
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = r * kThreads + threadIdx.x;
    int at = nalive + __popc(bal[r] & ((1u << lane) - 1u));
    for (int w = 0; w < kWarps; ++w) {
      at += w < warp ? wcnt[r][w] : 0;
      nalive += wcnt[r][w];
    }
    if ((flags >> r) & 1u) {
      const long long g = g0 + i;
      int ac[3], bc[3], tl[3];
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        ac[o] = __ldg(a_c + g * 3 + o);
        bc[o] = __ldg(b_c + g * 3 + o);
        tl[o] = __ldg(tiles + g * 3 + o);
      }
      qa[at] = make_int4(ac[0], ac[1], ac[2], 0);
      qb[at] = make_int4(bc[0], bc[1], bc[2], i / P);
      qt[at] = make_int4(tl[0], tl[1], tl[2], exact(ac, bc));
    }
  }
  __syncthreads();

  // phase 1: the decision, LUT chunk by LUT chunk
  for (int e0 = 0; e0 < E; e0 += kChunkE) {
    const int ec = min(kChunkE, E - e0);
    // items (LUT, alive pixel), LUT-major so that a warp reads one LUT's
    // points (broadcasts) and its lanes run over one tile's pixels
    const int items = ec * nalive;
    if (items > 0) {                    // stage the chunk's points
      for (int i = threadIdx.x; i < ec * kPoints; i += kThreads)
        tab[i] = __ldg(sp + (size_t)e0 * kPoints + i);
      __syncthreads();
    }
    for (int r = 0; r < items; r += kThreads) {
      const int i = r + threadIdx.x;
      const bool on = i < items;
      const int el = on ? i / nalive : 0, k = on ? i % nalive : 0;
      const int4 A = qa[k], B = qb[k], C = qt[k];
      const bool flt = __any_sync(0xffffffffu, on && !C.w);
      const int key = on ? B.w * kChunkE + el : -1;
      int ld[4] = {0, 0, 0, 0};
      if (on) {
        const int e = e0 + el, t = B.w;
        const Frame fr(__ldg(mode48 + (t0 + t) * E + e));
        const int ac[3] = {A.x, A.y, A.z}, bc[3] = {B.x, B.y, B.z},
                  tl[3] = {C.x, C.y, C.z};
        int m[3], n[4];
        fr.coords(ac, bc, m);
        const int4* lut = tab + el * kPoints;
        n[0] = first_min<0, false>(lut, m, flt);
        n[1] = first_min<1, false>(lut, m, flt);
        n[2] = first_min<2, false>(lut, m, flt);
        n[3] = first_min<3, false>(lut, m, flt);
        const int4* lutf = fp + (size_t)e * kPoints;
#pragma unroll
        for (int bi = 0; bi < 4; ++bi)
          ld[bi] = fr.ldiff(__ldg(lutf + win_off(bi) + n[bi]), tmn[t], td[t],
                            tl);
      }
      // lanes of one (tile, LUT) are contiguous: reduce each run in the
      // warp, and let its first lane add the run's totals
      const unsigned run = __match_any_sync(0xffffffffu, key);
      const bool lead = on && lane == __ffs(run) - 1;
#pragma unroll
      for (int bi = 0; bi < 4; ++bi) {
        const int c = __reduce_add_sync(run, ld[bi] > 5 ? 1 : 0);
        const int s = __reduce_add_sync(run, ld[bi]);
        const int at = (el * 4 + bi) * kMaxTiles + B.w;
        if (lead && c) atomicAdd(&cnt[at], c);
        if (lead && s) atomicAdd(&sum[at], s);
      }
    }
    __syncthreads();
    if (threadIdx.x < nt) {             // the scan over the chunk's LUTs
      const int t = threadIdx.x;
      int bd = best_diff[t], be = best_e[t], ba = best_acc[t];
      for (int el = 0; el < ec; ++el) {
        int acc = kSkip, diff = 0;
#pragma unroll
        for (int bi = 0; bi < 4; ++bi) {
          const int c = (el * 4 + bi) * kMaxTiles + t;
          if (cnt[c] <= 3) {
            acc = 3 - bi;
            diff = sum[c];
          }
          cnt[c] = sum[c] = 0;
        }
        if (acc != kSkip && diff <= bd) {
          bd = diff;
          be = e0 + el;
          ba = acc;
        }
      }
      best_diff[t] = bd;
      best_e[t] = be;
      best_acc[t] = ba;
    }
    __syncthreads();                    // tab and the counts are reused
  }

  if (threadIdx.x < nt) {
    const long long t = t0 + threadIdx.x;
    const int e_sel = max(best_e[threadIdx.x], 0);
    accept[t] = best_e[threadIdx.x] >= 0;
    tile_type[t] = __ldg(mode48 + t * E + e_sel) | (e_sel << 6) |
                   (min(best_acc[threadIdx.x], 3) << 14);
  }
}

// Phase 2: every pixel's idx in its tile's chosen window, read from the
// tile's type word (mode48 | e << 6 | mode << 14): window 3 - mode of LUT e.
__global__ void __launch_bounds__(kThreads)
values48_idx(const int* __restrict__ a_c, const int* __restrict__ b_c,
             const int* __restrict__ tile_type, const int4* __restrict__ sp,
             long long npx, int log2p, int* __restrict__ idx_out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool on = i < npx;
  const long long g = on ? i : 0;
  int ac[3], bc[3];
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    ac[o] = __ldg(a_c + g * 3 + o);
    bc[o] = __ldg(b_c + g * 3 + o);
  }
  const bool flt = __any_sync(0xffffffffu, on && !exact(ac, bc));
  if (on) {
    const int tt = __ldg(tile_type + (g >> log2p));
    const int bi = 3 - (tt >> 14);
    const Frame fr(tt & 63);
    int m[3];
    fr.coords(ac, bc, m);
    const int4* lut = sp + (size_t)((tt >> 6) & 0xFF) * kPoints;
    idx_out[g] = bi == 0   ? first_min<0, true>(lut, m, flt)
                 : bi == 1 ? first_min<1, true>(lut, m, flt)
                 : bi == 2 ? first_min<2, true>(lut, m, flt)
                           : first_min<3, true>(lut, m, flt);
  }
}

}  // namespace

// tiles, a_c, b_c [T, P, 3] i32; alive [T, P] u8; mode48 [T, E] i32;
// mn, d [T, 3] i32; pts [E, 64, 3] i32 in 0..255; factors [4, E, 64, 3] i32;
// scratch [2, E, 120, 4] i32 (16-byte aligned) -> accept [T] u8,
// tile_type [T] i32, idx [T, P] i32. P is a power of two <= 256, E <= 128.
extern "C" int yaik_values48(const int* tiles, const uint8_t* alive,
                             const int* a_c, const int* b_c,
                             const int* mode48, const int* mn, const int* d,
                             const int* pts, const int* factors, int* scratch,
                             long long T, int P, int E, uint8_t* accept,
                             int* tile_type, int* idx, cudaStream_t stream) {
  if (T > 0 && E > 0) {
    int4* sp = reinterpret_cast<int4*>(scratch);
    int4* fp = sp + (size_t)E * kPoints;
    pack_tables<<<(E * kPoints + 255) / 256, 256, 0, stream>>>(pts, factors,
                                                               E, sp, fp);
    const long long tpg = kGroupPx / P < kMaxTiles ? kGroupPx / P : kMaxTiles;
    const unsigned blocks = (unsigned)((T + tpg - 1) / tpg);
    const int smem = kChunkE * kPoints * (int)sizeof(int4);
    const cudaError_t err = cudaFuncSetAttribute(
        values48_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    values48_kernel<<<blocks, kThreads, smem, stream>>>(
        tiles, alive, a_c, b_c, mode48, mn, d, sp, fp, T, P, E, accept,
        tile_type);
    int log2p = 0;
    while ((1 << log2p) < P) ++log2p;
    const long long npx = T * P;
    values48_idx<<<(unsigned)((npx + kThreads - 1) / kThreads), kThreads, 0,
                   stream>>>(a_c, b_c, tile_type, sp, npx, log2p, idx);
  }
  return static_cast<int>(cudaGetLastError());
}
