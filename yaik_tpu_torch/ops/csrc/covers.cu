// The LUT-bank miner's coverage matrix: which candidate clouds cover which
// captured tiles.
//
// Replaces yaik_tpu/encoder/mining.py `_covers_device` (3D) and
// `_covers2d_device` (2D). Those are XLA on the TPU, not Pallas: a
// [kc, nc, 64 px, 64 pt(, 3)] broadcast of squared distances, reduced by a
// min over the points and a count over the pixels, chunked over both axes
// so the transient stays bounded. Here the broadcast is never built: each
// distance lives in registers for the one min it feeds.
//
// out[c, t] = #{pixels p of tile t : (p counted) and
//               min over the 64 points q of candidate c of |p - q|^2 > gate}
//             <= 3
// 3D: points and pixels are (x, y, z), every pixel counts. 2D: (x, y); a
// candidate's pad points (cmask 0) sit at (4096, 4096), as the JAX package
// pads them, and a tile's pad pixels (tmask 0) are left out of the count.
// Coordinates lie in 0..4096 and `gate` is any int32.
//
// Both are bound by operations on the H100: k * n * 64 * 64 distances in
// 3D, (live points) x (counted pixels) in 2D, against k*64 + n*64 input
// points and k*n output bytes, some 10^4 operations per byte moved.
//
// 3D (`covers3d_kernel`, 97-98% of its int32 bound): a block stages KC
// candidates in shared memory (one 16-byte word per point, read as a
// broadcast); each warp takes one tile at a time, two pixels a lane in
// registers, and for each staged candidate takes both pixels' mins over its
// 64 points in int32 (3 sub, 3 mul, 2 add, 1 min), counts the violations
// with __ballot_sync / __popc and writes one byte.
//
// 2D (`covers2d_kernel`). In the miner's operands about half of a tile's 64
// slots and of a candidate's 64 points are pads, so a loop over the slots
// computes each distance the bound needs about four times over. The design
// (each choice against what measured slower on the H100, at k = 256,
// n = 50,000 seeded clouds):
// - Counted pixels only. The tiles' counted pixels, in tile and slot
//   order, make one stream; a prologue (`kernels.covers2d_plan`, torch ops,
//   no host sync) gives each tile's start in it and each batch's first
//   tile. A warp takes CAP = 512 consecutive pixels of the stream, R = 16
//   a lane (slot r * 32 + lane), from whichever tiles hold them: a lane
//   loads one tile's start and mask, a slot finds its tile among the lanes
//   by a binary search of shuffles and its pixel by its rank among the
//   tile's counted pixels (slower: a loop over the tiles, a round trip
//   each; a packed copy of the stream made by torch ops before the launch).
//   Every batch is full but the last, so no lane computes a pad. A tile's
//   violations are the popcount of the R ballot words under the bits of
//   its segment. A tile that crosses a batch edge (at most one per edge: a
//   tile has <= 64 < CAP pixels) is counted by both batches: each adds its
//   part plus 1024 to a zeroed counter for (candidate, edge) with
//   atomicAdd, and the one that finds the other's part there writes the
//   byte. The "<= 3" rule stays a tile's.
// - Live points only, no pad point. A candidate's live points are staged
//   packed to the front in order. The pad point (4096, 4096) is the same
//   for every pad slot, so "min over live and pad > gate" is
//   "min over live > gate and d(p, pad) > gate"; d(p, pad) is one bit a
//   pixel, taken once a batch in 64-bit integers and applied only to
//   candidates with a pad. A candidate with no live point has min INT_MAX:
//   its pixels violate exactly where d(p, pad) > gate, as in the JAX
//   package. An odd live count is padded with a copy of the first live
//   point (the min is unchanged) so that the loop takes points in pairs.
// - Sixteen distances per point load: a point is one 16-byte word (x, y,
//   x^2 + y^2, x | y << 8), broadcast from shared memory to sixteen pixels
//   a lane held in registers (slower: eight, four). A block stages 32
//   candidates for 16 warps, a batch each (slower: 8 warps, 16 candidates).
// - One dp2a a distance. With a = (-2 px, -2 py) as two signed 16-bit
//   halves, b = (qx, qy) as two unsigned bytes and c = qx^2 + qy^2,
//   `dp2a.lo.s32.u32` gives c + a.b = |p - q|^2 - |p|^2 in one
//   instruction, and a 3-input min (__vimin3_s32) takes two of them: 1.5
//   instructions a distance, against five in int32 (2 sub, 2 mul with an
//   add, 1 min). Slower: float32 on exact integers (two FFMA and one FMNMX
//   a distance, or a 3-input integer min on offset floats), and half of a
//   lane's pixels by dp2a, half by FFMA.
//   Exact in int32: each product is at most 2 * 16383 * 255 < 2^23 in
//   size and c at most 2 * 255^2, so every sum lies within +-2^25 and is
//   |p - q|^2 - |p|^2 itself. The test "min > gate - |p|^2" takes
//   gate - |p|^2 in 64-bit integers, clamped to [-2^30, 2^30]; every such
//   min lies strictly inside, so the clamp keeps the answer.
// - The routes. dp2a needs every staged point of the block in 0..255 (the
//   miner's u8 clouds) and every pixel of the batch in 0..16383 (-2 x fits
//   16 bits); elsewhere (i32 coordinates up to 4096) the batch takes the
//   distances in int32 as the 3D loop does (squares <= 2 * 4096^2 < 2^31).
//   The choice is uniform over a warp, and both routes give the same bits.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int KC = 32;            // 3D: candidates staged per block
constexpr int WARPS = 8;          // 3D: warps per block
constexpr int TILES_PER_WARP = 8;  // 3D: tiles each warp walks per block
constexpr int TPB = WARPS * TILES_PER_WARP;

__global__ void __launch_bounds__(WARPS * 32)
covers3d_kernel(const int* __restrict__ cands, const int* __restrict__ tiles,
                int k, int n, int gate, uint8_t* __restrict__ out) {
  __shared__ int4 pts[KC * 64];
  const int c0 = blockIdx.y * KC;
  const int kc = min(KC, k - c0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = warp; c < kc; c += WARPS)
    for (int h = 0; h < 64; h += 32) {
      const int* s = cands + ((size_t)(c0 + c) * 64 + h + lane) * 3;
      pts[c * 64 + h + lane] =
          make_int4(__ldg(s), __ldg(s + 1), __ldg(s + 2), 0);
    }
  __syncthreads();
  const int t_end = min(n, (int)(blockIdx.x + 1) * TPB);
  for (int t = blockIdx.x * TPB + warp; t < t_end; t += WARPS) {
    const int* a = tiles + ((size_t)t * 64 + lane) * 3;
    const int* b = a + 32 * 3;
    const int ax = __ldg(a), ay = __ldg(a + 1), az = __ldg(a + 2);
    const int bx = __ldg(b), by = __ldg(b + 1), bz = __ldg(b + 2);
    for (int c = 0; c < kc; ++c) {
      const int4* q = pts + c * 64;
      int ma = INT_MAX, mb = INT_MAX;
#pragma unroll 8
      for (int j = 0; j < 64; ++j) {
        const int4 v = q[j];
        const int dax = ax - v.x, day = ay - v.y, daz = az - v.z;
        const int dbx = bx - v.x, dby = by - v.y, dbz = bz - v.z;
        ma = min(ma, dax * dax + day * day + daz * daz);
        mb = min(mb, dbx * dbx + dby * dby + dbz * dbz);
      }
      const unsigned ba = __ballot_sync(0xffffffffu, ma > gate);
      const unsigned bb = __ballot_sync(0xffffffffu, mb > gate);
      if (lane == 0)
        out[(size_t)(c0 + c) * n + t] = (__popc(ba) + __popc(bb)) <= 3;
    }
  }
}

constexpr int KC2 = 32;           // 2D: candidates staged per block
constexpr int WARPS2 = 16;        // 2D: warps per block, a batch each
constexpr int R = 16;             // 2D: pixel slots a lane
constexpr int CAP = 32 * R;       // 2D: counted pixels a batch (a warp's)
constexpr int PAD = 4096;         // a 2D candidate's pad point coordinate
constexpr unsigned PT_MAX = 255;  // dp2a route: points' coordinates (u8)
constexpr unsigned PX_MAX = 16383;  // dp2a route: pixels' (-2 x in s16)
constexpr int ARRIVED = 1024;     // a crossing tile's part is in the counter

// the position of the j-th (from 0) set bit of w, which has more than j
__device__ __forceinline__ int nth_bit(unsigned w, int j) {
  int pos = 0;
#pragma unroll
  for (int h = 16; h; h >>= 1) {
    const int c = __popc(w & ((1u << h) - 1));
    if (j >= c) {
      j -= c;
      w >>= h;
      pos += h;
    }
  }
  return pos;
}

// 4 mask bytes (each 0 or 1) as 4 bits: byte i's bit to bit i
__device__ __forceinline__ unsigned byte_bits(unsigned x) {
  return ((x & 0x01010101u) * 0x01020408u) >> 24;
}

// c + a.lo * b.byte0 + a.hi * b.byte1, a's halves signed 16-bit, b's
// bytes unsigned: with a = (-2 px, -2 py), b = (qx, qy), c = qx^2 + qy^2
// it is |p - q|^2 - |p|^2, exact in int32
__device__ __forceinline__ int dp2a_su(unsigned a, int b, int c) {
  int d;
  asm("dp2a.lo.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// the bits of ballot word r (batch slots 32 r .. 32 r + 31) in [s0, s1)
__device__ __forceinline__ unsigned seg_bits(int r, int s0, int s1) {
  const int lo = min(max(s0 - 32 * r, 0), 32);
  const int hi = min(max(s1 - 32 * r, 0), 32);
  return (unsigned)(((1ull << hi) - 1) ^ ((1ull << lo) - 1));
}

// One batch against the block's staged candidates: slots [lo, hi) of the
// counted-pixel stream (pix: this lane's R of them, (0, 0) past hi), the
// tiles ta..tz-1 that hold them.
template <bool DP2A>
__device__ __forceinline__ void batch2d(
    const int4* pts, const int* npts, const int* haspad, const int2* pix,
    const int* __restrict__ starts, int b, int lo, int hi, int ta, int tz,
    int c0, int kc, int n, int gate, int nb, int* __restrict__ scratch,
    uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  // dp2a route: a2 = (-2 px, -2 py) as two s16, thr = gate - |p|^2;
  // int32 route: px, py
  unsigned a2[R];
  int thr[R], px[R], py[R];
  unsigned padv = 0;              // bit r: d(pixel r, pad point) > gate
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long dx = PAD - pix[r].x, dy = PAD - pix[r].y;
    padv |= (unsigned)(dx * dx + dy * dy > gate) << r;
    if (DP2A) {
      a2[r] = ((unsigned)(-2 * pix[r].x) & 0xffffu) |
              (unsigned)(-2 * pix[r].y) << 16;
      const long long t = (long long)gate -
                          ((long long)pix[r].x * pix[r].x +
                           (long long)pix[r].y * pix[r].y);
      thr[r] = (int)max(min(t, 1ll << 30), -(1ll << 30));
    } else {
      px[r] = pix[r].x;
      py[r] = pix[r].y;
    }
  }
  // the first 32 tiles' segments: lane i holds tile ta + i's bits
  const int nt = tz - ta;
  int st = 0, en = 0;
  if (lane < nt) {
    st = __ldg(starts + ta + lane);
    en = __ldg(starts + ta + lane + 1);
  }
  unsigned seg[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    seg[r] = seg_bits(r, max(st, lo) - lo, min(en, hi) - lo);

  // one tile's count for candidate c: written, or for a tile that crosses
  // a batch edge, added to its counter and written by the second part
  auto emit = [&](int c, int t, int st_t, int en_t, int cnt) {
    const size_t o = (size_t)(c0 + c) * n + t;
    if (st_t < lo || en_t > hi) {
      const int edge = st_t < lo ? b - 1 : b;
      const int old = atomicAdd(scratch + (size_t)(c0 + c) * nb + edge,
                                cnt + ARRIVED);
      if (old >= ARRIVED) out[o] = old - ARRIVED + cnt <= 3;
    } else {
      out[o] = cnt <= 3;
    }
  };

  for (int c = 0; c < kc; ++c) {
    const int4* q = pts + c * 64;
    const int m = npts[c];
    // with a pad point, a pixel violates only if it also lies past the pad
    const unsigned keep = haspad[c] ? padv : ~0u;
    unsigned v[R];
    if (DP2A) {
      int mn[R];                  // min over the points of d - |p|^2
#pragma unroll
      for (int r = 0; r < R; ++r) mn[r] = INT_MAX;
#pragma unroll 2
      for (int j = 0; j < m; j += 2) {
        const int4 u = q[j], w = q[j + 1];
#pragma unroll
        for (int r = 0; r < R; ++r)
          mn[r] = __vimin3_s32(mn[r], dp2a_su(a2[r], u.w, u.z),
                               dp2a_su(a2[r], w.w, w.z));
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        v[r] = __ballot_sync(0xffffffffu,
                             mn[r] > thr[r] && ((keep >> r) & 1u));
    } else {
      int mn[R];
#pragma unroll
      for (int r = 0; r < R; ++r) mn[r] = INT_MAX;
      for (int j = 0; j < m; ++j) {
        const int4 u = q[j];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int dx = px[r] - u.x, dy = py[r] - u.y;
          mn[r] = min(mn[r], dx * dx + dy * dy);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        v[r] = __ballot_sync(0xffffffffu,
                             mn[r] > gate && ((keep >> r) & 1u));
    }
    if (lane < nt) {
      int cnt = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) cnt += __popc(v[r] & seg[r]);
      emit(c, ta + lane, st, en, cnt);
    }
    // tiles past the first 32 (a batch of tiles with few counted pixels,
    // or of tiles with none)
    for (int i = lane + 32; i < nt; i += 32) {
      const int st_t = __ldg(starts + ta + i);
      const int en_t = __ldg(starts + ta + i + 1);
      const int s0 = max(st_t, lo) - lo, s1 = min(en_t, hi) - lo;
      int cnt = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) cnt += __popc(v[r] & seg_bits(r, s0, s1));
      emit(c, ta + i, st_t, en_t, cnt);
    }
  }
}

// grid (ceil(nb / WARPS2), ceil(k / KC2)); warp w of block x takes batch
// b = x * WARPS2 + w, slots [b * CAP, min((b + 1) * CAP, total)) of the
// stream of counted pixels, and the tiles that start there (tfirst[b] ..
// tfirst[b + 1] - 1) with the one that runs into it from batch b - 1.
__global__ void __launch_bounds__(WARPS2 * 32)
covers2d_kernel(const int2* __restrict__ cands,
                const uint8_t* __restrict__ cmask,
                const int2* __restrict__ tiles,
                const uint8_t* __restrict__ tmask,
                const int* __restrict__ starts,
                const int* __restrict__ tfirst, int k, int n, int gate,
                int nb, int* __restrict__ scratch,
                uint8_t* __restrict__ out) {
  __shared__ int4 pts[KC2 * 64];   // (x, y, x^2 + y^2, x | y << 8)
  __shared__ int npts[KC2];       // points staged per candidate (even)
  __shared__ int haspad[KC2];
  const long long total = __ldg(starts + n);
  const int b0 = blockIdx.x * WARPS2;
  if ((long long)b0 * CAP > total) return;   // no batch of this block
  const int c0 = blockIdx.y * KC2;
  const int kc = min(KC2, k - c0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // warp w stages candidates w, w + WARPS2, ...: the live points packed to
  // the front in order (a lane's slot is the live lanes below it)
  bool small = true;
  for (int c = warp; c < kc; c += WARPS2) {
    int live_n = 0;
    for (int h = 0; h < 64; h += 32) {
      const size_t g = (size_t)(c0 + c) * 64 + h + lane;
      const bool live = __ldg(cmask + g) != 0;
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (live) {
        const int2 p = __ldg(cands + g);
        const bool fit = (unsigned)p.x <= PT_MAX && (unsigned)p.y <= PT_MAX;
        small = small && fit;
        pts[c * 64 + live_n + __popc(m & ((1u << lane) - 1))] =
            fit ? make_int4(p.x, p.y, p.x * p.x + p.y * p.y, p.x | p.y << 8)
                : make_int4(p.x, p.y, 0, 0);
      }
      live_n += __popc(m);
    }
    __syncwarp();
    if (lane == 0) {
      if (live_n & 1) pts[c * 64 + live_n] = pts[c * 64];
      npts[c] = (live_n + 1) & ~1;
      haspad[c] = live_n < 64;
    }
  }
  small = __syncthreads_and(small);
  const int b = b0 + warp;
  const long long lo = (long long)b * CAP;
  if (lo > total) return;
  const int hi = (int)min(lo + CAP, total);
  // the batch's tiles: tfirst[b] .. tz - 1 start in it, and the one
  // before them runs into it when it ends past lo
  int ta = __ldg(tfirst + b);
  const int tz = __ldg(tfirst + b + 1);
  if (ta > 0 && __ldg(starts + ta) > lo) --ta;
  // this lane's slots r * 32 + lane: slot s is the (s - starts[t])-th
  // counted pixel of the tile t that holds it. The batch's tiles are taken
  // 32 at a time, a tile a lane (its start, length and 64-slot mask,
  // loaded at once); a slot finds its tile by a binary search over the
  // lanes' starts and its pixel by its rank in the mask. Slots past hi
  // lie in no tile and hold (0, 0).
  int2 pix[R];
#pragma unroll
  for (int r = 0; r < R; ++r) pix[r] = make_int2(0, 0);
  for (int g = ta; g < tz; g += 32) {
    int st = INT_MAX, len = 0;
    unsigned m[2] = {0u, 0u};
    if (g + lane < tz) {
      const int t = g + lane;
      st = __ldg(starts + t);
      len = __ldg(starts + t + 1) - st;
      const uint4* w = reinterpret_cast<const uint4*>(tmask + (size_t)t * 64);
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const uint4 v = __ldg(w + h);
        m[h >> 1] |= (byte_bits(v.x) | byte_bits(v.y) << 4 |
                      byte_bits(v.z) << 8 | byte_bits(v.w) << 12)
                     << (16 * (h & 1));
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = (int)lo + r * 32 + lane;
      int i = 0;          // the last tile of the group starting at or before s
#pragma unroll
      for (int step = 16; step; step >>= 1)
        if (__shfl_sync(0xffffffffu, st, i + step) <= s) i += step;
      const int j = s - __shfl_sync(0xffffffffu, st, i);
      const int tl = __shfl_sync(0xffffffffu, len, i);
      const unsigned m0 = __shfl_sync(0xffffffffu, m[0], i);
      const unsigned m1 = __shfl_sync(0xffffffffu, m[1], i);
      if (j >= 0 && j < tl) {
        const int n0 = __popc(m0);
        pix[r] = __ldg(tiles + (size_t)(g + i) * 64 +
                       (j < n0 ? nth_bit(m0, j) : 32 + nth_bit(m1, j - n0)));
      }
    }
  }
  bool fit = true;
#pragma unroll
  for (int r = 0; r < R; ++r)
    fit = fit && (unsigned)pix[r].x <= PX_MAX && (unsigned)pix[r].y <= PX_MAX;
  if (__all_sync(0xffffffffu, fit) && small)
    batch2d<true>(pts, npts, haspad, pix, starts, b, (int)lo, hi, ta, tz,
                  c0, kc, n, gate, nb, scratch, out);
  else
    batch2d<false>(pts, npts, haspad, pix, starts, b, (int)lo, hi, ta, tz,
                   c0, kc, n, gate, nb, scratch, out);
}

}  // namespace

// cands [k, 64, 3] i32, tiles [n, 64, 3] i32; out [k, n] u8 (0/1).
// k <= 65535 * KC.
extern "C" int yaik_covers(const int* cands, const int* tiles, int k, int n,
                           int gate, uint8_t* out, cudaStream_t stream) {
  if (k < 0 || n < 0 || (k + KC - 1) / KC > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k > 0 && n > 0) {
    const dim3 blocks((unsigned)((n + TPB - 1) / TPB),
                      (unsigned)((k + KC - 1) / KC));
    covers3d_kernel<<<blocks, WARPS * 32, 0, stream>>>(cands, tiles, k, n,
                                                       gate, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// cands [k, 64, 2] i32 with cmask [k, 64] u8, tiles [n, 64, 2] i32 with
// tmask [n, 64] u8; the batch plan of kernels.covers2d_plan: starts
// [n + 1] i32 (tile t's counted pixels are the stream's slots starts[t] ..
// starts[t + 1] - 1, total = starts[n]), tfirst [nb + 1] i32 (the first
// tile t with starts[t] >= b * cap) with nb = n * 64 / cap + 1 and cap the
// kernel's CAP; scratch [k, nb] i32 zeroed; out [k, n] u8 (0/1).
extern "C" int yaik_covers2d(const int* cands, const uint8_t* cmask,
                             const int* tiles, const uint8_t* tmask,
                             const int* starts, const int* tfirst,
                             int* scratch, int k, int n, int nb, int cap,
                             int gate, uint8_t* out, cudaStream_t stream) {
  if (k < 0 || n < 0 || cap != CAP || nb != (long long)n * 64 / CAP + 1 ||
      (k + KC2 - 1) / KC2 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k > 0 && n > 0) {
    const dim3 blocks((unsigned)((nb + WARPS2 - 1) / WARPS2),
                      (unsigned)((k + KC2 - 1) / KC2));
    covers2d_kernel<<<blocks, WARPS2 * 32, 0, stream>>>(
        reinterpret_cast<const int2*>(cands), cmask,
        reinterpret_cast<const int2*>(tiles), tmask, starts, tfirst, k, n,
        gate, nb, scratch, out);
  }
  return static_cast<int>(cudaGetLastError());
}
