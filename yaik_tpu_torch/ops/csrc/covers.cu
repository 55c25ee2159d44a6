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
// The arithmetic is int32 and exact: coordinates lie in 0..4096, so a
// squared distance is at most 3 * 4096^2 < 2^31.
//
// Bound on the H100: operations. k * n * 64 px * 64 pt distances, each 9
// int32 operations in 3D (3 sub, 3 mul, 2 add, 1 min) and 6 in 2D, against
// k*64*3 + n*64*3 input words and k*n output bytes: about 6 * 10^4
// operations per byte moved. Design: a block stages a chunk of KC
// candidates in shared memory (one 16-byte word per point, read as a
// broadcast: every lane of a warp reads the same point); each warp takes
// one tile at a time, two pixels a lane held in registers, and for each
// candidate of the chunk takes both pixels' mins over its points, counts
// the violations with __ballot_sync / __popc and writes one byte.
// A 2D candidate's live points are staged first, in order, then one pad
// point if it has any (all pad points are equal, so one stands for them),
// and the min runs over those alone: the same min as over all 64.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KC = 32;            // candidates staged per block
constexpr int WARPS = 8;          // warps per block
constexpr int TILES_PER_WARP = 8;  // tiles each warp walks per block
constexpr int TPB = WARPS * TILES_PER_WARP;
constexpr int PAD = 4096;         // a 2D candidate's pad point coordinate

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
covers_kernel(const int* __restrict__ cands, const uint8_t* __restrict__ cmask,
              const int* __restrict__ tiles, const uint8_t* __restrict__ tmask,
              int k, int n, int gate, uint8_t* __restrict__ out) {
  __shared__ int4 pts[KC * 64];
  __shared__ int npts[KC];        // points staged per candidate
  const int c0 = blockIdx.y * KC;
  const int kc = min(KC, k - c0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // warp w stages candidates w, w + WARPS, ...: the live points packed to
  // the front in order (a lane's slot is the live lanes below it), then
  // one pad point where any point is a pad
  for (int c = warp; c < kc; c += WARPS) {
    int live_n = 0;
    for (int h = 0; h < 64; h += 32) {
      const size_t g = (size_t)(c0 + c) * 64 + h + lane;
      const bool live = cmask == nullptr || __ldg(cmask + g) != 0;
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (live) {
        const int* s = cands + g * D;
        pts[c * 64 + live_n + __popc(m & ((1u << lane) - 1))] =
            make_int4(__ldg(s), __ldg(s + 1), D == 3 ? __ldg(s + 2) : 0, 0);
      }
      live_n += __popc(m);
    }
    if (lane == 0) {
      if (live_n < 64) pts[c * 64 + live_n] = make_int4(PAD, PAD, 0, 0);
      npts[c] = min(live_n + 1, 64);
    }
  }
  __syncthreads();
  const int t_end = min(n, (int)(blockIdx.x + 1) * TPB);
  for (int t = blockIdx.x * TPB + warp; t < t_end; t += WARPS) {
    const size_t p0 = (size_t)t * 64 + lane, p1 = p0 + 32;
    const int* a = tiles + p0 * D;
    const int* b = tiles + p1 * D;
    const int ax = __ldg(a), ay = __ldg(a + 1), az = D == 3 ? __ldg(a + 2) : 0;
    const int bx = __ldg(b), by = __ldg(b + 1), bz = D == 3 ? __ldg(b + 2) : 0;
    const bool va = tmask == nullptr || __ldg(tmask + p0) != 0;
    const bool vb = tmask == nullptr || __ldg(tmask + p1) != 0;
    for (int c = 0; c < kc; ++c) {
      const int4* q = pts + c * 64;
      const int m = D == 3 ? 64 : npts[c];   // 3D: no pad, a fixed trip
      int ma = 0x7fffffff, mb = 0x7fffffff;
#pragma unroll 8
      for (int j = 0; j < m; ++j) {
        const int4 v = q[j];
        const int dax = ax - v.x, day = ay - v.y;
        const int dbx = bx - v.x, dby = by - v.y;
        int da = dax * dax + day * day, db = dbx * dbx + dby * dby;
        if (D == 3) {
          const int daz = az - v.z, dbz = bz - v.z;
          da += daz * daz;
          db += dbz * dbz;
        }
        ma = min(ma, da);
        mb = min(mb, db);
      }
      const unsigned ba = __ballot_sync(0xffffffffu, va && ma > gate);
      const unsigned bb = __ballot_sync(0xffffffffu, vb && mb > gate);
      if (lane == 0)
        out[(size_t)(c0 + c) * n + t] = (__popc(ba) + __popc(bb)) <= 3;
    }
  }
}

}  // namespace

// cands [k, 64, D] i32, cmask [k, 64] u8 or null (2D only), tiles
// [n, 64, D] i32, tmask [n, 64] u8 or null (2D only), D 2 or 3; out [k, n]
// u8 (0/1). k <= 65535 * KC.
extern "C" int yaik_covers(const int* cands, const uint8_t* cmask,
                           const int* tiles, const uint8_t* tmask, int D,
                           int k, int n, int gate, uint8_t* out,
                           cudaStream_t stream) {
  if ((D != 2 && D != 3) || k < 0 || n < 0 ||
      (k + KC - 1) / KC > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k > 0 && n > 0) {
    const dim3 blocks((unsigned)((n + TPB - 1) / TPB),
                      (unsigned)((k + KC - 1) / KC));
    if (D == 3)
      covers_kernel<3><<<blocks, WARPS * 32, 0, stream>>>(
          cands, cmask, tiles, tmask, k, n, gate, out);
    else
      covers_kernel<2><<<blocks, WARPS * 32, 0, stream>>>(
          cands, cmask, tiles, tmask, k, n, gate, out);
  }
  return static_cast<int>(cudaGetLastError());
}
