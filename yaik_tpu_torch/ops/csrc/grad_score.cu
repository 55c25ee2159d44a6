// The encoder's gradient stage: the 7 gradient passes in one launch.
//
// Replaces yaik_tpu/encoder/jax_scoring.py `gradient_all_device` (:112), an
// XLA program on the TPU (no Pallas kernel), as `yaik_grad_score`. For each
// pass (sx, sy) of swizzle.GRADIENT_PASS_ORDER, in order, a tile of
// tw x th = (1<<sx) x (1<<sy) pixels is ok when, for one of the 6 blends
// {corners, round6, round6p} x {(num + ROUNDING) >> 20, num >> 20} of its
// four corners (the corner grid clamped at w-1 and h-1), every pixel is
// within `rf` of the blend in all 3 channels; it is accepted when ok and no
// channel of claims is set at its origin; an accepted tile's pixels are set
// in all 3 channels of claims before the next pass.
//
// Two facts make the stage a per-block computation. `ok` reads the planes
// only: just the origin test reads claims. And every tile size divides 16
// and every origin is a multiple of its tile's size, so every tile of every
// pass lies inside one 16x16 block aligned to 16 (at most 1+2+2+4+8+8+16 =
// 41 tiles), and claims set by a pass reach only later tiles of the same
// block. Every origin and every corner sits on the block's 4-pixel lattice
// (corners at 0, 4, .., 16 in each axis, 16 being the next block's first
// row or column), and a tile covers whole 4x4 cells of it, so the claims
// the stage reads and writes are a 16-bit mask of those cells.
//
// The arithmetic. Each blend test is a range check: for a pixel p and
// 0 <= rf <= 255, |(n >> 20) - p| <= rf holds exactly when x = n - ((p -
// rf) << 20) lies in [0, span), span = (2 rf + 1) << 20; the rounding
// blend's test is x in [-ROUNDING, span - ROUNDING) (n >= 0, and >> 20
// floors). A tile passes a blend when every pixel and channel does, so a
// lane needs only the least and the greatest x of its pixels, two range
// checks per blend. The numerator steps down a column: with wy = 1024 >>
// sy, num(iy) = top * 1024 + iy * wy * (bot - top), the JAX function's
// products regrouped, so the same integer; a lane takes the least and
// greatest of r * step + (rf - p_r) << 20 over its rows r and adds num(first
// row) to both.
//
// Bound on the H100: int32 operations. Per (pixel, channel, pass, variant)
// 4 (the step, the add of the pixel's term, a min and a max); at 3840x2160
// 2.09e9 (0.062 ms at 33.5 TOP/s) against ~150 MB (12 bytes of planes per
// pixel read once, the claims read at the cell origins and written where
// accepted, ~0.1 accept byte a pixel: 0.045 ms at 3.35 TB/s). Every
// per-pixel value stays in registers.
//
// One warp per (16x16 block, image), kWarps independent warps per CTA, no
// CTA barrier and no atomic:
// - a lane owns column lane & 15 of the block and rows 8 * (lane >> 4) to
//   +7 (a half-warp loads 16 consecutive i32 of a row), and keeps (rf - p)
//   << 20 of its 8 pixels' 3 channels in registers;
// - the block's 5x5 corner lattice, clamped at w-1 and h-1, in its three
//   variants (raw, round6, round6p) and three channels, sits in the warp's
//   own slice of shared memory behind __syncwarp; claims at the 16 cell
//   origins (any channel) become a bit mask by one ballot;
// - per pass, a lane computes top and bot once per (tile row of its rows,
//   variant, channel) from the lattice and steps down its rows (a lane
//   holds one tile row, or two where th = 4); each of the 6 blend tests of
//   a tile is one ballot ANDed over the tile's lanes (its tw columns in one
//   half, both halves where th = 16);
// - the same warp resolves the pass on the cell mask: accept = ok and the
//   origin's cell unclaimed, the accepted tiles' cells ORed into the mask by
//   __reduce_or_sync before the next pass; a tile's left lane in its top
//   half writes its accept byte at its index in the packed [B, G] accepts
//   (pass p's grid at offset sum of the earlier passes' (h>>sy)*(w>>sx), row
//   major);
// - last, each lane writes 1 into the 3 channels of claims of its pixels
//   whose cell was accepted (in place; nothing else of claims is written).
// Pixels outside every pass's grid (h % 16 or w % 16 not 0, a band's halo
// row) are never claimed, as in the JAX function.
//
// Integer arithmetic throughout: the planes hold 0..255 (the wrapper's
// precondition), so a numerator lies in 0..255 * 2^20, every x in (-2^29,
// 2^29) and every r * step + (rf - p) << 20 in (-2^30, 2^30). rf is clamped
// to [-1, 255] by the wrapper, which is exact (blends and pixels lie in
// 0..255); rf = -1 gives span 0, so no blend is ok. A batch is grid row
// blockIdx.y with 64-bit per-image bases.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRounding = (1 << 19) - 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;  // 16x16 blocks per CTA, a warp each

__device__ __forceinline__ int round6(int v) {
  const int r = v >> 2;
  return (r << 2) | (r >> 4);
}

// true when `pred` holds in every lane of `lanes`
__device__ __forceinline__ bool tile_all(bool pred, unsigned lanes) {
  return (__ballot_sync(kFull, pred) & lanes) == lanes;
}

// What a warp keeps of its block while it scores it.
struct Block {
  int (*lat)[5][5];  // the corner lattice [3 * variant + channel][row][col]
  uint8_t* accepts;  // the image's packed accepts
  long long off;     // the pass's offset in them
  int lane, x0, y0, h, w, span;
  unsigned claimed;  // the block's claimed cells
  unsigned covered;  // the cells the stage accepts
};

// One pass, tiles of (1 << SX) x (1 << SY), for the warp's block. nlo:
// (rf - p) << 20 of the lane's pixels [channel][row].
template <int SX, int SY>
__device__ __forceinline__ void run_pass(Block& k, const int (&nlo)[3][8]) {
  constexpr int TW = 1 << SX, TH = 1 << SY;
  constexpr int NSEG = TH == 4 ? 2 : 1;  // tile rows among a lane's 8 rows
  constexpr int ROWS = 8 / NSEG;
  // the cell rows a tile covers, as a mask of one cell column repeated
  constexpr unsigned REP = TH == 16 ? 0x1111u : TH == 8 ? 0x11u : 0x1u;
  const int lx = k.lane & 15, hy = k.lane >> 4;
  const int ox = lx & ~(TW - 1);
  const int rw = (lx - ox) * (1024 >> SX), lf = 1024 - rw;
  const int q0 = ox >> 2, q1 = (ox + TW) >> 2;
  const int ntx = k.w >> SX, nty = k.h >> SY;
  const int tx = (k.x0 >> SX) + (lx >> SX);
  const unsigned cols = (TW == 16 ? 0xFFFFu : (1u << TW) - 1) << ox;
  const unsigned lanes = TH == 16 ? cols | cols << 16 : cols << (16 * hy);
  unsigned mine = 0;
#pragma unroll
  for (int s = 0; s < NSEG; ++s) {
    const int row0 = 8 * hy + ROWS * s;  // the block row of its first pixel
    const int tr = row0 >> SY;           // the tile's row in the block
    const int r0 = (tr << SY) >> 2, r1 = r0 + (TH >> 2);
    bool ok = false;
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      int mn = 0x7fffffff, mx = -0x7fffffff - 1;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        int (*L)[5] = k.lat[3 * v + c];
        const int top = L[r0][q0] * lf + L[r0][q1] * rw;
        const int bot = L[r1][q0] * lf + L[r1][q1] * rw;
        const int step = (bot - top) * (1024 >> SY);
        // the numerator at the segment's first row (8 for the lower half
        // of a 16-row tile)
        const int num = top * 1024 + (TH == 16 ? 8 * hy * step : 0);
        // x(r) = num + r * step + nlo[r]; its least and greatest are num
        // plus those of y(r) = r * step + nlo[r]
        int lo = nlo[c][ROWS * s], hi = lo;
#pragma unroll
        for (int r = 1; r < ROWS; ++r) {
          const int y = nlo[c][ROWS * s + r] + r * step;
          lo = min(lo, y);
          hi = max(hi, y);
        }
        mn = min(mn, num + lo);
        mx = max(mx, num + hi);
      }
      ok |= tile_all(mn >= 0 && mx < k.span, lanes);
      ok |= tile_all(mn >= -kRounding && mx < k.span - kRounding, lanes);
    }
    const int ty = (k.y0 >> SY) + tr;
    const bool valid = tx < ntx && ty < nty;
    const bool acc = valid && ok && !((k.claimed >> (4 * r0 + q0)) & 1);
    if (acc) mine |= ((((1u << (TW >> 2)) - 1) << q0) * REP) << (4 * r0);
    if (valid && lx == ox && (TH < 16 || hy == 0))
      k.accepts[k.off + static_cast<long long>(ty) * ntx + tx] = acc ? 1 : 0;
  }
  const unsigned nw = __reduce_or_sync(kFull, mine);
  k.claimed |= nw;
  k.covered |= nw;
  k.off += static_cast<long long>(nty) * ntx;
}

__global__ void __launch_bounds__(32 * kWarps, 8)
grad_score_kernel(const int* __restrict__ planes, uint8_t* __restrict__ claims,
                  uint8_t* __restrict__ accepts, int h, int w, int nbx,
                  int nblk, long long G, int rf) {
  __shared__ int lats[kWarps][9][5][5];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int blk = blockIdx.x * kWarps + wid;
  if (blk >= nblk) return;  // the whole warp: no barrier follows
  const int x0 = (blk % nbx) * 16, y0 = (blk / nbx) * 16;
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t b = blockIdx.y;
  planes += b * 3 * plane;
  claims += b * 3 * plane;
  int (*lat)[5][5] = lats[wid];
  for (int t = lane; t < 75; t += 32) {  // the corner lattice, clamped
    const int c = t / 25, r = (t / 5) % 5, q = t % 5;
    const int y = min(y0 + 4 * r, h - 1), x = min(x0 + 4 * q, w - 1);
    const int v = __ldg(planes + c * plane + static_cast<size_t>(y) * w + x);
    lat[c][r][q] = v;
    lat[3 + c][r][q] = round6(v);
    lat[6 + c][r][q] = round6(min(v + 1, 255));
  }
  bool any = false;  // claims at the 16 cell origins, any channel
  if (lane < 16) {
    const int y = y0 + 4 * (lane >> 2), x = x0 + 4 * (lane & 3);
    if (y < h && x < w) {
      const size_t o = static_cast<size_t>(y) * w + x;
      any = claims[o] | claims[plane + o] | claims[2 * plane + o];
    }
  }
  Block k{lat, accepts + b * G, 0, lane, x0, y0, h, w,
          rf < 0 ? 0 : (2 * rf + 1) << 20, __ballot_sync(kFull, any), 0};
  const int lx = lane & 15, hy = lane >> 4;
  const int x = x0 + lx;
  int nlo[3][8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int y = y0 + 8 * hy + r;
    const bool inside = y < h && x < w;
    const size_t o = static_cast<size_t>(y) * w + x;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      nlo[c][r] = (rf - (inside ? __ldg(planes + c * plane + o) : 0)) *
                  (1 << 20);
  }
  __syncwarp();

  // swizzle.GRADIENT_PASS_ORDER
  run_pass<4, 4>(k, nlo);
  run_pass<4, 3>(k, nlo);
  run_pass<3, 4>(k, nlo);
  run_pass<3, 3>(k, nlo);
  run_pass<3, 2>(k, nlo);
  run_pass<2, 3>(k, nlo);
  run_pass<2, 2>(k, nlo);

  // claims in place, where a pixel's cell was accepted
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = 8 * hy + r;
    if ((k.covered >> (4 * (row >> 2) + (lx >> 2))) & 1) {
      const size_t o = static_cast<size_t>(y0 + row) * w + x;
      claims[o] = 1;
      claims[plane + o] = 1;
      claims[2 * plane + o] = 1;
    }
  }
}

}  // namespace

// planes [B, 3, h, w] i32 (values 0..255), claims [B, 3, h, w] bool (updated
// in place), accepts [B, G] u8 with G = sum over the passes of
// (h >> sy) * (w >> sx); rf is the reject factor, which the caller clamps to
// [-1, 255] (any other is refused). Returns cudaGetLastError().
extern "C" int yaik_grad_score(const int* planes, uint8_t* claims,
                               uint8_t* accepts, int B, int h, int w,
                               long long G, int rf, cudaStream_t stream) {
  if (B < 0 || B > 65535 || h < 0 || w < 0 || rf < -1 || rf > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nbx = (w + 15) / 16, nby = (h + 15) / 16;
  if (nbx * nby > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long nblk = nbx * nby;
  if (B == 0 || nblk == 0) return static_cast<int>(cudaGetLastError());
  const unsigned ctas = static_cast<unsigned>((nblk + kWarps - 1) / kWarps);
  grad_score_kernel<<<dim3(ctas, B), 32 * kWarps, 0, stream>>>(
      planes, claims, accepts, h, w, static_cast<int>(nbx),
      static_cast<int>(nblk), G, rf);
  return static_cast<int>(cudaGetLastError());
}
