// The earlier design of yaik_tpu_torch/ops/csrc/grad_score.cu, kept as it
// was so that a timing can set it beside the current kernel on one card:
// tests/torch_time_grad_score.py and chip_smoke.py build it alone with
// nvcc (same C interface, `yaik_grad_score`). It is not part of the port
// and no caller of the port reaches it.
//
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
// One CTA per (16x16 block, image); 256 threads, a pixel each:
// - staging: the block's 5x5 corner lattice, clamped at w-1 and h-1, in
//   its three variants (raw, round6, round6p) and three channels; input
//   claims at the 16 cell origins (any channel) into a bit mask;
// - phase 1: for each pass the thread tests its pixel against its tile's 6
//   blends (a 6-bit mask), ANDs the masks of its tile's lanes by warp
//   shuffles (a warp is two rows of 16 pixels and a tile has >= 4 rows, so
//   a tile's lanes in a warp are an aligned group of tw columns in both
//   rows), and one lane ANDs it into the tile's mask in shared memory;
// - phase 2: one warp resolves the 7 passes in order, a lane a tile: accept
//   = ok & !claimed(origin), the accepted tiles' cells ORed into the mask
//   by __reduce_or_sync; each tile's accept byte written at its index in
//   the packed [B, G] accepts (pass p's grid at offset sum of the earlier
//   passes' (h>>sy)*(w>>sx), row major);
// - phase 3: each thread whose cell was accepted writes 1 into its pixel's
//   3 channels of claims (in place; nothing else of claims is written).
// Pixels outside every pass's grid (h % 16 or w % 16 not 0, a band's halo
// row) are never claimed, as in the JAX function.
//
// Bound on the H100: operations. Per (pixel, channel, pass) the three
// bilinear numerators (18 multiply(-add)s), 3 rounding adds, 6 shifts and
// 6 subtract-and-compares, ~39 int32 operations, against 12 bytes of
// planes per pixel read once, the claims read at the cell origins and
// written where accepted, and ~0.1 accept byte a pixel: at 3840x2160 some
// 6.8e9 operations (0.20 ms at 33.5 TOP/s) against ~150 MB (0.045 ms at
// 3.35 TB/s). The design keeps all work in registers: a pixel's 3 values
// are loaded once, the corners are broadcast reads of shared memory, and
// no per-pass, per-variant or per-blend array is ever written (the torch
// version builds [B, 3, nty, ntx, th, tw] temporaries for each of the 6
// blends of each pass).
//
// Integer arithmetic throughout: the planes hold 0..255 (the wrapper's
// precondition), so a blend's numerator peaks at 255 * 2^20 + 2^19 < 2^31.
// A batch is grid row blockIdx.y with 64-bit per-image bases.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRounding = (1 << 19) - 1;
constexpr unsigned kFull = 0xffffffffu;

// swizzle.GRADIENT_PASS_ORDER: (4,4) (4,3) (3,4) (3,3) (3,2) (2,3) (2,2)
__host__ __device__ constexpr int pass_sx(int p) {
  return p < 2 ? 4 : p < 5 ? 3 : 2;
}
__host__ __device__ constexpr int pass_sy(int p) {
  return (p == 0 || p == 2) ? 4 : (p == 4 || p == 6) ? 2 : 3;
}

__device__ __forceinline__ int round6(int v) {
  const int r = v >> 2;
  return (r << 2) | (r >> 4);
}

__global__ void __launch_bounds__(256)
grad_score_kernel(const int* __restrict__ planes, uint8_t* __restrict__ claims,
                  uint8_t* __restrict__ accepts, int h, int w, int nbx,
                  long long G, int rf) {
  __shared__ int corner[3][3][5][5];   // [variant][channel][row][col]
  __shared__ unsigned tile_ok[7][16];  // per pass and tile: 6 blend bits
  __shared__ unsigned claimed_in;      // cells claimed on entry (any channel)
  __shared__ unsigned covered;         // cells the 7 passes accept

  const int t = threadIdx.x;
  const int ly = t >> 4, lx = t & 15;
  const int x0 = (blockIdx.x % nbx) * 16, y0 = (blockIdx.x / nbx) * 16;
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t b = blockIdx.y;
  planes += b * 3 * plane;
  claims += b * 3 * plane;
  accepts += b * G;

  if (t < 75) {                         // the corner lattice, clamped
    const int c = t / 25, r = (t / 5) % 5, q = t % 5;
    const int y = min(y0 + 4 * r, h - 1), x = min(x0 + 4 * q, w - 1);
    const int v = __ldg(planes + c * plane + static_cast<size_t>(y) * w + x);
    corner[0][c][r][q] = v;
    corner[1][c][r][q] = round6(v);
    corner[2][c][r][q] = round6(min(v + 1, 255));
  }
  if (t >= 96 && t < 96 + 7 * 16) tile_ok[(t - 96) >> 4][t & 15] = 0x3F;
  if (t >= 224) {                       // warp 7: claims at the cell origins
    const int cell = t - 224;
    const int y = y0 + 4 * (cell >> 2), x = x0 + 4 * (cell & 3);
    bool any = false;
    if (cell < 16 && y < h && x < w) {
      const size_t o = static_cast<size_t>(y) * w + x;
      any = claims[o] | claims[plane + o] | claims[2 * plane + o];
    }
    const unsigned m = __ballot_sync(kFull, any);
    if (cell == 0) claimed_in = m & 0xFFFF;
  }
  const int y = y0 + ly, x = x0 + lx;
  const bool inside = y < h && x < w;
  int px[3] = {0, 0, 0};
  if (inside) {
    const size_t o = static_cast<size_t>(y) * w + x;
#pragma unroll
    for (int c = 0; c < 3; ++c) px[c] = __ldg(planes + c * plane + o);
  }
  __syncthreads();

  // phase 1: each pass's per-tile blend masks
#pragma unroll
  for (int p = 0; p < 7; ++p) {
    const int sx = pass_sx(p), sy = pass_sy(p);
    const int tw = 1 << sx, th = 1 << sy;
    const int ox = lx & ~(tw - 1), oy = ly & ~(th - 1);
    const bool valid = ((x0 + ox) >> sx) < (w >> sx) &&
                       ((y0 + oy) >> sy) < (h >> sy);
    unsigned m = 0x3F;
    if (valid) {
      const int ix = lx - ox, iy = ly - oy;
      const int lf = 1024 - ix * (1024 >> sx), rw = 1024 - lf;
      const int tf = 1024 - iy * (1024 >> sy), bw = 1024 - tf;
      const int r0 = oy >> 2, r1 = (oy + th) >> 2;
      const int q0 = ox >> 2, q1 = (ox + tw) >> 2;
#pragma unroll
      for (int v = 0; v < 3; ++v) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int top = corner[v][c][r0][q0] * lf + corner[v][c][r0][q1] * rw;
          const int bot = corner[v][c][r1][q0] * lf + corner[v][c][r1][q1] * rw;
          const int num = top * tf + bot * bw;
          if (abs(((num + kRounding) >> 20) - px[c]) > rf) m &= ~(1u << (2 * v));
          if (abs((num >> 20) - px[c]) > rf) m &= ~(2u << (2 * v));
        }
      }
    }
#pragma unroll
    for (int o = 1; o < tw; o <<= 1) m &= __shfl_xor_sync(kFull, m, o);
    m &= __shfl_xor_sync(kFull, m, 16);
    if (valid && lx == ox && (ly & 1) == 0)
      atomicAnd(&tile_ok[p][(ly >> sy) * (16 >> sx) + (lx >> sx)], m);
  }
  __syncthreads();

  // phase 2: the passes in order on the block's cells, a lane a tile
  if (t < 32) {
    unsigned claimed = claimed_in, cov = 0;
    long long off = 0;
#pragma unroll
    for (int p = 0; p < 7; ++p) {
      const int sx = pass_sx(p), sy = pass_sy(p);
      const int ncol = 16 >> sx, nrow = 16 >> sy;
      const int ntx = w >> sx, nty = h >> sy;
      const int row = t / ncol, col = t % ncol;
      const int tx = (x0 >> sx) + col, ty = (y0 >> sy) + row;
      const bool valid = t < ncol * nrow && tx < ntx && ty < nty;
      // the tile's cells: (th/4) rows of (tw/4) cells from its origin's
      const int cr = (row << sy) >> 2, cc = (col << sx) >> 2;
      unsigned rect = 0;
#pragma unroll
      for (int k = 0; k < (1 << sy) >> 2; ++k)
        rect |= ((1u << ((1 << sx) >> 2)) - 1) << (4 * (cr + k) + cc);
      const bool acc = valid && tile_ok[p][t & 15] != 0 &&
                       !((claimed >> (4 * cr + cc)) & 1);
      const unsigned nw = __reduce_or_sync(kFull, acc ? rect : 0u);
      claimed |= nw;
      cov |= nw;
      if (valid)
        accepts[off + static_cast<long long>(ty) * ntx + tx] = acc ? 1 : 0;
      off += static_cast<long long>(nty) * ntx;
    }
    if (t == 0) covered = cov;
  }
  __syncthreads();

  // phase 3: claims in place, where a pixel's cell was accepted
  if (inside && ((covered >> (4 * (ly >> 2) + (lx >> 2))) & 1)) {
    const size_t o = static_cast<size_t>(y) * w + x;
    claims[o] = 1;
    claims[plane + o] = 1;
    claims[2 * plane + o] = 1;
  }
}

}  // namespace

// planes [B, 3, h, w] i32 (values 0..255), claims [B, 3, h, w] bool (updated
// in place), accepts [B, G] u8 with G = sum over the passes of
// (h >> sy) * (w >> sx); rf is the reject factor. Returns cudaGetLastError().
extern "C" int yaik_grad_score(const int* planes, uint8_t* claims,
                               uint8_t* accepts, int B, int h, int w,
                               long long G, int rf, cudaStream_t stream) {
  if (B < 0 || B > 65535 || h < 0 || w < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nbx = (w + 15) / 16, nby = (h + 15) / 16;
  if (nbx * nby > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0 && nbx * nby > 0) {
    grad_score_kernel<<<dim3(static_cast<unsigned>(nbx * nby), B), 256, 0,
                        stream>>>(planes, claims, accepts, h, w,
                                  static_cast<int>(nbx), G, rf);
  }
  return static_cast<int>(cudaGetLastError());
}
