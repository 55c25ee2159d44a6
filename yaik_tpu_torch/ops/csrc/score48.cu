// Encoder 48-pattern tile scoring, and its pattern argmin.
//
// Replaces yaik_tpu/ops/pallas_kernels.py `score48` and its XLA twin
// yaik_tpu/encoder/jax_scoring.py `tile3d_score_device`:
//
//   sums[t, e, n] = sum over alive pixels p of min_k |c[t,p] - q[e,n,k]|^2
//
// with c [T, P, 3] i32 scoring coordinates in 0..63, alive [T, P] u8 and
// q = qpts [E, 48, 8, 3] i32 (each LUT's 8 scoring points in each pattern's
// frame). The mode form also replaces the `jnp.argmin(sums, -1)` that
// follows it (jax_scoring.py:354): it writes mode48 [T, E] i32, the first
// pattern of least sum, and never stores the sums.
//
// Design. One CTA owns a group of 1024 pixels (1024 / P whole tiles). It
// stages the group's ALIVE pixels only, compacted in order by a block-wide
// prefix sum (warp ballots; a thread loads its alive flags of every round
// before the one barrier), with each tile's start in the compacted list;
// a dead pixel costs one byte load. The threads then sweep the (e, n)
// pairs four LUTs at a time, thread = (e0 + tid / 48, tid % 48), holding
// the pair's 8 points in registers and looping over each tile's alive
// pixels (broadcast reads of shared memory). A tile with no alive pixel
// costs no distance work: its sums are 0, and the mode form, which loops
// over a list of the group's live tiles, writes its mode 0. The mode form
// takes the first minimum through a shared atomicMin of the packed key
// (sum << 6) | n (sum < 512 * 3 * 63^2 < 2^23, so the key fits 29 bits):
// the least key is the least sum with the least n, whatever the order of
// the atomics, so the result is deterministic. The sums form writes each
// sum from the one thread that owns it.
//
// Bound on the H100: arithmetic on the alive pixels. A pixel costs E*48*8
// point distances, each 3 FMAs and a min in the expanded form
// |c|^2 + (|q|^2 - 2 c.q). Exact in float32: every operand and partial sum
// is an integer below 2^24 (|c|^2, |q|^2 <= 3*63^2, |2 c.q| <= 6*63^2), so
// the float result equals the integer one. The sum over a tile runs in int.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 192;                  // 4 LUTs x 48 patterns
constexpr int kWarps = kThreads / 32;
constexpr int kSweep = kThreads / 48;          // LUTs per sweep
constexpr int kGroupPx = 1024;                 // pixels per CTA; P divides it
constexpr int kRounds = (kGroupPx + kThreads - 1) / kThreads;  // of staging

template <bool kMode>
__global__ void __launch_bounds__(kThreads)
score48_kernel(const int* __restrict__ c, const uint8_t* __restrict__ alive,
               const int* __restrict__ qpts, long long T, int P, int E,
               int* __restrict__ out) {
  __shared__ float4 px[kGroupPx];       // alive pixels: x, y, z, |c|^2
  __shared__ int start[kGroupPx + 1];   // tile t: px[start[t] .. start[t+1])
  __shared__ int live[kMode ? kGroupPx : 1];   // tiles with an alive pixel
  __shared__ int key[kMode ? kGroupPx * kSweep : 1];   // (t, LUT of sweep)
  __shared__ int wcnt[kRounds][kWarps];
  __shared__ int nlive;
  const int tpg = kGroupPx / P;
  const long long t0 = (long long)blockIdx.x * tpg;
  const int nt = (int)min((long long)tpg, T - t0);
  const int npx = nt * P;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // stage the alive pixels, compacted in order: the thread's alive flags
  // of every round load together, one barrier publishes the rounds' warp
  // counts, and each alive pixel lands at its prefix-sum slot
  unsigned flags = 0;                   // bit r: pixel r * kThreads + tid
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = r * kThreads + threadIdx.x;
    if (i < npx && __ldg(alive + t0 * P + i) != 0) flags |= 1u << r;
  }
  unsigned bal[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    bal[r] = __ballot_sync(0xffffffffu, (flags >> r) & 1u);
    if (lane == 0) wcnt[r][warp] = __popc(bal[r]);
  }
  __syncthreads();
  int base = 0;                         // alive pixels before this round
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = r * kThreads + threadIdx.x;
    int before = base + __popc(bal[r] & ((1u << lane) - 1u));
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? wcnt[r][w] : 0;
      base += wcnt[r][w];
    }
    if (i < npx && (i & (P - 1)) == 0) start[i / P] = before;
    if ((flags >> r) & 1u) {
      const long long g = t0 * P + i;
      const float x = (float)__ldg(c + g * 3),
                  y = (float)__ldg(c + g * 3 + 1),
                  z = (float)__ldg(c + g * 3 + 2);
      px[before] = make_float4(x, y, z, x * x + y * y + z * z);
    }
  }
  if (threadIdx.x == 0) start[nt] = base;
  __syncthreads();
  if (kMode && warp == 0) {             // the live tiles, in order
    int k = 0;
    for (int t = lane; t < ((nt + 31) & ~31); t += 32) {
      const bool on = t < nt && start[t + 1] > start[t];
      const unsigned b = __ballot_sync(0xffffffffu, on);
      if (on) live[k + __popc(b & ((1u << lane) - 1u))] = t;
      k += __popc(b);
    }
    if (lane == 0) nlive = k;
  }
  __syncthreads();

  // the mode form visits the live tiles only; the sums form writes every
  // tile's sums (0 for a tile with no alive pixel)
  const int J = E * 48, n = threadIdx.x % 48, slot = threadIdx.x / 48;
  const int ntv = kMode ? nlive : nt;
  for (int e0 = 0; e0 < E; e0 += kSweep) {
    const int e = e0 + slot;
    const int j = e0 * 48 + threadIdx.x;          // = e * 48 + n
    if (kMode) {
      for (int i = threadIdx.x; i < ntv * kSweep; i += kThreads)
        key[live[i / kSweep] * kSweep + i % kSweep] = INT_MAX;
      __syncthreads();
    }
    if (e < E) {
      float qx[8], qy[8], qz[8], q2[8];
      if (base > 0) {
        const int* q = qpts + (size_t)j * 24;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float a = (float)__ldg(q + 3 * k),
                      b = (float)__ldg(q + 3 * k + 1),
                      d = (float)__ldg(q + 3 * k + 2);
          qx[k] = -2.f * a;
          qy[k] = -2.f * b;
          qz[k] = -2.f * d;
          q2[k] = a * a + b * b + d * d;
        }
      }
      for (int l = 0; l < ntv; ++l) {
        const int t = kMode ? live[l] : l;
        const int p0 = start[t], p1 = start[t + 1];
        int s = 0;
        for (int p = p0; p < p1; ++p) {
          const float4 v = px[p];              // a broadcast: warp-uniform
          float m = fmaf(v.x, qx[0], fmaf(v.y, qy[0], fmaf(v.z, qz[0], q2[0])));
#pragma unroll
          for (int k = 1; k < 8; ++k)
            m = fminf(m, fmaf(v.x, qx[k], fmaf(v.y, qy[k],
                                                fmaf(v.z, qz[k], q2[k]))));
          s += (int)(m + v.w);
        }
        if (kMode)
          atomicMin(&key[t * kSweep + slot], (s << 6) | n);
        else
          out[(size_t)(t0 + t) * J + j] = s;
      }
    }
    if (kMode) {
      __syncthreads();
      for (int i = threadIdx.x; i < nt * kSweep; i += kThreads) {
        const int t = i / kSweep, ei = e0 + i % kSweep;
        if (ei < E)
          out[(size_t)(t0 + t) * E + ei] =
              start[t + 1] > start[t] ? key[i] & 63 : 0;
      }
      __syncthreads();                  // key is reset by the next sweep
    }
  }
}

template <bool kMode>
int launch(const int* c, const uint8_t* alive, const int* qpts, long long T,
           int P, int E, int* out, cudaStream_t stream) {
  if (T > 0 && E > 0) {
    const long long tpg = kGroupPx / P;
    const unsigned blocks = (unsigned)((T + tpg - 1) / tpg);
    score48_kernel<kMode><<<blocks, kThreads, 0, stream>>>(c, alive, qpts, T,
                                                           P, E, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// c [T, P, 3] i32, alive [T, P] u8, qpts [E, 48, 8, 3] i32,
// out [T, E, 48] i32. P is a power of two <= 512.
extern "C" int yaik_score48(const int* c, const uint8_t* alive,
                            const int* qpts, long long T, int P, int E,
                            int* out, cudaStream_t stream) {
  return launch<false>(c, alive, qpts, T, P, E, out, stream);
}

// The same operands -> mode48 [T, E] i32, the first n of least sums[t, e, n].
extern "C" int yaik_score48_mode(const int* c, const uint8_t* alive,
                                 const int* qpts, long long T, int P, int E,
                                 int* mode48, cudaStream_t stream) {
  return launch<true>(c, alive, qpts, T, P, E, mode48, stream);
}
