// 256-bin histogram of bf16 exponent fields, one histogram per row.
//
// Replaces the Pallas kernel repro/kernels/exp_histogram.py:exp_histogram
// (_hist_kernel), which builds the histogram as a one-hot hi^T @ lo
// product on the TPU's matrix unit.  Hopper has no use for that trick: the
// work is one counter update per element, so the kernel is bound by
// reading the input (2 bytes per element; 2n / 3.35 TB/s on an H100).
//
// Design: grid (ctas, rows), about two CTAs per SM in all; CTA c of a row
// counts one contiguous span of the row (the host's plan,
// kernels/exp_histogram.py:plan) in rounds of one 16-byte load (8
// elements) per thread, in batches of four rounds: the next batch's loads
// are in flight while a batch is counted (the first while the counters
// are cleared).  Exponent streams have a few hot bins, so shared counters
// that threads share would serialise on them.  Instead every thread
// counts into its own 256 8-bit counters in shared memory (64 KB a CTA),
// four bins to a 32-bit word and the words laid out [bin / 4][thread]:
// lane i always touches bank i, so a warp's updates never conflict
// whatever the bins, and a count is a load, an add and a store with no
// atomic and no vote.  Every kFoldRounds rounds (at most 224 counts per
// counter) the CTA folds the bytes: thread t sums a quarter of word row
// t / 4 (16 conflict-free 16-byte loads, two 16-bit lanes per bin), clears
// it if counting goes on, and four shuffles leave each thread the count of
// bin t in a register.
// One launch, no memset: a row counted by one CTA writes its histogram
// directly; otherwise each CTA writes its partial to a workspace, and the
// last CTA of the row to arrive (an arrival counter, which it leaves
// zero) sums the partials into the histogram.  Rows that are not 16-byte
// aligned (n % 8 != 0, or x itself) are counted one element per round.
//
// Layout: x (rows, n) bf16 as raw uint16 patterns, hist (rows, 256) int32,
// partials (rows, ctas, 256) int32, arrived (rows,) int32.
// Integer counts are exact, so the result equals the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;          // rounds in a batch of loads
constexpr int kFoldRounds = 28;     // a multiple of kUnroll; 8 x 28 < 256
constexpr int kCounterBytes = 256 * kThreads;
constexpr int kDepth = 2;           // batches of kUnroll rounds in flight

// One count of bin (bits 7-14 of w: a bf16's exponent) in this thread's
// column.
__device__ __forceinline__ void count(uint32_t* col, uint32_t w) {
  uint32_t* c = col + (((w >> 9) & 63u) << 8);   // word row bin / 4
  *c += 1u << ((w >> 4) & 24u);                  // byte bin % 4
}

// Item i of a row: a 16-byte vector (8 elements), or one element in .x.
template <bool Vec>
__device__ __forceinline__ uint4 load_item(const uint16_t* __restrict__ xr,
                                           long long i) {
  if constexpr (Vec)
    return __ldcs(reinterpret_cast<const uint4*>(xr) + i);
  else
    return make_uint4(xr[i], 0u, 0u, 0u);
}

template <bool Vec>
__device__ __forceinline__ void count_item(uint32_t* col, const uint4 v) {
  if constexpr (Vec) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      count(col, w[q]);
      count(col, w[q] >> 16);
    }
  } else {
    count(col, v.x);
  }
}

template <bool Vec>
__global__ void __launch_bounds__(kThreads, 3)     // 3 CTAs fit an SM
exp_histogram_kernel(const uint16_t* __restrict__ x, int* __restrict__ hist,
                     int* __restrict__ partials, int* __restrict__ arrived,
                     long long n, long long span) {
  extern __shared__ uint4 smem[];
  uint32_t* cnt = reinterpret_cast<uint32_t*>(smem);
  __shared__ bool last;
  const int t = threadIdx.x;
  const long long row = blockIdx.y;
  const long long items = Vec ? n >> 3 : n;      // 8 elements, or 1
  const long long base = (long long)blockIdx.x * span;
  const long long end = min(base + span, items);
  const long long rounds = (end - base + kThreads - 1) / kThreads;
  const long long first = base + t;            // this thread's item, round 0
  const uint16_t* xr = x + row * n;

  // a kDepth-deep pipeline of batches of kUnroll rounds' loads: the batch
  // being counted and the kDepth - 1 after it; the first batches are in
  // flight while the thread clears its counters
  uint4 ring[kDepth - 1][kUnroll];
  const auto load_batch = [&](uint4 (&v)[kUnroll], long long r) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = first + (r + u) * kThreads;
      v[u] = i < end ? load_item<Vec>(xr, i) : make_uint4(0, 0, 0, 0);
    }
  };
#pragma unroll
  for (int d = 0; d < kDepth - 1; ++d) load_batch(ring[d], d * kUnroll);
  uint32_t* col = cnt + t;
#pragma unroll 8
  for (int r = 0; r < 64; ++r) col[r << 8] = 0;

  uint32_t mine = 0;                             // this CTA's count of bin t
  for (long long r0 = 0; r0 < rounds; r0 += kFoldRounds) {
    const long long r1 = min(rounds, r0 + kFoldRounds);
    for (long long r = r0; r < r1; r += kUnroll) {
      uint4 cur[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) cur[u] = ring[0][u];
#pragma unroll
      for (int d = 0; d + 1 < kDepth - 1; ++d)
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) ring[d][u] = ring[d + 1][u];
      if (r + (kDepth - 1) * kUnroll < rounds)
        load_batch(ring[kDepth - 2], r + (kDepth - 1) * kUnroll);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (first + (r + u) * kThreads < end) count_item<Vec>(col, cur[u]);
    }
    // fold: thread t takes word row t / 4, columns [64 (t % 4), + 64),
    // and clears them if more rounds follow
    __syncthreads();
    const bool more = r1 < rounds;
    uint4* words = reinterpret_cast<uint4*>(cnt + ((t >> 2) << 8) +
                                            ((t & 3) << 6));
    uint32_t even = 0, odd = 0;          // bins 4q, 4q+2 / 4q+1, 4q+3
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = (i + t) & 15;        // rotated: no bank conflicts
      const uint4 v = words[c];
      if (more) words[c] = make_uint4(0, 0, 0, 0);
      even += (v.x & 0x00FF00FFu) + (v.y & 0x00FF00FFu) +
              (v.z & 0x00FF00FFu) + (v.w & 0x00FF00FFu);
      odd += ((v.x >> 8) & 0x00FF00FFu) + ((v.y >> 8) & 0x00FF00FFu) +
             ((v.z >> 8) & 0x00FF00FFu) + ((v.w >> 8) & 0x00FF00FFu);
    }
    // the four threads of a word row: at most 4 x 64 x 224 < 2^16 a lane
    even += __shfl_xor_sync(0xFFFFFFFFu, even, 1);
    even += __shfl_xor_sync(0xFFFFFFFFu, even, 2);
    odd += __shfl_xor_sync(0xFFFFFFFFu, odd, 1);
    odd += __shfl_xor_sync(0xFFFFFFFFu, odd, 2);
    const uint32_t pick = (t & 1) ? odd : even;    // bin t = 4 (t / 4) + t % 4
    mine += (t & 2) ? pick >> 16 : pick & 0xFFFFu;
    __syncthreads();
  }

  int* h = hist + row * 256;
  if (gridDim.x == 1) {
    h[t] = (int)mine;
    return;
  }
  int* part = partials + row * gridDim.x * 256;
  part[blockIdx.x * 256 + t] = (int)mine;
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(arrived + row, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  int sum = 0;
  for (unsigned c = 0; c < gridDim.x; c += 8) {   // 8 loads in flight
    int v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = c + j < gridDim.x ? __ldcg(part + (c + j) * 256 + t) : 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) sum += v[j];
  }
  h[t] = sum;
  if (t == 0) arrived[row] = 0;
}

template <bool Vec>
cudaError_t launch(const void* x, void* hist, void* partials, void* arrived,
                   int rows, long long n, int ctas, long long span,
                   cudaStream_t stream) {
  static unsigned long long sized = 0;       // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (!(sized >> dev & 1ull)) {
    e = cudaFuncSetAttribute(exp_histogram_kernel<Vec>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kCounterBytes);
    if (e != cudaSuccess) return e;
    sized |= 1ull << dev;
  }
  dim3 grid((unsigned)ctas, (unsigned)rows);
  exp_histogram_kernel<Vec><<<grid, kThreads, kCounterBytes, stream>>>(
      (const uint16_t*)x, (int*)hist, (int*)partials, (int*)arrived, n,
      span);
  return cudaGetLastError();
}

}  // namespace

// ctas: CTAs per row (>= 1), each counting `span` items (16-byte vectors
// if vec, else elements) of its row; partials (rows * ctas * 256 int32)
// and arrived (rows int32, zero) are only read when ctas > 1.
extern "C" int exp_histogram_launch(const void* x, void* hist,
                                    void* partials, void* arrived, int rows,
                                    long long n, int ctas, long long span,
                                    int vec, void* stream) {
  if (ctas < 1 || span < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(vec ? launch<true>(x, hist, partials, arrived, rows, n, ctas,
                                  span, s)
                   : launch<false>(x, hist, partials, arrived, rows, n, ctas,
                                   span, s));
}
