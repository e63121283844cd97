// LEXI-FW exponent unpack: signman byte + k bit-planes of codes -> bf16.
//
// Replaces the Pallas kernel repro/kernels/lexi_unpack.py:lexi_unpack
// (_unpack_kernel), the inverse of lexi_pack.  Escape-free, like the TPU
// kernel: a code equal to ESCAPE decodes through the dictionary's ESCAPE
// slot, and the caller patches escapes from the side channel afterwards
// (kernels/ops.py:unpack).
//
// Bound on an H100 by memory: each element reads 1 + k/8 bytes and writes
// 2 ((3 + k/8) n / 3.35 TB/s).  The decode (lexi::decode16) costs about a
// dozen instructions per element, well inside what the SMs issue while
// the bytes stream.
//
// Design: a streaming kernel, one thread per 32-element plane word.  The
// TPU kernel takes one dictionary for all rows; this one takes a
// dictionary per row (lexi_pack's convention), so a stacked weight
// (L, K, N) unpacks in one launch as L rows of K*N, and so do the pages
// of a pool.  Grid (ctas, rows): the host sizes `ctas` per row, about two
// CTAs per SM in all (kernels/lexi_unpack.py:ctas_per_row), and the
// CTAs of a row walk its words with a grid stride, so the row's
// dictionary is staged in shared memory once per CTA.  Each thread runs a
// two-deep software pipeline: it issues the next word's loads -- k 4-byte
// plane words (lane i takes word i: the planes are laid out
// (rows, k, npad/32), so a warp reads 128 contiguous bytes per plane) and
// two 16-byte signman loads -- before it decodes the current word with
// two decode16 calls and writes it with four 16-byte stores, so reads and
// writes stay in flight together.
// Ragged parts keep a scalar path, element by element: the last word of a
// row whose n is not a multiple of 32, and every word of a row whose
// signman or output rows are not 16-byte aligned (n % 16 != 0).
//
// Layout: signman (rows, n) uint8; planes (rows, k, npad/32) uint32
// (npad = n rounded up to 32); dicts (rows, 2^k) uint8; out (rows, n) bf16
// as uint16.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lexi_decode.cuh"

namespace {

constexpr int kThreads = 256;

template <int KB>
struct Word {
  uint32_t bits[KB];
  uint4 sm[2];
};

template <int KB>
__device__ __forceinline__ void load_word(Word<KB>& v,
                                          const uint32_t* __restrict__ pl,
                                          const uint8_t* __restrict__ sm,
                                          long long nw, long long w) {
#pragma unroll
  for (int b = 0; b < KB; ++b) v.bits[b] = __ldg(pl + b * nw + w);
  const uint4* s = reinterpret_cast<const uint4*>(sm + 32 * w);
  v.sm[0] = __ldg(s);
  v.sm[1] = __ldg(s + 1);
}

template <int KB>
__global__ void __launch_bounds__(kThreads)
lexi_unpack_kernel(const uint8_t* __restrict__ signman,
                   const uint32_t* __restrict__ planes,
                   const uint8_t* __restrict__ dicts,
                   uint16_t* __restrict__ out, long long n, long long nw,
                   bool vec) {
  __shared__ uint16_t lut[1 << KB];
  const long long row = blockIdx.y;
  for (int i = threadIdx.x; i < (1 << KB); i += kThreads)
    lut[i] = (uint16_t)(dicts[row * (1 << KB) + i] << 7);
  __syncthreads();

  const uint8_t* sm = signman + row * n;
  const uint32_t* pl = planes + row * KB * nw;
  uint16_t* o = out + row * n;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long nfull = vec ? n >> 5 : 0;    // words decoded 16 at a time

  Word<KB> next;
  if (first < nfull) load_word<KB>(next, pl, sm, nw, first);
  for (long long w = first; w < nfull; w += stride) {
    const Word<KB> cur = next;
    if (w + stride < nfull) load_word<KB>(next, pl, sm, nw, w + stride);
    uint32_t hi[KB];
#pragma unroll
    for (int b = 0; b < KB; ++b) hi[b] = cur.bits[b] >> 16;
    uint4 h[4];
    lexi::decode16<KB>(cur.sm[0], cur.bits, lut, h[0], h[1]);
    lexi::decode16<KB>(cur.sm[1], hi, lut, h[2], h[3]);
    uint4* dst = reinterpret_cast<uint4*>(o + 32 * w);
#pragma unroll
    for (int q = 0; q < 4; ++q) dst[q] = h[q];
  }
  // the scalar path: a partial last word, or a row that is not aligned
  for (long long w = nfull + first; w < nw; w += stride) {
    const int len = (int)min(32LL, n - 32 * w);
    for (int j = 0; j < len; ++j)
      o[32 * w + j] = lexi::decode1<KB>(pl + w, nw, j, sm[32 * w + j], lut);
  }
}

template <int KB>
cudaError_t launch(const void* signman, const void* planes, const void* dicts,
                   void* out, int rows, long long n, int ctas, bool vec,
                   cudaStream_t stream) {
  const long long nw = (n + 31) / 32;
  dim3 grid((unsigned)ctas, (unsigned)rows);
  lexi_unpack_kernel<KB><<<grid, kThreads, 0, stream>>>(
      (const uint8_t*)signman, (const uint32_t*)planes,
      (const uint8_t*)dicts, (uint16_t*)out, n, nw, vec);
  return cudaGetLastError();
}

}  // namespace

// ctas: CTAs per row (>= 1); vec: n % 16 == 0 and the signman and output
// pointers 16-byte aligned (else every word takes the scalar path).
extern "C" int lexi_unpack_launch(const void* signman, const void* planes,
                                  const void* dicts, void* out, int rows,
                                  long long n, int k, int ctas, int vec,
                                  void* stream) {
  if (ctas < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool v = vec != 0;
  switch (k) {
    case 1: return (int)launch<1>(signman, planes, dicts, out, rows, n, ctas, v, s);
    case 2: return (int)launch<2>(signman, planes, dicts, out, rows, n, ctas, v, s);
    case 3: return (int)launch<3>(signman, planes, dicts, out, rows, n, ctas, v, s);
    case 4: return (int)launch<4>(signman, planes, dicts, out, rows, n, ctas, v, s);
    case 5: return (int)launch<5>(signman, planes, dicts, out, rows, n, ctas, v, s);
    case 6: return (int)launch<6>(signman, planes, dicts, out, rows, n, ctas, v, s);
    case 7: return (int)launch<7>(signman, planes, dicts, out, rows, n, ctas, v, s);
    case 8: return (int)launch<8>(signman, planes, dicts, out, rows, n, ctas, v, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
