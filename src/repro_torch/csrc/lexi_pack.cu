// LEXI-FW exponent pack: bf16 -> signman byte + k bit-planes of codes.
//
// Replaces the Pallas kernel repro/kernels/lexi_pack.py:lexi_pack
// (_pack_kernel).  Bound on an H100 by memory: each element reads 2 bytes
// and writes 1 + k/8 bytes ((2 + 1 + k/8) n / 3.35 TB/s).
//
// Design: a streaming kernel, one thread per 32-element plane word, the
// mirror of lexi_unpack.cu.  Grid (ctas, rows): the host sizes `ctas` per
// row, a few hundred CTAs in all (kernels/lexi_pack.py:plan), and the CTAs
// of a row walk its words with a grid stride, so the row's 256-entry
// encode LUT is staged in shared memory, as 8-bit codes, once per CTA.
// Each thread runs a two-deep software pipeline: it issues the next word's
// four 16-byte loads of x before it encodes the current word
// (lexi::encode32: byte permutes for the signman bytes and exponents, a
// shared-memory lookup per code, 8 x 8 bit transposes for the planes)
// and writes it: two 16-byte signman stores, and one 4-byte store per
// plane, where lane i holds word i, so a warp stores 128 contiguous bytes
// per plane.
// Ragged parts take a scalar path, one warp per word, lane j on element
// j: the last word of a row whose n is not a multiple of 32, and every
// word of a row whose x or signman rows are not 16-byte aligned.  A
// ballot per plane gathers the word and lane b stores plane b.  Elements
// past n (the pad up to a multiple of 32) carry code 0, as the reference
// pads.
//
// Layout: x (rows, n) bf16 as uint16; lut (rows, 256) int32;
// signman (rows, n) uint8; planes (rows, k, npad/32) uint32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lexi_encode.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void load_word(uint32_t (&v)[16],
                                          const uint16_t* __restrict__ src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 t = __ldg(s + q);
    v[4 * q] = t.x;
    v[4 * q + 1] = t.y;
    v[4 * q + 2] = t.z;
    v[4 * q + 3] = t.w;
  }
}

template <int KB>
__global__ void __launch_bounds__(kThreads)
lexi_pack_kernel(const uint16_t* __restrict__ x, const int* __restrict__ lut,
                 uint8_t* __restrict__ signman, uint32_t* __restrict__ planes,
                 long long n, long long nw, bool vec) {
  __shared__ uint8_t code_of[256];
  const long long row = blockIdx.y;
  const uint16_t* xr = x + row * n;
  uint8_t* sm = signman + row * n;
  uint32_t* pl = planes + row * KB * nw;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long nfull = vec ? n >> 5 : 0;    // words encoded 32 at a time

  // the first word's loads are in flight while the LUT is staged
  uint32_t next[16];
  if (first < nfull) load_word(next, xr + 32 * first);
  code_of[threadIdx.x] = (uint8_t)lut[row * 256 + threadIdx.x];
  __syncthreads();
  for (long long w = first; w < nfull; w += stride) {
    uint32_t cur[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) cur[i] = next[i];
    if (w + stride < nfull) load_word(next, xr + 32 * (w + stride));
    uint4 smv[2];
    uint32_t bits[KB];
    lexi::encode32<KB>(cur, code_of, smv, bits);
    uint4* dst = reinterpret_cast<uint4*>(sm + 32 * w);
    dst[0] = smv[0];
    dst[1] = smv[1];
#pragma unroll
    for (int b = 0; b < KB; ++b) pl[b * nw + w] = bits[b];
  }
  // the scalar path: a partial last word, or a row that is not aligned;
  // the loop bound is the same for the whole warp, so every lane votes
  const int lane = threadIdx.x & 31;
  for (long long w = nfull + (first >> 5); w < nw; w += stride >> 5) {
    const long long i = 32 * w + lane;
    unsigned code = 0;
    if (i < n) {
      const unsigned u = xr[i];
      sm[i] = (uint8_t)(((u >> 8) & 0x80u) | (u & 0x7Fu));
      code = code_of[(u >> 7) & 0xFFu];
    }
#pragma unroll
    for (int b = 0; b < KB; ++b) {
      const unsigned word = __ballot_sync(0xFFFFFFFFu, (code >> b) & 1u);
      if (lane == b) pl[b * nw + w] = word;
    }
  }
}

template <int KB>
cudaError_t launch(const void* x, const void* lut, void* signman,
                   void* planes, int rows, long long n, int ctas, bool vec,
                   cudaStream_t stream) {
  const long long nw = (n + 31) / 32;
  dim3 grid((unsigned)ctas, (unsigned)rows);
  lexi_pack_kernel<KB><<<grid, kThreads, 0, stream>>>(
      (const uint16_t*)x, (const int*)lut, (uint8_t*)signman,
      (uint32_t*)planes, n, nw, vec);
  return cudaGetLastError();
}

}  // namespace

// ctas: CTAs per row (>= 1); vec: n % 16 == 0 and the x and signman
// pointers 16-byte aligned (else every word takes the scalar path).
extern "C" int lexi_pack_launch(const void* x, const void* lut, void* signman,
                                void* planes, int rows, long long n, int k,
                                int ctas, int vec, void* stream) {
  if (ctas < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool v = vec != 0;
  switch (k) {
    case 1: return (int)launch<1>(x, lut, signman, planes, rows, n, ctas, v, s);
    case 2: return (int)launch<2>(x, lut, signman, planes, rows, n, ctas, v, s);
    case 3: return (int)launch<3>(x, lut, signman, planes, rows, n, ctas, v, s);
    case 4: return (int)launch<4>(x, lut, signman, planes, rows, n, ctas, v, s);
    case 5: return (int)launch<5>(x, lut, signman, planes, rows, n, ctas, v, s);
    case 6: return (int)launch<6>(x, lut, signman, planes, rows, n, ctas, v, s);
    case 7: return (int)launch<7>(x, lut, signman, planes, rows, n, ctas, v, s);
    case 8: return (int)launch<8>(x, lut, signman, planes, rows, n, ctas, v, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
