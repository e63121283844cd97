// LEXI-FW exponent unpack: signman byte + k bit-planes of codes -> bf16.
//
// Replaces the Pallas kernel repro/kernels/lexi_unpack.py:lexi_unpack
// (_unpack_kernel), the inverse of lexi_pack.  Escape-free, like the TPU
// kernel: a code equal to ESCAPE decodes through the dictionary's ESCAPE
// slot, and the caller patches escapes from the side channel afterwards
// (kernels/ops.py:unpack).
//
// Bound on an H100 by memory: each element reads 1 + k/8 bytes and writes
// 2 ((3 + k/8) n / 3.35 TB/s); the decode is a few instructions per
// element.
//
// Design: one thread per element, 256 threads per block, one row of the
// (rows, n) stream per blockIdx.y.  The TPU kernel takes one dictionary
// for all rows; this one takes a dictionary per row (lexi_pack's
// convention), so a stacked weight (L, K, N) unpacks in one launch as L
// rows of K*N, and so do the pages of a pool.  The row's dictionary is
// staged in shared memory, pre-shifted into the exponent field.  Lane j of
// warp w holds element 32w + j of the row, so every lane of the warp reads
// the same k plane words (one broadcast load each) and takes bit j of
// each: the layout of core/packing.py needs no transpose.
//
// Layout: signman (rows, n) uint8; planes (rows, k, npad/32) uint32
// (npad = n rounded up to 32); dicts (rows, 2^k) uint8; out (rows, n) bf16
// as uint16.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void lexi_unpack_kernel(const uint8_t* __restrict__ signman,
                                   const uint32_t* __restrict__ planes,
                                   const uint8_t* __restrict__ dicts,
                                   uint16_t* __restrict__ out, long long n,
                                   long long nw, int k) {
  __shared__ uint16_t sexp[256];
  const long long row = blockIdx.y;
  const int nsym = 1 << k;
  for (int i = threadIdx.x; i < nsym; i += blockDim.x)
    sexp[i] = (uint16_t)((unsigned)dicts[row * nsym + i] << 7);
  __syncthreads();

  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long w = i >> 5;
  const unsigned lane = (unsigned)(i & 31);
  const uint32_t* pw = planes + row * k * nw + w;
  unsigned code = 0;
  for (int b = 0; b < k; ++b) code |= ((pw[(long long)b * nw] >> lane) & 1u) << b;
  const unsigned sm = signman[row * n + i];
  out[row * n + i] =
      (uint16_t)(((sm & 0x80u) << 8) | sexp[code] | (sm & 0x7Fu));
}

}  // namespace

extern "C" int lexi_unpack_launch(const void* signman, const void* planes,
                                  const void* dicts, void* out, int rows,
                                  long long n, int k, void* stream) {
  const long long nw = (n + 31) / 32;
  dim3 grid((unsigned)((n + kThreads - 1) / kThreads), (unsigned)rows);
  lexi_unpack_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)signman, (const uint32_t*)planes,
      (const uint8_t*)dicts, (uint16_t*)out, n, nw, k);
  return (int)cudaGetLastError();
}
