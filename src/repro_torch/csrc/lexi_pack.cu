// LEXI-FW exponent pack: bf16 -> signman byte + k bit-planes of codes.
//
// Replaces the Pallas kernel repro/kernels/lexi_pack.py:lexi_pack
// (_pack_kernel).  Bound on an H100 by memory: each element reads 2 bytes
// and writes 1 + k/8 bytes ((2n + n + k n / 8) / 3.35 TB/s); the LUT lookup
// and bit gathering are a few instructions per element.
//
// Design: one thread per element, 256 threads per block, one row of the
// (rows, n) input per blockIdx.y.  The row's 256-entry encode LUT is
// staged in shared memory.  Lane j of warp w holds element 32w + j of the
// row, so one __ballot_sync per bit plane produces exactly plane word w of
// core/packing.py's layout (bit j of word w = bit b of element 32w + j):
// no shifts, no shared-memory transpose.  Elements past n (the pad up to a
// multiple of 32) carry code 0, as the reference pads.
//
// Layout: x (rows, n) bf16 as uint16; lut (rows, 256) int32;
// signman (rows, n) uint8; planes (rows, k, npad/32) uint32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void lexi_pack_kernel(const uint16_t* __restrict__ x,
                                 const int* __restrict__ lut,
                                 uint8_t* __restrict__ signman,
                                 uint32_t* __restrict__ planes, long long n,
                                 long long nw, int k) {
  __shared__ int slut[256];
  const long long row = blockIdx.y;
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    slut[i] = lut[row * 256 + i];
  __syncthreads();

  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned code = 0;
  if (i < n) {
    const unsigned u = x[row * n + i];
    signman[row * n + i] = (uint8_t)(((u >> 8) & 0x80u) | (u & 0x7Fu));
    code = (unsigned)slut[(u >> 7) & 0xFFu];
  }
  // every lane reaches the ballots (threads past npad vote 0 and their
  // warp skips the store: npad is a multiple of 32, so warps never straddle)
  const long long w = i >> 5;
  for (int b = 0; b < k; ++b) {
    const unsigned word = __ballot_sync(0xFFFFFFFFu, (code >> b) & 1u);
    if ((threadIdx.x & 31) == 0 && w < nw)
      planes[(row * k + b) * nw + w] = word;
  }
}

}  // namespace

extern "C" int lexi_pack_launch(const void* x, const void* lut,
                                void* signman, void* planes, int rows,
                                long long n, int k, void* stream) {
  const long long npad = (n + 31) / 32 * 32;
  dim3 grid((unsigned)((npad + kThreads - 1) / kThreads), (unsigned)rows);
  lexi_pack_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)x, (const int*)lut, (uint8_t*)signman,
      (uint32_t*)planes, n, npad / 32, k);
  return (int)cudaGetLastError();
}
