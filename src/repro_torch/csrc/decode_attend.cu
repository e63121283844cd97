// Fused block decompress + decode attention over the fixed-batch store.
//
// Replaces the Pallas kernel repro/kernels/decode_attend.py:decode_attend
// (_fixed_kernel, with _decode_vals, _split_heads, _block_partial,
// _accumulate and _live_masks) at tp = 1.
//
// What it computes, per sequence b: all B sequences share one length L.
// Walk the store's blocks below L / blk; each block is ONE LEXI-FW record
// of all B sequences' (blk, W) rows, flat (B, blk, W), under one exponent
// dictionary and one escape side channel of capacity
// C = esc_capacity(B * blk * W).  Decode the b-th slice of each block (the
// rows at flat offset b * blk * W), then the sequence's raw bf16 ring
// rows below L; mask by L and the layer's window; run an online softmax
// for every query head.  Output: the unnormalised partials (out f32, m, l),
// exactly what the TPU kernel returns.
//
// The escape rank of an element of sequence b counts the escapes of
// sequences 0..b-1 too.  The side channel is position-ordered, so a binary
// search of esc_pos for the chunk's first flat position gives the rank of
// its first escape directly; escapes past the capacity decode as exponent
// 0 (the dictionary's ESCAPE slot), as fixed.decompress and the TPU kernel
// do.
//
// What bounds it on an H100: memory.  A decode step reads each live block
// once (B * n (1 + k/8) bytes plus its escape slots, n = blk * W) and the
// rings; ~4 flops per stored byte, far below the card's ~295 flops/byte
// ridge.  Decoded values stay in shared memory.
//
// Design: the paged kernel's (decode_attend_body.cuh), one CTA per
// (kv head, sequence), 256 threads, the block loop inside; a sequence's
// block i is record i of the store at offset b * blk * W.  The grid is
// Hkv * B CTAs; splitting the block walk across CTAs is left to a later
// change.

#include "decode_attend_body.cuh"

namespace {

using namespace decode_attend_body;

__global__ void __launch_bounds__(kThreads) decode_attend_kernel(
    const uint16_t* __restrict__ q, const uint8_t* __restrict__ signman,
    const uint32_t* __restrict__ planes, const uint8_t* __restrict__ dicts,
    const int* __restrict__ esc_pos, const uint8_t* __restrict__ esc_raw,
    const uint16_t* __restrict__ raw_blocks, const uint16_t* __restrict__ ring,
    float* __restrict__ out, float* __restrict__ m_out,
    float* __restrict__ l_out, int B, int length, long long nw, int H,
    int hkv, int hd, int g, int gmax, int blk, int W, int k, int C,
    int window, float scale, float softcap, int tr, int codec_on) {
  const int b = blockIdx.y;
  const long long n = (long long)blk * W;
  attend(q, signman, planes, dicts, esc_pos, esc_raw, raw_blocks, ring,
         nullptr, out, m_out, l_out, b, length, B * n, b * n, nw, H, hkv, hd,
         g, gmax, blk, W, k, C, window, scale, softcap, tr, codec_on);
}

}  // namespace

extern "C" int decode_attend_launch(
    const void* q, const void* signman, const void* planes, const void* dicts,
    const void* esc_pos, const void* esc_raw, const void* raw_blocks,
    const void* ring, void* out, void* m, void* l, int B, int H, int hkv,
    int hd, int blk, int W, int k, int C, int length, int window,
    long long nw, float scale, float softcap, int codec_on, void* stream) {
  const Launch ln(H, hkv, hd, blk);
  cudaError_t e = ln.prepare(decode_attend_kernel);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)hkv, (unsigned)B);
  decode_attend_kernel<<<grid, kThreads, ln.lay.total,
                         (cudaStream_t)stream>>>(
      (const uint16_t*)q, (const uint8_t*)signman, (const uint32_t*)planes,
      (const uint8_t*)dicts, (const int*)esc_pos, (const uint8_t*)esc_raw,
      (const uint16_t*)raw_blocks, (const uint16_t*)ring, (float*)out,
      (float*)m, (float*)l, B, length, nw, H, hkv, hd, ln.g, ln.gmax, blk, W,
      k, C, window, scale, softcap, ln.tr, codec_on);
  return (int)cudaGetLastError();
}
