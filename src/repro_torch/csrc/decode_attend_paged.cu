// Fused page decompress + decode attention through a page table.
//
// Replaces the Pallas kernel repro/kernels/decode_attend.py:
// decode_attend_paged (_paged_kernel, with _decode_vals, _split_heads,
// _block_partial, _accumulate and _live_masks) at tp = 1.
//
// What it computes, per slot s: walk the slot's page-table row over its
// full pages, decode each LEXI-FW page (k bit-planes -> codes -> the page's
// exponent dictionary -> escape patch -> bf16), then the slot's raw bf16
// ring; mask by the slot's length and the layer's window; run an online
// softmax for every query head.  Output: the unnormalised partials
// (out f32, m, l), exactly what the TPU kernel returns.
//
// What bounds it on an H100: memory.  A decode step reads every live page
// once (n (1 + k/8) bytes plus its escape slots, n = block * W) and the
// rings; the arithmetic is ~4 flops per stored byte, far below the card's
// ~295 flops/byte ridge.  The design therefore reads only the bytes a
// block needs and never writes the decoded page back to device memory.
//
// Design: one CTA per (kv head, slot), 256 threads.  The CTA owns the
// G = Hq/Hkv query heads of its kv head (GQA / MQA / MHA; a ragged last
// group takes the remainder, as gqa_head_table clips).  A page row is
// K‖V interleaved per kv head, (Hkv, 2, hd), so the CTA's columns are one
// contiguous 2*hd slice of each row; with hd % 16 == 0 that slice is whole
// 32-element plane words.  The page walk is decode_attend_body.cuh's, with
// each page's id read from the slot's page-table row.  Escapes are read
// from the page's esc_pos field rather than ranked with a popcount over
// the skipped words, because a CTA sees only 1/Hkv of each row.  The grid
// is small at decode batch sizes (Hkv * S CTAs); splitting the page walk
// across CTAs (FlashDecoding) is left to a later change.

#include "decode_attend_body.cuh"

namespace {

using namespace decode_attend_body;

__global__ void __launch_bounds__(kThreads) decode_attend_paged_kernel(
    const uint16_t* __restrict__ q, const uint8_t* __restrict__ signman,
    const uint32_t* __restrict__ planes, const uint8_t* __restrict__ dicts,
    const int* __restrict__ esc_pos, const uint8_t* __restrict__ esc_raw,
    const uint16_t* __restrict__ raw_pages, const uint16_t* __restrict__ ring,
    const int* __restrict__ page_ids, const int* __restrict__ lengths,
    float* __restrict__ out, float* __restrict__ m_out,
    float* __restrict__ l_out, int H, int hkv, int hd, int g, int gmax,
    int blk, int W, int maxp, int k, int C, int window, float scale,
    float softcap, int tr, int codec_on) {
  const int s = blockIdx.y;
  const long long n = (long long)blk * W;
  attend(q, signman, planes, dicts, esc_pos, esc_raw, raw_pages, ring,
         page_ids + (long long)s * maxp, out, m_out, l_out, s, lengths[s], n,
         0, n / 32, H, hkv, hd, g, gmax, blk, W, k, C, window, scale,
         softcap, tr, codec_on);
}

}  // namespace

extern "C" int decode_attend_paged_launch(
    const void* q, const void* signman, const void* planes, const void* dicts,
    const void* esc_pos, const void* esc_raw, const void* raw_pages,
    const void* ring, const void* page_ids, const void* lengths, void* out,
    void* m, void* l, int S, int H, int hkv, int hd, int blk, int W, int maxp,
    int k, int C, int window, float scale, float softcap, int codec_on,
    void* stream) {
  const Launch ln(H, hkv, hd, blk);
  cudaError_t e = ln.prepare(decode_attend_paged_kernel);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)hkv, (unsigned)S);
  decode_attend_paged_kernel<<<grid, kThreads, ln.lay.total,
                               (cudaStream_t)stream>>>(
      (const uint16_t*)q, (const uint8_t*)signman, (const uint32_t*)planes,
      (const uint8_t*)dicts, (const int*)esc_pos, (const uint8_t*)esc_raw,
      (const uint16_t*)raw_pages, (const uint16_t*)ring,
      (const int*)page_ids, (const int*)lengths, (float*)out, (float*)m,
      (float*)l, H, hkv, hd, ln.g, ln.gmax, blk, W, maxp, k, C, window,
      scale, softcap, ln.tr, codec_on);
  return (int)cudaGetLastError();
}
