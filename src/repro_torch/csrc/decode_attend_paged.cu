// Fused page decompress + decode attention through a page table.
//
// Replaces the Pallas kernel repro/kernels/decode_attend.py:
// decode_attend_paged (_paged_kernel, with _decode_vals, _split_heads,
// _block_partial, _accumulate and _live_masks), its tp, ti shard path
// included (a slot's pages hold its positions p % tp == ti), for plain
// (GQA / MQA / MHA) payloads and MLA latent payloads (mla_lora: lora > 0).
//
// What it computes, per slot s: walk the slot's page-table row over its
// full pages, decode each LEXI-FW page (k bit-planes -> codes -> the page's
// exponent dictionary -> escape patch -> bf16), then the slot's raw bf16
// ring; mask by the slot's length and the layer's window; softmax for
// every query head.  Output: the unnormalised partials (out f32, m, l),
// exactly what the TPU kernel returns.
//
// What bounds it on an H100: memory.  A decode step reads every live page
// once (n (1 + k/8) bytes plus its escape slots, n = block * W) and the
// rings; the arithmetic is ~4 flops per stored byte, far below the card's
// ~295 flops/byte ridge.  The design therefore reads only the bytes a
// block needs and never writes the decoded page back to device memory.
// At decode batch sizes the bytes take a few microseconds; what sets the
// time is how many CTAs share the walk and each CTA's chain of dependent
// steps (its length, page id, escape search, chunks, merge), so one CTA
// per (kv head, slot) would leave most SMs idle: the walk is split.
//
// Design: decode_attend_body.cuh's split-KV body.  Grid (Hkv, S, nsplit)
// of 128-thread CTAs, nsplit = (maxp + 1) * blk / P: every span of P rows
// the page table and the ring could hold, from the table's shape alone
// (the slots' lengths stay on the device, so the launch reads no device
// value).  The CTA owns the G = Hq/Hkv query heads of its kv head (GQA /
// MQA / MHA; a ragged last group takes the remainder, as gqa_head_table
// clips) and reads its span's page id from the slot's table row.  A page
// row is K||V interleaved per kv head, (Hkv, 2, hd), so the CTA's columns
// are one contiguous 2*hd slice of each row; with hd % 16 == 0 that slice
// is whole 16-element plane half-words.  An MLA page row is one latent
// c_kv || k_rope that all query heads share: one CTA per (slot, span)
// takes every head and the whole row (keys), whose first lora columns are
// the values.  Escapes are found through the
// page's esc_pos field rather than ranked with a popcount over the skipped
// words, because a CTA sees only 1/Hkv of each row.  The last CTA of each
// (slot, kv head) merges the splits in split order.

#include "decode_attend_body.cuh"

namespace {

using namespace decode_attend_body;

template <int KB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    decode_attend_paged_kernel(Args a, const int* __restrict__ page_ids,
                               const int* __restrict__ lengths, int maxp) {
  const int s = blockIdx.y, split = blockIdx.z;
  attend<KB>(a, s, lengths[s], 0, page_ids + (long long)s * maxp, split,
             split);
}

using Kernel = void (*)(Args, const int*, const int*, int);

}  // namespace

extern "C" int decode_attend_paged_launch(
    const void* q, const void* signman, const void* planes, const void* dicts,
    const void* esc_pos, const void* esc_raw, const void* raw_pages,
    const void* ring, const void* page_ids, const void* lengths, void* out,
    void* m, void* l, void* ws, void* counters, int S, int H, int hkv, int hd,
    int lora, int blk, int W, int maxp, int k, int C, int window, int span,
    int nsplit, float scale, float softcap, int codec_on, int tp, int ti,
    void* stream) {
  if (codec_on && (k < 1 || k > kMaxK)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, signman, planes, dicts, esc_pos, esc_raw,
                           raw_pages, ring, out, m, l, ws, counters,
                           (long long)blk * W, (long long)blk * W / 32, H,
                           hkv, hd, lora, blk, W, C, window, span, nsplit,
                           scale, softcap, tp, ti);
  const Kernel kernel = kernel_for<Kernel>(codec_on ? k : 0, [](auto kb) {
    return decode_attend_paged_kernel<decltype(kb)::value>;
  });
  const int smem_bytes = prepare(kernel, a);
  if (smem_bytes < 0) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)hkv, (unsigned)S, (unsigned)nsplit);
  kernel<<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      a, (const int*)page_ids, (const int*)lengths, maxp);
  return (int)cudaGetLastError();
}
