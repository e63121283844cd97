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
// rows below L; mask by L and the layer's window; softmax for every query
// head.  Output: the unnormalised partials (out f32, m, l), exactly what
// the TPU kernel returns.
//
// The escape rank of an element of sequence b counts the escapes of
// sequences 0..b-1 too.  The side channel is position-ordered, so a
// search of esc_pos for a span's first flat position gives the rank of
// its first escape directly; escapes past the capacity decode as exponent
// 0 (the dictionary's ESCAPE slot), as fixed.decompress and the TPU kernel
// do.
//
// What bounds it on an H100: memory.  A decode step reads each live block
// once (B * n (1 + k/8) bytes plus its escape slots, n = blk * W) and the
// rings; ~4 flops per stored byte, far below the card's ~295 flops/byte
// ridge.  Decoded values stay in shared memory; at decode batch sizes
// the time is set by the split's parallelism and each CTA's chain of
// dependent steps, as in the paged kernel.
//
// Design: the paged kernel's split-KV body (decode_attend_body.cuh); a
// sequence's block i is record i of the store at offset b * blk * W.
// Grid (Hkv, B, nsplit): the spans of P rows from span0 (the first span
// with a position inside the window) to the last one below L, both from
// the host-side length, so no span of the grid is dead except when L = 0.

#include "decode_attend_body.cuh"

namespace {

using namespace decode_attend_body;

template <int KB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    decode_attend_kernel(Args a, int length, int span0) {
  const int b = blockIdx.y, split = blockIdx.z;
  attend<KB>(a, b, length, (long long)b * a.blk * a.W, nullptr,
             span0 + split, split);
}

using Kernel = void (*)(Args, int, int);

}  // namespace

extern "C" int decode_attend_launch(
    const void* q, const void* signman, const void* planes, const void* dicts,
    const void* esc_pos, const void* esc_raw, const void* raw_blocks,
    const void* ring, void* out, void* m, void* l, void* ws, void* counters,
    int B, int H, int hkv, int hd, int blk, int W, int k, int C, int length,
    int window, int span, int span0, int nsplit, long long nw, float scale,
    float softcap, int codec_on, void* stream) {
  if (codec_on && (k < 1 || k > kMaxK)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, signman, planes, dicts, esc_pos, esc_raw,
                           raw_blocks, ring, out, m, l, ws, counters,
                           (long long)B * blk * W, nw, H, hkv, hd, blk, W, C,
                           window, span, nsplit, scale, softcap);
  const Kernel kernel = kernel_for<Kernel>(codec_on ? k : 0, [](auto kb) {
    return decode_attend_kernel<decltype(kb)::value>;
  });
  const int smem_bytes = prepare(kernel, a);
  if (smem_bytes < 0) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)hkv, (unsigned)B, (unsigned)nsplit);
  kernel<<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(a, length,
                                                               span0);
  return (int)cudaGetLastError();
}

// The launch geometry both kernels use for (hd, gmax, span): out[0] chunk
// rows, out[1] threads per (head, row) dot, out[2] dynamic shared memory
// per CTA in bytes, out[3] threads per CTA.
extern "C" void decode_attend_geometry(int hd, int gmax, int span, int* out) {
  const Geometry geo(hd, gmax, span);
  out[0] = geo.tr;
  out[1] = geo.nsub;
  out[2] = geo.total;
  out[3] = kThreads;
}
