// Fused block decompress + decode attention over the fixed-batch store.
//
// Replaces the Pallas kernel repro/kernels/decode_attend.py:decode_attend
// (_fixed_kernel, with _decode_vals, _split_heads, _block_partial,
// _accumulate and _live_masks), its tp, ti shard path included, for plain
// (GQA / MQA / MHA) payloads and MLA latent payloads (mla_lora: lora > 0).
// On shard ti of tp the store holds the sequence's interleaved positions
// p % tp == ti; L below counts them (see decode_attend_body.cuh).
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
// Grid (Hkv, B, nsplit).  Host-length launch: the spans of P rows from
// span0 (the first span with a position inside the window) to the last
// one below L, both from the host-side length, so no span of the grid is
// dead except when L = 0.  Device-length launch (decode_attend_dev_launch,
// the form a CUDA graph captures): L is read from device memory and the
// grid covers every span of the store's capacity; the spans outside
// [first live, last live] load nothing, and the merge skips them.

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

// The device-length form: the length is read on the device and the grid
// holds every span of the store's capacity (span0 = 0), so one launch --
// and one captured CUDA graph -- serves every length.  The host cannot
// check that length, so it is clamped to the capacity (nsplit * span =
// (nblk + 1) * blk rows, less one so that rows / blk <= nblk): a length
// past it reads no record beyond the store.
template <int KB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    decode_attend_dev_kernel(Args a, const int* __restrict__ length) {
  const int b = blockIdx.y, split = blockIdx.z;
  // the largest global length whose local rows (shard ti of tp) stay
  // below the capacity: (cap - 1) * tp + ti
  const int L = min(*length, (a.nsplit * a.span - 1) * a.tp + a.ti);
  attend<KB>(a, b, L, (long long)b * a.blk * a.W, nullptr, split, split);
}

using Kernel = void (*)(Args, int, int);
using DevKernel = void (*)(Args, const int*);

// Both launchers: check k, pick the instantiation, lift the shared-memory
// limit and launch grid (Hkv, B, nsplit).
template <class K, class Pick, class... KArgs>
int launch(Pick pick, const Args& a, int codec_on, int k, int B, void* stream,
           KArgs... kargs) {
  if (codec_on && (k < 1 || k > kMaxK)) return (int)cudaErrorInvalidValue;
  const K kernel = kernel_for<K>(codec_on ? k : 0, pick);
  const int smem_bytes = prepare(kernel, a);
  if (smem_bytes < 0) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)a.hkv, (unsigned)B, (unsigned)a.nsplit);
  kernel<<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(a, kargs...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int decode_attend_launch(
    const void* q, const void* signman, const void* planes, const void* dicts,
    const void* esc_pos, const void* esc_raw, const void* raw_blocks,
    const void* ring, void* out, void* m, void* l, void* ws, void* counters,
    int B, int H, int hkv, int hd, int lora, int blk, int W, int k, int C,
    int length, int window, int span, int span0, int nsplit, long long nw,
    float scale, float softcap, int codec_on, int tp, int ti,
    void* stream) {
  const Args a = make_args(q, signman, planes, dicts, esc_pos, esc_raw,
                           raw_blocks, ring, out, m, l, ws, counters,
                           (long long)B * blk * W, nw, H, hkv, hd, lora, blk,
                           W, C, window, span, nsplit, scale, softcap, tp,
                           ti);
  return launch<Kernel>(
      [](auto kb) { return decode_attend_kernel<decltype(kb)::value>; }, a,
      codec_on, k, B, stream, length, span0);
}

// The device-length launch: `length` points to one int32 on the device;
// nsplit covers the store's capacity (the store's blocks and the ring).
extern "C" int decode_attend_dev_launch(
    const void* q, const void* signman, const void* planes, const void* dicts,
    const void* esc_pos, const void* esc_raw, const void* raw_blocks,
    const void* ring, void* out, void* m, void* l, void* ws, void* counters,
    int B, int H, int hkv, int hd, int lora, int blk, int W, int k, int C,
    const void* length, int window, int span, int nsplit, long long nw,
    float scale, float softcap, int codec_on, int tp, int ti,
    void* stream) {
  const Args a = make_args(q, signman, planes, dicts, esc_pos, esc_raw,
                           raw_blocks, ring, out, m, l, ws, counters,
                           (long long)B * blk * W, nw, H, hkv, hd, lora, blk,
                           W, C, window, span, nsplit, scale, softcap, tp,
                           ti);
  return launch<DevKernel>(
      [](auto kb) { return decode_attend_dev_kernel<decltype(kb)::value>; },
      a, codec_on, k, B, stream, (const int*)length);
}

// The launch geometry both kernels use for a CTA's row slice of rw columns
// (keys dk wide, values dv wide; see decode_attend_body.cuh), gmax heads
// and span P: out[0] chunk rows, out[1] threads per (head, row) dot,
// out[2] dynamic shared memory per CTA in bytes, out[3] threads per CTA.
extern "C" void decode_attend_geometry(int rw, int dk, int dv, int gmax,
                                       int span, int* out) {
  const Geometry geo(rw, dk, dv, gmax, span);
  out[0] = geo.tr;
  out[1] = geo.nsub;
  out[2] = geo.total;
  out[3] = kThreads;
}
