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
// 32-element plane words.  A page is processed in chunks of `tr` rows:
//   1. decode: each thread takes one 32-element word group — k plane words
//      plus two 16-byte signman loads — and writes 32 bf16 values to shared
//      memory (ring rows and raw pages are copied with 16-byte loads);
//   2. escapes: the page's esc_pos field (position of the r-th escape in
//      flat order, ascending, sentinel >= n) is scanned and every escape
//      that falls in this chunk's rows and columns is patched from
//      esc_raw[r].  This reads esc_pos rather than ranking escapes with a
//      popcount over the skipped words, because a CTA sees only 1/Hkv of
//      each row; both give the TPU kernel's result, including overflow:
//      escapes past the capacity keep the dictionary's ESCAPE slot, i.e.
//      exponent 0, exactly as fixed.decompress.
//   3. scores: one warp per (head, row) dot product, masked to
//      NEG_INF outside [0, L) and the window; optional softcap;
//   4. online softmax: running (m, l) per head, and the f32 accumulator
//      out[h, :] rescaled and updated from the chunk's V columns.
// Pages whose every position lies outside the window are skipped, and the
// ring is read only up to the slot's length.  The grid is small at decode
// batch sizes (Hkv * S CTAs); splitting the page walk across CTAs
// (FlashDecoding) is left to a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -2.0e38f;

struct Smem {
  int qs, acc, sc, mrun, lrun, alpha, lut, kv, total;
  __host__ __device__ Smem(int gmax, int hd, int tr) {
    int off = 0;
    qs = off;    off += gmax * hd * 4;
    acc = off;   off += gmax * hd * 4;
    sc = off;    off += gmax * tr * 4;
    mrun = off;  off += gmax * 4;
    lrun = off;  off += gmax * 4;
    alpha = off; off += gmax * 4;
    lut = off;   off += 256;
    off = (off + 15) / 16 * 16;
    kv = off;    off += tr * 2 * hd * 2;
    total = off;
  }
};

__device__ __forceinline__ float bf2f(uint16_t u) {
  return __uint_as_float(((unsigned)u) << 16);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  return v;
}

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
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem lay(gmax, hd, tr);
  float* qs = (float*)(smem + lay.qs);
  float* acc = (float*)(smem + lay.acc);
  float* sc = (float*)(smem + lay.sc);
  float* mrun = (float*)(smem + lay.mrun);
  float* lrun = (float*)(smem + lay.lrun);
  float* alpha = (float*)(smem + lay.alpha);
  uint8_t* lut = smem + lay.lut;
  uint16_t* kv = (uint16_t*)(smem + lay.kv);

  const int kvh = blockIdx.x, s = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = kvh * g;
  const int G = (kvh == hkv - 1) ? H - q0 : g;
  const int D2 = 2 * hd;             // this kv head's K‖V columns per row
  const int col0 = kvh * D2;
  const int wpr = D2 / 32;           // plane words per row slice
  const long long n = (long long)blk * W;
  const long long nw = n / 32;
  const int nd = 1 << k;

  const int L = lengths[s];
  const int nfull = L / blk;
  const int lo = L - 1 - window;     // positions must be > lo

  for (int i = tid; i < G * hd; i += kThreads) {
    qs[i] = bf2f(q[((long long)s * H + q0) * hd + i]);
    acc[i] = 0.f;
  }
  for (int i = tid; i < G; i += kThreads) {
    mrun[i] = kNegInf;
    lrun[i] = 0.f;
  }
  __syncthreads();

  for (int pi = 0; pi <= nfull; ++pi) {
    const bool is_ring = pi == nfull;
    const int base = pi * blk;                 // first position of the block
    const int rows = is_ring ? L - base : blk;
    if (rows <= 0) break;
    if (base + rows - 1 <= lo) continue;       // all outside the window
    const long long pid = is_ring ? 0 : page_ids[(long long)s * maxp + pi];
    const bool decode = codec_on && !is_ring;
    if (decode)
      for (int i = tid; i < nd; i += kThreads) lut[i] = dicts[pid * nd + i];
    __syncthreads();

    for (int r0 = 0; r0 < rows; r0 += tr) {
      const int trc = min(tr, rows - r0);
      // 1. decode (or copy) this chunk's K‖V slice into shared memory
      for (int u = tid; u < trc * wpr; u += kThreads) {
        const int rr = u / wpr, wc = u - rr * wpr;
        const int r = r0 + rr;
        uint4* dst = (uint4*)(kv + rr * D2 + wc * 32);
        if (decode) {
          const long long f = (long long)r * W + col0 + wc * 32;
          uint32_t pw[8];
#pragma unroll
          for (int b = 0; b < 8; ++b)
            pw[b] = b < k ? planes[(pid * k + b) * nw + (f >> 5)] : 0u;
          const uint4* sp = (const uint4*)(signman + pid * n + f);
          const uint4 sa = sp[0], sb = sp[1];
          const uint32_t sw[8] = {sa.x, sa.y, sa.z, sa.w,
                                  sb.x, sb.y, sb.z, sb.w};
          uint32_t ow[16];
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            unsigned code = 0;
#pragma unroll
            for (int b = 0; b < 8; ++b) code |= ((pw[b] >> j) & 1u) << b;
            const unsigned e = lut[code];
            const unsigned sm = (sw[j >> 2] >> ((j & 3) * 8)) & 0xFFu;
            const unsigned v = ((sm & 0x80u) << 8) | (e << 7) | (sm & 0x7Fu);
            if (j & 1) ow[j >> 1] |= v << 16;
            else ow[j >> 1] = v;
          }
#pragma unroll
          for (int t = 0; t < 4; ++t)
            dst[t] = make_uint4(ow[4 * t], ow[4 * t + 1], ow[4 * t + 2],
                                ow[4 * t + 3]);
        } else {
          const uint16_t* src =
              is_ring ? ring + ((long long)s * blk + r) * W
                      : raw_pages + (pid * blk + r) * W;
          const uint4* sp = (const uint4*)(src + col0 + wc * 32);
#pragma unroll
          for (int t = 0; t < 4; ++t) dst[t] = sp[t];
        }
      }
      __syncthreads();

      // 2. escape patch from the side channel (position-ordered)
      if (decode) {
        for (int e = tid; e < C; e += kThreads) {
          const int p = esc_pos[pid * C + e];
          if (p >= n) break;                    // sentinel: no more escapes
          const int r = p / W;
          if (r >= r0 + trc) break;             // later escapes: later rows
          const int c = p - r * W - col0;
          if (r >= r0 && c >= 0 && c < D2) {
            const unsigned sm = signman[pid * n + p];
            const unsigned ex = esc_raw[pid * C + e];
            kv[(r - r0) * D2 + c] =
                (uint16_t)(((sm & 0x80u) << 8) | (ex << 7) | (sm & 0x7Fu));
          }
        }
        __syncthreads();
      }

      // 3. masked, scaled (and soft-capped) scores, one warp per dot
      for (int pair = warp; pair < G * trc; pair += kWarps) {
        const int gq = pair / trc, r = pair - gq * trc;
        float dot = 0.f;
        for (int d = lane; d < hd; d += 32)
          dot += qs[gq * hd + d] * bf2f(kv[r * D2 + d]);
        dot = warp_sum(dot);
        if (lane == 0) {
          float sv = dot * scale;
          if (softcap > 0.f) sv = tanhf(sv / softcap) * softcap;
          const int pos = base + r0 + r;
          const bool ok = pos < L && pos > lo;
          sc[gq * tr + r] = ok ? sv : kNegInf;
        }
      }
      __syncthreads();

      // 4a. online-softmax statistics per head
      for (int gq = warp; gq < G; gq += kWarps) {
        float mx = kNegInf;
        for (int r = lane; r < trc; r += 32) mx = fmaxf(mx, sc[gq * tr + r]);
        mx = warp_max(mx);
        const float m_old = mrun[gq];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int r = lane; r < trc; r += 32) {
          const float sv = sc[gq * tr + r];
          const float p = sv == kNegInf ? 0.f : expf(sv - m_new);
          sc[gq * tr + r] = p;
          sum += p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float a = expf(m_old - m_new);
          lrun[gq] = lrun[gq] * a + sum;
          mrun[gq] = m_new;
          alpha[gq] = a;
        }
      }
      __syncthreads();

      // 4b. rescale the accumulator and add this chunk's p @ V
      for (int i = tid; i < G * hd; i += kThreads) {
        const int gq = i / hd, d = i - gq * hd;
        float v = 0.f;
        for (int r = 0; r < trc; ++r)
          v += sc[gq * tr + r] * bf2f(kv[r * D2 + hd + d]);
        acc[i] = acc[i] * alpha[gq] + v;
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < G * hd; i += kThreads)
    out[((long long)s * H + q0) * hd + i] = acc[i];
  for (int i = tid; i < G; i += kThreads) {
    m_out[(long long)s * H + q0 + i] = mrun[i];
    l_out[(long long)s * H + q0 + i] = lrun[i];
  }
}

}  // namespace

extern "C" int decode_attend_paged_launch(
    const void* q, const void* signman, const void* planes, const void* dicts,
    const void* esc_pos, const void* esc_raw, const void* raw_pages,
    const void* ring, const void* page_ids, const void* lengths, void* out,
    void* m, void* l, int S, int H, int hkv, int hd, int blk, int W, int maxp,
    int k, int C, int window, float scale, float softcap, int codec_on,
    void* stream) {
  const int g = H / hkv;
  const int gmax = H - (hkv - 1) * g;
  int tr = 16384 / (2 * hd);
  if (tr > 64) tr = 64;
  if (tr > blk) tr = blk;
  if (tr < 1) tr = 1;
  const Smem lay(gmax, hd, tr);
  if (lay.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attend_paged_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)hkv, (unsigned)S);
  decode_attend_paged_kernel<<<grid, kThreads, lay.total,
                               (cudaStream_t)stream>>>(
      (const uint16_t*)q, (const uint8_t*)signman, (const uint32_t*)planes,
      (const uint8_t*)dicts, (const int*)esc_pos, (const uint8_t*)esc_raw,
      (const uint16_t*)raw_pages, (const uint16_t*)ring,
      (const int*)page_ids, (const int*)lengths, (float*)out, (float*)m,
      (float*)l, H, hkv, hd, g, gmax, blk, W, maxp, k, C, window, scale,
      softcap, tr, codec_on);
  return (int)cudaGetLastError();
}
