// Device body shared by the two decode-attention kernels:
// decode_attend_paged.cu (the paged pool, through a page table) and
// decode_attend.cu (the fixed-batch block store).
//
// One CTA computes one (kv head, sequence) pair.  Its sequence's stream is
// a list of full compressed blocks ("records"), then a raw bf16 ring.  The
// callers differ only in where the records are, and the body takes that as
// arguments:
//   record id of block i:  page_row[i] (paged), or i itself (fixed);
//   n_rec: elements per record (blk * W for a page; B * blk * W for a
//          fixed block, which holds all B sequences under ONE dictionary);
//   off:   this sequence's flat offset inside a record (0 for a page;
//          b * blk * W in a fixed block).
// A record's fields: signman[rid * n_rec + j], plane word w of bit b at
// planes[(rid * k + b) * nw + w], dictionary dicts[rid * 2^k ...], escape
// slots esc_pos/esc_raw[rid * C ...] (ascending flat positions, sentinel
// >= n_rec), or raw[rid * n_rec + j] with the codec off.
//
// Per block, in chunks of `tr` rows:
//   1. decode: each thread takes one 32-element word group (k plane words,
//      two 16-byte signman loads) and writes 32 bf16 values to shared
//      memory; ring rows and raw blocks are copied with 16-byte loads;
//   2. escapes: a binary search of the record's esc_pos finds the first
//      slot at or after the chunk's first element (one load when no escape
//      lies before it), and every escape in the chunk's rows and this
//      CTA's columns is patched from esc_raw[slot].  The slot index is the
//      escape's rank over the whole record, so in a fixed block the
//      escapes of sequences 0..b-1 are counted without a scan.  Escapes
//      past the capacity have no slot and keep the dictionary's ESCAPE
//      entry, exponent 0, exactly as fixed.decompress;
//   3. scores: one warp per (head, row) dot product, masked to NEG_INF
//      outside [0, L) and the window; optional softcap;
//   4. online softmax: running (m, l) per head, and the f32 accumulator
//      rescaled and updated from the chunk's V columns.
// Blocks whose every position lies outside the window are skipped, and
// the ring is read only up to L.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_attend_body {

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

// First slot e in [0, C) with pos[e] >= target (C when there is none).
// One load when no escape lies before the target (an escape-free record
// holds the sentinel in slot 0).
__device__ __forceinline__ int lower_bound(const int* __restrict__ pos, int C,
                                           long long target) {
  if (C == 0 || pos[0] >= target) return 0;
  int lo = 1, hi = C;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (pos[mid] < target) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Rows of a chunk, tile sizes and shared memory of one launch.
struct Launch {
  int g, gmax, tr;
  Smem lay;
  Launch(int H, int hkv, int hd, int blk)
      : g(H / hkv), gmax(H - (hkv - 1) * (H / hkv)), tr(pick_tr(hd, blk)),
        lay(H - (hkv - 1) * (H / hkv), hd, pick_tr(hd, blk)) {}
  static int pick_tr(int hd, int blk) {
    int tr = 16384 / (2 * hd);
    if (tr > 64) tr = 64;
    if (tr > blk) tr = blk;
    return tr < 1 ? 1 : tr;
  }
  // Lifts the 48 KB default where the layout needs more shared memory.
  template <class Kernel>
  cudaError_t prepare(Kernel kernel) const {
    if (lay.total <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
  }
};

// The CTA's whole computation; see the comment at the top of the file.
__device__ __forceinline__ void attend(
    const uint16_t* __restrict__ q, const uint8_t* __restrict__ signman,
    const uint32_t* __restrict__ planes, const uint8_t* __restrict__ dicts,
    const int* __restrict__ esc_pos, const uint8_t* __restrict__ esc_raw,
    const uint16_t* __restrict__ raw, const uint16_t* __restrict__ ring,
    const int* __restrict__ page_row, float* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out, int s, int L,
    long long n_rec, long long off, long long nw, int H, int hkv, int hd,
    int g, int gmax, int blk, int W, int k, int C, int window, float scale,
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

  const int kvh = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = kvh * g;
  const int G = (kvh == hkv - 1) ? H - q0 : g;
  const int D2 = 2 * hd;             // this kv head's K‖V columns per row
  const int col0 = kvh * D2;
  const int wpr = D2 / 32;           // plane words per row slice
  const int nd = 1 << k;

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
    const long long rid =
        is_ring ? 0 : (page_row != nullptr ? page_row[pi] : pi);
    const long long rec = rid * n_rec;         // the record's element 0
    const bool decode = codec_on && !is_ring;
    if (decode)
      for (int i = tid; i < nd; i += kThreads) lut[i] = dicts[rid * nd + i];
    __syncthreads();

    for (int r0 = 0; r0 < rows; r0 += tr) {
      const int trc = min(tr, rows - r0);
      // 1. decode (or copy) this chunk's K‖V slice into shared memory
      for (int u = tid; u < trc * wpr; u += kThreads) {
        const int rr = u / wpr, wc = u - rr * wpr;
        const int r = r0 + rr;
        uint4* dst = (uint4*)(kv + rr * D2 + wc * 32);
        // f: the group's first element inside the record
        const long long f = off + (long long)r * W + col0 + wc * 32;
        if (decode) {
          uint32_t pw[8];
#pragma unroll
          for (int b = 0; b < 8; ++b)
            pw[b] = b < k ? planes[(rid * k + b) * nw + (f >> 5)] : 0u;
          const uint4* sp = (const uint4*)(signman + rec + f);
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
          const uint4* sp = (const uint4*)(
              is_ring ? ring + ((long long)s * blk + r) * W + col0 + wc * 32
                      : raw + rec + f);
#pragma unroll
          for (int t = 0; t < 4; ++t) dst[t] = sp[t];
        }
      }
      __syncthreads();

      // 2. escape patch from the side channel (position-ordered)
      if (decode) {
        const long long first = (long long)off + (long long)r0 * W;
        const long long end = first + (long long)trc * W;
        const int* pos = esc_pos + rid * C;
        for (int e = lower_bound(pos, C, first) + tid; e < C;
             e += kThreads) {
          const long long p = pos[e];
          if (p >= end) break;                  // later rows or sentinel
          const long long rel = p - off;
          const int r = (int)(rel / W);
          const int c = (int)(rel - (long long)r * W) - col0;
          if (c >= 0 && c < D2) {
            const unsigned sm = signman[rec + p];
            const unsigned ex = esc_raw[rid * C + e];
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

}  // namespace decode_attend_body
