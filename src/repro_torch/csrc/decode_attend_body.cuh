// Device body shared by the two decode-attention kernels:
// decode_attend_paged.cu (the paged pool, through a page table) and
// decode_attend.cu (the fixed-batch block store).
//
// A sequence's stream is a list of full compressed blocks ("records"),
// then a raw bf16 ring.  The callers differ only in where the records are,
// and the body takes that as arguments:
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
// Tensor parallelism.  Shard ti of tp holds the interleaved global
// positions p % tp == ti: its stream row (local slot) sl holds position
// sl * tp + ti, and a sequence of global length L gives it
// max((L - 1 - ti) / tp + 1, 0) rows.  The body turns L and the window
// into local slots first (the reference's _live_masks), so everything
// below counts stream rows; at tp = 1 they are the positions.
//
// Split-KV (FlashDecoding).  The grid is (kv head, sequence, split): the
// CTA of split j owns stream rows [sp * P, sp * P + P), sp = span0 +
// j.  P (the span) divides blk, so a span lies inside one record (one
// dictionary, one escape search) or inside the ring.  The grid comes only
// from host-known shapes (the page table's width, or the fixed store's
// host-side length): a span past the sequence's length, or wholly outside
// the window, loads nothing and writes m = kNegInf, l = 0.
//
// Per span, 128 threads, in chunks of tr rows (a power of two dividing P):
//   1. loads: cp.async copies of the chunk's packed bytes (the span's
//      signman rows, rw bytes each at stride W; its k plane words) or raw
//      bf16 rows into a 3-stage shared-memory ring: chunk i + 2 loads
//      while chunk i is decoded and consumed;
//   2. decode, templated on k (lexi::decode16 of lexi_decode.cuh): each
//      thread takes 16 elements (one 16-byte signman load, k plane
//      half-words), spreads four codes at a time
//      into bytes with one multiply per plane, looks them up in the
//      record's dictionary (pre-shifted to the exponent field) and writes
//      bf16 to a tile whose row pitch (rw + 8) keeps the row-per-lane
//      reads below free of bank conflicts;
//   3. escapes: a block-wide 128-ary lower_bound of the record's sorted
//      esc_pos from the span's first flat element (one round when no
//      escape lies before it) stages up to 128 slots in shared memory.
//      Each chunk owns the slots [e_lo, e_hi) of its rows (e_hi counted in
//      the staged slots, or searched for past them) and patches those in
//      this CTA's columns, reading the unstaged ones with independent
//      loads, 16 in flight per thread (a full side channel, C slots in a
//      record's first rows, costs C / 2048 rounds of loads).  The slot
//      index is the escape's rank over the whole record, so a split that
//      starts mid-record, or in a fixed block's sequence b > 0, needs no
//      scan of what lies before it.  Escapes past the capacity keep the
//      dictionary's ESCAPE entry, exponent 0, as fixed.decompress;
//   4. scores on CUDA cores: one (head, row) dot per thread (split over
//      up to 8 threads when G * tr < 128, summed through shared memory in
//      a fixed order), no shuffle reduction per dot; masked to kNegInf
//      outside [0, L) and the window; optional softcap;
//   5. online softmax per head (one warp per head), then p @ V in f32:
//      each thread owns one column d for four heads.
// Merge: each CTA writes its unnormalised partial (acc G x dv, m, l) to a
// workspace, fences, and counts itself in with an atomicAdd on its
// (sequence, kv head) counter.  The last CTA to arrive merges all nsplit
// partials in split order (not arrival order, so two launches give the
// same bits) by merge_partials' rule -- m = max m_i, out = sum out_i
// e^(m_i - m), l = sum l_i e^(m_i - m), splits with m_i = kNegInf adding
// nothing -- 32 splits at a time (beyond 32 the running sums are rescaled
// to each block's new max, as the online softmax does), writes (out, m, l)
// and resets the counter to 0 for the next launch.
//
// Row slices.  A CTA reads rw columns of each row from column col0 = kv
// head * rw: its keys are the slice's first dk columns, its values the dv
// columns from vo.  Plain attention stores K||V per kv head: rw = 2 * hd,
// dk = dv = hd, vo = hd.  MLA (lora > 0) stores one latent row c_kv ||
// k_rope of W = lora + rope columns that every query head shares: one
// "kv head" (hkv = 1, all H heads in one group), rw = dk = W (the absorbed
// query is W wide), dv = lora, vo = 0 (v = the row's first lora columns).

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#include "lexi_decode.cuh"

namespace decode_attend_body {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;             // shared-memory ring of chunk loads
constexpr int kMinBlocks = 3;          // CTAs per SM the layout is sized for
constexpr int kEscWindow = kThreads;   // escape slots staged per span
constexpr int kMergeSplits = 32;       // split weights staged per merge step
constexpr int kMaxK = 8;
constexpr int kMaxSmem = 232448;       // an H100 CTA's shared memory
constexpr float kNegInf = -2.0e38f;

// Everything a launch passes to every CTA.
struct Args {
  const uint16_t* q;
  const uint8_t* signman;
  const uint32_t* planes;
  const uint8_t* dicts;
  const int* esc_pos;
  const uint8_t* esc_raw;
  const uint16_t* raw;      // raw records (codec off)
  const uint16_t* ring;
  float* out;
  float* m_out;
  float* l_out;
  float* ws;                // partials: (seq, kv head, split, gmax, dv + 2)
  int* counters;            // arrivals per (seq, kv head), zero between launches
  long long n_rec, nw;
  int H, hkv, rw, dk, dv, vo, g, gmax, blk, W, C, window, span, nsplit,
      planes16, tp, ti;
  float scale, softcap;
};

// Chunk rows, score split and shared-memory layout (bytes) of a launch.
struct Geometry {
  int tr, pitch, gpad, nsub, stage_bytes;
  int o_lut, o_stage, o_tile, o_qs, o_acc, o_sc, o_part, o_pt, o_stat,
      o_epos, o_eraw, o_wts, o_flag, total;

  __host__ __device__ static int take(int& off, int bytes) {
    const int at = off;
    off += (bytes + 15) / 16 * 16;
    return at;
  }

  __host__ __device__ Geometry(int rw, int dk, int dv, int gmax, int span) {
    tr = 1;                               // 16 KB of bf16 row slices, <= P
    while (tr * 2 * rw <= 8192 && tr * 2 <= span) tr *= 2;
    pitch = rw + 8;
    gpad = (gmax + 3) / 4 * 4;
    nsub = 1;
    while (gmax * tr * nsub * 2 <= kThreads && dk % (nsub * 16) == 0)
      nsub *= 2;
    // a raw chunk is tr rows of the padded pitch; a packed one fits in it
    stage_bytes = tr * pitch * 2;
    int off = 0;
    o_lut = take(off, 256 * 2);            // first: a constant address
    o_stage = take(off, kStages * stage_bytes);
    o_tile = take(off, tr * pitch * 2);
    o_qs = take(off, gmax * dk * 4);
    o_acc = take(off, gmax * dv * 4);
    o_sc = take(off, gmax * tr * 4);
    o_part = take(off, kThreads * 4);
    o_pt = take(off, tr * gpad * 4);
    o_stat = take(off, 3 * gmax * 4);
    o_epos = take(off, kEscWindow * 4);
    o_eraw = take(off, kEscWindow);
    o_wts = take(off, 2 * kMergeSplits * gmax * 4);
    o_flag = take(off, 16);
    total = off;
  }
};

__device__ __forceinline__ float bf2f(uint32_t u) {
  return __uint_as_float(u << 16);
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

// (r, x) = divmod(u, per) for u = u0, u0 + kThreads, ...: one division to
// set up, none per step.
struct Walk {
  int r, x, per, dr, dx;
  __device__ __forceinline__ Walk(int u0, int per_) : per(per_) {
    r = u0 / per;
    x = u0 - r * per;
    dr = kThreads / per;
    dx = kThreads - dr * per;
  }
  __device__ __forceinline__ void next() {
    r += dr;
    x += dx;
    if (x >= per) {
      x -= per;
      ++r;
    }
  }
};

// First slot e in [lo, hi) with pos[e] >= target (hi when there is none;
// every slot below lo must lie below the target), found by the whole CTA:
// each round samples 128 evenly spaced slots of the remaining range, so
// 4096 slots take two rounds and an escape-free record (sentinel in slot
// 0) one.
__device__ __forceinline__ int block_lower_bound(const int* __restrict__ pos,
                                                 int lo, int hi,
                                                 int target) {
  while (lo < hi) {
    const int step = (hi - lo + kThreads - 1) / kThreads;
    const int idx = lo + (int)threadIdx.x * step;
    const int below = __syncthreads_count(idx < hi && pos[idx] < target);
    if (below == 0) break;
    const int nlo = lo + (below - 1) * step + 1;
    hi = min(hi, lo + below * step);
    lo = nlo;
  }
  return lo;
}

// The CTA's whole computation for stream span `sp` of sequence s (global
// length L), partial index `split`; see the comment at the top of the file.
// KB = 0: the records are raw bf16 (codec off); KB = k otherwise.
template <int KB>
__device__ __forceinline__ void attend(const Args& a, const int s,
                                       int L, const long long off,
                                       const int* __restrict__ page_row,
                                       const int sp, const int split) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Geometry geo(a.rw, a.dk, a.dv, a.gmax, a.span);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kvh = blockIdx.x;
  const int q0 = kvh * a.g;
  const int G = (kvh == a.hkv - 1) ? a.H - q0 : a.g;
  const int dk = a.dk, dv = a.dv, D2 = a.rw, tr = geo.tr, pitch = geo.pitch;
  const int gpad = geo.gpad;
  const int pair = s * a.hkv + kvh;
  const int stride = a.gmax * (dv + 2);       // one partial's floats
  float* part = a.ws + ((long long)pair * a.nsplit + split) * stride;

  unsigned char* stage0 = smem + geo.o_stage;
  uint16_t* tile = (uint16_t*)(smem + geo.o_tile);
  float* qs = (float*)(smem + geo.o_qs);
  float* acc = (float*)(smem + geo.o_acc);
  float* sc = (float*)(smem + geo.o_sc);
  float* psum = (float*)(smem + geo.o_part);
  float* pt = (float*)(smem + geo.o_pt);
  float* mrun = (float*)(smem + geo.o_stat);
  float* lrun = mrun + a.gmax;
  float* alpha = lrun + a.gmax;
  uint16_t* lut = (uint16_t*)smem;         // geo.o_lut == 0
  int* epos = (int*)(smem + geo.o_epos);
  uint8_t* eraw = smem + geo.o_eraw;
  float* wts = (float*)(smem + geo.o_wts);
  int* flag = (int*)(smem + geo.o_flag);

  // Shard ti of tp holds the global positions p = sl * tp + ti at its
  // local slots sl (tp = 1: sl = p).  From here on L counts this shard's
  // slots below the global length Lg, and the live slots are > lo: the
  // first slot whose position is > Lg - 1 - window is
  // ceil((Lg - window - ti) / tp).
  const int Lg = L;
  L = Lg > a.ti ? (Lg - 1 - a.ti) / a.tp + 1 : 0;
  const int w0 = Lg - a.window - a.ti;
  const int lo = (w0 > 0 ? (w0 + a.tp - 1) / a.tp : 0) - 1;
  const int p0 = sp * a.span;              // the span's first slot
  const int live0 = max(p0, lo + 1), live1 = min(p0 + a.span, L);

  if (live0 < live1) {
    const int nfull = L / a.blk;
    const int bi = p0 / a.blk, rb0 = p0 - bi * a.blk;
    const bool is_ring = bi >= nfull;
    const bool decode = KB > 0 && !is_ring;
    const long long rid =
        is_ring ? 0 : (page_row != nullptr ? page_row[bi] : bi);
    const long long rec = rid * a.n_rec;     // the record's element 0
    const int col0 = kvh * D2;               // this kv head's row slice
    const int wpr = D2 / 32;                 // plane words per row slice
    const int c_first = (live0 - p0) / tr;
    const int nch = (live1 - 1 - p0) / tr - c_first + 1;
    auto rows_of = [&](int i) {
      return min(tr, live1 - p0 - (c_first + i) * tr);
    };
    // first row of chunk i inside its block (page, fixed block or ring)
    auto row_of = [&](int i) { return rb0 + (c_first + i) * tr; };

    const int tr_shift = __ffs(tr) - 1;
    const Walk walk_sm(tid, D2 / 16);        // 16-byte signman pieces
    const Walk walk_pl(tid, a.planes16 ? wpr / 4 : wpr);   // plane copies
    const Walk walk_raw(tid, D2 / 8);        // 16-byte pieces of raw rows
    const Walk walk_pv(tid, dv);             // (4-head group, column)

    // 1. issue chunk i's copies into stage i % kStages
    auto load = [&](int i) {
      unsigned char* st = stage0 + (i % kStages) * geo.stage_bytes;
      const int rows = rows_of(i), rr0 = row_of(i);
      if (decode) {
        for (Walk w = walk_sm; w.r < rows; w.next()) {
          const long long f = off + (long long)(rr0 + w.r) * a.W + col0;
          __pipeline_memcpy_async(st + w.r * D2 + w.x * 16,
                                  a.signman + rec + f + w.x * 16, 16);
        }
        // plane b of row r: (b * tr + r) in one walk; tr is a power of two
        uint32_t* pst = (uint32_t*)(st + tr * D2);
        for (Walk w = walk_pl; w.r < KB * tr; w.next()) {
          const int b = w.r >> tr_shift, r = w.r & (tr - 1);
          if (r >= rows) continue;
          const long long f = off + (long long)(rr0 + r) * a.W + col0;
          const uint32_t* src = a.planes + (rid * KB + b) * a.nw + (f >> 5);
          uint32_t* dst = pst + w.r * wpr;
          if (a.planes16)
            __pipeline_memcpy_async(dst + w.x * 4, src + w.x * 4, 16);
          else
            __pipeline_memcpy_async(dst + w.x, src + w.x, 4);
        }
      } else {
        for (Walk w = walk_raw; w.r < rows; w.next()) {
          const int r = w.r, x = w.x;
          const uint16_t* src =
              is_ring ? a.ring + ((long long)s * a.blk + rr0 + r) * a.W + col0
                      : a.raw + rec + off + (long long)(rr0 + r) * a.W + col0;
          __pipeline_memcpy_async((uint16_t*)st + r * pitch + x * 8,
                                  src + x * 8, 16);
        }
      }
    };

    for (int i = 0; i < kStages - 1; ++i) {
      if (i < nch) load(i);
      __pipeline_commit();
    }

    // the span's dictionary, q, running state, staged escape slots
    for (int i = tid; i < G * dk; i += kThreads)
      qs[i] = bf2f(a.q[((long long)s * a.H + q0) * dk + i]);
    for (int i = tid; i < G * dv; i += kThreads) acc[i] = 0.f;
    for (int i = tid; i < tr * gpad; i += kThreads) pt[i] = 0.f;
    for (int i = tid; i < G; i += kThreads) {
      mrun[i] = kNegInf;
      lrun[i] = 0.f;
    }
    const int* pos = a.esc_pos + rid * a.C;
    int e_span = 0;
    if (decode) {
      for (int i = tid; i < (1 << KB); i += kThreads)
        lut[i] = (uint16_t)(a.dicts[rid * (1 << KB) + i] << 7);
      e_span = block_lower_bound(
          pos, 0, a.C, (int)(off + (long long)row_of(0) * a.W));
      const int e = e_span + tid;
      epos[tid] = e < a.C ? pos[e] : 0x7FFFFFFF;
      eraw[tid] = e < a.C ? a.esc_raw[rid * a.C + e] : 0;
    }

    const int npairs = G * tr, nsub = geo.nsub, dsub = dk / nsub;
    const int e_win = e_span + kEscWindow;   // first slot not staged
    const float inv_w = 1.f / a.W;
    int e_lo = e_span;                       // first slot of this chunk
    for (int i = 0; i < nch; ++i) {
      __pipeline_wait_prior(kStages - 2);
      __syncthreads();                     // chunk i landed; i - 1 consumed
      if (i + kStages - 1 < nch) load(i + kStages - 1);
      __pipeline_commit();
      const unsigned char* st = stage0 + (i % kStages) * geo.stage_bytes;
      const int rows = rows_of(i), rr0 = row_of(i);
      const int pc = p0 + (c_first + i) * tr;   // the chunk's first position
      const uint16_t* kv = decode ? tile : (const uint16_t*)st;

      // 2-3. decode into the tile, then patch the escapes
      if constexpr (KB > 0) {
        if (decode) {
          const uint32_t* pst = (const uint32_t*)(st + tr * D2);
          const int first = (lane >> 2) & 1;   // conflict-free 32-byte stores
          for (Walk w = walk_sm; w.r < rows; w.next()) {
            const int r = w.r, x = w.x;
            const uint4 smv = *(const uint4*)(st + r * D2 + x * 16);
            const uint32_t* pw = pst + r * wpr + (x >> 1);
            uint32_t bits[KB];
#pragma unroll
            for (int b = 0; b < KB; ++b)
              bits[b] = pw[b * tr * wpr] >> ((x & 1) * 16);
            uint4 h0, h1;
            lexi::decode16<KB>(smv, bits, lut, h0, h1);
            uint4* dst = (uint4*)(tile + r * pitch + x * 16);
            dst[first] = first ? h1 : h0;
            dst[first ^ 1] = first ? h0 : h1;
          }
          // the chunk's slots are [e_lo, e_hi): counted in the staged
          // window when it reaches past the chunk, else searched for
          const int cf = (int)(off + (long long)rr0 * a.W);
          const int ce = cf + rows * a.W;
          const bool staged = epos[kEscWindow - 1] >= ce;
          int e_hi = __syncthreads_count(epos[tid] < ce);  // tile written
          e_hi = staged ? e_span + e_hi
                        : block_lower_bound(pos, e_win, a.C, ce);
          // slot e at flat position p: patch it if it lies in this CTA's
          // columns (row by a float reciprocal: rows * W < 2^24)
          auto patch = [&](int p, int e, bool staged_slot) {
            const int rel = p - cf;
            int r = (int)((float)rel * inv_w);
            r -= r * a.W > rel;
            r += (r + 1) * a.W <= rel;
            const int c = rel - r * a.W - col0;
            if (c >= 0 && c < D2) {
              const unsigned sm = st[r * D2 + c];
              const unsigned ex = staged_slot ? eraw[e - e_span]
                                              : a.esc_raw[rid * a.C + e];
              tile[r * pitch + c] =
                  (uint16_t)(((sm & 0x80u) << 8) | (ex << 7) | (sm & 0x7Fu));
            }
          };
          const int e = e_span + tid;
          if (e >= e_lo && e < e_hi) patch(epos[tid], e, true);
          // slots past the window: independent loads, 16 in flight each
          for (int e0 = max(e_lo, e_win); e0 < e_hi; e0 += 16 * kThreads) {
            int pv[16];
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const int ej = e0 + j * kThreads + tid;
              pv[j] = ej < e_hi ? pos[ej] : -1;
            }
#pragma unroll
            for (int j = 0; j < 16; ++j)
              if (pv[j] >= 0) patch(pv[j], e0 + j * kThreads + tid, false);
          }
          e_lo = e_hi;
          __syncthreads();
        }
      }

      // 4. masked, scaled (and soft-capped) scores, row-per-lane
      auto score = [&](int pr, float dot) {
        const int r = pr & (tr - 1), pos_r = pc + r;
        float sv = dot * a.scale;
        if (a.softcap > 0.f) sv = tanhf(sv / a.softcap) * a.softcap;
        return (r < rows && pos_r < L && pos_r > lo) ? sv : kNegInf;
      };
      for (int t = tid; t < npairs * nsub; t += kThreads) {
        const int sub = nsub > 1 ? t / npairs : 0, pr = t - sub * npairs;
        const int g = pr >> tr_shift, r = pr & (tr - 1);
        float dot = 0.f;
        if (r < rows) {                    // four chains of FMAs, not one
          const float* qg = qs + g * dk + sub * dsub;
          const uint16_t* kr = kv + r * pitch + sub * dsub;
          float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
          for (int d = 0; d < dsub; d += 8) {
            const uint4 kw = *(const uint4*)(kr + d);
            const float4 qa = *(const float4*)(qg + d);
            const float4 qb = *(const float4*)(qg + d + 4);
            d0 = fmaf(qa.x, bf2f(kw.x & 0xFFFFu), d0);
            d1 = fmaf(qa.y, bf2f(kw.x >> 16), d1);
            d2 = fmaf(qa.z, bf2f(kw.y & 0xFFFFu), d2);
            d3 = fmaf(qa.w, bf2f(kw.y >> 16), d3);
            d0 = fmaf(qb.x, bf2f(kw.z & 0xFFFFu), d0);
            d1 = fmaf(qb.y, bf2f(kw.z >> 16), d1);
            d2 = fmaf(qb.z, bf2f(kw.w & 0xFFFFu), d2);
            d3 = fmaf(qb.w, bf2f(kw.w >> 16), d3);
          }
          dot = (d0 + d1) + (d2 + d3);
        }
        if (nsub > 1) psum[t] = dot;
        else sc[pr] = score(pr, dot);
      }
      if (nsub > 1) {                      // nsub * npairs <= kThreads
        __syncthreads();
        if (tid < npairs) {
          float dot = 0.f;
          for (int sub = 0; sub < nsub; ++sub) dot += psum[sub * npairs + tid];
          sc[tid] = score(tid, dot);
        }
      }
      __syncthreads();

      // 5a. online-softmax statistics, one warp per head
      for (int g = warp; g < G; g += kWarps) {
        float mx = kNegInf;
        for (int r = lane; r < tr; r += 32) mx = fmaxf(mx, sc[g * tr + r]);
        mx = warp_max(mx);
        const float m_old = mrun[g], m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int r = lane; r < tr; r += 32) {
          const float sv = sc[g * tr + r];
          const float p = sv == kNegInf ? 0.f : expf(sv - m_new);
          pt[r * gpad + g] = p;
          sum += p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float al = expf(m_old - m_new);
          lrun[g] = lrun[g] * al + sum;
          mrun[g] = m_new;
          alpha[g] = al;
        }
      }
      __syncthreads();

      // 5b. rescale the accumulator and add p @ V: one column, four heads
      for (Walk w = walk_pv; w.r < gpad / 4; w.next()) {
        const int gb = w.r, d = w.x;
        const uint16_t* vc = kv + a.vo + d;
        const float* pp = pt + gb * 4;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        for (int r = 0; r < rows; ++r) {
          const float v = bf2f(vc[r * pitch]);
          const float4 p4 = *(const float4*)(pp + r * gpad);
          a0 = fmaf(p4.x, v, a0);
          a1 = fmaf(p4.y, v, a1);
          a2 = fmaf(p4.z, v, a2);
          a3 = fmaf(p4.w, v, a3);
        }
        const float av[4] = {a0, a1, a2, a3};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int g = gb * 4 + j;
          if (g < G) acc[g * dv + d] = acc[g * dv + d] * alpha[g] + av[j];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < G * dv; i += kThreads) part[i] = acc[i];
    for (int i = tid; i < G; i += kThreads) {
      part[a.gmax * dv + i] = mrun[i];
      part[a.gmax * dv + a.gmax + i] = lrun[i];
    }
  } else {                                  // a dead span loads nothing
    for (int i = tid; i < G; i += kThreads) {
      part[a.gmax * dv + i] = kNegInf;
      part[a.gmax * dv + a.gmax + i] = 0.f;
    }
  }

  // merge: the last CTA of this (sequence, kv head) to arrive
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(a.counters + pair, 1) == a.nsplit - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // Splits in blocks of kMergeSplits, in split order: stage the block's
  // (m, l), fold them into the running max and sum (thread g, in order),
  // then rescale the accumulator and add the block's weighted partials.
  // All loads of a step are independent; a dead split's out is never read.
  const float* base = a.ws + (long long)pair * a.nsplit * stride;
  const int om = a.gmax * dv, ol = om + a.gmax;
  float* wl = wts + kMergeSplits * a.gmax;   // the block's l, then weights
  for (int i = tid; i < G * dv; i += kThreads) acc[i] = 0.f;
  for (int g = tid; g < G; g += kThreads) {
    mrun[g] = kNegInf;
    lrun[g] = 0.f;
  }
  for (int i0 = 0; i0 < a.nsplit; i0 += kMergeSplits) {
    const int nb = min(kMergeSplits, a.nsplit - i0);
    __syncthreads();                         // the last block consumed
    for (int u = tid; u < nb * G; u += kThreads) {
      const int i = u / G, g = u - i * G;
      const float* pi = base + (long long)(i0 + i) * stride;
      wts[i * a.gmax + g] = __ldcg(pi + om + g);
      wl[i * a.gmax + g] = __ldcg(pi + ol + g);
    }
    __syncthreads();
    for (int g = tid; g < G; g += kThreads) {
      float mx = mrun[g];
      for (int i = 0; i < nb; ++i) mx = fmaxf(mx, wts[i * a.gmax + g]);
      const float al = expf(mrun[g] - mx);
      float l = lrun[g] * al;
      for (int i = 0; i < nb; ++i) {
        const float mi = wts[i * a.gmax + g];
        const float w = mi == kNegInf ? 0.f : expf(mi - mx);
        l = fmaf(wl[i * a.gmax + g], w, l);
        wts[i * a.gmax + g] = w;
      }
      mrun[g] = mx;
      lrun[g] = l;
      alpha[g] = al;
    }
    __syncthreads();
    for (int it0 = tid; it0 < G * dv; it0 += 4 * kThreads) {
      float v[4];
      int gj[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int it = it0 + j * kThreads;
        gj[j] = it < G * dv ? it / dv : -1;
        v[j] = gj[j] >= 0 ? acc[it] * alpha[gj[j]] : 0.f;
      }
#pragma unroll 4
      for (int i = 0; i < nb; ++i) {
        const float* pi = base + (long long)(i0 + i) * stride;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float w = gj[j] >= 0 ? wts[i * a.gmax + gj[j]] : 0.f;
          const float x = w != 0.f ? __ldcg(pi + it0 + j * kThreads) : 0.f;
          v[j] = fmaf(w, x, v[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gj[j] >= 0) acc[it0 + j * kThreads] = v[j];
    }
  }
  const long long o0 = (long long)s * a.H + q0;
  for (int it = tid; it < G * dv; it += kThreads) a.out[o0 * dv + it] = acc[it];
  for (int g = tid; g < G; g += kThreads) {
    a.m_out[o0 + g] = mrun[g];
    a.l_out[o0 + g] = lrun[g];
  }
  if (tid == 0) a.counters[pair] = 0;
}

// Host side: the arguments both launchers pass, from the C interface's.
// hd is the query's width; lora > 0 selects the MLA latent row (see the
// row slices above), with hkv = 1 and hd = W.
inline Args make_args(const void* q, const void* signman, const void* planes,
                      const void* dicts, const void* esc_pos,
                      const void* esc_raw, const void* raw, const void* ring,
                      void* out, void* m, void* l, void* ws, void* counters,
                      long long n_rec, long long nw, int H, int hkv, int hd,
                      int lora, int blk, int W, int C, int window, int span,
                      int nsplit, float scale, float softcap, int tp,
                      int ti) {
  Args a;
  a.q = (const uint16_t*)q;
  a.signman = (const uint8_t*)signman;
  a.planes = (const uint32_t*)planes;
  a.dicts = (const uint8_t*)dicts;
  a.esc_pos = (const int*)esc_pos;
  a.esc_raw = (const uint8_t*)esc_raw;
  a.raw = (const uint16_t*)raw;
  a.ring = (const uint16_t*)ring;
  a.out = (float*)out;
  a.m_out = (float*)m;
  a.l_out = (float*)l;
  a.ws = (float*)ws;
  a.counters = (int*)counters;
  a.n_rec = n_rec;
  a.nw = nw;
  a.H = H;
  a.hkv = hkv;
  a.rw = lora > 0 ? W : 2 * hd;
  a.dk = hd;
  a.dv = lora > 0 ? lora : hd;
  a.vo = lora > 0 ? 0 : hd;
  a.g = H / hkv;
  a.gmax = H - (hkv - 1) * a.g;
  a.blk = blk;
  a.W = W;
  a.C = C;
  a.window = window;
  a.span = span;
  a.nsplit = nsplit;
  // 16-byte plane copies: every row slice starts on a 4-word boundary
  a.planes16 = a.rw % 128 == 0 && W % 128 == 0 && (uintptr_t)planes % 16 == 0;
  a.scale = scale;
  a.softcap = softcap;
  a.tp = tp;
  a.ti = ti;
  return a;
}

// Host side: a launcher's kernel template instantiated for k = kb (codec
// on) or kb = 0 (codec off): pick(std::integral_constant<int, KB>())
// returns its kernel<KB>; nullptr for kb outside 0..kMaxK.
template <class Kernel, class Pick, int... KB>
Kernel pick_kernel(int kb, Pick pick, std::integer_sequence<int, KB...>) {
  const Kernel table[] = {pick(std::integral_constant<int, KB>())...};
  return kb >= 0 && kb <= kMaxK ? table[kb] : nullptr;
}

template <class Kernel, class Pick>
Kernel kernel_for(int kb, Pick pick) {
  return pick_kernel<Kernel>(kb, pick,
                             std::make_integer_sequence<int, kMaxK + 1>());
}

// Host side: checks a launch's geometry and lifts the shared-memory limit.
// Returns the dynamic shared memory per CTA, or -1 if the shapes do not fit.
template <class Kernel>
int prepare(Kernel kernel, const Args& a) {
  const Geometry geo(a.rw, a.dk, a.dv, a.gmax, a.span);
  const bool mla = a.vo == 0;
  if (a.dk % 16 || a.rw % 32 || a.dv % 16 || a.span < 1 || a.tp < 1 ||
      a.ti < 0 || a.ti >= a.tp ||
      a.blk % a.span || a.span % geo.tr || geo.total > kMaxSmem ||
      (mla ? a.hkv != 1 || a.dk != a.W || a.dv > a.W
           : a.rw != 2 * a.dk || a.hkv * a.rw != a.W))
    return -1;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           geo.total) != cudaSuccess ||
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared) != cudaSuccess)
    return -1;
  return geo.total;
}

}  // namespace decode_attend_body
