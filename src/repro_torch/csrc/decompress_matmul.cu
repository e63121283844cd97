// Fused just-in-time weight decompression + matmul:
//     out (M, N) f32 = x (M, K) bf16 @ W (K, N),
// W held in the LEXI-FW packed layout of the serving weight plane:
// signman (K, N) uint8, planes (k, K, N/32) uint32, dict (2^k,) uint8.
// Word (b, r, c) of the planes holds bit b of the codes of
// W[r, 32c .. 32c + 31]; the dictionary maps a code to the exponent byte.
//
// Replaces the Pallas kernel repro/kernels/decompress_matmul.py:
// decompress_matmul (_dm_kernel).  As there, the decoded bf16 tile never
// goes back to device memory: W is read in its packed size, 1 + k/8 bytes
// per element instead of 2.
//
// What bounds it on an H100: at decode (M = a few slots) memory, the
// packed W (K N (1 + k/8) bytes over 3.35 TB/s); at prefill
// (M = slots x prompt) the tensor cores (2 M N K operations).  Both
// routes decode with lexi::decode16 (lexi_decode.cuh), about a dozen
// instructions per element: at decode that is close to what the SMs can
// issue while the packed bytes stream, so the product must cost almost
// nothing per element -- tensor cores, not FMAs.
//
// Two routes, picked on the host by kernels/decompress_matmul.py:plan
// from (M, K, N, k), which also sizes the decode route's grid and picks
// the prefill route's tile:
//
// Decode route (small M; split-K).  Grid (N / bn, splits, M-groups), 128
// threads (4 warps), templated on the column tile bn (32, 64 or 128) so
// every tile dimension is a constant.  The CTA owns a bn-column tile of
// `depth` rows of W (its split) and up to 32 rows of x (its M-group).
//   * an asynchronous 2-stage ring in shared memory (cp.async, zero-filled
//     past K and N): a stage is one chunk of chunk_rows(bn) rows of W
//     (8 KB of signman at most, and k * rows * bn / 32 plane words) and
//     the same rows of x, so every byte of W and x in the CTA's slice is
//     loaded into shared memory once; the next chunk is in flight while
//     one is decoded and multiplied (three or more stages, or 4 KB
//     chunks, measured slower on the H100: fewer CTAs per SM);
//   * decode: each thread takes four 16-column pieces of the chunk (one
//     16-byte signman load, k plane half-words) through decode16 into a
//     bf16 tile in shared memory; rows past K decode to 0;
//   * tensor cores: mma.sync m16n8k16 bf16 -> f32 with W^T as the A
//     operand (16 columns of W, ldmatrix.trans from the [k][n] tile) and
//     x as B (8 rows of x, ldmatrix from the [m][k] chunk), so M is padded
//     to a multiple of 8 rows, not 16.  Warp w owns 32 columns and, when
//     bn < 128, every (128 / bn)-th k16 step; the k phases are summed in
//     shared memory in a fixed order;
//   * split merge in the same launch, deterministic (as the attention
//     kernels' merge, decode_attend_body.cuh): split 0 writes its partial
//     straight to `out`, split s > 0 to workspace slot s - 1; each CTA
//     fences and counts in on an arrival counter per (column tile,
//     M-group); the last CTA to arrive loads the partials of 8 splits x 4
//     outputs per thread at once, sums them in split order (not arrival
//     order, so two launches give the same bits), writes `out` and resets
//     the counter to 0 (no float atomics, no memset, no second launch; a
//     captured graph replays it as it is).  A cluster merge through
//     distributed shared memory measured no faster on qwen3-4b's shapes.
//
// Prefill route (large M): decompress_matmul_prefill.cu, wgmma on W tiles
// decoded into shared memory while the previous tile's products run.
//
// Edges are masked in the kernels (no host padding): rows past K and
// columns past N load as 0, rows of x past M and columns past K load as 0,
// only in-range outputs are stored.  N must be a multiple of 32 (the
// format's word), K and M are free.  x is read with 16-byte copies when
// K % 8 == 0 and x is 16-byte aligned, else element by element.  Templated
// on k (1..8), so the plane words stay in registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lexi_decode.cuh"

namespace {

constexpr int kMaxSmem = 232448;       // an H100 CTA's shared memory

// ---------------------------------------------------------------------------
// decode route
// ---------------------------------------------------------------------------

namespace dec {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;           // measured: 3 and more were slower
constexpr int kMaxMT = 4;              // m8 tiles per CTA: 32 rows of x
constexpr int kChunkBytes = 8192;      // signman bytes of one chunk, at most
constexpr int kPieces = kChunkBytes / 16 / kThreads;  // per thread, chunk
constexpr int kMergeBatch = 8;         // splits' partials loaded at once,
constexpr int kMergeOut = 4;           // for this many outputs per thread

struct Args {
  const uint16_t* x;
  const uint8_t* signman;
  const uint32_t* planes;
  const uint8_t* dict;
  float* out;
  float* ws;          // (splits - 1, M, N) partials of splits 1..
  int* counters;      // arrivals per (M-group, column tile); zero between launches
  int M, K, N, bn, rows, depth, splits, mrows, vec_x, pl_copy;
};

__host__ __device__ constexpr int align16(int b) { return (b + 15) / 16 * 16; }

// Shared-memory layout (bytes) of one launch.
// The LUT first (256 16-bit entries at offset 0, a constant address),
// then the ring of stages (signman rows, plane words, x rows), the decoded
// tile and the merge flag.
struct Layout {
  int x_pitch, pl_off, x_off, stage, ring_off, red_pitch, tile_pitch,
      tile_off, flag_off, total;
  __host__ __device__ Layout(int bn, int rows, int kb, int mt) {
    x_pitch = rows * 2 + 16;           // 16-byte rows apart: ldmatrix
    pl_off = rows * bn;                // after the signman rows
    x_off = align16(pl_off + kb * rows * (bn / 32) * 4);
    stage = align16(x_off + mt * 8 * x_pitch);
    ring_off = 256 * 2;
    red_pitch = bn + 4;                // floats; the k-phase sums reuse the ring
    const int red = (kWarps * 32 / bn) * mt * 8 * red_pitch * 4;
    tile_pitch = bn * 2 + 16;
    tile_off = ring_off + align16(max(kStages * stage, red));
    flag_off = tile_off + rows * tile_pitch;
    total = flag_off + 16;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// cp.async of `bytes` (16, 8 or 4), of which `src_bytes` are read and the
// rest zero-filled (0: nothing is read).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "n"(BYTES), "r"(src_bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Rows of W in one chunk of a BN-column tile: kChunkBytes of signman, at
// most 128 rows (kernels/decompress_matmul.py:chunk_rows).
__host__ __device__ constexpr int chunk_rows(int bn) {
  return kChunkBytes / bn < 128 ? kChunkBytes / bn : 128;
}

// plane-word copies of PL bytes (PL / 4 words each) of one chunk
template <int KB, int BN, int PL>
__device__ __forceinline__ void load_planes(const Args& a, unsigned char* dst,
                                            int r0, int k1, int n0) {
  constexpr int ROWS = chunk_rows(BN), WPR = BN / 32, WPC = PL / 4;
  constexpr int CPR = WPR / WPC;
  const int nw = a.N / 32;
#pragma unroll
  for (int p = threadIdx.x; p < KB * ROWS * CPR; p += kThreads) {
    const int q = p / CPR, j = p % CPR;
    const int b = q / ROWS, r = q % ROWS;
    const int kr = r0 + r, w = n0 / 32 + j * WPC;
    const bool ok = kr < k1 && w < nw;
    const uint32_t* src =
        ok ? a.planes + ((long long)b * a.K + kr) * nw + w : a.planes;
    cp_async<PL>(dst + ((b * ROWS + r) * WPR + j * WPC) * 4, src,
                 ok ? PL : 0);
  }
}

// Decode one chunk's pieces (16 columns of one row each) into the tile:
// every piece's operands first, so the decodes overlap.  Guard: rows at
// or past `valid` (the end of K) decode to 0.
template <int KB, int BN, bool Guard>
__device__ __forceinline__ void decode_chunk(const unsigned char* st,
                                             const uint16_t* lut,
                                             uint16_t* tile, int tile_pitch,
                                             int valid, int first) {
  constexpr int ROWS = chunk_rows(BN), PPR = BN / 16, WPR = BN / 32;
  constexpr int PIECES = ROWS * PPR / kThreads;
  const uint32_t* pst = (const uint32_t*)(st + ROWS * BN);
  uint4 smv[PIECES];
  uint32_t bits[PIECES][KB];
#pragma unroll
  for (int i = 0; i < PIECES; ++i) {
    const int p = threadIdx.x + i * kThreads, r = p / PPR, j = p % PPR;
    if (!Guard || r < valid) {
      smv[i] = *(const uint4*)(st + r * BN + 16 * j);
      const uint32_t* pw = pst + r * WPR + (j >> 1);
#pragma unroll
      for (int b = 0; b < KB; ++b)
        bits[i][b] = pw[b * ROWS * WPR] >> ((j & 1) * 16);
    }
  }
#pragma unroll
  for (int i = 0; i < PIECES; ++i) {
    const int p = threadIdx.x + i * kThreads, r = p / PPR, j = p % PPR;
    uint4 h0 = make_uint4(0, 0, 0, 0), h1 = h0;
    if (!Guard || r < valid) lexi::decode16<KB>(smv[i], bits[i], lut, h0, h1);
    uint4* dst = (uint4*)(tile + r * tile_pitch + 16 * j);
    dst[first] = first ? h1 : h0;
    dst[first ^ 1] = first ? h0 : h1;
  }
}

// The decode route for a BN-column tile (32, 64 or 128), so that every
// tile dimension, and with it the chunk's index arithmetic, is a constant.
template <int KB, int BN>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const Args a) {
  constexpr int ROWS = chunk_rows(BN);
  constexpr int PPR = BN / 16;               // 16-column pieces per row
  constexpr int CG = BN / 32, KPH = kWarps / CG;   // column groups, k phases
  constexpr int KSTEPS = ROWS / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int mt_alloc = a.mrows / 8;
  const Layout L(BN, ROWS, KB, mt_alloc);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, split = blockIdx.y;
  const int m0 = blockIdx.z * a.mrows;
  const int mrows = min(a.mrows, a.M - m0);  // rows of x this CTA holds
  const int mt = (mrows + 7) >> 3;           // m8 tiles with rows in them
  const int k0 = split * a.depth, k1 = min(a.K, k0 + a.depth);
  const int nchunks = k1 > k0 ? (k1 - k0 + ROWS - 1) / ROWS : 0;
  const int wcol = (warp % CG) * 32, phase = warp / CG;
  const int tile_pitch = L.tile_pitch / 2;   // bf16 elements

  uint16_t* lut = (uint16_t*)smem;           // offset 0
  uint16_t* tile = (uint16_t*)(smem + L.tile_off);
  unsigned char* ring = smem + L.ring_off;

  // issue chunk c's copies into stage c % kStages
  auto load = [&](int c) {
    unsigned char* st = ring + (c % kStages) * L.stage;
    const int r0 = k0 + c * ROWS;
#pragma unroll
    for (int p = tid; p < ROWS * PPR; p += kThreads) {
      const int r = p / PPR, j = p % PPR;
      const int kr = r0 + r, col = n0 + 16 * j;
      const bool ok = kr < k1 && col < a.N;
      cp_async<16>(st + r * BN + 16 * j,
                   ok ? a.signman + (long long)kr * a.N + col : a.signman,
                   ok ? 16 : 0);
    }
    if (BN >= 128 && a.pl_copy == 16)
      load_planes<KB, BN, (BN >= 128 ? 16 : 4)>(a, st + L.pl_off, r0, k1, n0);
    else if (BN >= 64 && a.pl_copy == 8)
      load_planes<KB, BN, (BN >= 64 ? 8 : 4)>(a, st + L.pl_off, r0, k1, n0);
    else
      load_planes<KB, BN, 4>(a, st + L.pl_off, r0, k1, n0);
    unsigned char* xs = st + L.x_off;
    if (a.vec_x) {
      constexpr int XPR = ROWS / 8;          // 16-byte pieces per x row
      for (int p = tid; p < mt * 8 * XPR; p += kThreads) {
        const int m = p / XPR, j = p % XPR;
        const int gm = m0 + m, kc = r0 + 8 * j;
        const bool ok = m < mrows && kc < k1;
        cp_async<16>(xs + m * L.x_pitch + 16 * j,
                     ok ? a.x + (long long)gm * a.K + kc : a.x, ok ? 16 : 0);
      }
    } else {                                 // plain loads, then stores
      for (int p = tid; p < mt * 8 * ROWS; p += kThreads) {
        const int m = p / ROWS, j = p % ROWS;
        const int kc = r0 + j;
        ((uint16_t*)(xs + m * L.x_pitch))[j] =
            m < mrows && kc < k1 ? a.x[(long long)(m0 + m) * a.K + kc] : 0;
      }
    }
  };

  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nchunks) load(c);
    cp_commit();
  }
  for (int i = tid; i < (1 << KB); i += kThreads)   // after the first copies
    lut[i] = (uint16_t)(a.dict[i] << 7);

  float acc[2][kMaxMT][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < kMaxMT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][i][e] = 0.f;

  // ldmatrix lane addresses: A (x4.trans) matrices [n 0-7 | 8-15] x
  // [k 0-7 | 8-15] of the [k][n] tile; B (x2) rows m of x, k 0-7 | 8-15
  const int a_row = (lane & 7) + ((lane >> 4) << 3);
  const int a_col = wcol + (((lane >> 3) & 1) << 3);
  const int b_row = lane & 7, b_col = ((lane >> 3) & 1) << 3;
  const int first = BN == 128 ? (lane >> 2) & 1 : 0;  // conflict-free stores

  for (int c = 0; c < nchunks; ++c) {
    cp_wait<kStages - 2>();
    __syncthreads();                  // chunk c landed; chunk c - 1 consumed
    if (c + kStages - 1 < nchunks) load(c + kStages - 1);
    cp_commit();
    const unsigned char* st = ring + (c % kStages) * L.stage;
    const int valid = k1 - (k0 + c * ROWS);   // rows of the chunk below K
    if (valid >= ROWS)
      decode_chunk<KB, BN, false>(st, lut, tile, tile_pitch, valid, first);
    else
      decode_chunk<KB, BN, true>(st, lut, tile, tile_pitch, valid, first);
    __syncthreads();                  // the tile is decoded

    const unsigned char* xs = st + L.x_off;
#pragma unroll
    for (int s = phase; s < KSTEPS; s += KPH) {
      uint32_t af[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
        ldmatrix_x4_trans(af[t], tile + (16 * s + a_row) * tile_pitch +
                                     a_col + 16 * t);
#pragma unroll
      for (int i = 0; i < kMaxMT; ++i) {
        if (i >= mt) break;                  // warp-uniform
        uint32_t bf[2];
        ldmatrix_x2(bf, xs + (8 * i + b_row) * L.x_pitch +
                            (16 * s + b_col) * 2);
        mma_bf16(acc[0][i], af[0], bf);
        mma_bf16(acc[1][i], af[1], bf);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();                    // the ring is free: k-phase sums

  // red[phase][m][n]: fragment c0, c1 at (n = g, m = 2q, 2q + 1), c2, c3 at
  // n = g + 8 (g = lane / 4, q = lane % 4)
  float* red = (float*)ring;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < kMaxMT; ++i) {
      if (i >= mt) break;
      float* base = red + (phase * mt_alloc * 8 + 8 * i + 2 * q) * L.red_pitch +
                    wcol + 16 * t + g;
      base[0] = acc[t][i][0];
      base[L.red_pitch] = acc[t][i][1];
      base[8] = acc[t][i][2];
      base[L.red_pitch + 8] = acc[t][i][3];
    }
  __syncthreads();

  // this CTA's partial: the k phases summed in order, kept in red[0]
  const int nv = min(BN, a.N - n0);          // columns in range
  const long long MN = (long long)a.M * a.N;
  for (int e = tid; e < mrows * BN; e += kThreads) {
    const int m = e / BN, n = e % BN;
    float* r0 = red + m * L.red_pitch + n;
    float v = r0[0];
#pragma unroll
    for (int ph = 1; ph < KPH; ++ph) v += r0[ph * mt_alloc * 8 * L.red_pitch];
    r0[0] = v;
    if (n < nv) {
      const long long o = (long long)(m0 + m) * a.N + n0 + n;
      if (split == 0)
        a.out[o] = v;
      else
        a.ws[(split - 1) * MN + o] = v;
    }
  }
  if (a.splits == 1) return;

  // merge: the last CTA of this (M-group, column tile) to arrive
  int* flag = (int*)(smem + L.flag_off);
  int* counter = a.counters + blockIdx.z * gridDim.x + blockIdx.x;
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(counter, 1) == a.splits - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // The partials of kMergeOut outputs x kMergeBatch splits are loaded
  // before any is added, so a batch costs one L2 round trip, not one per
  // split and output; each sum still runs in split order.
  for (int e0 = tid; e0 < mrows * BN; e0 += kMergeOut * kThreads) {
    long long o[kMergeOut];
    float own[kMergeOut], v[kMergeOut];
    bool ok[kMergeOut];
#pragma unroll
    for (int i = 0; i < kMergeOut; ++i) {
      const int e = e0 + i * kThreads, m = e / BN, n = e % BN;
      ok[i] = e < mrows * BN && n < nv;
      o[i] = (long long)(m0 + m) * a.N + n0 + n;
      own[i] = ok[i] ? red[m * L.red_pitch + n] : 0.f;
      v[i] = 0.f;
    }
    for (int s0 = 0; s0 < a.splits; s0 += kMergeBatch) {
      float p[kMergeOut][kMergeBatch];
#pragma unroll
      for (int i = 0; i < kMergeOut; ++i)
#pragma unroll
        for (int j = 0; j < kMergeBatch; ++j) {
          const int sj = s0 + j;
          p[i][j] = !ok[i] || sj >= a.splits || sj == split
                        ? own[i]
                        : __ldcg(sj == 0 ? a.out + o[i]
                                         : a.ws + (sj - 1) * MN + o[i]);
        }
#pragma unroll
      for (int i = 0; i < kMergeOut; ++i)
#pragma unroll
        for (int j = 0; j < kMergeBatch; ++j)
          if (s0 + j < a.splits) v[i] = s0 + j == 0 ? p[i][j] : v[i] + p[i][j];
    }
#pragma unroll
    for (int i = 0; i < kMergeOut; ++i)
      if (ok[i]) a.out[o[i]] = v[i];
  }
  if (tid == 0) *counter = 0;
}

}  // namespace dec

template <int KB, int BN>
cudaError_t launch_decode(const dec::Args& a, cudaStream_t stream) {
  const dec::Layout L(BN, dec::chunk_rows(BN), KB, a.mrows / 8);
  static bool lifted = false;        // the attribute, once per instantiation
  if (!lifted) {
    const cudaError_t e = cudaFuncSetAttribute(
        dec::decode_kernel<KB, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    lifted = true;
  }
  dim3 grid((unsigned)((a.N + BN - 1) / BN), (unsigned)a.splits,
            (unsigned)((a.M + a.mrows - 1) / a.mrows));
  dec::decode_kernel<KB, BN><<<grid, dec::kThreads, L.total, stream>>>(a);
  return cudaGetLastError();
}

template <int KB>
cudaError_t launch(const dec::Args& a, cudaStream_t stream) {
  switch (a.bn) {
    case 32: return launch_decode<KB, 32>(a, stream);
    case 64: return launch_decode<KB, 64>(a, stream);
    case 128: return launch_decode<KB, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The decode route's shapes that the kernel's layout supports.
bool decode_shape_ok(const dec::Args& a, int k) {
  if (a.bn != 32 && a.bn != 64 && a.bn != 128) return false;
  if (a.rows != dec::chunk_rows(a.bn) || a.depth < a.rows ||
      a.depth % a.rows)
    return false;
  if (a.mrows < 8 || a.mrows > 8 * dec::kMaxMT || a.mrows % 8) return false;
  if (a.splits < 1 || (long long)a.splits * a.depth < a.K ||
      (long long)(a.splits - 1) * a.depth >= (a.K > 0 ? a.K : 1))
    return false;
  if (a.pl_copy != 4 && a.pl_copy != 8 && a.pl_copy != 16) return false;
  if (a.pl_copy > a.bn / 8) return false;
  return dec::Layout(a.bn, a.rows, k, a.mrows / 8).total <= kMaxSmem;
}

}  // namespace

// The prefill route (decompress_matmul_prefill.cu).
cudaError_t decompress_matmul_prefill(const void* x, const void* signman,
                                      const void* planes, const void* dict,
                                      void* out, int M, int K, int N, int k,
                                      int bn, int bm, int vec_x,
                                      cudaStream_t s);

// shape: {M, K, N, k, vec_x, route, bn, rows, depth, splits, mrows,
// pl_copy}.  route 0: the prefill tiles, mrows x bn (128 x 128 or 256 x
// 128), rows = 64 K rows per step, one split of depth K (pl_copy, ws and
// counters unused).  route 1:
// the split-K decode route with the plan's column tile bn, chunk rows,
// split depth and count, x rows per CTA, and the plane copy width in
// bytes; ws holds (splits - 1) * M * N floats and counters (N / bn) *
// ceil(M / mrows) ints, zero before the launch and left zero after it.
// vec_x: K % 8 == 0 and x 16-byte aligned.
extern "C" int decompress_matmul_launch(
    const void* x, const void* signman, const void* planes, const void* dict,
    void* out, void* ws, void* counters, const int* shape, void* stream) {
  const int M = shape[0], K = shape[1], N = shape[2], k = shape[3];
  const int route = shape[5];
  cudaStream_t s = (cudaStream_t)stream;
  if (k < 1 || k > 8) return (int)cudaErrorInvalidValue;
  if (route == 0) {
    if (shape[7] != 64 || shape[9] != 1) return (int)cudaErrorInvalidValue;
    return (int)decompress_matmul_prefill(x, signman, planes, dict, out, M,
                                          K, N, k, shape[6], shape[10],
                                          shape[4], s);
  }
  dec::Args a{(const uint16_t*)x, (const uint8_t*)signman,
              (const uint32_t*)planes, (const uint8_t*)dict, (float*)out,
              (float*)ws, (int*)counters, M, K, N, shape[6], shape[7],
              shape[8], shape[9], shape[10], shape[4], shape[11]};
  if (route != 1 || !decode_shape_ok(a, k)) return (int)cudaErrorInvalidValue;
  switch (k) {
    case 1: return (int)launch<1>(a, s);
    case 2: return (int)launch<2>(a, s);
    case 3: return (int)launch<3>(a, s);
    case 4: return (int)launch<4>(a, s);
    case 5: return (int)launch<5>(a, s);
    case 6: return (int)launch<6>(a, s);
    case 7: return (int)launch<7>(a, s);
    case 8: return (int)launch<8>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The decode route's dynamic shared memory per CTA, in bytes.
extern "C" int decompress_matmul_smem(int bn, int rows, int k, int mrows) {
  return dec::Layout(bn, rows, k, mrows / 8).total;
}
