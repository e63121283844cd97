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
// (M = slots x prompt) the tensor cores (2 M N K operations).  The decode
// of a W tile costs a few dozen instructions per 16 elements, which at
// large M the tile's reuse over BM rows of x amortizes.
//
// Design (simple first; TMA, wgmma and split-K for small M come later):
//   * grid (N / BN, M / BM), 256 threads (8 warps) per CTA, a BM x BN
//     = 64 x 128 output tile; the K loop runs inside the CTA, BK = 64.
//   * each K step, every thread reads two 16-column chunks of the packed
//     W tile (one 16-byte signman load and k plane words each) and one
//     row segment of x into registers; decodes the chunks through the
//     dictionary (staged in shared memory, pre-shifted to the exponent
//     field) into a bf16 tile in shared memory; copies x beside it.  The
//     next step's loads are issued before this step's products, so their
//     latency overlaps the tensor-core work.
//   * bf16 tensor-core products (nvcuda::wmma 16x16x16, f32 accumulate):
//     each warp owns a 32 x 32 sub-tile (2 x 2 fragments) and skips the
//     fragments whose rows lie past M.
//   * edges are masked in the kernel: rows past K and columns past N
//     decode to 0, rows of x past M and columns past K load as 0, and the
//     epilogue stores only in-range outputs (through a per-warp staging
//     tile).  N must be a multiple of 32 (the format's word), K and M are
//     free.  x is read with 16-byte loads when K % 8 == 0 and x is
//     16-byte aligned, else element by element.
//   * templated on k (1..8), so the plane words stay in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int BM = 64, BN = 128, BK = 64;
constexpr int XLD = BK + 8;        // shared row strides (bf16 elements):
constexpr int WLD = BN + 8;        // multiples of 8, rows 32-byte aligned
constexpr int kWChunks = BK * BN / 16 / kThreads;   // 16-col chunks/thread
constexpr int kXChunks = BM * BK / 8 / kThreads;    // 8-col chunks/thread

template <int KB>
struct Regs {
  uint4 sm[kWChunks];
  uint32_t words[kWChunks][KB];
  bool wok[kWChunks];
  uint4 x[kXChunks];
};

template <int KB>
__device__ __forceinline__ void load_tile(
    Regs<KB>& r, const uint16_t* __restrict__ x,
    const uint8_t* __restrict__ signman, const uint32_t* __restrict__ planes,
    int M, int K, int N, int m0, int n0, int k0, bool vec_x) {
  const int nw = N >> 5;
#pragma unroll
  for (int j = 0; j < kWChunks; ++j) {
    const int c = threadIdx.x + j * kThreads;
    const int kr = k0 + c / (BN / 16);
    const int col = n0 + (c % (BN / 16)) * 16;
    r.wok[j] = kr < K && col < N;
    if (r.wok[j]) {
      r.sm[j] = *reinterpret_cast<const uint4*>(signman + (long long)kr * N + col);
#pragma unroll
      for (int b = 0; b < KB; ++b)
        r.words[j][b] = planes[((long long)b * K + kr) * nw + (col >> 5)];
    }
  }
#pragma unroll
  for (int j = 0; j < kXChunks; ++j) {
    const int c = threadIdx.x + j * kThreads;
    const int m = m0 + c / (BK / 8);
    const int kc = k0 + (c % (BK / 8)) * 8;
    const uint16_t* src = x + (long long)m * K + kc;
    if (vec_x) {
      r.x[j] = (m < M && kc < K) ? *reinterpret_cast<const uint4*>(src)
                                 : make_uint4(0, 0, 0, 0);
    } else {
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned lo = (m < M && kc + 2 * e < K) ? src[2 * e] : 0u;
        const unsigned hi = (m < M && kc + 2 * e + 1 < K) ? src[2 * e + 1] : 0u;
        v[e] = lo | (hi << 16);
      }
      r.x[j] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <int KB>
__device__ __forceinline__ void store_tile(const Regs<KB>& r,
                                           const uint16_t* __restrict__ sexp,
                                           uint16_t* xs, uint16_t* ws) {
#pragma unroll
  for (int j = 0; j < kWChunks; ++j) {
    const int c = threadIdx.x + j * kThreads;
    const int row = c / (BN / 16), g16 = c % (BN / 16);
    uint32_t packed[8];
    if (r.wok[j]) {
      const int shift = (g16 & 1) * 16;      // which half of the word
      const uint32_t smw[4] = {r.sm[j].x, r.sm[j].y, r.sm[j].z, r.sm[j].w};
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        unsigned code = 0;
#pragma unroll
        for (int b = 0; b < KB; ++b)
          code |= ((r.words[j][b] >> (shift + e)) & 1u) << b;
        const unsigned s = (smw[e >> 2] >> ((e & 3) * 8)) & 0xFFu;
        const unsigned u = ((s & 0x80u) << 8) | sexp[code] | (s & 0x7Fu);
        if (e & 1)
          packed[e >> 1] |= u << 16;
        else
          packed[e >> 1] = u;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) packed[e] = 0;
    }
    uint4* dst = reinterpret_cast<uint4*>(ws + row * WLD + g16 * 16);
    dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
    dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
  }
#pragma unroll
  for (int j = 0; j < kXChunks; ++j) {
    const int c = threadIdx.x + j * kThreads;
    const int row = c / (BK / 8), c8 = (c % (BK / 8)) * 8;
    *reinterpret_cast<uint4*>(xs + row * XLD + c8) = r.x[j];
  }
}

template <int KB>
__global__ void __launch_bounds__(kThreads)
decompress_matmul_kernel(const uint16_t* __restrict__ x,
                         const uint8_t* __restrict__ signman,
                         const uint32_t* __restrict__ planes,
                         const uint8_t* __restrict__ dict,
                         float* __restrict__ out, int M, int K, int N,
                         bool vec_x) {
  __shared__ __align__(32) uint16_t xs[BM * XLD];
  __shared__ __align__(32) uint16_t ws[BK * WLD];
  __shared__ __align__(32) float stage[kThreads / 32][16 * 16];
  __shared__ uint16_t sexp[256];

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
  for (int i = threadIdx.x; i < (1 << KB); i += kThreads)
    sexp[i] = (uint16_t)((unsigned)dict[i] << 7);
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = (K + BK - 1) / BK;
  Regs<KB> r;
  if (nk > 0) load_tile<KB>(r, x, signman, planes, M, K, N, m0, n0, 0, vec_x);
  for (int t = 0; t < nk; ++t) {
    if (t > 0) __syncthreads();              // last step's products done
    store_tile<KB>(r, sexp, xs, ws);
    __syncthreads();
    if (t + 1 < nk)
      load_tile<KB>(r, x, signman, planes, M, K, N, m0, n0, (t + 1) * BK,
                    vec_x);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(
            b[j], reinterpret_cast<const __nv_bfloat16*>(ws + kk * WLD + wn + 16 * j),
            WLD);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (m0 + wm + 16 * i >= M) continue;  // warp-uniform
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(
            a, reinterpret_cast<const __nv_bfloat16*>(xs + (wm + 16 * i) * XLD + kk),
            XLD);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
      }
    }
  }

  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (m0 + wm + 16 * i >= M) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gm = m0 + wm + 16 * i + (e >> 4);
        const int gn = n0 + wn + 16 * j + (e & 15);
        if (gm < M && gn < N) out[(long long)gm * N + gn] = st[e];
      }
      __syncwarp();
    }
  }
}

template <int KB>
cudaError_t launch(const void* x, const void* signman, const void* planes,
                   const void* dict, void* out, int M, int K, int N,
                   bool vec_x, cudaStream_t stream) {
  dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM));
  decompress_matmul_kernel<KB><<<grid, kThreads, 0, stream>>>(
      (const uint16_t*)x, (const uint8_t*)signman, (const uint32_t*)planes,
      (const uint8_t*)dict, (float*)out, M, K, N, vec_x);
  return cudaGetLastError();
}

}  // namespace

extern "C" int decompress_matmul_launch(const void* x, const void* signman,
                                        const void* planes, const void* dict,
                                        void* out, int M, int K, int N, int k,
                                        int vec_x, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1: return (int)launch<1>(x, signman, planes, dict, out, M, K, N, vec_x, s);
    case 2: return (int)launch<2>(x, signman, planes, dict, out, M, K, N, vec_x, s);
    case 3: return (int)launch<3>(x, signman, planes, dict, out, M, K, N, vec_x, s);
    case 4: return (int)launch<4>(x, signman, planes, dict, out, M, K, N, vec_x, s);
    case 5: return (int)launch<5>(x, signman, planes, dict, out, M, K, N, vec_x, s);
    case 6: return (int)launch<6>(x, signman, planes, dict, out, M, K, N, vec_x, s);
    case 7: return (int)launch<7>(x, signman, planes, dict, out, M, K, N, vec_x, s);
    case 8: return (int)launch<8>(x, signman, planes, dict, out, M, K, N, vec_x, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
