// The prefill route of decompress_matmul (csrc/decompress_matmul.cu, whose
// C entry point launches it as route 0): large M,
//     out (M, N) f32 = x (M, K) bf16 @ W (K, N),
// W LEXI-packed: signman (K, N) uint8, planes (k, K, N/32) uint32, dict
// (2^k,) uint8 (the layout is described in decompress_matmul.cu).
//
// Replaces the Pallas kernel repro/kernels/decompress_matmul.py:
// decompress_matmul (_dm_kernel) at prefill shapes (M = prompt tokens).
//
// What bounds it on an H100: the tensor cores (2 M N K operations at
// 989 TFLOP/s bf16) and, beside them, decoding W, which a CTA does once
// per BM rows of x.  A CTA owns a BM x 128 output tile (BM = 128 or 256)
// and walks K in steps of 64 rows, its warpgroups specialised:
//   * two consumer warpgroups, each MT = BM / 128 m64 row tiles, issue
//     wgmma.m64n128k16 (bf16 in, f32 accumulators in registers) with x as
//     A (K-major) and the decoded W as B (MN-major: W is N-contiguous),
//     both from shared memory.  Each copies its own rows of x by cp.async
//     (16-byte copies, zero-filled past M and K) into a ring of kXRing
//     slots, two steps ahead, and keeps one step's products in flight;
//   * one producer warpgroup copies the packed W (signman and plane
//     words, zero-filled past K and N) into a ring of kPRing slots, three
//     steps ahead, each thread exactly the bytes it decodes, and decodes
//     each tile with decode16 (lexi_decode.cuh) into a ring of kWRing bf16
//     tiles in the swizzled MN-major layout wgmma reads for B (64-column
//     atoms of 64 K rows x 128 bytes, 16-byte chunk c of row r at c ^
//     (r % 8)), by ordinary stores;
//   * a decoded tile changes hands through mbarriers: full (the producer's
//     stores, after fence.proxy.async) and empty (the consumers, once the
//     products that read it are done), so the producer runs up to kWRing
//     tiles ahead, the decode overlaps the products, and no barrier spans
//     the CTA in the K loop;
//   * the epilogue writes f32 straight from the accumulator fragments, two
//     floats per store, masked at the M and N edges.  Deterministic: one
//     CTA owns each output, the K loop runs in order, no atomics.
// Measured on the H100 (scripts/prefill_probe.py): the producer's decode
// is the limit (four warps decode a 64 x 128 tile in about 1.7 us, the
// products of a 256-row step take about 0.8 us), which is why BM = 256:
// it halves the decode per row of x.  384 threads leave 168 registers
// each, room for the consumers' 2 x 64 accumulators (at 512 threads the
// 128-register cap spills them, and setmaxnreg did not lift it).
// Rows of W past K decode to 0 and the columns of x past K load as 0, so
// the last (ragged) K step adds nothing but its valid rows.  x is copied
// with 16-byte cp.async when K % 8 == 0 and x is 16-byte aligned (vec_x),
// else element by element.  The grid walks M fastest, so the CTAs that
// share a column tile of W run together and read it from L2.
//
// Templated on k (1..8) and MT; kernels/decompress_matmul.py:plan picks BM
// per shape.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lexi_decode.cuh"

namespace {

constexpr int kBK = 64;                // K rows per step: 128 bytes of x
constexpr int kBN = 128;               // output columns per CTA
constexpr int kWPR = kBN / 32;         // plane words per row of a W tile
constexpr int kWRing = 4;              // decoded W tiles (producers ahead)
constexpr int kXRing = 3;              // x tiles (loaded two steps ahead)
constexpr int kPRing = 3;              // packed W tiles (three steps ahead)
constexpr int kAtom = kBK * 128;       // one 64-column atom of a W tile
constexpr int kWTile = kBK * kBN * 2;  // one decoded bf16 W tile
constexpr int kMaxSmem = 232448;       // an H100 CTA's shared memory

// One packed W slot: the signman tile, then the k plane tiles.
__host__ __device__ constexpr int packed_bytes(int kb) {
  return (kBK * kBN + kb * kBK * kBN / 8 + 1023) / 1024 * 1024;
}

// Dynamic shared memory of a launch: the rings of decoded W tiles, x
// tiles and packed W tiles, and 1 KB of slack to align the tiles to the
// 1024-byte swizzle pattern.
__host__ __device__ constexpr int smem_bytes(int kb, int bm) {
  return kWRing * kWTile + kXRing * bm * kBK * 2 + kPRing * packed_bytes(kb) +
         1024;
}

struct Args {
  const uint16_t* x;
  const uint8_t* signman;
  const uint32_t* planes;
  const uint8_t* dict;
  float* out;
  int M, K, N, vec_x;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of 16 or 4 bytes, of which `src_bytes` are read and the rest
// zero-filled (0: nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Make this thread's shared-memory writes (stores and cp.async) visible
// to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin the accumulators around the asynchronous products, so the compiler
// moves no access to them across a fence or a wait.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (16-byte units), layout
// type 1 (SWIZZLE_128B) in bits 62-63.  K-major A (x): LBO unused, SBO =
// 1024 (8 rows of 128 bytes).  MN-major B (W): LBO = the stride between
// 64-column atoms, SBO = 1024 (8 K rows of one atom).
__device__ __forceinline__ uint64_t desc128(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// wgmma.m64n128k16.f32.bf16.bf16, A and B from shared memory, B MN-major
// (imm-trans-b 1), accumulating into d.
struct Wgmma {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

// mbarriers in shared memory (phase parity waits; arrivals release).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done;
}

// Wait until the phase of parity `parity` has completed.  A lost arrival
// traps (a launch error) after some seconds instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (unsigned spins = 0; !mbar_try_wait(bar, parity);)
    if (++spins == (1u << 24)) __trap();
}

// A barrier of one warpgroup (id 1 + warpgroup; 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// A consumer warpgroup's copies of its `rows` rows of x (rows r0 .. r0 +
// rows - 1 of the tile, columns k0 .. k0 + 63) into its part of an x slot
// (`xs`: the slot's row r0).
template <int ROWS>
__device__ __forceinline__ void load_x(const Args& a, unsigned char* xs,
                                       int gm0, int k0, int t4) {
  if (a.vec_x) {
#pragma unroll
    for (int j = 0; j < ROWS * 8 / 128; ++j) {
      const int i = t4 + j * 128, m = i >> 3, c = i & 7;
      const int gm = gm0 + m, kc = k0 + 8 * c;
      const bool ok = gm < a.M && kc < a.K;
      cp_async16(xs + m * 128 + ((c ^ (m & 7)) << 4),
                 ok ? a.x + (long long)gm * a.K + kc : a.x, ok ? 16 : 0);
    }
  } else {                               // plain loads, then stores
#pragma unroll 8
    for (int i = t4; i < ROWS * kBK; i += 128) {
      const int m = i >> 6, j = i & 63;
      const int gm = gm0 + m, kc = k0 + j;
      *(uint16_t*)(xs + m * 128 + (((j >> 3) ^ (m & 7)) << 4) + (j & 7) * 2) =
          gm < a.M && kc < a.K ? a.x[(long long)gm * a.K + kc] : 0;
    }
  }
}

// The packed W tile of step k0 / 64, split among the 128 producer
// threads: thread p owns rows r and r + 32 (r = 8 (p / 32) + p % 8) and
// plane word q = (p % 32) / 8 of the 64 x 128 tile, i.e. 32 columns of
// each row, and copies exactly the bytes it decodes: two 16-byte signman
// chunks per row (stored with the 128-byte swizzle, chunk c of row r at c
// ^ (r % 8)) and its word of each of the k plane tiles ([b][row][4
// words]).  No other thread reads them, so a thread's own
// cp.async.wait_group is all the synchronisation the packed ring needs.
struct Own {
  int r, q, sw;
  __device__ Own(int p)
      : r((p >> 5) * 8 + (p & 7)), q((p & 31) >> 3), sw(r & 7) {}
};

template <int KB>
__device__ __forceinline__ void load_packed(const Args& a, unsigned char* sm,
                                            const Own& o, int n0, int k0) {
  const int col = n0 + 32 * o.q, nw = a.N >> 5;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = o.r + 32 * u, kr = k0 + r;
    const bool ok = kr < a.K && col < a.N;
    const uint8_t* src =
        ok ? a.signman + (long long)kr * a.N + col : a.signman;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      cp_async16(sm + r * kBN + (((2 * o.q + h) ^ o.sw) << 4), src + 16 * h,
                 ok ? 16 : 0);
    uint32_t* pl = (uint32_t*)(sm + kBK * kBN) + r * kWPR + o.q;
#pragma unroll
    for (int b = 0; b < KB; ++b)
      cp_async4(pl + b * kBK * kWPR,
                ok ? a.planes + ((long long)b * a.K + kr) * nw + (col >> 5)
                   : a.planes,
                ok ? 4 : 0);
  }
}

// Decode the thread's 2 x 32 columns of one packed tile (both halves of
// each plane word through decode16: four independent decodes) into the
// bf16 tile in wgmma's MN-major 128-byte-swizzled layout: 64-column atoms
// of 64 K rows x 128 bytes, 16-byte chunk c of row r at c ^ (r % 8).
// Every quarter-warp reads and writes 8 distinct banks (8 rows, one
// column group).  Rows at or past `valid` (the end of K) decode to 0.
template <int KB>
__device__ __forceinline__ void decode_tile(const unsigned char* sm,
                                            const uint16_t* lut,
                                            unsigned char* wt, const Own& o,
                                            int valid) {
  uint4 h[2][4];
  uint32_t bits[2][2][KB];
  uint4 smv[2][2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = o.r + 32 * u;
    const uint32_t* pw = (const uint32_t*)(sm + kBK * kBN) + r * kWPR + o.q;
#pragma unroll
    for (int b = 0; b < KB; ++b) {
      const uint32_t w = pw[b * kBK * kWPR];
      bits[u][0][b] = w;
      bits[u][1][b] = w >> 16;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      smv[u][i] = *(const uint4*)(sm + r * kBN + (((2 * o.q + i) ^ o.sw) << 4));
  }
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      lexi::decode16<KB>(smv[u][i], bits[u][i], lut, h[u][2 * i],
                         h[u][2 * i + 1]);
  // columns 32 q .. 32 q + 31: chunks 4 (q % 2) .. + 3 of atom q / 2
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = o.r + 32 * u;
    unsigned char* row = wt + (o.q >> 1) * kAtom + r * 128;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *(uint4*)(row + (((4 * (o.q & 1) + i) ^ o.sw) << 4)) =
          r < valid ? h[u][i] : make_uint4(0, 0, 0, 0);
  }
}

// The products of one K step: 4 k16 slices of each of this warpgroup's MT
// m64 row tiles (rows past M multiply zeros: a wgmma under a branch would
// be serialized).
template <int MT>
__device__ __forceinline__ void issue_products(float (&acc)[MT][64],
                                               uint32_t xs, uint32_t wt) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t db = desc128(wt + kk * 16 * 128, kAtom, 1024);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      Wgmma::mma(acc[mt], desc128(xs + mt * 64 * 128 + kk * 32, 16, 1024),
                 db);
  }
}

// Warp-specialised: warpgroups 0 and 1 (consumers) each own MT m64 row
// tiles of the CTA's BM = 128 MT rows: they copy their own rows of x
// (kXRing slots, loaded two steps ahead) and issue the wgmma products;
// warpgroup 2 (the producer) copies and decodes the packed W (kPRing
// slots, loaded kPRing steps ahead) into a ring of kWRing decoded tiles.
// A decoded tile is handed over through mbarriers: full (the 128
// producers' stores, after fence.proxy.async) and empty (the 256
// consumers, once the products that read it are done), so the producer
// runs up to kWRing tiles ahead and no barrier spans the CTA.  384
// threads leave 168 registers each: the consumers' 2 x 64 accumulators
// fit beside their addressing.
template <int KB, int MT>
__global__ void __launch_bounds__(384, 1) prefill_kernel(const Args a) {
  constexpr int BM = 128 * MT, X_TILE = BM * kBK * 2;
  constexpr int PACKED = packed_bytes(KB);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ uint16_t lut[256];
  __shared__ uint64_t full[kWRing], empty[kWRing];
  unsigned char* wring =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  unsigned char* xring = wring + kWRing * kWTile;
  unsigned char* pring = xring + kXRing * X_TILE;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN;
  const int nk = (a.K + kBK - 1) / kBK;

  if (tid == 0) {
    for (int i = 0; i < kWRing; ++i) {
      mbar_init(&full[i], 128);
      mbar_init(&empty[i], 256);
    }
  }
  for (int i = tid; i < (1 << KB); i += 384)
    lut[i] = (uint16_t)(a.dict[i] << 7);
  __syncthreads();

  if (wg == 2) {                                  // the producer
    const Own o(tid - 256);
    for (int s = 0; s < kPRing; ++s) {
      if (s < nk) load_packed<KB>(a, pring + s * PACKED, o, n0, s * kBK);
      cp_commit();
    }
    for (int t = 0; t < nk; ++t) {
      const int w = t % kWRing;
      cp_wait<kPRing - 1>();                      // my part of tile t
      if (t >= kWRing) mbar_wait(&empty[w], (t / kWRing - 1) & 1);
      decode_tile<KB>(pring + (t % kPRing) * PACKED, lut,
                      wring + w * kWTile, o, a.K - t * kBK);
      fence_async_smem();
      mbar_arrive(&full[w]);
      if (t + kPRing < nk)
        load_packed<KB>(a, pring + (t % kPRing) * PACKED, o, n0,
                        (t + kPRing) * kBK);
      cp_commit();
    }
  } else {                                        // consumers
    const int t4 = tid & 127, gm0 = m0 + wg * 64 * MT;
    unsigned char* xpart = xring + wg * 64 * MT * 128;
    for (int s = 0; s < kXRing - 1; ++s) {
      if (s < nk) load_x<64 * MT>(a, xpart + s * X_TILE, gm0, s * kBK, t4);
      cp_commit();
    }
    float acc[MT][64];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[mt][i] = 0.f;
    for (int t = 0; t < nk; ++t) {
      const int w = t % kWRing;
      cp_wait<kXRing - 2>();                      // my part of x(t)
      fence_async_smem();
      warpgroup_sync(wg);                         // the warpgroup's x(t)
      mbar_wait(&full[w], (t / kWRing) & 1);      // decoded W(t)
      fence_async_smem();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_operands(acc[mt]);
      wgmma_fence();
      issue_products<MT>(acc, smem_addr(xpart + (t % kXRing) * X_TILE),
                         smem_addr(wring + w * kWTile));
      wgmma_commit();
      wgmma_wait<1>();                            // step t - 1 done
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_operands(acc[mt]);
      if (t > 0) mbar_arrive(&empty[(t - 1) % kWRing]);
      // x(t - 1)'s slot is free in this warpgroup
      if (t + kXRing - 1 < nk)
        load_x<64 * MT>(a, xpart + ((t + kXRing - 1) % kXRing) * X_TILE,
                        gm0, (t + kXRing - 1) * kBK, t4);
      cp_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_operands(acc[mt]);

    // accumulator fragment of m64n128: warp w of the warpgroup holds rows
    // 16 w + l / 4 (+ 8), register 4 i + e column 8 i + 2 (l % 4) (+ 1)
    const int rows = a.M - m0, w4 = (tid >> 5) & 3, lane = tid & 31;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r0 = (wg * MT + mt) * 64 + w4 * 16 + (lane >> 2);
      const long long o0 = (long long)(m0 + r0) * a.N + n0 + 2 * (lane & 3);
      const long long o8 = o0 + 8LL * a.N;
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i) {
        if (n0 + 8 * i + 2 * (lane & 3) >= a.N) continue;
        if (r0 < rows)
          *(float2*)(a.out + o0 + 8 * i) =
              make_float2(acc[mt][4 * i], acc[mt][4 * i + 1]);
        if (r0 + 8 < rows)
          *(float2*)(a.out + o8 + 8 * i) =
              make_float2(acc[mt][4 * i + 2], acc[mt][4 * i + 3]);
      }
    }
  }
}

template <int KB, int MT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int BM = 128 * MT, smem = smem_bytes(KB, BM);
  static_assert(smem <= kMaxSmem, "prefill tile over the shared memory");
  static bool lifted = false;        // the attribute, once per instantiation
  if (!lifted) {
    const cudaError_t e = cudaFuncSetAttribute(
        prefill_kernel<KB, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    lifted = true;
  }
  dim3 grid((unsigned)((a.M + BM - 1) / BM),
            (unsigned)((a.N + kBN - 1) / kBN));
  prefill_kernel<KB, MT><<<grid, 384, smem, stream>>>(a);
  return cudaGetLastError();
}

// BM = 128 (one m64 tile per consumer warpgroup) or 256 (two).
template <int KB>
cudaError_t launch_tile(const Args& a, int bm, cudaStream_t s) {
  if (bm == 128) return launch<KB, 1>(a, s);
  if (bm == 256) return launch<KB, 2>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Route 0 of decompress_matmul_launch (decompress_matmul.cu): BM x 128
// tiles (BM 128 or 256).
cudaError_t decompress_matmul_prefill(const void* x, const void* signman,
                                      const void* planes, const void* dict,
                                      void* out, int M, int K, int N, int k,
                                      int bn, int bm, int vec_x,
                                      cudaStream_t s) {
  if (bn != kBN) return cudaErrorInvalidValue;
  const Args a{(const uint16_t*)x, (const uint8_t*)signman,
               (const uint32_t*)planes, (const uint8_t*)dict, (float*)out,
               M, K, N, vec_x};
  switch (k) {
    case 1: return launch_tile<1>(a, bm, s);
    case 2: return launch_tile<2>(a, bm, s);
    case 3: return launch_tile<3>(a, bm, s);
    case 4: return launch_tile<4>(a, bm, s);
    case 5: return launch_tile<5>(a, bm, s);
    case 6: return launch_tile<6>(a, bm, s);
    case 7: return launch_tile<7>(a, bm, s);
    case 8: return launch_tile<8>(a, bm, s);
    default: return cudaErrorInvalidValue;
  }
}

// The prefill route's dynamic shared memory per CTA, in bytes (0: not a
// tile the route has).
extern "C" int decompress_matmul_prefill_smem(int bn, int bm, int k) {
  if (k < 1 || k > 8 || bn != kBN || (bm != 128 && bm != 256)) return 0;
  return smem_bytes(k, bm);
}
