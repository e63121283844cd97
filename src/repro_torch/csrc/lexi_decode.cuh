// The one decode routine of the LEXI-FW packed format, shared by every
// kernel that reads it: the two decode-attention kernels
// (decode_attend_body.cuh), decompress_matmul.cu and lexi_unpack.cu.
//
// The format: element i of a record is a signman byte (sign in bit 7,
// the 7 mantissa bits below) and a k-bit exponent code, stored as k bit
// planes: bit b of the codes of elements 32w .. 32w + 31 is plane word
// (b, w), bit j of the word for element 32w + j.  The record's dictionary
// maps a code to the exponent byte.  Every kernel takes the dictionary
// pre-shifted into the exponent field of a bf16 (lut[code] = exp << 7, a
// 16-bit entry), staged in shared memory at an address the compiler
// knows (a static array, or the start of dynamic shared memory), so a
// lookup is one load from a register's byte offset.

#pragma once

#include <stdint.h>

namespace lexi {

// Codes of 8 elements from an 8 x 8 bit matrix: byte b of (x, y) (b < 4
// in x, the rest in y) holds plane b's bits of the 8 elements, bit j for
// element j; on return byte j holds element j's code.  Three rounds of
// block swaps (2 x 2, 4 x 4, 8 x 8 bits), about 20 operations for 8 codes
// at any k; y = 0 (KB <= 4) costs 11.
template <bool HasY>
__device__ __forceinline__ void transpose8x8(uint32_t& x, uint32_t& y) {
  uint32_t t = (x ^ (x >> 7)) & 0x00AA00AAu;
  x ^= t ^ (t << 7);
  if constexpr (HasY) {
    t = (y ^ (y >> 7)) & 0x00AA00AAu;
    y ^= t ^ (t << 7);
  }
  t = (x ^ (x >> 14)) & 0x0000CCCCu;
  x ^= t ^ (t << 14);
  if constexpr (HasY) {
    t = (y ^ (y >> 14)) & 0x0000CCCCu;
    y ^= t ^ (t << 14);
  }
  t = (x ^ (y << 4)) & 0xF0F0F0F0u;
  x ^= t;
  y ^= t >> 4;
}

// prmt in its default mode: a selector nibble 8 | i gives byte i's sign
// bit in all eight bits.
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// 16 elements from their signman bytes and the low 16 bits of each of the
// KB plane words (bit j: element j); lut[code] is the exponent already
// shifted to bit 7.  A plane word covers 32 elements, so a whole word is
// two calls: the low half, then the word shifted right by 16.
// Codes: byte g of every plane, gathered with byte permutes, then one
// 8 x 8 bit transpose per 8 elements.  For KB <= 7 plane b goes to row
// b + 1, so each code comes out doubled: the byte offset of its 16-bit
// LUT entry.  Values: one sign-replicating byte permute puts each
// signman byte's mantissa in bits 0-6 and its sign in bits 8-15 of a
// half-word; masked (0x807F) and or-ed with the exponents.  About 6
// instructions per element at k = 5.
template <int KB>
__device__ __forceinline__ void decode16(const uint4 smv,
                                         const uint32_t (&bits)[KB],
                                         const uint16_t* __restrict__ lut,
                                         uint4& h0, uint4& h1) {
  static_assert(KB >= 1 && KB <= 8, "code width 1..8");
  constexpr bool kDoubled = KB <= 7;
  constexpr bool kHasY = kDoubled ? KB > 3 : true;
  auto plane = [&](int b) { return b < KB ? bits[b] : 0u; };
  // pairs of rows, bytes [row i .0, row i+1 .0, row i .1, row i+1 .1]
  uint32_t r01, r23, r45 = 0, r67 = 0;
  if constexpr (kDoubled) {
    r01 = __byte_perm(plane(0), 0u, 0x1404);      // row 0 is zero
    r23 = __byte_perm(plane(1), plane(2), 0x5140);
    if constexpr (kHasY) {
      r45 = __byte_perm(plane(3), plane(4), 0x5140);
      r67 = __byte_perm(plane(5), plane(6), 0x5140);
    }
  } else {
    r01 = __byte_perm(plane(0), plane(1), 0x5140);
    r23 = __byte_perm(plane(2), plane(3), 0x5140);
    r45 = __byte_perm(plane(4), plane(5), 0x5140);
    r67 = __byte_perm(plane(6), plane(7), 0x5140);
  }
  uint32_t codes[4];                  // byte i of codes[j]: element 4j + i
#pragma unroll
  for (int g = 0; g < 2; ++g) {       // elements 8g .. 8g + 7
    const uint32_t sel = g ? 0x7632u : 0x5410u;
    uint32_t x = __byte_perm(r01, r23, sel), y = 0;
    if constexpr (kHasY) y = __byte_perm(r45, r67, sel);
    transpose8x8<kHasY>(x, y);
    codes[2 * g] = x;
    codes[2 * g + 1] = y;
  }
  const unsigned char* lutb = reinterpret_cast<const unsigned char*>(lut);
  const uint32_t sw[4] = {smv.x, smv.y, smv.z, smv.w};
  uint32_t o[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {       // output word j: elements 2j, 2j + 1
    const uint32_t cw = codes[j >> 1], a = 2 * (j & 1);
    uint32_t i0 = __byte_perm(cw, 0u, 0x4440u | a);
    uint32_t i1 = __byte_perm(cw, 0u, 0x4441u | a);
    if constexpr (!kDoubled) {
      i0 <<= 1;
      i1 <<= 1;
    }
    const uint32_t ee =
        __byte_perm(*reinterpret_cast<const uint16_t*>(lutb + i0),
                    *reinterpret_cast<const uint16_t*>(lutb + i1), 0x5410);
    const uint32_t sp = prmt(sw[j >> 1], 0u, (j & 1) ? 0xB3A2u : 0x9180u);
    o[j] = (sp & 0x807F807Fu) | ee;
  }
  h0 = make_uint4(o[0], o[1], o[2], o[3]);
  h1 = make_uint4(o[4], o[5], o[6], o[7]);
}

// One element, for ragged edges: bit j of the KB plane words `w` (at a
// stride of `stride` words), its signman byte `sm`.
template <int KB>
__device__ __forceinline__ uint16_t decode1(const uint32_t* __restrict__ w,
                                            long long stride, int j,
                                            unsigned sm,
                                            const uint16_t* __restrict__ lut) {
  unsigned code = 0;
#pragma unroll
  for (int b = 0; b < KB; ++b) code |= ((w[b * stride] >> j) & 1u) << b;
  return (uint16_t)(((sm & 0x80u) << 8) | lut[code] | (sm & 0x7Fu));
}

}  // namespace lexi
