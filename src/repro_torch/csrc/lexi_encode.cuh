// The one encode routine of the LEXI-FW packed format, the inverse of
// lexi_decode.cuh's decode16: 32 bf16 elements -> their 32 signman bytes
// and the KB plane words of their codes (the format is described there).
// lexi_pack.cu is its only user today.
//
// An 8 x 8 bit transpose is its own inverse, so the decode side's
// transpose8x8 serves here too: fed 8 elements' codes (byte j: element
// j), it returns their plane bytes (byte b: bit b of each code, bit j for
// element j).

#pragma once

#include <stdint.h>

#include "lexi_decode.cuh"

namespace lexi {

// Planes BASE .. BASE + 3 (those below KB) from the transposed groups r[g]
// (byte b: plane BASE + b's bits of elements 8g .. 8g + 7): a 4 x 4 byte
// transpose.
template <int KB, int BASE>
__device__ __forceinline__ void gather_planes(const uint32_t (&r)[4],
                                              uint32_t (&plane)[KB]) {
  const uint32_t p01 = __byte_perm(r[0], r[1], 0x5140);     // bytes 0, 1
  const uint32_t p23 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t q01 = __byte_perm(r[0], r[1], 0x7362);     // bytes 2, 3
  const uint32_t q23 = __byte_perm(r[2], r[3], 0x7362);
  const uint32_t out[4] = {
      __byte_perm(p01, p23, 0x5410), __byte_perm(p01, p23, 0x7632),
      __byte_perm(q01, q23, 0x5410), __byte_perm(q01, q23, 0x7632)};
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (BASE + b < KB) plane[BASE + b] = out[b];
}

// 32 elements (x: 16 words, word i = elements 2i and 2i + 1, low half
// first, as a 16-byte-aligned load gives them) -> sm (the signman bytes,
// byte j of the 32: element j) and plane[b] for b < KB (bit j: bit b of
// element j's code).  code_of[e] is the code of exponent e.
// Per 4 elements: two byte permutes split the low and high bytes; one
// LOP3 gives the signman bytes, three more the exponent bytes; four
// shared-memory byte loads look up the codes.  Then one 8 x 8 transpose
// per 8 elements, and a 4 x 4 byte transpose (byte permutes) per 4
// planes gathers plane b's bytes of the 4 groups into its word.
// About 9 instructions per element at any k.
template <int KB>
__device__ __forceinline__ void encode32(const uint32_t (&x)[16],
                                         const uint8_t* __restrict__ code_of,
                                         uint4 (&sm)[2],
                                         uint32_t (&plane)[KB]) {
  static_assert(KB >= 1 && KB <= 8, "code width 1..8");
  uint32_t smw[8], codes[8];          // byte i of [j]: element 4j + i
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t lo = __byte_perm(x[2 * j], x[2 * j + 1], 0x6420);
    const uint32_t hi = __byte_perm(x[2 * j], x[2 * j + 1], 0x7531);
    smw[j] = (hi & 0x80808080u) | (lo & 0x7F7F7F7Fu);
    const uint32_t e = ((hi << 1) & 0xFEFEFEFEu) | ((lo >> 7) & 0x01010101u);
    const uint32_t c0 = code_of[e & 0xFFu], c1 = code_of[(e >> 8) & 0xFFu];
    const uint32_t c2 = code_of[(e >> 16) & 0xFFu], c3 = code_of[e >> 24];
    codes[j] = __byte_perm(__byte_perm(c0, c1, 0x0040),
                           __byte_perm(c2, c3, 0x0040), 0x5410);
  }
  sm[0] = make_uint4(smw[0], smw[1], smw[2], smw[3]);
  sm[1] = make_uint4(smw[4], smw[5], smw[6], smw[7]);
  // group g (elements 8g .. 8g + 7): planes 0-3 in lo[g], 4-7 in hi[g]
  uint32_t lo[4], hi[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    lo[g] = codes[2 * g];
    hi[g] = codes[2 * g + 1];
    transpose8x8<true>(lo[g], hi[g]);
  }
  gather_planes<KB, 0>(lo, plane);
  if constexpr (KB > 4) gather_planes<KB, 4>(hi, plane);
}

}  // namespace lexi
