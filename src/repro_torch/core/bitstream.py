"""Bit-exact LEXI-H bitstream encode/decode (numpy oracle; a copy of
``repro/core/bitstream.py``: the bytes are the same).

This is the software model of the paper's wire format: a per-layer canonical
codebook header followed by the concatenated prefix-free codewords (escapes
carry a raw 8-bit exponent suffix).  It is used as

* the oracle for compression-ratio experiments (Table 2),
* the reference the staged-LUT hardware decoder model is checked against,
* the storage format of LEXI-compressed checkpoints.

Encoding is vectorized (bit matrix + scatter + packbits); decoding walks the
stream with canonical first-code tables — O(total_symbols) python, used on
test/benchmark-sized streams.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from . import huffman
from .huffman import Codebook, ESCAPE, RAW_EXP_BITS

_HEADER_SYM_BITS = 8
_HEADER_LEN_BITS = 5


@dataclasses.dataclass(frozen=True)
class EncodedStream:
    """A compressed exponent stream + its codebook (flit payload model)."""

    payload: bytes          # packed codeword bitstream (MSB-first)
    n_symbols: int          # number of exponents coded
    total_bits: int         # payload bits actually used (<= 8*len(payload))
    book: Codebook

    @property
    def header_bits(self) -> int:
        return self.book.header_bits()

    @property
    def coded_bits(self) -> int:
        """Header + payload bits — the Table-2 denominator."""
        return self.total_bits + self.header_bits

    @property
    def cr(self) -> float:
        return (8.0 * self.n_symbols) / max(self.coded_bits, 1)


def encode(exp_stream: np.ndarray, book: Codebook | None = None) -> EncodedStream:
    """Encode an exponent byte stream with a (possibly fresh) codebook."""
    exp = np.ascontiguousarray(exp_stream, dtype=np.uint8).reshape(-1)
    if book is None:
        hist = np.bincount(exp, minlength=256).astype(np.float64)
        book = huffman.build_codebook(hist)
    # Per-element emitted (value, nbits): escapes append the raw exponent.
    codes = book.enc_code[exp].astype(np.uint64)
    lens = book.enc_len[exp].astype(np.int64)
    is_esc = ~book.in_alphabet[exp]
    codes = np.where(is_esc, (codes << RAW_EXP_BITS) | exp.astype(np.uint64), codes)
    lens = np.where(is_esc, lens + RAW_EXP_BITS, lens)
    total_bits = int(lens.sum())
    offsets = np.cumsum(lens) - lens
    lmax = int(lens.max()) if len(lens) else 1
    # bit j (MSB-first within each codeword) of element i:
    shift = (lens[:, None] - 1 - np.arange(lmax)[None, :])
    valid = shift >= 0
    bits = (codes[:, None] >> np.maximum(shift, 0).astype(np.uint64)) & 1
    pos = offsets[:, None] + np.arange(lmax)[None, :]
    flat = np.zeros(total_bits + 8, dtype=np.uint8)
    flat[pos[valid]] = bits[valid].astype(np.uint8)
    payload = np.packbits(flat[:total_bits]).tobytes()
    return EncodedStream(payload=payload, n_symbols=len(exp),
                         total_bits=total_bits, book=book)


def decode(stream: EncodedStream) -> np.ndarray:
    """Canonical decode back to the exponent byte stream (bit-exact)."""
    book = stream.book
    first_code, first_index, symbols = book.decode_tables()
    max_l = int(book.lengths.max())
    counts = np.bincount(book.lengths, minlength=max_l + 2)
    bits = np.unpackbits(np.frombuffer(stream.payload, dtype=np.uint8))
    out = np.empty(stream.n_symbols, dtype=np.uint8)
    p = 0
    for i in range(stream.n_symbols):
        code = 0
        l = 0
        while True:
            code = (code << 1) | int(bits[p]); p += 1; l += 1
            if l > max_l:
                raise ValueError("corrupt bitstream: no codeword match")
            idx = code - int(first_code[l])
            if counts[l] > 0 and 0 <= idx < counts[l]:
                sym = int(symbols[int(first_index[l]) + idx])
                break
        if sym == ESCAPE:
            raw = 0
            for _ in range(RAW_EXP_BITS):
                raw = (raw << 1) | int(bits[p]); p += 1
            out[i] = raw
        else:
            out[i] = sym
    assert p == stream.total_bits, (p, stream.total_bits)
    return out


# ---------------------------------------------------------------------------
# Whole-tensor (BF16) container: signman bytes + coded exponents + header.
# This is the checkpoint/wire format for full values, not just exponents.
# ---------------------------------------------------------------------------

def serialize_codebook(book: Codebook) -> bytes:
    """Canonical header: count + (symbol, length) pairs; symbol 0xFF+len marks
    ESCAPE (symbol id 256 does not fit a byte, so it is flagged)."""
    out = bytearray([len(book.symbols)])
    for s, l in zip(book.symbols, book.lengths):
        if int(s) == ESCAPE:
            out += bytes([0xFF, 0x80 | int(l)])
        else:
            out += bytes([int(s), int(l)])
    return bytes(out)


def deserialize_codebook(data: bytes) -> Tuple[Codebook, int]:
    n = data[0]
    symbols = np.zeros(n, dtype=np.int32)
    lengths = np.zeros(n, dtype=np.int32)
    for i in range(n):
        s, l = data[1 + 2 * i], data[2 + 2 * i]
        if l & 0x80:
            symbols[i], lengths[i] = ESCAPE, l & 0x7F
        else:
            symbols[i], lengths[i] = s, l
    codes = huffman.canonical_codes(
        {int(s): int(l) for s, l in zip(symbols, lengths)})
    enc_code = np.zeros(257, dtype=np.int64)
    enc_len = np.zeros(257, dtype=np.int32)
    in_alpha = np.zeros(256, dtype=bool)
    esc_code, esc_len = codes[ESCAPE]
    for s in range(256):
        if s in codes:
            enc_code[s], enc_len[s] = codes[s]
            in_alpha[s] = True
        else:
            enc_code[s], enc_len[s] = esc_code, esc_len
    enc_code[ESCAPE], enc_len[ESCAPE] = esc_code, esc_len
    book = Codebook(symbols=symbols, lengths=lengths, enc_code=enc_code,
                    enc_len=enc_len, in_alphabet=in_alpha)
    return book, 1 + 2 * n


def compress_bf16(u16: np.ndarray) -> bytes:
    """Full LEXI container for a BF16 tensor (given as uint16 bit patterns):

        [u32 n] [codebook] [signman bytes] [u32 payload_bits] [payload]
    """
    from . import entropy as E
    u16 = np.ascontiguousarray(u16, dtype=np.uint16).reshape(-1)
    _, exp, _ = E.split_fields(u16)
    sm = E.signman_byte(u16)
    st = encode(exp)
    out = bytearray()
    out += np.uint32(len(u16)).tobytes()
    out += serialize_codebook(st.book)
    out += sm.tobytes()
    out += np.uint32(st.total_bits).tobytes()
    out += st.payload
    return bytes(out)


def decompress_bf16(blob: bytes) -> np.ndarray:
    """Inverse of :func:`compress_bf16` -> uint16 bit patterns."""
    from . import entropy as E
    n = int(np.frombuffer(blob[:4], dtype=np.uint32)[0])
    book, consumed = deserialize_codebook(blob[4:])
    off = 4 + consumed
    sm = np.frombuffer(blob[off:off + n], dtype=np.uint8)
    off += n
    total_bits = int(np.frombuffer(blob[off:off + 4], dtype=np.uint32)[0])
    off += 4
    payload = blob[off:]
    st = EncodedStream(payload=payload, n_symbols=n, total_bits=total_bits,
                       book=book)
    exp = decode(st)
    sign = (sm >> 7).astype(np.uint16)
    man = (sm & 0x7F).astype(np.uint16)
    return E.combine_fields(sign, exp, man)


# ---------------------------------------------------------------------------
# LEXI-F32 (beyond-paper): the same exponent-only coding applied to float32.
# f32 = sign(1) | exp(8) | mantissa(23): exponents of optimizer states share
# the bell-shaped concentration the paper profiles for bf16, so coding the
# exponent byte takes 32 -> ~26.6 bits (~1.2x) — applied to checkpointed
# AdamW master/m (v is chi-squared-ish but still compresses ~1.15x).
# ---------------------------------------------------------------------------

def compress_f32(x: np.ndarray) -> bytes:
    """Container: [u32 n][codebook][signman24 3n bytes][u32 bits][payload]."""
    u32 = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32).reshape(-1)
    exp = ((u32 >> 23) & 0xFF).astype(np.uint8)
    # sign bit + 23-bit mantissa packed as 3 little-endian bytes per value
    sm = ((u32 >> 31) << 23) | (u32 & 0x7FFFFF)
    sm_bytes = np.empty((u32.size, 3), np.uint8)
    sm_bytes[:, 0] = sm & 0xFF
    sm_bytes[:, 1] = (sm >> 8) & 0xFF
    sm_bytes[:, 2] = (sm >> 16) & 0xFF
    st = encode(exp)
    out = bytearray()
    out += np.uint32(u32.size).tobytes()
    out += serialize_codebook(st.book)
    out += sm_bytes.tobytes()
    out += np.uint32(st.total_bits).tobytes()
    out += st.payload
    return bytes(out)


def decompress_f32(blob: bytes) -> np.ndarray:
    n = int(np.frombuffer(blob[:4], dtype=np.uint32)[0])
    book, consumed = deserialize_codebook(blob[4:])
    off = 4 + consumed
    sm_bytes = np.frombuffer(blob[off:off + 3 * n], dtype=np.uint8
                             ).reshape(n, 3).astype(np.uint32)
    off += 3 * n
    total_bits = int(np.frombuffer(blob[off:off + 4], dtype=np.uint32)[0])
    payload = blob[off + 4:]
    st = EncodedStream(payload=payload, n_symbols=n, total_bits=total_bits,
                       book=book)
    exp = decode(st).astype(np.uint32)
    sm = sm_bytes[:, 0] | (sm_bytes[:, 1] << 8) | (sm_bytes[:, 2] << 16)
    u32 = ((sm >> 23) << 31) | (exp << 23) | (sm & 0x7FFFFF)
    return u32.astype(np.uint32).view(np.float32)
