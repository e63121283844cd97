"""Length-limited canonical Huffman coding over the BF16 exponent alphabet
(a copy of ``repro/core/huffman.py``, which uses numpy only).

This is the paper-faithful LEXI-H codec core (§4.2):

* the main alphabet is the <=31 most frequent exponent symbols plus a
  reserved ESCAPE symbol (32 entries total, matching the 32-entry hardware
  pipeline);
* code lengths are limited to ``MAX_CODE_LEN = 24`` bits (the paper's naive
  decoder is indexed by L_max = 24 bits, and the escape is a 24-bit prefix),
  computed with the package-merge algorithm (optimal under the limit);
* codes are *canonical* so the decoder can be reconstructed from the
  (symbol, length) list alone — this is exactly what the hardware piggybacks
  alongside the bitstream as the per-layer codebook header.

Escape semantics (paper §4.2.2 "Exception handling"): an out-of-alphabet
exponent is emitted as ``ESCAPE code + raw 8-bit exponent``.  In hardware the
escape is the reserved all-ones 24-bit pattern; canonically we give ESCAPE a
pseudo-count of 1 so it lands among the longest codes.  Either choice decodes
identically through the staged-LUT model because canonical order is preserved.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

MAX_CODE_LEN = 24
MAIN_ALPHABET = 32           # paper: 32-entry pipeline (31 symbols + escape)
ESCAPE = 256                 # symbol id for the escape (outside the 8-bit range)
RAW_EXP_BITS = 8             # bits appended after an escape code


def length_limited_lengths(hist: Sequence[float], max_len: int = MAX_CODE_LEN,
                           symbols: Sequence[int] | None = None) -> Dict[int, int]:
    """Optimal length-limited code lengths via package-merge.

    ``hist`` is indexed by symbol; only strictly positive entries (or the
    explicit ``symbols`` subset) participate.  Returns {symbol: length}.
    """
    hist = np.asarray(hist, dtype=np.float64)
    if symbols is None:
        symbols = [int(s) for s in np.nonzero(hist > 0)[0]]
    items: List[Tuple[float, Tuple[int, ...]]] = [
        (float(hist[s]), (int(s),)) for s in symbols
    ]
    n = len(items)
    if n == 0:
        return {}
    if n == 1:
        return {items[0][1][0]: 1}
    if (1 << max_len) < n:
        raise ValueError(f"cannot code {n} symbols within {max_len} bits")
    original = sorted(items)
    packages = list(original)
    for _ in range(max_len - 1):
        paired = [
            (packages[i][0] + packages[i + 1][0],
             packages[i][1] + packages[i + 1][1])
            for i in range(0, len(packages) - 1, 2)
        ]
        packages = sorted(paired + original)
    lengths: Dict[int, int] = {}
    for _, syms in packages[: 2 * n - 2]:
        for s in syms:
            lengths[s] = lengths.get(s, 0) + 1
    # Kraft equality must hold for an optimal prefix code.
    kraft = sum(2.0 ** -l for l in lengths.values())
    assert abs(kraft - 1.0) < 1e-9, f"package-merge Kraft sum {kraft}"
    return lengths


def canonical_codes(lengths: Dict[int, int]) -> Dict[int, Tuple[int, int]]:
    """Canonical (code, length) assignment: sort by (length, symbol)."""
    order = sorted(lengths.items(), key=lambda kv: (kv[1], kv[0]))
    codes: Dict[int, Tuple[int, int]] = {}
    code = 0
    prev_len = order[0][1] if order else 0
    for sym, l in order:
        code <<= (l - prev_len)
        codes[sym] = (code, l)
        code += 1
        prev_len = l
    return codes


@dataclasses.dataclass(frozen=True)
class Codebook:
    """A per-layer LEXI-H codebook (what the flit header carries).

    ``symbols``/``lengths`` are parallel arrays in canonical order; everything
    else is derived.  ``enc_code``/``enc_len`` are 257-entry encoder LUTs
    (index 256 = ESCAPE).  Out-of-alphabet exponents map to ESCAPE.
    """

    symbols: np.ndarray          # (S,) int32, canonical order (incl. ESCAPE)
    lengths: np.ndarray          # (S,) int32
    enc_code: np.ndarray         # (257,) int64: symbol -> codeword
    enc_len: np.ndarray          # (257,) int32: symbol -> code length;
                                 # escapes get len(ESCAPE)+8 at the call site
    in_alphabet: np.ndarray      # (256,) bool

    @property
    def escape_code(self) -> Tuple[int, int]:
        return int(self.enc_code[ESCAPE]), int(self.enc_len[ESCAPE])

    def header_bits(self) -> int:
        """Canonical header: 8-bit symbol + 5-bit length per entry."""
        return int(len(self.symbols) * (8 + 5))

    def decode_tables(self):
        """(first_code, first_index, by-length symbol array) for canonical
        decode — the software analogue of the staged LUTs."""
        max_l = int(self.lengths.max())
        first_code = np.zeros(max_l + 2, dtype=np.int64)
        first_index = np.zeros(max_l + 2, dtype=np.int64)
        counts = np.bincount(self.lengths, minlength=max_l + 2)
        code = 0
        idx = 0
        for l in range(1, max_l + 1):
            first_code[l] = code
            first_index[l] = idx
            code = (code + counts[l]) << 1
            idx += counts[l]
        return first_code, first_index, self.symbols


def build_codebook(hist: np.ndarray, *, main_alphabet: int = MAIN_ALPHABET,
                   max_len: int = MAX_CODE_LEN) -> Codebook:
    """Histogram -> canonical length-limited codebook with escape.

    Mirrors the hardware pipeline: take the (main_alphabet - 1) most frequent
    exponents, add ESCAPE with the residual count (>= 1 pseudo-count), run
    package-merge, assign canonical codes.
    """
    hist = np.asarray(hist, dtype=np.float64)
    order = np.argsort(-hist, kind="stable")
    keep = [int(s) for s in order[: main_alphabet - 1] if hist[s] > 0]
    residual = float(hist.sum() - sum(hist[s] for s in keep))
    freqs = np.zeros(257, dtype=np.float64)
    freqs[keep] = hist[keep]
    freqs[ESCAPE] = max(residual, 1.0)
    lengths = length_limited_lengths(freqs, max_len=max_len,
                                     symbols=keep + [ESCAPE])
    codes = canonical_codes(lengths)
    order2 = sorted(lengths.items(), key=lambda kv: (kv[1], kv[0]))
    symbols = np.array([s for s, _ in order2], dtype=np.int32)
    lens = np.array([l for _, l in order2], dtype=np.int32)
    enc_code = np.zeros(257, dtype=np.int64)
    enc_len = np.zeros(257, dtype=np.int32)
    in_alpha = np.zeros(256, dtype=bool)
    esc_code, esc_len = codes[ESCAPE]
    for s in range(256):
        if s in codes:
            enc_code[s], enc_len[s] = codes[s]
            in_alpha[s] = True
        else:
            enc_code[s], enc_len[s] = esc_code, esc_len  # escape prefix only
    enc_code[ESCAPE], enc_len[ESCAPE] = esc_code, esc_len
    return Codebook(symbols=symbols, lengths=lens, enc_code=enc_code,
                    enc_len=enc_len, in_alphabet=in_alpha)


def code_cost_bits(hist: np.ndarray, book: Codebook) -> float:
    """Total bitstream cost (excluding header) of coding ``hist`` with ``book``."""
    hist = np.asarray(hist, dtype=np.float64)
    cost = 0.0
    esc_len = book.escape_code[1] + RAW_EXP_BITS
    for s in range(256):
        if hist[s] <= 0:
            continue
        cost += hist[s] * (book.enc_len[s] if book.in_alphabet[s] else esc_len)
    return cost


def compression_ratio(exp_stream: np.ndarray, *, include_header: bool = True,
                      main_alphabet: int = MAIN_ALPHABET) -> float:
    """Exponent-stream CR = raw bits / coded bits (paper Table 2 metric)."""
    hist = np.bincount(exp_stream.reshape(-1), minlength=256).astype(np.float64)
    book = build_codebook(hist, main_alphabet=main_alphabet)
    bits = code_cost_bits(hist, book)
    if include_header:
        bits += book.header_bits()
    return (8.0 * hist.sum()) / max(bits, 1.0)
