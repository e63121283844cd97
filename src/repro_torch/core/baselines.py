"""Compression baselines the paper compares against (Table 2; a copy of
``repro/core/baselines.py``, numpy only).

* RLE — run-length encoding [Golomb 1966]: each maximal run of identical
  exponent bytes is emitted as (8-bit value, 8-bit run length).  The paper
  measures CR ≈ 0.64× (expansion) because runs are mostly length 1.
* BDI — base-delta-immediate [Pekhimenko et al. 2012] adapted to the exponent
  stream: fixed 32-byte blocks, 8-bit base (block minimum), per-block best
  delta width w ∈ {0,1,2,3,4} chosen from a 3-bit encoding tag (real BDI
  likewise picks the narrowest of several base+delta encodings per block);
  an incompressible block falls back to raw bytes.  The paper measures
  CR ≈ 2.4× with "3-bit delta encoding" — the dominant width here is indeed
  w = 3 (~72 % of blocks on normal-distributed exponents).

Both operate on the 8-bit exponent stream only, like LEXI, so the three CRs
are directly comparable.
"""

from __future__ import annotations

import numpy as np

RLE_VALUE_BITS = 8
RLE_RUN_BITS = 8
BDI_BLOCK = 32
BDI_DELTA_BITS = 3


def rle_bits(exp: np.ndarray) -> int:
    """Total coded bits under RLE (value, run-length) pairs."""
    x = np.ascontiguousarray(exp, dtype=np.uint8).reshape(-1)
    if x.size == 0:
        return 0
    boundaries = np.nonzero(np.diff(x) != 0)[0]
    n_runs = len(boundaries) + 1
    # Runs longer than 255 split into multiple pairs.
    run_starts = np.concatenate([[0], boundaries + 1, [x.size]])
    run_lens = np.diff(run_starts)
    n_pairs = int(np.ceil(run_lens / 255.0).sum())
    del n_runs
    return n_pairs * (RLE_VALUE_BITS + RLE_RUN_BITS)


def rle_cr(exp: np.ndarray) -> float:
    x = np.asarray(exp).reshape(-1)
    return (8.0 * x.size) / max(rle_bits(x), 1)


BDI_TAG_BITS = 3      # selects delta width 0..4 or raw fallback
BDI_WIDTHS = (0, 1, 2, 3, 4)


def bdi_bits(exp: np.ndarray, *, block: int = BDI_BLOCK) -> int:
    """Total coded bits under multi-width base+delta with raw fallback."""
    x = np.ascontiguousarray(exp, dtype=np.int32).reshape(-1)
    n = x.size
    if n == 0:
        return 0
    pad = (-n) % block
    x = np.pad(x, (0, pad), mode="edge")
    blocks = x.reshape(-1, block)
    span = blocks.max(axis=1) - blocks.min(axis=1)   # deltas from block min
    bits = np.full(len(blocks), BDI_TAG_BITS + block * 8, dtype=np.int64)
    for w in reversed(BDI_WIDTHS):                    # narrowest wins
        fits = span < (1 << w) if w > 0 else span == 0
        per = BDI_TAG_BITS + 8 + (block - 1) * w
        bits = np.where(fits, per, bits)
    return int(bits.sum())


def bdi_cr(exp: np.ndarray, **kw) -> float:
    x = np.asarray(exp).reshape(-1)
    return (8.0 * x.size) / max(bdi_bits(x, **kw), 1)
