"""BF16 field extraction and exponent-stream profiling (ports the
``jnp_*`` helpers of ``repro/core/entropy.py`` on torch tensors, and its
numpy helpers: the fields, which the LEXI-H container of
``core.bitstream`` uses, and the Fig-1 profile, ``profile_exponents``).

BF16 layout: [sign(1) | exponent(8) | mantissa(7)].  torch has no shift
operators for unsigned 16/32-bit types on the CPU, so 16-bit patterns are
carried as int32 tensors holding 0..65535; only byte fields are stored
unsigned (``uint8``).  The numpy helpers take uint16 patterns.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

BF16_EXP_BITS = 8
BF16_MAN_BITS = 7
EXP_ALPHABET = 256  # 8-bit exponent field


def to_u16(x: torch.Tensor) -> torch.Tensor:
    """BF16 bit patterns as int32 in [0, 65535] (other floats are rounded
    to bf16 first).  Ports ``jnp_to_u16``."""
    if x.dtype != torch.bfloat16:
        x = x.to(torch.bfloat16)
    return x.view(torch.int16).to(torch.int32) & 0xFFFF


def from_u16(u16: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_u16`.  Ports ``jnp_from_u16``."""
    u = u16.to(torch.int32) & 0xFFFF
    return torch.where(u >= 0x8000, u - 0x10000, u).to(torch.int16) \
        .view(torch.bfloat16)


def exponent(u16: torch.Tensor) -> torch.Tensor:
    """8-bit exponent field as int64 (ready for indexing)."""
    return ((u16 >> 7) & 0xFF).to(torch.int64)


def signman(u16: torch.Tensor) -> torch.Tensor:
    """sign<<7 | mantissa as one byte.  Ports ``jnp_signman``."""
    return (((u16 >> 8) & 0x80) | (u16 & 0x7F)).to(torch.uint8)


def combine(sm: torch.Tensor, exp: torch.Tensor) -> torch.Tensor:
    """Rebuild int32-held u16 patterns from a signman byte and an exponent
    byte.  Ports ``jnp_combine``."""
    s = sm.to(torch.int32)
    return ((s & 0x80) << 8) | (exp.to(torch.int32) << 7) | (s & 0x7F)


# ---------------------------------------------------------------------------
# numpy (host) variants, on uint16 bit patterns
# ---------------------------------------------------------------------------

def split_fields(u16: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(sign, exponent, mantissa) uint8 arrays from BF16 bit patterns."""
    sign = (u16 >> 15).astype(np.uint8)
    exp = ((u16 >> 7) & 0xFF).astype(np.uint8)
    man = (u16 & 0x7F).astype(np.uint8)
    return sign, exp, man


def signman_byte(u16: np.ndarray) -> np.ndarray:
    """Pack {sign, mantissa} into one byte: sign<<7 | mantissa."""
    sign, _, man = split_fields(u16)
    return ((sign << 7) | man).astype(np.uint8)


def combine_fields(sign: np.ndarray, exp: np.ndarray,
                   man: np.ndarray) -> np.ndarray:
    """Inverse of :func:`split_fields` -> uint16 BF16 bit patterns."""
    return ((sign.astype(np.uint16) << 15) | (exp.astype(np.uint16) << 7)
            | man.astype(np.uint16))


def to_bf16_u16(x) -> np.ndarray:
    """An array's BF16 bit patterns (uint16), rounding wider floats to the
    nearest even bf16 (torch's conversion, as ``ml_dtypes``' in the
    reference); uint16 passes through, a bf16 array (numpy's
    ``ml_dtypes.bfloat16`` or a torch tensor) is viewed."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype != torch.bfloat16:
            t = t.float().to(torch.bfloat16)
        return t.view(torch.int16).numpy().view(np.uint16)
    x = np.asarray(x)
    if x.dtype == np.uint16:
        return x
    if x.dtype.name == "bfloat16":
        return x.view(np.uint16)
    return to_bf16_u16(torch.from_numpy(x.astype(np.float32)))


def exponent_histogram(exp: np.ndarray) -> np.ndarray:
    """256-bin histogram of the exponent stream (float64 counts)."""
    return np.bincount(exp.reshape(-1), minlength=EXP_ALPHABET) \
        .astype(np.float64)


def shannon_entropy(hist: np.ndarray) -> float:
    """Shannon entropy (bits/symbol) of a histogram."""
    total = hist.sum()
    if total == 0:
        return 0.0
    p = hist[hist > 0] / total
    return float(-(p * np.log2(p)).sum())


@dataclasses.dataclass(frozen=True)
class ExponentStats:
    """Fig-1-style profile of one tensor or stream."""

    n: int
    exp_entropy_bits: float
    man_entropy_bits: float
    distinct_exponents: int
    top32_coverage: float        # share of values whose exponent is one of
                                 # the 32 most frequent (paper: ~1.0)
    huffman_bits_per_exp: float  # length-limited Huffman code cost

    @property
    def exp_cr(self) -> float:
        """Exponent-only compression ratio at the Huffman code cost."""
        return BF16_EXP_BITS / max(self.huffman_bits_per_exp, 1e-9)

    @property
    def overall_cr(self) -> float:
        """Whole-BF16-value CR: sign and mantissa travel verbatim (8
        bits)."""
        return 16.0 / (8.0 + max(self.huffman_bits_per_exp, 1e-9))


def profile_exponents(x) -> ExponentStats:
    """Profile a tensor per paper section 3.1 (entropy, distinct count,
    coverage, Huffman cost)."""
    from . import huffman  # local import to avoid a cycle

    _, exp, man = split_fields(to_bf16_u16(x))
    hist = exponent_histogram(exp)
    man_hist = np.bincount(man.reshape(-1), minlength=128).astype(np.float64)
    order = np.argsort(-hist, kind="stable")
    top32 = hist[order[:32]].sum() / max(hist.sum(), 1.0)
    lengths = huffman.length_limited_lengths(hist,
                                             max_len=huffman.MAX_CODE_LEN)
    code_bits = sum(hist[s] * n for s, n in lengths.items())
    return ExponentStats(
        n=int(hist.sum()),
        exp_entropy_bits=shannon_entropy(hist),
        man_entropy_bits=shannon_entropy(man_hist),
        distinct_exponents=int((hist > 0).sum()),
        top32_coverage=float(top32),
        huffman_bits_per_exp=float(code_bits / max(hist.sum(), 1.0)),
    )
