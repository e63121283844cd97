"""BF16 field extraction (ports the ``jnp_*`` helpers of
``repro/core/entropy.py`` on torch tensors, and its numpy field helpers,
which the LEXI-H container of ``core.bitstream`` uses).

BF16 layout: [sign(1) | exponent(8) | mantissa(7)].  torch has no shift
operators for unsigned 16/32-bit types on the CPU, so 16-bit patterns are
carried as int32 tensors holding 0..65535; only byte fields are stored
unsigned (``uint8``).  The numpy helpers take uint16 patterns.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

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
