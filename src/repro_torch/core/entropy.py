"""BF16 field extraction on torch tensors (ports the ``jnp_*`` helpers of
``repro/core/entropy.py``).

BF16 layout: [sign(1) | exponent(8) | mantissa(7)].  torch has no shift
operators for unsigned 16/32-bit types on the CPU, so 16-bit patterns are
carried as int32 tensors holding 0..65535; only byte fields are stored
unsigned (``uint8``).
"""

from __future__ import annotations

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
