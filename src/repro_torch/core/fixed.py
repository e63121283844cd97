"""LEXI-FW: the fixed-width deployment codec (ports ``repro/core/fixed.py``).

Per tensor: a 256-bin histogram of the bf16 exponent field, a
frequency-ranked dictionary of the 2^k - 1 most common exponents, a
reserved ESCAPE index (2^k - 1) with a fixed-capacity side channel of
(position, raw exponent) pairs, and sign+mantissa verbatim as one byte.
Every field is byte-identical to the JAX package's encoder.

``compress`` runs on the tensor's device.  On a CUDA tensor the histogram
and the pack are the hand-written kernels (``kernels.ops.histogram`` and
``kernels.ops.pack``); the dictionary build (a stable argsort of 256 bins)
and the escape side channel (a cumsum rank) are torch ops on the device.
On a CPU tensor the same steps run through the kernels' plain versions.

``compress_many`` encodes a stack of tensors, each on its own (the
``jax.vmap(fixed.compress)`` of the reference), in one pass: a page flush
or a prefill block store compresses all its pages at once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from . import entropy as E
from . import packing

DEFAULT_K = 5
# Escape side-channel capacity as a fraction of N (1/128 ≈ 0.8% of values).
DEFAULT_ESC_FRAC = 128


@dataclasses.dataclass
class Compressed:
    """A LEXI-FW compressed BF16 tensor, or a stack of them.

    Fields may carry leading batch axes (``compress_many``); the trailing
    axes are those of the JAX package's ``Compressed``:

    ``signman``: (N,) uint8 — sign<<7 | mantissa, verbatim.
    ``planes``:  (k, Np/32) int32 — bit-plane-packed dictionary indices,
                 the uint32 words held bit for bit (Np = N padded to 32).
    ``dict_syms``: (2^k,) uint8 — frequency-ranked exponent dictionary;
                 slot 2^k - 1 is the reserved ESCAPE (stored as 0).
    ``esc_pos``: (C,) int32 — element positions of escapes (Np = empty).
    ``esc_raw``: (C,) uint8 — raw exponents for the escape slots.
    ``n_escapes``: () int32 — total escapes seen (> C means overflow).
    ``shape``/``k``: the shape of one encoded tensor, and k.
    """

    signman: torch.Tensor
    planes: torch.Tensor
    dict_syms: torch.Tensor
    esc_pos: torch.Tensor
    esc_raw: torch.Tensor
    n_escapes: torch.Tensor
    shape: Tuple[int, ...]
    k: int

    @property
    def n(self) -> int:
        return math.prod(self.shape)

    def wire_bytes(self) -> int:
        """Bytes one encoded tensor occupies on a link or in HBM."""
        c = self.esc_pos.shape[-1]
        return (self.n + self.planes.shape[-2] * self.planes.shape[-1] * 4
                + self.dict_syms.shape[-1] + c * 4 + c + 4)


def esc_index(k: int) -> int:
    return (1 << k) - 1


def build_dictionary(hist: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frequency-ranked dictionary + 256-entry encode LUT, per row of
    ``hist`` (..., 256).

    Returns (dict_syms (..., 2^k) uint8, enc_lut (..., 256) int32).
    Exponents outside the top 2^k - 1 map to the ESCAPE index.  The rank
    is a STABLE argsort of -hist, as ``jnp.argsort`` is: ties go to the
    smaller exponent, which fixes the dictionary order byte for byte.
    """
    esc = esc_index(k)
    hist = hist.to(torch.int64)
    order = torch.argsort(-hist, dim=-1, stable=True)
    top = order[..., :esc]
    present = torch.gather(hist, -1, top) > 0
    dict_syms = torch.where(present, top, 0).to(torch.uint8)
    dict_syms = torch.cat(
        [dict_syms, torch.zeros_like(dict_syms[..., :1])], dim=-1)
    # Only slots whose symbol occurs are programmed (absent symbols keep
    # the escape mapping, so duplicate zeros in dict_syms are harmless).
    slot = torch.where(present,
                       torch.arange(esc, device=hist.device).expand_as(top),
                       esc)
    enc_lut = torch.full(hist.shape, esc, dtype=torch.int64,
                         device=hist.device)
    enc_lut.scatter_(-1, top, slot)
    return dict_syms, enc_lut.to(torch.int32)


def compress_many(x: torch.Tensor, *, k: int = DEFAULT_K,
                  esc_capacity: Optional[int] = None) -> Compressed:
    """Compress each of ``x[0], x[1], ...`` on its own (bf16 any shape)."""
    from repro_torch.kernels import ops

    g = x.shape[0]
    shape = tuple(x.shape[1:])
    n = math.prod(shape)
    np_ = packing.pad_to_lanes(n)
    c = esc_capacity if esc_capacity is not None else max(
        n // DEFAULT_ESC_FRAC, 8)
    esc = esc_index(k)
    xb = x.reshape(g, n).to(torch.bfloat16).contiguous()

    hist = ops.histogram(xb)                               # (g, 256)
    dict_syms, enc_lut = build_dictionary(hist, k)
    signman, planes = ops.pack(xb, enc_lut, k)             # (g,n), (g,k,np/32)

    # escape side channel: the r-th escape (flat order) takes slot r
    exp = E.exponent(E.to_u16(xb))                         # (g, n)
    esc_mask = torch.gather(enc_lut, 1, exp) == esc
    slot = torch.cumsum(esc_mask.to(torch.int32), 1) - 1
    n_escapes = esc_mask.sum(1, dtype=torch.int32)
    write_slot = torch.where(esc_mask & (slot < c), slot, c).to(torch.int64)
    pos = torch.arange(n, dtype=torch.int32, device=x.device).expand(g, n)
    # slot c collects every non-written element and is cut off after
    esc_pos = torch.full((g, c + 1), np_, dtype=torch.int32,
                         device=x.device).scatter_(1, write_slot, pos)[:, :c]
    esc_raw = torch.zeros((g, c + 1), dtype=torch.uint8, device=x.device) \
        .scatter_(1, write_slot, exp.to(torch.uint8))[:, :c]
    return Compressed(signman=signman, planes=planes, dict_syms=dict_syms,
                      esc_pos=esc_pos.contiguous(),
                      esc_raw=esc_raw.contiguous(), n_escapes=n_escapes,
                      shape=shape, k=k)


def compress(x: torch.Tensor, *, k: int = DEFAULT_K,
             esc_capacity: Optional[int] = None) -> Compressed:
    """Compress one BF16 tensor (any shape) into a :class:`Compressed`."""
    ct = compress_many(x[None], k=k, esc_capacity=esc_capacity)
    return dataclasses.replace(
        ct, signman=ct.signman[0], planes=ct.planes[0],
        dict_syms=ct.dict_syms[0], esc_pos=ct.esc_pos[0],
        esc_raw=ct.esc_raw[0], n_escapes=ct.n_escapes[0])


def decompress(ct: Compressed) -> torch.Tensor:
    """Exact inverse of :func:`compress` (given no escape overflow); keeps
    any leading batch axes of the fields."""
    n = ct.n
    lead = tuple(ct.signman.shape[:-1])
    codes = packing.bitplane_unpack(ct.planes, ct.k)[..., :n]
    exp = torch.gather(ct.dict_syms.to(torch.int64), -1, codes)
    # patch escapes from the side channel; the sentinel position (Np >= n)
    # lands in a scratch tail that is cut off
    np_ = packing.pad_to_lanes(n)
    exp = torch.cat([exp, exp.new_zeros(lead + (np_ + 1 - n,))], dim=-1)
    exp.scatter_(-1, ct.esc_pos.to(torch.int64), ct.esc_raw.to(torch.int64))
    u16 = E.combine(ct.signman, exp[..., :n])
    return E.from_u16(u16).reshape(lead + tuple(ct.shape))


def wire_ratio(k: int = DEFAULT_K, esc_frac: int = DEFAULT_ESC_FRAC) -> float:
    """Analytic wire compression ratio of LEXI-FW (per-value amortized)."""
    bits = 8.0 + k + (40.0 / esc_frac)  # 32-bit pos + 8-bit raw per slot
    return 16.0 / bits
