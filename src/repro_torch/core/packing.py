"""Bit-plane packing of k-bit exponent codes into 32-bit words (ports
``repro/core/packing.py``).

Lane j of plane b holds bit b of element 32*i + j:

    codes (..., N) ints, N % 32 == 0   ->   planes (..., k, N // 32)

torch's ``uint32`` supports almost no operations, so plane words are
int32 tensors holding the uint32 bits unchanged: ``.numpy().view(np.uint32)``
gives the JAX package's words byte for byte.
"""

from __future__ import annotations

import torch

LANES = 32


def pad_to_lanes(n: int) -> int:
    """Smallest multiple of 32 >= n."""
    return (n + LANES - 1) // LANES * LANES


def _lane(device) -> torch.Tensor:
    return torch.arange(LANES, dtype=torch.int64, device=device)


def bitplane_pack(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Pack k-bit codes (last dim divisible by 32) into int32-held words."""
    assert codes.shape[-1] % LANES == 0, codes.shape
    x = codes.to(torch.int64).reshape(*codes.shape[:-1], -1, LANES)
    lane = _lane(codes.device)
    planes = torch.stack(
        [(((x >> b) & 1) << lane).sum(-1) for b in range(k)], dim=-2)
    # u32 word in an int64 -> the same 32 bits as int32
    return torch.where(planes >= 1 << 31, planes - (1 << 32), planes) \
        .to(torch.int32)


def bitplane_unpack(planes: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`bitplane_pack` -> (..., N) int64 codes."""
    assert planes.shape[-2] == k, planes.shape
    lane = _lane(planes.device)
    bits = (planes.to(torch.int64)[..., None] >> lane) & 1   # (...,k,W,32)
    weights = (1 << torch.arange(k, dtype=torch.int64, device=planes.device))
    codes = (bits * weights[:, None, None]).sum(-3)
    return codes.reshape(*planes.shape[:-2], -1)
