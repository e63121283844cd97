"""Inputs and checks for the two decode-attention kernels' split edge cases,
shared by ``chip_smoke.py`` and ``tests/test_torch_gpu.py``.

Every generator takes a ``torch.Generator`` and makes its tensors on that
generator's device.  The values are built so that a k = 5 page or block
meets the case named: a dictionary that holds exactly the 31 exponents in
use (so any other exponent escapes), escapes planted on given rows (on
both sides of a span boundary), and more distinct exponents than the
escape side channel holds (overflow).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from . import decode_attend, ref


def kv_idx(h: int, hkv: int) -> Tuple[int, ...]:
    """The GQA / MQA / MHA head map both kernels accept."""
    g = h // hkv
    return tuple(min(i // g, hkv - 1) for i in range(h))


def edge_lengths(blk: int) -> List[int]:
    """Lengths at the split's edges: none, one token, around a span (P
    rows), around a block, a multiple of the block, and a ragged one."""
    p = decode_attend.span_rows(blk)
    return [0, 1, p - 1, p, p + 1, blk, blk + 1, 2 * blk, 3 * blk + 5]


def escape_rows(blk: int) -> List[int]:
    """Rows on both sides of the first span boundary (P - 1 and P; at
    P = blk, the block's last and first rows)."""
    p = decode_attend.span_rows(blk)
    return [p - 1, p % blk]


def dict_filled(gen: torch.Generator, shape) -> torch.Tensor:
    """bf16 values whose exponents take 31 values (2^-30 .. 2^0) equally
    often: exactly what a k = 5 dictionary holds, so any other exponent
    escapes."""
    dev = gen.device
    e = (torch.arange(math.prod(shape), device=dev) % 31 - 30).reshape(shape)
    mag = 1 + torch.rand(shape, generator=gen, device=dev)
    sign = torch.randint(0, 2, shape, generator=gen, device=dev)
    return ((2 * sign - 1) * mag * torch.exp2(e.float())).to(torch.bfloat16)


def overflowing(gen: torch.Generator, shape) -> torch.Tensor:
    """Normal values times 2^U[-48, 0): more distinct exponents than a
    k = 5 dictionary holds, so about a third escape, far past the side
    channel's capacity, with bounded values."""
    dev = gen.device
    x = torch.randn(shape, generator=gen, device=dev)
    e = torch.randint(-48, 0, shape, generator=gen, device=dev)
    return (x * torch.exp2(e.float())).to(torch.bfloat16)


def with_escapes(x: torch.Tensor, rows) -> torch.Tensor:
    """x (..., blk, W) with every 32nd element of the given rows moved to
    one of four exponents outside its dictionary (2^-60 .. 2^-57):
    escapes in those rows, W / 16 per row pair, within the capacity."""
    blk, w = x.shape[-2:]
    col = torch.arange(w, device=x.device)
    sel = torch.zeros((blk, w), dtype=torch.bool, device=x.device)
    sel[rows] = (col % 32 == 5)
    tiny = torch.exp2(-60.0 + (col % 4))
    return torch.where(sel, (torch.sign(x.float()) * tiny).to(x.dtype), x)


def alias_slot(q, ring, table, lens, src: int, dst: int):
    """Copies of a paged case's q, ring, page table and lengths in which
    slot ``dst`` holds slot ``src``'s row of each: two slots that read the
    same pages, as two requests sharing a prefix do after a hit (their
    outputs must hold the same bits)."""
    out = [t.clone() for t in (q, ring, table, lens)]
    for t in out:
        t[dst] = t[src]
    return out


def same_bits(a, b) -> bool:
    """Two (out, m, l) results hold the same bits."""
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def attend_close(got, want) -> float:
    """Kernel (out, m, l) against its plain version: normalised outputs
    within rtol = atol = 1e-4, the same live heads, m within 1e-5 where
    live, and dead heads (l = 0) with m = NEG_INF and out = 0.  Returns
    the largest normalised |error|."""
    o_k, m_k, l_k = got
    o_p, m_p, l_p = want
    a = o_k / l_k.clamp(min=1e-30)[..., None]
    b = o_p / l_p.clamp(min=1e-30)[..., None]
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    live = l_p > 0
    assert bool((live == (l_k > 0)).all()), "live heads differ"
    torch.testing.assert_close(m_k[live], m_p[live], rtol=1e-5, atol=1e-5)
    assert bool((m_k[~live] == ref.NEG_INF).all())
    assert bool((o_k[~live] == 0).all())
    return float((a - b).abs().max())
