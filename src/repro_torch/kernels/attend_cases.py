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


# ---------------------------------------------------------------------------
# the tensor-parallel shard path (tp, ti) of both kernels
# ---------------------------------------------------------------------------

def tp_lengths(blk: int, tp: int) -> List[int]:
    """Global lengths 0 .. 3 blk tp + 5 at the edges a shard of ``tp``
    meets: fewer tokens than shards, around a span (P tp positions) and a
    block (blk tp) of every shard, and a ragged tail."""
    p = decode_attend.span_rows(blk)
    return sorted({0, 1, tp - 1, tp, tp + 1, p * tp - 1, p * tp,
                   p * tp + 1, blk * tp - 1, blk * tp, blk * tp + 1,
                   2 * blk * tp, 3 * blk * tp + 5})


TP_MASKS = ((ref.WINDOW_NONE, None), (5, None), (ref.WINDOW_NONE, 50.0))


def tp_paged_checks(gen: torch.Generator, h: int, hd: int, w: int, kw,
                    blk: int = 256, k: int = 5, tps=(2, 4)):
    """``decode_attend_paged`` against its plain version on every shard of
    each tp in ``tps``: slots at ``tp_lengths`` (then 1 slot, then 64
    slots of ragged lengths), no window, window 5 and softcap 50; a page
    with escapes on rows P - 1 and P (both sides of the first span
    boundary) and one past its capacity, both live in the longest slot.
    Every call within 1e-4 and bit for bit on a second launch.  Returns
    (largest |error|, calls)."""
    from repro_torch.core import fixed

    dev = gen.device
    p = decode_attend.span_rows(blk)
    pages = torch.randn((24, blk, w), generator=gen, device=dev
                        ).to(torch.bfloat16)
    pages[0] = overflowing(gen, (blk, w))
    pages[1] = with_escapes(dict_filled(gen, (blk, w)), escape_rows(blk))
    ct = fixed.compress_many(pages, k=k)
    assert int(ct.n_escapes[0]) > ct.esc_pos.shape[-1]
    assert set(escape_rows(blk)) <= set(
        (ct.esc_pos[1][:int(ct.n_escapes[1])] // w).tolist())
    pool = (ct.signman, ct.planes, ct.dict_syms, ct.esc_pos, ct.esc_raw,
            None)
    worst, n_calls = 0.0, 0
    for tp in tps:
        top = 3 * blk * tp + 5
        for lengths in (tp_lengths(blk, tp), [top],
                        [(i * 97 + 300) % (top + 1) for i in range(64)]):
            s_ = len(lengths)
            maxp = ref.local_length(max(lengths), tp, 0) // blk + 1
            table = torch.randint(0, 24, (s_, maxp), generator=gen,
                                  device=dev, dtype=torch.int32)
            longest = max(range(s_), key=lambda i: lengths[i])
            table[longest, :2] = torch.tensor([1, 0], dtype=torch.int32)
            lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
            q = torch.randn((s_, h, hd), generator=gen, device=dev
                            ).to(torch.bfloat16)
            ring = torch.randn((s_, blk, w), generator=gen, device=dev
                               ).to(torch.bfloat16)
            for ti in range(tp):
                for window, softcap in TP_MASKS:
                    args = (q, *pool, ring, table, lens, window)
                    kw2 = dict(kw, k=k, softcap=softcap, tp=tp, ti=ti)
                    got = decode_attend.decode_attend_paged(*args, **kw2)
                    worst = max(worst, attend_close(
                        got, ref.paged_decode_attend_plain(*args, **kw2)))
                    assert same_bits(got, decode_attend.decode_attend_paged(
                        *args, **kw2)), "paged tp: launches differ"
                    n_calls += 1
    return worst, n_calls


def tp_fixed_checks(gen: torch.Generator, h: int, hd: int, w: int, kw,
                    blk: int = 256, k: int = 5, b: int = 3, tps=(2, 4)):
    """``decode_attend`` against its plain version on every shard of each
    tp in ``tps``, B = ``b`` sequences at each of ``tp_lengths``, in both
    launch forms (the length from the host, and on the device with the
    store's capacity as the grid); no window, window 5, softcap 50;
    block 1 holds escapes on rows P - 1 and P of sequence ``b - 1`` and
    more than its side channel holds.  Every call within 1e-4 and bit for
    bit on a second launch.  Returns (largest |error|, calls)."""
    from repro_torch.core import fixed

    dev = gen.device
    p = decode_attend.span_rows(blk)
    worst, n_calls = 0.0, 0
    dev_len = torch.zeros((), dtype=torch.int32, device=dev)
    for tp in tps:
        lengths = tp_lengths(blk, tp)
        nblk = ref.local_length(max(lengths), tp, 0) // blk + 1
        blocks = torch.randn((nblk, b, blk, w), generator=gen, device=dev
                             ).to(torch.bfloat16)
        blocks[1] = dict_filled(gen, (b, blk, w))
        blocks[1, -1] = with_escapes(blocks[1, -1], escape_rows(blk))
        over = list(range(min(p + 3, blk - 2), blk))
        blocks[1, -1, over] = torch.exp2(torch.randint(
            -90, -50, (len(over), w), generator=gen, device=dev).float()
        ).to(torch.bfloat16)
        n = b * blk * w
        ct = fixed.compress_many(blocks.reshape(nblk, n), k=k,
                                 esc_capacity=max(n // 128, 8))
        assert int(ct.n_escapes[1]) > ct.esc_pos.shape[-1]
        store = (ct.signman, ct.planes, ct.dict_syms, ct.esc_pos,
                 ct.esc_raw, None)
        q = torch.randn((b, h, hd), generator=gen, device=dev
                        ).to(torch.bfloat16)
        ring = torch.randn((b, blk, w), generator=gen, device=dev
                           ).to(torch.bfloat16)
        for ti in range(tp):
            for length in lengths:
                dev_len.fill_(length)
                for window, softcap in TP_MASKS:
                    kw2 = dict(kw, k=k, softcap=softcap, tp=tp, ti=ti)
                    want = ref.decode_attend_plain(
                        q, *store, ring, length, window, **kw2)
                    for form in (length, dev_len):
                        args = (q, *store, ring, form, window)
                        got = decode_attend.decode_attend(*args, **kw2)
                        worst = max(worst, attend_close(got, want))
                        assert same_bits(got, decode_attend.decode_attend(
                            *args, **kw2)), "fixed tp: launches differ"
                        n_calls += 1
    return worst, n_calls
