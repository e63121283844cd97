"""The launch plans of the port's two codec kernels, ``lexi_pack`` and
``exp_histogram`` (``repro_torch.kernels.{lexi_pack,exp_histogram}.plan``),
on the CPU: pure Python, no card.

Each plan sizes a grid of (CTAs per row, rows) and says which words or
items take the kernel's vector path.  These tests walk the kernels' loops
as the CUDA sources write them (a grid stride over words, one thread or
one warp each, for the pack; one contiguous span per CTA, one item per
thread per round, for the histogram) and hold the plans to what the
kernels assume: every word or item of a row in exactly one thread's
share, a grid and shared memory an H100 takes, 8-bit counters folded
before they can overflow, and the workspace the histogram's last CTA
reads.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import exp_histogram as H
from repro_torch.kernels import lexi_pack as P

torch.set_num_threads(2)

NS = [1, 31, 32, 1000, 524288, 524288 + 96, 24903680]
ROWS = [1, 2, 3, 16, 36, 263, 264, 265, 396, 397, 1000, 65535]
MAX_SMEM = 232448          # an H100 CTA's shared memory (227 KB)
SM_SMEM = 233472           # an H100 SM's shared memory for its CTAs
RESERVED = 1024            # shared memory the card reserves per CTA
SMS = 132
MAX_CTAS = (1 << 31) - 1   # grid.x (grid.y: the modules' MAX_ROWS)
WARPS = P.THREADS // 32


def _strided_counts(starts, stop: int, step: int, size: int) -> np.ndarray:
    """How often each of range(size) appears in the ranges
    range(s, stop, step) for s in starts."""
    starts = np.asarray(starts, dtype=np.int64)
    reps = max(0, -(-(stop - int(starts.min())) // step))
    idx = starts[:, None] + step * np.arange(reps, dtype=np.int64)[None, :]
    return np.bincount(idx[idx < stop], minlength=size)


def _cta_items(p: H.Plan, cta: int) -> range:
    return range(cta * p.span, min((cta + 1) * p.span, p.items))


def _rounds(p: H.Plan, cta: int) -> int:
    return -(-len(_cta_items(p, cta)) // H.THREADS)


def _pack_cover(p: P.Plan) -> np.ndarray:
    threads = p.ctas * P.THREADS
    counts = np.zeros(p.nw, dtype=np.int64)
    if p.nfull:
        counts += _strided_counts(np.arange(threads), p.nfull, threads, p.nw)
    warps = p.ctas * WARPS
    counts += _strided_counts(p.nfull + np.arange(warps), p.nw, warps, p.nw)
    return counts


def _hist_cover(p: H.Plan) -> np.ndarray:
    """Item c * span + 256 r + t for CTA c, round r < its rounds, thread t,
    below the CTA's end (the kernel's loop)."""
    assert all(len(_cta_items(p, c)) > 0 for c in range(p.ctas))  # no idle
    rounds = np.array([_rounds(p, c) for c in range(p.ctas)])
    assert (rounds <= p.span // H.THREADS).all()
    cta = np.arange(p.ctas, dtype=np.int64)
    idx = (cta[:, None, None] * p.span
           + H.THREADS * np.arange(rounds.max())[None, :, None]
           + np.arange(H.THREADS)[None, None, :])
    end = np.minimum((cta + 1) * p.span, p.items)[:, None, None]
    live = (idx < end) & (np.arange(rounds.max())[None, :, None]
                          < rounds[:, None, None])
    return np.bincount(idx[live], minlength=p.items)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("vec", [True, False])
def test_pack_plan_covers_every_word_once(n, vec):
    """For every row count: each plane word of a row (the pad word too) is
    encoded by exactly one thread (vector path) or one warp (scalar
    path), and the grid stays within its limits."""
    seen = {}
    for g in ROWS:
        p = P.plan(g, n, vec and n % 16 == 0)
        assert p.rows == g <= P.MAX_ROWS and 1 <= p.ctas <= MAX_CTAS
        assert p.nw == -(-n // 32)
        assert p.ctas * P.THREADS <= max(p.nw, 1) + P.THREADS - 1  # no idle CTA
        assert g * p.ctas <= max(g, P.FILL_CTAS + g)
        if (p.ctas, p.nfull) not in seen:
            seen[(p.ctas, p.nfull)] = _pack_cover(p)
        assert (seen[(p.ctas, p.nfull)] == 1).all(), (g, p)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("vec", [True, False])
def test_histogram_plan_covers_every_item_once(n, vec):
    """For every row count: each item (a 16-byte vector, or an element) of
    a row is counted by exactly one thread of exactly one CTA, every CTA
    has work, and the grid stays within its limits."""
    seen = {}
    for g in ROWS:
        p = H.plan(g, n, vec and n % 8 == 0)
        assert p.rows == g <= H.MAX_ROWS and 1 <= p.ctas <= MAX_CTAS
        assert p.items == (n // 8 if p.vec else n)
        assert p.span % H.THREADS == 0
        assert g * p.ctas <= max(g, H.FILL_CTAS)
        if (p.ctas, p.span, p.items) not in seen:
            seen[(p.ctas, p.span, p.items)] = _hist_cover(p)
        assert (seen[(p.ctas, p.span, p.items)] == 1).all(), (g, p)


def test_plans_at_the_main_path_shapes():
    """A decode flush, the 16-page table, the fixed store, the largest
    stacked weight leaf and the LM head: a grid of about one wave, never
    more than one, and at least a CTA on every SM at the table and the
    leaf."""
    for g, n in ((1, 524288), (16, 524288), (3, 2097152), (36, 24903680),
                 (1, 2560 * 151936)):
        h, p = H.plan(g, n, True), P.plan(g, n, True)
        assert g * h.ctas <= H.FILL_CTAS and g * p.ctas <= P.FILL_CTAS + g
        assert h.vec and p.nfull == n // 32
    for g, n in ((16, 524288), (36, 24903680)):
        assert g * H.plan(g, n, True).ctas >= SMS
        assert g * P.plan(g, n, True).ctas >= 2 * SMS


def test_histogram_counters_never_overflow():
    """A thread counts at most 8 elements a round, so FOLD_ROUNDS rounds
    fit an 8-bit counter; a fold sums 4 threads x 64 words of bytes into
    16-bit lanes; the fold cadence is a whole number of unrolled steps."""
    per_counter = H.FOLD_ROUNDS * H.VEC_ELEMS
    assert per_counter < 256
    assert 4 * 64 * per_counter < 1 << 16
    assert H.FOLD_ROUNDS % H.UNROLL == 0 and H.MIN_ROUNDS >= H.UNROLL
    assert H.SMEM_BYTES == 256 * H.THREADS          # a byte per (bin, thread)


def test_shared_memory_fits():
    """Each instantiation's shared memory within a CTA's 227 KB, and the
    histogram's FILL_CTAS a whole number of CTAs on every SM, all resident
    at once (three 64 KB CTAs fit an SM, four do not)."""
    assert H.SMEM_BYTES + 16 <= MAX_SMEM and P.SMEM_BYTES <= MAX_SMEM
    fit = SM_SMEM // (H.SMEM_BYTES + 16 + RESERVED)
    assert fit == 3
    assert H.FILL_CTAS % SMS == 0 and 1 <= H.FILL_CTAS // SMS <= fit


@pytest.mark.parametrize("n", NS)
def test_scalar_path_choice(n):
    """The pack's vector path needs n % 16 == 0 and 16-byte aligned x and
    signman; only a partial last word then goes scalar.  The histogram's
    needs n % 8 == 0 and a 16-byte aligned x."""
    for x_off in (0, 2, 8, 16):
        for sm_off in (0, 1, 16):
            vec = P.vector_path(n, 4096 + x_off, 4096 + sm_off)
            assert vec == (n % 16 == 0 and x_off % 16 == 0
                           and sm_off % 16 == 0)
            p = P.plan(4, n, vec)
            scalar = p.nw - p.nfull
            assert scalar == (int(n % 32 != 0) if vec else p.nw)
        assert H.vector_path(n, 4096 + x_off) == (n % 8 == 0
                                                  and x_off % 16 == 0)


@pytest.mark.parametrize("g,n", [(1, 524288), (16, 524288), (3, 2097152),
                                 (36, 24903680), (1, 1000), (400, 524288)])
def test_histogram_workspace(g, n):
    """Partials (rows, ctas, 256) and one counter per row when a row has
    several CTAs, none when it has one; the cached workspace grows to the
    largest launch, keeps its zeroed counters, and is per stream."""
    p = H.plan(g, n, True)
    part, rows = p.workspace()
    if p.ctas == 1:
        assert (part, rows) == (0, 0)
    else:
        assert (part, rows) == (g * p.ctas * 256, g)
        assert part * 4 <= (H.FILL_CTAS + g) * 256 * 4
    H._workspaces.clear()
    dev = torch.device("cpu")
    ws, cnt = H._workspace(dev, 7, p)
    assert ws.numel() >= part and cnt.numel() >= rows
    assert cnt.dtype == torch.int32 and not cnt.any()
    big = H.plan(1, 2560 * 151936, True)      # the most partials of any
    assert big.workspace()[0] == H.FILL_CTAS * 256
    ws2, cnt2 = H._workspace(dev, 7, big)
    assert ws2.numel() >= big.workspace()[0]
    assert H._workspace(dev, 7, p)[0] is ws2          # reused, not shrunk
    other, _ = H._workspace(dev, 8, p)
    assert other is not ws2
    assert {s for _, s in H._workspaces} == {7, 8}
    H._workspaces.clear()
