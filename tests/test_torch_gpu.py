"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marker ``gpu``; each test skips without a CUDA device).

This file imports neither JAX nor the JAX package, so it also runs on the
card's machine, which has no JAX.  tests/conftest.py imports JAX, so run
it there with ``--noconftest``:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig
from repro_torch.configs.base import RunConfig, SSMConfig
from repro_torch.core import fixed, weights
from repro_torch.core.collectives import CodecConfig
from repro_torch.kernels import decode_attend, decompress_matmul, lexi_unpack
from repro_torch.kernels import exp_histogram, lexi_pack
from repro_torch.kernels import attend_cases as AC
from repro_torch.kernels import ops, ref
from repro_torch.models import lm, params as PM
from repro_torch.serve import engine
from repro_torch.serve.scheduler import Request, ServeEngine

pytestmark = pytest.mark.gpu

FIELDS = ("signman", "planes", "dict_syms", "esc_pos", "esc_raw",
          "n_escapes")
# the kernels a raw-weight serve runs: attention and the page codec
ATTEND_PATH_KERNELS = ("decode_attend_paged", "exp_histogram", "lexi_pack")


@pytest.fixture()
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (hand-written kernels run only on "
                    "the card)")
    return torch.device("cuda")


def _bf16(gen, shape, spread=0, device="cuda"):
    """Normal bf16 values; ``spread`` > 0 scales each by 2^U[-s, s)."""
    x = torch.randn(shape, generator=gen, device=device)
    if spread:
        x = x * torch.exp2(torch.randint(-spread, spread, shape,
                                         generator=gen, device=device).float())
    return x.to(torch.bfloat16)


@pytest.mark.parametrize("n", [524288, 524288 + 96, 1000])
def test_codec_kernels_match_plain(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = _bf16(gen, (6, n), spread=20)
    before = ops.launch_counts()
    hist = ops.histogram(x)
    assert torch.equal(hist, ref.histogram_ref(x))
    _, lut = fixed.build_dictionary(hist, 5)
    sm, pl = ops.pack(x, lut, 5)
    sm_p, pl_p = ref.pack_ref(x, lut, 5)
    assert torch.equal(sm, sm_p) and torch.equal(pl, pl_p)
    after = ops.launch_counts()
    assert after["exp_histogram"] == before["exp_histogram"] + 1
    assert after["lexi_pack"] == before["lexi_pack"] + 1
    ct = fixed.compress_many(x, k=5)
    ct_cpu = fixed.compress_many(x.cpu(), k=5)
    for f in FIELDS:
        assert torch.equal(getattr(ct, f).cpu(), getattr(ct_cpu, f)), f


# ---------------------------------------------------------------------------
# the codec kernels: exp_histogram and lexi_pack, exact against the plain
# versions
# ---------------------------------------------------------------------------

CODEC_NS = [1, 7, 31, 33, 1000, 524288 + 96]


def _bits(gen, shape, device="cuda"):
    """Arbitrary bf16 bit patterns: every exponent (0: zeros and
    subnormals, 255: infinities and NaNs), sign and mantissa."""
    return torch.randint(-(1 << 15), 1 << 15, shape, generator=gen,
                         device=device, dtype=torch.int16).view(torch.bfloat16)


def _luts(gen, g, k):
    """A distinct random encode LUT per row, codes in 0 .. 2^k - 1."""
    return torch.randint(0, 1 << k, (g, 256), generator=gen, device="cuda",
                         dtype=torch.int32)


def _check_codec(x, k, lut=None):
    """Both kernels on x, one launch each, equal to the plain versions."""
    before = ops.launch_counts()
    hist = ops.histogram(x)
    assert torch.equal(hist, ref.histogram_ref(x))
    if lut is None:
        lut = fixed.build_dictionary(hist, k)[1]
    sm, pl = ops.pack(x, lut, k)
    sm_p, pl_p = ref.pack_ref(x, lut, k)
    assert torch.equal(sm, sm_p) and torch.equal(pl, pl_p)
    after = ops.launch_counts()
    assert after["exp_histogram"] == before["exp_histogram"] + 1
    assert after["lexi_pack"] == before["lexi_pack"] + 1


@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("n", CODEC_NS)
def test_lexi_pack_every_k(cuda, n, k):
    """Arbitrary bits and a random LUT per row at every code width: the
    vector path (n % 16 == 0), a scalar last word (n % 32 != 0) and rows
    that are all scalar."""
    gen = torch.Generator(device=cuda).manual_seed(n * 10 + k)
    x = _bits(gen, (3, n))
    _check_codec(x, k, _luts(gen, 3, k))


@pytest.mark.parametrize("g,n", [(1, 8), (2, 2048), (5, 524288),
                                 (16, 524288), (3, 2097152), (400, 4096)]
                         + [(3, n) for n in CODEC_NS])
def test_exp_histogram_shapes(cuda, g, n):
    """One CTA a row, several (the last one merges), more rows than the
    grid's fill; wide exponents; the dictionary's LUT packs exactly."""
    gen = torch.Generator(device=cuda).manual_seed(g * n)
    _check_codec(_bf16(gen, (g, n), spread=40), 5)


@pytest.mark.parametrize("n", [1 << 20, (1 << 20) + 3])
def test_codec_one_repeated_value(cuda, n):
    """One value over long rows, each row one CTA's (more rows than the
    grid's fill): every thread's 8-bit counter of that bin would wrap
    many times over unless folded in time."""
    g = 200
    assert exp_histogram.plan(g, n, n % 8 == 0).ctas == 1
    x = torch.full((g, n), 1.5, dtype=torch.bfloat16, device=cuda)
    x[g // 2:] = -3.0e-3
    _check_codec(x, 3)
    assert int(ops.histogram(x).max()) == n


def test_codec_exponents_0_and_255(cuda):
    """Zeros, subnormals, infinities and NaNs beside normal values."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = _bf16(gen, (4, 4096), spread=20)
    specials = torch.tensor([0.0, -0.0, 1e-40, -1e-39, float("inf"),
                             float("-inf"), float("nan")],
                            dtype=torch.bfloat16, device=cuda)
    pick = torch.randint(0, len(specials), (4, 4096), generator=gen,
                         device=cuda)
    x = torch.where(torch.rand((4, 4096), generator=gen, device=cuda) < 0.3,
                    specials[pick], x)
    hist = ops.histogram(x)
    assert int(hist[:, 0].min()) > 0 and int(hist[:, 255].min()) > 0
    for k in (2, 5, 8):
        _check_codec(x, k)


@pytest.mark.parametrize("n", [4096, 1000])
def test_codec_unaligned_rows(cuda, n):
    """x contiguous but not 16-byte aligned (a view at storage offset 1):
    both kernels take their scalar paths and give the same bytes."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    base = _bf16(gen, (3 * n + 1,), spread=12)
    x = base[1:].view(3, n)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert not exp_histogram.vector_path(n, x.data_ptr())
    _check_codec(x, 5)


def test_codec_two_launches_same_bytes(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = _bf16(gen, (16, 524288), spread=9)
    h1, h2 = ops.histogram(x), ops.histogram(x)
    assert torch.equal(h1, h2)
    lut = fixed.build_dictionary(h1, 5)[1]
    (s1, p1), (s2, p2) = ops.pack(x, lut, 5), ops.pack(x, lut, 5)
    assert torch.equal(s1, s2) and torch.equal(p1, p2)


def test_codec_cuda_graph(cuda):
    """histogram -> build_dictionary -> pack captured once on static
    buffers, replayed on new data: equal to an eager run on that data."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = _bf16(gen, (16, 524288), spread=9)

    def encode():
        hist = ops.histogram(x)
        dict_syms, lut = fixed.build_dictionary(hist, 5)
        return (hist, dict_syms, *ops.pack(x, lut, 5))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # the capture stream's workspace
        encode()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = encode()
    for seed in (7, 8):
        x.copy_(_bf16(torch.Generator(device=cuda).manual_seed(seed),
                      x.shape, spread=seed))
        want = encode()
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, want):
            assert torch.equal(a, b)


def test_exp_histogram_streams_have_own_workspace(cuda):
    """Launches on two streams that may overlap: each stream has its own
    partials and arrival counters, so every result equals the call made
    alone."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = _bf16(gen, (16, 524288), spread=9)
    assert exp_histogram.plan(16, 524288, True).ctas > 1
    want = ops.histogram(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    got = []
    for _ in range(4):
        got.append(ops.histogram(x))
        with torch.cuda.stream(side):
            got.append(ops.histogram(x))
    torch.cuda.current_stream().wait_stream(side)
    for res in got:
        assert torch.equal(res, want)
    here = torch.cuda.current_stream().cuda_stream
    assert {here, side.cuda_stream} <= {
        s for _, s in exp_histogram._workspaces}


def test_codec_one_launch_per_call(cuda):
    """Each call is one kernel on the card, and the histogram needs no
    memset: a torch.profiler trace of one call of each (after a warm-up
    call has made the workspace) holds exactly its kernel."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=cuda).manual_seed(10)
    x = _bf16(gen, (16, 524288), spread=9)
    lut = fixed.build_dictionary(ops.histogram(x), 5)[1]
    ops.pack(x, lut, 5)
    torch.cuda.synchronize()
    for name, call in (("exp_histogram_kernel", lambda: ops.histogram(x)),
                       ("lexi_pack_kernel", lambda: ops.pack(x, lut, 5))):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(names) == 1 and name in names[0], names


HEAD_MAPS = [(4, 2), (5, 1), (8, 8), (32, 8)]
HEAD_IDS = ["gqa", "mqa", "mha", "qwen3"]
# full, windowed, a window that leaves a slot only its last span, softcap
WINDOWS = ((ref.WINDOW_NONE, None), (21, None), (5, None),
           (ref.WINDOW_NONE, 30.0))
# the spread-40 cases' windows: full, windowed, soft-capped
SPREAD_WINDOWS = ((ref.WINDOW_NONE, None), (21, None),
                  (ref.WINDOW_NONE, 30.0))
F32_EPS = 2.0 ** -24


def _gamma(n):
    return n * F32_EPS / (1 - n * F32_EPS)


def _assert_within_f32_rounding(got, q, vals, ok, kv_idx, scale, softcap):
    """Normalised (out, m, l) against attention over the same gathered
    stream in float64, within a first-order bound of what f32 rounding can
    do to these inputs in any summation order.  Per output, with
    p_t = e^(s_t - m) and y = sum p_t v_t / l:
    |dy| <= 2 [sum p_t (d_t + g) (|v_t| + |y|)] / l + eps |y|, where
    g = gamma(T + 4) covers the sums over T positions (and the split
    merge), d_t = gamma(hd + 2) scale sum_d |q_d k_td| + 4 eps (|s_t| +
    |m| + softcap + 1) the score's and the weight's own rounding.  For
    values near 2^40 this bound is large: the sums cancel ±1e12 terms."""
    o_k, _, l_k = got
    s_, t, w = vals.shape
    hd = q.shape[-1]
    kv = vals.reshape(s_, t, w // (2 * hd), 2, hd)
    idx = torch.as_tensor(list(kv_idx), device=vals.device)
    k = kv[..., 0, :].index_select(2, idx).double()
    v = kv[..., 1, :].index_select(2, idx).double()
    qd = q.double()
    sc = torch.einsum("shd,sthd->sht", qd, k) * scale
    mag = torch.einsum("shd,sthd->sht", qd.abs(), k.abs()) * scale
    if softcap is not None:
        sc = torch.tanh(sc / softcap) * softcap
    okb = ok[:, None, :]
    sc = torch.where(okb, sc, -torch.inf)
    m = sc.max(-1).values
    p = torch.where(okb, torch.exp(sc - m[..., None]), 0.0)
    l64 = p.sum(-1)
    live = l64 > 0
    y = torch.einsum("sht,sthd->shd", p, v) / l64.clamp(min=1e-300)[..., None]
    d = (_gamma(hd + 2) * mag
         + 4 * F32_EPS * (sc.abs().nan_to_num(posinf=0.0)
                          + m.abs().nan_to_num(posinf=0.0)[..., None]
                          + (softcap or 0.0) + 1))
    pw = p * (d + _gamma(t + 4))
    bound = (2 * (torch.einsum("sht,sthd->shd", pw, v.abs())
                  + y.abs() * pw.sum(-1)[..., None])
             / l64.clamp(min=1e-300)[..., None] + F32_EPS * y.abs())
    y_k = o_k.double() / l_k.double().clamp(min=1e-30)[..., None]
    err = (y_k - y).abs()[live]
    assert bool((err <= bound[live]).all()), \
        float((err / bound[live].clamp(min=1e-300)).max())
    assert bool((live == (l_k > 0)).all())
    assert bool((o_k[~live] == 0).all())


def _spread_pool(gen, h, hkv, hd, blk, codec_on):
    """5 slots of lengths 3 blk + 5, 2, 0, 4 blk and blk over 11 pages;
    page 0, whose values are spread over 2^±40, overflows its escape
    capacity and is the first slot's first page; slot 1's table tail is
    unmapped (-1, clipped)."""
    maxp, n_pages = 4, 11
    w = 2 * hkv * hd
    pages = _bf16(gen, (n_pages, blk, w))
    pages[0] = _bf16(gen, (blk, w), spread=40)               # overflow
    ring = _bf16(gen, (5, blk, w))
    q = _bf16(gen, (5, h, hd))
    table = torch.randint(0, n_pages, (5, maxp), generator=gen,
                          device=gen.device, dtype=torch.int32)
    table[0, 0] = 0
    table[1, 1:] = -1
    lengths = torch.tensor([3 * blk + 5, 2, 0, maxp * blk, blk],
                           dtype=torch.int32, device=gen.device)
    if codec_on:
        ct = fixed.compress_many(pages, k=5)
        assert int(ct.n_escapes[0]) > ct.esc_pos.shape[-1]
        pool = (ct.signman, ct.planes, ct.dict_syms, ct.esc_pos, ct.esc_raw,
                None)
    else:
        pool = (None,) * 5 + (pages,)
    return q, pool, ring, table.clamp(min=0), lengths


def _edge_pool(gen, h, hkv, hd, blk, lengths, codec_on, n_pages=16):
    """A pool whose page 0 overflows its escape capacity and whose page 1
    has escapes on both sides of a span boundary, both live in the
    longest slot; a short slot's table tail unmapped (-1, clipped)."""
    w = 2 * hkv * hd
    s_ = len(lengths)
    maxp = max(lengths) // blk + 1
    pages = _bf16(gen, (n_pages, blk, w))
    pages[0] = AC.overflowing(gen, (blk, w))
    pages[1] = AC.with_escapes(AC.dict_filled(gen, (blk, w)),
                               AC.escape_rows(blk))
    ring = _bf16(gen, (s_, blk, w))
    q = _bf16(gen, (s_, h, hd))
    table = torch.randint(0, n_pages, (s_, maxp), generator=gen,
                          device=gen.device, dtype=torch.int32)
    longest = max(range(s_), key=lambda i: lengths[i])
    table[longest, :2] = torch.tensor([0, 1], dtype=torch.int32)
    if s_ > 1 and longest != 1:
        table[1, 1:] = -1
    lens = torch.tensor(lengths, dtype=torch.int32, device=gen.device)
    if codec_on:
        ct = fixed.compress_many(pages, k=5)
        assert int(ct.n_escapes[0]) > ct.esc_pos.shape[-1]
        rows = set((ct.esc_pos[1][:int(ct.n_escapes[1])] // w).tolist())
        assert set(AC.escape_rows(blk)) <= rows, rows
        pool = (ct.signman, ct.planes, ct.dict_syms, ct.esc_pos, ct.esc_raw,
                None)
    else:
        pool = (None,) * 5 + (pages,)
    return q, pool, ring, table.clamp(min=0), lens


@pytest.mark.parametrize("data", ["spread", "edges"])
@pytest.mark.parametrize("blk", [16, 256])
@pytest.mark.parametrize("hd", [16, 128])
@pytest.mark.parametrize("heads", HEAD_MAPS, ids=HEAD_IDS)
@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
def test_decode_attend_kernel_matches_plain(cuda, heads, hd, codec_on, blk,
                                            data):
    """``spread``: per-slot lengths incl. 0 and 2 tokens, unmapped table
    entries, a page of values spread over 2^±40 with escapes past
    capacity; full and windowed; softcap.  ``edges``: slot lengths at the
    split's edges (0, 1, P - 1, P, P + 1, blk, blk + 1, 2 blk, ragged), a
    page with escapes past capacity and one with escapes on both sides of
    a span boundary; also a window that leaves only the last span.  One
    launch per call, and a second launch gives the same bits.  Within 1e-4
    of the plain version, except the spread data at block 256: there a
    slot sums up to 1024 products of values near 2^40, whose f32 result
    depends on the order of the sum, so the kernel and the plain version
    are each held against float64 within the bound of f32 rounding."""
    h, hkv = heads
    kv_idx = AC.kv_idx(h, hkv)
    if data == "spread":
        seed = h * hd if blk == 16 else h * hd + blk
        gen = torch.Generator(device=cuda).manual_seed(seed)
        q, pool, ring, table, lens = _spread_pool(gen, h, hkv, hd, blk,
                                                  codec_on)
        windows = SPREAD_WINDOWS
    else:
        gen = torch.Generator(device=cuda).manual_seed(h * hd + blk)
        q, pool, ring, table, lens = _edge_pool(
            gen, h, hkv, hd, blk, AC.edge_lengths(blk), codec_on)
        windows = WINDOWS
    for window, softcap in windows:
        args = (q, *pool, ring, table, lens, window)
        kw = dict(k=5, kv_idx=kv_idx, scale=hd ** -0.5, softcap=softcap)
        before = decode_attend.launches["decode_attend_paged"]
        got = ops.decode_attend_paged(*args, **kw)
        assert decode_attend.launches["decode_attend_paged"] == before + 1
        want = ref.paged_decode_attend_plain(*args, **kw)
        if data == "spread" and blk == 256:
            vals, ok = ref.paged_stream(*args[1:], k=5)
            for res in (got, want):
                _assert_within_f32_rounding(res, q, vals, ok, kv_idx,
                                            hd ** -0.5, softcap)
        else:
            AC.attend_close(got, want)
        assert AC.same_bits(got, ops.decode_attend_paged(*args, **kw))


@pytest.mark.parametrize("n_slots", [1, 64])
def test_decode_attend_paged_slot_counts(cuda, n_slots):
    """One slot, and 64 slots of lengths 0..blk * 3 (a grid of
    8 x 64 x 8 CTAs), qwen3-4b's heads: within 1e-4, bit-identical on a
    second launch."""
    h, hkv, hd, blk = 32, 8, 128, 256
    gen = torch.Generator(device=cuda).manual_seed(n_slots)
    lengths = [(i * 97 + 300) % (3 * blk) for i in range(n_slots)]
    lengths[0] = 3 * blk - 1
    q, pool, ring, table, lens = _edge_pool(gen, h, hkv, hd, blk, lengths,
                                            True, n_pages=40)
    args = (q, *pool, ring, table, lens, ref.WINDOW_NONE)
    kw = dict(k=5, kv_idx=AC.kv_idx(h, hkv), scale=hd ** -0.5)
    got = ops.decode_attend_paged(*args, **kw)
    AC.attend_close(got, ref.paged_decode_attend_plain(*args, **kw))
    assert AC.same_bits(got, ops.decode_attend_paged(*args, **kw))


@pytest.mark.parametrize("blk", [16, 256])
def test_decode_attend_paged_aliased_slots(cuda, blk):
    """Prefix sharing maps the same page ids into several slots' rows: a
    slot that holds the longest slot's row (with its overflowing page and
    its page of escapes across a span boundary), q, ring and length is
    within 1e-4 of the plain version and gives the same bits as that
    slot."""
    h, hkv, hd = 32, 8, 128
    gen = torch.Generator(device=cuda).manual_seed(blk + 1)
    lengths = [3 * blk + 5, 2, blk + 1, 2 * blk]
    q, pool, ring, table, lens = _edge_pool(gen, h, hkv, hd, blk, lengths,
                                            True)
    q, ring, table, lens = AC.alias_slot(q, ring, table, lens, src=0, dst=2)
    args = (q, *pool, ring, table, lens, ref.WINDOW_NONE)
    kw = dict(k=5, kv_idx=AC.kv_idx(h, hkv), scale=hd ** -0.5)
    got = ops.decode_attend_paged(*args, **kw)
    AC.attend_close(got, ref.paged_decode_attend_plain(*args, **kw))
    assert AC.same_bits([t[0] for t in got], [t[2] for t in got])


def test_decode_attend_paged_reads_no_device_value(cuda):
    """The paged launch sizes its grid from shapes alone: under
    ``torch.cuda.set_sync_debug_mode("error")`` a call does not
    synchronise with the card (the slots' lengths stay on it)."""
    h, hkv, hd, blk = 32, 8, 128, 256
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, pool, ring, table, lens = _edge_pool(gen, h, hkv, hd, blk,
                                            [300, 700, 1100, 2000], True)
    args = (q, *pool, ring, table, lens, ref.WINDOW_NONE)
    kw = dict(k=5, kv_idx=AC.kv_idx(h, hkv), scale=hd ** -0.5)
    want = ops.decode_attend_paged(*args, **kw)        # builds, warms
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ops.decode_attend_paged(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert AC.same_bits(got, want)


def test_decode_attend_streams_have_own_workspace(cuda):
    """Launches on two streams that may overlap: each stream gets its own
    split workspace and arrival counters, so both results equal the
    same call made alone."""
    h, hkv, hd, blk = 32, 8, 128, 256
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, pool, ring, table, lens = _edge_pool(gen, h, hkv, hd, blk,
                                            [300, 700, 1100, 2000], True)
    args = (q, *pool, ring, table, lens, ref.WINDOW_NONE)
    kw = dict(k=5, kv_idx=AC.kv_idx(h, hkv), scale=hd ** -0.5)
    want = ops.decode_attend_paged(*args, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    got = []
    for _ in range(4):
        got.append(ops.decode_attend_paged(*args, **kw))
        with torch.cuda.stream(side):
            got.append(ops.decode_attend_paged(*args, **kw))
    torch.cuda.current_stream().wait_stream(side)
    for res in got:
        assert AC.same_bits(res, want)
    here = torch.cuda.current_stream().cuda_stream
    assert {here, side.cuda_stream} <= {s for _, s in decode_attend._workspaces}


HEAD_DIMS = [16, 128, 256]


def _spread_blocks(gen, b, blk, w):
    """4 blocks of 3 sequences; block 1 has escapes (values times 2^40) in
    sequence 0 and, in sequence 2, values spread over 2^±40 that overflow
    the block's side channel."""
    blocks = _bf16(gen, (4, b, blk, w))
    rare = torch.rand((blk, w), generator=gen, device=gen.device) < 0.004
    blocks[1, 0] = torch.where(rare, blocks[1, 0] * 2.0 ** 40, blocks[1, 0])
    blocks[1, 2] = _bf16(gen, (blk, w), spread=40)           # overflow
    return blocks


def _edge_blocks(gen, b, blk, w, nblk):
    """Block 1 fills a k = 5 dictionary; it has escapes in sequence 0 and,
    in sequence 2, escapes on both sides of a span boundary followed by
    more than the capacity holds."""
    blocks = _bf16(gen, (nblk, b, blk, w))
    blocks[1] = AC.dict_filled(gen, (b, blk, w))
    blocks[1, 0] = AC.with_escapes(blocks[1, 0], list(range(1, blk, 5)))
    edge = AC.escape_rows(blk)
    blocks[1, 2] = AC.with_escapes(blocks[1, 2], edge)
    over = [r for r in range(edge[1] + 3, blk) if r != edge[0]]
    ex = torch.randint(-90, -50, (len(over), w), generator=gen,
                       device=gen.device)
    blocks[1, 2, over] = torch.exp2(ex.float()).to(torch.bfloat16)
    return blocks


@pytest.mark.parametrize("data", ["spread", "edges"])
@pytest.mark.parametrize("blk", [16, 256])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("heads", HEAD_MAPS, ids=HEAD_IDS)
@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
def test_fixed_decode_attend_kernel_matches_plain(cuda, heads, hd, codec_on,
                                                  blk, data):
    """The fixed-batch store: 3 sequences share each block's dictionary
    and escape side channel; block 1 has escapes in sequence 0 and
    overflows the capacity inside sequence 2.  ``spread`` (values over
    2^±40): lengths with a partial ring, an empty ring, no full block and
    no token; full, windowed and soft-capped.  ``edges``: escapes on both
    sides of a span boundary in sequence 2 before the overflow; lengths
    at the split's edges; also a window that leaves only the last span.
    One launch per call, and a second launch gives the same bits.  Within
    1e-4 of the plain version, except the spread data at block 256, held
    against float64 within the bound of f32 rounding (see the paged
    test)."""
    h, hkv = heads
    b = 3
    w = 2 * hkv * hd
    kv_idx = AC.kv_idx(h, hkv)
    if data == "spread":
        seed = h * hd + codec_on + (0 if blk == 16 else blk)
        gen = torch.Generator(device=cuda).manual_seed(seed)
        blocks = _spread_blocks(gen, b, blk, w)
        lengths, windows = (2 * blk + 5, 3 * blk, 7, 0), SPREAD_WINDOWS
    else:
        gen = torch.Generator(device=cuda).manual_seed(h * hd + codec_on
                                                       + blk)
        lengths, windows = AC.edge_lengths(blk), WINDOWS
        blocks = _edge_blocks(gen, b, blk, w, max(lengths) // blk + 1)
    nblk = blocks.shape[0]
    ring = _bf16(gen, (b, blk, w))
    q = _bf16(gen, (b, h, hd))
    n = b * blk * w
    if codec_on:
        ct = fixed.compress_many(blocks.reshape(nblk, n), k=5,
                                 esc_capacity=max(n // 128, 8))
        c = ct.esc_pos.shape[-1]
        assert int(ct.n_escapes[1]) > c
        assert bool((ct.esc_pos[1] < blk * w).any())          # sequence 0
        assert bool((ct.esc_pos[1] >= 2 * blk * w).any())     # sequence 2
        edge = AC.escape_rows(blk)
        if data == "edges" and blk > decode_attend.span_rows(blk):
            rows = set(((ct.esc_pos[1] - 2 * blk * w) // w).tolist())
            assert set(edge) <= rows, edge         # both sides, in capacity
        store = (ct.signman, ct.planes, ct.dict_syms, ct.esc_pos, ct.esc_raw,
                 None)
    else:
        store = (None,) * 5 + (blocks,)
    for length in lengths:
        for window, softcap in windows:
            args = (q, *store, ring, length, window)
            kw = dict(k=5, kv_idx=kv_idx, scale=hd ** -0.5, softcap=softcap)
            before = decode_attend.launches["decode_attend"]
            got = ops.decode_attend(*args, **kw)
            assert decode_attend.launches["decode_attend"] == before + 1
            want = ref.decode_attend_plain(*args, **kw)
            if data == "spread" and blk == 256:
                vals, ok = ref.fixed_store_stream(*args[1:], k=5)
                for res in (got, want):
                    _assert_within_f32_rounding(res, q, vals, ok, kv_idx,
                                                hd ** -0.5, softcap)
            else:
                AC.attend_close(got, want)
            assert AC.same_bits(got, ops.decode_attend(*args, **kw))


TINY = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                   n_heads=8, n_kv_heads=4, d_ff=128, vocab_size=512,
                   head_dim=16, qk_norm=True)


def _tiny_requests():
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(0, 512, (s,)).astype(np.int32),
                    max_new_tokens=b)
            for i, (s, b) in enumerate([(8, 5), (13, 6), (4, 9), (23, 4)])]


def test_engine_serves_on_card_with_every_kernel(cuda):
    """A tiny dense model through ServeEngine's default device: every
    request gets its budget and the attention path's three kernels
    launch (raw weights: the weight plane's two do not)."""
    run = RunConfig(codec=dataclasses.replace(CodecConfig(), cache_block=4))
    eng = ServeEngine(TINY, run, n_slots=2, max_len=48, seed=1)
    assert eng.device.type == "cuda" and eng.decode_backend == "cuda"
    reqs = _tiny_requests()
    ops.reset_launch_counts()
    results, st = eng.run(reqs)
    assert [len(r.tokens) for r in results] == [5, 6, 9, 4]
    counts = ops.launch_counts()
    assert all(counts[name] > 0 for name in ATTEND_PATH_KERNELS), counts
    assert counts["decompress_matmul"] == counts["lexi_unpack"] == 0
    assert st.peak_cache_bytes < st.peak_cache_raw_bytes


def test_fixed_engine_on_card_matches_cpu(cuda):
    """The fixed-batch loop on a tiny dense model, card against CPU from
    the same weights: prefill, then 10 steps fed the CPU's greedy tokens
    (block 4: flushes at 12, 16 and 20): logits within 1e-2 at every step
    (f32 sums in another order); ``decode_attend`` launched once per layer
    and step, the paged kernel never.  ``decode_backend="torch"`` is
    refused on the card."""
    run = RunConfig(codec=dataclasses.replace(CodecConfig(), cache_block=4))
    params = PM.init_params(lm.lm_table(TINY),
                            torch.Generator().manual_seed(3))
    prompts = torch.as_tensor(np.random.default_rng(3).integers(
        0, 512, (2, 9)), dtype=torch.int32)
    steps, max_len = 10, 24
    logits, states = {}, {}
    for dev in ("cpu", "cuda"):
        p = PM.to_device(params, dev)
        lg, st = engine.prefill(TINY, run, p, prompts.to(dev), max_len)
        logits[dev], states[dev] = [lg.float().cpu()], (st, p)
    ops.reset_launch_counts()
    for _ in range(steps):
        feed = engine.greedy_token(logits["cpu"][-1])
        for dev in ("cpu", "cuda"):
            st, p = states[dev]
            logits[dev].append(engine.decode_step(
                TINY, run, p, st, feed.to(dev)).float().cpu())
    counts = ops.launch_counts()
    assert counts["decode_attend"] == TINY.n_layers * steps, counts
    assert counts["decode_attend_paged"] == 0
    for a, b in zip(logits["cpu"], logits["cuda"]):
        assert torch.isfinite(b).all()
        assert float((a - b).abs().max()) <= 1e-2
    st, p = states["cuda"]
    torch_run = RunConfig(codec=dataclasses.replace(
        run.codec, decode_backend="torch"))
    with pytest.raises(ValueError, match="CPU tensors"):
        engine.decode_step(TINY, torch_run, p, st,
                           torch.zeros((2, 1), dtype=torch.int32,
                                       device="cuda"))


# ---------------------------------------------------------------------------
# the packed weight plane: lexi_unpack and decompress_matmul
# ---------------------------------------------------------------------------

# (K, N) of qwen3-4b's weights: wq, wk/wv, wo, w_gate/w_up, w_down, lm_head
QWEN3_4B_WEIGHTS = [(2560, 4096), (2560, 1024), (4096, 2560), (2560, 9728),
                    (9728, 2560), (2560, 151936)]


def _weight(gen, shape, k):
    """bf16 weights with at most 2^k - 1 distinct exponents (random sign
    and mantissa): escape-free at k, so the packed form is exact."""
    e = torch.randint(-8, (1 << k) - 9, shape, generator=gen, device="cuda")
    m = 1 + torch.randint(0, 128, shape, generator=gen, device="cuda") / 128
    s = torch.randint(0, 2, shape, generator=gen, device="cuda") * 2 - 1
    return (s * m * torch.exp2(e.float())).to(torch.bfloat16)


def _i16(t):
    return t.view(torch.int16)


@pytest.mark.parametrize("k", [4, 5, 6])
@pytest.mark.parametrize("g,n", [(3, 32 * 37), (2, 1000), (1, 2560 * 9728)],
                         ids=["rows", "ragged", "qwen3-w_gate"])
def test_lexi_unpack_kernel_matches_plain(cuda, g, n, k):
    """Arbitrary bits (every code, every signman byte, a dictionary per
    row): bit for bit, one launch."""
    gen = torch.Generator(device=cuda).manual_seed(g * n + k)
    sm = torch.randint(0, 256, (g, n), generator=gen, device=cuda,
                       dtype=torch.uint8)
    planes = torch.randint(-(1 << 31), 1 << 31, (g, k, -(-n // 32)),
                           generator=gen, device=cuda, dtype=torch.int32)
    dicts = torch.randint(0, 256, (g, 1 << k), generator=gen, device=cuda,
                          dtype=torch.uint8)
    before = lexi_unpack.launches
    got = ops.unpack_rows(sm, planes, dicts, k)
    assert lexi_unpack.launches == before + 1
    assert torch.equal(_i16(got), _i16(ref.unpack_ref(sm, planes, dicts, k)))


@pytest.mark.parametrize("spread", [9, 40], ids=["escapes", "overflow"])
def test_ops_unpack_matches_decompress(cuda, spread):
    """The kernel-backed decompress patches the escape side channel as
    fixed.decompress does, within and past its capacity."""
    gen = torch.Generator(device=cuda).manual_seed(spread)
    x = _bf16(gen, (6, 256, 512), spread=spread)
    ct = fixed.compress_many(x, k=5, esc_capacity=64)
    assert int(ct.n_escapes.max()) > 0
    assert (int(ct.n_escapes.max()) > 64) == (spread == 40)
    assert torch.equal(_i16(ops.unpack(ct)), _i16(fixed.decompress(ct)))


def _dm_check(gen, m, kk, n, k, make=_weight, x=None):
    w = make(gen, (kk, n), k)
    sm, pl, d, n_esc = ops.compress_weight(w, k=k)
    assert int(n_esc) == 0
    if x is None:
        x = _bf16(gen, (m, kk))
    route = decompress_matmul.plan(m, kk, n, k).route
    before = decompress_matmul.launches
    by_route = dict(decompress_matmul.launches_by_route)
    got = ops.matmul_compressed(x, sm, pl, d, k=k)
    assert decompress_matmul.launches == before + 1
    by_route[route] += 1
    assert decompress_matmul.launches_by_route == by_route
    want = ref.decompress_matmul_ref(x, sm, pl, d, k)
    # the products are exact in f32: only the summation order differs
    tol = 1e-4 * (x.float().abs() @ w.float().abs()) + 1e-6
    assert got.shape == (m, n) and bool(((got - want).abs() <= tol).all())
    assert bool(((got - x.float() @ w.float()).abs() <= tol).all())


@pytest.mark.parametrize("k", [4, 5, 6])
@pytest.mark.parametrize("m,kk,n", [(1, 1, 32), (37, 301, 32 * 9),
                                    (130, 64, 160), (5, 1000, 32 * 33),
                                    (64, 128, 128)])
def test_decompress_matmul_kernel_matches_plain(cuda, m, kk, n, k):
    """Ragged M, K and N tiles (masked in the kernel), odd K (element-wise
    x loads), tile-exact shapes."""
    _dm_check(torch.Generator(device=cuda).manual_seed(m * kk + n + k),
              m, kk, n, k)


@pytest.mark.parametrize("m", [4, 1024], ids=["decode", "prefill"])
@pytest.mark.parametrize("kk,n", QWEN3_4B_WEIGHTS,
                         ids=[f"{a}x{b}" for a, b in QWEN3_4B_WEIGHTS])
def test_decompress_matmul_kernel_qwen3_shapes(cuda, kk, n, m):
    _dm_check(torch.Generator(device=cuda).manual_seed(kk + n + m),
              m, kk, n, 5)


# the M values the decode route's plan distinguishes (the slot counts up
# to 64, in M-groups of 8, 16 or 32 rows, and up to its threshold,
# DECODE_MAX_M), then the prefill route's
SWEEP_M = [1, 2, 3, 4, 5, 8, 15, 16, 17, 33, 64, 65, 128, 129, 1024]


def _weight_any_k(gen, shape, k):
    """As ``_weight`` for any k in 1..8, the exponents kept within 2^±60
    so that products and sums stay finite in f32."""
    e = torch.randint(-8, min((1 << k) - 9, 60), shape, generator=gen,
                      device="cuda")
    m = 1 + torch.randint(0, 128, shape, generator=gen, device="cuda") / 128
    s = torch.randint(0, 2, shape, generator=gen, device="cuda") * 2 - 1
    return (s * m * torch.exp2(e.float())).to(torch.bfloat16)


@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("m", SWEEP_M)
@pytest.mark.parametrize("kk,n", [(1000, 32 * 33), (777, 96)],
                         ids=["ragged", "odd-k"])
def test_decompress_matmul_sweep_matches_plain(cuda, kk, n, m, k):
    """Both routes at every M the plan distinguishes and every code
    width: ragged N (33 plane words: 4-byte plane copies), K not a
    multiple of the chunk, odd K (element-wise x loads)."""
    _dm_check(torch.Generator(device=cuda).manual_seed(m * 100 + k), m, kk,
              n, k, make=_weight_any_k)


@pytest.mark.parametrize("m", [m for m in SWEEP_M if m not in (4, 1024)])
@pytest.mark.parametrize("kk,n", QWEN3_4B_WEIGHTS,
                         ids=[f"{a}x{b}" for a, b in QWEN3_4B_WEIGHTS])
def test_decompress_matmul_qwen3_shapes_every_m(cuda, kk, n, m):
    _dm_check(torch.Generator(device=cuda).manual_seed(kk + n + m),
              m, kk, n, 5)


def _dm_operands(seed, m, kk, n, k=5):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = _weight(gen, (kk, n), k)
    x = _bf16(gen, (m, kk))
    return (x, *ops.compress_weight(w, k=k)[:3])


@pytest.mark.parametrize("m,kk,n", [(1, 2560, 1024), (4, 9728, 2560),
                                    (17, 2560, 1024), (64, 4096, 2560),
                                    (1024, 2560, 1024)])
def test_decompress_matmul_two_launches_same_bits(cuda, m, kk, n):
    """The split merge sums in split order, not arrival order: two
    launches give the same bits (here with 3 to 16 splits)."""
    x, sm, pl, d = _dm_operands(m + kk, m, kk, n)
    p = decompress_matmul.plan(m, kk, n, 5)
    assert p.route == "prefill" or p.splits >= 3
    a = ops.matmul_compressed(x, sm, pl, d, k=5)
    for _ in range(3):
        assert torch.equal(ops.matmul_compressed(x, sm, pl, d, k=5)
                           .view(torch.int32), a.view(torch.int32))


def test_decompress_matmul_streams_have_own_workspace(cuda):
    """Launches on two streams that may overlap: each stream gets its own
    split workspace and arrival counters, so every result equals the same
    call made alone."""
    x, sm, pl, d = _dm_operands(5, 4, 9728, 2560)
    assert decompress_matmul.plan(4, 9728, 2560, 5).splits > 1
    want = ops.matmul_compressed(x, sm, pl, d, k=5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    got = []
    for _ in range(4):
        got.append(ops.matmul_compressed(x, sm, pl, d, k=5))
        with torch.cuda.stream(side):
            got.append(ops.matmul_compressed(x, sm, pl, d, k=5))
    torch.cuda.current_stream().wait_stream(side)
    for res in got:
        assert torch.equal(res.view(torch.int32), want.view(torch.int32))
    here = torch.cuda.current_stream().cuda_stream
    assert {here, side.cuda_stream} <= \
        {s for _, s in decompress_matmul._workspaces}


def test_decompress_matmul_cuda_graph(cuda):
    """One CUDA-graph capture of the split-K launch, replayed twice: both
    replays equal the eager result bit for bit (the kernel leaves its
    arrival counters zeroed, and reads no host value)."""
    x, sm, pl, d = _dm_operands(6, 4, 4096, 2560)
    assert decompress_matmul.plan(4, 4096, 2560, 5).splits > 1
    want = ops.matmul_compressed(x, sm, pl, d, k=5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # the capture stream's workspace
        ops.matmul_compressed(x, sm, pl, d, k=5)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = decompress_matmul.launches
    with torch.cuda.graph(graph, stream=side):
        out = ops.matmul_compressed(x, sm, pl, d, k=5)
    assert decompress_matmul.launches == before + 1
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))


# the prefill route (M > DECODE_MAX_M): every tile the plan can pick,
# forced one at a time
PREFILL_M = [129, 200, 1000, 1024, 4096]


@pytest.fixture(params=decompress_matmul.PREFILL_TILES,
                ids=[f"{bm}x{bn}" for bm, bn in
                     decompress_matmul.PREFILL_TILES])
def prefill_tile(request, monkeypatch):
    """The plan's prefill tile forced to ``request.param`` (BM, BN)."""
    dm = decompress_matmul
    monkeypatch.setattr(dm, "PREFILL_TILES", (request.param,))
    dm.plan.cache_clear()
    dm._launch.cache_clear()
    yield request.param
    dm.plan.cache_clear()
    dm._launch.cache_clear()


@pytest.mark.parametrize("m", PREFILL_M)
@pytest.mark.parametrize("kk,n", [(2560, 1024), (300, 96), (4095, 1056)],
                         ids=["qwen3-wk", "ragged-k300-n96",
                              "ragged-k4095-n1056"])
def test_prefill_route_every_m(cuda, prefill_tile, kk, n, m):
    """The prefill route on each tile at M from one row past the decode
    route to 4096 (ragged last M tile), K not a multiple of the 64-row
    step (300, 4095: element-wise x loads), N not a multiple of the column
    tile (96, 1056: 4-byte plane copies)."""
    p = decompress_matmul.plan(m, kk, n, 5)
    assert p.route == "prefill" and (p.mrows, p.bn) == prefill_tile
    _dm_check(torch.Generator(device=cuda).manual_seed(m + kk + n), m, kk,
              n, 5)


@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("kk,n", [(1000, 32 * 33), (300, 96)],
                         ids=["ragged", "odd-k"])
def test_prefill_route_every_k(cuda, prefill_tile, kk, n, k):
    _dm_check(torch.Generator(device=cuda).manual_seed(kk + k), 200, kk, n,
              k, make=_weight_any_k)


def test_prefill_route_x_unaligned(cuda, prefill_tile):
    """x 2 bytes off a 16-byte boundary (K % 8 == 0): element-wise x
    loads."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    m, kk, n = 1024, 2560, 1024
    x = _bf16(gen, (m * kk + 1,))[1:].view(m, kk)
    assert x.is_contiguous() and x.data_ptr() % 16
    _dm_check(gen, m, kk, n, 5, x=x)


@pytest.mark.parametrize("kk,n", QWEN3_4B_WEIGHTS[:5],
                         ids=[f"{a}x{b}" for a, b in QWEN3_4B_WEIGHTS[:5]])
def test_prefill_route_same_bits_and_graph(cuda, kk, n):
    """At M = 1024 on the plan's tile: three launches give the same bits,
    and one CUDA-graph capture replayed twice gives them too."""
    x, sm, pl, d = _dm_operands(kk + n, 1024, kk, n)
    assert decompress_matmul.plan(1024, kk, n, 5).route == "prefill"
    want = ops.matmul_compressed(x, sm, pl, d, k=5)
    for _ in range(2):
        assert torch.equal(ops.matmul_compressed(x, sm, pl, d, k=5)
                           .view(torch.int32), want.view(torch.int32))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    before = dict(decompress_matmul.launches_by_route)
    with torch.cuda.graph(graph, stream=side):
        out = ops.matmul_compressed(x, sm, pl, d, k=5)
    assert decompress_matmul.launches_by_route["prefill"] == \
        before["prefill"] + 1
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("n", [7, 48, 1000, 1001, 32 * 37],
                         ids=["n<32", "n%32", "n%16", "odd", "words"])
def test_lexi_unpack_kernel_ragged_every_k(cuda, n, k):
    """Arbitrary bits at every code width, over three rows with distinct
    dictionaries: bit for bit, at n below one word, n not a multiple of
    32 (a scalar last word) and of 16 (every word scalar)."""
    gen = torch.Generator(device=cuda).manual_seed(n * 10 + k)
    g = 3
    sm = torch.randint(0, 256, (g, n), generator=gen, device=cuda,
                       dtype=torch.uint8)
    planes = torch.randint(-(1 << 31), 1 << 31, (g, k, -(-n // 32)),
                           generator=gen, device=cuda, dtype=torch.int32)
    dicts = torch.stack([torch.randperm(256, generator=gen, device=cuda)
                         [:1 << k] for _ in range(g)]).to(torch.uint8)
    assert len({tuple(r) for r in dicts.tolist()}) == g
    got = ops.unpack_rows(sm, planes, dicts, k)
    assert torch.equal(_i16(got), _i16(ref.unpack_ref(sm, planes, dicts, k)))


def test_engine_serves_packed_weights_on_card(cuda):
    """ServeEngine(compress_weights=True) on the card: the ``unpack``
    backend launches lexi_unpack (and not decompress_matmul) and gives
    the raw weights' streams; the ``cuda`` backend launches
    decompress_matmul (and not lexi_unpack).  Every request gets its
    budget on both."""
    streams = {}
    for be in ("raw", "unpack", "cuda"):
        codec = dataclasses.replace(CodecConfig(), cache_block=4,
                                    weight_backend="auto" if be == "raw"
                                    else be)
        eng = ServeEngine(TINY, RunConfig(codec=codec), n_slots=2, max_len=48,
                          seed=1, compress_weights=be != "raw")
        ops.reset_launch_counts()
        results, st = eng.run(_tiny_requests())
        counts = ops.launch_counts()
        assert [len(r.tokens) for r in results] == [5, 6, 9, 4]
        streams[be] = [r.tokens for r in results]
        if be == "raw":
            assert counts["decompress_matmul"] == counts["lexi_unpack"] == 0
            continue
        assert st.weight_backend == be and st.weight_ratio < 0.95
        assert isinstance(eng.params["lm_head"], weights.PackedWeight)
        used, idle = (("lexi_unpack", "decompress_matmul") if be == "unpack"
                      else ("decompress_matmul", "lexi_unpack"))
        assert counts[used] > 0 and counts[idle] == 0, counts
    assert streams["unpack"] == streams["raw"]
    with pytest.raises(ValueError, match="CPU tensors"):
        ServeEngine(TINY, RunConfig(codec=dataclasses.replace(
            CodecConfig(), cache_block=4, weight_backend="torch")),
            n_slots=2, max_len=48, compress_weights=True)


# ---------------------------------------------------------------------------
# compiled decode dispatch: CUDA graphs of the decode step
# ---------------------------------------------------------------------------

def _pool_bits(pkv):
    """Every byte of a pool that a step can touch, with its host table."""
    out = {"page_table": torch.as_tensor(pkv.page_table),
           "page_used": torch.as_tensor(pkv.page_used),
           "ring": pkv.ring.view(torch.int16).cpu()}
    for f in ("signman", "planes", "dict_syms", "esc_pos", "esc_raw",
              "raw_pages"):
        t = getattr(pkv, f)
        if t is not None:
            used = torch.as_tensor(pkv.page_used).to(t.device)
            out[f] = t[:, used].contiguous().view(torch.uint8).cpu()
    return out


@pytest.mark.parametrize("weights_be", ["raw", "cuda", "unpack"])
@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
def test_graph_streams_match_eager(cuda, codec_on, weights_be):
    """ServeEngine with CUDA graphs against ``cuda_graphs=False`` on the
    tiny mix (prompts 8, 13, 4, 23 over 2 slots: trunks and ragged tail
    replays, ring flushes at block 4, evictions and readmissions after the
    capture): the same streams, page tables, used pages and rings bit for
    bit; every flushing step eager and no other, the rest replayed; each
    kernel's launches counted per replay (the warm-up's too)."""
    codec = dataclasses.replace(
        CodecConfig() if codec_on else CodecConfig.off(), cache_block=4,
        weight_backend="auto" if weights_be == "raw" else weights_be)
    run = RunConfig(codec=codec)
    params = PM.init_params(lm.lm_table(TINY),
                            torch.Generator(device=cuda).manual_seed(1),
                            device=cuda)
    got = {}
    for graphs in (False, True):
        eng = ServeEngine(TINY, run, n_slots=2, max_len=48, params=params,
                          compress_weights=weights_be != "raw",
                          cuda_graphs=graphs)
        ops.reset_launch_counts()
        results, st = eng.run(_tiny_requests())
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert [len(r.tokens) for r in results] == [5, 6, 9, 4]
        assert st.n_replay_dispatches > 0
        got[graphs] = ([r.tokens for r in results], _pool_bits(eng.state.kv))
        steps = st.eager_steps + st.graph_replays
        if graphs:
            assert st.cuda_graphs and st.graph_captures == 1
            assert st.eager_steps == st.flush_steps
            assert st.graph_replays > 0
            passes = steps + st.graph_captures        # + the warm-up
        else:
            assert st.graph_replays == 0 and st.eager_steps == steps
            passes = steps
        assert counts["decode_attend_paged"] == TINY.n_layers * passes
        if weights_be == "cuda":
            n_mm = 7 * TINY.n_layers + 1
            assert counts["decompress_matmul"] == \
                n_mm * (passes + st.n_admit_dispatches)
    assert got[True][0] == got[False][0]
    assert got[True][1].keys() == got[False][1].keys()
    for key in got[False][1]:
        assert torch.equal(got[True][1][key], got[False][1][key]), key


def _shared_requests():
    """A shared-prefix mix over 2 slots at block 4: a base prompt, its
    exact duplicate, a fork of its first 4 columns, an unrelated prompt,
    the base again; more requests than slots."""
    rng = np.random.default_rng(42)
    a = rng.integers(0, 512, (24,)).astype(np.int32)
    b = rng.integers(0, 512, (12,)).astype(np.int32)
    fork = np.concatenate([a[:16], rng.integers(0, 512, (6,))
                           .astype(np.int32)])
    return [Request(uid=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(zip([a, b, a.copy(), fork, a.copy()],
                                           [5, 3, 4, 4, 3]))]


@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
def test_prefix_sharing_graph_matches_eager(cuda, codec_on):
    """Prefix sharing on the card: the shared mix from CUDA graphs and
    eagerly gives the same streams, hits and cache counters, and the same
    page tables, page use and pool bytes; then, with every retained column
    evicted, the base prompt again restores its prefix from the warm tier
    (no prefill) on the same stream in both modes."""
    codec = dataclasses.replace(
        CodecConfig() if codec_on else CodecConfig.off(), cache_block=4)
    run = RunConfig(codec=codec)
    params = PM.init_params(lm.lm_table(TINY),
                            torch.Generator(device=cuda).manual_seed(1),
                            device=cuda)
    got = {}
    for graphs in (False, True):
        eng = ServeEngine(TINY, run, n_slots=2, max_len=48, params=params,
                          cuda_graphs=graphs)
        results, st = eng.run(_shared_requests())
        assert st.shared_page_hits > 0 and st.cache_hot_hits > 0
        assert st.graph_replays > 0 if graphs else st.graph_replays == 0
        eng._ensure_free_pages(1 << 30)
        again, st2 = eng.run([Request(uid=9, prompt=_shared_requests()[0]
                                      .prompt, max_new_tokens=5)])
        assert again[0].tokens == results[0].tokens
        assert st2.n_admit_dispatches == 0 and st2.cache_fetched_pages > 0
        torch.cuda.synchronize()
        got[graphs] = ([r.tokens for r in results], _pool_bits(eng.state.kv),
                       [getattr(st2, f) for f in (
                           "shared_page_hits", "cache_hot_hits",
                           "cache_spilled_pages", "cache_spilled_bytes",
                           "cache_fetched_pages", "cache_evicted_cols")])
    assert got[True][0] == got[False][0]
    assert got[True][2] == got[False][2]
    assert got[True][1].keys() == got[False][1].keys()
    for key in got[False][1]:
        assert torch.equal(got[True][1][key], got[False][1][key]), key


def test_graph_recaptured_when_params_change(cuda):
    """A decoder's graph bakes in its parameters: replacing them (raw to
    packed) captures again, and the packed graph's streams equal a fresh
    packed engine's."""
    codec = dataclasses.replace(CodecConfig(), cache_block=4)
    run = RunConfig(codec=codec)
    eng = ServeEngine(TINY, run, n_slots=2, max_len=48, seed=1)
    eng.run(_tiny_requests()[:2])
    fresh = ServeEngine(TINY, run, n_slots=2, max_len=48, seed=1,
                        compress_weights=True)
    eng.params = fresh.params
    a, st = eng.run(_tiny_requests()[2:])
    b, _ = fresh.run(_tiny_requests()[2:])
    assert st.graph_captures == 1
    assert [r.tokens for r in a] == [r.tokens for r in b]


def test_generate_graph_matches_eager(cuda):
    """The fixed-batch loop from a CUDA graph (``generate``'s default on
    the card) against the eager loop: the same tokens; and through
    ``FixedDecoder``, the same block store and rings, the flushing steps
    (3 of 11 at block 4) eager, the rest replayed."""
    run = RunConfig(codec=dataclasses.replace(CodecConfig(), cache_block=4))
    params = PM.init_params(lm.lm_table(TINY),
                            torch.Generator(device=cuda).manual_seed(3),
                            device=cuda)
    prompts = torch.as_tensor(np.random.default_rng(3).integers(
        0, 512, (3, 6)), dtype=torch.int32, device=cuda)
    outs, stores = [], []
    for graphs in (False, True):
        logits, st = engine.prefill(TINY, run, params, prompts, 24)
        dec = engine.FixedDecoder(TINY, run, params, st,
                                  engine.greedy_token(logits), graphs)
        toks = [dec.tok.clone()]
        for _ in range(11):
            dec.step()
            toks.append(dec.tok.clone())
        outs.append(torch.cat(toks, 1))
        assert int(st.length_dev) == st.length == 17
        stores.append([{f: getattr(kv, f).contiguous().view(torch.uint8)
                        for f in ("signman", "planes", "dict_syms",
                                  "esc_pos", "esc_raw", "ring")}
                       for kv in st.kv])
        if graphs:
            assert dec.counts.eager == dec.counts.flush == 3
            assert dec.counts.replays == 8
    for a, b in zip(*stores):
        for f in a:
            assert torch.equal(a[f], b[f]), f
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(engine.generate(TINY, run, params, prompts, 11, 24),
                       outs[0])


@pytest.mark.parametrize("heads", HEAD_MAPS, ids=HEAD_IDS)
@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
def test_fixed_decode_attend_device_length(cuda, heads, codec_on):
    """The fixed kernel's device-length launch (the length a 0-d int32 on
    the card, the grid every span of the store's capacity) at the split's
    edge lengths and windows: within 1e-4 of the plain version and of the
    host-length launch, twice bit for bit; a length past the capacity
    reads as the capacity's last; and captured once in a CUDA graph,
    replayed at every length by rewriting the length in place."""
    h, hkv = heads
    hd, blk, b = 128, 256, 3
    w = 2 * hkv * hd
    gen = torch.Generator(device=cuda).manual_seed(h + codec_on)
    lengths = AC.edge_lengths(blk)
    blocks = _edge_blocks(gen, b, blk, w, max(lengths) // blk + 1)
    nblk = blocks.shape[0]
    ring = _bf16(gen, (b, blk, w))
    q = _bf16(gen, (b, h, hd))
    n = b * blk * w
    if codec_on:
        ct = fixed.compress_many(blocks.reshape(nblk, n), k=5,
                                 esc_capacity=max(n // 128, 8))
        store = (ct.signman, ct.planes, ct.dict_syms, ct.esc_pos, ct.esc_raw,
                 None)
    else:
        store = (None,) * 5 + (blocks,)
    kw = dict(k=5, kv_idx=AC.kv_idx(h, hkv), scale=hd ** -0.5)
    dev_len = torch.zeros((), dtype=torch.int32, device=cuda)
    for length in lengths:
        dev_len.fill_(length)
        for window, softcap in WINDOWS:
            host = (q, *store, ring, length, window)
            dev = (q, *store, ring, dev_len, window)
            before = decode_attend.launches["decode_attend"]
            got = ops.decode_attend(*dev, softcap=softcap, **kw)
            assert decode_attend.launches["decode_attend"] == before + 1
            AC.attend_close(got, ref.decode_attend_plain(*host,
                                                         softcap=softcap,
                                                         **kw))
            AC.attend_close(got, ops.decode_attend(*host, softcap=softcap,
                                                   **kw))
            assert AC.same_bits(got, ops.decode_attend(*dev, softcap=softcap,
                                                       **kw))
    dev_len.fill_((nblk + 1) * blk - 1)
    last = ops.decode_attend(q, *store, ring, dev_len, ref.WINDOW_NONE, **kw)
    dev_len.fill_((nblk + 1) * blk + 7)
    assert AC.same_bits(ops.decode_attend(q, *store, ring, dev_len,
                                          ref.WINDOW_NONE, **kw), last)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.decode_attend(q, *store, ring, dev_len, ref.WINDOW_NONE, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = ops.decode_attend(q, *store, ring, dev_len, ref.WINDOW_NONE,
                                **kw)
    for length in lengths:
        dev_len.fill_(length)
        graph.replay()
        AC.attend_close(out, ref.decode_attend_plain(
            q, *store, ring, length, ref.WINDOW_NONE, **kw))


def test_second_capture_keeps_first_graph(cuda):
    """Two graphs captured on one stream, the second at larger shapes, so
    its warm-up grows all three workspaces (attention, decompress_matmul's
    split-K, the histogram's): the first graph, whose kernels hold the old
    buffers, still replays bit for bit after the card's memory is churned.
    Growing a workspace inside a capture raises."""
    h, hkv, hd, blk = 32, 8, 128, 256
    gen = torch.Generator(device=cuda).manual_seed(21)
    kw = dict(k=5, kv_idx=AC.kv_idx(h, hkv), scale=hd ** -0.5)

    def case(lengths, m, rows):
        q, pool, ring, table, lens = _edge_pool(gen, h, hkv, hd, blk,
                                                lengths, True)
        x = _bf16(gen, (m, 2560))
        wt = ops.compress_weight(_weight(gen, (2560, 9728), 5), k=5)[:3]
        rowsx = _bf16(gen, (rows, 524288), spread=9)

        def step():
            return (*ops.decode_attend_paged(q, *pool, ring, table, lens,
                                             ref.WINDOW_NONE, **kw),
                    ops.matmul_compressed(x, *wt, k=5), ops.histogram(rowsx))
        return step

    side = torch.cuda.Stream()
    graphs, outs, wants = [], [], []
    for step in (case([300, 700], 4, 1), case([300, 700, 1100, 2000, 90, 5],
                                              8, 16)):
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=side):
            out = step()
        g.replay()
        torch.cuda.synchronize()
        graphs.append(g)
        outs.append(out)
        wants.append([t.clone() for t in out])
    with torch.cuda.stream(side):       # the pool the old buffers came from
        junk = [torch.full((1 << 20,), 7.0, device=cuda) for _ in range(64)]
    torch.cuda.current_stream().wait_stream(side)
    for g, out, want in zip(graphs, outs, wants):
        for t in out:
            t.zero_()
        g.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, want):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    del junk
    bigger = case([2000] * 12, 16, 24)
    g = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="workspace"):
        with torch.cuda.graph(g, stream=side):
            bigger()


def test_replay_launch_counts(cuda):
    """``CapturedStep``: the capture counts nothing, the warm-up counts
    what it launched, every replay counts the captured launches."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = _bf16(gen, (4, 2560))
    wt = ops.compress_weight(_weight(gen, (2560, 1024), 5), k=5)[:3]
    rows = _bf16(gen, (2, 4096))

    def step():
        return (ops.matmul_compressed(x, *wt, k=5), ops.histogram(rows),
                ops.histogram(rows))

    ops.reset_launch_counts()
    graph = ops.CapturedStep(step, step, cuda)
    counts = ops.launch_counts()
    assert counts["decompress_matmul"] == 1 and counts["exp_histogram"] == 2
    assert graph.launches == {"decompress_matmul": 1, "exp_histogram": 2,
                              "decompress_matmul/decode": 1}
    for _ in range(3):
        graph.replay()
    counts = ops.launch_counts()
    assert counts["decompress_matmul"] == 4 and counts["exp_histogram"] == 8
    assert decompress_matmul.launches_by_route["decode"] == 4


def test_host_sync_in_captured_step_raises(cuda, monkeypatch):
    """A host read inside the captured step (here an injected ``.item()``
    in the greedy pick) fails the capture, and the error reaches the
    caller: no eager fallback."""
    real = engine.greedy_token

    def reading(logits, tg=None):
        float(logits.max())
        return real(logits, tg)

    run = RunConfig(codec=dataclasses.replace(CodecConfig(), cache_block=4))
    eng = ServeEngine(TINY, run, n_slots=2, max_len=48, seed=1)
    monkeypatch.setattr(engine, "greedy_token", reading)
    with pytest.raises(RuntimeError):
        eng.run(_tiny_requests())
    assert eng.decoder.counts.replays == 0


# ---------------------------------------------------------------------------
# disaggregated serving on the card
# ---------------------------------------------------------------------------

def _disagg_run(codec_on):
    codec = dataclasses.replace(
        CodecConfig() if codec_on else CodecConfig.off(), cache_block=4)
    return RunConfig(codec=codec)


def _card_params(cuda):
    return PM.init_params(lm.lm_table(TINY),
                          torch.Generator(device=cuda).manual_seed(1),
                          device=cuda)


@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
def test_disagg_export_wire_import_bitexact(cuda, codec_on):
    """On the card: a slot exported to a host blob, serialized, parsed and
    imported into another pool (other page ids), then exported again,
    gives the same wire bytes; the imported pages hold the source pages'
    bytes and the ring its ring."""
    from repro_torch.serve.disagg import DecodeReplica, Handoff, PrefillReplica
    from repro_torch.serve.transport import SequenceBlob
    run = _disagg_run(codec_on)
    params = _card_params(cuda)
    src = ServeEngine(TINY, run, n_slots=2, max_len=48, params=params,
                      prefix_sharing=False)
    pr = PrefillReplica(src)
    prompt = np.random.default_rng(3).integers(0, 512, (19,)).astype(np.int32)
    pr.submit(Request(uid=0, prompt=prompt, max_new_tokens=4))
    src._admit_phase(pr.ls)
    blob = pr._export_blob(0)
    data = blob.to_wire(None)[0]
    dec = DecodeReplica(ServeEngine(TINY, run, n_slots=2, max_len=48,
                                    params=params, prefix_sharing=False))
    dec.engine.state.kv.page_used[:3] = True
    slot = dec.import_handoff(Handoff(req=pr.ls.slot_req[0],
                                      blob=SequenceBlob.from_wire(data),
                                      admit_t=0.0))
    torch.cuda.synchronize()
    pr2 = PrefillReplica(dec.engine)
    pr2.ls = dec.ls
    assert pr2._export_blob(slot).to_wire(None)[0] == data
    a, b = src.state.kv, dec.engine.state.kv
    for c in range(blob.n_cols):
        p, q = int(a.page_table[0, c]), int(b.page_table[slot, c])
        assert p != q
        for f in ("signman", "planes", "dict_syms", "esc_pos", "esc_raw",
                  "raw_pages"):
            if getattr(a, f) is not None:
                assert torch.equal(getattr(a, f)[:, p], getattr(b, f)[:, q])
    assert torch.equal(a.ring[:, 0], b.ring[:, slot])


def test_disagg_loopback_socket_and_eager_decode_equal(cuda):
    """The shared mix through 1 prefill -> 1 decode replica on the card:
    the loopback fleet from CUDA graphs, a fleet whose decode replica sits
    behind a threaded socket host, and the loopback fleet with every step
    eager give the same streams and wire bytes; the graph and eager decode
    replicas end with the same page tables and pool bytes."""
    import socket
    import threading
    from repro_torch.serve import (DecodeReplica, DisaggEngine, PageHost,
                                   SocketTransport)
    from repro_torch.serve.net import framing
    run = _disagg_run(True)
    params = _card_params(cuda)
    reqs = _shared_requests()
    got = {}
    for graphs in (True, False):
        dis = DisaggEngine(TINY, run, n_slots=2, max_len=48, params=params,
                           streaming=True, cuda_graphs=graphs)
        ops.reset_launch_counts()
        res, st = dis.run(reqs)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert all(counts[k] > 0 for k in ATTEND_PATH_KERNELS), counts
        assert st.pages_streamed > 0 and st.n_transfers == len(reqs)
        got[graphs] = ([r.tokens for r in res], st.wire_bytes,
                       _pool_bits(dis.decodes[0].engine.state.kv))
    assert got[True][:2] == got[False][:2]
    for key in got[False][2]:
        assert torch.equal(got[True][2][key], got[False][2][key]), key

    host_eng = ServeEngine(TINY, run, n_slots=2, max_len=48, params=params)
    fp = framing.config_fingerprint(TINY, run.codec, 1, 2, 48, 0)
    host = PageHost(DecodeReplica(host_eng), fp)
    listener = socket.create_server(("127.0.0.1", 0))
    thread = threading.Thread(target=host.serve_forever, args=(listener,),
                              kwargs={"once": True}, daemon=True)
    thread.start()
    tr = SocketTransport(timeout=120.0)
    try:
        dis = DisaggEngine(TINY, run, n_slots=2, max_len=48, params=params,
                           transport=tr, streaming=True,
                           decode_addrs=[f"127.0.0.1:"
                                         f"{listener.getsockname()[1]}"])
        res, st = dis.run(reqs)
        tr.close()
        thread.join(timeout=30)
    finally:
        listener.close()
    assert ([r.tokens for r in res], st.wire_bytes) == got[True][:2]


def test_capture_pauses_the_cyclic_collector(cuda):
    """The cyclic garbage collector is off while a step is captured (a
    dead engine's graph freed there would invalidate the capture) and on
    again after it; the captured step replays."""
    import gc
    x = torch.zeros(4, device=cuda)
    seen = []

    def step():
        seen.append(gc.isenabled())
        x.add_(1)

    assert gc.isenabled()
    graph = ops.CapturedStep(step, lambda: x.add_(0), cuda)
    assert seen == [False] and gc.isenabled()
    graph.replay()
    torch.cuda.synchronize()
    assert x.tolist() == [1.0] * 4


# ---------------------------------------------------------------------------
# the parallel attention ∥ SSM hybrid: graphs against eager, SSM bytes
# ---------------------------------------------------------------------------

TINY_HYBRID = ModelConfig(
    name="h", family="hybrid", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16,
    parallel_hybrid=True, attn_layout="hymba_3global", window=16,
    ssm=SSMConfig(d_state=16, headdim=8, chunk=16), sub_quadratic=True)


def _ssm_bits(ssm):
    return [t.contiguous().view(torch.uint8).cpu() for t in ssm]


@pytest.mark.parametrize("sharing", [False, True], ids=["off", "sharing"])
@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
def test_hybrid_graph_streams_match_eager(cuda, codec_on, sharing):
    """The tiny hybrid through ServeEngine from CUDA graphs and eagerly
    (the tiny mix over 2 slots, block 4, windows of 16; with sharing, two
    page-aligned repeats that restore a boundary SSM snapshot): the same
    streams, hits, page tables, pool bytes and SSM state bit for bit;
    every flushing step eager, the rest replayed."""
    codec = dataclasses.replace(
        CodecConfig() if codec_on else CodecConfig.off(), cache_block=4)
    run = RunConfig(codec=codec)
    params = PM.init_params(lm.lm_table(TINY_HYBRID),
                            torch.Generator(device=cuda).manual_seed(1),
                            device=cuda)
    reqs = _tiny_requests()
    if sharing:
        reqs += [Request(uid=10 + i, prompt=reqs[0].prompt.copy(),
                         max_new_tokens=4) for i in range(2)]
    got = {}
    for graphs in (False, True):
        eng = ServeEngine(TINY_HYBRID, run, n_slots=2, max_len=48,
                          params=params, cuda_graphs=graphs,
                          prefix_sharing=sharing)
        results, st = eng.run(reqs)
        torch.cuda.synchronize()
        assert [len(r.tokens) for r in results] == \
            [r.max_new_tokens for r in reqs]
        assert st.n_replay_dispatches == 0          # the exact trunk
        assert (st.shared_page_hits > 0) == sharing
        if graphs:
            assert st.graph_captures == 1 and st.graph_replays > 0
            assert st.eager_steps == st.flush_steps
        got[graphs] = ([r.tokens for r in results], _pool_bits(eng.state.kv),
                       _ssm_bits(eng.state.ssm), st.shared_page_hits)
    assert got[True][0] == got[False][0]
    assert got[True][3] == got[False][3]
    for key in got[False][1]:
        assert torch.equal(got[True][1][key], got[False][1][key]), key
    for a, b in zip(got[True][2], got[False][2]):
        assert torch.equal(a, b)


def test_hybrid_generate_graph_matches_eager(cuda):
    """The hybrid's fixed loop from a CUDA graph against the eager loop:
    the same tokens, block stores, rings and SSM state (the capture's
    warm-up puts the state back)."""
    run = RunConfig(codec=dataclasses.replace(CodecConfig(), cache_block=4))
    params = PM.init_params(lm.lm_table(TINY_HYBRID),
                            torch.Generator(device=cuda).manual_seed(3),
                            device=cuda)
    prompts = torch.as_tensor(np.random.default_rng(3).integers(
        0, 512, (3, 6)), dtype=torch.int32, device=cuda)
    outs, states = [], []
    for graphs in (False, True):
        logits, st = engine.prefill(TINY_HYBRID, run, params, prompts, 24)
        dec = engine.FixedDecoder(TINY_HYBRID, run, params, st,
                                  engine.greedy_token(logits), graphs)
        toks = [dec.tok.clone()]
        for _ in range(11):
            dec.step()
            toks.append(dec.tok.clone())
        outs.append(torch.cat(toks, 1))
        states.append(_ssm_bits(st.ssm) + [
            getattr(kv, f).contiguous().view(torch.uint8).cpu()
            for kv in st.kv for f in ("signman", "planes", "ring")])
        if graphs:
            assert dec.counts.replays == 8 and dec.counts.eager == 3
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*states):
        assert torch.equal(a, b)


def test_hybrid_masked_ssm_update_in_graph(cuda):
    """A slot turned inactive in the middle of a window keeps its SSM state
    through replayed steps (the masked in-place write reads ``active``
    from the staged step buffer), while the active slot's state moves; the
    graph's states equal an eager decoder's on a copy, step for step."""
    run = RunConfig(codec=dataclasses.replace(CodecConfig(), cache_block=4))
    params = PM.init_params(lm.lm_table(TINY_HYBRID),
                            torch.Generator(device=cuda).manual_seed(5),
                            device=cuda)
    prompts = torch.as_tensor(np.random.default_rng(5).integers(
        0, 512, (2, 9)), dtype=torch.int32, device=cuda)
    sts = []
    for _ in range(2):
        st = engine.empty_paged_state(TINY_HYBRID, run, 2, 48, device=cuda)
        logits, d = engine.prefill_sequences(TINY_HYBRID, run, params,
                                             prompts)
        engine.insert_sequences(TINY_HYBRID, run, st, d, [0, 1])
        sts.append(st)
    tok = engine.greedy_token(logits)
    decs = [engine.PagedDecoder(TINY_HYBRID, run, sts[0], graphs=True),
            engine.PagedDecoder(TINY_HYBRID, run, sts[1], graphs=False)]
    for dec in decs:
        dec.tok.copy_(tok)
    only0 = np.array([True, False])
    for t in range(5):                  # lengths 9..13: a flush at 11
        mask = None if t < 2 else only0
        before = _ssm_bits(sts[0].ssm)
        for dec in decs:
            dec.step(params, mask)
        torch.cuda.synchronize()
        after = _ssm_bits(sts[0].ssm)
        for a, b, e in zip(after, before, _ssm_bits(sts[1].ssm)):
            assert torch.equal(a, e)
            moved = a.reshape(3, 2, -1) != b.reshape(3, 2, -1)
            assert moved[:, 0].any()
            assert moved[:, 1].any() == (mask is None)
        assert torch.equal(decs[0].tok, decs[1].tok)
    assert decs[0].counts.replays >= 3 and decs[0].counts.captures == 1
    assert list(sts[0].lengths) == [14, 11]


# ---------------------------------------------------------------------------
# MLA latent payloads in both attention kernels; MoE models on the card
# ---------------------------------------------------------------------------

# (query heads, lora, rope): deepseek-v2-lite-16b's latent, and a small one
MLA_SHAPES = [(16, 512, 64), (4, 48, 16)]
MLA_IDS = ["deepseek", "small"]


def _mla_kw(lora, softcap=None):
    return dict(k=5, kv_idx=(), scale=(128 + 64) ** -0.5, softcap=softcap,
                mla_lora=lora)


@pytest.mark.parametrize("blk", [16, 256])
@pytest.mark.parametrize("shape", MLA_SHAPES, ids=MLA_IDS)
@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
def test_decode_attend_paged_mla_matches_plain(cuda, shape, codec_on, blk):
    """The paged kernel's MLA latent path (k the whole row of lora + rope
    columns, v its first lora columns, every query head on one row, out
    lora wide: hd_v != hd) on a pool with escapes on both sides of a span
    boundary and one past the capacity, slot lengths at the split's edges;
    full, windowed, last span only, soft-capped: within 1e-4 of the plain
    version, one launch per call, a second launch bit for bit."""
    h, lora, rope = shape
    w = lora + rope
    gen = torch.Generator(device=cuda).manual_seed(h + lora + blk)
    lengths = AC.edge_lengths(blk)
    s_, n_pages = len(lengths), 16
    maxp = max(lengths) // blk + 1
    pages = _bf16(gen, (n_pages, blk, w))
    pages[0] = AC.overflowing(gen, (blk, w))
    pages[1] = AC.with_escapes(AC.dict_filled(gen, (blk, w)),
                               AC.escape_rows(blk))
    table = torch.randint(0, n_pages, (s_, maxp), generator=gen,
                          device=cuda, dtype=torch.int32)
    longest = max(range(s_), key=lambda i: lengths[i])
    table[longest, :2] = torch.tensor([0, 1], dtype=torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    if codec_on:
        ct = fixed.compress_many(pages, k=5)
        assert int(ct.n_escapes[0]) > ct.esc_pos.shape[-1]
        pool = (ct.signman, ct.planes, ct.dict_syms, ct.esc_pos, ct.esc_raw,
                None)
    else:
        pool = (None,) * 5 + (pages,)
    q, ring = _bf16(gen, (s_, h, w)), _bf16(gen, (s_, blk, w))
    for window, softcap in WINDOWS:
        args = (q, *pool, ring, table, lens, window)
        kw = _mla_kw(lora, softcap)
        before = decode_attend.launches["decode_attend_paged"]
        got = ops.decode_attend_paged(*args, **kw)
        assert decode_attend.launches["decode_attend_paged"] == before + 1
        assert got[0].shape == (s_, h, lora)
        AC.attend_close(got, ref.paged_decode_attend_plain(*args, **kw))
        assert AC.same_bits(got, ops.decode_attend_paged(*args, **kw))


@pytest.mark.parametrize("blk", [16, 256])
@pytest.mark.parametrize("shape", MLA_SHAPES, ids=MLA_IDS)
@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
def test_fixed_decode_attend_mla_matches_plain(cuda, shape, codec_on, blk):
    """The fixed-batch kernel's MLA latent path: 3 sequences share each
    block's dictionary and side channel (escapes in sequence 0, escapes on
    both sides of a span boundary then overflow in sequence 2), lengths at
    the split's edges, host- and device-length launches; within 1e-4 of
    the plain version, bit for bit on a second launch."""
    h, lora, rope = shape
    w, b = lora + rope, 3
    gen = torch.Generator(device=cuda).manual_seed(h + lora + blk + 1)
    lengths = AC.edge_lengths(blk)
    blocks = _edge_blocks(gen, b, blk, w, max(lengths) // blk + 1)
    nblk = blocks.shape[0]
    n = b * blk * w
    if codec_on:
        ct = fixed.compress_many(blocks.reshape(nblk, n), k=5,
                                 esc_capacity=max(n // 128, 8))
        assert int(ct.n_escapes[1]) > ct.esc_pos.shape[-1]
        store = (ct.signman, ct.planes, ct.dict_syms, ct.esc_pos, ct.esc_raw,
                 None)
    else:
        store = (None,) * 5 + (blocks,)
    q, ring = _bf16(gen, (b, h, w)), _bf16(gen, (b, blk, w))
    dev_len = torch.zeros((), dtype=torch.int32, device=cuda)
    for length in lengths:
        dev_len.fill_(length)
        for window, softcap in WINDOWS:
            kw = _mla_kw(lora, softcap)
            want = ref.decode_attend_plain(q, *store, ring, length, window,
                                           **kw)
            for form in (length, dev_len):
                args = (q, *store, ring, form, window)
                got = ops.decode_attend(*args, **kw)
                assert got[0].shape == (b, h, lora)
                AC.attend_close(got, want)
                assert AC.same_bits(got, ops.decode_attend(*args, **kw))


def test_mla_kernels_refuse_bad_latents(cuda):
    """The MLA launch checks: the payload as wide as the query, a multiple
    of 32 wide, lora a multiple of 16 inside it, no head map."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, ring = _bf16(gen, (2, 4, 64)), _bf16(gen, (2, 16, 64))
    table = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
    lens = torch.tensor([3, 20], dtype=torch.int32, device=cuda)
    pages = _bf16(gen, (2, 16, 64))
    pool = (None,) * 5 + (pages,)
    for bad in (dict(mla_lora=40), dict(mla_lora=80),
                dict(mla_lora=48, kv_idx=(0, 0, 0, 0))):
        kw = dict(_mla_kw(48), **bad)
        with pytest.raises(ValueError, match="MLA"):
            decode_attend.decode_attend_paged(q, *pool, ring, table, lens,
                                              ref.WINDOW_NONE, **kw)
    with pytest.raises(ValueError, match="MLA"):
        decode_attend.decode_attend_paged(
            _bf16(gen, (2, 4, 48)), *pool, ring, table, lens,
            ref.WINDOW_NONE, **_mla_kw(32))


TINY_MOE_MLA = ModelConfig(
    name="dv", family="moe", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=512, head_dim=16,
    mla=MLAConfig(kv_lora_rank=48, qk_nope_dim=16, qk_rope_dim=16,
                  v_dim=16),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=32, n_shared=1))
TINY_JAMBA = dataclasses.replace(
    TINY_HYBRID, name="jl", d_ff=0,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=32, n_shared=1,
                  capacity_factor=4.0))


def test_moe_mla_model_on_card_matches_cpu(cuda):
    """The tiny MoE + MLA model, card against CPU from the same weights:
    the per-sequence prefill, then 10 paged steps fed the CPU's greedy
    tokens (block 4: flushes at 12, 16, 20): logits within 1e-2 at every
    step (f32 sums in another order; a routing choice near a tie may go
    the other way, which moves the logits by far less); the paged kernel
    launched once per layer and step on the latent pages."""
    run = RunConfig(codec=dataclasses.replace(CodecConfig(), cache_block=4))
    params = PM.init_params(lm.lm_table(TINY_MOE_MLA),
                            torch.Generator().manual_seed(3))
    prompt = torch.as_tensor(np.random.default_rng(3).integers(
        0, 512, (2, 9)), dtype=torch.int32)
    logits, states = {}, {}
    for dev in ("cpu", "cuda"):
        p = PM.to_device(params, dev)
        st = engine.empty_paged_state(TINY_MOE_MLA, run, 2, 48, device=dev)
        lg, d = engine.prefill_sequences(TINY_MOE_MLA, run, p, prompt.to(dev))
        engine.insert_sequences(TINY_MOE_MLA, run, st, d, [0, 1])
        logits[dev], states[dev] = [lg.float().cpu()], (st, p)
    assert states["cuda"][0].kv.ring.shape[-1] == 64       # the latent
    ops.reset_launch_counts()
    for _ in range(10):
        feed = engine.greedy_token(logits["cpu"][-1])
        for dev in ("cpu", "cuda"):
            st, p = states[dev]
            logits[dev].append(engine.paged_decode_step(
                TINY_MOE_MLA, run, p, st, feed.to(dev)).float().cpu())
    assert ops.launch_counts()["decode_attend_paged"] == 2 * 10
    for a, b in zip(logits["cpu"], logits["cuda"]):
        assert torch.isfinite(b).all()
        assert float((a - b).abs().max()) <= 1e-2


@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
@pytest.mark.parametrize("model", [TINY_MOE_MLA, TINY_JAMBA],
                         ids=["moe_mla", "jamba"])
def test_moe_graph_streams_match_eager(cuda, model, codec_on):
    """A tiny MoE + MLA model and a tiny jamba-like hybrid (attention ∥
    SSM, MoE FFN) through ServeEngine from CUDA graphs and eagerly: the
    same streams, page tables, pool bytes and SSM state bit for bit; every
    flushing step eager, the rest replayed (the MoE decode's gathers and
    batched products captured)."""
    codec = dataclasses.replace(
        CodecConfig() if codec_on else CodecConfig.off(), cache_block=4)
    run = RunConfig(codec=codec)
    params = PM.init_params(lm.lm_table(model),
                            torch.Generator(device=cuda).manual_seed(1),
                            device=cuda)
    got = {}
    for graphs in (False, True):
        eng = ServeEngine(model, run, n_slots=2, max_len=48, params=params,
                          cuda_graphs=graphs)
        assert not eng.prefix_sharing
        results, st = eng.run(_tiny_requests())
        torch.cuda.synchronize()
        assert [len(r.tokens) for r in results] == [5, 6, 9, 4]
        assert st.n_replay_dispatches == 0          # the exact trunk
        if graphs:
            assert st.graph_captures == 1 and st.graph_replays > 0
            assert st.eager_steps == st.flush_steps
        got[graphs] = ([r.tokens for r in results], _pool_bits(eng.state.kv),
                       [] if eng.state.ssm is None
                       else _ssm_bits(eng.state.ssm))
    assert got[True][0] == got[False][0]
    for key in got[False][1]:
        assert torch.equal(got[True][1][key], got[False][1][key]), key
    for a, b in zip(got[True][2], got[False][2]):
        assert torch.equal(a, b)


def test_moe_mla_generate_graph_matches_eager(cuda):
    """The tiny MoE + MLA model's fixed loop (one joint MoE dispatch at
    prefill) from a CUDA graph against the eager loop: the same tokens,
    latent block stores and rings."""
    run = RunConfig(codec=dataclasses.replace(CodecConfig(), cache_block=4))
    params = PM.init_params(lm.lm_table(TINY_MOE_MLA),
                            torch.Generator(device=cuda).manual_seed(3),
                            device=cuda)
    prompts = torch.as_tensor(np.random.default_rng(3).integers(
        0, 512, (3, 6)), dtype=torch.int32, device=cuda)
    outs, states = [], []
    for graphs in (False, True):
        logits, st = engine.prefill(TINY_MOE_MLA, run, params, prompts, 24)
        dec = engine.FixedDecoder(TINY_MOE_MLA, run, params, st,
                                  engine.greedy_token(logits), graphs)
        toks = [dec.tok.clone()]
        for _ in range(11):
            dec.step()
            toks.append(dec.tok.clone())
        outs.append(torch.cat(toks, 1))
        states.append([getattr(kv, f).contiguous().view(torch.uint8).cpu()
                       for kv in st.kv for f in ("signman", "planes",
                                                 "ring")])
        if graphs:
            assert dec.counts.replays == 8 and dec.counts.eager == 3
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*states):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# tensor parallelism: both attention kernels' shard path (tp, ti), and the
# collectives of a one-rank group on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("heads", [(8, 2), (4, 1)], ids=["gqa", "mqa"])
def test_decode_attend_paged_tp_shards_match_plain(cuda, heads, tp):
    """Every shard ti of tp: lengths 0 .. 3 blk tp + 5, window 5, softcap,
    escapes on both sides of a span boundary and past the capacity, 1 and
    64 slots; within 1e-4 of the plain version, two launches bit for
    bit."""
    h, hkv = heads
    hd, blk = 32, 16
    gen = torch.Generator(device=cuda).manual_seed(tp * 10 + h)
    kw = dict(kv_idx=AC.kv_idx(h, hkv), scale=hd ** -0.5, mla_lora=None)
    worst, n = AC.tp_paged_checks(gen, h, hd, 2 * hkv * hd, kw, blk=blk,
                                  tps=(tp,))
    assert n == 3 * tp * len(AC.TP_MASKS) and worst < 1e-4


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("heads", [(8, 2), (4, 1)], ids=["gqa", "mqa"])
def test_decode_attend_tp_shards_match_plain(cuda, heads, tp):
    """The fixed-batch kernel on every shard of tp, both launch forms
    (host and device length), the same cases as the paged test."""
    h, hkv = heads
    hd, blk = 32, 16
    gen = torch.Generator(device=cuda).manual_seed(tp * 20 + h)
    kw = dict(kv_idx=AC.kv_idx(h, hkv), scale=hd ** -0.5, mla_lora=None)
    worst, n = AC.tp_fixed_checks(gen, h, hd, 2 * hkv * hd, kw, blk=blk,
                                  tps=(tp,))
    assert n > 0 and worst < 1e-4


# MLA latents: deepseek-v2-lite's (16 heads over one 512 + 64 row) and a
# small one (4 heads over 48 + 16)
MLA_TP_GEOMS = {"deepseek": (16, 512, 64), "small": (4, 48, 16)}


def _mla_tp_kw(h, lora, rope):
    return dict(kv_idx=(), scale=(128 + rope) ** -0.5, mla_lora=lora)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("geom", sorted(MLA_TP_GEOMS))
def test_decode_attend_paged_mla_tp_shards_match_plain(cuda, geom, tp):
    """The MLA latent path on every shard of tp: the paged kernel against
    its plain version (the tp cases above: lengths 0 .. 3 blk tp + 5,
    window 5, softcap, escapes on both sides of a span boundary and past
    the capacity, 1 and 64 slots), within 1e-4, two launches bit for
    bit."""
    h, lora, rope = MLA_TP_GEOMS[geom]
    w = lora + rope
    gen = torch.Generator(device=cuda).manual_seed(tp * 30 + h)
    worst, n = AC.tp_paged_checks(gen, h, w, w, _mla_tp_kw(h, lora, rope),
                                  blk=16, tps=(tp,))
    assert n == 3 * tp * len(AC.TP_MASKS) and worst < 1e-4


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("geom", sorted(MLA_TP_GEOMS))
def test_decode_attend_mla_tp_shards_match_plain(cuda, geom, tp):
    """The fixed-batch kernel's MLA latent path on every shard of tp,
    both launch forms, the same cases."""
    h, lora, rope = MLA_TP_GEOMS[geom]
    w = lora + rope
    gen = torch.Generator(device=cuda).manual_seed(tp * 40 + h)
    worst, n = AC.tp_fixed_checks(gen, h, w, w, _mla_tp_kw(h, lora, rope),
                                  blk=16, tps=(tp,))
    assert n > 0 and worst < 1e-4


def test_decode_attend_tp1_args_are_the_tp1_path(cuda):
    """tp = 1, ti = 0 passed explicitly gives the bits of the default
    launch (the shard arithmetic is the identity there)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    h, hkv, hd, blk = 8, 2, 32, 16
    w = 2 * hkv * hd
    kw = dict(k=5, kv_idx=AC.kv_idx(h, hkv), scale=hd ** -0.5)
    pages = _bf16(gen, (6, blk, w), spread=9)
    ct = fixed.compress_many(pages, k=5)
    pool = (ct.signman, ct.planes, ct.dict_syms, ct.esc_pos, ct.esc_raw, None)
    q = _bf16(gen, (3, h, hd))
    ring = _bf16(gen, (3, blk, w))
    table = torch.randint(0, 6, (3, 4), generator=gen, device=cuda,
                          dtype=torch.int32)
    lens = torch.tensor([5, 40, 63], dtype=torch.int32, device=cuda)
    for window in (ref.WINDOW_NONE, 7):
        args = (q, *pool, ring, table, lens, window)
        assert AC.same_bits(decode_attend.decode_attend_paged(*args, **kw),
                            decode_attend.decode_attend_paged(
                                *args, **kw, tp=1, ti=0))
    with pytest.raises(ValueError, match="shard"):
        decode_attend.decode_attend_paged(q, *pool, ring, table, lens,
                                          ref.WINDOW_NONE, **kw, tp=2, ti=2)


def test_one_rank_group_collectives_are_identity_on_card(cuda):
    """A world-1 TPGroup on the card: every collective returns its input
    (the compressed ones too: no round trip at one rank)."""
    from repro_torch.core import collectives as cl
    from repro_torch.launch import mesh

    tg = mesh.solo(cuda)
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = _bf16(gen, (4, 6, 64), spread=30)
    for y in (cl.psum(x, tg), cl.pmax(x, tg), cl.pmin(x, tg),
              cl.all_gather(x, tg, axis=1), cl.psum_scatter(x, tg, 1),
              cl.all_to_all(x, tg, 0, 1), cl.ppermute(x, tg, [(0, 0)]),
              cl.compressed_all_gather(x, tg, gather_axis=1),
              cl.compressed_psum(x, tg), cl.compressed_all_to_all(x, tg),
              cl.compressed_ppermute(x, tg, [(0, 0)])):
        assert y is x
    assert cl.host_max(7, tg) == 7
    assert torch.equal(cl.all_gather(x, tg, axis=1, tiled=False),
                       x.unsqueeze(1))


# ---------------------------------------------------------------------------
# training: the codec at the FSDP gathers' largest group, and the train
# step on the card
# ---------------------------------------------------------------------------

def test_compress_many_one_group_of_2_27_plus_3(cuda):
    """One compress group of 2^27 + 3 elements (the embedding's FSDP shard
    of full-width qwen1.5-1.8b is 151936 x 1024, about 2^27.2): both codec
    kernels equal their plain versions, and compress_many -> ops.unpack
    gives the input back, escapes (within capacity) included."""
    n = (1 << 27) + 3
    gen = torch.Generator(device=cuda).manual_seed(27)
    x = (torch.randn((1, n), generator=gen, device=cuda) * 0.02)
    x[0, ::1_000_003] *= 2.0 ** -60                  # rare exponents
    x = x.to(torch.bfloat16)
    _check_codec(x, 5)
    ct = fixed.compress_many(x, k=5, esc_capacity=n // 128)
    assert 0 < int(ct.n_escapes[0]) <= n // 128
    before = ops.launch_counts()["lexi_unpack"]
    back = ops.unpack(ct)
    assert ops.launch_counts()["lexi_unpack"] == before + 1
    assert torch.equal(back.view(torch.int16), x.view(torch.int16))


def test_matmul_f32_gradient_matches_cpu(cuda):
    """``layers.matmul_f32``'s gradient on the card (its autograd Function
    around ``aten::mm.dtype``) against the CPU path's autograd."""
    from repro_torch.models import layers
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 5, 64), generator=gen).to(torch.bfloat16)
    w = (torch.randn((64, 96), generator=gen) * 0.1).to(torch.bfloat16)
    g = torch.randn((2, 5, 96), generator=gen)
    grads = []
    for dev in ("cpu", cuda):
        xd = x.to(dev, copy=True).requires_grad_()
        wd = w.to(dev, copy=True).requires_grad_()
        out = layers.matmul_f32(xd, wd)
        assert out.dtype == torch.float32
        (out * g.to(dev)).sum().backward()
        grads.append((out.detach().cpu(), xd.grad.cpu(), wd.grad.cpu()))
    for a, b in zip(*grads):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-2,
                                   atol=1e-3)


def test_train_steps_on_card_match_cpu(cuda):
    """Three steps of the reduced qwen1.5-1.8b at mesh 1x1 on the card and
    on the CPU from the same seeded state and batches: losses within 1e-3
    relative."""
    from repro_torch.configs import get_config, make_reduced
    from repro_torch.core import tree
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train import train_step as TS
    cfg = make_reduced(get_config("qwen1.5-1.8b"))
    run = RunConfig(warmup_steps=1)
    mesh = Mesh(1, 1, None)
    table = lm.lm_table(cfg, run=run)
    data = SyntheticLM(cfg.vocab_size, 4, 32, seed=0)
    losses = {}
    for dev in ("cpu", cuda):
        state = tree.map_(lambda t: t.to(dev), TS.init_state(table, seed=0))
        step = TS.make_train_step(cfg, run, mesh, table, total_steps=3)
        losses[str(dev)] = []
        for i in range(3):
            batch = {k: v.to(dev) for k, v in data.batch_at(i).items()}
            state, m = step(state, batch)
            losses[str(dev)].append(float(m["loss"]))
    for a, b in zip(losses["cpu"], losses["cuda"]):
        assert abs(a - b) <= 1e-3 * abs(a), losses


# ---------------------------------------------------------------------------
# the remaining families' geometries: hd 256 with softcap and window
# (gemma2-9b), a GQA group of 5 (hymba-1.5b), the non-causal cross-memory
# launch (seamless-m4t-large-v2); the attention-free PagedDecoder
# ---------------------------------------------------------------------------

# (heads, kv heads, head dim, the local layers' window, softcap)
FAMILY_GEOMETRIES = {"gemma2": (16, 8, 256, 4096, 50.0),
                     "hymba": (25, 5, 64, 1024, None)}


@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
@pytest.mark.parametrize("geo", list(FAMILY_GEOMETRIES))
def test_attention_kernels_family_geometries(cuda, geo, codec_on):
    """Both attention kernels at gemma2-9b's heads (16/8, hd 256: a
    4096-wide row) and hymba-1.5b's (25 query heads on 5 kv heads), block
    256, the split's edge lengths and one past the window: full, the
    config's window, and (gemma2) softcap 50 with and without it; escapes
    past capacity and on both sides of a span boundary.  Within 1e-4 of
    the plain versions, two launches bit for bit."""
    h, hkv, hd, win, softcap = FAMILY_GEOMETRIES[geo]
    blk, w = 256, 2 * hkv * hd
    kv_idx = AC.kv_idx(h, hkv)
    lengths = AC.edge_lengths(blk) + [win + 300]
    cases = [(ref.WINDOW_NONE, None), (win, None), (win, softcap),
             (ref.WINDOW_NONE, softcap)]
    gen = torch.Generator(device=cuda).manual_seed(h * hd + codec_on)
    q, pool, ring, table, lens = _edge_pool(gen, h, hkv, hd, blk, lengths,
                                            codec_on)
    for window, cap in cases:
        args = (q, *pool, ring, table, lens, window)
        kw = dict(k=5, kv_idx=kv_idx, scale=hd ** -0.5, softcap=cap)
        got = ops.decode_attend_paged(*args, **kw)
        AC.attend_close(got, ref.paged_decode_attend_plain(*args, **kw))
        assert AC.same_bits(got, ops.decode_attend_paged(*args, **kw))
    b = 3
    blocks = _edge_blocks(gen, b, blk, w, max(lengths) // blk + 1)
    nblk, n = blocks.shape[0], b * blk * w
    if codec_on:
        ct = fixed.compress_many(blocks.reshape(nblk, n), k=5,
                                 esc_capacity=max(n // 128, 8))
        assert int(ct.n_escapes[1]) > ct.esc_pos.shape[-1]
        store = (ct.signman, ct.planes, ct.dict_syms, ct.esc_pos, ct.esc_raw,
                 None)
    else:
        store = (None,) * 5 + (blocks,)
    ring = _bf16(gen, (b, blk, w))
    q = _bf16(gen, (b, h, hd))
    for length in lengths:
        dev_len = torch.tensor(length, dtype=torch.int32, device=cuda)
        for window, cap in cases:
            kw = dict(k=5, kv_idx=kv_idx, scale=hd ** -0.5, softcap=cap)
            want = ref.decode_attend_plain(q, *store, ring, length, window,
                                           **kw)
            for ln in (length, dev_len):          # both launch forms
                got = ops.decode_attend(q, *store, ring, ln, window, **kw)
                AC.attend_close(got, want)
            assert AC.same_bits(got, ops.decode_attend(
                q, *store, ring, dev_len, window, **kw))


@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
@pytest.mark.parametrize("sm", [5, 300, 513, 1000])
def test_cross_memory_attend(cuda, sm, codec_on):
    """An encoder-decoder's cross attention at seamless-m4t-large-v2's
    heads (16/16, hd 64), 4 sequences: the encoder's K/V of ``sm`` frames
    (lengths that end mid-block) stored by ``cache.fill_from_prefill``
    (full blocks compressed on the card byte for byte as on the CPU, the
    tail in the ring) and attended non-causally, no softcap, at that
    static length through ``cache.attend_cache``: within 1e-4 of the
    plain version on the CPU's store."""
    from repro_torch.models import cache, layers

    cfg = ModelConfig(name="x", family="encdec", n_layers=1, d_model=1024,
                      n_heads=16, n_kv_heads=16, d_ff=64, vocab_size=512,
                      head_dim=64, encdec=True, frontend="audio_stub")
    codec = CodecConfig(cache_block=256) if codec_on else \
        dataclasses.replace(CodecConfig.off(), cache_block=256)
    run = RunConfig(codec=codec)
    gen = torch.Generator(device=cuda).manual_seed(sm)
    b, w = 4, cache.kv_width(cfg)
    vals = _bf16(gen, (b, sm, w))
    q = _bf16(gen, (b, 16, 1, 64))
    spec = layers.AttnSpec(causal=False, softcap=None)
    stores = {}
    for dev in ("cpu", "cuda"):
        st = cache.empty_kv(cfg, run, b, 1024 + 8, group=b, device=dev)
        stores[dev] = cache.fill_from_prefill(cfg, run, st, vals.to(dev))
    for f in ("signman", "planes", "dict_syms", "esc_pos", "esc_raw",
              "raw_blocks", "ring"):
        a, c = getattr(stores["cpu"], f), getattr(stores["cuda"], f)
        assert (a is None) == (c is None)
        if a is not None:
            assert torch.equal(a.view(torch.uint8),
                               c.cpu().view(torch.uint8)), f
    before = decode_attend.launches["decode_attend"]
    got = cache.attend_cache(cfg, run, stores["cuda"], q, sm, spec)
    assert decode_attend.launches["decode_attend"] == before + 1
    want = cache.attend_cache(cfg, run, stores["cpu"], q.cpu(), sm, spec)
    torch.testing.assert_close(got.float().cpu(), want.float(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("sm", [5, 513, 1000])
def test_cross_memory_attend_tp_shards(cuda, sm, tp):
    """An encoder-decoder's cross attention at tp: each shard's store of
    its interleaved rows of the memory's K/V (seamless-m4t-large-v2's
    heads, 4 sequences, ``sm`` frames: a shard's rows end mid-block, or
    it holds fewer than a block) filled on the card byte for byte as on
    the CPU, and attended at the memory's static length through the
    kernel's ``tp, ti`` path (host-length launch, non-causal, no
    softcap): every shard within 1e-4 of its plain version, and the
    shards' partials merged within 1e-4 of tp = 1's attention over the
    whole memory (normalised in f32)."""
    from repro_torch.models import cache, layers

    cfg = ModelConfig(name="x", family="encdec", n_layers=1, d_model=1024,
                      n_heads=16, n_kv_heads=16, d_ff=64, vocab_size=512,
                      head_dim=64, encdec=True, frontend="audio_stub")
    run = RunConfig(codec=CodecConfig(cache_block=256))
    gen = torch.Generator(device=cuda).manual_seed(sm + tp)
    b, w = 4, cache.kv_width(cfg)
    pad = (-sm) % tp                   # whole rows for every shard
    vals = _bf16(gen, (b, sm + pad, w))
    q = _bf16(gen, (b, 16, 1, 64))
    kw = cache.kernel_statics(cfg, run, q, layers.AttnSpec(
        causal=False, softcap=None))
    outs, ms, ls = [], [], []
    for ti in range(tp):
        rows = vals.reshape(b, -1, tp, w)[:, :, ti]
        stores = {}
        for dev in ("cpu", "cuda"):
            st = cache.empty_kv(cfg, run, b, 1024 + 8, group=b, device=dev,
                                tp=tp)
            stores[dev] = cache.fill_from_prefill(cfg, run, st,
                                                  rows.to(dev))
        for f in ("signman", "planes", "dict_syms", "esc_pos", "esc_raw",
                  "ring"):
            assert torch.equal(getattr(stores["cpu"], f).view(torch.uint8),
                               getattr(stores["cuda"], f).cpu()
                               .view(torch.uint8)), (ti, f)
        args = {dev: (q.to(dev)[:, :, 0],
                      *(getattr(stores[dev], f)[0] for f in
                        ("signman", "planes", "dict_syms", "esc_pos",
                         "esc_raw")), None, stores[dev].ring, sm,
                      ref.WINDOW_NONE) for dev in ("cpu", "cuda")}
        before = decode_attend.launches["decode_attend"]
        got = ops.decode_attend(*args["cuda"], **kw, tp=tp, ti=ti)
        assert decode_attend.launches["decode_attend"] == before + 1
        want = ops.decode_attend(*args["cpu"], **kw, tp=tp, ti=ti)
        AC.attend_close(got, tuple(t.to(cuda) for t in want))
        o, m, l_ = (t.float().cpu() for t in got)
        outs.append(o)
        ms.append(m)
        ls.append(l_)
    m_g = torch.stack(ms).max(0).values
    wts = [torch.exp(m - m_g) for m in ms]
    num = sum(o * wt[..., None] for o, wt in zip(outs, wts))
    den = sum(l_ * wt for l_, wt in zip(ls, wts))
    whole = cache.empty_kv(cfg, run, b, 1024 + 8, group=b, device="cpu")
    cache.fill_from_prefill(cfg, run, whole, vals[:, :sm].cpu())
    o, _, l_ = ops.decode_attend(
        q.cpu()[:, :, 0], *(getattr(whole, f)[0] for f in
                            ("signman", "planes", "dict_syms", "esc_pos",
                             "esc_raw")), None, whole.ring, sm,
        ref.WINDOW_NONE, **kw)
    torch.testing.assert_close(num / den[..., None], o / l_[..., None],
                               rtol=1e-4, atol=1e-4)


SSM_ONLY = ModelConfig(name="s", family="ssm", n_layers=2, d_model=64,
                       n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=512,
                       ssm=SSMConfig(d_state=16, headdim=8, chunk=16),
                       sub_quadratic=True)


def test_attention_free_paged_decoder_graph_matches_eager(cuda):
    """The attention-free model (no pool: ``PagedState.kv`` None) on
    ``ServeEngine`` from CUDA graphs against eagerly: the same streams and
    SSM state bit for bit, every step replayed (no ring ever flushes),
    one capture; no page, and no attention or page-codec launch."""
    run = RunConfig(codec=CodecConfig(cache_block=4))
    params = PM.init_params(lm.lm_table(SSM_ONLY),
                            torch.Generator(device=cuda).manual_seed(2),
                            device=cuda)
    got = {}
    for graphs in (False, True):
        eng = ServeEngine(SSM_ONLY, run, n_slots=2, max_len=48,
                          params=params, cuda_graphs=graphs)
        assert eng.state.kv is None
        ops.reset_launch_counts()
        results, st = eng.run(_tiny_requests())
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert [len(r.tokens) for r in results] == [5, 6, 9, 4]
        assert st.peak_pages == 0
        assert not any(counts[k] for k in ATTEND_PATH_KERNELS), counts
        if graphs:
            assert st.graph_captures == 1 and st.eager_steps == 0
            assert st.graph_replays == st.decode_steps
        got[graphs] = ([r.tokens for r in results],
                       [t.view(torch.uint8).cpu() for t in eng.state.ssm])
    assert got[True][0] == got[False][0]
    for a, c in zip(got[True][1], got[False][1]):
        assert torch.equal(a, c)
