"""Paged decompress + attend: the port's plain version against the JAX
package's oracle (``ref.paged_decode_attend_ref``) and its ``jax`` decode
backend (``cache.attend_paged``), within rtol = atol = 1e-4 on the
normalised output — GQA / MQA / MHA, full and windowed, codec on and off,
unmapped table entries, escapes and escape overflow.  The reference's
``interpret`` backend is never used (it cannot run on jax 0.9).  The CUDA
kernel is held against the plain version in test_torch_gpu.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import ModelConfig as JModel, RunConfig as JRun
from repro.core import collectives as jcl
from repro.core import fixed as jfixed
from repro.core.collectives import CodecConfig as JCodec
from repro.kernels import ref as jref
from repro.models import cache as jcache, layers as jlayers
from repro_torch.configs.base import ModelConfig as TModel, RunConfig as TRun
from repro_torch.core import fixed as tfixed
from repro_torch.core.collectives import CodecConfig as TCodec
from repro_torch.kernels import ops, ref as tref
from repro_torch.models import cache as tcache, layers as tlayers
from torch_port_util import bf16_np, to_np, to_torch

torch.set_num_threads(2)

HEADS = {"gqa": (4, 2), "mqa": (5, 1), "mha": (8, 8)}
HD, BLK, N_S, MAXP, N_PAGES, K = 16, 8, 3, 3, 9, 5


def _inputs(heads, seed=0):
    """Pages with escapes (page 0: overflow, page 3: a few), a table with
    unmapped entries, per-slot lengths incl. a 2-token slot."""
    h, hkv = heads
    w = 2 * hkv * HD
    rng = np.random.default_rng(seed)
    pages = bf16_np(rng, (N_PAGES, BLK, w), 0.5)
    pages[0] = bf16_np(rng, (BLK, w), 0.5, spread=30)
    # page 3: 31 exponents fill the dictionary, 4 rare ones escape
    e = np.resize(np.arange(-15, 16), BLK * w).astype(np.float64)
    e[[5, 77, 150, 201]] = [-60, -59, -58, -57]
    vals = rng.choice([-1.0, 1.0], e.shape) * (1 + rng.random(e.shape)) \
        * np.exp2(e)
    pages[3] = vals.reshape(BLK, w).astype(pages.dtype)
    ring = bf16_np(rng, (N_S, BLK, w), 0.5)
    pt = rng.integers(0, N_PAGES, (N_S, MAXP)).astype(np.int32)
    pt[0, 0] = 0
    pt[2, 1] = 3
    pt[1, 1:] = -1                           # short slot: unmapped tail
    lengths = np.asarray([2 * BLK + 3, 2, MAXP * BLK], np.int32)
    q = bf16_np(rng, (N_S, h, HD))
    return q, pages, ring, pt, lengths


def _kv_idx(heads):
    h, hkv = heads
    g = max(h // hkv, 1)
    return tuple(min(i // g, hkv - 1) for i in range(h))


@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
@pytest.mark.parametrize("window", [None, 9], ids=["full", "windowed"])
def test_plain_matches_reference_oracle(heads, codec_on, window):
    hh = HEADS[heads]
    q, pages, ring, pt, lengths = _inputs(hh)
    win = tref.WINDOW_NONE if window is None else window
    kv_idx, scale = _kv_idx(hh), HD ** -0.5
    pages_t = to_torch(pages)
    if codec_on:
        ct = tfixed.compress_many(pages_t, k=K)
        fields = (ct.signman, ct.planes, ct.dict_syms, ct.esc_pos,
                  ct.esc_raw, None)
        assert int(ct.n_escapes[0]) > ct.esc_pos.shape[-1]   # overflow
        assert 0 < int(ct.n_escapes[3]) <= ct.esc_pos.shape[-1]
        # the oracle sees what the codec stores (overflow decodes lossy)
        seen = np.asarray(jax.vmap(jfixed.decompress)(
            jax.vmap(lambda v: jfixed.compress(v, k=K))(jnp.asarray(pages))))
    else:
        fields, seen = (None,) * 5 + (pages_t,), pages
    ids = torch.as_tensor(np.maximum(pt, 0))
    args = (to_torch(q), *fields, to_torch(ring), ids,
            torch.as_tensor(lengths), win)
    out, m, l = tref.paged_decode_attend_plain(*args, k=K, kv_idx=kv_idx,
                                               scale=scale)
    got = (out / l.clamp(min=1e-30)[..., None]).numpy()
    want = np.asarray(jref.paged_decode_attend_ref(
        jnp.asarray(q), jnp.asarray(seen), jnp.asarray(pt),
        jnp.asarray(lengths), jnp.asarray(ring), kv_idx=kv_idx, scale=scale,
        window=win, tp=1, ti=0))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the ops wrapper takes the plain version for CPU tensors
    o2, m2, l2 = ops.decode_attend_paged(*args, k=K, kv_idx=kv_idx,
                                         scale=scale)
    assert torch.equal(o2, out) and torch.equal(l2, l) and torch.equal(m2, m)


def _models(heads, codec_on):
    h, hkv = heads
    kw = dict(name="t", family="dense", n_layers=1, d_model=64, n_heads=h,
              n_kv_heads=hkv, d_ff=128, vocab_size=64, head_dim=HD)
    jc = JCodec(cache_block=BLK) if codec_on else dataclasses.replace(
        JCodec.off(), cache_block=BLK)
    tc = TCodec(cache_block=BLK) if codec_on else dataclasses.replace(
        TCodec.off(), cache_block=BLK)
    return JModel(**kw), JRun(codec=jc), TModel(**kw), TRun(codec=tc)


@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
@pytest.mark.parametrize("window", [None, 9], ids=["full", "windowed"])
def test_attend_paged_matches_jax_backend(heads, codec_on, window):
    """``cache.attend_paged`` of both packages on the same pool: the f32
    normalised attention within 1e-4 (the reference's jax-backend scan
    body), and the public bf16 results within one bf16 rounding."""
    hh = HEADS[heads]
    jcfg, jrun, tcfg, trun = _models(hh, codec_on)
    q, pages, ring, pt, lengths = _inputs(hh, seed=1)
    w = 2 * hh[1] * HD
    if codec_on:
        cts = jax.vmap(lambda v: jfixed.compress(v, k=K))(jnp.asarray(pages))
        jf = dict(signman=cts.signman, planes=cts.planes,
                  dict_syms=cts.dict_syms, esc_pos=cts.esc_pos,
                  esc_raw=cts.esc_raw, raw_pages=None)
    else:
        jf = dict(signman=None, planes=None, dict_syms=None, esc_pos=None,
                  esc_raw=None, raw_pages=jnp.asarray(pages))
    jpkv = jcache.PagedKV(page_table=jnp.asarray(pt),
                          page_used=jnp.zeros((N_PAGES,), bool),
                          ring=jnp.asarray(ring), **jf)
    tf = {k: (None if v is None else to_torch(np.asarray(v))[None])
          for k, v in jf.items()}
    tpkv = tcache.PagedKV(page_table=pt.copy(),
                          page_used=np.zeros((N_PAGES,), bool),
                          ring=to_torch(ring)[None], **tf)
    spec_kw = dict(windowed=window is not None)
    jspec, tspec = jlayers.AttnSpec(**spec_kw), tlayers.AttnSpec(**spec_kw)
    q4 = jnp.asarray(q)[:, :, None]
    win = jcache.effective_window(jspec, window)
    lens = jnp.asarray(lengths)

    # the reference's jax-backend body, before its bf16 merge
    load = lambda i: jcache.load_pages(jpkv, jpkv.page_table[:, i], BLK, w,
                                       jrun.codec)
    valid = lambda i: jcache.stream_mask(lens, i, BLK, 1, 0, win, ring=False)
    ring_ok = jcache.stream_mask(lens, 0, BLK, 1, 0, win, ring=True)
    o, _, l = jcache._attend_scan_jax(jcfg, q4, jspec, hh[0], load, MAXP,
                                      valid, jpkv.ring, ring_ok)
    want = np.asarray(o / jnp.maximum(l, 1e-30)[..., None])[:, :, 0]
    args = (to_torch(q), *tpkv.layer_fields(0), tpkv.ring[0],
            tpkv.page_ids(), torch.as_tensor(lengths),
            tcache.effective_window(tspec, window))
    out, _, lt = tref.paged_decode_attend_plain(
        *args, k=K, kv_idx=tcache.gqa_head_table(tcfg, hh[0]),
        scale=HD ** -0.5)
    got = (out / lt.clamp(min=1e-30)[..., None]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jout = jax.jit(jcl.shmap(
        lambda qq: jcache.attend_paged(jcfg, jrun, jpkv, qq, lens, jspec, 1,
                                       window=window),
        mesh, (P(),), P()))(q4)
    tout = tcache.attend_paged(tcfg, trun, tpkv, 0, to_torch(q4),
                               torch.as_tensor(lengths), tspec,
                               window=window)
    a = np.asarray(jout).astype(np.float32)
    b = to_np(tout).astype(np.float32)
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=2.0 ** -8, atol=1e-4)


def test_stream_mask_matches_reference():
    lens = np.asarray([0, 3, 8, 17, 40], np.int32)
    for i in range(6):
        for ring in (False, True):
            for win in (tcache.WINDOW_NONE, 5):
                want = np.asarray(jcache.stream_mask(
                    jnp.asarray(lens), i, 8, 1, 0, win, ring=ring))
                got = tcache.stream_mask(torch.as_tensor(lens), i, 8, win,
                                         ring).numpy()
                assert (want == got).all(), (i, ring, win)


# ---------------------------------------------------------------------------
# the kernels' split of the stream across CTAs (FlashDecoding) and merge
# ---------------------------------------------------------------------------

SPLIT_BLK = 16      # blocks of 16 rows, so spans of 4 rows cut every page


def _split_inputs(heads, seed):
    """A pool of SPLIT_BLK-row pages with escapes and overflow, slot
    lengths at and around span and block edges (incl. 0 and 1)."""
    h, hkv = heads
    w = 2 * hkv * HD
    rng = np.random.default_rng(seed)
    pages = bf16_np(rng, (N_PAGES, SPLIT_BLK, w), 0.5)
    pages[0] = bf16_np(rng, (SPLIT_BLK, w), 0.5, spread=30)
    lengths = np.asarray([0, 1, 3, 4, 5, 16, 17, 32, 47], np.int32)
    maxp = int(lengths.max()) // SPLIT_BLK + 1
    pt = rng.integers(0, N_PAGES, (len(lengths), maxp)).astype(np.int32)
    ring = bf16_np(rng, (len(lengths), SPLIT_BLK, w), 0.5)
    q = bf16_np(rng, (len(lengths), h, HD))
    return q, pages, ring, pt, lengths


@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("span", [4, 16])
@pytest.mark.parametrize("window", [None, 2, 9], ids=["full", "w2", "w9"])
def test_split_partials_match_unsplit_and_reference_merge(heads, span,
                                                          window):
    """The paged kernel's split: the plain partials of every span of the
    grid (``paged_splits``), merged in split order by the kernels' rule,
    equal the unsplit plain version within 1e-5 (normalised; m too), and
    the reference's ``merge_partials`` (run under ``jax.vmap`` with the
    split axis as its named axis) gives the same attention within one
    bf16 rounding (it returns bf16)."""
    from repro_torch.kernels import decode_attend as tda

    hh = HEADS[heads]
    q, pages, ring, pt, lengths = _split_inputs(hh, seed=span)
    win = tref.WINDOW_NONE if window is None else window
    kv_idx, scale = _kv_idx(hh), HD ** -0.5
    ct = tfixed.compress_many(to_torch(pages), k=K)
    assert int(ct.n_escapes[0]) > ct.esc_pos.shape[-1]          # overflow
    args = (ct.signman, ct.planes, ct.dict_syms, ct.esc_pos, ct.esc_raw,
            None, to_torch(ring), torch.as_tensor(pt),
            torch.as_tensor(lengths), win)
    vals, ok = tref.paged_stream(*args, k=K)
    nsplit = (pt.shape[1] + 1) * SPLIT_BLK // span
    (out, m, l), (outs, ms, ls) = tref.split_partials_plain(
        to_torch(q), vals, ok, span, kv_idx=kv_idx, scale=scale,
        nsplit=nsplit)
    assert outs.shape[0] == nsplit
    if span == tda.span_rows(SPLIT_BLK):
        assert nsplit == tda.paged_splits(pt.shape[1], SPLIT_BLK)
    o1, m1, l1 = tref.paged_decode_attend_plain(
        to_torch(q), *args, k=K, kv_idx=kv_idx, scale=scale)
    got = out / l.clamp(min=1e-30)[..., None]
    want = o1 / l1.clamp(min=1e-30)[..., None]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    live = (l1 > 0).numpy()
    assert ((l > 0).numpy() == live).all()
    np.testing.assert_allclose(m.numpy()[live], m1.numpy()[live], rtol=1e-5,
                               atol=1e-5)
    assert (m.numpy()[~live] == np.float32(tref.NEG_INF)).all()
    assert (out.numpy()[~live] == 0).all()

    merge = jax.vmap(lambda o, mm, ll: jlayers.merge_partials(o, mm, ll,
                                                              "split"),
                     axis_name="split")
    res = np.asarray(merge(jnp.asarray(outs.numpy())[:, :, :, None],
                           jnp.asarray(ms.numpy())[..., None],
                           jnp.asarray(ls.numpy())[..., None]))
    assert res.shape == (nsplit,) + tuple(outs.shape[1:3]) + (1, HD)
    for j in range(nsplit):                  # every split gets the merge
        np.testing.assert_array_equal(res[j], res[0])
    np.testing.assert_allclose(res[0][:, :, 0].astype(np.float32),
                               got.numpy(), rtol=2.0 ** -8, atol=1e-5)


def test_merge_skips_dead_splits():
    """A dead split (m = NEG_INF) adds nothing, whatever its out holds
    (the kernel never writes it): no NaN, and all-dead gives out = 0,
    m = NEG_INF, l = 0."""
    rng = np.random.default_rng(5)
    outs = torch.as_tensor(rng.normal(size=(3, 2, 4, HD)), dtype=torch.float32)
    ms = torch.as_tensor(rng.normal(size=(3, 2, 4)), dtype=torch.float32)
    ls = torch.as_tensor(rng.random((3, 2, 4)) + 0.5, dtype=torch.float32)
    ms[1] = tref.NEG_INF
    ls[1] = 0.0
    outs[1] = float("nan")
    ms[:, 1] = tref.NEG_INF
    ls[:, 1] = 0.0
    out, m, l = tref.merge_split_partials(outs, ms, ls)
    assert torch.isfinite(out).all()
    live = [0, 2]
    mm = ms[live, 0].max(0).values
    w = torch.exp(ms[live, 0] - mm)
    torch.testing.assert_close(out[0], (outs[live, 0] * w[..., None]).sum(0),
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(l[0], (ls[live, 0] * w).sum(0), rtol=1e-6,
                               atol=1e-6)
    assert (out[1] == 0).all() and (l[1] == 0).all()
    assert (m[1] == np.float32(tref.NEG_INF)).all()


@pytest.mark.parametrize("length", [0, 1, 7, 8, 9, 16, 17, 29])
@pytest.mark.parametrize("window", [None, 1, 5, 12], ids=["full", "w1",
                                                         "w5", "w12"])
def test_fixed_split_grid_matches_unsplit(length, window):
    """The fixed kernel's grid at the host-side length: only the spans
    ``fixed_splits`` names (from the first one inside the window), merged,
    equal the unsplit plain version within 1e-5."""
    from repro_torch.kernels import decode_attend as tda

    h, hkv = HEADS["gqa"]
    blk, b, nblk = 8, 3, 4
    w = 2 * hkv * HD
    rng = np.random.default_rng(length)
    blocks = to_torch(bf16_np(rng, (nblk, b, blk, w), 0.5))
    ring = to_torch(bf16_np(rng, (b, blk, w), 0.5))
    q = to_torch(bf16_np(rng, (b, h, HD)))
    win = tref.WINDOW_NONE if window is None else window
    kw = dict(kv_idx=_kv_idx((h, hkv)), scale=HD ** -0.5)
    vals, ok = tref.fixed_stream(blocks[:length // blk], ring, length, win)
    span = tda.span_rows(blk)
    first, nsplit = tda.fixed_splits(length, win, blk)
    (out, m, l), _ = tref.split_partials_plain(q, vals, ok, span,
                                               first=first, nsplit=nsplit,
                                               **kw)
    o1, m1, l1 = tref.decode_attend_plain(q, *(None,) * 5, blocks, ring,
                                          length, win, k=K, **kw)
    np.testing.assert_allclose((out / l.clamp(min=1e-30)[..., None]).numpy(),
                               (o1 / l1.clamp(min=1e-30)[..., None]).numpy(),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(l > 0, l1 > 0)


def test_split_grid_sizes():
    """``span_rows``: the largest power of two dividing the block, at most
    128.  ``paged_splits``: every span of maxp pages and the ring.
    ``fixed_splits``: exactly the spans holding a live position (one dead
    split when none is), checked against every position."""
    from repro_torch.kernels import decode_attend as tda

    assert [tda.span_rows(b) for b in (4, 16, 48, 128, 256, 1000, 1024)] \
        == [4, 16, 16, 128, 128, 8, 128]
    assert tda.paged_splits(8, 256) == 18          # 2000 tokens: 7 pages
    assert tda.paged_splits(1, 16) == 2
    assert tda.paged_splits(0, 4) == 1             # the ring alone
    for blk in (8, 48, 256):
        p = tda.span_rows(blk)
        for length in list(range(0, 3 * blk + 2)) + [1100, 4400]:
            for window in (tref.WINDOW_NONE, 1, 5, p, 300, 4096, 0):
                first, n = tda.fixed_splits(length, window, blk)
                live = {pos // p for pos in range(length)
                        if pos > length - 1 - window}
                if live:
                    assert set(range(first, first + n)) == live, \
                        (blk, length, window)
                else:
                    assert n == 1 and 0 <= first <= -(-length // p)
