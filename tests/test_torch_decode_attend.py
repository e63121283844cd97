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
