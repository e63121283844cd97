"""The plain twins of the two attention kernels on the tensor-parallel
shard path (``kernels.ref.paged_decode_attend_plain`` /
``decode_attend_plain`` with ``tp``, ``ti``) against the reference's
oracles (``repro.kernels.ref.paged_decode_attend_ref`` /
``decode_attend_ref``) at tp 2 and 4, every shard, within 1e-4: the
shapes of ``tests/test_decode_dispatch.py::test_attend_paged_backend_parity``
(block 4, GQA 4:2 and MQA 3:1 with their padded query heads, window None
and 5, codec on and off), the pages and blocks compressed by the port and
given to the oracles decompressed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.configs.base import ModelConfig
from repro_torch.core import fixed
from repro_torch.kernels import ref as tref
from repro_torch.models import cache as tcache
from torch_port_util import bf16_np, to_np, to_torch

BLK, K, HD = 4, 5, 8
HEADS = {"gqa": (4, 2), "mqa": (3, 1)}


def _cfg(h, hkv):
    return ModelConfig(name="t", family="dense", n_layers=1, d_model=32,
                       n_heads=h, n_kv_heads=hkv, d_ff=64, vocab_size=128,
                       head_dim=HD)


def _stores(rng, n_rec, lead, w, codec_on):
    """Random (n_rec, *lead, BLK, W) bf16 records with a few escapes, as
    the kernel's fields (port-compressed) and as the oracle sees them."""
    vals = bf16_np(rng, (n_rec,) + lead + (BLK, w), 0.5, spread=12)
    if not codec_on:
        return (None,) * 5 + (to_torch(vals),), vals
    ct = fixed.compress_many(to_torch(vals).reshape(n_rec, -1), k=K)
    seen = to_np(fixed.decompress(ct)).reshape(vals.shape)
    return (ct.signman, ct.planes, ct.dict_syms, ct.esc_pos, ct.esc_raw,
            None), seen


@pytest.mark.parametrize("window", [None, 5], ids=["full", "windowed"])
@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("tp", [2, 4])
def test_paged_plain_matches_oracle_every_shard(tp, heads, codec_on, window):
    cfg = _cfg(*HEADS[heads])
    hq, w = cfg.padded_heads(tp), tcache.kv_width(cfg)
    kv_idx = tcache.gqa_head_table(cfg, hq)
    win = tref.WINDOW_NONE if window is None else window
    rng = np.random.default_rng(tp * 10 + len(heads))
    lengths = np.asarray([3 * BLK * tp + 2, BLK * tp + 1, 0, tp - 1,
                          2 * BLK * tp], np.int32)
    n_s = len(lengths)
    maxp = 4
    q = bf16_np(rng, (n_s, hq, HD))
    n_pages = n_s * maxp
    pool, seen = _stores(rng, n_pages, (), w, codec_on)
    table = rng.permutation(n_pages).reshape(n_s, maxp).astype(np.int32)
    ring = bf16_np(rng, (n_s, BLK, w), 0.5)
    for ti in range(tp):
        loc = [tref.local_length(int(L), tp, ti) for L in lengths]
        assert max(loc) // BLK < maxp
        args = (to_torch(q), *pool, to_torch(ring), torch.as_tensor(table),
                torch.as_tensor(lengths), win)
        out, m, l = tref.paged_decode_attend_plain(
            *args, k=K, kv_idx=kv_idx, scale=HD ** -0.5, tp=tp, ti=ti)
        got = (out / l.clamp(min=1e-30)[..., None]).numpy()
        want = np.asarray(jref.paged_decode_attend_ref(
            jnp.asarray(q), jnp.asarray(seen), jnp.asarray(table),
            jnp.asarray(lengths), jnp.asarray(ring), kv_idx=kv_idx,
            scale=HD ** -0.5, window=win, tp=tp, ti=ti))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        # a shard that holds no live position: l = 0, m = NEG_INF
        dead = np.asarray(loc) == 0
        assert (l.numpy()[dead] == 0).all()
        assert (m.numpy()[dead] == tref.NEG_INF).all()
        # the port's own oracle agrees
        mine = tref.paged_decode_attend_ref(
            to_torch(q), to_torch(seen), torch.as_tensor(table),
            torch.as_tensor(lengths), to_torch(ring), kv_idx=kv_idx,
            scale=HD ** -0.5, window=win, tp=tp, ti=ti).numpy()
        np.testing.assert_allclose(mine, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("window", [None, 5], ids=["full", "windowed"])
@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("tp", [2, 4])
def test_fixed_plain_matches_oracle_every_shard(tp, heads, codec_on, window):
    cfg = _cfg(*HEADS[heads])
    hq, w = cfg.padded_heads(tp), tcache.kv_width(cfg)
    kv_idx = tcache.gqa_head_table(cfg, hq)
    win = tref.WINDOW_NONE if window is None else window
    rng = np.random.default_rng(tp * 20 + len(heads))
    b, nblk = 2, 4
    q = bf16_np(rng, (b, hq, HD))
    store, seen = _stores(rng, nblk, (b,), w, codec_on)
    ring = bf16_np(rng, (b, BLK, w), 0.5)
    for length in (0, 1, tp - 1, BLK * tp + 1, 2 * BLK * tp + 3,
                   3 * BLK * tp + 2):
        for ti in range(tp):
            args = (to_torch(q), *store, to_torch(ring), length, win)
            out, m, l = tref.decode_attend_plain(
                *args, k=K, kv_idx=kv_idx, scale=HD ** -0.5, tp=tp, ti=ti)
            got = (out / l.clamp(min=1e-30)[..., None]).numpy()
            want = np.asarray(jref.decode_attend_ref(
                jnp.asarray(q), jnp.asarray(seen), jnp.asarray(ring), length,
                kv_idx=kv_idx, scale=HD ** -0.5, window=win, tp=tp, ti=ti))
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
            if tref.local_length(length, tp, ti) == 0:
                assert (l.numpy() == 0).all()


def test_local_length_and_stream_mask_match_the_reference():
    """``ref.local_length`` and ``stream_mask`` at tp 1, 2, 4: the
    reference's ``_live_masks`` arithmetic, column by column."""
    from repro.models import cache as jcache

    lens = np.asarray([0, 1, 2, 3, 7, 8, 9, 17, 33], np.int32)
    for tp in (1, 2, 4):
        for ti in range(tp):
            for win in (tref.WINDOW_NONE, 5):
                for i in range(3):
                    for ring in (False, True):
                        want = np.asarray(jcache.stream_mask(
                            jnp.asarray(lens), i, BLK, tp, ti, win,
                            ring=ring))
                        got = tref.stream_mask(torch.as_tensor(lens), i, BLK,
                                               win, ring, tp, ti).numpy()
                        assert (got == want).all(), (tp, ti, win, i, ring)
            for L in lens:
                assert tref.local_length(int(L), tp, ti) == int(
                    jcache.local_full_pages(int(L), ti, 1, tp))
