"""The port's model code against the JAX package at tp = 1 (a 1x1 mesh):
layer primitives, attention projections, a dense block, the trunk and the
prefill, from the same bridged weights and inputs.  And the paged cache:
pages written by ``fill_from_prefill``/``paged_insert_many`` and
``append_token_paged`` from the same bf16 K/V are byte-identical to the
reference's, with equal page tables, through release and page reuse.

Tolerances: bf16 results may differ by one bf16 rounding step (rtol
2^-8) where the two frameworks sum f32 products in another order; f32
results (rope tables, logits) get absolute bounds stated per test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import MeshConfig, ModelConfig as JModel
from repro.configs.base import RunConfig as JRun
from repro.core import collectives as jcl
from repro.core import fixed as jfixed
from repro.core.collectives import CodecConfig as JCodec
from repro.models import attention as jattn, blocks as jblocks
from repro.models import cache as jcache, layers as jlayers, lm as jlm
from repro.models import params as jparams
from repro.serve import engine as jengine
from repro_torch.configs.base import ModelConfig as TModel
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.core.collectives import CodecConfig as TCodec
from repro_torch.models import attention as tattn, blocks as tblocks
from repro_torch.models import cache as tcache, layers as tlayers, lm as tlm
from repro_torch.models import params as tparams
from repro_torch.serve import engine as tengine
from torch_port_util import bf16_np, bits, to_np, to_torch

torch.set_num_threads(2)

BF16_RTOL = 2.0 ** -8
MESH = jax.make_mesh((1, 1), ("data", "model"))

CFGS = {
    "bench": dict(name="bench", family="dense", n_layers=2, d_model=64,
                  n_heads=8, n_kv_heads=4, d_ff=128, vocab_size=512,
                  head_dim=16),
    "qknorm-bias": dict(name="qb", family="dense", n_layers=2, d_model=64,
                        n_heads=4, n_kv_heads=4, d_ff=96, vocab_size=300,
                        head_dim=16, qk_norm=True, qkv_bias=True,
                        rope_theta=1e6),
}


def shm_jit(f, n_args):
    """``f`` jitted under shard_map on the 1x1 mesh (the reference's
    functions read axis indices / collectives)."""
    return jax.jit(jcl.shmap(f, MESH, tuple(P() for _ in range(n_args)),
                             P()))


def shm(f, *args):
    return shm_jit(f, len(args))(*args)


def close_bf16(got, want, rtol=BF16_RTOL, atol=1e-6, steps=None):
    """bf16 results within one rounding step; ``steps`` > 0 allows that
    many rounding steps of the tensor's largest magnitude (a residual
    sum rounds at the scale of its largest summand)."""
    want = np.asarray(want, np.float32)
    if steps:
        atol = steps * BF16_RTOL * float(np.abs(want).max())
    np.testing.assert_allclose(
        np.asarray(to_np(got) if isinstance(got, torch.Tensor) else got,
                   np.float32), want, rtol=rtol, atol=atol)


def _jparams_with_bias(jcfg, jrun, seed):
    table = jlm.lm_table(jcfg, MeshConfig(data=1, model=1, pod=1), jrun)
    params = jparams.init_params(table, jax.random.key(seed))
    params = jax.device_get(params)
    rng = np.random.default_rng(seed)
    attn = params["blocks"]["attn"]
    for b in ("bq", "bk", "bv"):               # zero-init: make them count
        if b in attn:
            attn[b] = bf16_np(rng, attn[b].shape, 0.05)
    for nm in ("q_norm", "k_norm"):
        if nm in attn:
            attn[nm] = bf16_np(rng, attn[nm].shape, 0.2) + 1
    return params


@pytest.fixture(scope="module", params=sorted(CFGS))
def model(request):
    kw = CFGS[request.param]
    jcfg, tcfg = JModel(**kw), TModel(**kw)
    jrun = JRun(codec=JCodec(cache_block=8))
    trun = TRun(codec=TCodec(cache_block=8))
    jp = _jparams_with_bias(jcfg, jrun, seed=4)
    tp_ = tparams.from_jax_params(jp)
    dims = jlm.lm_fsdp_dims(
        jlm.lm_table(jcfg, MeshConfig(data=1, model=1, pod=1), jrun))
    return jcfg, jrun, tcfg, trun, jp, tp_, dims


def test_param_table_matches_reference(model):
    jcfg, jrun, tcfg, _, jp, tp_, _ = model
    t = tlm.lm_table(tcfg)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in flat_j:
        node = tp_
        pd = t
        for key in path:
            node, pd = node[key.key], pd[key.key]
        assert tuple(node.shape) == tuple(leaf.shape) == pd.shape, path
        assert (bits(node) == bits(np.asarray(leaf))).all(), path
    gen = torch.Generator().manual_seed(0)
    init = tparams.init_params(t, gen)
    assert float(init["blocks"]["ln1"].float().mean()) == 1.0
    assert abs(float(init["embed"].float().std()) - 0.02) < 2e-3


def test_rms_norm_rope_swiglu():
    rng = np.random.default_rng(0)
    x = bf16_np(rng, (3, 5, 64), 2.0)
    s = bf16_np(rng, (64,), 0.3)
    close_bf16(tlayers.rms_norm(to_torch(x), to_torch(s), 1e-6),
               jlayers.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6))
    pos = np.asarray([0, 1, 7, 300, 4095], np.int32)
    cj, sj = jlayers.rope_tables(jnp.asarray(pos), 16, 1e6)
    ct, st = tlayers.rope_tables(torch.as_tensor(pos), 16, 1e6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=2e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=2e-6)
    xr = bf16_np(rng, (2, 4, 5, 16))
    close_bf16(tlayers.apply_rope(to_torch(xr), ct, st),
               jlayers.apply_rope(jnp.asarray(xr), cj, sj))
    g, u = bf16_np(rng, (4, 32), 2.0), bf16_np(rng, (4, 32), 2.0)
    close_bf16(tlayers.swiglu(to_torch(g), to_torch(u)),
               jlayers.swiglu(jnp.asarray(g), jnp.asarray(u)))
    close_bf16(tlayers.pdot(to_torch(g), to_torch(u.T.copy()),
                            to_torch(g[0, :4])),
               jlayers.pdot(jnp.asarray(g), jnp.asarray(u.T.copy()),
                            jnp.asarray(g[0, :4])))


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("softcap", [None, 5.0])
def test_flash_attention(windowed, softcap):
    """Multi-chunk schedule (S = 4 chunks of 16): the reference's causal
    pair schedule (or its rectangle schedule when windowed) against the
    port's rectangle schedule with skipped upper chunks."""
    rng = np.random.default_rng(1)
    q = bf16_np(rng, (2, 8, 64, 16))
    k = bf16_np(rng, (2, 4, 64, 16))
    v = bf16_np(rng, (2, 4, 64, 16))
    pos = np.arange(64, dtype=np.int32)
    kw = dict(causal=True, softcap=softcap, windowed=windowed)
    win = 13 if windowed else None
    want = jlayers.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(pos), jlayers.AttnSpec(**kw), window=win, chunk_q=16,
        chunk_kv=16)
    pt = torch.as_tensor(pos)
    got = tlayers.flash_attention(
        to_torch(q), to_torch(k), to_torch(v), pt, pt,
        tlayers.AttnSpec(**kw), window=win, chunk_q=16, chunk_kv=16)
    close_bf16(got, want, atol=1e-5)


def test_decode_qkv_and_out(model):
    jcfg, _, tcfg, _, jp, tp_, _ = model
    rng = np.random.default_rng(2)
    h = bf16_np(rng, (3, 1, jcfg.d_model))
    pos = np.asarray([0, 17, 301], np.int32)
    pj = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["attn"])
    pt = {k: v[0] for k, v in tp_["blocks"]["attn"].items()}
    qj, nj = shm(lambda hh, pp: jattn.decode_qkv(jcfg, pj, hh, pp, 1),
                 jnp.asarray(h), jnp.asarray(pos))
    qt, nt = tattn.decode_qkv(tcfg, pt, to_torch(h), torch.as_tensor(pos))
    close_bf16(qt, qj)
    close_bf16(nt, nj)
    merged = bf16_np(rng, (3, jcfg.n_heads, 1, jcfg.head_dim))
    oj = shm(lambda m: jattn.decode_out(jcfg, pj, m, 1), jnp.asarray(merged))
    ot = tattn.decode_out(tcfg, pt, to_torch(merged))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5,
                               atol=1e-6)


def _gathers_fit(run_codec, arrays):
    """The reference's tp=1 ``lexi_all_gather`` round trip is the identity
    only without escape overflow: check the activations it gathers."""
    for a in arrays:
        a = jnp.asarray(to_np(a))
        ct = jfixed.compress(a, k=run_codec.k,
                             esc_capacity=run_codec.esc_capacity(a.size))
        assert int(ct.n_escapes) <= ct.esc_pos.shape[0]


def test_block_forward(model):
    jcfg, jrun, tcfg, trun, jp, tp_, _ = model
    rng = np.random.default_rng(3)
    x = bf16_np(rng, (2, 24, jcfg.d_model))
    pos = np.arange(24, dtype=np.int32)
    pj = jax.tree_util.tree_map(lambda a: a[1], jp["blocks"])
    spec = jattn.base_attn_spec(jcfg)
    xj, cj, _ = shm(lambda xx, pp: jblocks.block_forward(
        jcfg, jrun, pj, xx, pp, spec, 1, want_cache=True),
        jnp.asarray(x), jnp.asarray(pos))
    pl = tlm.layer_params(tp_, 1)
    xt, (kt, vt), _ = tblocks.block_forward(
        tcfg, trun, pl, to_torch(x), torch.as_tensor(pos),
        tattn.base_attn_spec(tcfg), want_cache=True)
    close_bf16(xt, xj, steps=1)
    close_bf16(kt, cj["kv"][0])
    close_bf16(vt, cj["kv"][1])
    h1 = tlayers.rms_norm(to_torch(x), pl["ln1"], tcfg.norm_eps)
    _gathers_fit(jrun.codec, [h1])


def test_lm_forward_and_prefill(model):
    jcfg, jrun, tcfg, trun, jp, tp_, dims = model
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    xj, _, _ = shm(lambda p, t: jlm.lm_forward(jcfg, jrun, p, t, 1, dims),
                   jp, jnp.asarray(toks))
    xt, _ = tlm.lm_forward(tcfg, trun, tp_, torch.as_tensor(toks))
    close_bf16(xt, xj, steps=2)

    lj, dj = shm(lambda p, t: jengine.prefill(jcfg, jrun, p, dims, t, 64, 1),
                 jp, jnp.asarray(toks[:1]))
    lt, dt = tengine.prefill(tcfg, trun, tp_, torch.as_tensor(toks[:1]), 64)
    lj = np.asarray(lj)
    vocab_ok = np.arange(lj.shape[-1]) < jcfg.vocab_size
    # f32 logits of a trunk whose bf16 activations may differ by one
    # rounding step here and there: within 5e-3 (logits are O(0.3))
    np.testing.assert_allclose(lt.numpy()[..., vocab_ok], lj[..., vocab_ok],
                               atol=5e-3)
    assert (lt.numpy()[..., ~vocab_ok] == lj[..., ~vocab_ok]).all()
    assert int(tengine.greedy_token(lt)[0, 0]) == int(lj[0, 0].argmax())
    assert dt.length == 20 and len(dt.kv) == jcfg.n_layers
    # every gathered activation of the reference's trunk fits its codec
    x = tlm.embed_tokens(tcfg, tp_["embed"], torch.as_tensor(toks))
    spec = tattn.base_attn_spec(tcfg)
    for i in range(tcfg.n_layers):
        pl = tlm.layer_params(tp_, i)
        h1 = tlayers.rms_norm(x, pl["ln1"], tcfg.norm_eps)
        x_new, _, _ = tblocks.block_forward(tcfg, trun, pl, x,
                                         torch.arange(20), spec)
        o = tattn.attn_forward(tcfg, trun, pl["attn"], h1, torch.arange(20),
                               spec)[0].to(torch.bfloat16)
        h2 = tlayers.rms_norm(x + o, pl["ln2"], tcfg.norm_eps)
        _gathers_fit(jrun.codec, [h1, h2])
        x = x_new


# ---------------------------------------------------------------------------
# page bytes and page tables
# ---------------------------------------------------------------------------

def _cache_cfgs(codec_on):
    kw = dict(name="c", family="dense", n_layers=1, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=64, vocab_size=64, head_dim=16)
    jc = JCodec(cache_block=4) if codec_on else dataclasses.replace(
        JCodec.off(), cache_block=4)
    tc = TCodec(cache_block=4) if codec_on else dataclasses.replace(
        TCodec.off(), cache_block=4)
    return JModel(**kw), JRun(codec=jc), TModel(**kw), TRun(codec=tc)


def _assert_pools_equal(jpkv, tpkv):
    assert (np.asarray(jpkv.page_table) == tpkv.page_table).all()
    assert (np.asarray(jpkv.page_used) == tpkv.page_used).all()
    assert (bits(np.asarray(jpkv.ring)) == bits(tpkv.ring[0])).all()
    for f in ("signman", "planes", "dict_syms", "esc_pos", "esc_raw",
              "raw_pages"):
        a, b = getattr(jpkv, f), getattr(tpkv, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert (bits(np.asarray(a)) == bits(b[0])).all(), f


@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
def test_pages_byte_identical(codec_on):
    jcfg, jrun, tcfg, trun = _cache_cfgs(codec_on)
    n_slots, max_len, w = 3, 40, jcache.kv_width(jcfg)
    rng = np.random.default_rng(6)
    jpkv = jcache.empty_paged_kv(jcfg, jrun, n_slots, max_len, 1)
    tpkv = tcache.empty_paged_kv(tcfg, trun, n_slots, max_len)
    _assert_pools_equal(jpkv, tpkv)
    assert tcache.page_bytes(tcfg, trun) == jcache.page_bytes(jcfg, jrun)
    lengths = np.zeros((n_slots,), np.int32)
    active = np.zeros((n_slots,), bool)

    def insert(slots, s):
        nonlocal jpkv
        vals = bf16_np(rng, (len(slots), s, w), spread=6)
        one = lambda v: jcache.fill_from_prefill(
            jcfg, jrun, jcache.empty_kv(jcfg, jrun, 1, max_len, 1), v[None],
            s, 1)
        kvb = jax.vmap(lambda v: shm(one, v))(jnp.asarray(vals))
        jpkv = shm(lambda p, k: jcache.paged_insert_many(
            jcfg, jrun, p, k, jnp.asarray(slots), s, 1), jpkv, kvb)
        tk = tcache.fill_from_prefill(
            tcfg, trun, tcache.empty_kv(tcfg, trun, len(slots), max_len),
            to_torch(vals))
        for b in range(len(slots)):           # the prefill-side store too
            for f in ("signman", "planes", "dict_syms", "esc_pos",
                      "esc_raw", "raw_blocks"):
                a, t = getattr(kvb, f), getattr(tk, f)
                if a is not None:
                    assert (bits(np.asarray(a[b])) == bits(t[b])).all(), f
        tcache.paged_insert_many(tcfg, trun, tpkv, [tk], slots, s)
        lengths[slots] = s
        active[slots] = True

    jstep = shm_jit(lambda p, v, ln, a: jcache.append_token_paged(
        jcfg, jrun, p, v, ln, a, 1), 4)           # compiled once

    def step(act):
        nonlocal jpkv
        vals = bf16_np(rng, (n_slots, w), spread=6)
        # a copy: JAX on the CPU may alias a numpy buffer, and ``lengths``
        # changes in place below while the step may still be running
        jpkv = jstep(jpkv, jnp.asarray(vals), jnp.asarray(lengths.copy()),
                     jnp.asarray(act))
        plan = tcache.plan_append(trun, tpkv, lengths, act)
        tcache.append_token_paged(tcfg, trun, tpkv, 0, to_torch(vals), plan)
        lengths[:] += act.astype(np.int32)

    insert([0, 2], 9)                          # 2 full pages + ring each
    for t in range(7):
        act = active.copy()
        act[2] = act[2] and t % 3 != 1          # an idle step for slot 2
        step(act)
    _assert_pools_equal(jpkv, tpkv)
    mask = np.asarray([True, False, False])
    jpkv = shm(lambda p, m: jcache.release_pages(p, m), jpkv,
               jnp.asarray(mask))
    tcache.release_pages(tpkv, mask)
    lengths[mask], active[mask] = 0, False
    insert([1, 0], 6)                          # reuses the freed pages
    for _ in range(5):
        step(active.copy())
    _assert_pools_equal(jpkv, tpkv)
    assert tpkv.page_used.sum() > 0
