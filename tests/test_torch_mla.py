"""MLA (multi-head latent attention, deepseek-v2) in the port against the
JAX package at tp = 1, on the same numpy-seeded inputs and bridged
weights:

- the model code: ``project_qkv_mla`` (per-head q/k/v and the latent the
  cache stores), ``attn_forward``, the absorbed ``decode_qkv`` and
  ``decode_out``;
- the MLA latent path of both attention kernels' plain twins (the paged
  pool and the fixed-batch store: k the 64-wide latent row, v its first
  48 columns, one "kv head" for all query heads) against the reference's
  oracles (``kernels/ref.py`` with ``mla_lora``) and its ``jax`` decode
  backend, codec on and off, full, windowed and soft-capped;
- ``pack_serving_params`` on a deepseek-like model: the MLA, expert,
  router and shared-expert leaves byte-identical to the reference's;
- serving on the reference tests' ``mla_moe`` model (``tests/
  test_models.py``: 2 layers, lora 32 + rope 8, 8 experts top-2 at
  capacity factor 1.25, block 4), codec on and off: ``ServeEngine``
  streams and admission counts equal to the reference's, a
  disaggregated fleet's streams equal to the monolithic engine's with
  the reference fleet's byte counters, and the fixed loop under the
  teacher-forced rule of ``ROADMAP.md`` section 3, item 2.

Tolerances: attention outputs rtol = atol = 1e-4 (normalised, f32, as the
reference's kernel tests); bf16 results within one rounding step (a sum's
largest summand sets the step where noted); f32 products within 1e-5;
logits within 5e-3."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import MeshConfig, MLAConfig as JMLA
from repro.configs.base import ModelConfig as JModel, MoEConfig as JMoE
from repro.configs.base import RunConfig as JRun
from repro.core import collectives as jcl
from repro.core import fixed as jfixed
from repro.core import weights as jweights
from repro.core.collectives import CodecConfig as JCodec
from repro.kernels import ref as jref
from repro.models import attention as jattn, cache as jcache
from repro.models import layers as jlayers, lm as jlm, params as jparams
from repro.serve import Request as JRequest, ServeEngine as JEngine
from repro.serve import disagg as jdisagg, engine as jengine
from repro_torch.configs.base import MLAConfig as TMLA
from repro_torch.configs.base import ModelConfig as TModel
from repro_torch.configs.base import MoEConfig as TMoE
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.core import fixed as tfixed, weights as tweights
from repro_torch.core.collectives import CodecConfig as TCodec
from repro_torch.kernels import ops, ref as tref
from repro_torch.models import attention as tattn, cache as tcache
from repro_torch.models import layers as tlayers, lm as tlm, moe as tmoe
from repro_torch.models import params as tparams
from repro_torch.models.params import from_jax_params
from repro_torch.serve import engine as tengine
from repro_torch.serve.disagg import DisaggEngine
from repro_torch.serve.scheduler import Request, ServeEngine
from torch_port_util import bf16_np, bits, to_np, to_torch

torch.set_num_threads(2)

MESH = jax.make_mesh((1, 1), ("data", "model"))
BF16_STEP = 2.0 ** -8
MLA_MOE = dict(name="dv", family="moe", n_layers=2, d_model=64, n_heads=4,
               n_kv_heads=4, d_ff=0, vocab_size=500, head_dim=16)
MLA_KW = dict(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_dim=16)
MOE_KW = dict(n_experts=8, top_k=2, d_ff=32)
MAXLEN, SLOTS, BLK = 48, 2, 4
BYTE_COUNTERS = ("n_transfers", "wire_bytes", "wire_raw_bytes",
                 "dedup_page_refs")


def cfgs(model=MLA_MOE, mla=MLA_KW, moe=MOE_KW):
    return (JModel(mla=JMLA(**mla), moe=JMoE(**moe), **model),
            TModel(mla=TMLA(**mla), moe=TMoE(**moe), **model))


def shm(f, *args):
    return jax.jit(jcl.shmap(f, MESH, tuple(P() for _ in args), P()))(*args)


def close_bf16(got, want, steps=None):
    """Within one bf16 rounding step; ``steps`` of the largest magnitude
    where a rounded sum's scale is set by its largest summand."""
    want = np.asarray(want, np.float32)
    atol = steps * BF16_STEP * float(np.abs(want).max()) if steps else 1e-6
    np.testing.assert_allclose(np.asarray(to_np(got), np.float32), want,
                               rtol=BF16_STEP, atol=atol)


def ref_params(jcfg, jrun, seed):
    table = jlm.lm_table(jcfg, MeshConfig(data=1, model=1, pod=1), jrun)
    return jax.device_get(jparams.init_params(table, jax.random.key(seed))), \
        table


def _codecs(codec_on, blk=BLK):
    if codec_on:
        return JCodec(cache_block=blk), TCodec(cache_block=blk)
    return (dataclasses.replace(JCodec.off(), cache_block=blk),
            dataclasses.replace(TCodec.off(), cache_block=blk))


# ---------------------------------------------------------------------------
# the model code
# ---------------------------------------------------------------------------

def test_mla_projections_and_decode():
    jcfg, tcfg = cfgs()
    jrun = JRun(codec=JCodec(cache_block=BLK))
    trun = TRun(codec=TCodec(cache_block=BLK))
    params, _ = ref_params(jcfg, jrun, 1)
    pj = jax.tree_util.tree_map(lambda a: jnp.asarray(a[1]),
                                params["blocks"]["attn"])
    pt = tlm.layer_params(from_jax_params(params), 1)["attn"]
    assert sorted(pt) == sorted(pj) == ["kv_norm", "w_dkv", "w_uk", "w_uv",
                                        "wo", "wq"]
    rng = np.random.default_rng(3)
    x = bf16_np(rng, (2, 12, 64))
    pos = np.arange(12, dtype=np.int32)

    qj, lj = shm(lambda xx, pp: jattn.project_qkv_mla(jcfg, pj, xx, pp, 1),
                 jnp.asarray(x), jnp.asarray(pos))
    qt, lt = tattn.project_qkv_mla(tcfg, pt, to_torch(x),
                                   torch.as_tensor(pos))
    for got, want in ((qt.q, qj.q), (qt.k, qj.k), (qt.v, qj.v), (lt, lj)):
        assert tuple(got.shape) == want.shape
        close_bf16(got, want)
    assert lt.shape == (2, 12, tcache.kv_width(tcfg)) == (2, 12, 40)

    spec = jattn.base_attn_spec(jcfg)
    oj, cj = shm(lambda xx, pp: jattn.attn_forward(
        jcfg, jrun, pj, xx, pp, spec, 1, want_cache=True),
        jnp.asarray(x), jnp.asarray(pos))
    ot, ct = tattn.attn_forward(tcfg, trun, pt, to_torch(x),
                                torch.as_tensor(pos),
                                tattn.base_attn_spec(tcfg), want_cache=True)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5,
                               atol=1e-5)
    close_bf16(ct, cj)

    h = bf16_np(rng, (3, 1, 64))
    lens = np.asarray([5, 9, 17], np.int32)
    (dqj, nvj) = shm(lambda hh, ll: jattn.decode_qkv(jcfg, pj, hh, ll, 1),
                     jnp.asarray(h), jnp.asarray(lens))
    dqt, nvt = tattn.decode_qkv(tcfg, pt, to_torch(h), torch.as_tensor(lens))
    assert tuple(dqt.shape) == dqj.shape == (3, 4, 1, 40)
    close_bf16(dqt, dqj)
    close_bf16(nvt, nvj)
    merged = bf16_np(rng, (3, 4, 1, 32))
    doj = shm(lambda mm: jattn.decode_out(jcfg, pj, mm, 1),
              jnp.asarray(merged))
    dot = tattn.decode_out(tcfg, pt, to_torch(merged))
    np.testing.assert_allclose(dot.numpy(), np.asarray(doj), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the MLA latent path of both attention kernels' plain twins
# ---------------------------------------------------------------------------

LORA, ROPE, H, KB = 48, 16, 4, 5
W = LORA + ROPE                      # a multiple of 32, as the kernels need
KBLK, N_S, MAXP, N_PAGES = 8, 3, 3, 9
SCALE = (16 + ROPE) ** -0.5
CASES = {"full": (None, None), "windowed": (9, None), "softcap": (None, 30.0)}


def _kernel_cfgs(codec_on):
    kw = dict(name="k", family="moe", n_layers=1, d_model=64, n_heads=H,
              n_kv_heads=H, d_ff=0, vocab_size=64, head_dim=16)
    jcfg, tcfg = cfgs(kw, dict(kv_lora_rank=LORA, qk_nope_dim=16,
                               qk_rope_dim=ROPE, v_dim=16))
    jc, tc = _codecs(codec_on, KBLK)
    return jcfg, JRun(codec=jc), tcfg, TRun(codec=tc)


def _latent_pages(rng, shape):
    """Latent rows with escapes: a page (or block) whose exponents spread
    past the dictionary overflows the side channel."""
    pages = bf16_np(rng, shape, 0.5)
    pages[0] = bf16_np(rng, shape[1:], 0.5, spread=30)
    return pages


def _seen(vals, k=KB):
    """What the codec stores, decoded (overflow decodes lossy)."""
    return np.asarray(jax.vmap(lambda v: jfixed.decompress(
        jfixed.compress(v, k=k)))(jnp.asarray(vals)))


@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_paged_mla_plain_matches_reference(codec_on, case):
    window, softcap = CASES[case]
    jcfg, jrun, tcfg, trun = _kernel_cfgs(codec_on)
    rng = np.random.default_rng(11)
    pages = _latent_pages(rng, (N_PAGES, KBLK, W))
    ring = bf16_np(rng, (N_S, KBLK, W), 0.5)
    pt = rng.integers(0, N_PAGES, (N_S, MAXP)).astype(np.int32)
    pt[0, 1] = 0
    pt[1, 1:] = -1
    lengths = np.asarray([2 * KBLK + 3, 2, MAXP * KBLK], np.int32)
    q = bf16_np(rng, (N_S, H, W))
    win = tref.WINDOW_NONE if window is None else window
    if codec_on:
        cts = jax.vmap(lambda v: jfixed.compress(v, k=KB))(
            jnp.asarray(pages))
        assert int(cts.n_escapes[0]) > cts.esc_pos.shape[-1]   # overflow
        jf = dict(signman=cts.signman, planes=cts.planes,
                  dict_syms=cts.dict_syms, esc_pos=cts.esc_pos,
                  esc_raw=cts.esc_raw, raw_pages=None)
        seen = _seen(pages)
    else:
        jf = dict(signman=None, planes=None, dict_syms=None, esc_pos=None,
                  esc_raw=None, raw_pages=jnp.asarray(pages))
        seen = pages
    tpkv = tcache.PagedKV(
        page_table=pt.copy(), page_used=np.zeros((N_PAGES,), bool),
        ring=to_torch(ring)[None],
        **{k: None if v is None else to_torch(np.asarray(v))[None]
           for k, v in jf.items()})
    args = (to_torch(q), *tpkv.layer_fields(0), tpkv.ring[0],
            tpkv.page_ids(), torch.as_tensor(lengths), win)
    kw = dict(k=KB, kv_idx=(), scale=SCALE, softcap=softcap, mla_lora=LORA)
    out, m, l = tref.paged_decode_attend_plain(*args, **kw)
    assert tuple(out.shape) == (N_S, H, LORA)
    got = (out / l.clamp(min=1e-30)[..., None]).numpy()
    want = np.asarray(jref.paged_decode_attend_ref(
        jnp.asarray(q), jnp.asarray(seen), jnp.asarray(pt),
        jnp.asarray(lengths), jnp.asarray(ring), kv_idx=(), scale=SCALE,
        softcap=softcap, mla_lora=LORA, window=win, tp=1, ti=0))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    o2, m2, l2 = ops.decode_attend_paged(*args, **kw)
    assert torch.equal(o2, out) and torch.equal(m2, m) and torch.equal(l2, l)

    # the reference's jax decode backend (its scan body in f32, then its
    # bf16 merge) on the same pool
    jpkv = jcache.PagedKV(page_table=jnp.asarray(pt),
                          page_used=jnp.zeros((N_PAGES,), bool),
                          ring=jnp.asarray(ring), **jf)
    spec_kw = dict(windowed=window is not None, softcap=softcap,
                   scale=SCALE)
    jspec, tspec = jlayers.AttnSpec(**spec_kw), tlayers.AttnSpec(**spec_kw)
    lens, q4 = jnp.asarray(lengths), jnp.asarray(q)[:, :, None]
    load = lambda i: jcache.load_pages(jpkv, jpkv.page_table[:, i], KBLK, W,
                                       jrun.codec)
    valid = lambda i: jcache.stream_mask(lens, i, KBLK, 1, 0, win,
                                         ring=False)
    ring_ok = jcache.stream_mask(lens, 0, KBLK, 1, 0, win, ring=True)
    o, _, lj = jcache._attend_scan_jax(jcfg, q4, jspec, H, load, MAXP, valid,
                                       jpkv.ring, ring_ok)
    np.testing.assert_allclose(
        got, np.asarray(o / jnp.maximum(lj, 1e-30)[..., None])[:, :, 0],
        rtol=1e-4, atol=1e-4)
    jout = jax.jit(jcl.shmap(
        lambda qq: jcache.attend_paged(jcfg, jrun, jpkv, qq, lens, jspec, 1,
                                       window=window),
        MESH, (P(),), P()))(q4)
    tout = tcache.attend_paged(tcfg, trun, tpkv, 0, to_torch(q4),
                               torch.as_tensor(lengths), tspec, window=window)
    assert tuple(tout.shape) == jout.shape == (N_S, H, 1, LORA)
    np.testing.assert_allclose(to_np(tout).astype(np.float32),
                               np.asarray(jout).astype(np.float32),
                               rtol=BF16_STEP, atol=1e-4)


NBLK, B = 4, 3
LENGTH = 2 * KBLK + 5          # two full blocks, 5 ring rows; blocks 2-3 dead


@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fixed_mla_plain_matches_reference(codec_on, case):
    window, softcap = CASES[case]
    jcfg, jrun, tcfg, trun = _kernel_cfgs(codec_on)
    rng = np.random.default_rng(12)
    blocks = bf16_np(rng, (NBLK, B, KBLK, W), 0.5)
    blocks[1, 2] = bf16_np(rng, (KBLK, W), 0.5, spread=30)  # sequence 2
    ring = bf16_np(rng, (B, KBLK, W), 0.5)
    q = bf16_np(rng, (B, H, W))
    win = tref.WINDOW_NONE if window is None else window
    max_len = (NBLK - 2) * KBLK                 # n_blocks = NBLK
    jkv = jcache.empty_kv(jcfg, jrun, B, max_len, 1)
    tkv = tcache.empty_kv(tcfg, trun, B, max_len, group=B)
    for i in range(NBLK):
        jkv = jcache.store_block(jkv, i, jnp.asarray(blocks[i]), jrun.codec)
        tcache.store_block(tkv, i, to_torch(blocks[i]), trun.codec)
    jkv = jkv._replace(ring=jnp.asarray(ring),
                       length=jnp.asarray(LENGTH, jnp.int32))
    tkv.ring.copy_(to_torch(ring))
    for f in ("signman", "planes", "dict_syms", "esc_pos", "esc_raw",
              "raw_blocks"):
        a, b = getattr(jkv, f), getattr(tkv, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert (bits(np.asarray(a)) == bits(b[0])).all(), f
    seen = _seen(blocks) if codec_on else blocks
    fields = tuple(None if f is None else f[0] for f in
                   (tkv.signman, tkv.planes, tkv.dict_syms, tkv.esc_pos,
                    tkv.esc_raw, tkv.raw_blocks))
    args = (to_torch(q), *fields, tkv.ring, LENGTH, win)
    kw = dict(k=KB, kv_idx=(), scale=SCALE, softcap=softcap, mla_lora=LORA)
    out, m, l = tref.decode_attend_plain(*args, **kw)
    assert tuple(out.shape) == (B, H, LORA)
    got = (out / l.clamp(min=1e-30)[..., None]).numpy()
    want = np.asarray(jref.decode_attend_ref(
        jnp.asarray(q), jnp.asarray(seen), jnp.asarray(ring), LENGTH,
        kv_idx=(), scale=SCALE, softcap=softcap, mla_lora=LORA, window=win,
        tp=1, ti=0))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        tref.decode_attend_ref(to_torch(q), to_torch(seen), to_torch(ring),
                               LENGTH, kv_idx=(), scale=SCALE,
                               softcap=softcap, window=win,
                               mla_lora=LORA).numpy(),
        want, rtol=1e-4, atol=1e-4)
    o2, m2, l2 = ops.decode_attend(*args, **kw)
    assert torch.equal(o2, out) and torch.equal(m2, m) and torch.equal(l2, l)
    # the split of the stream into spans merges to the same partials
    vals, ok = tref.fixed_store_stream(*fields, tkv.ring, LENGTH, win, k=KB)
    (so, sm, sl), _ = tref.split_partials_plain(
        to_torch(q), vals, ok, 4, kv_idx=(), scale=SCALE, softcap=softcap,
        mla_lora=LORA)
    np.testing.assert_allclose((so / sl[..., None]).numpy(), got, rtol=1e-5,
                               atol=1e-5)

    spec_kw = dict(windowed=window is not None, softcap=softcap,
                   scale=SCALE)
    jspec, tspec = jlayers.AttnSpec(**spec_kw), tlayers.AttnSpec(**spec_kw)
    q4 = jnp.asarray(q)[:, :, None]
    jout = jax.jit(jcl.shmap(lambda qq: jcache.attend_cache(
        jcfg, jrun, jkv, qq, jspec, 1, window=window),
        MESH, (P(),), P()))(q4)
    tout = tcache.attend_cache(tcfg, trun, tkv, to_torch(q4), LENGTH, tspec,
                               window=window)
    assert tuple(tout.shape) == jout.shape == (B, H, 1, LORA)
    np.testing.assert_allclose(to_np(tout).astype(np.float32),
                               np.asarray(jout).astype(np.float32),
                               rtol=BF16_STEP, atol=1e-4)


# ---------------------------------------------------------------------------
# the packed serving store
# ---------------------------------------------------------------------------

def test_pack_mla_moe_leaves_byte_identical():
    """A deepseek-like model wide enough that every MLA, expert, router
    and shared-expert leaf packs: the port's store equals the reference's
    leaf for leaf (bytes and k); the stacked ``kv_norm`` stays raw; a
    decode layer's attention and MoE on the packed store equal the raw
    ones (expert stacks, ``w_uk`` and ``w_uv`` decoded exactly through
    ``raw_weight``).  The reference packs slice by slice on the host, so
    it gets the leaves of one layer, one stack of each shape (the widths
    are chosen so that most leaves share a shape)."""
    model = dict(MLA_MOE, d_model=128, n_heads=2, n_kv_heads=2,
                 n_layers=1)
    _, tcfg = cfgs(model, dict(kv_lora_rank=96, qk_nope_dim=32,
                               qk_rope_dim=32, v_dim=32),
                   dict(n_experts=32, top_k=2, d_ff=32, n_shared=1))
    raw_tree = tparams.init_params(tlm.lm_table(tcfg),
                                   torch.Generator().manual_seed(2))
    tpk = tweights.pack_serving_params(raw_tree)
    names = {"attn": ("wq", "w_dkv", "w_uk", "w_uv", "wo"),
             "moe": ("router", "w_gate", "ws_gate")}
    sub = {"blocks": {k: {n: to_np(raw_tree["blocks"][k][n]) for n in v}
                      for k, v in names.items()}}
    jpk, _ = jweights.pack_serving_params(
        sub, jax.tree_util.tree_map(lambda _: P(), sub), tp=1)
    for k, v in names.items():
        for name in v:
            j, t = jpk["blocks"][k][name], tpk["blocks"][k][name]
            assert isinstance(t, tweights.PackedWeight), name
            assert t.k == j.k and t.shape == j.signman.shape, name
            assert (bits(t.signman) == bits(j.signman)).all(), name
            assert (bits(t.planes) == bits(
                np.asarray(j.planes).view(np.int32))).all(), name
            assert (bits(t.dict_syms) == bits(j.dict_syms)).all(), name
    tb = tpk["blocks"]
    assert tb["moe"]["w_gate"].shape == (1, 32, 128, 32)
    for name in ("w_up", "w_down", "ws_up", "ws_down"):
        assert isinstance(tb["moe"][name], tweights.PackedWeight), name
    assert isinstance(tb["attn"]["kv_norm"], torch.Tensor)

    raw = tlm.layer_params(raw_tree, 0)
    pk = tlm.layer_params(tpk, 0)
    rng = np.random.default_rng(4)
    h = to_torch(bf16_np(rng, (3, 1, 128)))
    pos = torch.as_tensor([3, 8, 21])
    got = [tattn.decode_qkv(tcfg, p["attn"], h, pos) for p in (raw, pk)]
    for a, b in zip(*got):
        assert torch.equal(a, b)
    merged = to_torch(bf16_np(rng, (3, 2, 1, 96)))
    assert torch.equal(tattn.decode_out(tcfg, raw["attn"], merged),
                       tattn.decode_out(tcfg, pk["attn"], merged))
    assert torch.equal(tmoe.moe_decode(tcfg, raw["moe"], h),
                       tmoe.moe_decode(tcfg, pk["moe"], h))


# ---------------------------------------------------------------------------
# serving on the reference tests' mla_moe model
# ---------------------------------------------------------------------------

def _mix(cls=Request):
    """The reference serve test's request shapes (``tests/
    test_serve_engine.py:_requests``): mixed lengths, more requests than
    slots."""
    rng = np.random.default_rng(0)
    specs = [(8, 5), (16, 3), (8, 6), (12, 4)]
    return [cls(uid=i, prompt=rng.integers(0, 500, (s,)).astype(np.int32),
                max_new_tokens=n) for i, (s, n) in enumerate(specs)]


def _stream(results):
    return [(r.tokens, r.stop_reason) for r in results]


@pytest.fixture(scope="module")
def ref():
    """The reference engine (codec on; sharing off by itself for MLA, one
    step per window) and its streams on the mix; the bridged weights.  The
    codec is lossless, so the reference's streams are the same with it
    off (the reference's own tests hold that), and the port runs both."""
    jcfg, tcfg = cfgs()
    jc, tc = _codecs(True)
    jrun, trun = JRun(codec=jc), TRun(codec=tc)
    je = JEngine(jcfg, jrun, tp=1, n_slots=SLOTS, max_len=MAXLEN, seed=1,
                 max_fuse_steps=1)
    res, st = je.run(_mix(JRequest))
    return dict(jcfg=jcfg, tcfg=tcfg, jrun=jrun, trun=trun, je=je,
                params=from_jax_params(jax.device_get(je.params)),
                mono=_stream(res), stats=st)


@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
def test_streams_identical(ref, codec_on):
    te = ServeEngine(ref["tcfg"], TRun(codec=_codecs(codec_on)[1]),
                     n_slots=SLOTS, max_len=MAXLEN, params=ref["params"],
                     max_fuse_steps=1, device="cpu")
    assert not te.prefix_sharing
    res, st = te.run(_mix())
    assert _stream(res) == ref["mono"]
    js = ref["stats"]
    assert st.n_admit_dispatches == js.n_admit_dispatches
    assert st.n_replay_dispatches == js.n_replay_dispatches == 0
    assert st.decode_steps == js.decode_steps
    assert not te.state.kv.page_used.any()
    assert te.state.kv.ring.shape[-1] == 40            # lora + rope


@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
def test_disagg_matches_monolithic(ref, codec_on):
    """A prefill replica hands off latent pages to a decode replica: the
    monolithic streams.  With the codec on, the reference's prefill replica
    (its engine) then hands off through the port's transport to a port
    decode replica: the same streams, and its blobs put the same bytes on
    the wire (the ``DisaggStats`` byte counters)."""
    dis = DisaggEngine(ref["tcfg"], TRun(codec=_codecs(codec_on)[1]),
                       n_slots=SLOTS, max_len=MAXLEN, params=ref["params"],
                       max_fuse_steps=1, device="cpu")
    res, st = dis.run(_mix())
    assert _stream(res) == ref["mono"]
    assert st.n_transfers == len(_mix())
    if not codec_on:
        return
    cross = DisaggEngine(ref["tcfg"], ref["trun"], n_slots=SLOTS,
                         max_len=MAXLEN, params=ref["params"],
                         max_fuse_steps=1, device="cpu")
    cross.prefills = [jdisagg.PrefillReplica(
        ref["je"], transport=cross.transport,
        pick_dst=cross.prefills[0].pick_dst)]
    jres, jst = cross.run(_mix(JRequest))
    assert _stream(jres) == ref["mono"]
    for f in BYTE_COUNTERS:
        assert getattr(st, f) == getattr(jst, f), f


def test_fixed_loop_matches_reference(ref):
    """The fixed loop: 3 prompts of 10 tokens (one joint MoE dispatch of
    30 tokens at capacity factor 1.25, so some choices drop), 8 greedy
    steps, against the reference's prefill + decode_step.  Fed the
    reference's tokens, the port's logits are within 5e-3 at every step;
    the port's own stream (``generate``) equals the reference's up to the
    first step whose reference top-2 margin is within 1e-2 (``ROADMAP.md``
    section 3, item 2)."""
    atol = 5e-3
    jcfg, tcfg, jrun, trun = ref["jcfg"], ref["tcfg"], ref["jrun"], \
        ref["trun"]
    jp, dims = ref["je"].params, ref["je"].dims

    def shm_jit(f, n):
        return jax.jit(jcl.shmap(f, MESH, tuple(P() for _ in range(n)), P()))

    s, n, max_len = 10, 8, 24
    prefill = shm_jit(lambda p, t: jengine.prefill(jcfg, jrun, p, dims, t,
                                                   max_len, 1), 2)
    step = shm_jit(lambda p, st, tok: jengine.decode_step(
        jcfg, jrun, p, dims, st, tok, 1), 3)
    prompts = np.random.default_rng(3).integers(0, 500, (3, s)) \
        .astype(np.int32)
    lg, st = prefill(jp, jnp.asarray(prompts))
    lt, tst = tengine.prefill(tcfg, trun, ref["params"],
                              torch.as_tensor(prompts), max_len)
    want, got_lg, want_lg = [], [], []
    for t in range(n + 1):
        want_lg.append(np.asarray(lg)[:, 0, :500])
        got_lg.append(lt.numpy()[:, 0, :500])
        want.append(want_lg[-1].argmax(-1).astype(np.int32))
        if t == n:
            break
        tok = want[-1][:, None]
        lg, st = step(jp, st, jnp.asarray(tok))
        lt = tengine.decode_step(tcfg, trun, ref["params"], tst,
                                 torch.as_tensor(tok))
    want, want_lg = np.stack(want, 1), np.stack(want_lg, 1)
    np.testing.assert_allclose(np.stack(got_lg, 1), want_lg, atol=atol)
    got = tengine.generate(tcfg, trun, ref["params"],
                           torch.as_tensor(prompts), n, max_len).numpy()
    top2 = np.sort(want_lg, -1)[..., -2:]
    near_tie = top2[..., 1] - top2[..., 0] <= 2 * atol
    for b in range(3):
        diff = np.flatnonzero(got[b] != want[b])
        if len(diff):
            assert near_tie[b, diff[0]], (b, diff[0], got[b], want[b])
