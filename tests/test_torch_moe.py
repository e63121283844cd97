"""The MoE FFN in the port (``repro_torch.models.moe``) against the JAX
package at tp = 1, on the same numpy-seeded inputs and bridged weights:

- ``moe_forward`` at capacity factor 4.0 (no drops) and 1.25 (drops):
  expert ids, keep masks and outputs equal to the reference's, the aux
  loss within f32 rounding; dispatched per sequence (``groups``) it
  equals the reference's B = 1 calls one by one; ties in the router go
  to the lower expert id, as ``jax.lax.top_k``;
- the decode step's MoE against the reference's ``engine._moe_decode``;
- ``pack_serving_params``: expert stacks pack as one leaf at one k, a
  router of 8 columns stays raw, both byte-identical to the reference's;
- serving on the reference tests' ``moe`` model (``tests/
  test_serve_engine.py``: 2 layers, 8 experts top-2, 1 shared, capacity
  factor 4.0) and on a jamba-like parallel hybrid (that file's
  ``hybrid`` case with ``d_ff=0`` and the ``moe`` case's ``MoEConfig``),
  block 4, codec on and off: ``ServeEngine`` streams and admission
  counts equal to the reference's, a disaggregated fleet's streams equal
  to the monolithic engine's (with the reference fleet's byte counters on
  the ``moe`` model), and the fixed loop under the teacher-forced rule of
  ``ROADMAP.md`` section 3, item 2 (and with the reference's expert ids
  forced, every row);
- ``launch.serve`` on deepseek-v2-lite-16b, jamba-tiny-dev and
  granite-moe-1b-a400m (reduced) in its three modes.

Tolerances: MoE outputs within one bf16 rounding step of the reference's;
the aux loss rtol 1e-6 (f32 sums in another order); logits within
5e-3."""

import dataclasses

import jax
import ml_dtypes
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import MeshConfig, ModelConfig as JModel
from repro.configs.base import MoEConfig as JMoE, RunConfig as JRun
from repro.configs.base import SSMConfig as JSSM
from repro.core import collectives as jcl, weights as jweights
from repro.core.collectives import CodecConfig as JCodec
from repro.models import layers as jlayers, lm as jlm, moe as jmoe
from repro.models import params as jparams
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine, engine as jengine
from repro.serve import transport as jtransport
from repro_torch.configs.base import ModelConfig as TModel
from repro_torch.configs.base import MoEConfig as TMoE, RunConfig as TRun
from repro_torch.configs.base import SSMConfig as TSSM
from repro_torch.core import weights as tweights
from repro_torch.core.collectives import CodecConfig as TCodec
from repro_torch.models import blocks as tblocks, lm as tlm, moe as tmoe
from repro_torch.models import params as tparams
from repro_torch.models.params import from_jax_params
from repro_torch.serve import engine as tengine
from repro_torch.serve.disagg import DisaggEngine
from repro_torch.serve.scheduler import Request, ServeEngine
from torch_port_util import bf16_np, bits, to_np, to_torch

torch.set_num_threads(2)

MESH = jax.make_mesh((1, 1), ("data", "model"))
BF16_STEP = 2.0 ** -8
MOE = dict(name="m", family="moe", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=4, d_ff=0, vocab_size=500, head_dim=16)
JAMBA = dict(name="jl", family="hybrid", n_layers=3, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=0, vocab_size=500, head_dim=16,
             parallel_hybrid=True, attn_layout="hymba_3global", window=16,
             sub_quadratic=True)
MOE_KW = dict(n_experts=8, top_k=2, d_ff=32, n_shared=1, capacity_factor=4.0)
SSM_KW = dict(d_state=16, headdim=8, chunk=16)
MAXLEN, SLOTS, BLK = 48, 2, 4


def cfgs(case="moe", **moe_over):
    moe = dict(MOE_KW, **moe_over)
    if case == "jamba":
        return (JModel(ssm=JSSM(**SSM_KW), moe=JMoE(**moe), **JAMBA),
                TModel(ssm=TSSM(**SSM_KW), moe=TMoE(**moe), **JAMBA))
    return JModel(moe=JMoE(**moe), **MOE), TModel(moe=TMoE(**moe), **MOE)


def close_bf16(got, want):
    np.testing.assert_allclose(np.asarray(to_np(got), np.float32),
                               np.asarray(want, np.float32),
                               rtol=BF16_STEP, atol=1e-6)


def moe_params(jcfg, seed=1, layer=0):
    """One layer's ``moe`` subtree of the reference's seeded init, as JAX
    arrays and bridged."""
    jrun = JRun(codec=JCodec(cache_block=BLK))
    table = jlm.lm_table(jcfg, MeshConfig(data=1, model=1, pod=1), jrun)
    params = jax.device_get(jparams.init_params(table, jax.random.key(seed)))
    p = jax.tree_util.tree_map(lambda a: a[layer], params["blocks"]["moe"])
    return jax.tree_util.tree_map(jnp.asarray, p), from_jax_params(p)


def _ref_routing(jcfg, pj, x):
    """The reference's routing and capacity dispatch of ``x`` (n, D) as
    ``moe_forward`` computes them: (experts (n, k), keep (n*k,))."""
    e = jcfg.moe

    def route(xt):
        probs = jax.nn.softmax(jlayers.matmul_f32(xt, pj["router"]), -1)
        experts = jax.lax.top_k(probs, e.top_k)[1]
        flat_e = experts.reshape(-1)
        onehot = jax.nn.one_hot(flat_e, e.n_experts, dtype=jnp.int32)
        slot = (jnp.cumsum(onehot, axis=0) - 1)[
            jnp.arange(flat_e.shape[0]), flat_e]
        return experts, slot < jmoe._capacity(xt.shape[0], jcfg)

    return jax.jit(route)(jnp.asarray(x))


@pytest.mark.parametrize("cf", [4.0, 1.25])
def test_moe_forward_matches_reference(cf):
    jcfg, tcfg = cfgs(capacity_factor=cf)
    pj, pt = moe_params(jcfg)
    jrun, trun = JRun(), TRun()
    x = bf16_np(np.random.default_rng(2), (3, 16, 64))
    ref_fwd = jax.jit(jcl.shmap(
        lambda xx: jmoe.moe_forward(jcfg, jrun, pj, xx, 1), MESH, (P(),),
        (P(), P())))
    # the whole batch in one dispatch, as the reference's moe_forward
    yj, auxj = ref_fwd(jnp.asarray(x))
    yt, auxt = tmoe.moe_forward(tcfg, trun, pt, to_torch(x))
    close_bf16(yt, yj)
    np.testing.assert_allclose(float(auxt[0]), float(auxj), rtol=1e-6)
    ej, kj = _ref_routing(jcfg, pj, x.reshape(-1, 64))
    _, _, et = tmoe.route(tcfg, pt, to_torch(x).reshape(1, -1, 64))
    cap = tmoe._capacity(48, tcfg)
    _, _, kt = tmoe.dispatch(tcfg, et, cap)
    assert (et[0].numpy() == np.asarray(ej)).all()
    assert (kt[0].numpy() == np.asarray(kj)).all()
    assert bool(kt.all()) == (cf == 4.0)           # 1.25 drops choices
    # each sequence on its own, as the reference's B = 1 admissions
    yg, auxg = tmoe.moe_forward(tcfg, trun, pt, to_torch(x), groups=3)
    for b in range(3):
        yb, auxb = ref_fwd(jnp.asarray(x[b:b + 1]))
        close_bf16(yg[b:b + 1], yb)
        np.testing.assert_allclose(float(auxg[b]), float(auxb), rtol=1e-6)


def test_router_ties_go_to_the_lower_expert():
    jcfg, tcfg = cfgs()
    pj, pt = moe_params(jcfg)
    router = np.asarray(pj["router"]).copy()
    router[:, 5] = router[:, 6] = router[:, 2]      # three equal columns
    pj = dict(pj, router=jnp.asarray(router))
    pt = dict(pt, router=to_torch(router))
    x = bf16_np(np.random.default_rng(3), (40, 64))
    ej, _ = _ref_routing(jcfg, pj, x)
    _, gt, et = tmoe.route(tcfg, pt, to_torch(x))
    assert (et.numpy() == np.asarray(ej)).all()
    assert ((et == 2) | (et == 5)).any()            # the tie was taken


def test_moe_decode_matches_reference():
    jcfg, tcfg = cfgs()
    pj, pt = moe_params(jcfg, layer=1)
    jrun = JRun()
    f = jax.jit(jcl.shmap(
        lambda xx: jengine._moe_decode(jcfg, jrun, pj, xx, 1), MESH, (P(),),
        P()))
    rng = np.random.default_rng(4)
    for _ in range(5):
        x = bf16_np(rng, (4, 1, 64))
        close_bf16(tmoe.moe_decode(tcfg, pt, to_torch(x)), f(jnp.asarray(x)))


def test_pack_moe_leaves():
    """Expert stacks (L, E, D, F) pack as one leaf at one k, one dictionary
    per (layer, expert) slice, and the shared experts pack; the 8-column
    router (N % 32) stays raw, as the reference judges it; the packed MoE
    equals the raw one, prefill and decode.  (The packed bytes of these
    leaves are held against the reference's in test_torch_mla.py.)"""
    model = dict(MOE, d_model=128, n_layers=1)
    jcfg = JModel(moe=JMoE(**dict(MOE_KW, d_ff=64)), **model)
    tcfg = TModel(moe=TMoE(**dict(MOE_KW, d_ff=64)), **model)
    params = tparams.init_params(tlm.lm_table(tcfg),
                                 torch.Generator().manual_seed(3))
    tpk = tweights.pack_serving_params(params)
    tm = tpk["blocks"]["moe"]
    for name in ("w_gate", "w_up", "w_down", "ws_gate", "ws_up", "ws_down"):
        assert isinstance(tm[name], tweights.PackedWeight), name
    assert tm["w_gate"].shape == (1, 8, 128, 64)
    assert tm["w_gate"].dict_syms.shape[:2] == (1, 8)   # one per slice
    assert isinstance(tm["router"], torch.Tensor)
    router = to_np(params["blocks"]["moe"]["router"])
    assert not jweights._leaf_eligible("['blocks']['moe']['router']", router,
                                       None, 1)
    raw = tlm.layer_params(params, 0)["moe"]
    pk = tlm.layer_params(tpk, 0)["moe"]
    x = to_torch(bf16_np(np.random.default_rng(5), (2, 7, 128)))
    assert torch.equal(tmoe.moe_forward(tcfg, TRun(), raw, x)[0],
                       tmoe.moe_forward(tcfg, TRun(), pk, x)[0])
    assert torch.equal(tmoe.moe_decode(tcfg, raw, x[:, :1]),
                       tmoe.moe_decode(tcfg, pk, x[:, :1]))


# ---------------------------------------------------------------------------
# serving: the reference tests' moe model and a jamba-like hybrid
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


def _codecs(codec_on):
    if codec_on:
        return JCodec(cache_block=BLK), TCodec(cache_block=BLK)
    return (dataclasses.replace(JCodec.off(), cache_block=BLK),
            dataclasses.replace(TCodec.off(), cache_block=BLK))


@pytest.fixture(scope="module", params=["moe", "jamba"])
def ref(request):
    """The reference engine (codec on; sharing off by itself for MoE, one
    step per window) and its streams on the mix; the bridged weights.  The
    codec is lossless, so the reference's streams are the same with it
    off (the reference's own tests hold that), and the port runs both."""
    jcfg, tcfg = cfgs(request.param)
    jc, _ = _codecs(True)
    jrun = JRun(codec=jc)
    je = JEngine(jcfg, jrun, tp=1, n_slots=SLOTS, max_len=MAXLEN, seed=1,
                 max_fuse_steps=1)
    res, st = je.run(_mix(JRequest))
    return dict(case=request.param, jcfg=jcfg, tcfg=tcfg, je=je,
                mono=_stream(res), stats=st,
                params=from_jax_params(jax.device_get(je.params)))


@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
def test_streams_identical(ref, codec_on):
    trun = TRun(codec=_codecs(codec_on)[1])
    te = ServeEngine(ref["tcfg"], trun, n_slots=SLOTS, max_len=MAXLEN,
                     params=ref["params"], max_fuse_steps=1, device="cpu")
    assert not te.prefix_sharing
    res, st = te.run(_mix())
    assert _stream(res) == ref["mono"]
    js = ref["stats"]
    assert st.n_admit_dispatches == js.n_admit_dispatches
    assert st.n_replay_dispatches == js.n_replay_dispatches == 0
    assert st.decode_steps == js.decode_steps
    assert not te.state.kv.page_used.any()


def _to_ref_blob(blob):
    """The port's blob as the reference's ``SequenceBlob`` (bf16 leaves as
    ml_dtypes bf16, the same bits)."""
    f = dataclasses.asdict(blob)
    f["kv"] = {k: (v.view(ml_dtypes.bfloat16) if k in ("ring", "raw_pages")
                   else v) for k, v in blob.kv.items()}
    if blob.ssm is not None:
        h, cx, cbc = blob.ssm
        f["ssm"] = (h, cx.view(ml_dtypes.bfloat16),
                    cbc.view(ml_dtypes.bfloat16))
    return jtransport.SequenceBlob(**f)


@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
def test_disagg_matches_monolithic(ref, codec_on):
    """A prefill replica hands off to a decode replica (a jamba-like
    slot's SSM state in the blob's SSM section): the monolithic streams;
    the reference's serializer writes each blob to the port's bytes."""
    dis = DisaggEngine(ref["tcfg"], TRun(codec=_codecs(codec_on)[1]),
                       n_slots=SLOTS,
                       max_len=MAXLEN, params=ref["params"],
                       max_fuse_steps=1, device="cpu")
    blobs = []
    export = dis.prefills[0]._export_blob
    dis.prefills[0]._export_blob = lambda s: blobs.append(export(s)) \
        or blobs[-1]
    res, st = dis.run(_mix())
    assert _stream(res) == ref["mono"]
    assert st.n_transfers == len(blobs) == len(_mix())
    for blob in blobs:
        assert (blob.ssm is not None) == (ref["case"] == "jamba")
        assert _to_ref_blob(blob).to_wire(None)[0] == blob.to_wire(None)[0]


class RouterGaps:
    """Records, per routed row, the relative gap between the k-th and the
    (k+1)-th routing probability (``moe.route`` wrapped)."""

    def __init__(self, monkeypatch):
        self.calls = []
        self.route = route = tmoe.route

        def wrapped(cfg, p, xt):
            probs, gates, experts = route(cfg, p, xt)
            top = torch.sort(probs, -1, descending=True).values
            k = cfg.moe.top_k
            self.calls.append(((top[..., k - 1] - top[..., k])
                               / top[..., k - 1]).reshape(-1))
            return probs, gates, experts

        monkeypatch.setattr(tmoe, "route", wrapped)

    def take(self, n_seqs: int) -> np.ndarray:
        """The smallest gap of each sequence over the calls since the last
        take (a prefill's rows are its sequences' tokens in order)."""
        g = torch.stack([c.reshape(n_seqs, -1).min(-1).values
                         for c in self.calls]).min(0).values
        self.calls.clear()
        return g.numpy()


class RefRouting:
    """The reference's expert ids, one array per routing call in call order
    (one per MoE layer of a prefill or a decode step): ``jax.lax.top_k``
    wrapped, its indices read back through a host callback.  ``force``
    then makes the port's ``moe.route`` take them, call by call, with the
    gates the port's own probabilities give those experts."""

    def __init__(self, monkeypatch):
        self.calls, self.mp = [], monkeypatch
        top_k = jax.lax.top_k

        def wrapped(x, k):
            vals, idx = top_k(x, k)
            jax.debug.callback(lambda i: self.calls.append(np.array(i)), idx)
            return vals, idx

        monkeypatch.setattr(jax.lax, "top_k", wrapped)

    def force(self):
        route, queue = tmoe.route, list(self.calls)

        def forced(cfg, p, xt):
            probs, _, _ = route(cfg, p, xt)
            experts = torch.as_tensor(queue.pop(0)).long().reshape(
                probs.shape[:-1] + (cfg.moe.top_k,))
            gates = probs.gather(-1, experts)
            return probs, gates / gates.sum(-1, keepdim=True).clamp(
                min=1e-9), experts

        self.mp.setattr(tmoe, "route", forced)
        return queue


def test_fixed_loop_matches_reference(ref, monkeypatch):
    """The fixed loop: 3 prompts of 10 tokens (one joint MoE dispatch of
    the 30 tokens, as the reference's ``prefill``), 8 greedy steps, against
    the reference's prefill + decode_step.  Fed the reference's tokens,
    the port's logits are within 5e-3 of the reference's at every step of
    every sequence, under the port's own routing wherever its router met
    no near-tie in that step (ROADMAP.md section 3, item 2: where the k-th
    and (k+1)-th routing probabilities of a layer lie within 1e-3 of each
    other, relative, f32 sums in another order than the reference's can
    pick the other expert), and everywhere with each layer's expert ids
    forced to the reference's.  The port's own stream (``generate``)
    equals the reference's up to the first step whose reference top-2
    margin is within 1e-2."""
    atol = 5e-3
    ref_routes = RefRouting(monkeypatch)
    gaps = RouterGaps(monkeypatch)
    jcfg, tcfg, params = ref["jcfg"], ref["tcfg"], ref["params"]
    jp, dims = ref["je"].params, ref["je"].dims
    jrun, trun = JRun(codec=_codecs(True)[0]), TRun(codec=_codecs(True)[1])

    def shm_jit(f, n):
        return jax.jit(jcl.shmap(f, MESH, tuple(P() for _ in range(n)), P()))

    s, n, max_len = 10, 8, 24
    prefill = shm_jit(lambda p, t: jengine.prefill(jcfg, jrun, p, dims, t,
                                                   max_len, 1), 2)
    step = shm_jit(lambda p, st, tok: jengine.decode_step(
        jcfg, jrun, p, dims, st, tok, 1), 3)
    prompts = np.random.default_rng(3).integers(0, 500, (3, s)) \
        .astype(np.int32)

    def port_loop(toks):
        """The port's logits teacher-forced on ``toks`` (B, n), and where
        its router met a near-tie, both (B, n + 1)."""
        lt, tst = tengine.prefill(tcfg, trun, params,
                                  torch.as_tensor(prompts), max_len)
        out, ties = [lt.numpy()[:, 0, :500]], [gaps.take(3) <= 1e-3]
        for t in range(n):
            lt = tengine.decode_step(tcfg, trun, params, tst,
                                     torch.as_tensor(toks[:, t:t + 1]))
            out.append(lt.numpy()[:, 0, :500])
            ties.append(gaps.take(3) <= 1e-3)
        return np.stack(out, 1), np.stack(ties, 1)

    lg, st = prefill(jp, jnp.asarray(prompts))
    want_lg = [np.asarray(lg)[:, 0, :500]]
    for t in range(n):
        tok = want_lg[-1].argmax(-1).astype(np.int32)[:, None]
        lg, st = step(jp, st, jnp.asarray(tok))
        want_lg.append(np.asarray(lg)[:, 0, :500])
    jax.effects_barrier()
    want_lg = np.stack(want_lg, 1)
    want = want_lg.argmax(-1).astype(np.int32)
    assert len(ref_routes.calls) == (n + 1) * jcfg.n_layers

    got_lg, ties = port_loop(want)
    far = np.abs(got_lg - want_lg).max(-1) > atol                # (B, t)
    assert not (far & ~ties).any(), np.argwhere(far)
    left = ref_routes.force()
    np.testing.assert_allclose(port_loop(want)[0], want_lg, atol=atol)
    assert not left
    monkeypatch.setattr(tmoe, "route", gaps.route)
    got = tengine.generate(tcfg, trun, params,
                           torch.as_tensor(prompts), n, max_len).numpy()
    top2 = np.sort(want_lg, -1)[..., -2:]
    near_tie = top2[..., 1] - top2[..., 0] <= 2 * atol
    for b in range(3):
        diff = np.flatnonzero(got[b] != want[b])
        if len(diff):
            assert near_tie[b, diff[0]], (b, diff[0], got[b], want[b])
    print("rows beyond 5e-3 under the port's routing, at a router "
          "near-tie:", np.argwhere(far).tolist())


def test_block_tables():
    """The MoE tables: attention (∥ SSM for a hybrid) and ``moe``, no
    ``mlp``; the attention-free and enc-dec configs' tables build with
    the reference's keys (the decoder's with its cross attention)."""
    from repro_torch.configs import get_config

    t = tblocks.block_table(get_config("jamba-tiny-dev"))
    assert {"attn", "ssm", "moe"} <= set(t) and "mlp" not in t
    t = tblocks.block_table(get_config("deepseek-v2-lite-16b"))
    assert "moe" in t and "w_dkv" in t["attn"] and "ssm" not in t
    assert "ws_gate" in t["moe"] and "mlp" not in t
    assert get_config("deepseek-v2-lite-16b").param_count() == 16210198528
    assert get_config("jamba-tiny-dev").param_count() == 613023744
    from repro.configs import get_config as jget_config
    from repro.models import blocks as jblocks

    for name, cross in (("mamba2-370m", False),
                        ("seamless-m4t-large-v2", False),
                        ("seamless-m4t-large-v2", True)):
        t = tblocks.block_table(get_config(name), cross=cross)
        jt = jblocks.block_table(jget_config(name), 1, cross=cross)
        assert list(t) == list(jt), (name, cross)
        for key in ("attn", "xattn", "ssm", "mlp"):
            if key in jt:
                assert set(t[key]) == set(jt[key]), (name, key)
    assert set(tblocks.block_table(get_config("mamba2-370m"))) \
        == {"ln1", "ssm"}


@pytest.mark.parametrize("mode", [[], ["--continuous"], ["--disagg"]],
                         ids=["fixed", "continuous", "disagg"])
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "jamba-tiny-dev",
                                  "granite-moe-1b-a400m"])
def test_launcher_serves_moe(arch, mode, capsys):
    """``launch.serve --arch <arch>`` (its reduced variant) in each mode."""
    from repro_torch.launch import serve

    size = (["--batch", "2", "--prompt-len", "12", "--new-tokens", "3"]
            if not mode else ["--requests", "3", "--slots", "2",
                              "--prompt-len", "16", "--new-tokens", "3"])
    assert serve.main(["--arch", arch, "--device", "cpu"] + mode + size) == 0
    assert "sample continuations" in capsys.readouterr().out
