"""Expert-parallel MoE at tp = 2: the port on two spawned gloo ranks
(``launch.mesh.spawn`` running ``launch.tp_jobs``, which imports no JAX)
against the reference on two of conftest's fake devices, with the
reference's weights (the whole tree, cut to each rank's shard by
``models.params.shard_params``), on the reference tests' ``moe`` model
(``tests/test_models.py``: 2 layers, 8 experts top-2, one shared expert,
capacity factor 1.25) and a jamba-like parallel hybrid MoE (3 layers,
attention ∥ Mamba2, hymba_3global windows, 8 experts top-2 of d_ff 64,
so that their stacks pack, and no shared one), block 4:

* ``moe_forward`` on each rank's sequence shard against the reference's
  shard outputs under ``shmap`` (the whole local batch in one dispatch,
  and each sequence on its own as the reference's vmapped admissions);
  the bytes each rank puts on the wire in the dispatch and the return
  all-to-alls are the reference's ``fixed.compress`` of each
  destination's slice of its dispatch and return buffers; ``moe_decode``
  on replicated tokens;
* ``ServeEngine(tp=2)``, codec on and off, on a mix with odd prompt
  lengths (their one-token tails replay through decode steps): both
  ranks' streams alike, admission and replay dispatches equal to the
  reference's ``ServeEngine(tp=2)``, the streams and stop reasons too,
  except that a request may part at a near-tie of the reference's own
  logits (``torch_tp_ref.part_at_near_ties``: at most one request of the
  mix); the port's paged path teacher-forced (trunk, the tail replayed,
  the stream) within 5e-3 of the reference's logits up to each parting
  position and over a replayed request's whole stream;
* packed weights (the jamba-like model): each rank's packed expert
  stacks and SSM leaves the reference's ``pack_serving_params(...,
  tp=2)`` shards byte for byte, and the packed streams equal the raw;
* the fixed loop (the ``moe`` model): teacher-forced logits within 5e-3,
  as ``test_torch_fixed.py`` holds tp = 1;
* ``launch.serve --arch jamba-tiny-dev --tp 2 --dist-backend gloo
  --device cpu`` (reduced) in both modes: rank 0 prints tp = 2's own
  continuations.

Tolerances: MoE outputs within one bf16 rounding step of the
reference's; logits within 5e-3."""

import dataclasses
import os
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import MeshConfig, ModelConfig as JModel
from repro.configs.base import MoEConfig as JMoE, RunConfig as JRun
from repro.configs.base import SSMConfig as JSSM
from repro.core import collectives as jcl, fixed as jfixed
from repro.core import weights as jweights
from repro.core.collectives import CodecConfig as JCodec
from repro.models import lm as jlm, moe as jmoe, params as JPM
from repro.serve import Request as JRequest, ServeEngine as JEngine
from repro.serve import engine as jengine
from repro_torch.configs.base import ModelConfig as TModel
from repro_torch.configs.base import MoEConfig as TMoE, RunConfig as TRun
from repro_torch.configs.base import SSMConfig as TSSM
from repro_torch.core.collectives import CodecConfig as TCodec
from repro_torch.launch import mesh, tp_jobs
from repro_torch.models import lm as tlm, params as tparams
from torch_port_util import bf16_np
from torch_tp_ref import (first_replay, pair, part_at_near_ties, ref_fixed,
                          ref_forced, tree_np)

torch.set_num_threads(2)

TP, MAXLEN, SLOTS, BLK = 2, 48, 2, 4
BF16_STEP = 2.0 ** -8
ROOT = Path(__file__).resolve().parents[1]
MOE = dict(name="m", family="moe", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=4, d_ff=0, vocab_size=500, head_dim=16)
JAMBA = dict(name="jl", family="hybrid", n_layers=3, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=0, vocab_size=500, head_dim=16,
             parallel_hybrid=True, attn_layout="hymba_3global", window=16,
             sub_quadratic=True)
SSM_KW = dict(d_state=16, headdim=8, chunk=16)
MODELS = ("moe", "jamba")


def cfgs(name):
    if name == "jamba":        # experts of 64 x 64: the stacks pack
        moe = dict(n_experts=8, top_k=2, d_ff=64)
        return (JModel(ssm=JSSM(**SSM_KW), moe=JMoE(**moe), **JAMBA),
                TModel(ssm=TSSM(**SSM_KW), moe=TMoE(**moe), **JAMBA))
    moe = dict(n_experts=8, top_k=2, d_ff=32, n_shared=1)
    return JModel(moe=JMoE(**moe), **MOE), TModel(moe=TMoE(**moe), **MOE)


def _runs(codec_on):
    jc = JCodec(cache_block=BLK) if codec_on else dataclasses.replace(
        JCodec.off(), cache_block=BLK)
    tc = TCodec(cache_block=BLK) if codec_on else dataclasses.replace(
        TCodec.off(), cache_block=BLK)
    return JRun(codec=jc), TRun(codec=tc)


def _tree(tcfg, seed):
    """Seeded weights of the tp = 2 table (numpy, the port's init)."""
    gen = torch.Generator().manual_seed(seed)
    return tree_np(tparams.init_params(tlm.lm_table(tcfg, TP), gen))


def _mix():
    """Odd lengths (13, 9: a one-token tail replays at tp = 2), two trunk
    lengths, a repeat, more requests than slots."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 500, (8,)).astype(np.int32)
    specs = [(a, 5), (rng.integers(0, 500, (13,)), 4),
             (rng.integers(0, 500, (9,)), 6), (a, 3)]
    return [dict(uid=i, prompt=np.asarray(p, np.int32).copy(),
                 max_new_tokens=n) for i, (p, n) in enumerate(specs)]


def _ref_layer(jcfg, jrun, p, x, xd):
    """The reference's MoE layer at tp = 2 under shmap, x (tp, B, S, D)
    rank r's sequence shard x[r]: (moe_forward's output, its dispatch and
    return buffers (E, cap, D), each sequence's output dispatched on its
    own, ``_moe_decode`` on the replicated xd), per rank."""
    mesh_ = jax.make_mesh((TP,), ("model",))
    specs = JPM.param_pspecs(jmoe.moe_table(jcfg, TP))
    seen = []

    def spy(buf, axis, codec, split, concat):
        seen.append(buf)
        return jcl.lexi_all_to_all(buf, axis, codec, split, concat)

    def body(pp, xx, xd_):
        seen.clear()
        y, _ = jmoe.moe_forward(jcfg, jrun, pp, xx[0], TP)
        bufs = list(seen)
        ys = jax.vmap(lambda xb: jmoe.moe_forward(
            jcfg, jrun, pp, xb[None], TP)[0][0])(xx[0])
        yd = jengine._moe_decode(jcfg, jrun, pp, xd_, TP)
        return tuple(a[None] for a in (y, bufs[0], bufs[1], ys, yd))

    f = jax.jit(jcl.shmap(body, mesh_, (specs, P("model"), P()),
                          P("model")))
    saved = jmoe.cl
    jmoe.cl = types.SimpleNamespace(lexi_all_to_all=spy)
    try:
        out = f(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
                jnp.asarray(xd))
    finally:
        jmoe.cl = saved
    return [np.asarray(a) for a in out]


def _launch(*args):
    """The launcher in a subprocess (a spawning main must be a module)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--device", "cpu", *args], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    return out.returncode, out.stdout, out.stderr


LAUNCH = {"fixed": ["--batch", "2", "--prompt-len", "12", "--new-tokens",
                    "3"],
          "continuous": ["--continuous", "--requests", "3", "--slots", "2",
                         "--prompt-len", "16", "--new-tokens", "3"]}


@pytest.fixture(scope="module")
def served():
    """The reference's layer and fixed loop, then every port job on one
    spawn of two ranks and the launcher's two runs, in threads while the
    reference serves and packs."""
    ref, calls = {}, []
    jrun, trun = _runs(True)
    for seed, name in enumerate(MODELS):
        jcfg, tcfg = cfgs(name)
        params = _tree(tcfg, seed + 1)
        ref[name] = dict(params=params)
        for codec_on in (True, False):
            calls.append(("serve", (tcfg, _runs(codec_on)[1], _mix(), dict(
                params=params, forced=True,
                engine=dict(n_slots=SLOTS, max_len=MAXLEN,
                            max_fuse_steps=1)))))
    # packed weights, the jamba-like model
    jcfg, tcfg = cfgs("jamba")
    calls.append(("serve", (tcfg, trun, _mix(), dict(
        params=ref["jamba"]["params"], packed_leaves=True,
        engine=dict(n_slots=SLOTS, max_len=MAXLEN, compress_weights=True,
                    max_fuse_steps=1)))))
    # the fixed loop, the moe model: 3 prompts of 10 tokens, 8 steps
    jcfg, tcfg = cfgs("moe")
    s, n = 10, 8
    max_len = s + n + BLK * TP
    prompts = np.random.default_rng(3).integers(0, 500, (3, s)) \
        .astype(np.int32)
    ref["fixed"] = ref_fixed(jcfg, jrun, TP, ref["moe"]["params"], prompts,
                             n, max_len)
    calls.append(("fixed", (tcfg, trun, prompts, n, max_len, dict(
        params=ref["moe"]["params"], forced=ref["fixed"][0][:, :n]))))
    # one MoE layer of each model: each rank's shard of 2 x 12 tokens
    rng = np.random.default_rng(4)
    cases = []
    for name in MODELS:
        jcfg, tcfg = cfgs(name)
        p1 = jax.tree_util.tree_map(lambda a: a[1],
                                    ref[name]["params"]["blocks"]["moe"])
        x = bf16_np(rng, (TP, 2, 6, 64))
        xd = bf16_np(rng, (4, 1, 64))
        ref[name]["layer"] = _ref_layer(jcfg, jrun, p1, x, xd)
        xs = [pair(x[r]) for r in range(TP)]
        calls.append(("mixers", (tcfg, trun, [
            dict(fn="moe_forward", p=p1, x=xs),
            dict(fn="moe_forward", p=p1, x=xs, groups=2),
            dict(fn="moe_decode", p=p1, x=pair(xd))])))
    with ThreadPoolExecutor(3) as pool:
        job = pool.submit(mesh.spawn, tp_jobs.batch, TP, backend="gloo",
                          args=(calls,))
        launched = {k: pool.submit(_launch, "--arch", "jamba-tiny-dev",
                                   "--tp", "2", "--dist-backend", "gloo",
                                   *args) for k, args in LAUNCH.items()}
        for name in MODELS:
            jcfg, _ = cfgs(name)
            params = jax.tree_util.tree_map(jnp.asarray, ref[name]["params"])
            for codec_on in (True, False):
                je = JEngine(jcfg, _runs(codec_on)[0], tp=TP, n_slots=SLOTS,
                             max_len=MAXLEN, max_fuse_steps=1, params=params)
                res, st = je.run([JRequest(**r) for r in _mix()])
                streams = [(list(r.tokens), r.stop_reason) for r in res]
                k = first_replay(_mix(), TP)
                ref[name][codec_on] = dict(
                    streams=streams,
                    stats=(st.n_admit_dispatches, st.n_replay_dispatches),
                    replay=ref_forced(jcfg, jrun, TP, ref[name]["params"],
                                      _mix()[k]["prompt"], streams[k][0], BLK)
                    if codec_on else None)
        # the reference packs its whole tree at tp = 2
        jcfg, _ = cfgs("jamba")
        table = jlm.lm_table(jcfg, MeshConfig(data=1, model=TP, pod=1), jrun)
        packed, specs = jweights.pack_serving_params(
            jax.tree_util.tree_map(jnp.asarray, ref["jamba"]["params"]),
            JPM.param_pspecs(table), tp=TP)
        ref["packed"] = dict(params=jax.tree_util.tree_map(
            np.asarray, packed), specs=specs)
        ranks = job.result()
        ref["launch"] = {k: v.result() for k, v in launched.items()}
    return ref, ranks


def _close_bf16(got, want):
    got = got[1].view(ml_dtypes.bfloat16) if isinstance(got, tuple) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=BF16_STEP, atol=1e-6)


def _ref_wire(x: np.ndarray, codec=jcl.CodecConfig()) -> np.ndarray:
    """The reference's ``fixed.compress`` of one part, its fields back to
    back (the port's wire layout)."""
    ct = jfixed.compress(jnp.asarray(x), k=codec.k,
                         esc_capacity=codec.esc_capacity(x.size))
    return np.concatenate([np.asarray(f).reshape(-1).view(np.uint8) for f in
                           (ct.signman, ct.planes, ct.dict_syms, ct.esc_pos,
                            ct.esc_raw, ct.n_escapes)])


@pytest.mark.parametrize("name", MODELS)
def test_moe_layer_matches_reference_shards(served, name):
    ref, ranks = served
    i = 6 + MODELS.index(name)
    y, disp, ret, ys, yd = ref[name]["layer"]
    for r in range(TP):
        joint, per_seq, dec = ranks[r][i]
        _close_bf16(joint["y"], y[r])
        _close_bf16(per_seq["y"], ys[r])
        _close_bf16(dec["y"], yd[r])
        # dispatch, then return: one packed part per destination rank
        # (each sequence's parts cross in the same two exchanges)
        assert [w.shape[0] for w in joint["wire"]] == [TP, TP]
        assert [w.shape[0] for w in per_seq["wire"]] == [2 * TP, 2 * TP]
        for j, (d, b) in enumerate(zip(disp[r].reshape(TP, -1),
                                       ret[r].reshape(TP, -1))):
            assert (joint["wire"][0][j] == _ref_wire(d)).all(), (r, j)
            assert (joint["wire"][1][j] == _ref_wire(b)).all(), (r, j)
        assert dec["wire"] == []              # decode sums raw partials
    assert disp.shape[1:] == (8, jmoe._capacity(12, cfgs(name)[0]), 64)


@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
@pytest.mark.parametrize("name", MODELS)
def test_streams_equal_the_reference(served, name, codec_on):
    ref, ranks = served
    i = 2 * MODELS.index(name) + (0 if codec_on else 1)
    want = ref[name][codec_on]
    got = ranks[0][i]["runs"][0]["streams"]
    for r in range(TP):
        run = ranks[r][i]["runs"][0]
        assert run["streams"] == got, r
        assert (run["stats"]["n_admit_dispatches"],
                run["stats"]["n_replay_dispatches"]) == want["stats"]
    assert want["stats"][1] > 0                  # odd tails replayed
    jcfg, _ = cfgs(name)
    assert part_at_near_ties(jcfg, _runs(codec_on)[0], TP,
                             ref[name]["params"], _mix(), got,
                             want["streams"],
                             ranks[0][i]["runs"][0]["forced"],
                             want["replay"], BLK) <= 1
    if codec_on:      # the all-to-alls and gathers compressed, lossless
        w = ranks[0][i]["runs"][0]["wire"]
        assert 0 < w["wire_bytes"] < w["raw_bytes"] and w["overflows"] == 0
        kinds = w["kinds"]         # each prefill's dispatch and return
        assert set(kinds) == {"all_gather", "dispatch", "return"}
        assert kinds["dispatch"] == kinds["return"]
        assert kinds["dispatch"]["calls"] == want["stats"][0] \
            * jcfg.n_layers


def test_packed_leaves_are_the_reference_shards(served):
    """Each rank's PackedWeight leaves (the expert stacks, sharded on
    their expert dim, and the SSM's) are the reference's packed whole
    leaves cut along their PartitionSpec's model dim, byte for byte; the
    packed streams equal the raw ones."""
    ref, ranks = served
    i = 4
    raw = ranks[0][2 * MODELS.index("jamba")]["runs"][0]["streams"]
    for r in range(TP):
        assert ranks[r][i]["runs"][0]["streams"] == raw
    params, specs = ref["packed"]["params"], ref["packed"]["specs"]
    paths = set(ranks[0][i]["packed"])
    assert {"blocks/moe/w_gate", "blocks/moe/w_up", "blocks/moe/w_down",
            "blocks/ssm/w_zx", "blocks/ssm/w_out"} <= paths
    for path in paths:
        node, spec = params, specs
        for key in path.split("/"):
            node, spec = node[key], spec[key]
        for f in ("signman", "planes", "dict_syms"):
            whole = np.asarray(getattr(node, f))
            sp = tuple(getattr(spec, f))
            sp = sp + (None,) * (whole.ndim - len(sp))
            for r in range(TP):
                part = whole
                if "model" in sp:
                    part = np.split(whole, TP, axis=sp.index("model"))[r]
                got = ranks[r][i]["packed"][path]
                assert int(node.k) == got["k"], path
                assert (got[f].view(np.uint8) == part.view(np.uint8)).all(), \
                    (path, f, r)


def test_fixed_loop_matches_reference(served):
    """Teacher-forced logits within 5e-3; the greedy streams equal the
    reference's up to its first top-2 margin within 1e-2."""
    ref, ranks = served
    want, logits = ref["fixed"]
    v = 500
    got0 = ranks[0][5]
    for r in range(TP):
        assert (ranks[r][5]["tokens"] == got0["tokens"]).all()
    np.testing.assert_allclose(got0["logits"][..., :v], logits[..., :v],
                               atol=5e-3)
    top2 = np.sort(logits[..., :v], -1)[..., -2:]
    near_tie = ((top2[..., 1] - top2[..., 0]) <= 1e-2).T     # (B, n + 1)
    for b in range(want.shape[0]):
        diff = np.flatnonzero(got0["tokens"][b] != want[b])
        if len(diff):
            assert near_tie[b, diff[0]], (b, diff[0])


@pytest.mark.parametrize("mode", sorted(LAUNCH))
def test_launcher_serves_jamba_at_tp2(served, mode):
    ref, _ = served
    code, out, err = ref["launch"][mode]
    assert code == 0, err[-3000:]
    assert "sample continuations" in out and "tp 2" in out
