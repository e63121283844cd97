"""The parallel attention ∥ SSM hybrid at tp = 2: the port on two spawned
gloo ranks (``launch.mesh.spawn`` running ``launch.tp_jobs``, which
imports no JAX) against the reference on two of conftest's fake devices,
with the reference's weights (the whole tree, cut to each rank's shard by
``models.params.shard_params``), on the reference tests' hybrid
(``tests/test_serve_engine.py``: 3 layers, hymba_3global windows, Mamba2
d_state 16, block 4) with its per-head vectors seeded:

* ``ssm_forward`` and ``ssm_decode_step`` on each rank against the
  reference's shard outputs under ``shmap``: the rank's z and x halves of
  its ``w_zx`` columns, ``gate_norm`` over the rank's channels, the
  row-parallel B/C projection (the reference's tp = 2 function, which is
  not its tp = 1 function: ``ROADMAP.md``, section 3);
* ``ServeEngine(tp=2)``, codec on and off, with prefix sharing on, on a
  mix with odd prompt lengths (their one-token tails replay through
  decode steps) and page-aligned prompts served again: both ranks'
  streams alike, boundary-snapshot hits, admission and replay dispatches
  and the ``cache_*`` counters equal to the reference's
  ``ServeEngine(tp=2)``, the streams and stop reasons too, except that a
  request may part at a near-tie of the reference's own logits (its
  top-2 margin there within 1e-2: ``torch_tp_ref.part_at_near_ties``, at
  most one request of the mix), the rule the fixed loop is held to; the
  port's paged path teacher-forced (trunk, the tail replayed, the
  stream) within 5e-3 of the reference's logits up to each parting
  position and over a replayed request's whole stream;
* packed weights: streams equal to the reference's, and each rank's
  packed leaves (the SSM's among them) the reference's
  ``pack_serving_params(..., tp=2)`` shards byte for byte;
* the fixed loop: teacher-forced logits within 5e-3, as
  ``test_torch_fixed.py`` holds tp = 1.

Tolerances: SSM outputs 1e-2, its state 1e-4 (f32 sums in another
order); conv rings bit for bit."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import MeshConfig
from repro.configs.base import ModelConfig as JModel, RunConfig as JRun
from repro.configs.base import SSMConfig as JSSM
from repro.core import collectives as jcl
from repro.core import weights as jweights
from repro.core.collectives import CodecConfig as JCodec
from repro.models import lm as jlm, params as JPM, ssm as jssm
from repro.serve import Request as JRequest, ServeEngine as JEngine
from repro_torch.configs.base import ModelConfig as TModel
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import SSMConfig as TSSM
from repro_torch.core.collectives import CodecConfig as TCodec
from repro_torch.launch import mesh, tp_jobs
from repro_torch.models import lm as tlm, params as tparams
from torch_port_util import bf16_np
from torch_tp_ref import (first_replay, pair, part_at_near_ties, ref_fixed,
                          ref_forced, tree_np)

torch.set_num_threads(2)

KW = dict(name="h", family="hybrid", n_layers=3, d_model=64, n_heads=4,
          n_kv_heads=2, d_ff=128, vocab_size=500, head_dim=16,
          parallel_hybrid=True, attn_layout="hymba_3global", window=16,
          sub_quadratic=True)
SSM_KW = dict(d_state=16, headdim=8, chunk=16)
JCFG, TCFG = JModel(ssm=JSSM(**SSM_KW), **KW), TModel(ssm=TSSM(**SSM_KW),
                                                      **KW)
TP, MAXLEN, SLOTS, BLK = 2, 48, 2, 4
COUNTERS = ("shared_page_hits", "cache_hot_hits", "cache_spilled_pages",
            "cache_spilled_bytes", "cache_fetched_pages",
            "cache_fetched_bytes", "cache_reprefill_cols",
            "cache_evicted_cols", "n_admit_dispatches",
            "n_replay_dispatches")


def _runs(codec_on):
    jc = JCodec(cache_block=BLK) if codec_on else dataclasses.replace(
        JCodec.off(), cache_block=BLK)
    tc = TCodec(cache_block=BLK) if codec_on else dataclasses.replace(
        TCodec.off(), cache_block=BLK)
    return JRun(codec=jc), TRun(codec=tc)


def _tree():
    """Seeded weights of the tp = 2 table (numpy, the port's init: any
    seeded tree will do), the per-head vectors seeded so that they
    count."""
    gen = torch.Generator().manual_seed(1)
    params = tree_np(tparams.init_params(tlm.lm_table(TCFG, TP), gen))
    rng = np.random.default_rng(5)
    s = params["blocks"]["ssm"]
    s["dt_bias"] = bf16_np(rng, s["dt_bias"].shape, 0.5)
    s["a_log"] = bf16_np(rng, s["a_log"].shape, 0.5)
    s["d_skip"] = (1 + bf16_np(rng, s["d_skip"].shape, 0.2).astype(
        np.float32)).astype(ml_dtypes.bfloat16)
    return params


def _mix():
    """Odd lengths (a one-token tail replays at tp = 2), a prompt of one
    page column, page-aligned prompts (8 and 16 tokens: whole columns of
    blk * tp) served again, one of them twice in one admission round
    (it waits for the index), more requests than slots."""
    rng = np.random.default_rng(1)
    a, b = (rng.integers(0, 500, (n,)).astype(np.int32) for n in (8, 16))
    specs = [(a, 5), (rng.integers(0, 500, (13,)), 6), (b, 4), (a, 3),
             (rng.integers(0, 500, (5,)), 7), (b, 2), (a, 4),
             (rng.integers(0, 500, (11,)), 3)]
    return [dict(uid=i, prompt=np.asarray(p, np.int32).copy(),
                 max_new_tokens=n) for i, (p, n) in enumerate(specs)]


def _shard_specs():
    return JPM.param_pspecs(jssm.ssm_table(JCFG, TP))


def _ref_ssm(p, x, x1, jrun):
    """The reference's SSM layer at tp = 2 under shmap: the forward's
    per-rank partial and state on ``x``, then one decode step on ``x1``
    from that state: (out, state, out1, state1), each (tp, ...)."""
    mesh_ = jax.make_mesh((TP,), ("model",))

    def body(pp, xx, xx1):
        out, st = jssm.ssm_forward(JCFG, jrun, pp, xx, TP, want_state=True)
        out1, st1 = jssm.ssm_decode_step(JCFG, pp, xx1, st, TP)
        lead = lambda t: jax.tree_util.tree_map(lambda a: a[None], t)
        return lead(out), lead(tuple(st)), lead(out1), lead(tuple(st1))

    f = jax.jit(jcl.shmap(body, mesh_, (_shard_specs(), P(), P()),
                          P("model")))
    return jax.tree_util.tree_map(np.asarray, f(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
        jnp.asarray(x1)))


@pytest.fixture(scope="module")
def served():
    """The reference's fixed loop and SSM layer, then every port job on one
    spawn of two ranks, run in a thread while the reference serves and
    packs."""
    params = _tree()
    jrun, trun = _runs(True)
    ref, calls = {}, []
    for codec_on in (True, False):
        calls.append(("serve", (TCFG, _runs(codec_on)[1], _mix(), dict(
            params=params, forced=True,
            engine=dict(n_slots=SLOTS, max_len=MAXLEN, max_fuse_steps=1)))))
    calls.append(("serve", (TCFG, trun, _mix()[:5], dict(
        params=params, packed_leaves=True, forced=True,
        engine=dict(n_slots=SLOTS, max_len=MAXLEN, compress_weights=True,
                    prefix_sharing=False, max_fuse_steps=1)))))
    # the fixed loop: 3 prompts of 10 tokens, 8 steps (flushes at 16)
    s, n = 10, 8
    max_len = s + n + BLK * TP
    prompts = np.random.default_rng(3).integers(0, 500, (3, s)) \
        .astype(np.int32)
    ref["fixed"] = ref_fixed(JCFG, jrun, TP, params, prompts, n, max_len)
    calls.append(("fixed", (TCFG, trun, prompts, n, max_len, dict(
        params=params, forced=ref["fixed"][0][:, :n]))))
    # one layer's SSM: the forward on 2 x 12 tokens, then a decode step
    rng = np.random.default_rng(4)
    p1 = jax.tree_util.tree_map(lambda a: a[1], params["blocks"]["ssm"])
    x = bf16_np(rng, (2, 12, JCFG.d_model))
    x1 = bf16_np(rng, (2, 1, JCFG.d_model))
    ref["ssm"] = _ref_ssm(p1, x, x1, jrun)
    st = ref["ssm"][1]
    calls.append(("mixers", (TCFG, trun, [
        dict(fn="ssm_forward", p=p1, x=pair(x)),
        dict(fn="ssm_decode_step", p=p1, x=pair(x1),
             state=[[pair(t[r]) for t in st] for r in range(TP)])])))
    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(mesh.spawn, tp_jobs.batch, TP, backend="gloo",
                          args=(calls,))
        for codec_on in (True, False):
            je = JEngine(JCFG, _runs(codec_on)[0], tp=TP, n_slots=SLOTS,
                         max_len=MAXLEN, max_fuse_steps=1,
                         params=jax.tree_util.tree_map(jnp.asarray, params))
            res, st = je.run([JRequest(**r) for r in _mix()])
            streams = [(list(r.tokens), r.stop_reason) for r in res]
            k = first_replay(_mix(), TP)
            ref[codec_on] = dict(
                streams=streams, stats={f: getattr(st, f) for f in COUNTERS},
                replay=ref_forced(JCFG, jrun, TP, params, _mix()[k]["prompt"],
                                  streams[k][0], BLK) if codec_on else None)
        # the reference packs its whole tree at tp = 2
        table = jlm.lm_table(JCFG, MeshConfig(data=1, model=TP, pod=1), jrun)
        packed, specs = jweights.pack_serving_params(
            jax.tree_util.tree_map(jnp.asarray, params),
            JPM.param_pspecs(table), tp=TP)
        ref["params"] = params
        ref["packed"] = dict(params=jax.tree_util.tree_map(
            np.asarray, packed), specs=specs)
        ranks = job.result()
    return ref, ranks


def _bf(a):
    return a[1].view(ml_dtypes.bfloat16).astype(np.float32) \
        if isinstance(a, tuple) else np.asarray(a)


def test_ssm_layer_matches_reference_shards(served):
    ref, ranks = served
    out, st, out1, st1 = ref["ssm"]
    for r in range(TP):
        fwd, dec = ranks[r][-1]
        np.testing.assert_allclose(_bf(fwd["y"]), out[r], atol=1e-2,
                                   rtol=1e-2)
        np.testing.assert_allclose(dec["y"], out1[r], atol=1e-2, rtol=1e-2)
        for got, want in ((fwd["state"], st), (dec["state"], st1)):
            np.testing.assert_allclose(got[0], want[0][r], atol=1e-4,
                                       rtol=1e-4)              # h, the rank's
            assert got[0].shape[1] == JCFG.ssm.n_heads(64) // TP
            for i in (1, 2):                                   # rings
                assert (got[i][1] == np.asarray(want[i][r])
                        .view(np.uint16)).all(), i
        assert fwd["wire"] == []               # the B/C psum moves raw


@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
def test_streams_snapshots_and_counters(served, codec_on):
    """Both ranks' streams alike and the reference's (a request may part
    at a near-tie of the reference's own logits, ``part_at_near_ties``:
    at most one of the mix), the counters equal."""
    ref, ranks = served
    i = 0 if codec_on else 1
    want = ref[codec_on]
    got = ranks[0][i]["runs"][0]["streams"]
    for r in range(TP):
        run = ranks[r][i]["runs"][0]
        assert run["streams"] == got, r
        for f in COUNTERS:
            assert run["stats"][f] == want["stats"][f], (r, f)
    assert part_at_near_ties(JCFG, _runs(codec_on)[0], TP, ref["params"],
                             _mix(), got, want["streams"],
                             ranks[0][i]["runs"][0]["forced"],
                             want["replay"], BLK) <= 1
    assert want["stats"]["shared_page_hits"] > 0      # snapshots hit
    assert want["stats"]["n_replay_dispatches"] > 0   # odd tails replayed
    if codec_on:
        w = ranks[0][i]["runs"][0]["wire"]
        assert 0 < w["wire_bytes"] < w["raw_bytes"] and w["overflows"] == 0


def test_packed_streams_and_leaves(served):
    """Packed streams equal the reference's (packing changes no stream
    there: its CPU weight backend is exact); each rank's PackedWeight
    leaves are the reference's packed whole leaves cut along their
    PartitionSpec's model dim, byte for byte (the SSM's ``w_zx`` column
    shard and ``w_out`` row shard among them; at this width ``w_bc`` and
    ``conv_x`` are under the size threshold, and the stacked
    ``gate_norm`` stays raw: ``ROADMAP.md`` section 3, item 1)."""
    ref, ranks = served
    i = 2
    got = ranks[0][i]["runs"][0]["streams"]
    for r in range(TP):
        assert ranks[r][i]["runs"][0]["streams"] == got
    assert got == ranks[0][0]["runs"][0]["streams"][:5]   # as raw
    assert part_at_near_ties(JCFG, _runs(True)[0], TP, ref["params"],
                             _mix()[:5], got, ref[True]["streams"][:5],
                             ranks[0][i]["runs"][0]["forced"],
                             ref[True]["replay"], BLK) <= 1
    params, specs = ref["packed"]["params"], ref["packed"]["specs"]
    paths = set(ranks[0][i]["packed"])
    assert {"blocks/ssm/w_zx", "blocks/ssm/w_out"} <= paths
    assert "blocks/ssm/gate_norm" not in paths
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
                got = ranks[r][i]["packed"][path][f]
                assert int(node.k) == ranks[r][i]["packed"][path]["k"]
                assert (got.view(np.uint8) == part.view(np.uint8)).all(), \
                    (path, f, r)


def test_fixed_loop_matches_reference(served):
    """Teacher-forced logits within 5e-3; the greedy streams equal the
    reference's up to its first top-2 margin within 1e-2."""
    ref, ranks = served
    want, logits = ref["fixed"]
    v = JCFG.vocab_size
    got0 = ranks[0][3]
    for r in range(TP):
        assert (ranks[r][3]["tokens"] == got0["tokens"]).all()
    np.testing.assert_allclose(got0["logits"][..., :v], logits[..., :v],
                               atol=5e-3)
    top2 = np.sort(logits[..., :v], -1)[..., -2:]
    near_tie = ((top2[..., 1] - top2[..., 0]) <= 1e-2).T     # (B, n + 1)
    for b in range(want.shape[0]):
        diff = np.flatnonzero(got0["tokens"][b] != want[b])
        if len(diff):
            assert near_tie[b, diff[0]], (b, diff[0])
