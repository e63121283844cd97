"""The parallel attention ∥ SSM hybrid on the port's serving paths
(device="cpu", weights bridged from the reference) against the reference
at tp = 1, on the reference tests' hybrid model (``tests/test_serve_engine
.py``: 3 layers, hymba_3global windows, Mamba2 d_state 16, block 4):

- ``ServeEngine`` with sharing off, codec on and off: the reference's
  greedy streams and admission counts (the exact-trunk bucket);
- sharing on: the same streams, boundary-snapshot hits and ``cache_*``
  counters; a snapshot restored through a warm import;
- the fixed loop (``engine.generate``) against the reference's
  prefill + ``decode_step``;
- the packed weight plane: packed streams equal the raw ones;
- a disaggregated fleet: streams equal the monolithic engine's, the SSM
  section crosses byte for byte, the port's blobs serialize to the
  reference serializer's bytes, and a reference prefill replica feeds
  port decode replicas (and the reverse) with the monolithic streams.

Streams are compared for identity: near-ties widen nothing."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import ModelConfig as JModel, RunConfig as JRun
from repro.configs.base import SSMConfig as JSSM
from repro.core import collectives as jcl
from repro.core.collectives import CodecConfig as JCodec
from repro.models import lm as jlm
from repro.serve import DisaggEngine as JDisagg, Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro.serve import disagg as jdisagg, engine as jengine
from repro.serve import transport as jtransport
from repro_torch.configs.base import ModelConfig as TModel
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import SSMConfig as TSSM
from repro_torch.core.collectives import CodecConfig as TCodec
from repro_torch.models.params import from_jax_params
from repro_torch.serve import LoopbackTransport, engine as tengine
from repro_torch.serve.disagg import DisaggEngine, Handoff, PrefillReplica
from repro_torch.serve.scheduler import Request, ServeEngine
from torch_port_util import bf16_np

torch.set_num_threads(2)

KW = dict(name="h", family="hybrid", n_layers=3, d_model=64, n_heads=4,
          n_kv_heads=2, d_ff=128, vocab_size=500, head_dim=16,
          parallel_hybrid=True, attn_layout="hymba_3global", window=16,
          sub_quadratic=True)
SSM_KW = dict(d_state=16, headdim=8, chunk=16)
JCFG, TCFG = JModel(ssm=JSSM(**SSM_KW), **KW), TModel(ssm=TSSM(**SSM_KW),
                                                      **KW)
MAXLEN, SLOTS, BLK = 48, 2, 4
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


def _mix(cls=Request):
    """Mixed lengths (each its own exact trunk), ring flushes in decode,
    windows crossed, more requests than slots."""
    rng = np.random.default_rng(0)
    specs = [(8, 5), (13, 6), (5, 9), (23, 4), (13, 7)]
    return [cls(uid=i, prompt=rng.integers(0, 500, (s,)).astype(np.int32),
                max_new_tokens=n) for i, (s, n) in enumerate(specs)]


def _shared_mix(cls=Request):
    """Page-aligned prompts served again (snapshot hits, hot), an
    unaligned one (never a hit), and a repeat in one admission round
    (waits for the index)."""
    rng = np.random.default_rng(1)
    a, b = (rng.integers(0, 500, (n,)).astype(np.int32) for n in (8, 12))
    c = rng.integers(0, 500, (10,)).astype(np.int32)
    specs = [(a, 5), (a, 3), (b, 6), (c, 4), (b, 2), (a, 7), (c, 3)]
    return [cls(uid=i, prompt=p.copy(), max_new_tokens=n)
            for i, (p, n) in enumerate(specs)]


def _stream(results):
    return [(r.tokens, r.stop_reason) for r in results]


def _ref_params(je):
    """The reference engine's seeded weights with the zeros/ones SSM
    leaves made to count."""
    params = jax.device_get(je.params)
    rng = np.random.default_rng(5)
    s = params["blocks"]["ssm"]
    s["dt_bias"] = bf16_np(rng, s["dt_bias"].shape, 0.5)
    s["a_log"] = bf16_np(rng, s["a_log"].shape, 0.5)
    s["d_skip"] = (1 + bf16_np(rng, s["d_skip"].shape, 0.2).astype(
        np.float32)).astype(ml_dtypes.bfloat16)
    je.params = jax.tree_util.tree_map(jnp.asarray, params)
    return params


@pytest.fixture(scope="module", params=[True, False], ids=["codec", "raw"])
def ref(request):
    """The reference engine (sharing off, one step per window) and its
    streams on the mix, the bridged weights."""
    jrun, trun = _runs(request.param)
    je = JEngine(JCFG, jrun, tp=1, n_slots=SLOTS, max_len=MAXLEN, seed=1,
                 prefix_sharing=False, max_fuse_steps=1)
    params = _ref_params(je)
    res, st = je.run(_mix(JRequest))
    return dict(codec_on=request.param, jrun=jrun, trun=trun, je=je,
                jparams=params, params=from_jax_params(params),
                mono=_stream(res), stats=st)


def _engine(ref, **kw):
    return ServeEngine(TCFG, ref["trun"], n_slots=kw.pop("n_slots", SLOTS),
                       max_len=MAXLEN, params=ref["params"],
                       max_fuse_steps=1, device="cpu", **kw)


def test_streams_identical(ref):
    te = _engine(ref, prefix_sharing=False)
    res, st = te.run(_mix())
    assert _stream(res) == ref["mono"]
    js = ref["stats"]
    assert st.n_admit_dispatches == js.n_admit_dispatches
    assert st.n_replay_dispatches == js.n_replay_dispatches == 0
    assert st.decode_steps == js.decode_steps
    assert not te.state.kv.page_used.any() and not te.state.active.any()
    # the pool's bytes count the SSM state of every slot
    ssm_bytes = sum(t.numel() * t.element_size() for t in te.state.ssm)
    assert ssm_bytes == 3 * SLOTS * (16 * 8 * 16 * 4 + 3 * (128 + 32) * 2)
    assert te.sync_metrics(te._new_loop()).value("serve.pool_bytes") \
        == tengine.paged_state_nbytes(te.state) > ssm_bytes


def test_packed_weights_stream_equal_raw(ref):
    te = _engine(ref, prefix_sharing=False, compress_weights=True)
    res, st = te.run(_mix())
    assert _stream(res) == ref["mono"]
    assert st.weights_compressed and st.weight_ratio < 1.0
    packed = [k for k, v in te.params["blocks"]["ssm"].items()
              if not isinstance(v, torch.Tensor)]
    assert sorted(packed) == ["w_out", "w_zx"]


def test_prefix_sharing_snapshots_match_reference():
    """Sharing on: the reference's streams, snapshot hits, admissions and
    ``cache_*`` counters; the port's snapshots equal in number and key."""
    jrun, trun = _runs(True)
    je = JEngine(JCFG, jrun, tp=1, n_slots=SLOTS, max_len=MAXLEN, seed=1,
                 max_fuse_steps=1)
    params = _ref_params(je)
    jres, jst = je.run(_shared_mix(JRequest))
    te = ServeEngine(TCFG, trun, n_slots=SLOTS, max_len=MAXLEN,
                     params=from_jax_params(params), max_fuse_steps=1,
                     device="cpu")
    res, st = te.run(_shared_mix())
    assert _stream(res) == _stream(jres)
    for f in COUNTERS:
        assert getattr(st, f) == getattr(jst, f), f
    assert st.shared_page_hits > 0
    assert list(te.cache.snapshots) == list(je.cache.snapshots)
    for key, snap in te.cache.snapshots.items():
        jsnap = je.cache.snapshots[key]
        assert snap["g0"] == jsnap["g0"]
        np.testing.assert_allclose(snap["ssm"].h.numpy(), jsnap["ssm"].h[0],
                                   rtol=1e-4, atol=1e-4)
    # the same prompts again, every hot column evicted first: each
    # page-aligned repeat restores its snapshot through a warm import
    te._ensure_free_pages(te._n_pages)
    assert not te.cache.lru
    again, st2 = te.run([dataclasses.replace(r, uid=100 + r.uid)
                         for r in _shared_mix()])
    assert [r.tokens for r in again] == [r.tokens for r in res]
    assert st2.n_admit_dispatches < st.n_admit_dispatches
    assert st2.cache_fetched_pages > st.cache_fetched_pages


def test_fixed_loop_matches_reference(ref):
    """The fixed loop: 3 prompts of 10 tokens, 8 greedy steps (flushes at
    12 and 16), against the reference's prefill + decode_step.  Fed the
    reference's tokens, the port's logits are within 5e-3 at every step
    and layer 0's recurrent state within 1e-4.  The port's own greedy
    stream (``generate``) equals the reference's up to the first step
    whose reference top-2 margin is within 1e-2 (``ROADMAP.md`` section
    3, item 2: both codec cases meet one, margin 1.35e-3 at token 6 of
    sequence 0); streams that meet no such step are identical."""
    atol = 5e-3
    jrun, trun = ref["jrun"], ref["trun"]
    jp = jax.tree_util.tree_map(jnp.asarray, ref["jparams"])
    dims = ref["je"].dims
    mesh = jax.make_mesh((1, 1), ("data", "model"))

    def shm_jit(f, n):
        return jax.jit(jcl.shmap(f, mesh, tuple(P() for _ in range(n)), P()))

    s, n, max_len = 10, 8, 24
    prefill = shm_jit(lambda p, t: jengine.prefill(JCFG, jrun, p, dims, t,
                                                   max_len, 1), 2)
    step = shm_jit(lambda p, st, tok: jengine.decode_step(
        JCFG, jrun, p, dims, st, tok, 1), 3)
    prompts = np.random.default_rng(3).integers(0, 500, (3, s)) \
        .astype(np.int32)
    lg, st = prefill(jp, jnp.asarray(prompts))
    lt, tst = tengine.prefill(TCFG, trun, ref["params"],
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
        lt = tengine.decode_step(TCFG, trun, ref["params"], tst,
                                 torch.as_tensor(tok))
    want, want_lg = np.stack(want, 1), np.stack(want_lg, 1)
    np.testing.assert_allclose(np.stack(got_lg, 1), want_lg, atol=atol)
    np.testing.assert_allclose(tst.ssm.h[0].numpy(), np.asarray(st.ssm.h)[0],
                               rtol=1e-4, atol=1e-4)
    got = tengine.generate(TCFG, trun, ref["params"],
                           torch.as_tensor(prompts), n, max_len).numpy()
    top2 = np.sort(want_lg, -1)[..., -2:]
    near_tie = top2[..., 1] - top2[..., 0] <= 2 * atol       # (B, n + 1)
    for b in range(3):
        diff = np.flatnonzero(got[b] != want[b])
        if len(diff):
            assert near_tie[b, diff[0]], (b, diff[0], got[b], want[b])
    print("first divergence per sequence",
          [int(np.flatnonzero(g != w)[0]) if (g != w).any() else None
           for g, w in zip(got, want)], f"of {n + 1} tokens")


def _to_ref_blob(blob):
    """The port's blob as the reference's ``SequenceBlob`` (bf16 leaves as
    ml_dtypes bf16, the same bits)."""
    f = dataclasses.asdict(blob)
    f["kv"] = {k: (v.view(ml_dtypes.bfloat16) if k in ("ring", "raw_pages")
                   else v) for k, v in blob.kv.items()}
    h, cx, cbc = blob.ssm
    f["ssm"] = (h, cx.view(ml_dtypes.bfloat16), cbc.view(ml_dtypes.bfloat16))
    return jtransport.SequenceBlob(**f)


def test_disagg_fleet_and_wire(ref):
    """A prefill replica hands off to a decode replica: the monolithic
    streams; each blob's SSM section equals the prefill slot's state and
    arrives byte for byte; the reference serializer writes the port's
    blobs to the same bytes; the link totals count the SSM section."""
    dis = DisaggEngine(TCFG, ref["trun"], n_slots=SLOTS, max_len=MAXLEN,
                       params=ref["params"], max_fuse_steps=1, device="cpu")
    pre, dec = dis.prefills[0], dis.decodes[0]
    blobs, imported = [], []
    export, imp = pre._export_blob, dec.import_handoff

    def watch_export(s):
        blob = export(s)
        want = [t[:, s] for t in pre.engine.state.ssm]
        assert (blob.ssm[0][0] == want[0].numpy()).all()
        assert (blob.ssm[1][0] == want[1].view(torch.int16).numpy()
                .view(np.uint16)).all()
        # the export hands out views; the blob's section owns its copy
        _, view, _ = tengine.export_slot(pre.engine.state, s, 1)
        assert all(a.data_ptr() == b.data_ptr() for a, b in zip(view, want))
        assert not any(np.shares_memory(a, b.numpy())
                       for a, b in zip(blob.ssm, (want[0],)))
        blobs.append(blob)
        return blob

    def watch_import(h):
        s = imp(h)
        imported.append([t[:, s].clone() for t in dec.engine.state.ssm])
        return s

    pre._export_blob, dec.import_handoff = watch_export, watch_import
    res, st = dis.run(_mix())
    assert _stream(res) == ref["mono"]
    assert len(blobs) == len(imported) == st.n_transfers > 0
    for blob, got in zip(blobs, imported):
        assert blob.ssm is not None
        assert (got[0].numpy() == blob.ssm[0][0]).all()
        assert (got[2].view(torch.int16).numpy().view(np.uint16)
                == blob.ssm[2][0]).all()
        data = blob.to_wire(None)[0]
        assert _to_ref_blob(blob).to_wire(None)[0] == data
    ssm_raw = sum(sum(a.nbytes for a in b.ssm) for b in blobs)
    assert st.wire_raw_bytes >= ssm_raw and st.wire_bytes >= ssm_raw
    bad = dataclasses.replace(blobs[0], ssm=None)    # a dense blob
    with pytest.raises(ValueError, match="geometry"):
        dec.import_handoff(Handoff(req=_mix()[0], blob=bad, admit_t=0.0))


def test_cross_framework_handoffs(ref):
    """The reference's prefill replica (its sharing-off engine) hands off
    through the port's transport to a port decode replica, and a port
    prefill replica through the reference's transport to the reference's
    decode replica (the same engine): the monolithic streams both ways."""
    je = ref["je"]
    dis = DisaggEngine(TCFG, ref["trun"], n_slots=SLOTS, max_len=MAXLEN,
                       params=ref["params"], max_fuse_steps=1, device="cpu")
    pick = dis.prefills[0].pick_dst
    dis.prefills = [jdisagg.PrefillReplica(je, transport=dis.transport,
                                           pick_dst=pick)]
    res, _ = dis.run(_mix(JRequest))
    assert _stream(res) == ref["mono"]

    jtr = jtransport.LoopbackTransport()
    jd = JDisagg.__new__(JDisagg)      # the router alone, no new engines
    jd.cfg, jd.run_cfg = JCFG, ref["jrun"]
    jd.tracer, jd.transport = je.tracer, jtr
    jd.decodes, jd._names = [jdisagg.DecodeReplica(je)], ["decode0"]
    te = _engine(ref, prefix_sharing=False, name="prefill0")
    jd.prefills = [PrefillReplica(te, transport=jtr,
                                  pick_dst=lambda: "decode0")]
    res, _ = jd.run(_mix())
    assert _stream(res) == ref["mono"]
    assert isinstance(dis.transport, LoopbackTransport)


@pytest.mark.parametrize("mode", [[], ["--continuous"], ["--disagg"]],
                         ids=["fixed", "continuous", "disagg"])
def test_launcher_serves_zamba2(mode, capsys):
    """``launch.serve --arch zamba2-1.2b`` (its reduced variant) in each
    mode; the decode host's ``param_digest`` covers the SSM leaves."""
    from repro_torch.configs import get_config, make_reduced
    from repro_torch.launch import serve
    from repro_torch.launch.disagg_host import param_digest
    from repro_torch.models import lm, params as PM

    size = (["--batch", "2", "--prompt-len", "12", "--new-tokens", "3"]
            if not mode else ["--requests", "3", "--slots", "2",
                              "--prompt-len", "16", "--new-tokens", "3"])
    assert serve.main(["--arch", "zamba2-1.2b", "--device", "cpu"] + mode
                      + size) == 0
    assert "sample continuations" in capsys.readouterr().out
    if mode == ["--disagg"]:
        cfg = make_reduced(get_config("zamba2-1.2b"))
        params = PM.init_params(lm.lm_table(cfg),
                                torch.Generator().manual_seed(0))
        d = param_digest(params)
        conv = params["blocks"]["ssm"]["conv_x"].clone()
        conv[1, 0, 0] += 1
        params["blocks"]["ssm"]["conv_x"] = conv
        assert param_digest(params) != d
