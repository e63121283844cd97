"""Disaggregated prefill -> decode serving in the port (``repro_torch.serve.
disagg``, device="cpu", weights bridged from the reference) against the
reference's ``DisaggEngine`` and ``ServeEngine`` at tp = 1 on the
reference test's dense model (``tests/test_disagg.py``, block 4), codec on
and off: streams equal the monolithic engines' (the port's and the
reference's), streaming, prefix reuse across imports, several replicas,
the export -> import round trip bit for bit, a permuted free list,
oversubscription rejected where the reference rejects it with the pool
untouched, the wire round trip, dedup on and off, and ``DisaggStats``'
byte counters equal to the reference's.  The cross-framework gate: a
reference prefill replica hands off to port decode replicas, and port
prefill replicas to a reference decode replica, through the transports'
wire bytes, with the monolithic streams on the other side."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModel, RunConfig as JRun
from repro.core.collectives import CodecConfig as JCodec
from repro.serve import DisaggEngine as JDisagg, Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro.serve import disagg as jdisagg, transport as jtransport
from repro_torch.configs.base import ModelConfig as TModel
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.core.collectives import CodecConfig as TCodec
from repro_torch.models import cache as tcache
from repro_torch.models.params import from_jax_params
from repro_torch.serve import LoopbackTransport, SequenceBlob
from repro_torch.serve.disagg import (DecodeReplica, DisaggEngine, Handoff,
                                      PrefillReplica)
from repro_torch.serve.scheduler import Request, ServeEngine

torch.set_num_threads(2)

KW = dict(name="t2", family="dense", n_layers=2, d_model=64, n_heads=8,
          n_kv_heads=4, d_ff=128, vocab_size=500, head_dim=16)
TCFG = TModel(**KW)
MAXLEN, SLOTS, BLK = 64, 2, 4
BYTE_COUNTERS = ("n_transfers", "wire_bytes", "wire_bytes_nodedup",
                 "wire_raw_bytes", "dedup_page_refs", "pages_streamed",
                 "stream_chunk_bytes", "pages_resent", "store_evicted",
                 "link_model_ms", "link_model_ms_raw")
SCHEDULE = ("n_requests", "n_tokens", "decode_steps", "n_dispatches",
            "n_admit_dispatches", "n_replay_dispatches",
            "decode_prefix_hits")


def _runs(codec_on):
    jc = JCodec(cache_block=BLK) if codec_on else dataclasses.replace(
        JCodec.off(), cache_block=BLK)
    tc = TCodec(cache_block=BLK) if codec_on else dataclasses.replace(
        TCodec.off(), cache_block=BLK)
    return JRun(codec=jc), TRun(codec=tc)


def _requests(cls=Request):
    """The reference test's mix: mixed (unaligned) lengths, shared
    prefixes, a budget-1 request that finishes on the prefill replica,
    more requests than decode slots."""
    rng = np.random.default_rng(7)
    a = rng.integers(0, 500, (16,)).astype(np.int32)
    specs = [(a, 5), (rng.integers(0, 500, (9,)).astype(np.int32), 3),
             (a.copy(), 4), (rng.integers(0, 500, (12,)).astype(np.int32), 1),
             (a.copy(), 6)]
    return [cls(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(specs)]


def _stream(results):
    return [(r.tokens, r.stop_reason) for r in results]


@pytest.fixture(scope="module", params=[True, False], ids=["codec", "raw"])
def ref(request):
    """The reference's monolithic engine and streaming DisaggEngine on the
    mix (one decode step per window, as the port's runs below), and the
    port's monolithic engine on the bridged weights."""
    codec_on = request.param
    jrun, trun = _runs(codec_on)
    je = JEngine(JModel(**KW), jrun, tp=1, n_slots=SLOTS, max_len=MAXLEN,
                 seed=1, max_fuse_steps=1)
    mono, _ = je.run(_requests(JRequest))
    jd = JDisagg(JModel(**KW), jrun, tp=1, n_slots=SLOTS, max_len=MAXLEN,
                 params=je.params, max_fuse_steps=1, streaming=True)
    dres, dst = jd.run(_requests(JRequest))
    params = from_jax_params(jax.device_get(je.params))
    tmono, _ = _engine(trun, params).run(_requests())
    return dict(codec_on=codec_on, jrun=jrun, trun=trun, params=params,
                mono=_stream(mono), disagg=_stream(dres), stats=dst,
                jpre=jd.prefills[0].engine, jdec=jd.decodes[0].engine,
                tmono=_stream(tmono))


def _engine(trun, params, **kw):
    return ServeEngine(TCFG, trun, n_slots=kw.pop("n_slots", SLOTS),
                       max_len=kw.pop("max_len", MAXLEN), params=params,
                       max_fuse_steps=1, device="cpu", **kw)


def _disagg(ref, **kw):
    return DisaggEngine(TCFG, ref["trun"], n_slots=SLOTS, max_len=MAXLEN,
                        params=ref["params"], max_fuse_steps=1,
                        device="cpu", **kw)


def _drains(decodes):
    for dr in decodes:
        dr.engine.drop_cache()
        assert dr.engine._pages_in_use() == 0
        assert not dr.engine._slot_busy.any()


@pytest.mark.parametrize("streaming", [False, True], ids=["whole", "stream"])
def test_disagg_matches_monolithic(ref, streaming):
    """The port's disaggregated streams equal its monolithic engine's and
    the reference's; the budget-1 request never transfers; streamed pages
    cross ahead of the tails and arrive as references; with streaming
    (the reference run's mode) every byte counter and the schedule equal
    the reference's ``DisaggStats``."""
    assert ref["tmono"] == ref["mono"] == ref["disagg"]
    dis = _disagg(ref, streaming=streaming)
    res, st = dis.run(_requests())
    assert _stream(res) == ref["mono"]
    assert st.n_transfers == len(res) - 1
    assert 0 < st.wire_bytes < st.wire_raw_bytes or not ref["codec_on"]
    if streaming:
        assert st.pages_streamed > 0 and st.stream_chunk_bytes > 0
        assert st.dedup_page_refs >= st.pages_streamed
        for f in BYTE_COUNTERS + SCHEDULE:
            assert getattr(st, f) == getattr(ref["stats"], f), f
        assert st.link_reduction == ref["stats"].link_reduction
    else:
        assert st.pages_streamed == st.stream_chunk_bytes == 0
    _drains(dis.decodes)


def test_cross_framework_reference_prefill_to_port_decode(ref):
    """A reference prefill replica streams its chunks and closing blobs
    through the port's transport (the reference's bytes, parsed by the
    port) into port decode replicas: the reference's monolithic streams,
    and the reference run's byte counters and schedule."""
    dis = _disagg(ref, streaming=True)
    pick = dis.prefills[0].pick_dst
    dis.prefills = [jdisagg.PrefillReplica(
        ref["jpre"], transport=dis.transport, pick_dst=pick,
        streaming=True)]
    res, st = dis.run(_requests(JRequest))
    assert _stream(res) == ref["mono"]
    for f in BYTE_COUNTERS + SCHEDULE:
        assert getattr(st, f) == getattr(ref["stats"], f), f
    _drains(dis.decodes)


def test_cross_framework_port_prefill_to_reference_decode(ref):
    """Port prefill replicas stream through the reference's transport into
    the reference's decode replica (its pool emptied first): the port's
    monolithic streams, and the reference run's byte counters."""
    jdec = ref["jdec"]
    jdec.drop_cache()
    assert jdec._pages_in_use() == 0
    jtr = jtransport.LoopbackTransport()
    jd = JDisagg.__new__(JDisagg)      # the router alone, no new engines
    jd.cfg, jd.run_cfg = JModel(**KW), ref["jrun"]
    jd.tracer, jd.transport = jdec.tracer, jtr
    jd.decodes, jd._names = [jdisagg.DecodeReplica(jdec)], ["decode0"]
    jdec.cache.remote_fetch = jd._make_fetch("decode0")
    te = _engine(ref["trun"], ref["params"], prefix_sharing=False,
                 name="prefill0")
    jd.prefills = [PrefillReplica(te, transport=jtr,
                                  pick_dst=lambda: "decode0",
                                  streaming=True)]
    res, st = jd.run(_requests())
    assert _stream(res) == ref["tmono"]
    for f in BYTE_COUNTERS + SCHEDULE:
        assert getattr(st, f) == getattr(ref["stats"], f), f
    jdec.drop_cache()
    assert jdec._pages_in_use() == 0


def test_decode_prefix_reuse_across_imports(ref):
    """Duplicates imported while the first is resident map the same pool
    pages; released columns stay hot; the pool drains after
    ``drop_cache``."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 500, (16,)).astype(np.int32)
    reqs = [Request(uid=0, prompt=a, max_new_tokens=8),
            Request(uid=1, prompt=a.copy(), max_new_tokens=4),
            Request(uid=2, prompt=a.copy(), max_new_tokens=3)]
    res_m, _ = _engine(ref["trun"], ref["params"]).run(reqs)
    dis = _disagg(ref)
    res_d, st = dis.run(reqs)
    assert _stream(res_d) == _stream(res_m)
    assert st.decode_prefix_hits > 0
    dec = dis.decodes[0].engine
    assert dec.cache.retained() > 0
    dec.drop_cache()
    assert dec._pages_in_use() == 0 and not dec._prefix_index


def test_multi_replica_routing(ref):
    """2 prefill -> 2 decode replicas: the monolithic streams, transfers
    spread over both decode replicas, every pool drains."""
    rng = np.random.default_rng(5)
    reqs = _requests() + [Request(uid=10 + i, prompt=rng.integers(
        0, 500, (8,)).astype(np.int32), max_new_tokens=3) for i in range(3)]
    res_m, _ = _engine(ref["trun"], ref["params"]).run(reqs)
    dis = _disagg(ref, n_prefill=2, n_decode=2)
    res_d, st = dis.run(reqs)
    assert _stream(res_d) == _stream(res_m)
    assert st.n_prefill_replicas == 2 and st.n_decode_replicas == 2
    assert st.n_transfers == len(reqs) - 1
    used = [len(dr.ls.results) for dr in dis.decodes]
    assert sum(used) == len(reqs) - 1 and all(u > 0 for u in used)
    _drains(dis.decodes)


def _admit_one(eng, prompt, uid=0, budget=4):
    """A prefill replica that admitted one request, its slot still live."""
    pr = PrefillReplica(eng)
    pr.submit(Request(uid=uid, prompt=prompt, max_new_tokens=budget))
    eng._admit_phase(pr.ls)
    return pr


def _pool(pkv):
    return {f: getattr(pkv, f).clone()
            for f in ("signman", "planes", "dict_syms", "esc_pos", "esc_raw",
                      "raw_pages", "ring") if getattr(pkv, f) is not None}


def test_export_import_roundtrip_bitexact(ref):
    """export -> import -> export reproduces the blob bit for bit (planes,
    dictionaries, escape side channels, ring), with other page ids."""
    prompt = np.random.default_rng(9).integers(0, 500, (19,)).astype(
        np.int32)
    pr = _admit_one(_engine(ref["trun"], ref["params"]), prompt)
    blob = pr._export_blob(0)
    assert blob.length == 19 and blob.n_cols == tcache.export_n_cols(19, BLK)
    dec = DecodeReplica(_engine(ref["trun"], ref["params"],
                                prefix_sharing=False))
    # a used page first, so that the imported ids differ from the source's
    dec.engine.state.kv.page_used[0] = True
    slot = dec.import_handoff(Handoff(req=pr.ls.slot_req[0], blob=blob,
                                      admit_t=0.0))
    assert (dec.engine.state.kv.page_table[slot, :blob.n_cols]
            != pr.engine.state.kv.page_table[0, :blob.n_cols]).all()
    pr2 = PrefillReplica(dec.engine)
    pr2.ls = dec.ls
    blob2 = pr2._export_blob(slot)
    assert blob.kv.keys() == blob2.kv.keys()
    for f in blob.kv:
        np.testing.assert_array_equal(blob.kv[f], blob2.kv[f], err_msg=f)
    assert blob.to_wire(None)[0] == blob2.to_wire(None)[0]


def test_import_into_permuted_free_list(ref):
    """Churn a decode pool so that its free list is permuted, then serve
    the mix through it: the monolithic streams."""
    dis = _disagg(ref)
    dec = dis.decodes[0]
    rng = np.random.default_rng(13)
    churn = [Request(uid=100, prompt=rng.integers(0, 500, (14,)).astype(
        np.int32), max_new_tokens=6),
        Request(uid=101, prompt=rng.integers(0, 500, (8,)).astype(np.int32),
                max_new_tokens=2)]
    pr = PrefillReplica(_engine(ref["trun"], ref["params"],
                                prefix_sharing=False))
    for r in churn:
        pr.submit(r)
    while not pr.idle():
        _, hoffs = pr.admit_step()
        for h in hoffs:
            dec.import_handoff(h)
        while dec.ls.live_slots():
            dec.step_window()
    dec.engine.drop_cache()
    assert dec.engine._pages_in_use() == 0
    res, _ = dis.run(_requests())
    assert _stream(res) == ref["mono"]


def test_import_oversubscription_fails_loudly(ref):
    """An import the pool cannot hold raises before any device write (the
    pool's bytes, table and page use unchanged, no slot taken), at the
    same free-page count as the reference's check; so do a sequence longer
    than a page-table row and a replica without a free slot."""
    rng = np.random.default_rng(17)
    prompt = rng.integers(0, 500, (16,)).astype(np.int32)
    pr = _admit_one(_engine(ref["trun"], ref["params"]), prompt)
    blob = pr._export_blob(0)
    req = pr.ls.slot_req[0]
    need = blob.valid_cols(0)
    jblob = jtransport.SequenceBlob.from_wire(blob.to_wire(None)[0])
    jreq = JRequest(uid=0, prompt=prompt, max_new_tokens=4)
    for free in (need - 1, need):
        dec = DecodeReplica(_engine(ref["trun"], ref["params"],
                                    prefix_sharing=False))
        kv = dec.engine.state.kv
        kv.page_used[free:] = True
        before = (_pool(kv), kv.page_table.copy(), kv.page_used.copy())
        jdec = jdisagg.DecodeReplica(JEngine(
            JModel(**KW), ref["jrun"], tp=1, n_slots=SLOTS, max_len=MAXLEN,
            seed=1, prefix_sharing=False, max_fuse_steps=1))
        jkv = jdec.engine.state.kv
        jused = np.zeros(jkv.page_used.shape, bool)
        jused[..., free:] = True
        jdec.engine.state = jdec.engine.state._replace(
            kv=jkv._replace(page_used=jax.numpy.asarray(jused)))
        if free < need:
            with pytest.raises(RuntimeError, match="oversubscribed"):
                dec.import_handoff(Handoff(req=req, blob=blob, admit_t=0.0))
            with pytest.raises(RuntimeError, match="oversubscribed"):
                jdec.import_handoff(jdisagg.Handoff(req=jreq, blob=jblob,
                                                    admit_t=0.0))
            after = (_pool(kv), kv.page_table, kv.page_used)
            for f in before[0]:
                assert torch.equal(before[0][f], after[0][f]), f
            assert (before[1] == after[1]).all()
            assert (before[2] == after[2]).all()
            assert dec.ls.slot_req == [None] * SLOTS
            assert not dec.engine._slot_busy.any()
        else:
            assert dec.import_handoff(Handoff(req=req, blob=blob,
                                              admit_t=0.0)) == 0
            assert jdec.import_handoff(jdisagg.Handoff(
                req=jreq, blob=jblob, admit_t=0.0)) == 0
            assert kv.page_used.all()

    long_prompt = rng.integers(0, 500, (40,)).astype(np.int32)
    pr2 = _admit_one(_engine(ref["trun"], ref["params"]), long_prompt)
    small = DecodeReplica(_engine(ref["trun"], ref["params"], max_len=8,
                                  prefix_sharing=False))
    with pytest.raises(ValueError, match="page columns"):
        small.import_handoff(Handoff(req=pr2.ls.slot_req[0],
                                     blob=pr2._export_blob(0), admit_t=0.0))
    one = DecodeReplica(_engine(ref["trun"], ref["params"], n_slots=1,
                                prefix_sharing=False))
    one.import_handoff(Handoff(req=req, blob=blob, admit_t=0.0))
    with pytest.raises(RuntimeError, match="no free decode slot"):
        one.import_handoff(Handoff(req=Request(uid=1, prompt=prompt,
                                               max_new_tokens=2),
                                   blob=blob, admit_t=0.0))
    # a blob of another geometry is refused before anything else
    other = dataclasses.replace(blob, k=blob.k + 1)
    with pytest.raises(ValueError, match="geometry"):
        small.import_handoff(Handoff(req=req, blob=other, admit_t=0.0))


def _port_blob(ref, length=10, seed=19):
    prompt = np.random.default_rng(seed).integers(0, 500, (length,)).astype(
        np.int32)
    return _admit_one(_engine(ref["trun"], ref["params"]),
                      prompt)._export_blob(0)


def test_wire_serialization_roundtrip(ref):
    """to_wire / from_wire is lossless for every section and rejects
    foreign or newer blobs."""
    blob = _port_blob(ref)
    data, inline, refs = blob.to_wire(None)
    assert not refs and len(inline) == blob.n_valid_pages
    back = SequenceBlob.from_wire(data)
    assert back.to_wire(None)[0] == data
    assert (back.length, back.emitted, back.cur_token) == \
        (blob.length, blob.emitted, blob.cur_token)
    for f in blob.kv:
        np.testing.assert_array_equal(blob.kv[f], back.kv[f], err_msg=f)
    with pytest.raises(ValueError, match="magic"):
        SequenceBlob.from_wire(b"XXXX" + data[4:])
    with pytest.raises(ValueError, match="version"):
        SequenceBlob.from_wire(data[:4] + bytes([99]) + data[5:])


def test_transport_dedup_accounting(ref):
    """Repeat transfers ship references; the receiver rebuilds the blob
    bit for bit; an unknown reference fails loudly; the meters add up."""
    blob = _port_blob(ref)
    tr = LoopbackTransport(dedup=True)
    d1 = tr.send(blob, "decode0")
    assert tr.recv(d1, "decode0").to_wire(None)[0] == blob.to_wire(None)[0]
    d2 = tr.send(blob, "decode0")
    assert len(d2) < len(d1)
    assert tr.recv(d2, "decode0").to_wire(None)[0] == blob.to_wire(None)[0]
    st = tr.stats
    assert st.n_transfers == 2
    assert st.pages_ref == st.pages_inline == blob.n_valid_pages
    assert st.wire_bytes == len(d1) + len(d2)
    assert st.wire_bytes_nodedup == 2 * len(d1)
    assert st.raw_bytes == 2 * blob.raw_bytes
    assert st.model_ns > 0 and st.model_ns_raw > st.model_ns or \
        not ref["codec_on"]
    assert len(tr.send(blob, "decode1")) == len(d1)
    with pytest.raises(ValueError, match="unknown page digest"):
        LoopbackTransport(dedup=True).recv(d2, "decode0")


def test_transport_dedup_off_is_codec_only(ref):
    blob = _port_blob(ref)
    tr = LoopbackTransport(dedup=False)
    d1 = tr.send(blob, "x")
    d2 = tr.send(blob, "x")
    assert d1 == d2
    assert tr.stats.pages_ref == 0
    assert tr.stats.wire_bytes == tr.stats.wire_bytes_nodedup


# ---------------------------------------------------------------------------
# chip_smoke.py's teacher-forced gate for disaggregated vs monolithic
# ---------------------------------------------------------------------------


class _FakeCapture:
    """``ops.CapturedStep`` on the CPU: the warm-up where the capture
    would run, the step on every replay."""

    def __init__(self, step, warmup, device):
        warmup()
        self.step = step

    def replay(self):
        self.step()


def test_chip_smoke_disagg_tie_paths(monkeypatch):
    """The card's check of a disaggregated-vs-monolithic divergence, run
    here on the tiny model (no card: graphs replaced by a stand-in, the
    probes' syncs by no-ops).  Its paths -- the prefill batch at position
    0, later the decode replica's state re-exported as a ``SequenceBlob``
    right after its import -- teacher-forced to any position predict the
    token both runs emitted there, with the monolithic path's logits; a
    divergence forced where the runs agree is no near-tie, and the gate
    raises on it."""
    import importlib.util
    import pathlib
    from repro_torch.kernels import ops
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(ops, "CapturedStep", _FakeCapture)

    _, trun = _runs(True)
    reqs = _requests()
    kw = dict(n_slots=4, max_len=MAXLEN, device="cpu")
    mono = ServeEngine(TCFG, trun, prefix_sharing=False, seed=3, **kw)
    mono_probe = cs.SharingProbe(mono)
    off = {r.uid: r.tokens for r in mono.run(reqs)[0]}
    params = mono.params
    dis = DisaggEngine(TCFG, trun, params=params, **kw)
    probe = cs.DisaggProbe(dis, reexport=True)
    res, st = dis.run(reqs)
    on = {r.uid: r.tokens for r in res}
    assert on == off
    assert probe.checked == st.n_transfers > 0
    paths_of = cs.disagg_paths(on, reqs, probe, mono_probe.batches)

    todo = [(u, p) for u in sorted(probe.post) for p in (0, len(on[u]) - 1)]
    for i in range(0, len(todo), 2):
        pairs = todo[i:i + 2]
        paths = [q for u, p in pairs for q in paths_of(u, p)]
        assert any(isinstance(q[0], SequenceBlob) for q in paths)
        logits = cs.teacher_forced_paths(TCFG, trun, params, paths, MAXLEN)
        for j, (u, p) in enumerate(pairs):
            a, b = logits[2 * j].float(), logits[2 * j + 1].float()
            assert int(a.argmax()) == int(b.argmax()) == on[u][p], (u, p)
            assert torch.equal(a, b), (u, p)     # one CPU, the same bits

    uid, pos = todo[-1]
    with pytest.raises(AssertionError) as err:
        cs.check_ties("disagg", "forced", TCFG, trun, params, {uid: pos},
                      on, off, paths_of, MAXLEN, cs.describe_disagg_path,
                      ("disagg", "mono"))
    assert err.value.args[0][:3] == ("forced", uid, pos)
