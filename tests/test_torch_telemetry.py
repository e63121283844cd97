"""The port's telemetry (``repro_torch.serve.telemetry``, a copy of the
reference's) and its use in the serving loop, against the reference on
numpy-seeded inputs: the registry's kinds, snapshot, load and merge and
the stats helpers equal the reference's; on the reference telemetry
test's mix (tiny dense model, block 4, prefix sharing on, weights
bridged) the port's ``ServeEngine`` records the reference's spans (names,
lanes and arguments, in order) and ``sync_metrics`` the reference's
counter names and values; the port's span tree passes
``scripts/trace_summary.py``'s ``validate``, summed span bytes equal the
counters, a disabled tracer changes no stream and no step count, the
disaggregated fleet's trace round-trips through the summarizer, and the
METRICS RPC merges two socket replicas' registries."""

import importlib.util
import json
import math
import pathlib
import socket
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModel, RunConfig as JRun
from repro.core.collectives import CodecConfig as JCodec
from repro.serve import Request as JRequest, ServeEngine as JEngine
from repro.serve import telemetry as jtel
from repro_torch.configs.base import ModelConfig as TModel
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.core.collectives import CodecConfig as TCodec
from repro_torch.models.params import from_jax_params
from repro_torch.serve import (DecodeReplica, DisaggEngine, PageHost,
                               Request, ServeEngine, SocketTransport)
from repro_torch.serve import telemetry as ttel
from repro_torch.serve.net import framing as fr

torch.set_num_threads(2)

KW = dict(name="t1", family="dense", n_layers=2, d_model=64, n_heads=8,
          n_kv_heads=4, d_ff=128, vocab_size=500, head_dim=16)
TCFG = TModel(**KW)
MAXLEN = 64
# fields of ServeStats that do not depend on clocks
DETERMINISTIC = (
    "n_requests", "n_tokens", "decode_steps", "n_dispatches",
    "n_admit_dispatches", "n_replay_dispatches", "shared_page_hits",
    "peak_pages", "peak_cache_bytes", "peak_cache_raw_bytes",
    "decode_backend", "cache_hot_hits", "cache_spilled_pages",
    "cache_spilled_bytes", "cache_fetched_pages", "cache_fetched_bytes",
    "cache_reprefill_cols", "cache_evicted_cols", "weights_compressed",
    "weight_backend", "weight_bytes_per_step", "weight_raw_bytes_per_step",
    "eager_steps", "flush_steps", "graph_replays", "graph_captures")


def _requests(cls=Request, n=4):
    """The reference telemetry test's mix (a repeated prompt, so that
    columns spill and hit)."""
    rng = np.random.default_rng(23)
    a = rng.integers(0, 500, (12,)).astype(np.int32)
    prompts = [a, rng.integers(0, 500, (9,)).astype(np.int32), a.copy(),
               rng.integers(0, 500, (16,)).astype(np.int32)]
    return [cls(uid=i, prompt=prompts[i % 4], max_new_tokens=3 + i % 3)
            for i in range(n)]


def _load_trace_summary():
    path = (pathlib.Path(__file__).resolve().parents[1]
            / "scripts" / "trace_summary.py")
    spec = importlib.util.spec_from_file_location("trace_summary", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _span_bytes(tracer, names, key):
    return sum(int(ev["args"].get(key, 0)) for ev in tracer.events
               if ev["name"] in names)


def _untimed(tracer):
    return [(ev["name"], ev["cat"], ev["pid"], ev["tid"], ev["args"])
            for ev in tracer.events]


@pytest.fixture(scope="module")
def ref():
    """The reference engine on the mix, traced; its registry snapshot
    (a fresh copy per call); the bridged weights."""
    jrun = JRun(codec=JCodec(cache_block=4))
    tracer = jtel.Tracer(enabled=True)
    je = JEngine(JModel(**KW), jrun, tp=1, n_slots=2, max_len=MAXLEN,
                 seed=1, max_fuse_steps=1, tracer=tracer)
    res, st = je.run(_requests(JRequest))
    return dict(res=res, stats=st, tracer=tracer,
                snap=je.registry.snapshot,
                params=from_jax_params(jax.device_get(je.params)),
                trun=TRun(codec=TCodec(cache_block=4)))


def _engine(ref, **kw):
    return ServeEngine(TCFG, ref["trun"], n_slots=2, max_len=MAXLEN,
                       params=ref["params"], max_fuse_steps=1, device="cpu",
                       **kw)


def _ops(mod):
    """One fixed sequence of registry operations."""
    rng = np.random.default_rng(31)
    regs = []
    for j in range(3):
        r = mod.MetricsRegistry()
        r.counter("serve.tokens").inc(int(rng.integers(1, 50)))
        r.counter("serve.tokens").inc()
        r.counter("link.model_ns").inc(float(rng.random()))
        r.gauge("serve.peak_pages", agg="max").set(int(rng.integers(0, 9)))
        r.gauge("serve.wall_s").set(float(rng.random()))
        r.gauge("x.last", agg="last").set(j)
        for v in rng.random(3):
            r.histogram("latency.request_s").observe(float(v))
        regs.append(r)
    snaps = [r.snapshot() for r in regs]
    out = dict(snaps=snaps, merged=mod.MetricsRegistry.merge(snaps),
               loaded=mod.MetricsRegistry().load(snaps[0]).snapshot(),
               value=regs[0].value("serve.tokens"),
               missing=regs[0].value("nope", default=-1),
               hist=regs[1].values_of("latency.request_s"),
               not_hist=regs[1].values_of("serve.tokens"))
    for bad in (lambda: regs[0].gauge("serve.tokens"),
                lambda: regs[0].counter("latency.request_s"),
                lambda: mod.MetricsRegistry.merge([{"version": 9}]),
                lambda: regs[0].gauge("y", agg="median")):
        with pytest.raises((TypeError, ValueError)) as e:
            bad()
        out.setdefault("errors", []).append((type(e.value), str(e.value)))
    return out


def test_registry_snapshot_load_merge_match_reference():
    assert _ops(ttel) == _ops(jtel)
    assert ttel.SNAPSHOT_VERSION == jtel.SNAPSHOT_VERSION
    assert ttel.ENGINE_LANE == jtel.ENGINE_LANE


def test_helpers_match_reference():
    rng = np.random.default_rng(37)
    for n in (0, 1, 7, 40):
        vals = rng.exponential(size=n).tolist()
        assert ttel.summarize_latencies(vals) == \
            jtel.summarize_latencies(vals)
    dicts = [{k: int(v) for k, v in zip("abcd", rng.integers(0, 9, 4))
              if rng.random() < 0.7} for _ in range(5)]
    assert ttel.sum_counters(dicts) == jtel.sum_counters(dicts)
    assert ttel.sum_counters(dicts, ["a", "z"]) == \
        jtel.sum_counters(dicts, ["a", "z"])
    s = ttel.summarize_latencies([0.4, 0.1, 0.9, 0.2])
    assert math.isclose(s["p95"], float(np.percentile([0.4, 0.1, 0.9, 0.2],
                                                      95)))


def test_tracer_matches_reference():
    """The same lifecycle calls record the same events (all but their
    clocks) and the same Chrome-trace metadata in both packages."""
    def drive(mod):
        tr = mod.Tracer(enabled=True)
        tr.request_begin(0, pid="serve", args={"prompt_len": 3})
        tr.stage(0, "queue")
        tr.stage(0, "admit", args={"mode": "cold"})
        tr.request_begin(1, pid="prefill0")
        tr.stage(1, "queue")
        tr.emit("admit_batch", cat="dispatch", pid="serve",
                tid=mod.ENGINE_LANE, t0=tr.now(), t1=tr.now(),
                args={"batch": 2})
        tr.stage_end(0, args={"extra": 1})
        tr.request_span(1, "wire", t0=tr.now(), t1=tr.now(),
                        args={"wire_bytes": 7})
        tr.instant("mark", cat="x", pid="serve", tid=0)
        tr.request_end(0, args={"stop_reason": "budget"})
        open_ = tr.open_requests()
        tr.request_end(1)
        meta = [e for e in tr.to_chrome_trace()["traceEvents"]
                if e["ph"] == "M"]
        return _untimed(tr), open_, meta

    assert drive(ttel) == drive(jtel)
    off = ttel.Tracer(enabled=False)
    off.request_begin(0, pid="x")
    off.stage(0, "admit")
    off.request_end(0)
    assert off.events == [] and off.now() == 0


def test_serving_spans_and_metrics_match_reference(ref):
    """On the same mix the port's engine records the reference's spans
    (names, lanes, arguments, in order), its ``sync_metrics`` the
    reference's counters and gauges (``serve.pool_bytes`` is the port's
    own pool layout; ``serve.wall_s`` a clock) and as many histogram
    samples; the stats view reads the same numbers."""
    tracer = ttel.Tracer(enabled=True)
    eng = _engine(ref, tracer=tracer)
    res, st = eng.run(_requests())
    assert [r.tokens for r in res] == [r.tokens for r in ref["res"]]
    assert _untimed(tracer) == _untimed(ref["tracer"])
    snap, want = eng.registry.snapshot(), ref["snap"]()
    assert snap["counters"].pop("serve.admit_compiles") == 0  # no jit
    assert want["counters"].pop("serve.admit_compiles") > 0
    assert snap["counters"] == want["counters"]
    skip = ("serve.pool_bytes", "serve.wall_s")
    assert {k: v for k, v in snap["gauges"].items() if k not in skip} == \
        {k: v for k, v in want["gauges"].items() if k not in skip}
    assert snap["gauges"].keys() == want["gauges"].keys()
    assert {k: len(v["values"]) for k, v in snap["hists"].items()} == \
        {k: len(v["values"]) for k, v in want["hists"].items()}
    for f in DETERMINISTIC[:-4]:
        if f not in ("decode_backend", "weight_backend"):
            assert getattr(st, f) == getattr(ref["stats"], f), f


def test_span_tree_and_byte_accounting(ref):
    """Every request closes one root span its children nest in
    (``trace_summary.validate``); summed span bytes equal the counters."""
    tracer = ttel.Tracer(enabled=True)
    eng = _engine(ref, tracer=tracer)
    results, st = eng.run(_requests())
    assert tracer.open_requests() == []
    roots = [ev for ev in tracer.events if ev["name"] == "request"]
    assert sorted(ev["args"]["uid"] for ev in roots) == [0, 1, 2, 3]
    errors = []
    _load_trace_summary().validate(
        [dict(ev, ts=ev["ts"] / 1e3, dur=ev["dur"] / 1e3)
         for ev in tracer.events], errors)
    assert errors == []
    reg = eng.registry
    assert st.cache_spilled_bytes > 0
    assert _span_bytes(tracer, ("cache_spill",), "bytes") == \
        reg.value("cache.spilled_bytes") == st.cache_spilled_bytes
    assert _span_bytes(tracer, ("cache_fetch",), "bytes") == \
        reg.value("cache.fetched_bytes") == st.cache_fetched_bytes
    assert _span_bytes(tracer, ("decode_window",), "weight_bytes") == \
        reg.value("weights.hbm_bytes") == \
        st.decode_steps * st.weight_bytes_per_step
    assert st.ttft_p95_s >= st.ttft_p50_s > 0
    assert len(reg.values_of("latency.request_s")) == len(results)


def test_disabled_tracer_identity(ref):
    """Tracing on or off: the same streams, stats and step counts."""
    off = _engine(ref)
    res_off, st_off = off.run(_requests())
    on = _engine(ref, tracer=ttel.Tracer(enabled=True))
    res_on, st_on = on.run(_requests())
    assert [(r.tokens, r.stop_reason) for r in res_off] == \
        [(r.tokens, r.stop_reason) for r in res_on]
    for f in DETERMINISTIC:
        assert getattr(st_off, f) == getattr(st_on, f), f
    assert off.decoder.counts == on.decoder.counts


def test_disagg_wire_bytes_and_trace_roundtrip(ref, tmp_path):
    """The fleet's spans: export, wire, wire_chunk, import, decode; wire
    bytes in the trace equal the transport's counter and the stats; the
    Chrome trace passes the summarizer's check, a duplicated root fails
    it."""
    tracer = ttel.Tracer(enabled=True)
    eng = DisaggEngine(TCFG, ref["trun"], n_decode=2, n_slots=2,
                       max_len=MAXLEN, params=ref["params"], streaming=True,
                       tracer=tracer, device="cpu")
    results, st = eng.run(_requests())
    assert tracer.open_requests() == []
    names = {ev["name"] for ev in tracer.events}
    assert {"request", "admit", "export", "wire", "import", "decode",
            "wire_chunk"} <= names
    wire = _span_bytes(tracer, ("wire", "wire_chunk"), "wire_bytes")
    assert wire == eng.transport.registry.value("transport.wire_bytes") \
        == st.wire_bytes > 0
    assert st.ttft_p95_s >= st.ttft_p50_s > 0
    assert all(r.ttft_s > 0 for r in results)
    ts = _load_trace_summary()
    path = tmp_path / "trace.json"
    tracer.write(str(path))
    trace = json.loads(path.read_text())
    assert {e["ph"] for e in trace["traceEvents"]} == {"M", "X"}
    assert ts.main([str(path), "--check"]) == 0
    root = next(e for e in trace["traceEvents"]
                if e["ph"] == "X" and e["name"] == "request")
    bad = dict(trace, traceEvents=trace["traceEvents"] + [dict(root)])
    badp = tmp_path / "bad.json"
    badp.write_text(json.dumps(bad))
    assert ts.main([str(badp), "--check"]) == 1


def _start_host(ref):
    eng = _engine(ref)
    fp = fr.config_fingerprint(TCFG, ref["trun"].codec, 1, 2, MAXLEN, 1)
    host = PageHost(DecodeReplica(eng), fp, max_store_pages=4096)
    listener = socket.create_server(("127.0.0.1", 0))

    def serve():
        try:
            host.serve_forever(listener, once=True)
        except OSError:
            pass

    threading.Thread(target=serve, daemon=True).start()
    return listener, listener.getsockname()[1]


def test_metrics_rpc_two_replica_merge(ref):
    l1, p1 = _start_host(ref)
    l2, p2 = _start_host(ref)
    tr = SocketTransport()
    eng = DisaggEngine(TCFG, ref["trun"], n_slots=2, max_len=MAXLEN,
                       seed=1, params=ref["params"], transport=tr,
                       streaming=True, device="cpu",
                       decode_addrs=[f"127.0.0.1:{p1}", f"127.0.0.1:{p2}"])
    try:
        results, st = eng.run(_requests())
        assert [r.tokens for r in results] == [r.tokens for r in ref["res"]]
        snaps = [tr.metrics(d) for d in ("decode0", "decode1")]
        assert all(s["version"] == ttel.SNAPSHOT_VERSION for s in snaps)
        per = [s["counters"].get("serve.tokens", 0) for s in snaps]
        assert all(n > 0 for n in per)
        merged = ttel.MetricsRegistry.merge(snaps)
        assert merged["counters"]["serve.tokens"] == sum(per)
        fleet = eng.metrics_snapshot()
        assert fleet["counters"]["transport.wire_bytes"] == st.wire_bytes
        assert fleet["counters"]["serve.tokens"] >= sum(per)
        assert fleet["hists"]["latency.transfer_s"]["values"]
        assert json.loads(json.dumps(fleet)) == fleet
    finally:
        tr.close()
        l1.close()
        l2.close()
