"""The port's multi-process page transport (``repro_torch.serve.net``,
device="cpu"), the counterparts of the reference's ``tests/test_net.py``:
socket framing is loud on truncation and corruption, the hello handshake
refuses version and config mismatches, a mid-stream disconnect leaves the
receiving pool untouched, the receiver's digest store is LRU-bounded with
eviction and re-send accounting, FETCH pulls pages back by digest, a
failed import keeps the pool and the session, and a ``DisaggEngine``
driving decode replicas over ``SocketTransport`` (a host thread in
process, and a second OS process started by ``launch.disagg_host``)
serves the monolithic engine's streams.  Across packages: the reference's
driver (JAX prefill, its ``SocketTransport``) serves through the port's
``PageHost`` (weights bridged, backends "auto") with the same streams."""

import dataclasses
import socket
import struct
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModel, RunConfig as JRun
from repro.core.collectives import CodecConfig as JCodec
from repro.serve import DisaggEngine as JDisagg, ServeEngine as JEngine
from repro.serve import Request as JRequest
from repro.serve import SocketTransport as JSocketTransport
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.collectives import CodecConfig
from repro_torch.models.params import from_jax_params
from repro_torch.serve import (DecodeReplica, DigestStore, DisaggEngine,
                               LoopbackTransport, PageHost, Request,
                               ServeEngine, SocketTransport)
from repro_torch.serve.disagg import Handoff, PrefillReplica
from repro_torch.serve.net import framing as fr
from repro_torch.serve.transport import (_page_digest, pack_chunk,
                                         unpack_chunk)

torch.set_num_threads(2)

RNG = np.random.default_rng(11)

KW = dict(name="t1", family="dense", n_layers=2, d_model=64, n_heads=8,
          n_kv_heads=4, d_ff=128, vocab_size=500, head_dim=16)
CFG = ModelConfig(**KW)
MAXLEN = 64


def _run_cfg(codec_on=True):
    return RunConfig(codec=CodecConfig(cache_block=4) if codec_on
                     else dataclasses.replace(CodecConfig.off(),
                                              cache_block=4))


def _engine(run, **kw):
    return ServeEngine(CFG, run, n_slots=2, max_len=MAXLEN,
                       seed=kw.pop("seed", 1), device="cpu", **kw)


def _requests(n=4, cls=Request):
    rng = np.random.default_rng(11)
    a = rng.integers(0, 500, (12,)).astype(np.int32)
    prompts = [a, rng.integers(0, 500, (9,)).astype(np.int32), a.copy(),
               rng.integers(0, 500, (16,)).astype(np.int32)]
    return [cls(uid=i, prompt=prompts[i % 4], max_new_tokens=3 + i % 3)
            for i in range(n)]


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


def test_frame_roundtrip_and_truncation():
    a, b = socket.socketpair()
    try:
        fr.send_frame(a, fr.MSG_STEP, b"payload")
        msg, payload = fr.recv_frame(b)
        assert (msg, payload) == (fr.MSG_STEP, b"payload")
        # a frame cut mid-payload is loud, not a short read
        full = struct.pack("<IB", 101, fr.MSG_SEQ) + b"x" * 50
        a.sendall(full)
        a.close()
        with pytest.raises(fr.FrameError, match="mid-frame"):
            fr.recv_frame(b)
    finally:
        b.close()


def test_frame_oversize_length_rejected():
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack("<IB", fr.MAX_FRAME + 1, fr.MSG_STEP))
        with pytest.raises(fr.FrameError, match="length"):
            fr.recv_frame(b)
        with pytest.raises(fr.FrameError):
            fr.send_frame(a, fr.MSG_STEP, b"x" * fr.MAX_FRAME)
    finally:
        a.close()
        b.close()


def test_chunk_pack_unpack_and_corruption():
    entries = [(0, 0, 0, b"abcdef" * 10), (1, 1, 2, b"zyxw" * 12)]
    data, inline, refs = pack_chunk(7, entries, known=None)
    assert len(inline) == 2 and not refs
    seq_id, out = unpack_chunk(data)
    assert seq_id == 7
    assert [(t, l, c) for t, l, c, _, _, _ in out] == \
           [(0, 0, 0), (1, 1, 2)]
    assert all(tag == 0 and _page_digest(body) == digest
               for _, _, _, tag, digest, body in out)
    # known digests become refs
    data2, inline2, refs2 = pack_chunk(
        8, entries, known={_page_digest(entries[0][3])})
    assert len(inline2) == 1 and len(refs2) == 1
    # corrupted payload length / truncation / magic / version: all loud
    with pytest.raises(ValueError, match="magic"):
        unpack_chunk(b"XXXX" + data[4:])
    with pytest.raises(ValueError, match="version"):
        unpack_chunk(data[:4] + bytes([99]) + data[5:])
    with pytest.raises(ValueError, match="truncated|overruns"):
        unpack_chunk(data[:-5])
    with pytest.raises(ValueError, match="truncated"):
        unpack_chunk(data[:6])
    # bump the first entry's payload length field past the frame end
    hdr_end = 4 + 1 + 4 + 2          # magic, version, seq_id, n_entries
    len_off = hdr_end + 7 + 12       # entry header + digest
    bad = (data[:len_off] + struct.pack("<I", 10_000)
           + data[len_off + 4:])
    with pytest.raises(ValueError, match="overruns"):
        unpack_chunk(bad)


def test_digest_store_lru_pins_and_verification():
    store = DigestStore(max_pages=3)
    payloads = [bytes([i]) * 8 for i in range(5)]
    digests = [_page_digest(p) for p in payloads]
    for d, p in zip(digests[:3], payloads[:3]):
        store[d] = p
    store.pin(1, digests[0])          # in-flight stream protects entry 0
    store[digests[3]] = payloads[3]
    store[digests[4]] = payloads[4]
    assert store.trim() == 2          # bounded again, pinned survived
    assert len(store) == 3 and digests[0] in store
    assert digests[1] not in store and digests[2] not in store
    store.release(1)
    store[digests[1]] = payloads[1]
    assert store.trim() == 1          # now entry 0 is evictable
    assert digests[0] not in store
    assert store.n_evicted == 3
    # corrupted payloads are rejected at ingest
    with pytest.raises(ValueError, match="digest"):
        store[digests[0]] = b"not the payload"


def test_loopback_store_eviction_and_resend_accounting():
    """A too-small receiver store forgets pages; the sender's next
    transfer re-inlines them and the stats ledger shows both sides."""
    run = _run_cfg(True)
    eng = _engine(run)
    pr = PrefillReplica(eng)
    pr.submit(Request(uid=0, prompt=RNG.integers(0, 500, (16,)
                                                 ).astype(np.int32),
                      max_new_tokens=4))
    eng._admit_phase(pr.ls)
    blob = pr._export_blob(0)
    assert blob.n_valid_pages > 1
    tr = LoopbackTransport(max_store_pages=1)
    d1 = tr.send(blob, "d")
    tr.recv(d1, "d")
    assert len(tr.store("d")) == 1            # trimmed at the boundary
    assert tr.stats.store_evicted == blob.n_valid_pages - 1
    d2 = tr.send(blob, "d")
    tr.recv(d2, "d")
    st = tr.stats
    assert st.pages_resent == blob.n_valid_pages - 1
    assert st.pages_ref == 1                  # only the survivor deduped
    # big store: second send is all refs, nothing resent
    tr2 = LoopbackTransport(max_store_pages=4096)
    tr2.recv(tr2.send(blob, "d"), "d")
    tr2.recv(tr2.send(blob, "d"), "d")
    assert tr2.stats.pages_resent == 0
    assert tr2.stats.pages_ref == blob.n_valid_pages


# ---------------------------------------------------------------------------
# socket sessions (threaded host in-process)
# ---------------------------------------------------------------------------


def _fingerprint(run, tp=1, n_slots=2, max_len=MAXLEN, seed=1):
    return fr.config_fingerprint(CFG, run.codec, tp, n_slots, max_len, seed)


def _start_host(run, once=True, seed=1, max_store_pages=4096,
                params=None):
    eng = _engine(run, seed=seed, params=params)
    host = PageHost(DecodeReplica(eng), _fingerprint(run, seed=seed),
                    max_store_pages=max_store_pages)
    listener = socket.create_server(("127.0.0.1", 0))
    port = listener.getsockname()[1]

    def serve():
        try:
            host.serve_forever(listener, once=once)
        except OSError:
            pass                     # listener closed by the test

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return host, listener, port, eng


def test_socket_disagg_identity_threaded():
    """DisaggEngine over SocketTransport (host in a thread, full TCP
    framing): streams byte-identical to the monolithic engine; wire
    accounting matches what loopback meters for the same transfers."""
    run = _run_cfg(True)
    reqs = _requests()
    res_m, _ = _engine(run).run(reqs)
    loop = DisaggEngine(CFG, run, n_prefill=1, n_decode=1, n_slots=2,
                        max_len=MAXLEN, seed=1, streaming=True,
                        device="cpu")
    res_l, st_l = loop.run(reqs)

    host, listener, port, dec_eng = _start_host(run)
    tr = SocketTransport()
    dis = DisaggEngine(CFG, run, n_prefill=1, n_slots=2,
                       max_len=MAXLEN, seed=1, transport=tr, streaming=True,
                       decode_addrs=[f"127.0.0.1:{port}"], device="cpu")
    res_s, st_s = dis.run(reqs)
    tr.close()
    listener.close()
    for x, y, z in zip(res_m, res_s, res_l):
        assert x.tokens == y.tokens == z.tokens, x.uid
        assert x.stop_reason == y.stop_reason
    # same sequences, same dedup decisions -> identical data-plane bytes
    assert st_s.wire_bytes == st_l.wire_bytes
    assert st_s.pages_streamed == st_l.pages_streamed
    assert st_s.decode_prefix_hits == st_l.decode_prefix_hits
    dec_eng.drop_cache()
    assert dec_eng._pages_in_use() == 0


def test_socket_hello_mismatches_refused():
    """Version/magic/fingerprint mismatches kill the session before any
    page moves; the host keeps serving afterwards."""
    run = _run_cfg(True)
    host, listener, port, dec_eng = _start_host(run, once=False)
    try:
        # config fingerprint mismatch (e.g. different seed) -> refused
        tr = SocketTransport()
        with pytest.raises(RuntimeError, match="fingerprint"):
            tr.connect("d", "127.0.0.1", port,
                       _fingerprint(run, seed=999))
        # wire-version mismatch inside the hello -> refused
        with socket.create_connection(("127.0.0.1", port)) as s:
            bad = fr._HELLO.pack(fr.PROTO_MAGIC, fr.PROTO_VERSION,
                                 fr.WIRE_VERSION + 1,
                                 _fingerprint(run))
            fr.send_frame(s, fr.MSG_HELLO, bad)
            msg, payload = fr.recv_frame(s)
            assert msg == fr.MSG_ERROR
            assert b"wire-format" in payload
        # protocol magic mismatch -> refused
        with socket.create_connection(("127.0.0.1", port)) as s:
            bad = fr._HELLO.pack(b"NOPE", fr.PROTO_VERSION,
                                 fr.WIRE_VERSION, _fingerprint(run))
            fr.send_frame(s, fr.MSG_HELLO, bad)
            msg, payload = fr.recv_frame(s)
            assert msg == fr.MSG_ERROR and b"magic" in payload
        # a good session still works after all those refusals
        tr2 = SocketTransport()
        tr2.connect("d", "127.0.0.1", port, _fingerprint(run))
        assert tr2.inventory("d") == set()
        tr2.close()
        assert dec_eng._pages_in_use() == 0
    finally:
        listener.close()


def test_socket_midstream_disconnect_pool_untouched():
    """A driver that dies mid-stream (chunks sent, no closing blob) leaves
    the decode pool untouched; its pins are released so the staged pages
    become ordinary LRU content, and the next session serves normally."""
    run = _run_cfg(True)
    host, listener, port, dec_eng = _start_host(run, once=False)
    try:
        with socket.create_connection(("127.0.0.1", port)) as s:
            fr.send_frame(s, fr.MSG_HELLO, fr.pack_hello(_fingerprint(run)))
            msg, _ = fr.recv_frame(s)
            assert msg == fr.MSG_HELLO_OK
            data, _, _ = pack_chunk(1, [(0, 0, 0, b"payload" * 16)])
            fr.send_frame(s, fr.MSG_PAGE_CHUNK, data)
            msg, _ = fr.recv_frame(s)
            assert msg == fr.MSG_CHUNK_OK
            # a corrupted chunk answers ERROR and the session survives
            fr.send_frame(s, fr.MSG_PAGE_CHUNK, b"garbage")
            msg, payload = fr.recv_frame(s)
            assert msg == fr.MSG_ERROR and b"chunk" in payload
            fr.send_frame(s, fr.MSG_STATUS_REQ)
            msg, payload = fr.recv_frame(s)
            assert msg == fr.MSG_STATUS
            # die abruptly, mid-stream: no BYE, no closing blob
        assert dec_eng._pages_in_use() == 0
        # the staged page is unpinned at session teardown (the host thread
        # notices the dead socket asynchronously)
        deadline = time.time() + 10
        while host.store._pin_count and time.time() < deadline:
            time.sleep(0.05)
        assert not host.store._pin_count
        # next session: a full serving run against the same host
        reqs = _requests()
        res_m, _ = _engine(run).run(reqs)
        tr = SocketTransport()
        dis = DisaggEngine(CFG, run, n_prefill=1, n_slots=2,
                           max_len=MAXLEN, seed=1, transport=tr,
                           streaming=True, device="cpu",
                           decode_addrs=[f"127.0.0.1:{port}"])
        res_s, _ = dis.run(reqs)
        tr.close()
        for x, y in zip(res_m, res_s):
            assert x.tokens == y.tokens, x.uid
        dec_eng.drop_cache()
        assert dec_eng._pages_in_use() == 0
    finally:
        listener.close()


def test_pack_pages_roundtrip_and_corruption():
    """The FETCH_OK payload codec is lossless and loud on truncation or
    trailing garbage."""
    pages = {_page_digest(b"a" * 9): b"a" * 9, _page_digest(b"bb"): b"bb"}
    data = fr.pack_pages(pages)
    assert fr.unpack_pages(data) == pages
    assert fr.unpack_pages(fr.pack_pages({})) == {}
    with pytest.raises(fr.FrameError, match="overruns"):
        fr.unpack_pages(data[:-1])
    with pytest.raises(fr.FrameError, match="trailing"):
        fr.unpack_pages(data + b"x")


def test_socket_fetch_by_digest():
    """FETCH pulls pages back OUT of the host's digest store (the remote
    tier of the tiered PageCache): the reply is the held subset — a
    missing digest is not an error — and the transport meters the fetch;
    STATUS reports store occupancy and capacity."""
    run = _run_cfg(True)
    host, listener, port, dec_eng = _start_host(run, once=False)
    try:
        tr = SocketTransport()
        tr.connect("d", "127.0.0.1", port, _fingerprint(run))
        st = tr.status("d")
        assert st["store_pages"] == 0 and st["store_capacity"] == 4096
        # stage two pages into the host store via a streamed chunk
        bodies = [b"payload-a" * 8, b"payload-b" * 8]
        data, _, _ = pack_chunk(3, [(0, 0, i, b)
                                    for i, b in enumerate(bodies)])
        fr.send_frame(tr._socks["d"], fr.MSG_PAGE_CHUNK, data)
        msg, _ = fr.recv_frame(tr._socks["d"])
        assert msg == fr.MSG_CHUNK_OK
        digests = [_page_digest(b) for b in bodies]
        missing = _page_digest(b"never shipped")
        got = tr.fetch("d", digests + [missing])
        assert got == dict(zip(digests, bodies))
        assert tr.stats.pages_fetched == 2
        assert tr.stats.fetch_bytes == sum(len(b) for b in bodies)
        assert int(tr.status("d")["store_pages"]) == 2
        # the host-side replica's remote tier reads the same store
        assert host._fetch_pages([digests[0]]) == {digests[0]: bodies[0]}
        tr.close()
    finally:
        listener.close()


def test_socket_import_failure_keeps_pool_and_session():
    """A blob the receiver cannot resolve (unknown digest: its store was
    built by a DIFFERENT session) answers ERROR with the pool untouched."""
    run = _run_cfg(True)
    eng = _engine(run)
    pr = PrefillReplica(eng)
    pr.submit(Request(uid=0, prompt=RNG.integers(0, 500, (12,)
                                                 ).astype(np.int32),
                      max_new_tokens=2))
    eng._admit_phase(pr.ls)
    blob = pr._export_blob(0)
    data_refs, _, refs = blob.to_wire(
        {d for _, _, _, p in blob.page_entries()
         for d in [_page_digest(p)]})
    assert refs                               # all pages are references
    host, listener, port, dec_eng = _start_host(run, once=False)
    try:
        tr = SocketTransport()
        tr.connect("d", "127.0.0.1", port, _fingerprint(run))
        meta = {"uid": 0, "prompt": [int(t) for t in pr.ls.slot_req[0].prompt],
                "max_new_tokens": 2, "eos_id": None, "stop_seqs": None,
                "seq_id": None}
        sock = tr._socks["d"]
        fr.send_frame(sock, fr.MSG_SEQ, fr.pack_seq(meta, data_refs))
        msg, payload = fr.recv_frame(sock)
        assert msg == fr.MSG_ERROR and b"unknown page digest" in payload
        assert dec_eng._pages_in_use() == 0
        assert not any(dec_eng._slot_busy)
        # the same session can still import the blob shipped inline
        slot = tr.deliver(Handoff(req=pr.ls.slot_req[0], blob=blob,
                                  admit_t=0.0), "d")
        assert dec_eng._pages_in_use() > 0
        assert dec_eng.state is not None and slot == 0
        tr.close()
    finally:
        listener.close()


# ---------------------------------------------------------------------------
# two OS processes
# ---------------------------------------------------------------------------


def test_two_process_socket_identity():
    """A decode host in a second OS process (``launch.disagg_host
    --device cpu``), its weights drawn from the same seed as the driver's
    (their digests equal): the monolithic streams, with streaming export
    and receiver-side dedup on."""
    from repro_torch.launch.disagg_host import (param_digest,
                                                spawn_decode_host,
                                                stop_child,
                                                tiny_bench_config)
    cfg = tiny_bench_config()
    run = RunConfig(codec=CodecConfig(cache_block=8))
    rng = np.random.default_rng(0)
    base = rng.integers(0, 512, (24,)).astype(np.int32)
    reqs = [Request(uid=0, prompt=base, max_new_tokens=6),
            Request(uid=1, prompt=rng.integers(0, 512, (16,)
                                               ).astype(np.int32),
                    max_new_tokens=3),
            Request(uid=2, prompt=base.copy(), max_new_tokens=4)]
    mono = ServeEngine(cfg, run, n_slots=2, max_len=96, seed=1,
                       device="cpu")
    res_m, _ = mono.run(reqs)
    proc, port, params = spawn_decode_host(
        ["--model", "tiny-bench", "--codec", "on", "--cache-block", "8",
         "--slots", "2", "--max-len", "96", "--seed", "1",
         "--device", "cpu"], timeout=120.0)
    try:
        assert params == param_digest(mono.params)
        tr = SocketTransport(timeout=60.0)
        dis = DisaggEngine(cfg, run, n_prefill=1, n_slots=2, max_len=96,
                           seed=1, transport=tr, streaming=True,
                           decode_addrs=[f"127.0.0.1:{port}"],
                           device="cpu")
        res_s, st = dis.run(reqs)
        tr.close()
        for x, y in zip(res_m, res_s):
            assert x.tokens == y.tokens, x.uid
            assert x.stop_reason == y.stop_reason
        assert st.n_transfers == len(reqs)
        assert st.pages_streamed > 0
        assert st.wire_bytes < st.wire_raw_bytes
        assert proc.wait(timeout=30) == 0     # --once: ends with the session
    finally:
        if proc.poll() is None:
            stop_child(proc)


def test_driver_role_trace_and_metrics(tmp_path, capsys):
    """``launch.disagg_host --role driver --check`` against a threaded
    decode host: the streams equal the monolithic engine's, the
    ``--trace-out`` file passes ``scripts/trace_summary.py``'s checks
    with one root span per request, and the ``--metrics-json`` snapshot
    folds in the host's METRICS RPC (its decode steps, its finished
    requests' latencies)."""
    import importlib.util
    import json
    import pathlib
    from repro_torch.launch import disagg_host
    cfg = disagg_host.tiny_bench_config()
    run = RunConfig(codec=CodecConfig(cache_block=8))
    eng = ServeEngine(cfg, run, n_slots=2, max_len=96, seed=1, device="cpu")
    rep = DecodeReplica(eng)
    host = PageHost(rep, fr.config_fingerprint(cfg, run.codec, 1, 2, 96, 1))
    listener = socket.create_server(("127.0.0.1", 0))
    port = listener.getsockname()[1]
    threading.Thread(target=host.serve_forever, args=(listener,),
                     kwargs=dict(once=True), daemon=True).start()
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.json"
    try:
        rc = disagg_host.main(
            ["--role", "driver", "--decode-addr", f"127.0.0.1:{port}",
             "--device", "cpu", "--check", "--requests", "4",
             "--trace-out", str(trace), "--metrics-json", str(metrics)])
    finally:
        listener.close()
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "check ok: 4 streams identical" in out
    path = (pathlib.Path(__file__).resolve().parents[1]
            / "scripts" / "trace_summary.py")
    spec = importlib.util.spec_from_file_location("trace_summary", path)
    ts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ts)
    errors = []
    spans = ts.load_events(str(trace), errors)
    ts.validate(spans, errors)
    assert errors == []
    roots = [ev for ev in spans if ev["name"] == "request"]
    assert sorted(ev["args"]["uid"] for ev in roots) == [0, 1, 2, 3]
    snap = json.loads(metrics.read_text())
    assert snap["counters"]["transport.wire_bytes"] > 0
    host_counters = rep.metrics_snapshot()["counters"]
    assert snap["counters"]["serve.decode_steps"] == \
        host_counters["serve.decode_steps"] > 0
    assert len(snap["hists"]["latency.request_s"]["values"]) == 4


def test_reference_driver_port_host():
    """The reference's driver (its prefill replica and ``SocketTransport``)
    through the port's ``PageHost`` (weights bridged from the driver's):
    the hello fingerprints agree with the backends at "auto", and the
    streams are the port's monolithic engine's."""
    jrun = JRun(codec=JCodec(cache_block=4))
    run = _run_cfg(True)
    je = JEngine(JModel(**KW), jrun, tp=1, n_slots=2, max_len=MAXLEN,
                 seed=1)
    params = from_jax_params(jax.device_get(je.params))
    res_m, _ = _engine(run, params=params).run(_requests())
    host, listener, port, dec_eng = _start_host(run, params=params)
    tr = JSocketTransport()
    try:
        dis = JDisagg(JModel(**KW), jrun, tp=1, n_prefill=1, n_slots=2,
                      max_len=MAXLEN, seed=1, params=je.params,
                      transport=tr, streaming=True, max_fuse_steps=1,
                      decode_addrs=[f"127.0.0.1:{port}"])
        res_s, st = dis.run(_requests(cls=JRequest))
        snap = tr.metrics("decode0")
        tr.close()
        for x, y in zip(res_m, res_s):
            assert x.tokens == y.tokens, x.uid
            assert x.stop_reason == y.stop_reason
        assert st.pages_streamed > 0 and st.dedup_page_refs > 0
        assert snap["counters"]["serve.tokens"] == \
            sum(len(r.tokens) for r in res_s)
        dec_eng.drop_cache()
        assert dec_eng._pages_in_use() == 0
    finally:
        listener.close()


def test_param_digest_is_position_dependent():
    """``launch.disagg_host.param_digest``: equal trees give equal
    digests; a swap of two elements, a pair of compensating changes in
    one leaf, or another dtype of the same bits change it."""
    from repro_torch.launch.disagg_host import param_digest
    g = torch.Generator().manual_seed(0)
    w = torch.randn(300, 64, generator=g).to(torch.bfloat16)
    tree = {"w": w, "n": torch.ones(3), "b": torch.arange(5, dtype=torch.uint8),
            "s": torch.tensor(1.5)}
    d = param_digest(tree)
    assert d == param_digest({k: v.clone() for k, v in tree.items()})
    swapped = w.clone().view(-1)
    swapped[[5, 9]] = swapped[[9, 5]]
    assert not torch.equal(swapped, w.view(-1))
    bits = w.clone().view(torch.int16).view(-1)
    bits[3] += 1
    bits[4] -= 1
    for leaf in (swapped.view(w.shape), bits.view(torch.bfloat16).view(
            w.shape), w.view(torch.int16)):
        assert param_digest(dict(tree, w=leaf)) != d
    b = tree["b"].clone()
    b[[0, 4]] = b[[4, 0]]
    assert param_digest(dict(tree, b=b)) != d
