"""The port's page transport (``repro_torch.serve.transport``), its
framing fingerprint and its link model (``repro_torch.hw.noc``) against
the reference's, on numpy-seeded inputs: streaming chunk frames and
``SequenceBlob`` wire bytes identical in both directions (codec on and
off, with and without ``known`` digests, with an SSM section), parse
errors alike, ``LoopbackTransport``'s accounting equal on the same
sequence of transfers (wire, codec-only, raw, references, re-sends,
evictions, fetches, modelled latency), ``config_fingerprint`` equal for
all 13 architectures, and ``LinkModel``, ``MeteredLink`` and ``simulate``
giving the same numbers."""

import dataclasses

import ml_dtypes
import numpy as np
import pytest

from repro.configs import _MODULES as J_MODULES
from repro.configs import get_config as j_get_config
from repro.configs import make_reduced as j_make_reduced
from repro.core.collectives import CodecConfig as JCodec
from repro.hw import noc as jnoc
from repro.serve import transport as jt
from repro.serve.net import framing as jfr
from repro.serve.telemetry import MetricsRegistry as JRegistry
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import make_reduced as t_make_reduced
from repro_torch.core.collectives import CodecConfig as TCodec
from repro_torch.hw import noc as tnoc
from repro_torch.serve import transport as tt
from repro_torch.serve.net import framing as tfr
from repro_torch.serve.telemetry import MetricsRegistry as TRegistry

J_ARCHS = sorted(J_MODULES)
BLK, W, K = 4, 128, 5
N = BLK * W


def _geometry(codec_on):
    codec = TCodec(cache_block=BLK)
    return dict(codec_on=codec_on, blk=BLK, w=W, k=K,
                esc_cap=codec.esc_capacity(N), npad=N)


def _fields(rng, codec_on, n_layers, n_cols):
    """Random page fields in the wire layout ``(1, L, cols, ...)`` (the
    port's dtypes: raw bf16 as uint16 bits)."""
    g = _geometry(codec_on)
    kv = tt.empty_page_fields(codec_on, 1, n_layers, n_cols, BLK, W, K,
                              g["esc_cap"], g["npad"])
    for f, a in kv.items():
        info = np.iinfo(a.dtype)
        kv[f] = rng.integers(info.min, info.max, a.shape, dtype=a.dtype,
                             endpoint=True)
    kv["ring"] = rng.integers(0, 1 << 16, (1, n_layers, BLK, W),
                              dtype=np.uint16)
    return kv


def _blobs(rng, codec_on, length, n_layers=2, ssm=False, repeat_from=None):
    """A (port, reference) pair of the same blob; ``repeat_from`` copies
    another blob's first page columns (dedup material)."""
    n_cols = length // BLK
    kv = _fields(rng, codec_on, n_layers, n_cols + 1)
    if repeat_from is not None:
        m = min(n_cols, repeat_from.n_cols)
        for f in kv:
            if f != "ring":
                kv[f][:, :, :m] = repeat_from.kv[f][:, :, :m]
    st = None
    if ssm:
        st = (rng.normal(size=(1, n_layers, 2, 8, 16)).astype(np.float32),
              rng.integers(0, 1 << 16, (1, n_layers, 3, 32), np.uint16),
              rng.integers(0, 1 << 16, (1, n_layers, 3, 32), np.uint16))
    kw = dict(tp=1, n_layers=n_layers, n_cols=n_cols + 1, length=length,
              cur_token=int(rng.integers(0, 500)),
              emitted=[int(t) for t in rng.integers(0, 500, 3)],
              **_geometry(codec_on))
    port = tt.SequenceBlob(kv=kv, ssm=st, **kw)

    def bf16(a):
        return a.view(ml_dtypes.bfloat16) if a.dtype == np.uint16 else a

    ref = jt.SequenceBlob(kv={f: bf16(a) for f, a in kv.items()},
                          ssm=None if st is None else tuple(
                              bf16(a) for a in st), **kw)
    return port, ref


@pytest.mark.parametrize("seed", [0, 1])
def test_chunk_frames_identical(seed):
    rng = np.random.default_rng(seed)
    bodies = [rng.bytes(int(n)) for n in rng.integers(1, 300, 6)]
    entries = [(0, int(l), int(c), b) for (l, c), b in
               zip([(0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (1, 2)], bodies)]
    entries.append(entries[1][:3] + (bodies[1],))       # a repeat in-frame
    for known in (None, set(), {tt._page_digest(bodies[0]),
                                tt._page_digest(bodies[4])}):
        got = tt.pack_chunk(9, entries, known)
        want = jt.pack_chunk(9, entries, known)
        assert got == want
        assert tt.unpack_chunk(want[0]) == jt.unpack_chunk(got[0])
    data = got[0]
    for bad in (b"XXXX" + data[4:], data[:4] + bytes([99]) + data[5:],
                data[:-5], data[:6], data + b"z"):
        with pytest.raises(ValueError) as e_t:
            tt.unpack_chunk(bad)
        with pytest.raises(ValueError) as e_j:
            jt.unpack_chunk(bad)
        assert str(e_t.value) == str(e_j.value)


@pytest.mark.parametrize("ssm", [False, True], ids=["kv", "kv+ssm"])
@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
def test_blob_wire_identical(codec_on, ssm):
    """``to_wire`` of the same blob is the same bytes in both packages,
    with no ``known`` set, an empty one and one that covers some pages
    (which then ship as references); each package parses the other's
    bytes (references resolved from its own ``DigestStore``) back to the
    same bytes."""
    rng = np.random.default_rng(3 + codec_on)
    a_t, a_j = _blobs(rng, codec_on, 13, ssm=ssm)
    assert a_t.raw_bytes == a_j.raw_bytes
    assert a_t.n_valid_pages == a_j.n_valid_pages == 2 * 3
    half = {tt._page_digest(p) for _, _, c, p in a_t.page_entries() if c < 2}
    for known in (None, set(), half):
        got, want = a_t.to_wire(known), a_j.to_wire(known)
        assert got == want
        data, inline, refs = got
        assert len(inline) + len(refs) == a_t.n_valid_pages
        st_t, st_j = tt.DigestStore(), jt.DigestStore()
        if known:
            for _, _, _, p in a_t.page_entries():
                st_t[tt._page_digest(p)] = p
                st_j[jt._page_digest(p)] = p
        back_t = tt.SequenceBlob.from_wire(data, st_t if known else None)
        back_j = jt.SequenceBlob.from_wire(data, st_j if known else None)
        assert back_t.to_wire(None)[0] == back_j.to_wire(None)[0] == \
            a_t.to_wire(None)[0]
        assert back_t.kv["ring"].dtype == np.uint16
        assert (back_t.length, back_t.cur_token, back_t.emitted) == \
            (back_j.length, back_j.cur_token, back_j.emitted)
    with pytest.raises(ValueError, match="unknown page digest"):
        tt.SequenceBlob.from_wire(a_t.to_wire(half)[0])
    data = a_t.to_wire(None)[0]
    for bad in (b"XXXX" + data[4:], data[:4] + bytes([2]) + data[5:],
                data[:20], data[:-3]):
        with pytest.raises(ValueError) as e_t:
            tt.SequenceBlob.from_wire(bad)
        with pytest.raises(ValueError) as e_j:
            jt.SequenceBlob.from_wire(bad)
        assert str(e_t.value) == str(e_j.value)


@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
def test_loopback_accounting_matches_reference(codec_on):
    """The same sequence of streamed chunks, aborts, closing blobs and
    fetches through both packages' ``LoopbackTransport`` (a store small
    enough to evict, dedup on; then dedup off): the same wire bytes and
    every ``TransportStats`` field equal, the modelled latencies too."""
    rng = np.random.default_rng(11 + codec_on)
    pairs = [_blobs(rng, codec_on, 17)]
    pairs.append(_blobs(rng, codec_on, 14, repeat_from=pairs[0][0]))
    pairs.append(_blobs(rng, codec_on, 9, repeat_from=pairs[0][0]))
    pairs.append(pairs[1])
    for dedup, cap in ((True, 7), (True, 4096), (False, 4096)):
        trs = (tt.LoopbackTransport(dedup=dedup, max_store_pages=cap),
               jt.LoopbackTransport(dedup=dedup, max_store_pages=cap))
        for i, (bt, bj) in enumerate(pairs):
            dst = "d1" if i == 3 else "d0"
            outs = []
            for tr, b in zip(trs, (bt, bj)):
                seq = tr.new_stream()
                entries = [e for e in b.page_entries() if e[2] == 0]
                tr.stream_pages(dst, seq, entries)
                if i == 2:
                    tr.abort_stream(dst, seq)
                    seq = None
                data = tr.send(b, dst, seq_id=seq)
                back = tr.recv(data, dst, seq_id=seq)
                got = tr.fetch(dst, [tt._page_digest(p) for _, _, _, p in
                                     b.page_entries()] + [b"\0" * 12])
                outs.append((data, back.to_wire(None)[0], sorted(got)))
            assert outs[0] == outs[1], (dedup, cap, i)
        st_t, st_j = trs[0].stats, trs[1].stats
        assert dataclasses.asdict(st_t) == dataclasses.asdict(st_j)
        assert st_t.reduction == st_j.reduction
        assert trs[0].registry.snapshot() == trs[1].registry.snapshot()
        if dedup and cap == 7:
            assert st_t.store_evicted > 0 and st_t.pages_resent > 0
        if dedup:
            assert st_t.pages_ref > 0 and st_t.pages_fetched > 0
        else:           # every page inline, streamed ones again
            assert st_t.pages_ref == 0
            assert st_t.wire_bytes == (st_t.wire_bytes_nodedup
                                       + st_t.stream_chunk_bytes)


def _codecs(cls):
    return [cls(), cls.off(), cls(cache_block=8), cls(k=4, esc_frac=16),
            dataclasses.replace(cls.off(), cache_block=4)]


@pytest.mark.parametrize("arch", J_ARCHS)
def test_config_fingerprint_all_archs(arch):
    """``config_fingerprint`` hashes ``repr(cfg)`` and ``repr(codec)``: the
    port's configs and codecs give the reference's 16 bytes for every
    architecture, full size and reduced, with the backends at "auto"."""
    pairs = [(t_get_config(arch), j_get_config(arch))]
    pairs.append((t_make_reduced(pairs[0][0]), j_make_reduced(pairs[0][1])))
    for tcfg, jcfg in pairs:
        assert repr(tcfg) == repr(jcfg)
        for tc, jc in zip(_codecs(TCodec), _codecs(JCodec)):
            for geo in ((1, 2, 96, 1, None, None),
                        (1, 4, 4096, 0, 7, [[1, 2], [3]])):
                tp, slots, max_len, seed, eos, stops = geo
                assert tfr.config_fingerprint(
                    tcfg, tc, tp, slots, max_len, seed, eos_id=eos,
                    stop_seqs=stops) == jfr.config_fingerprint(
                    jcfg, jc, tp, slots, max_len, seed, eos_id=eos,
                    stop_seqs=stops)
    # a backend outside the shared "auto" changes the fingerprint
    tcfg, jcfg = pairs[0]
    assert tfr.config_fingerprint(
        tcfg, TCodec(decode_backend="cuda"), 1, 2, 96, 1) != \
        jfr.config_fingerprint(jcfg, JCodec(), 1, 2, 96, 1)


def test_framing_payloads_identical():
    rng = np.random.default_rng(5)
    digests = {rng.bytes(12) for _ in range(5)}
    pages = {d: rng.bytes(int(rng.integers(0, 64))) for d in digests}
    fp = rng.bytes(16)
    assert tfr.pack_hello(fp) == jfr.pack_hello(fp)
    assert tfr.pack_inventory(digests) == jfr.pack_inventory(digests)
    assert tfr.pack_pages(pages) == jfr.pack_pages(pages)
    meta = {"uid": 3, "prompt": [1, 2, 3], "seq_id": None}
    assert tfr.pack_seq(meta, b"blob") == jfr.pack_seq(meta, b"blob")
    assert (tfr.MAX_FRAME, tfr.PROTO_MAGIC, tfr.PROTO_VERSION,
            tfr.WIRE_VERSION, tfr.MSG_METRICS) == \
        (jfr.MAX_FRAME, jfr.PROTO_MAGIC, jfr.PROTO_VERSION,
         jfr.WIRE_VERSION, jfr.MSG_METRICS)


def test_link_model_metered_link_and_simulate():
    rng = np.random.default_rng(2)
    for gbps in (100.0, 12.5):
        lt, lj = tnoc.LinkModel(gbps=gbps), jnoc.LinkModel(gbps=gbps)
        mt = tnoc.MeteredLink(lt, TRegistry(), prefix="x")
        mj = jnoc.MeteredLink(lj, JRegistry(), prefix="x")
        for n, hops in zip(rng.integers(0, 1 << 30, 8), [0, 1, 2, 5] * 2):
            assert lt.transfer_ns(int(n), hops) == lj.transfer_ns(int(n),
                                                                  hops)
            assert mt.transfer_ns(int(n), hops) == mj.transfer_ns(int(n),
                                                                  hops)
        assert mt.registry.snapshot() == mj.registry.snapshot()
    crs = {"weights": 1.21, "activations": 1.1, "cache": 1.3}
    for arch in J_ARCHS:
        got = tnoc.simulate(t_get_config(arch), in_tokens=512,
                            out_tokens=300, crs=crs)
        want = jnoc.simulate(j_get_config(arch), in_tokens=512,
                             out_tokens=300, crs=crs)
        assert {k: dataclasses.asdict(v) for k, v in got.items()} == \
            {k: dataclasses.asdict(v) for k, v in want.items()}, arch
        assert got["lexi"].e2e_ms == want["lexi"].e2e_ms
