"""Prefix sharing and the tiered PageCache on the port's ``ServeEngine``
(device="cpu", weights bridged from the reference) against the
reference's ``ServeEngine(tp=1, prefix_sharing=True)``, on a tiny dense
model at block 4, codec on and off: on the reference's shared-prefix mix
the same streams and stop reasons, hits, admissions and ``cache_*``
counters, the same page tables and page use after every admission and
decode window, the same prefix index, refcounts, LRU order and warm
digests, and spilled payloads whose bytes are the reference's serializer
applied to the same pages.  Then on the port alone: sharing on equals
sharing off, evict / spill / restore, a remote tier and its re-prefill
fallback, the reference's oversubscription stress case, ``drop_cache``,
the refcount lifecycle with its double-release check, and the device page
table (``PagedKV.ids``) after map, import and release."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModel, RunConfig as JRun
from repro.core.collectives import CodecConfig as JCodec
from repro.launch.disagg_host import tiny_bench_config
from repro.serve import Request as JRequest, ServeEngine as JEngine
from repro.serve import transport as jtransport
from repro.serve.digest import page_digest
from repro_torch.configs.base import ModelConfig as TModel
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.core.collectives import CodecConfig as TCodec
from repro_torch.kernels import ops
from repro_torch.models import cache as tcache
from repro_torch.models.params import from_jax_params
from repro_torch.serve import engine as tengine
from repro_torch.serve.scheduler import Request as TRequest
from repro_torch.serve.scheduler import ServeEngine as TEngine

torch.set_num_threads(2)

MAXLEN, SLOTS, BLK = 64, 2, 4
KW = dataclasses.asdict(tiny_bench_config())
TCFG = TModel(**KW)
CACHE_COUNTERS = ("cache_hot_hits", "cache_spilled_pages",
                  "cache_spilled_bytes", "cache_fetched_pages",
                  "cache_fetched_bytes", "cache_reprefill_cols",
                  "cache_evicted_cols")


def _runs(codec_on):
    jc = JCodec(cache_block=BLK) if codec_on else dataclasses.replace(
        JCodec.off(), cache_block=BLK)
    tc = TCodec(cache_block=BLK) if codec_on else dataclasses.replace(
        TCodec.off(), cache_block=BLK)
    return JRun(codec=jc), TRun(codec=tc)


def _shared_mix(cls, vocab=512):
    """The reference's shared-prefix stream (``tests/test_serve_engine.py
    ::_shared_mix``): a base prompt A, an exact duplicate, a fork sharing
    A's first columns, an unrelated B, more requests than slots and
    staggered budgets, so that eviction interleaves with sharing."""
    rng = np.random.default_rng(42)
    a = rng.integers(0, vocab, (24,)).astype(np.int32)
    b = rng.integers(0, vocab, (12,)).astype(np.int32)
    fork = np.concatenate([a[:16], rng.integers(0, vocab, (6,))
                           .astype(np.int32)])
    prompts = [a, b, a.copy(), fork, a.copy()]
    budgets = [5, 3, 4, 4, 3]
    return [cls(uid=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(zip(prompts, budgets))]


def _stream(results):
    return [(r.tokens, r.stop_reason) for r in results]


def _record_tables(eng, tables, host):
    """After every admission phase and decode window, keep (page table,
    page use) of layer 0: the port's host arrays, or the reference's
    device ones (every layer's table and use must agree, see below)."""
    def read():
        kv = eng.state.kv
        if host:
            tables.append((kv.page_table.copy(), kv.page_used.copy()))
        else:
            pt, pu = np.asarray(kv.page_table)[0], np.asarray(kv.page_used)[0]
            assert (pt == pt[:1]).all() and (pu == pu[:1]).all()
            tables.append((pt[0], pu[0]))

    for name in ("_admit_phase", "_decode_window"):
        fn = getattr(eng, name)

        def wrapped(ls, fn=fn):
            fn(ls)
            read()
        setattr(eng, name, wrapped)


def _ledger(cache):
    return ({k: v.tolist() for k, v in cache.index.items()}, dict(cache.ref),
            list(cache.lru), {k: len(v) for k, v in cache.warm.items()})


@pytest.fixture(scope="module", params=[True, False], ids=["codec", "raw"])
def ref_run(request):
    """The reference engine on the shared mix: streams, stats, the page
    tables along the way, its cache ledger and spilled payloads."""
    codec_on = request.param
    jrun, trun = _runs(codec_on)
    je = JEngine(JModel(**KW), jrun, tp=1, n_slots=SLOTS, max_len=MAXLEN,
                 seed=1, prefix_sharing=True, max_fuse_steps=1)
    tables = []
    _record_tables(je, tables, host=False)
    res, st = je.run(_shared_mix(JRequest))
    warm = {k: [je.cache.store[d] for d in v]
            for k, v in je.cache.warm.items()}
    return dict(codec_on=codec_on, trun=trun, stream=_stream(res), stats=st,
                tables=tables, ledger=_ledger(je.cache), warm=warm,
                params=from_jax_params(jax.device_get(je.params)))


def _engine(ref_run, **kw):
    return TEngine(TCFG, ref_run["trun"], n_slots=SLOTS, max_len=MAXLEN,
                   params=ref_run["params"], device="cpu", **kw)


def _host_page(pkv, layer, page, codec_on):
    """One pool page's fields in the reference's ``(tp, L, cols, ...)``
    layout and dtypes (planes uint32, raw pages bf16 as uint16 bits)."""
    if not codec_on:
        a = pkv.raw_pages[layer, page].view(torch.int16).numpy()
        return {"raw_pages": a.view(np.uint16)[None, None, None]}
    out = {}
    for f in ("signman", "planes", "dict_syms", "esc_pos", "esc_raw"):
        a = getattr(pkv, f)[layer, page].numpy()
        out[f] = (a.view(np.uint32) if f == "planes" else a)[None, None, None]
    return out


def test_shared_mix_matches_reference(ref_run):
    """The port with sharing on against the reference with sharing on,
    one step per window as the reference ran (so windows match too)."""
    eng = _engine(ref_run, max_fuse_steps=1)
    tables = []
    _record_tables(eng, tables, host=True)
    res, st = eng.run(_shared_mix(TRequest))
    jst = ref_run["stats"]
    assert _stream(res) == ref_run["stream"]
    assert st.shared_page_hits == jst.shared_page_hits > 0
    assert st.n_admit_dispatches == jst.n_admit_dispatches < st.n_requests
    assert st.n_replay_dispatches == jst.n_replay_dispatches
    for name in CACHE_COUNTERS:
        assert getattr(st, name) == getattr(jst, name), name
    assert st.cache_spilled_pages > 0 and st.cache_hot_hits > 0
    assert len(tables) == len(ref_run["tables"])
    for (pt, pu), (jpt, jpu) in zip(tables, ref_run["tables"]):
        np.testing.assert_array_equal(pt, jpt)
        np.testing.assert_array_equal(pu, jpu)
    assert _ledger(eng.cache) == ref_run["ledger"]
    assert eng.cache.retained() > 0
    # spilled bytes: the reference's serializer on the same pool pages
    # (every spilled column is still hot here), and for layer 0, whose
    # K/V both models compute from the same embeddings, the reference's
    # own spilled payloads
    codec_on = ref_run["codec_on"]
    pkv = eng.state.kv
    for key, digs in eng.cache.warm.items():
        page = int(eng.cache.index[key][0])
        payloads = [eng.cache.store[d] for d in digs]
        for layer, p in enumerate(payloads):
            want = jtransport.page_payload(
                _host_page(pkv, layer, page, codec_on), codec_on, 0, 0, 0)
            assert p == want and page_digest(p) == digs[layer]
        assert payloads[0] == ref_run["warm"][key][0]
        assert [len(p) for p in payloads] == \
            [len(p) for p in ref_run["warm"][key]]


def test_sharing_on_equals_off(ref_run):
    on, st_on = _engine(ref_run).run(_shared_mix(TRequest))
    off_eng = _engine(ref_run, prefix_sharing=False)
    off, st_off = off_eng.run(_shared_mix(TRequest))
    assert _stream(on) == _stream(off)
    assert st_off.shared_page_hits == 0 and st_on.shared_page_hits > 0
    assert st_off.n_admit_dispatches > st_on.n_admit_dispatches
    assert st_off.cache_spilled_pages == 0
    assert not off_eng.state.kv.page_used.any()     # free at release


def test_evict_spill_restore_identity(ref_run):
    """Release retains and spills; pool pressure evicts every hot column;
    the same prompt again restores its prefix from the warm store with no
    prefill, on the same stream, each page byte for byte as spilled."""
    eng = _engine(ref_run)
    a = np.random.default_rng(5).integers(0, 512, (16,)).astype(np.int32)
    (r1,), st1 = eng.run([TRequest(uid=0, prompt=a, max_new_tokens=4)])
    keys = list(eng.cache.index)
    assert len(keys) == 4 and all(eng.cache.has_warm(k) for k in keys)
    assert st1.cache_spilled_pages == 4 * TCFG.n_layers
    eng._ensure_free_pages(1 << 30)
    assert eng.cache.retained() == 0
    assert eng.cache.evicted_cols == len(keys)
    assert eng._pages_in_use() == 0
    imported = []
    real = tengine.import_slot

    def watch(state, slot, wire, length, col0=0, **shard):
        out = real(state, slot, wire, length, col0, **shard)
        imported.append((slot, state.kv.page_table[slot].copy()))
        return out

    tengine.import_slot = watch
    try:
        (r2,), st2 = eng.run([TRequest(uid=1, prompt=a.copy(),
                                       max_new_tokens=4)])
    finally:
        tengine.import_slot = real
    assert r2.tokens == r1.tokens
    assert st2.n_admit_dispatches == 0 and st2.shared_page_hits == 3
    assert st2.cache_fetched_pages == 3 * TCFG.n_layers
    assert st2.cache_fetched_bytes > 0
    # the three imported columns (the fourth holds the last prompt token,
    # which replays) hold the spilled bytes
    (slot, row), = imported
    codec_on = ref_run["codec_on"]
    for c in range(3):
        digs = eng.cache.warm[keys[c]]
        for layer in range(TCFG.n_layers):
            page = _host_page(eng.state.kv, layer, int(row[c]), codec_on)
            assert page_digest(jtransport.page_payload(
                page, codec_on, 0, 0, 0)) == digs[layer]
    eng.drop_cache()
    assert eng._pages_in_use() == 0


def test_remote_tier_and_reprefill(ref_run):
    """A warm store of one page loses the spilled payloads; a stub peer
    that kept them restores the prefix (remote pages counted, stream
    unchanged); a peer that has nothing leaves the column to a counted
    re-prefill, cold, on the same stream."""
    peer = {}
    missing = []

    def remote(digests):
        missing.append(len(digests))
        return {d: peer[d] for d in digests if d in peer}

    a = np.random.default_rng(6).integers(0, 512, (16,)).astype(np.int32)
    eng = _engine(ref_run, store_pages=1, remote_fetch=remote)
    spill = eng.cache.spill

    def keep(key, payloads):
        peer.update((page_digest(p), p) for p in payloads)
        spill(key, payloads)

    eng.cache.spill = keep
    (r1,), _ = eng.run([TRequest(uid=0, prompt=a, max_new_tokens=4)])
    eng._ensure_free_pages(1 << 30)
    (r2,), st2 = eng.run([TRequest(uid=1, prompt=a.copy(),
                                   max_new_tokens=4)])
    assert r2.tokens == r1.tokens and missing
    assert eng.cache.remote_pages > 0 and st2.n_admit_dispatches == 0
    eng._ensure_free_pages(1 << 30)
    peer.clear()
    eng.cache.store = type(eng.cache.store)(1)        # local bytes gone
    (r3,), st3 = eng.run([TRequest(uid=2, prompt=a.copy(),
                                   max_new_tokens=4)])
    assert r3.tokens == r1.tokens
    assert st3.cache_reprefill_cols == 1 and st3.n_admit_dispatches == 1


def test_oversubscription_stress(ref_run):
    """Identical long prompts stream through 2 slots of an exactly sized
    pool: shared admissions and evictions never leak or oversubscribe
    pages (the reference's ``test_sharing_oversubscription_stress``)."""
    eng = _engine(ref_run)
    a = np.random.default_rng(7).integers(0, 512, (40,)).astype(np.int32)
    results, st = eng.run([TRequest(uid=i, prompt=a.copy(), max_new_tokens=4)
                           for i in range(4)])
    assert st.shared_page_hits > 0
    assert all(r.tokens == results[0].tokens for r in results[1:])
    eng.drop_cache()
    assert eng._pages_in_use() == 0 and not eng._prefix_index


def test_pool_pressure_evicts(ref_run):
    """Retained columns of distinct prompts fill the pool (2 slots of 18
    pages): admissions, replays and decode windows evict the oldest
    retained columns instead of running the pool dry, on the sharing-off
    streams."""
    rng = np.random.default_rng(10)
    reqs = [TRequest(uid=i, prompt=rng.integers(0, 512, (30,))
                     .astype(np.int32), max_new_tokens=6) for i in range(8)]
    eng = _engine(ref_run)
    on, st = eng.run(reqs)
    off, _ = _engine(ref_run, prefix_sharing=False).run(reqs)
    assert _stream(on) == _stream(off)
    assert st.cache_evicted_cols > 0 and st.shared_page_hits == 0
    assert eng.state.kv.page_used.sum() <= eng._n_pages


def test_drop_cache_drains_pool(ref_run):
    eng = _engine(ref_run)
    eng.run(_shared_mix(TRequest))
    assert eng.cache.retained() > 0 and eng.state.kv.page_used.any()
    assert eng.drop_cache() == eng.cache.evicted_cols > 0
    assert not eng.state.kv.page_used.any()
    assert not eng._prefix_index and not eng._prefix_ref
    assert not eng.cache.warm and not eng._slot_busy.any()
    assert not eng.state.active.any()
    assert _engine(ref_run, prefix_sharing=False).drop_cache() == 0


def _ids_match(pkv):
    np.testing.assert_array_equal(pkv.ids.numpy(),
                                  np.maximum(pkv.page_table, 0))


def test_refcount_lifecycle(ref_run):
    """Owner registration, a mapped sharer with no page copied, release
    of the owner while shared keeps the pages, a double release raises,
    the last release retains and spills, ``drop_cache`` drains; the device
    table follows the host table after every change."""
    eng = _engine(ref_run)
    a = np.random.default_rng(8).integers(0, 512, (16,)).astype(np.int32)
    _, d = tengine.prefill_sequences(TCFG, ref_run["trun"], eng.params,
                                     torch.as_tensor(a[None]))
    tengine.insert_sequences(TCFG, ref_run["trun"], eng.state, d, [0])
    eng._slot_busy[0] = True
    eng._register_prefixes([(0, a, 16)])
    pkv = eng.state.kv
    _ids_match(pkv)
    assert len(eng._prefix_index) == 4
    assert all(r == 1 for r in eng._prefix_ref.values())
    owner = eng._pages_in_use()
    assert owner == eng._pages_for_length(16) > 0

    ext = np.concatenate([a, np.arange(4, dtype=np.int32)])
    m, keys, warm = eng._prefix_match_cols(ext)
    assert m == 4 and warm == []
    ids = np.zeros((eng._maxp,), np.int32)
    for c, key in enumerate(keys):
        ids[c] = eng.cache.acquire(key)[0]
        eng._slot_keys[1].append(key)
    pkv.ring[:, 1].fill_(1.0)
    tengine.map_shared_slot(eng.state, 1, ids, m, 16)
    eng._slot_busy[1] = True
    _ids_match(pkv)
    assert not pkv.ring[:, 1].any()                   # the ring starts empty
    np.testing.assert_array_equal(pkv.page_table[1], pkv.page_table[0])
    assert eng._pages_in_use() == owner               # nothing allocated
    assert eng._shared_page_overcount() == 4 * TCFG.n_layers

    eng._free_slots([0])                              # owner, while shared
    _ids_match(pkv)
    assert eng._pages_in_use() == owner
    with pytest.raises(RuntimeError, match="double release"):
        eng._free_slots([0])
    eng._free_slots([1])                              # last reference
    _ids_match(pkv)
    assert eng._pages_in_use() == owner
    assert eng.cache.retained() == 4
    assert all(eng.cache.has_warm(k) for k in keys)
    assert eng.cache.spilled_pages == 4 * TCFG.n_layers
    eng.drop_cache()
    assert eng._pages_in_use() == 0 and not eng._prefix_index
    _ids_match(pkv)


def test_export_import_round_trip(ref_run):
    """A slot exported and imported into another slot (pages from the free
    list, a partial import above mapped columns) re-exports bit for bit;
    the device table follows every change."""
    eng = _engine(ref_run, prefix_sharing=False)
    trun = ref_run["trun"]
    a = np.random.default_rng(9).integers(0, 512, (14,)).astype(np.int32)
    _, d = tengine.prefill_sequences(TCFG, trun, eng.params,
                                     torch.as_tensor(a[None]))
    tengine.insert_sequences(TCFG, trun, eng.state, d, [0])
    pkv = eng.state.kv
    n = tcache.export_n_cols(14, BLK)
    wire, _, length = tengine.export_slot(eng.state, 0, n)
    assert length == 14 and n == 3
    tengine.import_slot(eng.state, 1, wire, length)
    _ids_match(pkv)
    assert set(pkv.page_table[1, :3]).isdisjoint(pkv.page_table[0, :3])
    again, _, _ = tengine.export_slot(eng.state, 1, n)
    for f in tcache.PageWire._fields:
        x, y = getattr(wire, f), getattr(again, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert torch.equal(x.view(torch.uint8), y.view(torch.uint8)), f
    # columns past the sequence's full pages export as zeros
    wide, _, _ = tengine.export_slot(eng.state, 0, n + 2)
    lead = wide.signman if wide.signman is not None else wide.raw_pages
    assert not lead[:, n:].any()
    # a partial import keeps the mapped columns below col0
    tengine.release_slots(eng.state, np.array([False, True]))
    _ids_match(pkv)
    tengine.map_shared_slot(eng.state, 1, pkv.page_table[0], 1, BLK)
    tail, _, _ = tengine.export_slot(eng.state, 0, n - 1, col0=1)
    tengine.import_slot(eng.state, 1, tail, length, col0=1)
    _ids_match(pkv)
    assert pkv.page_table[1, 0] == pkv.page_table[0, 0]
    assert pkv.page_table[1, 1] != pkv.page_table[0, 1]
    again, _, _ = tengine.export_slot(eng.state, 1, n)
    for f in tcache.PageWire._fields:
        x, y = getattr(wire, f), getattr(again, f)
        if x is not None:
            assert torch.equal(x.view(torch.uint8), y.view(torch.uint8)), f
    free = np.zeros_like(pkv.page_used)
    free[pkv.page_table[1, 1:3]] = True
    tengine.release_slots(eng.state, np.array([False, True]), free_mask=free)
    _ids_match(pkv)
    assert pkv.page_used[pkv.page_table[0, :3]].all()
    assert pkv.page_used.sum() == 3


class _StandInCapture:
    """``ops.CapturedStep`` on the CPU: the warm-up where the capture
    would run, then the step on every replay."""
    made = 0

    def __init__(self, step, warmup, device):
        warmup()
        self.step = step
        _StandInCapture.made += 1

    def replay(self):
        self.step()


def _bits(t):
    return t.contiguous().view(torch.uint8)


def test_graph_dispatch_with_sharing(ref_run, monkeypatch):
    """The decoder in graph mode (a stand-in capture) serves the shared
    mix, an eviction of every retained column and a warm restore with one
    capture for all of it, on the eager engine's streams, page tables and
    pool bytes: hits map, import and evict between steps, on the host."""
    _StandInCapture.made = 0
    monkeypatch.setattr(ops, "CapturedStep", _StandInCapture)
    a = _shared_mix(TRequest)[0].prompt
    out = {}
    for graphs in (False, True):
        eng = _engine(ref_run)
        eng.decoder.graphs = graphs
        res, st = eng.run(_shared_mix(TRequest))
        eng._ensure_free_pages(1 << 30)
        res2, st2 = eng.run([TRequest(uid=9, prompt=a.copy(),
                                      max_new_tokens=5)])
        assert st2.n_admit_dispatches == 0 and st2.cache_fetched_pages > 0
        assert res2[0].tokens == res[0].tokens
        if graphs:
            assert eng.decoder.counts.captures == 1
            assert st.graph_replays > 0 and st2.graph_replays > 0
        out[graphs] = (_stream(res), eng.state.kv)
    assert _StandInCapture.made == 1
    assert out[True][0] == out[False][0]
    a_kv, b_kv = out[True][1], out[False][1]
    np.testing.assert_array_equal(a_kv.page_table, b_kv.page_table)
    np.testing.assert_array_equal(a_kv.page_used, b_kv.page_used)
    for f in tcache.PageWire._fields:
        x, y = getattr(a_kv, f), getattr(b_kv, f)
        if x is not None:
            assert torch.equal(_bits(x), _bits(y)), f
