"""The port's host modules of prefix sharing (``repro_torch.serve.digest``,
the page-payload half of ``transport``, ``pagecache``) against the
reference's, side by side on the same seeded inputs: identical prefix keys
and page digests, payload bytes and their inverse (codec on and off), the
digest store's LRU and pins, and the tiered ``PageCache`` ledger (index,
refcounts, LRU order, warm digests and counters) after every step of the
reference's randomized schedules, plus its remote-fetch and re-prefill
fallback with a stub peer."""

import numpy as np
import pytest

from repro.serve import digest as jdigest
from repro.serve import pagecache as jpagecache
from repro.serve import transport as jtransport
from repro_torch.core import packing
from repro_torch.serve import digest as tdigest
from repro_torch.serve import pagecache as tpagecache
from repro_torch.serve import transport as ttransport
from repro_torch.serve import PageCache


@pytest.mark.parametrize("seed,n,blk", [(0, 40, 4), (1, 33, 8), (2, 600, 256),
                                        (3, 7, 4)])
def test_chain_keys_and_page_digest(seed, n, blk):
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, 151936, (n,)).astype(np.int32)
    n_cols = n // blk
    assert tdigest.chain_keys(prompt, n_cols, blk) == \
        jdigest.chain_keys(prompt, n_cols, blk)
    # an int64 prompt keys as its int32 values, as in the reference
    assert tdigest.chain_keys(prompt.astype(np.int64), n_cols, blk) == \
        jdigest.chain_keys(prompt, n_cols, blk)
    payload = rng.bytes(int(rng.integers(1, 5000)))
    assert tdigest.page_digest(payload) == jdigest.page_digest(payload)
    assert tdigest.DIGEST_BYTES == jdigest.DIGEST_BYTES == 12


def _geometry():
    blk, w = 4, 64
    return dict(blk=blk, w=w, k=5, esc_cap=8,
                npad=packing.pad_to_lanes(blk * w))


def _random_fields(rng, codec_on, n_layers, n_cols, g):
    """Seeded (1, L, cols, ...) fields in the reference's dtypes."""
    kv = jtransport.empty_page_fields(codec_on, 1, n_layers, n_cols, **g)
    for f, a in kv.items():
        bits = rng.integers(0, 256, a.nbytes, dtype=np.uint8)
        a.view(np.uint8).reshape(-1)[:] = bits
    return kv


@pytest.mark.parametrize("codec_on", [True, False], ids=["codec", "raw"])
def test_page_payload_round_trip(codec_on):
    """``page_payload`` gives the reference's bytes for the same fields
    (raw pages as uint16 bits, the reference's bf16), ``payload_nbytes``
    its size, and ``scatter_page_payload`` puts every field back."""
    g = _geometry()
    rng = np.random.default_rng(11)
    n_layers, n_cols = 3, 2
    jkv = _random_fields(rng, codec_on, n_layers, n_cols, g)
    tkv = {f: a.view(np.uint16) if f == "raw_pages" else a
           for f, a in jkv.items()}
    size = ttransport.payload_nbytes(codec_on, **g)
    assert size == jtransport.payload_nbytes(codec_on, **g)
    back = ttransport.empty_page_fields(codec_on, 1, n_layers, n_cols, **g)
    assert back.keys() == tkv.keys()
    assert all(back[f].dtype == tkv[f].dtype for f in back)
    for l in range(n_layers):
        for c in range(n_cols):
            p = ttransport.page_payload(tkv, codec_on, 0, l, c)
            assert p == jtransport.page_payload(jkv, codec_on, 0, l, c)
            assert len(p) == size
            ttransport.scatter_page_payload(back, codec_on, 0, l, c, p, **g)
    for f in tkv:
        np.testing.assert_array_equal(back[f], tkv[f])
    with pytest.raises(ValueError, match="geometry"):
        ttransport.scatter_page_payload(back, codec_on, 0, 0, 0, p[:-1], **g)


def test_digest_store_lru_and_pins():
    """The same inserts, reads, pins and trims on both stores: the same
    contents in the same LRU order, the same counters; a payload that
    does not hash to its digest is refused."""
    rng = np.random.default_rng(3)
    stores = [jtransport.DigestStore(4), ttransport.DigestStore(4)]
    payloads = [rng.bytes(40) for _ in range(9)]
    digs = [tdigest.page_digest(p) for p in payloads]
    trims = []
    for st in stores:
        for d, p in zip(digs[:6], payloads[:6]):
            st[d] = p
        st.pin(7, digs[0])
        st.pin(7, digs[1])
        st.pin(8, digs[1])
        assert st[digs[2]] == payloads[2]          # refreshed
        st[digs[3]] = payloads[3]                  # re-insert: refreshed
        trims.append([st.trim()])                  # pinned 0, 1 skipped
        st.release(7)
        for d, p in zip(digs[6:], payloads[6:]):
            st[d] = p
        trims[-1].append(st.trim())                # 1 still pinned by 8
        st.release(8)
        st.release(99)                             # absent: no-op
        with pytest.raises(ValueError, match="digest"):
            st[digs[0]] = payloads[1]
    a, b = stores
    assert trims[0] == trims[1] == [2, 3]
    assert list(a._lru) == list(b._lru) and digs[1] in b
    assert (a.n_inserted, a.n_evicted, a.n_hits) == \
        (b.n_inserted, b.n_evicted, b.n_hits)
    assert a.digests() == b.digests() and len(a) == len(b)
    with pytest.raises(ValueError):
        ttransport.DigestStore(0)


def _ledger(c):
    return ({k: v.tolist() for k, v in c.index.items()}, dict(c.ref),
            list(c.lru), {k: list(v) for k, v in c.warm.items()},
            list(c.store._lru), c.counters())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_randomized_schedule_side_by_side(seed):
    """The reference's randomized schedule (``tests/test_pagecache.py``)
    driven through the reference's and the port's ``PageCache`` at once:
    the same index, refcounts, LRU order, warm digests, store order and
    counters after every step, the same results from every call."""
    rng = np.random.default_rng(seed)
    caches = [jpagecache.PageCache(max_store_pages=8),
              tpagecache.PageCache(max_store_pages=8)]
    shadow = {}
    payload_of = {}
    next_page = 0

    def both(fn):
        out = [fn(c) for c in caches]
        a, b = out
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        elif isinstance(a, tuple):
            assert a[0] == b[0]
            np.testing.assert_array_equal(a[1], b[1])
        else:
            assert a == b
        return a

    for _ in range(400):
        op = int(rng.integers(0, 5))
        held = [k for k, r in shadow.items() if r > 0]
        retained = [k for k in shadow if shadow[k] == 0]
        if op == 0 or not shadow:
            key = rng.bytes(12)
            if key in shadow:
                continue
            page = next_page
            both(lambda c: c.insert(key, np.array([page])))
            next_page += 1
            shadow[key] = 1
            payload_of[key] = [rng.bytes(24), rng.bytes(24)]
        elif op == 1:
            key = list(shadow)[int(rng.integers(0, len(shadow)))]
            both(lambda c: c.acquire(key))
            shadow[key] += 1
        elif op == 2 and held:
            key = held[int(rng.integers(0, len(held)))]
            if shadow[key] == 1 and not caches[1].has_warm(key):
                both(lambda c: c.spill(key, payload_of[key]))
            both(lambda c: c.release(key))
            shadow[key] -= 1
        elif op == 3 and retained:
            key, _ = both(lambda c: c.evict_lru())
            assert shadow.pop(key) == 0
        elif op == 4:
            gone = [k for k in payload_of
                    if k not in shadow and caches[1].has_warm(k)]
            if gone:
                key = gone[int(rng.integers(0, len(gone)))]
                got = both(lambda c: c.fetch_warm(key))
                assert got is None or got == payload_of[key]
        assert _ledger(caches[0]) == _ledger(caches[1])
        assert caches[1].retained() == caches[0].retained()
    for key, r in list(shadow.items()):
        for _ in range(r):
            both(lambda c: c.release(key))
    dropped = [c.drop_retained() for c in caches]
    assert [v.tolist() for v in dropped[0]] == [v.tolist() for v in dropped[1]]
    assert _ledger(caches[0]) == _ledger(caches[1])
    assert not caches[1].index and not caches[1].warm


def test_underflow_and_double_register_loud():
    cache = PageCache()
    cache.insert(b"K" * 12, np.array([0]))
    with pytest.raises(AssertionError, match="registered twice"):
        cache.insert(b"K" * 12, np.array([1]))
    cache.release(b"K" * 12)
    with pytest.raises(RuntimeError, match="underflow"):
        cache.release(b"K" * 12)
    with pytest.raises(RuntimeError, match="underflow"):
        cache.release(b"?" * 12)


def test_remote_fetch_and_reprefill_side_by_side():
    """Warm payloads the bounded store evicted come back from a stub
    remote tier (digest-checked, re-warmed, counted); a corrupt remote
    payload raises; when every tier misses, the column is a counted
    re-prefill.  Both classes give the same results and counters."""
    pa, pb = [b"a" * 32, b"b" * 32], [b"c" * 32, b"d" * 32]
    peer = {tdigest.page_digest(p): p for p in pa + pb}
    runs = []
    for mod in (jpagecache, tpagecache):
        calls = []

        def remote(digests, calls=calls):
            calls.append(list(digests))
            return {d: peer[d] for d in digests if d in peer}

        cache = mod.PageCache(max_store_pages=1, remote_fetch=remote)
        cache.insert(b"A" * 12, np.array([0]))
        cache.insert(b"B" * 12, np.array([1]))
        cache.spill(b"A" * 12, pa)
        cache.spill(b"B" * 12, pb)              # store cap 1: A's bytes gone
        got = cache.fetch_warm(b"A" * 12)
        assert got == pa and calls
        bad = mod.PageCache(max_store_pages=1,
                            remote_fetch=lambda ds: {d: b"corrupt"
                                                     for d in ds})
        bad.insert(b"A" * 12, np.array([0]))
        bad.spill(b"A" * 12, pa)
        bad.spill(b"B" * 12, pb)
        with pytest.raises(ValueError, match="hash"):
            bad.fetch_warm(b"A" * 12)
        lost = mod.PageCache(max_store_pages=1)
        lost.spill(b"A" * 12, pa)
        lost.spill(b"B" * 12, pb)
        assert lost.fetch_warm(b"A" * 12) is None
        assert not lost.has_warm(b"A" * 12)
        assert lost.fetch_warm(b"Z" * 12) is None
        runs.append((cache.counters(), lost.counters(), calls))
    assert runs[0] == runs[1]
    assert runs[1][0]["remote_pages"] == 2 and runs[1][0]["fetched_pages"] == 2
    assert runs[1][1]["reprefill_cols"] == 1


def test_snapshot_lru_bound():
    cache = PageCache(max_snapshots=3)
    for i in range(4):
        cache.put_snapshot(bytes([i]) * 12, {"g0": i})
    assert cache.get_snapshot(bytes([0]) * 12) is None
    assert cache.get_snapshot(bytes([1]) * 12) == {"g0": 1}
    cache.put_snapshot(bytes([9]) * 12, {"g0": 9})
    assert cache.get_snapshot(bytes([2]) * 12) is None
    assert cache.get_snapshot(bytes([1]) * 12) == {"g0": 1}
