"""Tiered content-addressed page retention for the serving stack (a copy
of ``repro/serve/pagecache.py``; pure host bookkeeping, no torch).

Before this module, three retention mechanisms coexisted without talking
to each other: the scheduler's prefix index freed pages the moment their
refcount hit zero, the transport's :class:`~repro_torch.serve.transport.
DigestStore` LRU-retained the SAME immutable compressed bytes one layer
away, and the device pool knew nothing of either.  :class:`PageCache`
unifies them into one lifecycle over three tiers:

* **hot** — device pool pages.  A page column whose refcount drops to
  zero is RETAINED (moved to an LRU of zero-ref columns) instead of
  freed; a later request with the same prefix re-acquires it for a
  zero-FLOP, zero-copy hit.  Under pool pressure the scheduler evicts
  from the LRU tail (``evict_lru``) — eviction is pure ``page_used``
  clearing, because zero-ref columns are unmapped by construction.
* **warm** — host RAM.  At the LAST release of a column (while its pages
  are still addressable through the releasing slot's page-table row) the
  scheduler exports the column and ``spill``s its immutable payloads
  here, keyed by the same truncated SHA-256 page digests the transport
  computes (``serve.digest``).  A prefix whose hot pages were
  evicted restores from these bytes with a device import — no prefill
  FLOPs, just a scatter.
* **remote** — a peer's store.  When the warm store itself evicted a
  payload, ``remote_fetch`` (in the reference wired by the disagg router
  to ``PageTransport.fetch``; the port accepts any callable until its
  disaggregated serving lands) pulls it back by digest before the caller
  falls back to re-prefill.

The cache is pure host bookkeeping: it never touches device state.  The
scheduler (``serve.scheduler.ServeEngine``) drives the device side
— mapping hot columns, importing warm payloads, freeing evicted pages —
and reads/updates this ledger around each dispatch.  Keys are the
chained prefix digests of ``serve.digest.chain_keys``; values in
``index`` are per-shard page-id vectors (free-list order permutes
per-shard, so one column owns ``tp`` physical page ids, the same id
across layers by lockstep allocation).

For hybrid (attention + SSM) models the cache additionally holds
**boundary snapshots**: the per-slot recurrent state captured right
after a tail-less, page-aligned admission, keyed by the prompt's LAST
chained prefix key.  A later identical prompt maps/restores pages AND
state and skips prefill entirely — the only replay-free (hence bit-
exact) way to prefix-share a recurrence.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .digest import page_digest
from .transport import DigestStore


class PageCache:
    """Host-side ledger of the hot / warm / remote page tiers.

    ``index``: prefix key -> per-shard page-id vector (the hot tier: both
    referenced and retained zero-ref columns).  ``ref``: key -> live
    reference count.  ``lru``: zero-ref keys in eviction order (oldest
    first).  ``warm``: key -> page digests (``tp * n_layers`` per column,
    shard-major) resolving into ``store``.  ``snapshots``: last-column
    key -> boundary SSM state + first greedy token.
    """

    def __init__(self, max_store_pages: int = 4096,
                 remote_fetch: Optional[
                     Callable[[List[bytes]], Dict[bytes, bytes]]] = None,
                 max_snapshots: int = 64):
        self.index: Dict[bytes, np.ndarray] = {}
        self.ref: Dict[bytes, int] = {}
        self.lru: "OrderedDict[bytes, None]" = OrderedDict()
        self.warm: Dict[bytes, List[bytes]] = {}
        self.store = DigestStore(max_store_pages)
        self.remote_fetch = remote_fetch
        self.snapshots: "OrderedDict[bytes, Dict[str, Any]]" = OrderedDict()
        self.max_snapshots = max_snapshots
        # lifetime counters (engine-scoped, snapshotted into ServeStats)
        self.hot_hits = 0        # zero-ref retained columns re-acquired
        self.spilled_pages = 0   # payloads written to the warm store
        self.spilled_bytes = 0
        self.fetched_pages = 0   # payloads restored from warm (incl. remote)
        self.fetched_bytes = 0
        self.remote_pages = 0    # subset of fetched that came from a peer
        self.remote_bytes = 0
        self.reprefill_cols = 0  # warm columns lost to store eviction
        self.evicted_cols = 0    # hot columns dropped under pool pressure

    def counters(self) -> Dict[str, int]:
        """Lifetime tier-traffic counters, keyed as they appear in the
        unified metrics namespace (``cache.<key>``); the scheduler's
        ``ServeStats`` reads them through here."""
        return {"hot_hits": self.hot_hits,
                "spilled_pages": self.spilled_pages,
                "spilled_bytes": self.spilled_bytes,
                "fetched_pages": self.fetched_pages,
                "fetched_bytes": self.fetched_bytes,
                "remote_pages": self.remote_pages,
                "remote_bytes": self.remote_bytes,
                "reprefill_cols": self.reprefill_cols,
                "evicted_cols": self.evicted_cols}

    # -- hot tier ----------------------------------------------------------

    def __contains__(self, key: bytes) -> bool:
        return key in self.index

    def insert(self, key: bytes, ids: np.ndarray) -> None:
        """Register a freshly filled column at refcount 1."""
        assert key not in self.index, "column registered twice"
        self.index[key] = ids
        self.ref[key] = 1

    def acquire(self, key: bytes) -> np.ndarray:
        """Take a reference on a hot column; reviving a retained zero-ref
        column counts as a hot-tier hit.  Returns its page ids."""
        r = self.ref[key]
        if r == 0:
            del self.lru[key]
            self.hot_hits += 1
        self.ref[key] = r + 1
        return self.index[key]

    def release(self, key: bytes) -> None:
        """Drop a reference.  At zero the column is RETAINED (joins the
        eviction LRU) — this is the tentpole change from free-at-zero."""
        r = self.ref.get(key, 0) - 1
        if r < 0:
            raise RuntimeError(
                f"prefix refcount underflow for key {key.hex()[:12]}")
        self.ref[key] = r
        if r == 0:
            self.lru[key] = None

    def evict_lru(self) -> Tuple[bytes, np.ndarray]:
        """Drop the least-recently-retained zero-ref column from the hot
        tier; returns ``(key, page ids)`` so the caller can free the
        device pages.  Its warm bytes (if spilled) survive."""
        key, _ = self.lru.popitem(last=False)
        ids = self.index.pop(key)
        del self.ref[key]
        self.evicted_cols += 1
        return key, ids

    def retained(self) -> int:
        """Zero-ref columns currently held resident."""
        return len(self.lru)

    # -- warm tier ---------------------------------------------------------

    def has_warm(self, key: bytes) -> bool:
        return key in self.warm

    def spill(self, key: bytes, payloads: Sequence[bytes]) -> None:
        """Keep a column's immutable page payloads (shard-major, one per
        ``(shard, layer)``) in the host-RAM store, keyed by content."""
        digs = []
        for p in payloads:
            d = page_digest(p)
            if d not in self.store:
                self.store[d] = p
                self.spilled_pages += 1
                self.spilled_bytes += len(p)
            digs.append(d)
        self.warm[key] = digs
        self.store.trim()

    def fetch_warm(self, key: bytes) -> Optional[List[bytes]]:
        """Resolve a warm column back to payload bytes: local store first,
        then the remote tier.  ``None`` means the bytes are gone on every
        tier — the caller re-prefills (counted) and the dead entry is
        dropped."""
        digs = self.warm.get(key)
        if digs is None:
            return None
        got: Dict[bytes, bytes] = {}
        missing = []
        for d in digs:
            if d in self.store:
                got[d] = self.store[d]
            elif d not in got:
                missing.append(d)
        if missing and self.remote_fetch is not None:
            remote = self.remote_fetch(missing)
            for d, p in remote.items():
                if page_digest(p) != d:
                    raise ValueError(
                        f"remote payload does not hash to its digest "
                        f"{d.hex()} — corrupted page on the fetch path")
                got[d] = p
                self.remote_pages += 1
                self.remote_bytes += len(p)
                self.store[d] = p      # re-warm locally
            missing = [d for d in missing if d not in got]
        if missing:
            del self.warm[key]
            self.reprefill_cols += 1
            return None
        out = [got[d] for d in digs]
        self.fetched_pages += len(out)
        self.fetched_bytes += sum(len(p) for p in out)
        return out

    # -- SSM boundary snapshots -------------------------------------------

    def get_snapshot(self, key: bytes) -> Optional[Dict[str, Any]]:
        snap = self.snapshots.get(key)
        if snap is not None:
            self.snapshots.move_to_end(key)
        return snap

    def put_snapshot(self, key: bytes, snap: Dict[str, Any]) -> None:
        self.snapshots[key] = snap
        self.snapshots.move_to_end(key)
        while len(self.snapshots) > self.max_snapshots:
            self.snapshots.popitem(last=False)

    # -- teardown ----------------------------------------------------------

    def drop_retained(self) -> List[np.ndarray]:
        """Evict EVERY zero-ref column (the caller frees the device pages
        from the returned id vectors) and clear the warm + snapshot tiers.
        Columns still referenced by live slots are untouched."""
        ids = []
        while self.lru:
            ids.append(self.evict_lru()[1])
        self.warm.clear()
        self.store = DigestStore(self.store.max_pages)
        self.snapshots.clear()
        return ids
