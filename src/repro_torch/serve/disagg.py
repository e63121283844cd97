"""Disaggregated prefill serving: prefill replicas feeding decode replicas
through compressed page transfer (ports ``repro/serve/disagg.py`` for the
dense, MoE and MLA families, the parallel attention ∥ SSM hybrids and the
attention-free model; an MLA page is a block of 576-wide latent rows on
the wire).

The monolithic ``ServeEngine`` interleaves admission (prefill-heavy,
bursty) and decode (latency-sensitive, steady) on one set of slots.
Disaggregation splits them onto separate replicas and keeps the split
exact:

  * the prefill replica runs the same admission machinery
    (``ServeEngine._admit_phase``: batched bucketed prefill, fused tail
    replay), with prefix sharing off;
  * the handoff copies the slot's cache state byte for byte: compressed
    full pages travel as stored, plus the partial-tail ring, a hybrid's
    SSM state (f32 ``h`` and the bf16 conv rings, raw), the slot's length
    and its emitted tokens (``transport.SequenceBlob``, the reference's
    wire bytes);
  * slots are independent in the paged decode path, so the decode replica
    stepping an imported slot computes what the prefill replica would
    have.

Dataflow:

    requests -> PrefillReplica[0..N) --(page chunks, SequenceBlob bytes:
    PageTransport, metered through hw.noc.LinkModel)--> DecodeReplica[0..M)
    -> results

Requests go to the least-backlogged prefill replica; handoffs land on the
decode replica with the most free slots (a streamed sequence is routed
when its first chunk ships and sticks to that destination).  A handoff
waits while its destination has no free slot.  All device work goes
through ``engine.export_slot`` / ``engine.import_slot`` /
``engine.map_shared_slot``: an export is one gather per field and a copy
from the card to the host, an import one copy to the card and a scatter
into pages from the decode pool's own free list.

``LoopbackTransport`` keeps both replica kinds in one process;
``serve.net.client.SocketTransport`` (with ``decode_addrs=``) drives
decode replicas in other OS processes (``launch.disagg_host``) over TCP:
the same wire bytes, the same streams.

Tensor parallelism (``DisaggEngine(group=)``; every family
``ServeEngine`` serves): every rank runs its shard of every replica,
and the whole fleet's host loop, in lock step, as ``ServeEngine(group=)``
does.  A handoff's blob carries every rank's pages, shard-major, in the
reference's ``(tp, L, ...)`` layout (``repro/serve/disagg.py:293-316``):
each rank exports its own shard (``engine.export_slot(.., tp, ti=rank)``),
the shards are gathered to every rank (``collectives.gather_objects``)
and each rank imports its own shard of the received blob
(``:440-470``).  Streaming export counts the columns ``sent`` per shard
(``cache.local_full_pages``, ``:199-218``), and a hybrid's SSM state
travels per rank, ``(tp, L, nh_loc, ...)`` (an attention-free model's
blob is that section alone: no pages).  Every rank holds an
identical loopback transport, so the link accounting and every routing
decision are the same on every rank.  With ``decode_addrs`` rank 0 alone
holds the socket: the transport and the remote replicas run there and
every rank gets their results (``_OnRoot``); a decode host at tp > 1
(``launch.disagg_host --tp``) runs its ranks behind rank 0's socket
(``GroupReplica``, ``follow``).

The reference rounds streaming export windows to powers of two to bound
its jit cache; the port exports exactly the new columns, with the same
chunk entries.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import collectives as cl
from repro_torch.models import cache as cache_mod
from repro_torch.models.ssm import SSMState
from . import engine as engine_mod
from .scheduler import (Request, RequestResult, ServeEngine, _host_fields,
                        _LoopState)
from .telemetry import (MetricsRegistry, Tracer, sum_counters,
                        summarize_latencies)
from .transport import (LoopbackTransport, PageTransport, SequenceBlob,
                        TransportStats, page_payload)


@dataclasses.dataclass
class Handoff:
    """One admitted sequence in flight between replicas (host envelope:
    the request stays host-side; only the cache state in ``blob`` crosses
    the modelled link).  ``dst`` / ``seq_id`` are set when the sequence's
    full pages already streamed to a destination during admission: the
    router must then deliver the tail there (the chunks live in its
    digest store)."""
    req: Request
    blob: SequenceBlob
    admit_t: float
    dst: Optional[str] = None
    seq_id: Optional[int] = None


@dataclasses.dataclass
class DisaggStats:
    """Aggregate stats of a disaggregated serving run."""
    n_requests: int
    n_tokens: int
    decode_steps: int
    n_dispatches: int              # decode windows, all decode replicas
    n_admit_dispatches: int        # batched prefills, all prefill replicas
    n_replay_dispatches: int
    n_prefill_replicas: int
    n_decode_replicas: int
    n_transfers: int               # sequences shipped prefill -> decode
    wire_bytes: int                # bytes that crossed the modelled link
    wire_bytes_nodedup: int        # same transfers without page dedup
    wire_raw_bytes: int            # bf16-dense bytes of the same payloads
    dedup_page_refs: int           # pages that shipped as 13 B references
    pages_streamed: int            # pages that crossed during admission
    stream_chunk_bytes: int        # bytes of the streaming chunk frames
    pages_resent: int              # inline re-sends after receiver eviction
    store_evicted: int             # receiver-store pages evicted (LRU cap)
    decode_prefix_hits: int        # page columns reused across imports
    cache_hot_hits: int            # retained zero-ref columns re-acquired
    cache_spilled_pages: int       # payloads spilled to decode warm stores
    cache_spilled_bytes: int
    cache_fetched_pages: int       # payloads restored from warm / remote
    cache_fetched_bytes: int
    cache_reprefill_cols: int      # warm columns lost on every tier
    link_model_ms: float           # LinkModel latency of the wire bytes
    link_model_ms_raw: float       # ... of the bf16-dense baseline
    wall_s: float
    requests_per_s: float
    tokens_per_s: float
    mean_latency_s: float
    latency_p50_s: float
    latency_p95_s: float
    decode_backend: str
    ttft_mean_s: float = 0.0       # submit -> first token (prefill side)
    ttft_p50_s: float = 0.0
    ttft_p95_s: float = 0.0
    transfer_mean_s: float = 0.0   # host wall time of one deliver()

    @property
    def link_reduction(self) -> float:
        """Fractional link-byte reduction against shipping the cache
        bf16-dense: the serving analogue of the paper's Table 3 column."""
        return 1.0 - self.wire_bytes / max(self.wire_raw_bytes, 1)


def _dev(a: np.ndarray, dtype, device) -> torch.Tensor:
    """A host field (any dtype of ``dtype``'s width) as a tensor of
    ``dtype`` on ``device`` (bits kept)."""
    a = np.ascontiguousarray(a)
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(dtype).to(device)
    if dtype == torch.int32:
        return torch.from_numpy(a.view(np.int32)).to(device)
    return torch.from_numpy(a).to(device)


_WIRE_DTYPES = {"signman": torch.uint8, "planes": torch.int32,
                "dict_syms": torch.uint8, "esc_pos": torch.int32,
                "esc_raw": torch.uint8, "raw_pages": torch.bfloat16}


def blob_wire(blob: SequenceBlob, device, col0: int = 0, ti: int = 0
              ) -> Optional[cache_mod.PageWire]:
    """Shard ``ti``'s page columns of a host blob from ``col0`` on and its
    ring as a ``PageWire`` on ``device`` (one copy to the device per
    field), the form ``engine.import_slot`` scatters; None for a blob with
    no KV (an attention-free model's)."""
    kv = blob.kv
    if kv is None:
        return None
    return cache_mod.PageWire(
        **{f: _dev(kv[f][ti, :, col0:], dt, device) if f in kv else None
           for f, dt in _WIRE_DTYPES.items()},
        ring=_dev(kv["ring"][ti], torch.bfloat16, device))


def ssm_host(ssm: Optional[SSMState]):
    """A slot's SSM state (leaves (L, ...), views of the pool's) copied
    into the blob's host section of one rank: (1, L, ...) numpy leaves,
    ``h`` f32 and the rings as bf16 bits."""
    if ssm is None:
        return None

    def host(t):
        return t.to("cpu", copy=True).numpy()[None]

    return (host(ssm.h), host(ssm.conv_x.view(torch.int16)).view(np.uint16),
            host(ssm.conv_bc.view(torch.int16)).view(np.uint16))


def ssm_wire(blob: SequenceBlob, device, ti: int = 0
             ) -> Optional[SSMState]:
    """Shard ``ti``'s SSM section of a blob as an ``SSMState`` (leaves
    (L, ...)) on ``device``, or None."""
    if blob.ssm is None:
        return None
    h, cx, cbc = blob.ssm
    return SSMState(h=torch.from_numpy(np.ascontiguousarray(h[ti]))
                    .to(device),
                    conv_x=_dev(cx[ti], torch.bfloat16, device),
                    conv_bc=_dev(cbc[ti], torch.bfloat16, device))


def gather_shards(mine, group):
    """Every rank's host section (a dict or tuple of (1, ...) arrays, or
    None), stacked shard-major on the leading axis: (tp, ...); at one
    rank ``mine`` itself."""
    if mine is None or cl.world(group) == 1:
        return mine
    ranks = cl.gather_objects(mine, group)
    if isinstance(mine, dict):
        return {f: np.concatenate([r[f] for r in ranks]) for f in mine}
    return tuple(np.concatenate(a) for a in zip(*ranks))


class PrefillReplica:
    """One admission-only replica: runs the engine's batched / bucketed
    admission (and tail replay) on its own pool, then exports every
    admitted sequence instead of decoding it.  Requests that finish at
    admission (a budget of 1, EOS or stop on the first token) complete
    here and never transfer.

    ``streaming=True`` hooks the engine's ``admit_progress_cb`` and ships
    full page columns through the transport as they fill (after the
    batched trunk insert and after every replay window).  The destination
    is picked at the first chunk (``pick_dst``) and pinned into the
    handoff; the closing blob references the streamed pages by digest.
    A streamed sequence that finishes at admission aborts its stream.
    """

    def __init__(self, engine: ServeEngine,
                 transport: Optional[PageTransport] = None,
                 pick_dst: Optional[Callable[[], str]] = None,
                 streaming: bool = False):
        self.engine = engine
        self.ls: _LoopState = engine._new_loop()
        self.transport = transport
        self.pick_dst = pick_dst
        self.streaming = bool(streaming and engine.cfg.n_heads > 0)
        self._streams: Dict[int, dict] = {}   # slot -> seq_id/dst/sent cols
        if self.streaming:
            if transport is None or pick_dst is None:
                raise ValueError("streaming prefill export needs a "
                                 "transport and a destination picker")
            engine.admit_progress_cb = self._stream_progress

    @property
    def backlog(self) -> int:
        return len(self.engine.scheduler) + len(self.ls.live_slots())

    def submit(self, req: Request) -> None:
        self.engine.scheduler.submit(req)   # validates length / budget

    def idle(self) -> bool:
        return not len(self.engine.scheduler) and not self.ls.live_slots()

    def _stream_progress(self, ls: _LoopState) -> None:
        """Mid-admission hook: export and ship every freshly completed
        page column of every live slot (one export per slot and rank,
        exactly the columns from the least-sent shard's on; ``sent``
        counts per shard, ``cache.local_full_pages``)."""
        eng = self.engine
        blk = eng.run_cfg.codec.cache_block
        codec_on = bool(eng.run_cfg.codec.cache)
        tp = eng.tp
        for s in ls.live_slots():
            if ls.done[s]:
                continue               # finishing at admission: no transfer
            valid = [cache_mod.local_full_pages(ls.slot_len[s], t, blk, tp)
                     for t in range(tp)]
            st = self._streams.get(s)
            sent = st["sent"] if st is not None else [0] * tp
            if all(v <= s0 for v, s0 in zip(valid, sent)):
                continue
            col0 = min(sent)
            wire, _, _ = engine_mod.export_slot(
                eng.state, s, max(valid) - col0, col0=col0, tp=tp,
                ti=eng.rank)
            kv = gather_shards(_host_fields(wire), eng.group)
            entries = [(t, l, c, page_payload(kv, codec_on, t, l, c - col0))
                       for t in range(tp) for l in range(eng.cfg.n_layers)
                       for c in range(max(sent[t], col0), valid[t])]
            if not entries:
                continue
            if st is None:
                st = {"seq_id": self.transport.new_stream(),
                      "dst": self.pick_dst(), "sent": sent}
                self._streams[s] = st
            tr, reg = eng.tracer, self.transport.registry
            wb0 = reg.value("transport.wire_bytes")
            t0 = tr.now()
            self.transport.stream_pages(st["dst"], st["seq_id"], entries)
            if tr.enabled:
                tr.request_span(
                    ls.slot_req[s].uid, "wire_chunk", t0=t0, t1=tr.now(),
                    args={"wire_bytes":
                          reg.value("transport.wire_bytes") - wb0,
                          "pages": len(entries), "dst": st["dst"]})
            st["sent"] = [max(v, s0) for v, s0 in zip(valid, sent)]

    def admit_step(self) -> Tuple[List[RequestResult], List[Handoff]]:
        """One admission round: admit into every free slot, replay prompt
        tails (streaming full pages out as they fill, when enabled), then
        export and release every live slot as a handoff."""
        eng, ls = self.engine, self.ls
        eng._admit_phase(ls)
        eng._track_peak(ls)
        finished = eng._finish_ready(ls)    # done at admission: no transfer
        for s in list(self._streams):       # their streams never complete
            if ls.slot_req[s] is None:
                st = self._streams.pop(s)
                self.transport.abort_stream(st["dst"], st["seq_id"])
        handoffs: List[Handoff] = []
        exported = []
        tr = eng.tracer
        for s in list(ls.live_slots()):
            req = ls.slot_req[s]
            st = self._streams.pop(s, None)
            # TTFT closes here for transferred requests: the first token
            # came from admission on this replica (driver-side clock)
            ft = ls.first_tok_t.pop(req.uid, None)
            sub = eng.scheduler.submit_t.pop(req.uid, None)
            if ft is not None:
                ls.ttft_s[req.uid] = ft - (sub if sub is not None
                                           else ls.admit_t[req.uid])
            t0 = tr.now()
            blob = self._export_blob(s)
            if tr.enabled:
                tr.request_span(req.uid, "export", t0=t0, t1=tr.now(),
                                args={"raw_bytes": blob.raw_bytes,
                                      "length": blob.length,
                                      "n_cols": blob.n_cols})
            handoffs.append(Handoff(
                req=req, blob=blob, admit_t=ls.admit_t[req.uid],
                dst=st["dst"] if st is not None else None,
                seq_id=st["seq_id"] if st is not None else None))
            ls.slot_req[s] = None
            ls.slot_len[s] = 0
            exported.append(s)
        if exported:
            eng._free_slots(exported)
        return finished, handoffs

    def _export_blob(self, s: int) -> SequenceBlob:
        """Slot ``s`` as a host ``SequenceBlob``: its full pages and ring
        copied from the card (one gather per field), at tp > 1 every
        rank's shard of them (``export_n_cols`` columns each: the most any
        rank holds); an attention-free model's blob has no KV section (no
        ``_FLAG_KV``) and no columns, only its SSM state, as the
        reference's."""
        eng, ls = self.engine, self.ls
        req = ls.slot_req[s]
        length = ls.slot_len[s]
        blk, w, k, esc_cap, npad = eng._page_geometry()
        n_cols = (cache_mod.export_n_cols(length, blk, eng.tp)
                  if eng.cfg.n_heads > 0 else 0)
        wire, ssm, dev_len = engine_mod.export_slot(
            eng.state, s, n_cols, tp=eng.tp, ti=eng.rank)
        assert dev_len == length, (s, length, dev_len)
        return SequenceBlob(
            codec_on=bool(eng.run_cfg.codec.cache), tp=eng.tp,
            n_layers=eng.cfg.n_layers, n_cols=n_cols, blk=blk, w=w, k=k,
            esc_cap=esc_cap, npad=npad, length=length,
            cur_token=int(ls.cur[s, 0]), emitted=list(ls.emitted[req.uid]),
            kv=None if wire is None else gather_shards(
                _host_fields(wire, ring=True), eng.group),
            ssm=gather_shards(ssm_host(ssm), eng.group))


class DecodeReplica:
    """One decode-only replica: sequences arrive as wire blobs, scatter
    into its own pool (fresh pages from its free list), and step through
    the engine's decode windows until they finish.

    With prefix sharing on, imported sequences register their full page
    columns in the replica's tiered ``PageCache``, so a later import with
    the same prompt prefix maps the resident pages instead of allocating
    duplicates, and released columns stay hot or restorable (warm, or
    fetched back by digest from the transport's stores)."""

    def __init__(self, engine: ServeEngine):
        self.engine = engine
        self.ls: _LoopState = engine._new_loop()

    def free_slots(self) -> int:
        return len(self.engine._free_slot_ids(self.ls))

    def idle(self) -> bool:
        return not self.ls.live_slots()

    def decode_stats(self) -> Dict[str, int]:
        c = self.engine.cache
        return {"steps": self.ls.steps, "dispatches": self.ls.dispatches,
                "shared_hits": self.ls.shared_hits,
                "cache_hot_hits": c.hot_hits,
                "cache_spilled_pages": c.spilled_pages,
                "cache_spilled_bytes": c.spilled_bytes,
                "cache_fetched_pages": c.fetched_pages,
                "cache_fetched_bytes": c.fetched_bytes,
                "cache_reprefill_cols": c.reprefill_cols}

    def drop_live(self) -> int:
        """Evict every live slot and forget its request (a remote driver
        session that died mid-run can never step or collect its
        sequences).  Returns the count."""
        ls = self.ls
        live = ls.live_slots()
        for s in live:
            req = ls.slot_req[s]
            ls.slot_req[s] = None
            ls.done[s], ls.reason[s] = False, ""
            ls.emitted.pop(req.uid, None)
            ls.admit_t.pop(req.uid, None)
            ls.slot_len[s] = 0
        if live:
            self.engine._free_slots(live)
        return len(live)

    def metrics_snapshot(self) -> Dict:
        """Versioned registry snapshot of this replica's engine (the
        local counterpart of the socket METRICS RPC)."""
        return self.engine.sync_metrics(self.ls).snapshot()

    def deliver(self, h: Handoff, transport: PageTransport,
                dst: str) -> None:
        """Carry ``h`` across the transport and import it: serialize (and
        meter) the blob, parse it on the receiving side, scatter it into a
        slot.  The remote counterpart is
        ``net.client.RemoteDecodeReplica.deliver``."""
        tr, reg = self.engine.tracer, transport.registry
        wb0 = reg.value("transport.wire_bytes")
        t0 = tr.now()
        w0 = time.perf_counter()
        data = transport.send(h.blob, dst, seq_id=h.seq_id)
        blob = transport.recv(data, dst, seq_id=h.seq_id)
        reg.histogram("latency.transfer_s").observe(
            time.perf_counter() - w0)
        if tr.enabled:
            tr.request_span(
                h.req.uid, "wire", t0=t0, t1=tr.now(),
                args={"wire_bytes": reg.value("transport.wire_bytes") - wb0,
                      "raw_bytes": h.blob.raw_bytes, "dst": dst})
        t0 = tr.now()
        self.import_handoff(dataclasses.replace(h, blob=blob))
        if tr.enabled:
            tr.request_span(h.req.uid, "import", t0=t0, t1=tr.now(),
                            args={"n_cols": blob.n_cols,
                                  "length": blob.length})

    def import_handoff(self, h: Handoff) -> int:
        """Scatter a transferred sequence into a free slot; returns the
        slot.  Every check runs before any device write, so a rejected
        import leaves the pool untouched:

          * the geometry (tp, layers, page shape, codec flag) must match;
          * a free slot must exist;
          * the sequence must fit a page-table row (``n_cols <= maxp``);
          * the pool must hold enough free pages for the columns a prefix
            hit does not cover.  The port keeps one host page table for
            every layer, so its free count is every layer's; each rank
            checks its own shard and the ranks agree on the verdict: it
            rejects exactly where the reference's per-(shard, layer) check
            does.

        At tp > 1 every rank imports its own shard of the blob.
        """
        eng, ls, blob = self.engine, self.ls, h.blob
        blk, w, k, esc_cap, npad = eng._page_geometry()
        want = (eng.tp, eng.cfg.n_layers, blk, w, k, esc_cap, npad,
                bool(eng.run_cfg.codec.cache), eng.cfg.ssm is not None)
        got = (blob.tp, blob.n_layers, blob.blk, blob.w, blob.k,
               blob.esc_cap, blob.npad, blob.codec_on, blob.ssm is not None)
        if want != got:
            raise ValueError(f"wire blob geometry {got} does not match "
                             f"this decode replica {want}")
        free = eng._free_slot_ids(ls)
        if not free:
            raise RuntimeError("no free decode slot (the router must hold "
                               "handoffs until a slot frees)")
        s = free[0]
        req = h.req
        if blob.n_cols > eng._maxp:
            raise ValueError(
                f"import needs {blob.n_cols} page columns > max "
                f"{eng._maxp} per slot (decode replica max_len "
                f"{eng.max_len} too small for length {blob.length})")
        m = 0
        mkeys: List[bytes] = []
        if eng.prefix_sharing and len(req.prompt) >= blob.length:
            # prefix reuse across imports: the longest run of this
            # prompt's full page columns resident in the index
            keys = eng._prefix_keys(np.asarray(req.prompt),
                                    blob.length // eng.blk_tokens)
            while m < len(keys) and keys[m] in eng.cache.index:
                m += 1
            mkeys = keys[:m]
        ids = np.zeros((eng._maxp,), np.int32)
        for c, key in enumerate(mkeys):
            # pin the matched columns before the pressure valve runs (the
            # index holds this rank's page id)
            ids[c] = eng.cache.acquire(key)[0]
            eng._slot_keys[s].append(key)
        need = [max(blob.valid_cols(t) - m, 0) if blob.kv is not None else 0
                for t in range(eng.tp)]
        eng._ensure_free_pages(max(need))
        free_pages = eng._n_pages - (0 if eng.state.kv is None else
                                     int(eng.state.kv.page_used.sum()))
        if cl.host_max(int(free_pages < need[eng.rank]), eng.group):
            for key in mkeys:       # undo the pins: nothing written
                eng.cache.release(key)
            eng._slot_keys[s] = []
            raise RuntimeError(
                "decode-replica page pool oversubscribed: import needs "
                f"{max(need)} pages but a shard/layer has too few free "
                f"(rank {eng.rank}: {free_pages})")
        wire = blob_wire(blob, eng.device, col0=m, ti=eng.rank)
        if m:                       # map the resident shared columns first
            engine_mod.map_shared_slot(eng.state, s, ids, m,
                                       m * eng.blk_tokens)
            ls.shared_hits += m
        engine_mod.import_slot(eng.state, s, wire, blob.length, col0=m,
                               ssm_slot=ssm_wire(blob, eng.device,
                                                 eng.rank),
                               tp=eng.tp, ti=eng.rank)
        ls.slot_req[s] = req
        eng._slot_busy[s] = True
        ls.slot_len[s] = blob.length
        ls.emitted[req.uid] = list(blob.emitted)
        ls.cur[s] = blob.cur_token
        ls.admit_t[req.uid] = h.admit_t
        eng._register_prefixes([(s, np.asarray(req.prompt), blob.length)])
        eng._track_peak(ls)
        return s

    def step_window(self) -> List[RequestResult]:
        eng, ls = self.engine, self.ls
        eng._decode_window(ls)
        return eng._finish_ready(ls)


class _OnRoot:
    """An object that lives on rank 0 of ``group`` (None elsewhere), as
    every rank sees it: each attribute read or method call runs on rank 0
    and every rank gets its value or result (or its exception), so ranks
    in lock step take the same decisions from it.  An ``_OnRoot`` passed
    as an argument reaches rank 0's call as the object it wraps."""

    def __init__(self, obj, group):
        self._obj, self._group = obj, group

    def _root(self, fn):
        res = None
        if self._group.rank == 0:
            try:
                res = (True, fn())
            except Exception as e:             # re-raised on every rank
                res = (False, e)
        ok, val = cl.broadcast_object(res, self._group)
        if not ok:
            raise val
        return val

    def __getattr__(self, name):
        if self._group.rank == 0:
            attr = getattr(self._obj, name)
        is_call = self._root(lambda: callable(attr))
        if not is_call:
            return self._root(lambda: attr)

        def call(*args, **kw):
            def unwrap(a):
                return a._obj if isinstance(a, _OnRoot) else a
            return self._root(lambda: attr(
                *map(unwrap, args), **{k: unwrap(v) for k, v in kw.items()}))
        return call


def _on_root(obj, group):
    """``obj`` as every rank of ``group`` sees it (``_OnRoot``); ``obj``
    itself at one rank."""
    return obj if cl.world(group) == 1 else _OnRoot(obj, group)


class GroupReplica:
    """Rank 0's face of a decode replica whose ranks run in lock step
    behind one socket (``launch.disagg_host --tp``; ``net.server.PageHost``
    drives it as a ``DecodeReplica``): a call that changes the replica
    (an import, a decode window, dropping the live slots) goes to every
    rank with its arguments (the whole blob: each rank imports its shard)
    and returns rank 0's result; a read answers from rank 0's replica,
    whose host state every rank shares.  The other ranks run ``follow``;
    ``close`` ends it."""

    def __init__(self, replica: "DecodeReplica", group):
        self.replica, self.group = replica, group

    @property
    def engine(self):
        return self.replica.engine

    @property
    def ls(self):
        return self.replica.ls

    def _all(self, name: str, *args):
        cl.broadcast_object((name, args), self.group)
        return getattr(self.replica, name)(*args)

    def import_handoff(self, h: Handoff) -> int:
        return self._all("import_handoff", h)

    def step_window(self) -> List[RequestResult]:
        return self._all("step_window")

    def drop_live(self) -> int:
        return self._all("drop_live")

    def free_slots(self) -> int:
        return self.replica.free_slots()

    def idle(self) -> bool:
        return self.replica.idle()

    def decode_stats(self) -> Dict[str, int]:
        return self.replica.decode_stats()

    def metrics_snapshot(self) -> Dict:
        return self.replica.metrics_snapshot()

    def close(self) -> None:
        cl.broadcast_object(None, self.group)


def follow(replica: "DecodeReplica", group) -> None:
    """A decode host's rank > 0: run each call rank 0's ``GroupReplica``
    sends on this rank's replica, until ``close``.  A call that raises
    raised on rank 0 too, which reports it; the loop goes on."""
    while True:
        call = cl.broadcast_object(None, group)
        if call is None:
            return
        name, args = call
        try:
            getattr(replica, name)(*args)
        except Exception:
            pass


class DisaggEngine:
    """N prefill replicas feeding M decode replicas over a
    :class:`PageTransport`: the routing layer of the disaggregated stack.

    Construction mirrors ``ServeEngine`` (one set of parameters shared by
    every replica in the process); ``n_slots`` is per replica.  Prefill
    replicas run without prefix sharing (they export and free every slot
    each round, so their index could never hit); cross-request page reuse
    happens on the wire (transport dedup) and across imports in the decode
    replicas' prefix indexes.  ``DisaggStats`` adds the link accounting:
    wire against bf16-dense bytes, dedup references, streamed chunk
    bytes, and the ``hw.noc.LinkModel`` latency of both.

    ``streaming=True`` streams full pages during admission.
    ``decode_addrs`` replaces the in-process decode replicas with remote
    ones at the given ``host:port`` list; ``transport`` must then be a
    ``net.client.SocketTransport`` (on rank 0; the other ranks' is not
    used), and each address must run ``launch.disagg_host`` with a
    matching configuration fingerprint (``--tp`` included).

    ``group`` (a ``launch.mesh.TPGroup``) runs the fleet at tp = its
    world: every rank constructs this engine and calls ``run`` with the
    same requests (``tp``, if given, must equal the world).
    """

    def __init__(self, cfg: ModelConfig, run: RunConfig, *,
                 tp: Optional[int] = None, group=None,
                 n_prefill: int = 1, n_decode: int = 1, n_slots: int = 4,
                 max_len: int = 256, params=None, seed: int = 0,
                 eos_id: Optional[int] = None,
                 stop_seqs: Optional[Sequence[Sequence[int]]] = None,
                 max_fuse_steps: int = 32,
                 transport: Optional[PageTransport] = None,
                 streaming: bool = False,
                 decode_addrs: Optional[Sequence[str]] = None,
                 store_pages: int = 4096, compress_weights: bool = False,
                 tracer: Optional[Tracer] = None, device="cuda",
                 cuda_graphs: Optional[bool] = None):
        if n_prefill < 1 or (n_decode < 1 and decode_addrs is None):
            raise ValueError("need at least one replica of each kind")
        tp = cl.world(group) if tp is None else tp
        if tp != cl.world(group):
            raise ValueError(f"tp={tp} needs the rank's TPGroup of {tp} "
                             f"ranks, got {group}")
        self.cfg, self.run_cfg = cfg, run
        self.tp, self.group = tp, (group if tp > 1 else None)
        # one tracer for every replica: the root span opened at a prefill
        # submit closes when the decode side finishes the uid
        self.tracer = tracer if tracer is not None else Tracer(False)
        self.transport = transport if transport is not None \
            else LoopbackTransport(max_store_pages=store_pages)
        mk = dict(tp=tp, group=self.group, n_slots=n_slots, max_len=max_len,
                  seed=seed,
                  eos_id=eos_id, stop_seqs=stop_seqs,
                  max_fuse_steps=max_fuse_steps,
                  compress_weights=compress_weights, device=device,
                  cuda_graphs=cuda_graphs)
        self.decodes: List = []
        self._names: List[str] = []
        if decode_addrs is not None:
            from .net.client import RemoteDecodeReplica, SocketTransport
            from .net.framing import config_fingerprint
            root = cl.rank(self.group) == 0
            if root and not isinstance(self.transport, SocketTransport):
                raise ValueError("decode_addrs needs a SocketTransport")
            fp = config_fingerprint(cfg, run.codec, tp, n_slots, max_len,
                                    seed, eos_id=eos_id,
                                    stop_seqs=stop_seqs)
            for i, addr in enumerate(decode_addrs):
                host, _, port = str(addr).rpartition(":")
                dst = f"decode{i}"
                if root:
                    self.transport.connect(dst, host or "127.0.0.1",
                                           int(port), fp)
                self.decodes.append(_on_root(RemoteDecodeReplica(
                    self.transport, dst, tracer=self.tracer, name=dst)
                    if root else None, self.group))
                self._names.append(dst)
            # rank 0 alone talks to the hosts; every rank gets the results
            self.transport = _on_root(self.transport if root else None,
                                     self.group)
        self.prefills: List[PrefillReplica] = []

        def pick_dst() -> str:
            i = max(range(len(self.decodes)),
                    key=lambda j: self.decodes[j].free_slots())
            return self._names[i]

        for i in range(n_prefill):
            eng = ServeEngine(cfg, run, params=params, prefix_sharing=False,
                              tracer=self.tracer, name=f"prefill{i}", **mk)
            params = eng.params          # one parameter set everywhere
            self.prefills.append(PrefillReplica(
                eng, transport=self.transport, pick_dst=pick_dst,
                streaming=streaming))
        self.decode_backend = self.prefills[0].engine.decode_backend
        if decode_addrs is None:
            for i in range(n_decode):
                # decode replicas have overlapping residency: imports
                # register in their tiered PageCache
                eng = ServeEngine(cfg, run, params=params,
                                  store_pages=store_pages,
                                  tracer=self.tracer, name=f"decode{i}",
                                  **mk)
                self.decodes.append(DecodeReplica(eng))
                self._names.append(f"decode{i}")
            for i, d in enumerate(self.decodes):
                # remote tier: a payload the warm store lost comes back by
                # digest from this replica's transport-side store first
                # (pages that crossed the link land there), then its
                # peers'
                d.engine.cache.remote_fetch = self._make_fetch(
                    self._names[i])
        self.params = params

    def _make_fetch(self, own: str):
        def fetch(digests):
            out: Dict[bytes, bytes] = {}
            rest = list(digests)
            for dst in [own] + [n for n in self._names if n != own]:
                if not rest:
                    break
                out.update(self.transport.fetch(dst, rest))
                rest = [d for d in rest if d not in out]
            return out
        return fetch

    def run(self, requests: List[Request]
            ) -> Tuple[List[RequestResult], DisaggStats]:
        """Serve a request list to completion across the replica fleet."""
        uids = [r.uid for r in requests]
        if len(set(uids)) != len(uids):
            raise ValueError("request uids must be unique (token streams "
                             "are keyed by uid)")
        results: Dict[int, RequestResult] = {}
        queue = deque(requests)
        pending: deque[Handoff] = deque()   # admitted, awaiting a slot
        t0 = time.perf_counter()

        def route_submissions():
            while queue:
                pr = min(self.prefills, key=lambda p: p.backlog)
                pr.submit(queue.popleft())

        def route_handoffs():
            # streamed handoffs stick to their chunks' destination; the
            # others take the freest replica.  One rotation per round, free
            # counts read once per rotation (one STATUS round trip per
            # remote replica) and decremented on delivery.
            progress = True
            while pending and progress:
                progress = False
                free = [d.free_slots() for d in self.decodes]
                for _ in range(len(pending)):
                    h = pending.popleft()
                    i = (self._names.index(h.dst) if h.dst is not None
                         else max(range(len(free)), key=free.__getitem__))
                    if free[i] == 0:
                        pending.append(h)
                        continue
                    self.decodes[i].deliver(h, self.transport,
                                            self._names[i])
                    free[i] -= 1
                    progress = True

        route_submissions()
        while (pending or not all(p.idle() for p in self.prefills)
               or not all(d.idle() for d in self.decodes)):
            for pr in self.prefills:
                fin, hoffs = pr.admit_step()
                for r in fin:
                    results[r.uid] = r
                pending.extend(hoffs)
            route_handoffs()
            for dr in self.decodes:
                for r in dr.step_window():
                    results[r.uid] = r
            route_handoffs()    # freed slots admit waiting transfers now
        wall = time.perf_counter() - t0
        # transferred requests earn their first token on the prefill side;
        # the decode replica never saw the submit, so patch their TTFT
        ttfts: Dict[int, float] = {}
        for p in self.prefills:
            ttfts.update(p.ls.ttft_s)
        for uid, r in results.items():
            if r.ttft_s == 0.0 and uid in ttfts:
                results[uid] = dataclasses.replace(r, ttft_s=ttfts[uid])
        stats = self._stats(results, wall)
        return [results[r.uid] for r in requests], stats

    def metrics_snapshot(self) -> Dict:
        """Fleet totals: every replica's registry snapshot (local replicas
        synced in place, remote ones over the METRICS RPC) merged with the
        transport's own registry."""
        snaps = [p.engine.sync_metrics(p.ls).snapshot()
                 for p in self.prefills]
        snaps += [d.metrics_snapshot() for d in self.decodes]
        snaps.append(self.transport.registry.snapshot())
        return MetricsRegistry.merge(snaps)

    def _stats(self, results, wall: float) -> DisaggStats:
        ts: TransportStats = self.transport.stats
        pls = [p.ls for p in self.prefills]
        dst = sum_counters(d.decode_stats() for d in self.decodes)
        n_tok = sum(len(r.tokens) for r in results.values())
        lat = summarize_latencies([r.latency_s for r in results.values()])
        ttft = summarize_latencies(
            [t for l in pls for t in l.ttft_s.values()])
        xfer = self.transport.registry.values_of("latency.transfer_s")
        return DisaggStats(
            n_requests=len(results), n_tokens=n_tok,
            decode_steps=dst["steps"],
            n_dispatches=dst["dispatches"],
            n_admit_dispatches=sum(l.admit_dispatches for l in pls),
            n_replay_dispatches=sum(l.replay_dispatches for l in pls),
            n_prefill_replicas=len(self.prefills),
            n_decode_replicas=len(self.decodes),
            n_transfers=ts.n_transfers,
            wire_bytes=ts.wire_bytes,
            wire_bytes_nodedup=ts.wire_bytes_nodedup,
            wire_raw_bytes=ts.raw_bytes,
            dedup_page_refs=ts.pages_ref,
            pages_streamed=ts.pages_streamed,
            stream_chunk_bytes=ts.stream_chunk_bytes,
            pages_resent=ts.pages_resent,
            store_evicted=ts.store_evicted,
            decode_prefix_hits=dst["shared_hits"],
            cache_hot_hits=dst["cache_hot_hits"],
            cache_spilled_pages=dst["cache_spilled_pages"],
            cache_spilled_bytes=dst["cache_spilled_bytes"],
            cache_fetched_pages=dst["cache_fetched_pages"],
            cache_fetched_bytes=dst["cache_fetched_bytes"],
            cache_reprefill_cols=dst["cache_reprefill_cols"],
            link_model_ms=ts.model_ns * 1e-6,
            link_model_ms_raw=ts.model_ns_raw * 1e-6,
            wall_s=wall,
            requests_per_s=len(results) / max(wall, 1e-9),
            tokens_per_s=n_tok / max(wall, 1e-9),
            mean_latency_s=lat["mean"],
            latency_p50_s=lat["p50"], latency_p95_s=lat["p95"],
            ttft_mean_s=ttft["mean"], ttft_p50_s=ttft["p50"],
            ttft_p95_s=ttft["p95"],
            transfer_mean_s=(sum(xfer) / len(xfer)) if xfer else 0.0,
            decode_backend=self.decode_backend)


def format_disagg_stats(st: DisaggStats) -> str:
    """Human summary of a disaggregated run (demo output)."""
    return (f"{st.n_requests} reqs through {st.n_prefill_replicas} prefill "
            f"-> {st.n_decode_replicas} decode replicas "
            f"({st.decode_backend} backend): {st.tokens_per_s:.1f} tok/s, "
            f"{st.decode_steps} steps / {st.n_dispatches} dispatches\n"
            f"link: {st.n_transfers} transfers, "
            f"{st.wire_bytes / 1e3:.1f} kB wire vs "
            f"{st.wire_raw_bytes / 1e3:.1f} kB raw bf16 "
            f"({st.link_reduction * 100:.1f}% reduction; "
            f"{st.wire_bytes_nodedup / 1e3:.1f} kB codec-only, "
            f"{st.dedup_page_refs} pages deduped, "
            f"{st.pages_streamed} streamed in "
            f"{st.stream_chunk_bytes / 1e3:.1f} kB of chunks, "
            f"{st.decode_prefix_hits} import prefix hits), modeled "
            f"{st.link_model_ms:.3f} ms vs {st.link_model_ms_raw:.3f} ms")
