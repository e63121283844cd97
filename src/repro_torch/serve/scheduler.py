"""Continuous-batching request scheduler over the paged LEXI-compressed
cache (ports ``repro/serve/scheduler.py``).

``ServeEngine`` owns the parameters and one ``PagedState``;
``RequestScheduler`` is the admission queue.  The loop:

    while work:
        admit   — (a) queued requests whose prompt prefix matches full page
                  columns in the tiered ``PageCache`` take them with no
                  prefill: hot columns map into the slot's page-table row
                  (``engine.map_shared_slot``), warm ones import their
                  spilled bytes (``engine.import_slot``) (``_admit_shared``);
                  (b) the rest are drained per trunk bucket (the largest
                  power of two <= the prompt length; for SSM, MoE and MLA
                  families the prompt cut to a multiple of tp,
                  ``_bucket_of``) and prefilled
                  together in one batched pass, each sequence's blocks
                  compressed on its own (``_admit_cold_batch``); (c)
                  leftover prompt tokens (a bucket's tail or an unmatched
                  suffix) replay per slot through decode steps
                  (``_run_replays``), which are exact at every position;
        step    — one window runs K decode steps (K = the largest power of
                  two <= the earliest budget-finish, capped), one greedy
                  token per active slot and step, read back once per window
                  (``_decode_window``, ``_fuse_steps``);
        evict   — slots that hit their budget, emit ``eos_id`` or complete
                  a stop sequence release their pages at the window
                  boundary (``_check_done``, ``_finish_ready``); with
                  prefix sharing a column whose last reference goes is
                  spilled to host bytes (warm tier) and RETAINED on the
                  device (hot tier) until pool pressure evicts it
                  (``_free_slots``, ``_ensure_free_pages``).

Prefix sharing (``prefix_sharing=True``, the default, as in the
reference): full pages are immutable once compressed, so sharing is
page-table indirection.  The host keeps a ``pagecache.PageCache`` keyed
by chained SHA-256 prefix digests (``digest.chain_keys``), one key per
full page column: the hot tier maps a key to its page id, retains
zero-ref columns under an LRU and evicts them only under pool pressure;
the warm tier holds their compressed payloads in host RAM (spilled at
last release through ``engine.export_slot``, restored through
``engine.import_slot``); the remote tier is a ``remote_fetch`` callable.
Page ids come from the host page table, so no step of it reads the
device, apart from the spill's copy of the pages themselves.  MoE and
MLA auto-disable sharing, as in the reference.  Hybrids (attention ∥
SSM) cannot replay a suffix through the recurrence bit for bit, so they
share whole page-aligned prompts only: a tail-less admission captures
the slot's SSM state and first greedy token at the prompt boundary into
the PageCache (``_capture_snapshots``), and a later identical prompt maps
or imports every page column and restores that snapshot with no prefill
and no replay (``_snapshot_match``, ``_admit_snapshot``).  A hit changes
the page table and ring between windows, on the host and outside any captured
step; the captured step reads the table through ``PagedKV.ids`` and is
not captured again.

The reference fuses a window's K steps into one ``lax.scan`` dispatch
(one jitted program per K, and per replay window).  Here a window is K
steps of ``engine.PagedDecoder``: on the card each step that flushes no
ring replays one CUDA graph of the whole step (embed -> every layer ->
logits -> greedy), captured lazily at the engine's first such step; a
step in which an appending slot's ring fills runs eagerly, as every step
does on the CPU or with ``cuda_graphs=False``.  The window's tokens stay
on the device until it ends.  Streams are the same as stepping one token
at a time, graphs or not.

``compress_weights=True`` serves from the packed weight plane
(``core.weights``): bulk weights are packed once at construction, on the
parameters' device, and every matmul against them runs the backend
``CodecConfig.weight_backend`` resolves to.

Telemetry, as in the reference (``serve.telemetry``): ``tracer=``
records each request's spans (``queue``, ``admit``, ``replay``,
``decode``, the root ``request``) and the engine lane's
(``admit_batch``, ``replay_window``, ``decode_window``, ``cache_spill``,
``cache_fetch``), stamped with host clocks at window boundaries that exist
anyway: no span adds a device sync or sits inside a captured step, and a
disabled tracer changes nothing.  ``sync_metrics`` refreshes the
engine's ``MetricsRegistry`` under the reference's names.  The same loop
runs split across replicas (``serve.disagg``): a prefill replica drives
``_admit_phase`` (streaming pages through ``admit_progress_cb``), a decode
replica ``_decode_window`` on slots seeded by imports, its ``PageCache``
``remote_fetch`` wired to the transport's stores.

Tensor parallelism (``ServeEngine(group=...)``, every family it serves,
the attention-free one with no pool at any tp): one
process per rank, each running this same loop on the same requests;
the ranks agree on every decision because every input to one is the same
on all of them (the greedy tokens are, see ``engine.greedy_token``).  A
rank holds its shard of the weights and its interleaved slots of every
sequence (``models.cache``): its own page table and page use, on which it
alone acts, while the host arithmetic that sizes admissions and the pool
valve is over all ranks (``_lfp``, ``_page_growth``; ``_ensure_free_pages``
takes the largest page use of the ranks).  Trunk buckets are
power-of-two multiples of tp, prompts hold at least tp tokens, and one
prefix column covers ``cache_block * tp`` tokens.  A column's index entry
holds this rank's page id; a spilled column's payloads are every rank's,
shard-major (gathered at the spill), as the reference's.  A hybrid's
boundary snapshot is the rank's own heads' SSM state, kept in the rank's
PageCache under the same content key on every rank.  CUDA graphs at
tp > 1 are refused.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import collectives as cl
from repro_torch.core import weights as weights_mod
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import cache as cache_mod
from repro_torch.models import lm, params as PM
from repro_torch.models.ssm import SSMState
from . import engine
from . import transport
from .digest import chain_keys
from .pagecache import PageCache
from .telemetry import (ENGINE_LANE, MetricsRegistry, Tracer,
                        summarize_latencies)


@dataclasses.dataclass
class Request:
    """One generation request (greedy decoding, token budget + optional
    EOS / stop sequences).  ``eos_id`` and ``stop_seqs`` override the
    engine-level defaults when set (``stop_seqs=()`` disables stopping for
    this request even when the engine has defaults)."""
    uid: int
    prompt: np.ndarray               # (S,) int32, S >= 1
    max_new_tokens: int
    eos_id: Optional[int] = None
    stop_seqs: Optional[Sequence[Sequence[int]]] = None


@dataclasses.dataclass
class RequestResult:
    uid: int
    prompt_len: int
    tokens: List[int]                # generated (incl. EOS/stop seq if hit)
    latency_s: float                 # admit (incl. own prefill) -> finish
    stop_reason: str = "budget"      # budget | eos | stop_string
    ttft_s: float = 0.0              # submit -> first token


@dataclasses.dataclass
class ServeStats:
    n_requests: int
    n_tokens: int
    decode_steps: int                # total decode steps executed
    n_dispatches: int                # decode windows issuing those steps
    n_admit_dispatches: int          # batched-prefill admissions
    n_replay_dispatches: int         # prompt-tail replay windows
    wall_s: float
    requests_per_s: float
    tokens_per_s: float
    peak_pages: int                  # pages in use, summed over layers
    peak_cache_bytes: int            # stored bytes of those pages
    peak_cache_raw_bytes: int        # bf16 bytes of the same pages
    mean_latency_s: float
    latency_p50_s: float
    latency_p95_s: float
    decode_backend: str              # resolved cuda | torch
    ttft_mean_s: float = 0.0         # submit -> first token
    ttft_p50_s: float = 0.0
    ttft_p95_s: float = 0.0
    admit_window_mean_s: float = 0.0   # batched prefill / replay windows
    decode_window_mean_s: float = 0.0  # decode windows
    inter_token_mean_s: float = 0.0    # decode-window time per step
    # serving weight plane (core.weights): device bytes of the weight
    # store, the reference's per-decode-step weight meter (analytic)
    weights_compressed: bool = False
    weight_backend: str = "torch"      # resolved cuda | unpack | torch
    weight_bytes_per_step: int = 0     # stored (packed + raw-leaf) bytes
    weight_raw_bytes_per_step: int = 0   # same store, all bf16
    # compiled dispatch (engine.PagedDecoder): decode and replay steps run
    # eagerly (all of them without graphs; with them, the flushing ones)
    # and replayed from the captured step graph
    cuda_graphs: bool = False
    eager_steps: int = 0
    flush_steps: int = 0
    graph_replays: int = 0
    graph_captures: int = 0
    # prefix sharing: page columns mapped or imported at admission, and
    # the tiered PageCache's lifetime counters (engine lifetime)
    shared_page_hits: int = 0
    cache_hot_hits: int = 0          # retained zero-ref columns re-acquired
    cache_spilled_pages: int = 0     # page payloads written to the warm store
    cache_spilled_bytes: int = 0
    cache_fetched_pages: int = 0     # payloads restored from warm/remote
    cache_fetched_bytes: int = 0
    cache_reprefill_cols: int = 0    # warm columns lost on every tier
    cache_evicted_cols: int = 0      # hot columns evicted under pool pressure

    @property
    def cache_ratio(self) -> float:
        return self.peak_cache_raw_bytes / max(self.peak_cache_bytes, 1)

    @property
    def weight_ratio(self) -> float:
        """Packed/raw weight bytes per decode step (<= 1; 1.0 = raw)."""
        return self.weight_bytes_per_step / max(self.weight_raw_bytes_per_step,
                                                1)


def _norm_stops(stop_seqs) -> Tuple[Tuple[int, ...], ...]:
    """Normalize stop sequences to a tuple of int tuples; empty sequences
    are rejected (they would stop every request at its first token)."""
    if stop_seqs is None:
        return ()
    out = tuple(tuple(int(t) for t in s) for s in stop_seqs)
    if any(not s for s in out):
        raise ValueError("stop sequences must be non-empty")
    return out


@dataclasses.dataclass
class _LoopState:
    """Host-side mutable state of one serving loop."""
    slot_req: List[Optional[Request]]
    done: List[bool]                  # finished, awaiting eviction
    reason: List[str]
    emitted: Dict[int, List[int]]
    admit_t: Dict[int, float]
    results: Dict[int, RequestResult]
    cur: np.ndarray                   # (n_slots, 1) i32 next input tokens
    slot_len: List[int]               # host mirror of cache lengths
    steps: int = 0
    dispatches: int = 0
    admit_dispatches: int = 0
    replay_dispatches: int = 0
    shared_hits: int = 0
    peak_pages: int = 0
    first_tok_t: Dict[int, float] = dataclasses.field(default_factory=dict)
    ttft_s: Dict[int, float] = dataclasses.field(default_factory=dict)
    admit_window_s: List[float] = dataclasses.field(default_factory=list)
    decode_window_s: List[float] = dataclasses.field(default_factory=list)

    def live_slots(self) -> List[int]:
        return [s for s, r in enumerate(self.slot_req) if r is not None]


class RequestScheduler:
    """FIFO admission queue with capacity validation.

    Any prompt length >= tp admits: the trunk is bucketed to a power of
    two times tp and the leftover tokens replay through exact decode
    steps.  Same-bucket requests may admit ahead of a different-bucket
    request queued earlier in the same admission round.
    """

    def __init__(self, max_len: int, tp: int = 1):
        self.max_len = max_len
        self.tp = tp
        self.queue: deque[Request] = deque()
        # wired by the owning engine: the root request span opens at
        # submit, and submit_t feeds TTFT (first token - submit)
        self.tracer: Tracer = Tracer(False)
        self.pid = "serve"
        self.submit_t: Dict[int, float] = {}

    def submit(self, req: Request) -> None:
        s = len(req.prompt)
        if s < max(self.tp, 1):
            raise ValueError(f"prompt length {s} must be >= tp={self.tp} "
                             "(and hold at least one token)")
        if s + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request needs {s + req.max_new_tokens} tokens > "
                f"max_len={self.max_len}")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        # validate stop sequences before the request can occupy a slot
        _norm_stops(req.stop_seqs)
        self.submit_t[req.uid] = time.perf_counter()
        self.tracer.request_begin(
            req.uid, pid=self.pid,
            args={"prompt_len": s,
                  "max_new_tokens": int(req.max_new_tokens)})
        self.tracer.stage(req.uid, "queue")
        self.queue.append(req)

    def __len__(self) -> int:
        return len(self.queue)


def _host_fields(wire: cache_mod.PageWire, ring: bool = False
                 ) -> Dict[str, np.ndarray]:
    """A ``PageWire``'s page fields (and with ``ring`` its ring) on the
    host in the transport's ``(tp, L, ...)`` layout (one rank: a leading
    axis of 1), with the reference's dtypes: planes as uint32, raw bf16
    as uint16 bits (the same bytes)."""
    kv = {}
    for f in ("signman", "planes", "dict_syms", "esc_pos", "esc_raw",
              "raw_pages") + (("ring",) if ring else ()):
        t = getattr(wire, f)
        if t is None:
            continue
        if t.dtype == torch.bfloat16:
            a = t.view(torch.int16).cpu().numpy().view(np.uint16)
        else:
            a = t.cpu().numpy()
            if f == "planes":
                a = a.view(np.uint32)
        kv[f] = a[None]
    return kv


class ServeEngine:
    """Continuous-batching inference engine: one replica, on one GPU or,
    with ``tp`` > 1, one rank of a tensor-parallel group."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, *,
                 tp: Optional[int] = None, group=None, n_slots: int = 4, max_len: int = 256,
                 params=None,
                 seed: int = 0, eos_id: Optional[int] = None,
                 stop_seqs: Optional[Sequence[Sequence[int]]] = None,
                 max_fuse_steps: int = 32, prefix_sharing: bool = True,
                 store_pages: int = 4096, remote_fetch=None,
                 compress_weights: bool = False, device="cuda",
                 cuda_graphs: Optional[bool] = None,
                 tracer: Optional[Tracer] = None, name: str = "serve"):
        """``cuda_graphs``: replay decode steps from a CUDA graph (``None``:
        on a CUDA device, off on the CPU; ``True`` on the CPU raises).
        ``False`` on the card steps eagerly, e.g. to check a step from the
        host between its launches.  ``prefix_sharing``: share full prefix
        pages through the tiered ``PageCache`` (off by itself for MoE and
        MLA, whose decode is not bit-equal to their prefill);
        ``store_pages`` bounds its warm store, ``remote_fetch(digests) ->
        {digest: payload}`` is its remote tier.  ``tracer`` records the
        request and engine-lane spans (shared by a disaggregated fleet,
        whose replicas it tells apart by ``name``); ``registry`` holds
        the engine's metrics, refreshed by ``sync_metrics``.

        ``group``: this process's ``launch.mesh.TPGroup``; its world is
        the engine's tp (``tp``, if given, must equal it: without a group
        it is 1).  At tp > 1 ``params`` is the rank's shard
        (``models.params.shard_params``), and without it every rank
        builds the seed's tp = 1 weights, pads them for tp
        (``models.params.pad_for_tp``: zero padded vocab and query heads)
        and keeps its shard.  For the dense family the model is then the
        same at every tp; the SSM and MoE families compute the reference's
        tp-dependent function (``models/ssm.py``, ``models/moe.py``).

        Encoder-decoder and non-text-frontend configs are refused with the
        reference's error: they serve on the fixed loop only
        (``engine.generate``).  An attention-free config has no page pool
        (no pages, no sharing; every page count is 0)."""
        if cfg.encdec or cfg.frontend != "none":
            raise ValueError("continuous batching covers decoder-only, "
                             "text-frontend architectures")
        if max_fuse_steps < 1:
            raise ValueError("max_fuse_steps must be >= 1")
        if tp is None:
            tp = cl.world(group)
        if tp != cl.world(group):
            raise ValueError(f"tp={tp} needs the rank's TPGroup of {tp} "
                             f"ranks, got {group}")
        self.tp = tp
        self.group = group if tp > 1 else None
        self.rank = cl.rank(self.group)
        self.device = engine.resolve_device(device)
        self.cuda_graphs = engine.resolve_graphs(cuda_graphs, self.device,
                                                 tp)
        if self.device.type == "cuda":
            # f32 products (prefill attention) stay f32, as in the reference
            torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg, self.run_cfg = cfg, run
        self.n_slots, self.max_len = n_slots, max_len
        self.eos_id = eos_id
        self.stop_seqs = _norm_stops(stop_seqs)
        self.max_fuse_steps = max_fuse_steps
        # sharing needs KV pages and a decode step bit-equal to prefill at
        # prompt positions (the matched prefix skips prefill, the suffix
        # replays), which rules out MoE and MLA, as in the reference
        self.prefix_sharing = bool(prefix_sharing and cfg.n_heads > 0
                                   and cfg.moe is None and cfg.mla is None)
        self.decode_backend = kernel_ops.resolve_decode_backend(
            run.codec, self.device)
        self.table = lm.lm_table(cfg, tp)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = PM.init_params(lm.lm_table(cfg), gen,
                                    device=self.device)
            if tp > 1:
                params = PM.shard_params(PM.pad_for_tp(params, cfg, tp),
                                         self.table, tp, self.rank)
        self.params = params
        # serving weight plane: pack bulk 2-D leaves into the escape-free
        # LEXI-FW layout (idempotent on packed leaves)
        self.compress_weights = bool(compress_weights)
        self.weight_backend = kernel_ops.resolve_weight_backend(
            run.codec, self.device)
        if self.compress_weights:
            self.params = weights_mod.pack_serving_params(
                self.params, backend=self.weight_backend, table=self.table,
                tg=self.group)
        self._weight_bytes = weights_mod.weight_plane_bytes(self.params)
        # telemetry: host clocks read at window boundaries that exist
        # anyway, never a device sync; the registry is per engine
        self.name = name
        self.tracer = tracer if tracer is not None else Tracer(False)
        self.registry = MetricsRegistry()
        self.scheduler = RequestScheduler(max_len, tp)
        self.scheduler.tracer = self.tracer
        self.scheduler.pid = name
        self.state = engine.empty_paged_state(cfg, run, n_slots, max_len,
                                              device=self.device, tp=tp)
        self.decoder = engine.PagedDecoder(cfg, run, self.state,
                                           self.cuda_graphs, self.group)
        # tokens of one full page column (every rank's slots of it)
        self.blk_tokens = run.codec.cache_block * tp
        kv = self.state.kv
        self._n_pages = kv.page_used.shape[0] if kv is not None else 0
        self._maxp = kv.page_table.shape[1] if kv is not None else 0
        # host-side page lifecycle: the tiered PageCache owns the prefix
        # index, refcounts, retention LRU and warm store; _slot_keys holds
        # the prefix keys each slot has a reference on
        self.cache = PageCache(max_store_pages=store_pages,
                               remote_fetch=remote_fetch)
        self._slot_keys: List[List[bytes]] = [[] for _ in range(n_slots)]
        self._slot_busy = np.zeros((n_slots,), bool)
        # streaming prefill export: a disaggregated prefill replica sets
        # this to ship freshly completed page columns mid-admission (after
        # the batched trunk insert and after every replay window); called
        # with the loop state, None = no-op
        self.admit_progress_cb = None

    # the prefix index and refcounts live in the PageCache (views, as in
    # the reference)

    @property
    def _prefix_index(self) -> Dict[bytes, np.ndarray]:
        return self.cache.index

    @property
    def _prefix_ref(self) -> Dict[bytes, int]:
        return self.cache.ref

    # -- helpers -----------------------------------------------------------

    def _fuse_steps(self, bound: int) -> int:
        """Decode steps in the next window: the largest power of two <= the
        earliest slot-finish event, capped by ``max_fuse_steps``."""
        k = 1 << (max(bound, 1).bit_length() - 1)
        return min(k, self.max_fuse_steps)

    def _bucket_of(self, prompt_len: int) -> int:
        """Trunk bucket: the largest power-of-two multiple of tp that fits
        the prompt.  Leftover tokens replay through decode steps, which
        for pure attention are exact at prompt positions, so bucketing
        never changes streams.  Routed and recurrent layers (MoE, SSM,
        MLA) are not bit-equal between a decode step and the batched
        prefill at the same position, so those families take the largest
        multiple of tp that fits (every distinct length its own batch; the
        whole prompt at tp = 1), and a tail of fewer than tp tokens
        replays."""
        c = self.cfg
        if c.moe is not None or c.ssm is not None or c.mla is not None:
            return (prompt_len // self.tp) * self.tp
        b = self.tp
        while b * 2 <= prompt_len:
            b *= 2
        return b

    def _pages_for_length(self, length: int) -> int:
        """Pages one sequence of ``length`` tokens holds (all layers,
        summed over the ranks) — host arithmetic mirroring the flush rule,
        no device sync; none without attention."""
        if self.cfg.n_heads == 0:
            return 0
        return sum(self._lfp(length, t) for t in range(self.tp)) \
            * self.cfg.n_layers

    def _req_eos(self, req: Request) -> Optional[int]:
        return req.eos_id if req.eos_id is not None else self.eos_id

    def _req_stops(self, req: Request) -> Tuple[Tuple[int, ...], ...]:
        return (_norm_stops(req.stop_seqs) if req.stop_seqs is not None
                else self.stop_seqs)

    def _new_loop(self) -> _LoopState:
        return _LoopState(
            slot_req=[None] * self.n_slots, done=[False] * self.n_slots,
            reason=[""] * self.n_slots, emitted={}, admit_t={}, results={},
            cur=np.zeros((self.n_slots, 1), np.int32),
            slot_len=[0] * self.n_slots)

    def _track_peak(self, ls: _LoopState) -> None:
        pages = sum(self._pages_for_length(ls.slot_len[s])
                    for s in ls.live_slots())
        if self.prefix_sharing:
            pages -= self._shared_page_overcount()
        ls.peak_pages = max(ls.peak_pages, pages)

    def _shared_page_overcount(self) -> int:
        """Pages the per-slot sum counts more than once because they are
        prefix-shared: (ref - 1) per indexed column, times the ranks and
        the layers."""
        over = sum(max(r - 1, 0) for r in self._prefix_ref.values())
        return over * self.tp * self.cfg.n_layers

    def _pages_in_use(self) -> int:
        """This rank's pages in use, summed over layers (the host's page
        use)."""
        if self.state.kv is None:
            return 0
        return int(self.state.kv.page_used.sum()) * self.cfg.n_layers

    # -- prefix index ------------------------------------------------------

    def _prefix_keys(self, prompt: np.ndarray, n_cols: int) -> List[bytes]:
        """Chained content keys, one per full page column."""
        return chain_keys(prompt, n_cols, self.blk_tokens)

    def _prefix_match_cols(self, prompt: np.ndarray
                           ) -> Tuple[int, List[bytes], List[List[bytes]]]:
        """(matched column count, their keys, warm payload columns).

        The longest run of leading full page columns restorable from the
        cache: hot columns (mapped for free) extended by warm ones
        (payloads fetched and imported, no prefill).  Capped so that one
        suffix token at least replays (the first generated token needs
        the last prompt position's logits), and gated on replay cost: a
        match is taken only when the suffix to replay is no longer than
        the cold path's own bucket tail (or one column).  The gate is
        monotone in the depth, so it is checked on the deepest candidate
        before any warm bytes are fetched."""
        if not self.prefix_sharing or self.cfg.ssm is not None:
            return 0, [], []
        bt = self.blk_tokens
        keys = self._prefix_keys(prompt, (len(prompt) - 1) // bt)
        h = 0
        while h < len(keys) and keys[h] in self.cache.index:
            h += 1
        m_cand = h
        while m_cand < len(keys) and self.cache.has_warm(keys[m_cand]):
            m_cand += 1

        def ok(mm: int) -> bool:
            if mm < 1:
                return False
            suffix = len(prompt) - mm * bt
            cold_tail = len(prompt) - self._bucket_of(len(prompt))
            return suffix <= max(cold_tail, bt)

        if not ok(m_cand):
            return 0, [], []
        warm: List[List[bytes]] = []
        m = h
        with self._cache_fetch_span():
            for j in range(h, m_cand):
                payloads = self.cache.fetch_warm(keys[j])
                if payloads is None:    # gone on every tier: truncate
                    break
                warm.append(payloads)
                m += 1
        if not ok(m):
            return 0, [], []
        return m, keys[:m], warm

    def _snapshot_match(self, prompt: np.ndarray):
        """Hybrid replay-free hit: ``(keys, hot cols, warm payload
        columns, snapshot)`` when EVERY full column of this page-aligned
        prompt is restorable (hot or warm) AND its boundary SSM snapshot
        exists; None otherwise.  Partial matches stay cold: replaying a
        suffix through the recurrence is not bit-equal to prefill."""
        bt = self.blk_tokens
        if len(prompt) < bt or len(prompt) % bt != 0:
            return None
        n = len(prompt) // bt
        keys = self._prefix_keys(prompt, n)
        snap = self.cache.get_snapshot(keys[-1])
        if snap is None:
            return None
        h = 0
        while h < n and keys[h] in self.cache.index:
            h += 1
        if any(not self.cache.has_warm(keys[j]) for j in range(h, n)):
            return None
        warm: List[List[bytes]] = []
        with self._cache_fetch_span():
            for j in range(h, n):
                payloads = self.cache.fetch_warm(keys[j])
                if payloads is None:
                    return None
                warm.append(payloads)
        return keys, h, warm, snap

    def _register_prefixes(self, slots_prompts) -> None:
        """Index the freshly admitted slots' full page columns from the
        host page table.  Keys already indexed were mapped shared and
        counted at map time; new keys start at refcount 1 (their owner)."""
        if not self.prefix_sharing or not slots_prompts:
            return
        rows = self.state.kv.page_table
        for slot, prompt, length in slots_prompts:
            keys = self._prefix_keys(prompt, length // self.blk_tokens)
            for c, key in enumerate(keys):
                if key in self.cache.index:
                    continue
                ids = rows[slot, c:c + 1].copy()
                assert (ids >= 0).all(), (slot, c, ids)
                self.cache.insert(key, ids)
                self._slot_keys[slot].append(key)

    # -- slot release (tiered retention) -----------------------------------

    def _page_geometry(self) -> Tuple[int, int, int, int, int]:
        """(blk, w, k, esc_cap, npad) of one page in this pool: the
        payload geometry shared with the transport's wire format; (blk,
        0, k, 0, 0) without attention, as the reference's."""
        blk, w, n, npad, esc_cap, k = cache_mod._page_geometry(self.cfg,
                                                               self.run_cfg)
        if n == 0:
            return blk, 0, k, 0, 0
        return blk, w, k, esc_cap, npad

    @contextlib.contextmanager
    def _cache_fetch_span(self):
        """Engine-lane span over a warm / remote fetch burst.  Its byte
        args are deltas of the PageCache counters, so summed trace bytes
        equal the ``cache.*`` counters by construction."""
        tr = self.tracer
        if not tr.enabled:
            yield
            return
        c = self.cache
        t0 = tr.now()
        p0, b0 = c.fetched_pages, c.fetched_bytes
        rp0, rb0 = c.remote_pages, c.remote_bytes
        try:
            yield
        finally:
            if c.fetched_pages != p0 or c.remote_pages != rp0:
                tr.emit("cache_fetch", cat="cache", pid=self.name,
                        tid=ENGINE_LANE, t0=t0, t1=tr.now(),
                        args={"pages": c.fetched_pages - p0,
                              "bytes": c.fetched_bytes - b0,
                              "remote_pages": c.remote_pages - rp0,
                              "remote_bytes": c.remote_bytes - rb0})

    def _spill_slots(self, slots: List[int], rows: np.ndarray) -> None:
        """Export and spill every page column whose LAST reference is
        being released (hot -> warm), before the refcounts drop, while
        the releasing slot's row still addresses the pages.  Columns
        already warm skip the export.  One export per slot of the window
        of columns to spill (a copy from the card to the host; the
        reference exports a power-of-two window from column 0 to bound its
        jit cache, with the same bytes per column)."""
        tr = self.tracer
        t0 = tr.now()
        p0, b0 = self.cache.spilled_pages, self.cache.spilled_bytes
        holds: Dict[bytes, int] = {}
        for s in slots:
            for key in self._slot_keys[s]:
                holds[key] = holds.get(key, 0) + 1
        codec_on = bool(self.run_cfg.codec.cache)
        done = set()
        for s in slots:
            colof = {int(rows[s, c]): c for c in range(self._maxp)
                     if rows[s, c] >= 0}
            pend = []
            for key in self._slot_keys[s]:
                if (key in done or self.cache.has_warm(key)
                        or self.cache.ref.get(key, 0) != holds[key]):
                    continue          # other refs remain: stays hot there
                ids = self.cache.index.get(key)
                c = None if ids is None else colof.get(int(ids[0]))
                if c is None:
                    continue          # duplicate column owned elsewhere
                pend.append((key, c))
            if not pend:
                continue
            c0 = min(c for _, c in pend)
            wire, _, _ = engine.export_slot(
                self.state, s, max(c for _, c in pend) + 1 - c0, col0=c0,
                tp=self.tp, ti=self.rank)
            kv = _host_fields(wire)
            mine = [[transport.page_payload(kv, codec_on, 0, l, c - c0)
                     for l in range(self.cfg.n_layers)] for _, c in pend]
            # every rank's payloads, shard-major, as the reference spills
            ranks = cl.gather_objects(mine, self.group)
            for j, (key, _) in enumerate(pend):
                self.cache.spill(key, [p for r in ranks for p in r[j]])
                done.add(key)
        if tr.enabled and self.cache.spilled_pages != p0:
            tr.emit("cache_spill", cat="cache", pid=self.name,
                    tid=ENGINE_LANE, t0=t0, t1=tr.now(),
                    args={"pages": self.cache.spilled_pages - p0,
                          "bytes": self.cache.spilled_bytes - b0})

    def _free_slots(self, slots: List[int]) -> None:
        """Evict ``slots`` through the tiered PageCache: spill last-copy
        columns to the warm store, drop the slots' references (columns at
        zero stay RETAINED on the device under the cache's LRU), and free
        only the pages no index entry claims (decode-grown columns,
        duplicates; every page when sharing is off).  A double release
        raises: freeing a slot that is not occupied would hand its
        (possibly shared) pages back to the allocator while another
        sequence still reads them."""
        slots = [int(s) for s in slots]
        for s in slots:
            if not self._slot_busy[s]:
                raise RuntimeError(
                    f"double release: slot {s} is not occupied")
        mask = np.zeros((self.n_slots,), bool)
        mask[slots] = True
        if not self.prefix_sharing:
            engine.release_slots(self.state, mask)
        else:
            rows = self.state.kv.page_table.copy()
            self._spill_slots(slots, rows)        # 1) hot -> warm handoff
            for s in slots:                       # 2) drop references
                for key in self._slot_keys[s]:
                    self.cache.release(key)       # zero-ref -> retained
            free = np.zeros((self._n_pages,), bool)
            for s in slots:                       # 3) free unindexed pages
                keep = {int(self.cache.index[key][0])
                        for key in self._slot_keys[s]
                        if key in self.cache.index}
                for p in rows[s]:
                    if p >= 0 and int(p) not in keep:
                        free[int(p)] = True
                self._slot_keys[s] = []
            engine.release_slots(self.state, mask, free_mask=free)
        self._slot_busy[mask] = False

    def _lfp(self, length: int, t: Optional[int] = None) -> int:
        """Full page columns rank ``t`` (default: this rank) holds of a
        sequence of ``length`` tokens (host arithmetic mirroring the flush
        rule)."""
        return cache_mod.local_full_pages(
            length, self.rank if t is None else t,
            self.run_cfg.codec.cache_block, self.tp)

    def _page_growth(self, l0: int, l1: int) -> int:
        """New full pages, on the rank that gains the most, when a slot
        grows from l0 to l1 tokens."""
        return max(self._lfp(l1, t) - self._lfp(l0, t)
                   for t in range(self.tp))

    def _evict_pages(self, ids: List[np.ndarray]) -> None:
        """Free the pages of evicted hot columns (page use only: a
        zero-ref column is in no slot's row)."""
        fmask = np.zeros((self._n_pages,), bool)
        for v in ids:
            fmask[int(v[0])] = True
        engine.release_slots(self.state, np.zeros((self.n_slots,), bool),
                             free_mask=fmask)

    def _ensure_free_pages(self, need: int) -> None:
        """Make room for ``need`` fresh pages by evicting retained zero-ref
        columns (LRU order) from the hot tier: retention must never cause
        an allocation failure the free-at-zero engine could not have had.
        Called before every page-allocating admission, import, replay
        window and decode window.  Spilling happened at release, so
        eviction only clears page use."""
        if need <= 0 or not self.cache.lru or self.state.kv is None:
            return
        free = self._n_pages - cl.host_max(
            int(self.state.kv.page_used.sum()), self.group)
        ids = []
        while free + len(ids) < need and self.cache.lru:
            ids.append(self.cache.evict_lru()[1])
        if ids:
            self._evict_pages(ids)

    def drop_cache(self) -> int:
        """Evict every RETAINED (zero-ref) column and clear the warm tier;
        live slots are untouched.  Returns the hot columns dropped."""
        if not self.prefix_sharing:
            return 0
        ids = self.cache.drop_retained()
        if ids:
            self._evict_pages(ids)
        return len(ids)

    def _check_done(self, ls: _LoopState, s: int, req: Request) -> None:
        """Termination check after each emitted token.  Priority when
        several fire on the same token: eos > stop_string > budget."""
        toks = ls.emitted[req.uid]
        eos = self._req_eos(req)
        if eos is not None and toks and toks[-1] == eos:
            ls.done[s], ls.reason[s] = True, "eos"
            return
        for ss in self._req_stops(req):
            if len(toks) >= len(ss) and toks[-len(ss):] == list(ss):
                ls.done[s], ls.reason[s] = True, "stop_string"
                return
        if len(toks) >= req.max_new_tokens:
            ls.done[s], ls.reason[s] = True, "budget"

    def _first_token(self, ls: _LoopState, s: int, req: Request, t: int,
                     now: float) -> None:
        ls.emitted[req.uid] = [t]
        ls.first_tok_t[req.uid] = now
        self.tracer.stage_end(req.uid)
        ls.cur[s] = t
        self._check_done(ls, s, req)

    def _finish_ready(self, ls: _LoopState) -> List[RequestResult]:
        """Harvest done slots into results and evict them."""
        freed, fresh = [], []
        for s, req in enumerate(ls.slot_req):
            if req is None or not ls.done[s]:
                continue
            now = time.perf_counter()
            ft = ls.first_tok_t.pop(req.uid, None)
            sub = self.scheduler.submit_t.pop(req.uid, None)
            ttft = 0.0
            if ft is not None:
                ttft = ft - (sub if sub is not None else ls.admit_t[req.uid])
                ls.ttft_s[req.uid] = ttft
            res = RequestResult(
                uid=req.uid, prompt_len=len(req.prompt),
                tokens=ls.emitted[req.uid][:req.max_new_tokens],
                latency_s=now - ls.admit_t[req.uid],
                stop_reason=ls.reason[s], ttft_s=ttft)
            self.tracer.request_end(
                req.uid, args={"stop_reason": res.stop_reason,
                               "tokens": len(res.tokens)})
            ls.results[req.uid] = res
            fresh.append(res)
            ls.slot_req[s] = None
            ls.done[s], ls.reason[s] = False, ""
            freed.append(s)
        if freed:
            self._free_slots(freed)
        return fresh

    def _free_slot_ids(self, ls: _LoopState) -> List[int]:
        return [s for s in range(self.n_slots) if ls.slot_req[s] is None]

    # -- the serving loop --------------------------------------------------

    def _warm_wire(self, warm: List[List[bytes]]) -> cache_mod.PageWire:
        """Fetched warm payload columns as one import-ready ``PageWire``
        on the engine's device, with a zero ring (a warm restore is
        page-aligned, so the ring is written before it is read)."""
        blk, w, k, esc_cap, npad = self._page_geometry()
        codec_on = bool(self.run_cfg.codec.cache)
        n_layers = self.cfg.n_layers
        kv = transport.empty_page_fields(codec_on, 1, n_layers, len(warm),
                                         blk, w, k, esc_cap, npad)
        for c, payloads in enumerate(warm):
            for l in range(n_layers):   # this rank's (shard-major) payloads
                transport.scatter_page_payload(
                    kv, codec_on, 0, l, c, payloads[self.rank * n_layers + l],
                    blk=blk, w=w, k=k, esc_cap=esc_cap, npad=npad)

        def dev(a, dtype=None):
            t = torch.from_numpy(a[0])
            t = t if dtype is None else t.view(dtype)
            return t.to(self.device)

        ring = torch.zeros((n_layers, blk, w), dtype=torch.bfloat16,
                           device=self.device)
        if codec_on:
            return cache_mod.PageWire(
                signman=dev(kv["signman"]),
                planes=dev(kv["planes"].view(np.int32)),
                dict_syms=dev(kv["dict_syms"]), esc_pos=dev(kv["esc_pos"]),
                esc_raw=dev(kv["esc_raw"]), raw_pages=None, ring=ring)
        return cache_mod.PageWire(
            signman=None, planes=None, dict_syms=None, esc_pos=None,
            esc_raw=None,
            raw_pages=dev(kv["raw_pages"].view(np.int16), torch.bfloat16),
            ring=ring)

    def _admit_shared(self, ls: _LoopState, s: int, req: Request, m: int,
                      keys: List[bytes],
                      warm: List[List[bytes]]) -> None:
        """Prefix-cache hit: map the hot columns, import the warm ones
        (fetched payloads, no prefill), and leave the suffix to replay.
        Hot keys are acquired BEFORE the pool-pressure valve runs, so a
        retained column this admission maps cannot be evicted to make
        room for its own warm import."""
        h = m - len(warm)
        ls.admit_t.setdefault(req.uid, time.perf_counter())
        self.tracer.stage(req.uid, "admit",
                          args={"mode": "warm" if warm else "shared",
                                "cols": m, "warm_cols": len(warm)})
        ids = np.zeros((self._maxp,), np.int32)
        for c in range(h):
            ids[c] = self.cache.acquire(keys[c])[0]
            self._slot_keys[s].append(keys[c])
        if warm:
            self._ensure_free_pages(len(warm))
        if h:
            base_cols = h if warm else m    # the import sets the length
            engine.map_shared_slot(self.state, s, ids, h,
                                   base_cols * self.blk_tokens)
        if warm:
            engine.import_slot(self.state, s, self._warm_wire(warm),
                               m * self.blk_tokens, col0=h, tp=self.tp,
                               ti=self.rank)
        ls.shared_hits += m
        ls.slot_req[s] = req
        self._slot_busy[s] = True
        ls.slot_len[s] = m * self.blk_tokens
        ls.emitted[req.uid] = []

    def _admit_snapshot(self, ls: _LoopState, s: int, req: Request,
                        keys: List[bytes], h: int,
                        warm: List[List[bytes]], snap) -> None:
        """Hybrid snapshot hit: map or import ALL page columns and restore
        the boundary SSM state, with no prefill and no replay.  The first
        greedy token comes from the snapshot, computed by the original
        admission at the same boundary, so the stream is exact."""
        n, nr = len(keys), len(warm)
        ls.admit_t.setdefault(req.uid, time.perf_counter())
        self.tracer.stage(req.uid, "admit",
                          args={"mode": "snapshot", "cols": n,
                                "warm_cols": nr})
        ids = np.zeros((self._maxp,), np.int32)
        for c in range(h):
            ids[c] = self.cache.acquire(keys[c])[0]
            self._slot_keys[s].append(keys[c])
        if nr:
            self._ensure_free_pages(nr)
        if h:
            base_cols = h if nr else n
            engine.map_shared_slot(self.state, s, ids, h,
                                   base_cols * self.blk_tokens)
        if nr:
            engine.import_slot(self.state, s, self._warm_wire(warm),
                               n * self.blk_tokens, col0=h,
                               ssm_slot=snap["ssm"], tp=self.tp,
                               ti=self.rank)
        else:
            engine.restore_ssm(self.state, s, snap["ssm"])
        ls.shared_hits += n
        ls.slot_req[s] = req
        self._slot_busy[s] = True
        ls.slot_len[s] = n * self.blk_tokens
        self._first_token(ls, s, req, int(snap["g0"]), time.perf_counter())

    def _admit_cold_batch(self, ls: _LoopState, batch: List[Request],
                          slots: List[int], trunk: int, replays) -> None:
        """One batched prefill admits the whole bucket."""
        tr = self.tracer
        w0 = time.perf_counter()
        for r in batch:
            ls.admit_t.setdefault(r.uid, w0)
            tr.stage(r.uid, "admit", args={"mode": "cold", "bucket": trunk})
        self._ensure_free_pages(len(batch) * self._lfp(trunk))
        prompts = torch.as_tensor(np.stack([r.prompt[:trunk] for r in batch]),
                                  dtype=torch.int32, device=self.device)
        t0 = tr.now()
        logits, d = engine.prefill_sequences(self.cfg, self.run_cfg,
                                             self.params, prompts, self.group)
        engine.insert_sequences(self.cfg, self.run_cfg, self.state, d, slots,
                                self.tp)
        toks = engine.greedy_token(logits, self.group).cpu().numpy()
        ls.admit_dispatches += 1
        now = time.perf_counter()
        ls.admit_window_s.append(now - w0)
        tr.emit("admit_batch", cat="dispatch", pid=self.name,
                tid=ENGINE_LANE, t0=t0, t1=tr.now(),
                args={"bucket": trunk, "batch": len(batch)})
        for j, (req, s) in enumerate(zip(batch, slots)):
            ls.slot_req[s] = req
            self._slot_busy[s] = True
            ls.slot_len[s] = trunk
            tail = req.prompt[trunk:]
            if len(tail):
                ls.emitted[req.uid] = []
                replays.append((s, np.asarray(tail, np.int32)))
            else:
                self._first_token(ls, s, req, int(toks[j, 0]), now)
        if self.admit_progress_cb is not None:
            self.admit_progress_cb(ls)   # trunk pages exist: stream them

    def _run_replays(self, ls: _LoopState, replays) -> None:
        """Feed admitted slots' leftover prompt tokens through replay
        windows (heterogeneous lengths share a window via the feed mask);
        a slot's first generated token comes from the step consuming its
        last prompt token."""
        rem = {s: tail for s, tail in replays}
        off = {s: 0 for s in rem}
        tr = self.tracer
        for s in rem:
            tr.stage(ls.slot_req[s].uid, "replay",
                     args={"tail_tokens": len(rem[s])})
        while rem:
            longest = max(len(rem[s]) - off[s] for s in rem)
            k = self._fuse_steps(longest)
            toks = np.zeros((k, self.n_slots, 1), np.int32)
            feed = np.zeros((k, self.n_slots), bool)
            for s in rem:
                t_s = rem[s][off[s]:off[s] + k]
                toks[:len(t_s), s, 0] = t_s
                feed[:len(t_s), s] = True
            self._ensure_free_pages(sum(      # pool-pressure valve
                self._page_growth(ls.slot_len[s], ls.slot_len[s]
                                  + min(k, len(rem[s]) - off[s]))
                for s in rem))
            t0 = tr.now()
            w0 = time.perf_counter()
            seq = self.decoder.replay(
                self.params, torch.as_tensor(toks, device=self.device), feed)
            seq = seq.cpu().numpy()
            ls.replay_dispatches += 1
            now = time.perf_counter()
            ls.admit_window_s.append(now - w0)
            tr.emit("replay_window", cat="dispatch", pid=self.name,
                    tid=ENGINE_LANE, t0=t0, t1=tr.now(),
                    args={"steps": k, "slots": len(rem)})
            for s in list(rem):
                n_fed = min(k, len(rem[s]) - off[s])
                off[s] += n_fed
                ls.slot_len[s] += n_fed
                if off[s] == len(rem[s]):
                    self._first_token(ls, s, ls.slot_req[s],
                                      int(seq[n_fed - 1, s, 0]), now)
                    del rem[s]
            self._track_peak(ls)
            if self.admit_progress_cb is not None:
                self.admit_progress_cb(ls)   # ring flushes filled pages

    def _admit_phase(self, ls: _LoopState) -> None:
        """Admit until slots or admissible requests run out: prefix-cache
        hits first (queue order), then one batched prefill per trunk
        bucket; then replay every admitted slot's leftover prompt tokens
        and index the new slots' full columns.  A cold request whose first
        column another cold request of this phase already covers waits,
        so that it hits the index in the next phase."""
        replays = []
        new_slots = []
        blocked = set()       # first-column keys cold-admitted now
        q = self.scheduler.queue
        progress = True
        while progress:
            progress = False
            free = self._free_slot_ids(ls)
            if not free or not q:
                break
            if self.prefix_sharing:       # pass A: prefix-cache hits
                rest = deque()
                while q and free:
                    req = q.popleft()
                    if self.cfg.ssm is not None:  # whole-prompt hits only
                        hit = self._snapshot_match(req.prompt)
                        if hit is not None:
                            s = free.pop(0)
                            self._admit_snapshot(ls, s, req, *hit)
                            new_slots.append(s)
                            progress = True
                        else:
                            rest.append(req)
                        continue
                    m, mkeys, warm = self._prefix_match_cols(req.prompt)
                    if m >= 1:
                        s = free.pop(0)
                        self._admit_shared(ls, s, req, m, mkeys, warm)
                        replays.append(
                            (s, np.asarray(req.prompt[m * self.blk_tokens:],
                                           np.int32)))
                        new_slots.append(s)
                        progress = True
                    else:
                        rest.append(req)
                while rest:
                    q.appendleft(rest.pop())
            free = self._free_slot_ids(ls)
            if not free or not q:         # pass B: one cold bucket
                continue
            batch: List[Request] = []
            rest = deque()
            bucket = None
            while q:
                req = q.popleft()
                b = self._bucket_of(len(req.prompt))
                fk = (self._prefix_keys(req.prompt, 1)[0]
                      if self.prefix_sharing
                      and len(req.prompt) > self.blk_tokens else None)
                ok = (len(batch) < len(free) and bucket in (None, b)
                      and (fk is None or fk not in blocked))
                if ok:
                    bucket = b
                    batch.append(req)
                    if fk is not None:
                        blocked.add(fk)
                else:
                    rest.append(req)
            while rest:
                q.appendleft(rest.pop())
            if batch:
                slots = free[:len(batch)]
                self._admit_cold_batch(ls, batch, slots, bucket, replays)
                new_slots.extend(slots)
                progress = True
        self._run_replays(ls, replays)
        self._register_prefixes(
            [(s, ls.slot_req[s].prompt, ls.slot_len[s]) for s in new_slots])
        if self.prefix_sharing and self.cfg.ssm is not None:
            self._capture_snapshots(ls, new_slots)

    def _capture_snapshots(self, ls: _LoopState,
                           new_slots: List[int]) -> None:
        """Capture boundary SSM snapshots for tail-less page-aligned
        admissions (hybrids only): the recurrent state right after the
        prompt, copied to host memory, plus the first greedy token -- what
        makes a later identical prompt replay-free."""
        for s in new_slots:
            req = ls.slot_req[s]
            if req is None:
                continue
            ln = ls.slot_len[s]
            if (ln != len(req.prompt) or ln % self.blk_tokens != 0
                    or not ls.emitted.get(req.uid)):
                continue
            keys = self._prefix_keys(req.prompt, ln // self.blk_tokens)
            if self.cache.get_snapshot(keys[-1]) is not None:
                continue
            snap = SSMState(*(t[:, s].to("cpu", copy=True)
                              for t in self.state.ssm))
            self.cache.put_snapshot(keys[-1], {
                "ssm": snap, "g0": int(ls.emitted[req.uid][0])})

    def _decode_window(self, ls: _LoopState) -> None:
        """One decode window of K steps, K bounded by the earliest
        slot-finish event, so eviction and admission still happen at
        window boundaries and streams equal one-step-at-a-time decoding.
        An EOS / stop sequence inside a window finishes that request at
        its match position; its slot idles (still appending) until the
        window ends."""
        live = ls.live_slots()
        if not live:
            return
        bound = min(ls.slot_req[s].max_new_tokens
                    - len(ls.emitted[ls.slot_req[s].uid]) for s in live)
        n_steps = self._fuse_steps(bound)
        self._ensure_free_pages(sum(          # pool-pressure valve
            self._page_growth(ls.slot_len[s], ls.slot_len[s] + n_steps)
            for s in live))
        tr = self.tracer
        t0 = tr.now()
        w0 = time.perf_counter()
        seq = self.decoder.decode(
            self.params, torch.as_tensor(ls.cur, device=self.device),
            n_steps).cpu().numpy()                      # (K, n_slots, 1)
        ls.steps += n_steps
        ls.dispatches += 1
        ls.decode_window_s.append(time.perf_counter() - w0)
        t1 = tr.now()
        tr.emit("decode_window", cat="dispatch", pid=self.name,
                tid=ENGINE_LANE, t0=t0, t1=t1,
                args={"steps": n_steps, "slots": len(live),
                      "weight_bytes": n_steps * self._weight_bytes[0]})
        if tr.enabled:
            for s in live:
                tr.request_span(ls.slot_req[s].uid, "decode", t0=t0, t1=t1,
                                args={"steps": n_steps})
        for t_i in range(n_steps):
            for s in live:
                req = ls.slot_req[s]
                ls.slot_len[s] += 1  # device appends even past host-done
                if ls.done[s]:
                    continue
                t = int(seq[t_i, s, 0])
                ls.emitted[req.uid].append(t)
                ls.cur[s] = t
                self._check_done(ls, s, req)
            self._track_peak(ls)

    def sync_metrics(self, ls: _LoopState,
                     wall: Optional[float] = None) -> MetricsRegistry:
        """Refresh this engine's metrics registry from the loop state, with
        the reference's names: absolute values, safe to call repeatedly
        (the METRICS RPC calls it on every snapshot; ``_stats`` reads
        through it, so ``ServeStats`` is a view over the registry).
        ``serve.admit_compiles`` is 0: the port compiles no admission
        function (the reference counts its jitted ones).
        ``serve.pool_bytes`` is this pool's device bytes
        (``engine.paged_state_nbytes``), which differ from the
        reference's: its page tables and slot state are on the device and
        per layer, the port's on the host."""
        reg = self.registry
        c = reg.counter
        n_tok = sum(len(r.tokens) for r in ls.results.values())
        c("serve.requests").set(len(ls.results))
        c("serve.tokens").set(n_tok)
        c("serve.decode_steps").set(ls.steps)
        c("serve.decode_dispatches").set(ls.dispatches)
        c("serve.admit_dispatches").set(ls.admit_dispatches)
        c("serve.replay_dispatches").set(ls.replay_dispatches)
        c("serve.admit_compiles").set(0)
        c("serve.shared_page_hits").set(ls.shared_hits)
        reg.gauge("serve.peak_pages", agg="max").set(ls.peak_pages)
        reg.gauge("serve.pool_bytes").set(
            engine.paged_state_nbytes(self.state))
        if wall is not None:
            reg.gauge("serve.wall_s", agg="max").set(wall)
        for k, v in self.cache.counters().items():
            c(f"cache.{k}").set(v)
        reg.gauge("weights.bytes_per_step", agg="max").set(
            self._weight_bytes[0])
        reg.gauge("weights.raw_bytes_per_step", agg="max").set(
            self._weight_bytes[1])
        reg.gauge("weights.compressed", agg="max").set(
            int(self.compress_weights))
        c("weights.hbm_bytes").set(ls.steps * self._weight_bytes[0])
        reg.histogram("latency.request_s").set_values(
            [r.latency_s for r in ls.results.values()])
        reg.histogram("latency.ttft_s").set_values(list(ls.ttft_s.values()))
        reg.histogram("latency.admit_window_s").set_values(
            ls.admit_window_s)
        reg.histogram("latency.decode_window_s").set_values(
            ls.decode_window_s)
        return reg

    def _stats(self, ls: _LoopState, wall: float,
               steps0: engine.StepCounts) -> ServeStats:
        stored_pb, raw_pb = cache_mod.page_bytes(self.cfg, self.run_cfg)
        reg = self.sync_metrics(ls, wall)
        v = reg.value
        steps = self.decoder.counts
        lat = summarize_latencies(reg.values_of("latency.request_s"))
        ttft = summarize_latencies(reg.values_of("latency.ttft_s"))
        admitw = summarize_latencies(reg.values_of("latency.admit_window_s"))
        decw = summarize_latencies(reg.values_of("latency.decode_window_s"))
        n_req, n_tok = v("serve.requests"), v("serve.tokens")
        n_steps = v("serve.decode_steps")
        peak = v("serve.peak_pages")
        return ServeStats(
            n_requests=n_req, n_tokens=n_tok, decode_steps=n_steps,
            n_dispatches=v("serve.decode_dispatches"),
            n_admit_dispatches=v("serve.admit_dispatches"),
            n_replay_dispatches=v("serve.replay_dispatches"),
            wall_s=wall, requests_per_s=n_req / max(wall, 1e-9),
            tokens_per_s=n_tok / max(wall, 1e-9),
            peak_pages=peak, peak_cache_bytes=peak * stored_pb,
            peak_cache_raw_bytes=peak * raw_pb,
            mean_latency_s=lat["mean"], latency_p50_s=lat["p50"],
            latency_p95_s=lat["p95"], decode_backend=self.decode_backend,
            ttft_mean_s=ttft["mean"], ttft_p50_s=ttft["p50"],
            ttft_p95_s=ttft["p95"],
            admit_window_mean_s=admitw["mean"],
            decode_window_mean_s=decw["mean"],
            inter_token_mean_s=(sum(ls.decode_window_s) / n_steps
                                if n_steps else 0.0),
            weights_compressed=self.compress_weights,
            weight_backend=self.weight_backend,
            weight_bytes_per_step=v("weights.bytes_per_step"),
            weight_raw_bytes_per_step=v("weights.raw_bytes_per_step"),
            cuda_graphs=self.cuda_graphs,
            eager_steps=steps.eager - steps0.eager,
            flush_steps=steps.flush - steps0.flush,
            graph_replays=steps.replays - steps0.replays,
            graph_captures=steps.captures - steps0.captures,
            shared_page_hits=v("serve.shared_page_hits"),
            **{f"cache_{k}": v(f"cache.{k}")
               for k in ("hot_hits", "spilled_pages", "spilled_bytes",
                         "fetched_pages", "fetched_bytes", "reprefill_cols",
                         "evicted_cols")})

    def run(self, requests: List[Request]
            ) -> Tuple[List[RequestResult], ServeStats]:
        """Serve a request list to completion; returns results in input
        order plus engine-level stats."""
        uids = [r.uid for r in requests]
        if len(set(uids)) != len(uids):
            raise ValueError("request uids must be unique (token streams "
                             "are keyed by uid)")
        for r in requests:
            self.scheduler.submit(r)
        ls = self._new_loop()
        steps0 = dataclasses.replace(self.decoder.counts)
        t0 = time.perf_counter()
        while len(self.scheduler) or ls.live_slots():
            self._admit_phase(ls)
            self._track_peak(ls)
            self._finish_ready(ls)
            self._decode_window(ls)
            self._finish_ready(ls)
        wall = time.perf_counter() - t0
        return ([ls.results[r.uid] for r in requests],
                self._stats(ls, wall, steps0))


# ---------------------------------------------------------------------------
# demo helpers (launch/serve.py)
# ---------------------------------------------------------------------------

def demo_serving_setup(run: RunConfig, vocab_size: int, prompt_len: int,
                       new_tokens: int, n_requests: int, seed: int = 0,
                       tp: int = 1):
    """(run', max_len, requests) for a demo request stream, as the
    reference builds it: the cache block shrinks to a quarter of a rank's
    share of the prompt (at least 4), two base prompts (full and half
    length, a multiple of tp) cycle, and even-numbered requests get twice
    the token budget.  The repeats share their base's prefix pages
    (``shared_page_hits``, ``cache_hot_hits``) unless sharing is off."""
    rng = np.random.default_rng(seed)
    blk = max(4, (prompt_len // tp) // 4)
    run = dataclasses.replace(
        run, codec=dataclasses.replace(run.codec, cache_block=blk))
    max_len = prompt_len + 2 * new_tokens + blk * tp
    lens = [prompt_len, max(tp, prompt_len // 2 // tp * tp)]
    bases = [rng.integers(0, vocab_size, (n,)).astype(np.int32)
             for n in lens]
    reqs = [Request(uid=i, prompt=bases[i % len(bases)],
                    max_new_tokens=new_tokens * (2 if i % 2 == 0 else 1))
            for i in range(n_requests)]
    return run, max_len, reqs


def format_stats(st: ServeStats) -> str:
    """Six-line human summary of a serving run."""
    return (f"{st.n_requests} reqs, {st.decode_steps} decode steps in "
            f"{st.n_dispatches} windows ({st.decode_backend} backend), "
            f"{st.requests_per_s:.2f} req/s, {st.tokens_per_s:.1f} tok/s\n"
            f"admission: {st.n_admit_dispatches} batched prefills + "
            f"{st.n_replay_dispatches} replay windows, "
            f"{st.shared_page_hits} shared-prefix page hits\n"
            f"paged cache peak {st.peak_pages} pages: "
            f"{st.peak_cache_bytes / 1e3:.1f} kB stored / "
            f"{st.peak_cache_raw_bytes / 1e3:.1f} kB raw "
            f"({st.cache_ratio:.2f}x); mean request latency "
            f"{st.mean_latency_s * 1e3:.0f} ms\n"
            f"retention: {st.cache_hot_hits} hot-tier re-acquires, "
            f"{st.cache_spilled_pages} pages spilled "
            f"({st.cache_spilled_bytes / 1e3:.1f} kB), "
            f"{st.cache_fetched_pages} fetched back "
            f"({st.cache_fetched_bytes / 1e3:.1f} kB), "
            f"{st.cache_evicted_cols} columns evicted, "
            f"{st.cache_reprefill_cols} re-prefills\n"
            f"weights: "
            f"{'packed' if st.weights_compressed else 'raw bf16'} "
            f"({st.weight_backend} backend), "
            f"{st.weight_bytes_per_step / 1e3:.1f} kB HBM per decode step / "
            f"{st.weight_raw_bytes_per_step / 1e3:.1f} kB raw "
            f"({st.weight_ratio:.2f}x)\n"
            f"steps (decode and replay): {st.eager_steps} eager "
            f"({st.flush_steps} flushing a ring), {st.graph_replays} "
            f"replayed from the CUDA graph "
            f"({'on' if st.cuda_graphs else 'off'})")
