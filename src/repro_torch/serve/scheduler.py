"""Continuous-batching request scheduler over the paged LEXI-compressed
cache (ports ``repro/serve/scheduler.py`` at tp = 1).

``ServeEngine`` owns the parameters and one ``PagedState``;
``RequestScheduler`` is the admission queue.  The loop:

    while work:
        admit   — queued requests are drained per trunk bucket (the largest
                  power of two <= the prompt length) and prefilled together
                  in one batched pass, each sequence's blocks compressed on
                  its own (``_admit_cold_batch``); leftover prompt tokens
                  replay per slot through decode steps (``_run_replays``),
                  which are exact at every position;
        step    — one window runs K decode steps (K = the largest power of
                  two <= the earliest budget-finish, capped), one greedy
                  token per active slot and step, read back once per window
                  (``_decode_window``, ``_fuse_steps``);
        evict   — slots that hit their budget, emit ``eos_id`` or complete
                  a stop sequence release their pages at the window
                  boundary (``_check_done``, ``_finish_ready``).

The reference fuses a window's K steps into one ``lax.scan`` dispatch; here
they are a plain loop of K eager steps whose tokens stay on the device
until the window ends (CUDA graphs are a later change).  Streams are the
same as stepping one token at a time.

``compress_weights=True`` serves from the packed weight plane
(``core.weights``): bulk weights are packed once at construction, on the
parameters' device, and every matmul against them runs the backend
``CodecConfig.weight_backend`` resolves to.

Left out of this slice: prefix sharing and the tiered PageCache (the port
runs ``prefix_sharing=False``; the reference's streams are unchanged by
sharing), request tracing, and disaggregated replicas.  Dropped with the
mesh at one GPU: the shard_map wrappers and the leading per-shard axis of
every state leaf.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import weights as weights_mod
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import cache as cache_mod
from repro_torch.models import lm, params as PM
from . import engine


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

    @property
    def cache_ratio(self) -> float:
        return self.peak_cache_raw_bytes / max(self.peak_cache_bytes, 1)

    @property
    def weight_ratio(self) -> float:
        """Packed/raw weight bytes per decode step (<= 1; 1.0 = raw)."""
        return self.weight_bytes_per_step / max(self.weight_raw_bytes_per_step,
                                                1)


def summarize_latencies(values: Sequence[float]) -> Dict[str, float]:
    """mean/p50/p95 of a latency sample, 0.0 on empty."""
    lats = sorted(float(v) for v in values)
    if not lats:
        return {"mean": 0.0, "p50": 0.0, "p95": 0.0}
    return {"mean": float(np.mean(lats)),
            "p50": float(np.percentile(lats, 50)),
            "p95": float(np.percentile(lats, 95))}


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
    peak_pages: int = 0
    first_tok_t: Dict[int, float] = dataclasses.field(default_factory=dict)
    ttft_s: Dict[int, float] = dataclasses.field(default_factory=dict)
    admit_window_s: List[float] = dataclasses.field(default_factory=list)
    decode_window_s: List[float] = dataclasses.field(default_factory=list)

    def live_slots(self) -> List[int]:
        return [s for s, r in enumerate(self.slot_req) if r is not None]


class RequestScheduler:
    """FIFO admission queue with capacity validation.

    Any prompt length >= 1 admits: the trunk is bucketed to a power of
    two and the leftover tokens replay through exact decode steps.
    Same-bucket requests may admit ahead of a different-bucket request
    queued earlier in the same admission round.
    """

    def __init__(self, max_len: int):
        self.max_len = max_len
        self.queue: deque[Request] = deque()
        self.submit_t: Dict[int, float] = {}

    def submit(self, req: Request) -> None:
        s = len(req.prompt)
        if s < 1:
            raise ValueError("prompt must hold at least one token")
        if s + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request needs {s + req.max_new_tokens} tokens > "
                f"max_len={self.max_len}")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        # validate stop sequences before the request can occupy a slot
        _norm_stops(req.stop_seqs)
        self.submit_t[req.uid] = time.perf_counter()
        self.queue.append(req)

    def __len__(self) -> int:
        return len(self.queue)


def resolve_device(device) -> torch.device:
    """The serving device: CUDA unless the caller asks for the CPU; a
    CUDA request on a machine without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to serve on "
                           "the CPU")
    return dev


class ServeEngine:
    """Continuous-batching inference engine (one GPU)."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, *,
                 n_slots: int = 4, max_len: int = 256, params=None,
                 seed: int = 0, eos_id: Optional[int] = None,
                 stop_seqs: Optional[Sequence[Sequence[int]]] = None,
                 max_fuse_steps: int = 32, prefix_sharing: bool = False,
                 compress_weights: bool = False, device="cuda"):
        if prefix_sharing:
            raise NotImplementedError(
                "prefix sharing is not ported yet (streams are the same "
                "without it)")
        if max_fuse_steps < 1:
            raise ValueError("max_fuse_steps must be >= 1")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # f32 products (prefill attention) stay f32, as in the reference
            torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg, self.run_cfg = cfg, run
        self.n_slots, self.max_len = n_slots, max_len
        self.eos_id = eos_id
        self.stop_seqs = _norm_stops(stop_seqs)
        self.max_fuse_steps = max_fuse_steps
        self.decode_backend = kernel_ops.resolve_decode_backend(
            run.codec, self.device)
        self.table = lm.lm_table(cfg)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = PM.init_params(self.table, gen, device=self.device)
        self.params = params
        # serving weight plane: pack bulk 2-D leaves into the escape-free
        # LEXI-FW layout (idempotent on packed leaves)
        self.compress_weights = bool(compress_weights)
        self.weight_backend = kernel_ops.resolve_weight_backend(
            run.codec, self.device)
        if self.compress_weights:
            self.params = weights_mod.pack_serving_params(
                self.params, backend=self.weight_backend)
        self._weight_bytes = weights_mod.weight_plane_bytes(self.params)
        self.scheduler = RequestScheduler(max_len)
        self.state = engine.empty_paged_state(cfg, run, n_slots, max_len,
                                              device=self.device)

    # -- helpers -----------------------------------------------------------

    def _fuse_steps(self, bound: int) -> int:
        """Decode steps in the next window: the largest power of two <= the
        earliest slot-finish event, capped by ``max_fuse_steps``."""
        k = 1 << (max(bound, 1).bit_length() - 1)
        return min(k, self.max_fuse_steps)

    @staticmethod
    def _bucket_of(prompt_len: int) -> int:
        """Trunk bucket: the largest power of two that fits the prompt.
        Leftover tokens replay through decode steps, which for pure
        attention are exact at prompt positions, so bucketing never
        changes streams."""
        b = 1
        while b * 2 <= prompt_len:
            b *= 2
        return b

    def _pages_for_length(self, length: int) -> int:
        """Pages one sequence of ``length`` tokens holds (all layers) —
        host arithmetic mirroring the flush rule, no device sync."""
        return (length // self.run_cfg.codec.cache_block) * self.cfg.n_layers

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
        ls.peak_pages = max(ls.peak_pages, pages)

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
            ls.results[req.uid] = res
            fresh.append(res)
            ls.slot_req[s] = None
            ls.done[s], ls.reason[s] = False, ""
            freed.append(s)
        if freed:
            mask = np.zeros((self.n_slots,), bool)
            mask[freed] = True
            engine.release_slots(self.state, mask)
        return fresh

    # -- the serving loop --------------------------------------------------

    def _admit_cold_batch(self, ls: _LoopState, batch: List[Request],
                          slots: List[int], trunk: int, replays) -> None:
        """One batched prefill admits the whole bucket."""
        w0 = time.perf_counter()
        for r in batch:
            ls.admit_t.setdefault(r.uid, w0)
        prompts = torch.as_tensor(np.stack([r.prompt[:trunk] for r in batch]),
                                  dtype=torch.int32, device=self.device)
        logits, d = engine.prefill(self.cfg, self.run_cfg, self.params,
                                   prompts)
        engine.insert_sequences(self.cfg, self.run_cfg, self.state, d, slots)
        toks = engine.greedy_token(logits).cpu().numpy()
        ls.admit_dispatches += 1
        now = time.perf_counter()
        ls.admit_window_s.append(now - w0)
        for j, (req, s) in enumerate(zip(batch, slots)):
            ls.slot_req[s] = req
            ls.slot_len[s] = trunk
            tail = req.prompt[trunk:]
            if len(tail):
                ls.emitted[req.uid] = []
                replays.append((s, np.asarray(tail, np.int32)))
            else:
                self._first_token(ls, s, req, int(toks[j, 0]), now)

    def _run_replays(self, ls: _LoopState, replays) -> None:
        """Feed admitted slots' leftover prompt tokens through replay
        windows (heterogeneous lengths share a window via the feed mask);
        a slot's first generated token comes from the step consuming its
        last prompt token."""
        rem = {s: tail for s, tail in replays}
        off = {s: 0 for s in rem}
        while rem:
            longest = max(len(rem[s]) - off[s] for s in rem)
            k = self._fuse_steps(longest)
            toks = np.zeros((k, self.n_slots, 1), np.int32)
            feed = np.zeros((k, self.n_slots), bool)
            for s in rem:
                t_s = rem[s][off[s]:off[s] + k]
                toks[:len(t_s), s, 0] = t_s
                feed[:len(t_s), s] = True
            w0 = time.perf_counter()
            seq = engine.paged_replay_steps(
                self.cfg, self.run_cfg, self.params, self.state,
                torch.as_tensor(toks, device=self.device), feed)
            seq = seq.cpu().numpy()
            ls.replay_dispatches += 1
            now = time.perf_counter()
            ls.admit_window_s.append(now - w0)
            for s in list(rem):
                n_fed = min(k, len(rem[s]) - off[s])
                off[s] += n_fed
                ls.slot_len[s] += n_fed
                if off[s] == len(rem[s]):
                    self._first_token(ls, s, ls.slot_req[s],
                                      int(seq[n_fed - 1, s, 0]), now)
                    del rem[s]
            self._track_peak(ls)

    def _admit_phase(self, ls: _LoopState) -> None:
        """Admit until slots or requests run out, one batched prefill per
        trunk bucket, then replay every admitted slot's leftover tokens."""
        replays = []
        q = self.scheduler.queue
        while True:
            free = [s for s in range(self.n_slots) if ls.slot_req[s] is None]
            if not free or not q:
                break
            batch: List[Request] = []
            rest = deque()
            bucket = None
            while q:
                req = q.popleft()
                b = self._bucket_of(len(req.prompt))
                if len(batch) < len(free) and bucket in (None, b):
                    bucket = b
                    batch.append(req)
                else:
                    rest.append(req)
            while rest:
                q.appendleft(rest.pop())
            self._admit_cold_batch(ls, batch, free[:len(batch)], bucket,
                                   replays)
        self._run_replays(ls, replays)

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
        w0 = time.perf_counter()
        tok = torch.as_tensor(ls.cur, device=self.device)
        out = []
        for _ in range(n_steps):
            logits = engine.paged_decode_step(self.cfg, self.run_cfg,
                                              self.params, self.state, tok)
            tok = engine.greedy_token(logits)
            out.append(tok)
        seq = torch.stack(out).cpu().numpy()            # (K, n_slots, 1)
        ls.steps += n_steps
        ls.dispatches += 1
        ls.decode_window_s.append(time.perf_counter() - w0)
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

    def _stats(self, ls: _LoopState, wall: float) -> ServeStats:
        stored_pb, raw_pb = cache_mod.page_bytes(self.cfg, self.run_cfg)
        lat = summarize_latencies([r.latency_s for r in ls.results.values()])
        ttft = summarize_latencies(list(ls.ttft_s.values()))
        n_req = len(ls.results)
        n_tok = sum(len(r.tokens) for r in ls.results.values())
        return ServeStats(
            n_requests=n_req, n_tokens=n_tok, decode_steps=ls.steps,
            n_dispatches=ls.dispatches,
            n_admit_dispatches=ls.admit_dispatches,
            n_replay_dispatches=ls.replay_dispatches,
            wall_s=wall, requests_per_s=n_req / max(wall, 1e-9),
            tokens_per_s=n_tok / max(wall, 1e-9),
            peak_pages=ls.peak_pages,
            peak_cache_bytes=ls.peak_pages * stored_pb,
            peak_cache_raw_bytes=ls.peak_pages * raw_pb,
            mean_latency_s=lat["mean"], latency_p50_s=lat["p50"],
            latency_p95_s=lat["p95"], decode_backend=self.decode_backend,
            ttft_mean_s=ttft["mean"], ttft_p50_s=ttft["p50"],
            ttft_p95_s=ttft["p95"],
            admit_window_mean_s=summarize_latencies(
                ls.admit_window_s)["mean"],
            decode_window_mean_s=summarize_latencies(
                ls.decode_window_s)["mean"],
            inter_token_mean_s=(sum(ls.decode_window_s) / ls.steps
                                if ls.steps else 0.0),
            weights_compressed=self.compress_weights,
            weight_backend=self.weight_backend,
            weight_bytes_per_step=self._weight_bytes[0],
            weight_raw_bytes_per_step=self._weight_bytes[1])

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
        t0 = time.perf_counter()
        while len(self.scheduler) or ls.live_slots():
            self._admit_phase(ls)
            self._track_peak(ls)
            self._finish_ready(ls)
            self._decode_window(ls)
            self._finish_ready(ls)
        wall = time.perf_counter() - t0
        return [ls.results[r.uid] for r in requests], self._stats(ls, wall)


# ---------------------------------------------------------------------------
# demo helpers (launch/serve.py)
# ---------------------------------------------------------------------------

def demo_serving_setup(run: RunConfig, vocab_size: int, prompt_len: int,
                       new_tokens: int, n_requests: int, seed: int = 0):
    """(run', max_len, requests) for a demo request stream, as the
    reference builds it at tp = 1: the cache block shrinks to a quarter of
    the prompt (at least 4), two base prompts (full and half length)
    cycle, and even-numbered requests get twice the token budget."""
    rng = np.random.default_rng(seed)
    blk = max(4, prompt_len // 4)
    run = dataclasses.replace(
        run, codec=dataclasses.replace(run.codec, cache_block=blk))
    max_len = prompt_len + 2 * new_tokens + blk
    lens = [prompt_len, max(1, prompt_len // 2)]
    bases = [rng.integers(0, vocab_size, (n,)).astype(np.int32)
             for n in lens]
    reqs = [Request(uid=i, prompt=bases[i % len(bases)],
                    max_new_tokens=new_tokens * (2 if i % 2 == 0 else 1))
            for i in range(n_requests)]
    return run, max_len, reqs


def format_stats(st: ServeStats) -> str:
    """Four-line human summary of a serving run."""
    return (f"{st.n_requests} reqs, {st.decode_steps} decode steps in "
            f"{st.n_dispatches} windows ({st.decode_backend} backend), "
            f"{st.requests_per_s:.2f} req/s, {st.tokens_per_s:.1f} tok/s\n"
            f"admission: {st.n_admit_dispatches} batched prefills + "
            f"{st.n_replay_dispatches} replay windows\n"
            f"paged cache peak {st.peak_pages} pages: "
            f"{st.peak_cache_bytes / 1e3:.1f} kB stored / "
            f"{st.peak_cache_raw_bytes / 1e3:.1f} kB raw "
            f"({st.cache_ratio:.2f}x); mean request latency "
            f"{st.mean_latency_s * 1e3:.0f} ms\n"
            f"weights: "
            f"{'packed' if st.weights_compressed else 'raw bf16'} "
            f"({st.weight_backend} backend), "
            f"{st.weight_bytes_per_step / 1e3:.1f} kB HBM per decode step / "
            f"{st.weight_raw_bytes_per_step / 1e3:.1f} kB raw "
            f"({st.weight_ratio:.2f}x)")
