"""Serving engine (ports ``repro/serve/engine.py``) at tp = 1: prefill,
then greedy decode over a LEXI-compressed KV cache, in two dataflows that
share the per-layer compute (``_attn_block``):

Fixed batch (the reference's original research loop; ``launch/serve.py``
without ``--continuous``):
  ``prefill`` runs the trunk over B same-length prompts and builds each
  layer's batch-shared block store (group = B: one compressed record per
  block for all B sequences) as it goes; ``decode_step`` advances all B
  sequences in lockstep from one shared length — per layer the new token
  goes into the ring (a full ring is compressed into the next block) and
  ``cache.attend_cache`` attends [blocks ‖ ring] through the
  ``decode_attend`` kernel.  ``generate`` is prefill + N greedy steps
  (``FixedDecoder``).

Continuous batching (driven by ``serve.scheduler.ServeEngine``):
  admit  — ``prefill_sequences`` runs the trunk over a batch of
           same-length prompts, compressing each sequence's blocks on its
           own; ``insert_sequences`` copies them into fresh pages;
  step   — ``paged_decode_step``: every active slot appends at its own
           length (the ring flushes into a fresh page when full) and
           attends through its page table; one greedy token per slot
           (``PagedDecoder`` runs the scheduler's decode and replay
           windows);
  evict  — ``release_slots`` frees a finished slot's pages.

Compiled dispatch: the reference jits each decode window (a ``lax.scan``
of K steps) and the fixed loop; here ``PagedDecoder`` and
``FixedDecoder`` replay one captured CUDA graph of a step
(``kernels.ops.CapturedStep``) for every step that flushes no ring, and
run the flushing steps eagerly.  Graph and eager steps run the same code
on the same buffers, so streams and cache bytes are the same either way.

Port-specific: lengths live on the host — ``DecodeState.length`` as an
int, ``PagedState``'s slot lengths and occupancy in numpy next to the
host-side page table (see ``models.cache``) — so ring-flush decisions and
page allocation cost no device sync; the device sees them through
tensors that stay put (the fixed store's device length, the pool's page
table and step buffer), refreshed in place.  State updates happen in
place.  Collectives
dropped at tp = 1: every psum/pmax/pmin of the decode block, the logits
broadcast and ``greedy_token``'s cross-shard argmax.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import attention, blocks, cache as cache_mod, layers
from repro_torch.models import lm


@dataclasses.dataclass
class DecodeState:
    """Fixed-batch decode state: every layer's batch-shared block store
    (group = B); all B sequences hold ``length`` tokens, a host int that
    decides the ring flushes, kept equal to ``length_dev``, the same
    count as a 0-d int32 on the stores' device that the step's device
    work reads (rope positions, ring row, attention length)."""
    kv: List[cache_mod.KVBlocks]       # one per layer
    length: int
    length_dev: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.length_dev is None:
            self.length_dev = torch.tensor(self.length, dtype=torch.int32,
                                           device=self.kv[0].ring.device)


@dataclasses.dataclass
class PrefilledSequences:
    """``prefill_sequences`` output: per-layer single-sequence block
    stores (group = 1), ``length`` tokens each, for ``insert_sequences``."""
    kv: List[cache_mod.KVBlocks]       # one per layer, leading axis B
    length: int


@dataclasses.dataclass
class PagedState:
    """Slot-based decode state.  ``lengths``/``active`` are per slot and
    shared by every layer (a sequence is at the same position in all)."""
    kv: cache_mod.PagedKV
    lengths: np.ndarray                # (n_slots,) int32 tokens per slot
    active: np.ndarray                 # (n_slots,) bool slot occupied


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    """(B, 1, V) -> (B, 1) int32 argmax (first maximum on ties)."""
    return logits.argmax(-1).to(torch.int32)


def kv_payload(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B,Hkv,S,hd) k, v -> (B, S, W) cache payload, W laid out
    (Hkv, 2, hd) like ``attention.decode_qkv``'s new values."""
    b, hkv, s, hd = k.shape
    return torch.stack([k, v], dim=2).permute(0, 3, 1, 2, 4) \
        .reshape(b, s, hkv * 2 * hd)


def _prefill(cfg: ModelConfig, run: RunConfig, params, tokens: torch.Tensor,
             stores: List[cache_mod.KVBlocks]) -> torch.Tensor:
    """tokens (B, S) -> last-position logits (B,1,Vp); layer i's K/V fills
    the empty block store ``stores[i]`` in place.

    Each layer's K/V is compressed inside the layer loop (``lm_forward``'s
    ``cache_fn``), so raw K/V of one layer only is alive at a time."""
    def to_blocks(i, kv):
        return cache_mod.fill_from_prefill(cfg, run, stores[i],
                                           kv_payload(*kv))

    x, _ = lm.lm_forward(cfg, run, params, tokens, want_cache=True,
                         cache_fn=to_blocks)
    return lm.logits_for(cfg, params, x[:, -1:])


def empty_state(cfg: ModelConfig, run: RunConfig, batch: int, max_len: int,
                device="cpu") -> DecodeState:
    """Zeroed fixed-batch state: one batch-shared store per layer."""
    return DecodeState(
        kv=[cache_mod.empty_kv(cfg, run, batch, max_len, group=batch,
                               device=device)
            for _ in range(cfg.n_layers)],
        length=0)


def prefill(cfg: ModelConfig, run: RunConfig, params, tokens: torch.Tensor,
            max_len: int) -> Tuple[torch.Tensor, DecodeState]:
    """Fixed batch: tokens (B, S) -> (last-position logits (B,1,Vp),
    DecodeState) with room for ``max_len`` tokens per sequence."""
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len={max_len}")
    state = empty_state(cfg, run, b, max_len, device=tokens.device)
    logits = _prefill(cfg, run, params, tokens, state.kv)
    state.length = s
    state.length_dev.fill_(s)
    return logits, state


def prefill_sequences(cfg: ModelConfig, run: RunConfig, params,
                      tokens: torch.Tensor
                      ) -> Tuple[torch.Tensor, PrefilledSequences]:
    """Continuous batching: tokens (B, S) -> (last-position logits
    (B,1,Vp), each sequence's blocks compressed on its own)."""
    b, s = tokens.shape
    stores = [cache_mod.empty_kv(cfg, run, b, s, device=tokens.device)
              for _ in range(cfg.n_layers)]
    logits = _prefill(cfg, run, params, tokens, stores)
    return logits, PrefilledSequences(kv=stores, length=s)


def _attn_block(cfg: ModelConfig, p, x: torch.Tensor, pos: torch.Tensor,
                attend) -> torch.Tensor:
    """One layer's decode step around its cache: x (B,1,D), ``pos`` (B,)
    rope positions; ``attend(q, new_vals)`` appends the new K/V and returns
    the merged attention (B,Hq,1,hd) bf16."""
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, new_vals = attention.decode_qkv(cfg, p["attn"], h, pos)
    out = attention.decode_out(cfg, p["attn"], attend(q, new_vals)) \
        .to(torch.bfloat16)
    if cfg.post_norm:
        out = layers.rms_norm(out, p["ln1b"], cfg.norm_eps)
    return blocks.mlp(cfg, p, x + out)


def decode_block(cfg: ModelConfig, run: RunConfig, p, x: torch.Tensor,
                 kv: cache_mod.KVBlocks, length: int,
                 length_dev: torch.Tensor, post: torch.Tensor,
                 spec: layers.AttnSpec, window=None) -> torch.Tensor:
    """One layer's fixed-batch decode step: the new token at position
    ``length`` (host int, for the flush; ``length_dev`` the same on the
    device) of every sequence, ``post`` = length + 1 on the device; ``kv``
    updated in place."""
    pos = length_dev.expand(x.shape[0])

    def attend(q, new_vals):
        cache_mod.append_token(cfg, run, kv, new_vals, length, length_dev)
        return cache_mod.attend_cache(cfg, run, kv, q, post, spec,
                                      window=window)

    return _attn_block(cfg, p, x, pos, attend)


def _fixed_forward(cfg: ModelConfig, run: RunConfig, params,
                   state: DecodeState, tokens: torch.Tensor) -> torch.Tensor:
    """The device work of one fixed-batch step: tokens (B, 1) -> logits,
    ``state.length_dev`` advanced; the host length is read (to decide the
    flush) but not advanced.  Without a flush it has the same shapes and
    addresses at every length (``FixedDecoder`` captures it)."""
    x = lm.embed_tokens(cfg, params["embed"], tokens)      # (B,1,D)
    spec = attention.base_attn_spec(cfg)
    wins = attention.layer_windows(cfg)
    post = state.length_dev + 1
    for i in range(cfg.n_layers):
        x = decode_block(cfg, run, lm.layer_params(params, i), x,
                         state.kv[i], state.length, state.length_dev, post,
                         spec, window=None if wins is None else int(wins[i]))
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    state.length_dev.copy_(post)
    return lm.logits_for(cfg, params, x)


def decode_step(cfg: ModelConfig, run: RunConfig, params, state: DecodeState,
                tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, 1) -> logits (B, 1, Vp); every sequence advances one
    token (state updated in place)."""
    logits = _fixed_forward(cfg, run, params, state, tokens)
    state.length += 1
    return logits


def resolve_graphs(cuda_graphs: Optional[bool], device) -> bool:
    """Whether decode replays CUDA graphs: by default on a CUDA device and
    not on the CPU; ``True`` on the CPU raises."""
    on_cuda = torch.device(device).type == "cuda"
    if cuda_graphs is None:
        return on_cuda
    if cuda_graphs and not on_cuda:
        raise ValueError("cuda_graphs=True needs a CUDA device")
    return bool(cuda_graphs)


@dataclasses.dataclass
class StepCounts:
    """Decode steps a decoder ran: eagerly (every step without graphs;
    with them, the steps whose ring flush cannot be captured), flushing
    (a subset of the eager ones) and as replays of the captured step."""
    eager: int = 0
    flush: int = 0
    replays: int = 0
    captures: int = 0


class FixedDecoder:
    """The fixed-batch loop's steps (``generate``): each step feeds
    ``tok`` (B, 1) int32 and leaves its greedy tokens there.  A step whose
    ring write fills the ring (``length % blk == blk - 1``, known on the
    host) runs eagerly; with ``graphs``, every other step replays one
    captured ``decode_step`` + greedy, captured at the first such step."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, params,
                 state: DecodeState, tok: torch.Tensor, graphs: bool):
        self.cfg, self.run, self.params, self.state = cfg, run, params, state
        self.tok = tok.to(torch.int32).clone()
        self.graphs = graphs
        self.graph = None
        self.counts = StepCounts()

    def _body(self) -> None:
        self.tok.copy_(greedy_token(_fixed_forward(
            self.cfg, self.run, self.params, self.state, self.tok)))

    def _warmup(self) -> None:
        """One step on the capture stream, then the state put back: the
        ring row it wrote (every layer), the device length and the
        tokens."""
        st, blk = self.state, self.run.codec.cache_block
        r = st.length % blk
        keep = [kv.ring[:, r].clone() for kv in st.kv]
        tok, length = self.tok.clone(), st.length_dev.clone()
        self._body()
        for kv, row in zip(st.kv, keep):
            kv.ring[:, r] = row
        self.tok.copy_(tok)
        st.length_dev.copy_(length)

    def step(self) -> None:
        st, blk = self.state, self.run.codec.cache_block
        if (st.length + 1) // blk > st.kv[0].nblk:
            raise ValueError(f"length {st.length + 1} does not fit the "
                             f"store's blocks of {blk} and the ring")
        if self.graphs and self.state.length % blk != blk - 1:
            if self.graph is None:
                self.graph = kops.CapturedStep(self._body, self._warmup,
                                               self.tok.device)
                self.counts.captures += 1
            self.graph.replay()
            self.counts.replays += 1
        else:
            self._body()
            self.counts.eager += 1
            self.counts.flush += self.state.length % blk == blk - 1
        self.state.length += 1


def generate(cfg: ModelConfig, run: RunConfig, params, prompts: torch.Tensor,
             new_tokens: int, max_len: int) -> torch.Tensor:
    """The reference launcher's fixed-batch loop: prefill, then
    ``new_tokens`` greedy decode steps (``FixedDecoder``: from a CUDA
    graph on the card, eagerly on the CPU).  prompts (B, S) ->
    (B, new_tokens + 1) int32: the greedy token after the prompt and after
    each step."""
    logits, state = prefill(cfg, run, params, prompts, max_len)
    dec = FixedDecoder(cfg, run, params, state, greedy_token(logits),
                       resolve_graphs(None, prompts.device))
    outs = [dec.tok.clone()]
    for _ in range(new_tokens):
        dec.step()
        outs.append(dec.tok.clone())
    return torch.cat(outs, dim=1)


def empty_paged_state(cfg: ModelConfig, run: RunConfig, n_slots: int,
                      max_len: int, n_pages: Optional[int] = None,
                      device="cpu") -> PagedState:
    """Zeroed paged state with a page pool sized for ``n_slots``."""
    return PagedState(
        kv=cache_mod.empty_paged_kv(cfg, run, n_slots, max_len,
                                    n_pages=n_pages, device=device),
        lengths=np.zeros((n_slots,), np.int32),
        active=np.zeros((n_slots,), bool))


def paged_state_nbytes(state: PagedState) -> int:
    """Device bytes of the paged state (pools and rings), from shapes."""
    kv = state.kv
    return sum(t.numel() * t.element_size() for t in
               (kv.signman, kv.planes, kv.dict_syms, kv.esc_pos, kv.esc_raw,
                kv.raw_pages, kv.ring) if t is not None)


def paged_decode_block(cfg: ModelConfig, run: RunConfig, p, layer: int,
                       x: torch.Tensor, kv: cache_mod.PagedKV,
                       plan: cache_mod.AppendPlan, spec: layers.AttnSpec,
                       window=None) -> torch.Tensor:
    """One layer's decode step at per-slot positions.  x (S,1,D); the
    plan's ``pos`` (S,) are the rope positions, ``post`` (S,) the lengths
    including the new token.  Inactive slots leave their cache untouched
    (their outputs are garbage the scheduler drops)."""
    def attend(q, new_vals):
        cache_mod.append_token_paged(cfg, run, kv, layer, new_vals, plan)
        return cache_mod.attend_paged(cfg, run, kv, layer, q, plan.post,
                                      spec, window=window)

    return _attn_block(cfg, p, x, plan.pos, attend)


def _paged_forward(cfg: ModelConfig, run: RunConfig, params,
                   kv: cache_mod.PagedKV, plan: cache_mod.AppendPlan,
                   tokens: torch.Tensor) -> torch.Tensor:
    """The device work of one paged step: tokens (S, 1) -> logits (S, 1,
    Vp).  Every value it reads comes through ``plan`` (views of the
    pool's step buffer) and the pool's persistent tensors, so without a
    flush it has the same shapes and addresses every step
    (``PagedDecoder`` captures it)."""
    x = lm.embed_tokens(cfg, params["embed"], tokens)      # (S,1,D)
    spec = attention.base_attn_spec(cfg)
    wins = attention.layer_windows(cfg)
    for i in range(cfg.n_layers):
        x = paged_decode_block(
            cfg, run, lm.layer_params(params, i), i, x, kv, plan, spec,
            window=None if wins is None else int(wins[i]))
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm.logits_for(cfg, params, x)


def paged_decode_step(cfg: ModelConfig, run: RunConfig, params,
                      state: PagedState, tokens: torch.Tensor
                      ) -> torch.Tensor:
    """tokens (S, 1) -> logits (S, 1, Vp); every active slot advances one
    token at its own position (state updated in place)."""
    dec = PagedDecoder(cfg, run, state, graphs=False)
    dec.tok.copy_(tokens)
    return dec.forward(params)


class PagedDecoder:
    """The continuous-batching engine's decode and replay steps over one
    ``PagedState``.  Each step feeds ``tok`` (S, 1) int32 and leaves its
    greedy tokens there.  A step in which an appending slot's ring fills
    runs eagerly (its flush compresses pages, with shapes that depend on
    the flushing slots); with ``graphs``, every other step replays one
    captured step (embed -> the layers -> final norm -> logits -> greedy
    into ``tok``), captured at the first such step and again whenever the
    parameters change.  Host lengths advance on every step and are staged
    to the device before it (``cache.stage_append``), so eviction and
    admission between steps are visible to the graph."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, state: PagedState,
                 graphs: bool):
        self.cfg, self.run, self.state = cfg, run, state
        self.tok = torch.zeros((len(state.lengths), 1), dtype=torch.int32,
                               device=state.kv.ring.device)
        self.graphs = graphs
        self.graph, self.params = None, None
        self.counts = StepCounts()

    def _body(self, plan: cache_mod.AppendPlan) -> None:
        self.tok.copy_(greedy_token(_paged_forward(
            self.cfg, self.run, self.params, self.state.kv, plan, self.tok)))

    def _capture(self, params, active: np.ndarray) -> None:
        """Capture the step.  Its warm-up runs the step with no slot
        active (every ring row written back as it was, nothing flushed)
        and puts the tokens back; then the step in hand is staged again."""
        self.params = params
        st, kv = self.state, self.state.kv
        tok = self.tok.clone()

        def warmup():
            cache_mod.stage_append(self.run, kv, st.lengths,
                                   np.zeros_like(active))
            self._body(cache_mod.device_plan(kv))
            self.tok.copy_(tok)

        self.graph = kops.CapturedStep(
            lambda: self._body(cache_mod.device_plan(kv)), warmup,
            self.tok.device)
        self.counts.captures += 1
        cache_mod.stage_append(self.run, kv, st.lengths, active)

    def forward(self, params, active: Optional[np.ndarray] = None
                ) -> Optional[torch.Tensor]:
        """One step of the slots in ``active`` (default: the occupied
        ones) from ``tok``: replayed from the graph, which leaves its
        greedy tokens in ``tok`` (returns None), or run eagerly (returns
        its logits (S, 1, Vp); ``tok`` unchanged)."""
        st = self.state
        act = st.active if active is None else active
        flush = cache_mod.stage_append(self.run, st.kv, st.lengths, act)
        logits = None
        if self.graphs and not len(flush[0]):
            if self.graph is None or params is not self.params:
                self._capture(params, act)
            self.graph.replay()
            self.counts.replays += 1
        else:
            logits = _paged_forward(self.cfg, self.run, params, st.kv,
                                    cache_mod.device_plan(st.kv, *flush),
                                    self.tok)
            self.counts.eager += 1
            self.counts.flush += bool(len(flush[0]))
        st.lengths += act.astype(np.int32)
        return logits

    def step(self, params, active: Optional[np.ndarray] = None) -> None:
        """``forward``, with its greedy tokens left in ``tok``."""
        logits = self.forward(params, active)
        if logits is not None:
            self.tok.copy_(greedy_token(logits))

    def decode(self, params, tokens: torch.Tensor, n_steps: int
               ) -> torch.Tensor:
        """``n_steps`` greedy steps of the occupied slots from tokens (S,
        1): (n_steps, S, 1) int32, on the device."""
        self.tok.copy_(tokens)
        out = torch.empty((n_steps,) + tuple(self.tok.shape),
                          dtype=torch.int32, device=self.tok.device)
        for i in range(n_steps):
            self.step(params)
            out[i].copy_(self.tok)
        return out

    def replay(self, params, tokens: torch.Tensor, feed: np.ndarray
               ) -> torch.Tensor:
        """Feed K known tokens per slot: ``tokens`` (K, S, 1) where ``feed``
        (K, S) is True; a slot not fed at a step is inactive for it (cache
        and length untouched).  Returns the per-step greedy tokens (K, S,
        1) on the device."""
        out = torch.empty(tuple(tokens.shape), dtype=torch.int32,
                          device=self.tok.device)
        for t in range(tokens.shape[0]):
            self.tok.copy_(tokens[t])
            self.step(params, self.state.active & feed[t])
            out[t].copy_(self.tok)
        return out


def insert_sequences(cfg: ModelConfig, run: RunConfig, state: PagedState,
                     d: PrefilledSequences, slots) -> PagedState:
    """Insert a prefilled batch (``prefill_sequences``' output, B sequences
    of ``d.length`` tokens) into free slots ``slots`` (in place)."""
    slots = np.asarray(slots, np.int64)
    cache_mod.paged_insert_many(cfg, run, state.kv, d.kv, slots, d.length)
    state.lengths[slots] = d.length
    state.active[slots] = True
    return state


def paged_replay_steps(cfg: ModelConfig, run: RunConfig, params,
                       state: PagedState, tokens: torch.Tensor,
                       feed: np.ndarray) -> torch.Tensor:
    """Replay K known tokens per slot through the decode path, eagerly.

    ``tokens`` (K, S, 1) are fed where ``feed`` (K, S) is True; slots not
    fed at a step are inactive for it (cache and length untouched).
    Returns the per-step greedy tokens (K, S, 1); the scheduler reads a
    slot's first generated token from the step that consumed its last
    prompt token."""
    return PagedDecoder(cfg, run, state, graphs=False).replay(
        params, tokens, feed)


def release_slots(state: PagedState, mask: np.ndarray) -> PagedState:
    """Evict finished sequences: free their pages, clear their slots."""
    cache_mod.release_pages(state.kv, mask)
    state.lengths[mask] = 0
    state.active[mask] = False
    return state
