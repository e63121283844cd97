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
  ``decode_attend`` kernel.  ``generate`` is prefill + N greedy steps.

Continuous batching (driven by ``serve.scheduler.ServeEngine``):
  admit  — ``prefill_sequences`` runs the trunk over a batch of
           same-length prompts, compressing each sequence's blocks on its
           own; ``insert_sequences`` copies them into fresh pages;
  step   — ``paged_decode_step``: every active slot appends at its own
           length (the ring flushes into a fresh page when full) and
           attends through its page table; one greedy token per slot;
  evict  — ``release_slots`` frees a finished slot's pages.

Port-specific: lengths live on the host — ``DecodeState.length`` as an
int, ``PagedState``'s slot lengths and occupancy in numpy next to the
host-side page table (see ``models.cache``) — so ring-flush decisions and
page allocation cost no device sync; the device sees them as small
per-step index tensors.  State updates happen in place.  Collectives
dropped at tp = 1: every psum/pmax/pmin of the decode block, the logits
broadcast and ``greedy_token``'s cross-shard argmax.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import attention, blocks, cache as cache_mod, layers
from repro_torch.models import lm


@dataclasses.dataclass
class DecodeState:
    """Fixed-batch decode state: every layer's batch-shared block store
    (group = B); all B sequences hold ``length`` tokens."""
    kv: List[cache_mod.KVBlocks]       # one per layer
    length: int


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
                 kv: cache_mod.KVBlocks, length: int, spec: layers.AttnSpec,
                 window=None) -> torch.Tensor:
    """One layer's fixed-batch decode step: the new token at position
    ``length`` of every sequence; ``kv`` updated in place."""
    pos = torch.full((x.shape[0],), length, dtype=torch.int32,
                     device=x.device)

    def attend(q, new_vals):
        cache_mod.append_token(cfg, run, kv, new_vals, length)
        return cache_mod.attend_cache(cfg, run, kv, q, length + 1, spec,
                                      window=window)

    return _attn_block(cfg, p, x, pos, attend)


def decode_step(cfg: ModelConfig, run: RunConfig, params, state: DecodeState,
                tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, 1) -> logits (B, 1, Vp); every sequence advances one
    token (state updated in place)."""
    x = lm.embed_tokens(cfg, params["embed"], tokens)      # (B,1,D)
    spec = attention.base_attn_spec(cfg)
    wins = attention.layer_windows(cfg)
    for i in range(cfg.n_layers):
        x = decode_block(cfg, run, lm.layer_params(params, i), x,
                         state.kv[i], state.length, spec,
                         window=None if wins is None else int(wins[i]))
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    state.length += 1
    return lm.logits_for(cfg, params, x)


def generate(cfg: ModelConfig, run: RunConfig, params, prompts: torch.Tensor,
             new_tokens: int, max_len: int) -> torch.Tensor:
    """The reference launcher's fixed-batch loop: prefill, then
    ``new_tokens`` greedy decode steps.  prompts (B, S) -> (B,
    new_tokens + 1) int32: the greedy token after the prompt and after
    each step."""
    logits, state = prefill(cfg, run, params, prompts, max_len)
    tok = greedy_token(logits)
    outs = [tok]
    for _ in range(new_tokens):
        tok = greedy_token(decode_step(cfg, run, params, state, tok))
        outs.append(tok)
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
                       plan: cache_mod.AppendPlan, pos: torch.Tensor,
                       post: torch.Tensor, spec: layers.AttnSpec,
                       window=None) -> torch.Tensor:
    """One layer's decode step at per-slot positions.  x (S,1,D); ``pos``
    (S,) rope positions, ``post`` (S,) int32 lengths including the new
    token.  Inactive slots leave their cache untouched (their outputs are
    garbage the scheduler drops)."""
    def attend(q, new_vals):
        cache_mod.append_token_paged(cfg, run, kv, layer, new_vals, plan)
        return cache_mod.attend_paged(cfg, run, kv, layer, q, post, spec,
                                      window=window)

    return _attn_block(cfg, p, x, pos, attend)


def paged_decode_step(cfg: ModelConfig, run: RunConfig, params,
                      state: PagedState, tokens: torch.Tensor
                      ) -> torch.Tensor:
    """tokens (S, 1) -> logits (S, 1, Vp); every active slot advances one
    token at its own position (state updated in place)."""
    dev = tokens.device
    plan = cache_mod.plan_append(run, state.kv, state.lengths, state.active)
    pos = torch.tensor(state.lengths, device=dev)
    post = torch.tensor(state.lengths + state.active.astype(np.int32),
                        device=dev)
    x = lm.embed_tokens(cfg, params["embed"], tokens)      # (S,1,D)
    spec = attention.base_attn_spec(cfg)
    wins = attention.layer_windows(cfg)
    for i in range(cfg.n_layers):
        x = paged_decode_block(
            cfg, run, lm.layer_params(params, i), i, x, state.kv, plan, pos,
            post, spec, window=None if wins is None else int(wins[i]))
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    state.lengths += state.active.astype(np.int32)
    return lm.logits_for(cfg, params, x)


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
    """Replay K known tokens per slot through the decode path.

    ``tokens`` (K, S, 1) are fed where ``feed`` (K, S) is True; slots not
    fed at a step are inactive for it (cache and length untouched).
    Returns the per-step greedy tokens (K, S, 1); the scheduler reads a
    slot's first generated token from the step that consumed its last
    prompt token."""
    active = state.active.copy()
    out = []
    for t in range(tokens.shape[0]):
        state.active = active & feed[t]
        out.append(greedy_token(paged_decode_step(cfg, run, params, state,
                                                  tokens[t])))
    state.active = active
    return torch.stack(out)


def release_slots(state: PagedState, mask: np.ndarray) -> PagedState:
    """Evict finished sequences: free their pages, clear their slots."""
    cache_mod.release_pages(state.kv, mask)
    state.lengths[mask] = 0
    state.active[mask] = False
    return state
