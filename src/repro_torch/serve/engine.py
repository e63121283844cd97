"""Serving engine: prefill, and slot-based decode over the paged
LEXI-compressed cache (ports the continuous-batching half of
``repro/serve/engine.py``) at tp = 1.

Dataflow (driven by ``serve.scheduler.ServeEngine``):

  admit  — ``prefill`` runs the trunk over a batch of same-length prompts,
           turning each layer's K/V into per-sequence compressed blocks as
           it goes; ``insert_sequences`` copies them into fresh pages;
  step   — ``paged_decode_step``: every active slot appends at its own
           length (the ring flushes into a fresh page when full) and
           attends through its page table; one greedy token per slot;
  evict  — ``release_slots`` frees a finished slot's pages.

Port-specific: ``PagedState`` keeps slot lengths and occupancy on the host
(numpy), next to the host-side page table (see ``models.cache``), so page
allocation and ring-flush decisions cost no device sync; the device sees
them as small per-step index tensors.  State updates happen in place.
Collectives dropped at tp = 1: every psum/pmax/pmin of the decode block,
the logits broadcast and ``greedy_token``'s cross-shard argmax.
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
    """Prefill output: per-layer single-sequence block stores."""
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


def prefill(cfg: ModelConfig, run: RunConfig, params,
            tokens: torch.Tensor) -> Tuple[torch.Tensor, DecodeState]:
    """tokens (B, S) -> (last-position logits (B,1,Vp), DecodeState).

    Each layer's K/V is compressed into per-sequence blocks inside the
    layer loop (``lm_forward``'s ``cache_fn``), so raw K/V of one layer
    only is alive at a time."""
    b, s = tokens.shape

    def to_blocks(_, kv):
        store = cache_mod.empty_kv(cfg, run, b, s, device=tokens.device)
        return cache_mod.fill_from_prefill(cfg, run, store, kv_payload(*kv))

    x, caches = lm.lm_forward(cfg, run, params, tokens, want_cache=True,
                              cache_fn=to_blocks)
    logits = lm.logits_for(cfg, params, x[:, -1:])
    return logits, DecodeState(kv=caches, length=s)


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
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, new_vals = attention.decode_qkv(cfg, p["attn"], h, pos)
    cache_mod.append_token_paged(cfg, run, kv, layer, new_vals, plan)
    merged = cache_mod.attend_paged(cfg, run, kv, layer, q, post, spec,
                                    window=window)
    out = attention.decode_out(cfg, p["attn"], merged).to(torch.bfloat16)
    if cfg.post_norm:
        out = layers.rms_norm(out, p["ln1b"], cfg.norm_eps)
    return blocks.mlp(cfg, p, x + out)


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
                     d: DecodeState, slots) -> PagedState:
    """Insert a prefilled batch (``prefill``'s DecodeState, B sequences
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
