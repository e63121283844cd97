"""Decoder-only language model (ports ``repro/models/lm.py``).

The vocabulary is padded to a multiple of tp * 128 (``padded_vocab``) and,
at tp > 1, sharded over the ranks (rows of ``embed``, columns of
``lm_head``); padded logit columns are masked to NEG_INF.  The embedding
is a vocab-sharded lookup whose partials (exactly one nonzero per token)
are reduce-scattered over the sequence in prefill (the trunk's
sequence-sharded layout) or summed in decode; logits stay vocab-sharded
(``serve.engine.greedy_token`` reduces them).  Not ported: the
seq <-> batch all_to_alls of the fsdp strategy and FSDP weight gathers
(serving runs one replica).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import collectives as cl
from . import attention, blocks, layers
from .params import PDef, stack


def lm_table(cfg: ModelConfig, tp: int = 1) -> Dict:
    vp = cfg.padded_vocab(tp)
    d = cfg.d_model
    t: Dict = {
        "embed": PDef((vp, d), "normal:0.02", spec=("model", None)),
        "final_norm": PDef((d,), "ones"),
        "blocks": stack(blocks.block_table(cfg, tp), cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = PDef((d, vp), "normal:0.02", spec=(None, "model"))
    return t


def layer_params(params, i: int):
    """Layer ``i``'s leaves (views) of the stacked block tree; a
    ``PackedWeight`` leaf slices all its packed fields."""
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return take(params["blocks"])


def embed_tokens(cfg: ModelConfig, table: torch.Tensor,
                 tokens: torch.Tensor, tg=None,
                 scatter: bool = False) -> torch.Tensor:
    """tokens (B, S) -> (B, S, D) bf16 (gemma-style sqrt(d) scaling when
    the config asks for it).  At tp > 1 ``tokens`` are the same on every
    rank and ``table`` the rank's vocab rows: each rank looks up its rows
    (zero elsewhere) and the partials are reduce-scattered over the
    sequence (``scatter``: (B, S/tp, D), prefill) or summed (decode)."""
    if cl.world(tg) == 1:
        emb = table[tokens.to(torch.int64)]
    else:
        v_loc = table.shape[0]
        idx = tokens.to(torch.int64) - tg.rank * v_loc
        ok = (idx >= 0) & (idx < v_loc)
        emb = torch.where(ok[..., None], table[idx.clamp(0, v_loc - 1)],
                          torch.zeros((), dtype=table.dtype,
                                      device=table.device))
        emb = cl.psum_scatter(emb, tg, 1) if scatter else cl.psum(emb, tg)
    if cfg.scale_embeddings:
        emb = (emb.float() * float(cfg.d_model) ** 0.5).to(torch.bfloat16)
    return emb


def logits_for(cfg: ModelConfig, params, x: torch.Tensor,
               tg=None) -> torch.Tensor:
    """x (B,1,D) -> (B,1,Vp) f32 logits, padded columns masked (at tp > 1
    the rank's Vp/tp columns).  A packed ``lm_head`` goes through
    ``layers.matmul_f32`` like every weight."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = layers.softcap(layers.matmul_f32(x, head), cfg.final_softcap)
    v_loc = head.shape[1]
    col_ok = cl.rank(tg) * v_loc + torch.arange(v_loc, device=x.device) \
        < cfg.vocab_size
    return torch.where(col_ok, logits, layers.NEG_INF)


def lm_forward(cfg: ModelConfig, run: RunConfig, params,
               tokens: torch.Tensor, want_cache: bool = False,
               cache_fn=None, groups: int = 1, tg=None):
    """Trunk forward: tokens (B, S) -> (final-normed hidden (B, S, D),
    per-layer ``cache_fn(i, kv, ssm_state)`` results or None).  At tp > 1
    (``tg``) every rank takes the whole of ``tokens`` and returns its
    sequence shard (B, S/tp, D) of the hidden state (S % tp == 0).

    ``cache_fn`` (prefill) turns each layer's cache payload -- its rope'd
    (k, v), or an MLA layer's latent (B, S, W) -- (and, for a hybrid, its
    final ``SSMState``, else None) into its decode cache right away, so
    the raw tensors of only one layer are alive at a time.  Without
    ``cache_fn`` the list holds the (kv, ssm_state) pairs.  The B
    sequences run as ``groups`` separate prefills (``B``: each sequence
    on its own): MoE layers dispatch each group's tokens on their own, and
    at tp > 1 the gathers compress each group's activations on their
    own."""
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    spec = attention.base_attn_spec(cfg)
    wins = attention.layer_windows(cfg)
    if s % cl.world(tg):
        raise ValueError(f"prefill of {s} tokens does not split over tp "
                         f"{cl.world(tg)}")
    x = embed_tokens(cfg, params["embed"], tokens, tg, scatter=True)
    caches = [] if want_cache else None
    for i in range(cfg.n_layers):
        win: Optional[int] = None if wins is None else int(wins[i])
        x, kv, st = blocks.block_forward(cfg, run, layer_params(params, i),
                                         x, positions, spec, window=win,
                                         want_cache=want_cache,
                                         groups=groups, tg=tg)
        if want_cache:
            caches.append(cache_fn(i, kv, st) if cache_fn is not None
                          else (kv, st))
    return layers.rms_norm(x, params["final_norm"], cfg.norm_eps), caches
