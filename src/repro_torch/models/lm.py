"""Decoder-only language model at tp = 1 (ports ``repro/models/lm.py``).

The vocabulary is padded to a multiple of 128 (``padded_vocab(1)``);
padded logit columns are masked to NEG_INF.  Collectives dropped: the
vocab-shard psum/psum_scatter of the embedding, the seq<->batch
all_to_alls of the fsdp strategy, and FSDP weight gathers (one GPU holds
every parameter).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from . import attention, blocks, layers
from .params import PDef, stack


def lm_table(cfg: ModelConfig) -> Dict:
    vp = cfg.padded_vocab(1)
    d = cfg.d_model
    t: Dict = {
        "embed": PDef((vp, d), "normal:0.02"),
        "final_norm": PDef((d,), "ones"),
        "blocks": stack(blocks.block_table(cfg), cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = PDef((d, vp), "normal:0.02")
    return t


def layer_params(params, i: int):
    """Layer ``i``'s leaves (views) of the stacked block tree."""
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return take(params["blocks"])


def embed_tokens(cfg: ModelConfig, table: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> (B, S, D) bf16 (gemma-style sqrt(d) scaling when
    the config asks for it)."""
    emb = table[tokens.to(torch.int64)]
    if cfg.scale_embeddings:
        emb = (emb.float() * float(cfg.d_model) ** 0.5).to(torch.bfloat16)
    return emb


def logits_for(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """x (B,1,D) -> (B,1,Vp) f32 logits, padded columns masked."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = layers.softcap(layers.matmul_f32(x, head), cfg.final_softcap)
    col_ok = torch.arange(head.shape[1], device=x.device) < cfg.vocab_size
    return torch.where(col_ok, logits, layers.NEG_INF)


def lm_forward(cfg: ModelConfig, run: RunConfig, params,
               tokens: torch.Tensor, want_cache: bool = False,
               cache_fn=None):
    """Trunk forward: tokens (B, S) -> (final-normed hidden (B, S, D),
    per-layer ``cache_fn(i, (k, v))`` results or None).

    ``cache_fn`` (prefill) turns each layer's rope'd K/V into its decode
    cache right away, so raw K/V of only one layer is alive at a time."""
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    spec = attention.base_attn_spec(cfg)
    wins = attention.layer_windows(cfg)
    x = embed_tokens(cfg, params["embed"], tokens)
    caches = [] if want_cache else None
    for i in range(cfg.n_layers):
        win: Optional[int] = None if wins is None else int(wins[i])
        x, kv = blocks.block_forward(cfg, run, layer_params(params, i), x,
                                     positions, spec, window=win,
                                     want_cache=want_cache)
        if want_cache:
            caches.append(cache_fn(i, kv) if cache_fn is not None else kv)
    return layers.rms_norm(x, params["final_norm"], cfg.norm_eps), caches
