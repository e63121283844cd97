"""Config registry: ``get_config(name)`` and reduced smoke variants.

A copy of ``repro/configs/__init__.py`` without the JAX input specs
(``input_specs``/``batch_axes`` serve the TPU dry run, which the port does
not have yet).  The arch files are data only and are kept byte-for-byte,
so every ``ModelConfig`` reprs exactly as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from .base import (LONG_500K, DECODE_32K, PREFILL_32K, TRAIN_4K, SHAPES,
                   MeshConfig, ModelConfig, RunConfig, ShapeConfig,
                   shape_applicable)

_MODULES = {
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "hymba-1.5b": "hymba_1p5b",
    "qwen2.5-32b": "qwen2p5_32b",
    "codeqwen1.5-7b": "codeqwen1p5_7b",
    "gemma2-9b": "gemma2_9b",
    "qwen3-4b": "qwen3_4b",
    "mamba2-370m": "mamba2_370m",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "internvl2-76b": "internvl2_76b",
    # paper's own models (benchmark suite)
    "jamba-tiny-dev": "jamba_tiny",
    "zamba2-1.2b": "zamba2_1p2b",
    "qwen1.5-1.8b": "qwen1p5_1p8b",
}

ASSIGNED_ARCHS = list(_MODULES)[:10]
PAPER_ARCHS = list(_MODULES)[10:]


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def make_reduced(cfg: ModelConfig, tp: int = 1) -> ModelConfig:
    """Structure-preserving tiny variant for CPU smoke tests.

    Keeps every architectural feature (GQA ratios, MLA, MoE top-k, SSM,
    windows, softcaps) while shrinking width/depth/vocab.
    """
    d = 128
    heads = 0 if cfg.n_heads == 0 else max(4, min(cfg.n_heads, 8))
    kv = 0 if cfg.n_kv_heads == 0 else max(1, heads * cfg.n_kv_heads
                                           // max(cfg.n_heads, 1))
    changes: Dict = dict(
        n_layers=min(cfg.n_layers, 2 if cfg.attn_layout != "hymba_3global"
                     else 3),
        d_model=d, n_heads=heads, n_kv_heads=kv,
        head_dim=0 if heads == 0 else 16,
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab_size=min(cfg.vocab_size, 1009),   # odd: exercises padding
        window=None if cfg.window is None else 16,
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, n_experts=max(8, tp), top_k=min(cfg.moe.top_k, 2),
            d_ff=64)
    if cfg.mla is not None:
        changes["mla"] = dataclasses.replace(
            cfg.mla, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_dim=16)
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, headdim=16, chunk=16)
    if cfg.n_frontend_tokens:
        changes["n_frontend_tokens"] = 8
    return dataclasses.replace(cfg, **changes)


__all__ = [
    "ASSIGNED_ARCHS", "PAPER_ARCHS", "SHAPES", "get_config", "make_reduced",
    "MeshConfig", "ModelConfig", "RunConfig", "ShapeConfig",
    "shape_applicable", "LONG_500K", "DECODE_32K", "PREFILL_32K", "TRAIN_4K",
]
