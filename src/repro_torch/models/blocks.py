"""Dense transformer blocks at tp = 1 (ports ``repro/models/blocks.py``).

Collectives dropped: the ``lexi_all_gather`` of the normalised activations
and the ``psum_scatter`` of the mixer/FFN outputs.  At tp = 1 the
reference's gather still round-trips activations through
``fixed.compress``/``decompress``, which is the identity as long as no
escape overflows its side channel; the port has no such round trip (the
tests check that the reference's gathers saw no overflow on their inputs).
The mixer output is rounded to bf16 before the residual add, as the
reference's bf16 reduce-scatter does.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from . import attention, layers
from .params import PDef


def mlp_table(cfg: ModelConfig) -> Dict[str, PDef]:
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": PDef((d, f)), "w_up": PDef((d, f)),
            "w_down": PDef((f, d))}


def block_table(cfg: ModelConfig) -> Dict:
    """Parameter table for ONE dense layer (unstacked)."""
    if cfg.n_heads == 0 or cfg.ssm is not None or cfg.moe is not None \
            or cfg.encdec or not cfg.d_ff:
        raise NotImplementedError(
            f"{cfg.name}: only the dense attention + MLP family is ported")
    d = cfg.d_model
    t: Dict = {"ln1": PDef((d,), "ones"), "attn": attention.attn_table(cfg)}
    if cfg.post_norm:
        t["ln1b"] = PDef((d,), "ones")
    t["ln2"] = PDef((d,), "ones")
    t["mlp"] = mlp_table(cfg)
    if cfg.post_norm:
        t["ln2b"] = PDef((d,), "ones")
    return t


def mlp(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """The FFN sub-block with its residual: x + W_down(swiglu(...))."""
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    m = p["mlp"]
    act = layers.swiglu(layers.pdot(h, m["w_gate"]),
                        layers.pdot(h, m["w_up"]))
    y = layers.matmul_f32(act, m["w_down"]).to(torch.bfloat16)
    if cfg.post_norm:
        y = layers.rms_norm(y, p["ln2b"], cfg.norm_eps)
    return x + y


def block_forward(cfg: ModelConfig, run: RunConfig, p, x: torch.Tensor,
                  positions: torch.Tensor, spec: layers.AttnSpec,
                  window=None, want_cache: bool = False):
    """x (B,S,D) -> (x', (k, v) or None)."""
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    o, kv = attention.attn_forward(cfg, run, p["attn"], h, positions, spec,
                                   window=window, want_cache=want_cache)
    out = o.to(torch.bfloat16)
    if cfg.post_norm:
        out = layers.rms_norm(out, p["ln1b"], cfg.norm_eps)
    return mlp(cfg, p, x + out), kv
