"""Transformer blocks at tp = 1 (ports ``repro/models/blocks.py``): the
dense family (attention + MLP), the MoE family (attention, plain or MLA, +
the MoE FFN of ``models/moe.py``) and the parallel hybrid (attention ∥
Mamba2 on the same normed input, + MLP or MoE).

Collectives dropped: the ``lexi_all_gather`` of the normalised activations
and the ``psum_scatter`` of the mixer/FFN outputs.  At tp = 1 the
reference's gather still round-trips activations through
``fixed.compress``/``decompress``, which is the identity as long as no
escape overflows its side channel; the port has no such round trip (the
tests check that the reference's gathers saw no overflow on their inputs).
The mixer outputs are summed in f32 (attention's o-projection plus, for a
hybrid, the SSM's output projection) and the sum is rounded to bf16 before
the residual add, as the reference's bf16 reduce-scatter does.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from . import attention, layers, moe as moe_mod, ssm as ssm_mod
from .params import PDef


def mlp_table(cfg: ModelConfig) -> Dict[str, PDef]:
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": PDef((d, f)), "w_up": PDef((d, f)),
            "w_down": PDef((f, d))}


def block_table(cfg: ModelConfig) -> Dict:
    """Parameter table for ONE layer (unstacked): attention (with a
    hybrid's ``ssm`` subtable beside it), then an ``mlp`` or, for MoE
    configs, a ``moe`` FFN."""
    if cfg.n_heads == 0:
        raise NotImplementedError(
            f"{cfg.name}: attention-free blocks wait for the mamba2 slice "
            "(a KV-less PagedState)")
    if cfg.encdec or (cfg.moe is None and not cfg.d_ff):
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and FFN-less blocks wait for the "
            "enc-dec slice")
    d = cfg.d_model
    t: Dict = {"ln1": PDef((d,), "ones"), "attn": attention.attn_table(cfg)}
    if cfg.ssm is not None:
        t["ssm"] = ssm_mod.ssm_table(cfg)
    if cfg.post_norm:
        t["ln1b"] = PDef((d,), "ones")
    t["ln2"] = PDef((d,), "ones")
    if cfg.moe is not None:
        t["moe"] = moe_mod.moe_table(cfg)
        return t
    t["mlp"] = mlp_table(cfg)
    if cfg.post_norm:
        t["ln2b"] = PDef((d,), "ones")
    return t


def mlp(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """The MLP sub-block with its residual: x + W_down(swiglu(...))."""
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    m = p["mlp"]
    act = layers.swiglu(layers.pdot(h, m["w_gate"]),
                        layers.pdot(h, m["w_up"]))
    y = layers.matmul_f32(act, m["w_down"]).to(torch.bfloat16)
    if cfg.post_norm:
        y = layers.rms_norm(y, p["ln2b"], cfg.norm_eps)
    return x + y


def ffn(cfg: ModelConfig, run: RunConfig, p, x: torch.Tensor,
        moe_groups: int = 1) -> torch.Tensor:
    """The FFN tail of a full-sequence layer with its residual: the MoE
    FFN where the layer has one (its tokens dispatched in ``moe_groups``
    groups, see ``moe.moe_forward``; the aux loss is dropped: serving
    ignores it), else the MLP."""
    if "moe" in p:
        h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + moe_mod.moe_forward(cfg, run, p["moe"], h,
                                       groups=moe_groups)[0]
    return mlp(cfg, p, x)


def ffn_decode(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """The FFN tail of a decode layer (ports ``serve/engine.py:
    _ffn_decode``): ``moe.moe_decode`` where the layer has a MoE FFN,
    else the MLP."""
    if "moe" in p:
        h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + moe_mod.moe_decode(cfg, p["moe"], h)
    return mlp(cfg, p, x)


def mixer_residual(cfg: ModelConfig, p, x: torch.Tensor,
                   partial: torch.Tensor) -> torch.Tensor:
    """The mixers' f32 sum rounded to bf16, (post-normed,) added to the
    residual; the FFN tail comes after (``ffn`` / ``ffn_decode``)."""
    out = partial.to(torch.bfloat16)
    if cfg.post_norm:
        out = layers.rms_norm(out, p["ln1b"], cfg.norm_eps)
    return x + out


def block_forward(cfg: ModelConfig, run: RunConfig, p, x: torch.Tensor,
                  positions: torch.Tensor, spec: layers.AttnSpec,
                  window=None, want_cache: bool = False,
                  moe_groups: int = 1):
    """x (B,S,D) -> (x', the decode cache payload or None: (k, v), or an
    MLA layer's latent (B,S,W); the SSM's final ``SSMState`` or None).  A
    hybrid's attention and SSM outputs are summed in f32; a MoE FFN
    dispatches its tokens in ``moe_groups`` groups."""
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    o, kv = attention.attn_forward(cfg, run, p["attn"], h, positions, spec,
                                   window=window, want_cache=want_cache)
    st = None
    if "ssm" in p:
        o_ssm, st = ssm_mod.ssm_forward(cfg, p["ssm"], h,
                                        want_state=want_cache)
        o = o + o_ssm
    x = mixer_residual(cfg, p, x, o)
    return ffn(cfg, run, p, x, moe_groups), kv, st
