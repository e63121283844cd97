"""Dense GQA attention at tp = 1 (ports ``repro/models/attention.py``).

At one GPU every kv-head layout is the reference's "col" regime with one
shard: all heads are local.  Collectives dropped: the row-parallel psums,
the decode q/k/v all_gathers and the ``axis_index`` head slicing.  MLA
(``project_qkv_mla``) is not ported yet; the dense family is this slice's
path.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels.ref import WINDOW_NONE   # global layers' window
from . import layers
from .layers import AttnSpec, apply_rope, matmul_f32, pdot, rope_tables
from .params import PDef


def layer_windows(cfg: ModelConfig):
    """Per-layer window sizes (int32 (L,)), or None without local layers."""
    if cfg.attn_layout == "full" or cfg.window is None:
        return None
    w = np.full((cfg.n_layers,), WINDOW_NONE, np.int32)
    if cfg.attn_layout == "alternating_local":
        w[0::2] = cfg.window
    elif cfg.attn_layout == "hymba_3global":
        w[:] = cfg.window
        for i in (0, cfg.n_layers // 2, cfg.n_layers - 1):
            w[i] = WINDOW_NONE
    return w


def base_attn_spec(cfg: ModelConfig) -> AttnSpec:
    return AttnSpec(causal=True, softcap=cfg.attn_softcap,
                    windowed=layer_windows(cfg) is not None)


def attn_table(cfg: ModelConfig) -> Dict[str, PDef]:
    d, hd = cfg.d_model, cfg.head_dim
    hq, nkv = cfg.n_heads, cfg.n_kv_heads
    if cfg.mla is not None:
        raise NotImplementedError("MLA attention is not ported yet")
    t: Dict[str, PDef] = {
        "wq": PDef((d, hq * hd)),
        "wk": PDef((d, nkv * hd)),
        "wv": PDef((d, nkv * hd)),
        "wo": PDef((hq * hd, d)),
    }
    if cfg.qkv_bias:
        t["bq"] = PDef((hq * hd,), "zeros")
        t["bk"] = PDef((nkv * hd,), "zeros")
        t["bv"] = PDef((nkv * hd,), "zeros")
    if cfg.qk_norm:
        t["q_norm"] = PDef((hd,), "ones")
        t["k_norm"] = PDef((hd,), "ones")
    return t


class QKV(NamedTuple):
    q: torch.Tensor       # (B, Hq, S, hd) rope'd
    k: torch.Tensor       # (B, Hkv, S, hd) rope'd
    v: torch.Tensor       # (B, Hkv, S, hd)


def _heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd).transpose(1, 2)


def project_qkv(cfg: ModelConfig, p, xg: torch.Tensor,
                positions: torch.Tensor) -> QKV:
    """xg (B,S,D) -> rope'd q and k, and v, per head."""
    hd = cfg.head_dim
    q = _heads(pdot(xg, p["wq"], p.get("bq")), cfg.n_heads, hd)
    k = _heads(pdot(xg, p["wk"], p.get("bk")), cfg.n_kv_heads, hd)
    v = _heads(pdot(xg, p["wv"], p.get("bv")), cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = layers.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = layers.rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    return QKV(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v)


def attn_forward(cfg: ModelConfig, run: RunConfig, p, xg: torch.Tensor,
                 positions: torch.Tensor, spec: AttnSpec, window=None,
                 want_cache: bool = False):
    """Full-sequence attention: xg (B,S,D) -> (o-projection (B,S,D) f32,
    (k, v) for the decode cache or None)."""
    qkv = project_qkv(cfg, p, xg, positions)
    b, hq, s, hd = qkv.q.shape
    out = layers.flash_attention(
        qkv.q, qkv.k, qkv.v, positions, positions, spec, window=window,
        chunk_q=run.attn_chunk_q, chunk_kv=run.attn_chunk_kv)
    out = out.transpose(1, 2).reshape(b, s, hq * hd)
    o = matmul_f32(out, p["wo"])
    return o, ((qkv.k, qkv.v) if want_cache else None)


def decode_qkv(cfg: ModelConfig, p, h: torch.Tensor, pos: torch.Tensor):
    """h (B,1,D), pos (B,) rope positions -> (q (B,Hq,1,hd), new_vals
    (B, W)) with the new token's K‖V laid out (Hkv, 2, hd) per row."""
    hd, nkv = cfg.head_dim, cfg.n_kv_heads
    b = h.shape[0]
    q = pdot(h, p["wq"], p.get("bq")).reshape(b, 1, cfg.n_heads, hd) \
        .transpose(1, 2)
    k = pdot(h, p["wk"], p.get("bk")).reshape(b, 1, nkv, hd).transpose(1, 2)
    v = pdot(h, p["wv"], p.get("bv")).reshape(b, 1, nkv, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = layers.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = layers.rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_tables(pos.reshape(b, 1), hd, cfg.rope_theta)
    cos, sin = cos[:, None], sin[:, None]                # (B,1,1,hd/2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    new_vals = torch.stack([k[:, :, 0], v[:, :, 0]], dim=2)  # (B,Hkv,2,hd)
    return q, new_vals.reshape(b, -1)


def decode_out(cfg: ModelConfig, p, merged: torch.Tensor) -> torch.Tensor:
    """merged (B,Hq,1,hd) -> o-projection (B,1,D) f32."""
    b = merged.shape[0]
    return matmul_f32(merged.transpose(1, 2).reshape(b, 1, -1), p["wo"])
