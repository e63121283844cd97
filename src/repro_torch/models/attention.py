"""Attention at tp = 1 (ports ``repro/models/attention.py``): GQA / MQA /
MHA, and MLA (multi-head latent attention, deepseek-v2).

At one GPU every kv-head layout is the reference's "col" regime with one
shard: all heads are local.  Collectives dropped: the row-parallel psums,
the decode q/k/v all_gathers and the ``axis_index`` head slicing.

MLA: the cache stores one latent row per token, c_kv ‖ k_rope (lora +
rope wide, shared by every head; LEXI compresses the latent).  Prefill
runs the non-absorbed form (per-head keys [k_nope ‖ k_rope] and values
up-projected from c_kv); decode the absorbed one (q_lat = q_nope · W_uk
per head against the latent, W_uv applied to the attended latent).  As in
the reference, prefill stores k_rope before its rotation and decode
after it.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels.ref import WINDOW_NONE   # global layers' window
from . import layers
from .layers import (AttnSpec, apply_rope, matmul_f32, pdot, raw_weight,
                     rope_tables)
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


def mla_scale(cfg: ModelConfig) -> float:
    """MLA's softmax scale, the non-absorbed query's width to the -1/2."""
    return (cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim) ** -0.5


def attn_table(cfg: ModelConfig) -> Dict[str, PDef]:
    d, hd = cfg.d_model, cfg.head_dim
    hq, nkv = cfg.n_heads, cfg.n_kv_heads
    if cfg.mla is not None:
        m = cfg.mla
        return {
            "wq": PDef((d, hq * (m.qk_nope_dim + m.qk_rope_dim))),
            "w_dkv": PDef((d, m.kv_lora_rank + m.qk_rope_dim)),
            "kv_norm": PDef((m.kv_lora_rank,), "ones"),
            "w_uk": PDef((m.kv_lora_rank, hq * m.qk_nope_dim)),
            "w_uv": PDef((m.kv_lora_rank, hq * m.v_dim)),
            "wo": PDef((hq * m.v_dim, d)),
        }
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


def project_qkv_mla(cfg: ModelConfig, p, xg: torch.Tensor,
                    positions: torch.Tensor):
    """MLA projections, non-absorbed: xg (B,S,D) -> (QKV with per-head
    q/k (B,Hq,S,dn+dr) rope'd and v (B,Hq,S,dv), the latent (B,S,lora+dr)
    that the decode cache stores: c_kv normed, k_rope NOT rotated)."""
    m = cfg.mla
    hq, dn, dr, dv = cfg.n_heads, m.qk_nope_dim, m.qk_rope_dim, m.v_dim
    q = _heads(pdot(xg, p["wq"]), hq, dn + dr)
    lat = matmul_f32(xg, p["w_dkv"]).to(torch.bfloat16)
    c_kv = layers.rms_norm(lat[..., :m.kv_lora_rank], p["kv_norm"],
                           cfg.norm_eps)
    k_rope = lat[..., m.kv_lora_rank:]                   # (B,S,dr)
    latent = torch.cat([c_kv, k_rope], dim=-1)
    cos, sin = rope_tables(positions, dr, cfg.rope_theta)
    q = torch.cat([q[..., :dn], apply_rope(q[..., dn:], cos, sin)], dim=-1)
    k_rope = apply_rope(k_rope[:, None], cos, sin)       # (B,1,S,dr)
    k_nope = _heads(pdot(c_kv, p["w_uk"]), hq, dn)
    v = _heads(pdot(c_kv, p["w_uv"]), hq, dv)
    k = torch.cat([k_nope, k_rope.expand(-1, hq, -1, -1)], dim=-1)
    return QKV(q, k, v), latent


def attn_forward(cfg: ModelConfig, run: RunConfig, p, xg: torch.Tensor,
                 positions: torch.Tensor, spec: AttnSpec, window=None,
                 want_cache: bool = False):
    """Full-sequence attention: xg (B,S,D) -> (o-projection (B,S,D) f32,
    the decode cache's payload or None: (k, v), or MLA's latent)."""
    if cfg.mla is not None:
        qkv, latent = project_qkv_mla(cfg, p, xg, positions)
        spec = spec._replace(scale=mla_scale(cfg))
        cache = latent
    else:
        qkv = project_qkv(cfg, p, xg, positions)
        cache = (qkv.k, qkv.v)
    b, hq, s, _ = qkv.q.shape
    out = layers.flash_attention(
        qkv.q, qkv.k, qkv.v, positions, positions, spec, window=window,
        chunk_q=run.attn_chunk_q, chunk_kv=run.attn_chunk_kv)
    out = out.transpose(1, 2).reshape(b, s, hq * qkv.v.shape[-1])
    o = matmul_f32(out, p["wo"])
    return o, (cache if want_cache else None)


def decode_qkv_mla(cfg: ModelConfig, p, h: torch.Tensor,
                   pos: torch.Tensor):
    """MLA decode projections, absorbed: h (B,1,D), pos (B,) -> (q
    (B,Hq,1,lora+dr) = [q_nope · W_uk per head (f32, rounded to bf16) ‖
    q_rope rotated], new_vals (B, lora+dr) = [c_kv ‖ k_rope rotated])."""
    m = cfg.mla
    hq, dn, dr, lora = cfg.n_heads, m.qk_nope_dim, m.qk_rope_dim, \
        m.kv_lora_rank
    b = h.shape[0]
    q = pdot(h, p["wq"]).reshape(b, 1, hq, dn + dr).transpose(1, 2)
    lat = matmul_f32(h, p["w_dkv"]).to(torch.bfloat16)[:, 0]   # (B, W)
    c_kv = layers.rms_norm(lat[..., :lora], p["kv_norm"], cfg.norm_eps)
    cos, sin = rope_tables(pos.reshape(b, 1), dr, cfg.rope_theta)
    cos, sin = cos[:, None], sin[:, None]                # (B,1,1,dr/2)
    k_rope = apply_rope(lat[:, None, None, lora:], cos, sin)[:, 0, 0]
    new_vals = torch.cat([c_kv, k_rope], dim=-1)
    w_uk = raw_weight(p["w_uk"]).reshape(lora, hq, dn)
    q_lat = torch.einsum("bhsd,lhd->bhsl", q[..., :dn].float(),
                         w_uk.float()).to(torch.bfloat16)
    q_full = torch.cat([q_lat, apply_rope(q[..., dn:], cos, sin)], dim=-1)
    return q_full, new_vals


def decode_qkv(cfg: ModelConfig, p, h: torch.Tensor, pos: torch.Tensor):
    """h (B,1,D), pos (B,) rope positions -> (q (B,Hq,1,hd), new_vals
    (B, W)) with the new token's K‖V laid out (Hkv, 2, hd) per row (MLA:
    ``decode_qkv_mla``)."""
    if cfg.mla is not None:
        return decode_qkv_mla(cfg, p, h, pos)
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
    """merged (B,Hq,1,hd_v) -> o-projection (B,1,D) f32.  MLA first maps
    each head's attended latent (hd_v = lora) through its W_uv slice, in
    f32, rounded to bf16."""
    b = merged.shape[0]
    if cfg.mla is not None:
        m = cfg.mla
        w_uv = raw_weight(p["w_uv"]).reshape(m.kv_lora_rank, cfg.n_heads,
                                             m.v_dim)
        merged = torch.einsum("bhsl,lhv->bhsv", merged.float(),
                              w_uv.float()).to(torch.bfloat16)
    return matmul_f32(merged.transpose(1, 2).reshape(b, 1, -1), p["wo"])
