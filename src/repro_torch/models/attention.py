"""Attention (ports ``repro/models/attention.py``): GQA / MQA / MHA, and
MLA (multi-head latent attention, deepseek-v2).

Tensor parallelism (dense attention; a ``launch.mesh.TPGroup`` ``tg`` of
tp ranks, None at tp = 1): query heads are padded to a multiple of tp
(``cfg.padded_heads``) and column-sharded, hq/tp per rank, with the
reference's two kv regimes (``kv_mode``):

* ``col`` (n_kv % tp == 0): k/v projections column-sharded too, n_kv/tp
  kv heads per rank; its query heads group over them;
* ``row`` (n_kv % tp != 0, e.g. MQA): k/v projections row-parallel (the
  rank's slice of d_model) summed in f32 over the group, so every rank
  holds every kv head; each local query head picks its kv head.

Prefill's attention output is a partial o-projection (rows of ``wo`` per
rank) that the block reduce-scatters.  Decode gathers q (and, in ``col``,
the new k/v) to full heads -- the cache is sequence-sharded and holds
every head -- and ``decode_out`` applies the rank's heads' ``wo`` rows to
the merged attention.

MLA at tp > 1 (the reference's specs, ``repro/models/attention.py:
75-84``): ``wq``, ``w_uk`` and ``w_uv`` are column-sharded by query head,
``w_dkv`` and ``wo`` row-sharded.  The latent is the rank's d_model slice
of x times its rows of ``w_dkv``, summed in f32 over the group and
rounded to bf16 once (``:171-215``, ``:271-297``), so every rank holds
the whole latent; the cache keeps the rank's interleaved rows of it.
Decode absorbs q through the rank's ``w_uk`` heads and gathers q over
heads, so every rank attends all heads over its own latent rows;
``decode_out`` takes the rank's heads through its ``w_uv`` slice, then
its rows of ``wo`` (``:335-352``).

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
from repro_torch.core import collectives as cl
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


def kv_mode(cfg: ModelConfig, tp: int) -> str:
    return "col" if cfg.n_kv_heads % tp == 0 else "row"


def attn_table(cfg: ModelConfig, tp: int = 1) -> Dict[str, PDef]:
    d, hd = cfg.d_model, cfg.head_dim
    hq, nkv = cfg.padded_heads(tp), cfg.n_kv_heads
    col, row, rep = (None, "model"), ("model", None), ()
    if cfg.mla is not None:
        m = cfg.mla
        return {
            "wq": PDef((d, hq * (m.qk_nope_dim + m.qk_rope_dim)), spec=col),
            "w_dkv": PDef((d, m.kv_lora_rank + m.qk_rope_dim), spec=row),
            "kv_norm": PDef((m.kv_lora_rank,), "ones"),
            "w_uk": PDef((m.kv_lora_rank, hq * m.qk_nope_dim), spec=col),
            "w_uv": PDef((m.kv_lora_rank, hq * m.v_dim), spec=col),
            "wo": PDef((hq * m.v_dim, d), spec=row),
        }
    kv = col if kv_mode(cfg, tp) == "col" else row
    t: Dict[str, PDef] = {
        "wq": PDef((d, hq * hd), spec=col),
        "wk": PDef((d, nkv * hd), spec=kv),
        "wv": PDef((d, nkv * hd), spec=kv),
        "wo": PDef((hq * hd, d), spec=row),
    }
    if cfg.qkv_bias:
        bkv = ("model",) if kv is col else rep
        t["bq"] = PDef((hq * hd,), "zeros", spec=("model",))
        t["bk"] = PDef((nkv * hd,), "zeros", spec=bkv)
        t["bv"] = PDef((nkv * hd,), "zeros", spec=bkv)
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


def row_sum(cfg: ModelConfig, x: torch.Tensor, ws, tg):
    """Row-parallel products, in the order of ``ws``: the rank's d_model
    slice of x times each of its row shards, summed in f32 over the group
    (x times each whole weight at tp = 1)."""
    if cl.world(tg) == 1:
        return [matmul_f32(x, w) for w in ws]
    dsh = cfg.d_model // tg.world
    x = x[..., tg.rank * dsh:(tg.rank + 1) * dsh]
    return cl.psum(torch.stack([matmul_f32(x, w) for w in ws]), tg)


def _row_kv(cfg: ModelConfig, p, x: torch.Tensor, tg):
    """``row`` mode's k and v (…, nkv * hd) bf16: the rank's d_model slice
    of x times its rows of wk / wv, summed in f32 over the group, biased
    in f32, then rounded."""
    k, v = row_sum(cfg, x, (p["wk"], p["wv"]), tg)
    if cfg.qkv_bias:
        k, v = k + p["bk"].float(), v + p["bv"].float()
    return k.to(torch.bfloat16), v.to(torch.bfloat16)


def local_q_kv_index(cfg: ModelConfig, tg) -> torch.Tensor:
    """``row`` mode: the kv head of each of the rank's query heads (pad
    heads clip onto the last kv head)."""
    hq_loc = cfg.padded_heads(tg.world) // tg.world
    g = max(cfg.n_heads // max(cfg.n_kv_heads, 1), 1)
    return torch.as_tensor(np.clip(
        (tg.rank * hq_loc + np.arange(hq_loc)) // g, 0,
        cfg.n_kv_heads - 1))


def project_qkv(cfg: ModelConfig, p, xg: torch.Tensor,
                positions: torch.Tensor, tg=None):
    """xg (B,S,D) (the full sequence) -> (QKV for the rank's query heads:
    rope'd q and k, and v; the cache payload's (k, v): the rank's kv
    heads in ``col`` mode, every kv head in ``row`` mode)."""
    hd, tp = cfg.head_dim, cl.world(tg)
    hq_loc = cfg.padded_heads(tp) // tp
    q = _heads(pdot(xg, p["wq"], p.get("bq")), hq_loc, hd)
    if kv_mode(cfg, tp) == "col":
        nkv = cfg.n_kv_heads // tp
        k = _heads(pdot(xg, p["wk"], p.get("bk")), nkv, hd)
        v = _heads(pdot(xg, p["wv"], p.get("bv")), nkv, hd)
    else:
        k, v = _row_kv(cfg, p, xg, tg)
        k = _heads(k, cfg.n_kv_heads, hd)
        v = _heads(v, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = layers.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = layers.rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    if kv_mode(cfg, tp) == "col":
        return QKV(q, k, v), (k, v)
    idx = local_q_kv_index(cfg, tg).to(k.device)
    return QKV(q, k.index_select(1, idx), v.index_select(1, idx)), (k, v)


def _latent(cfg: ModelConfig, p, x: torch.Tensor, tg) -> torch.Tensor:
    """MLA's latent rows (…, lora + dr) bf16 before the norm: x times
    ``w_dkv`` in f32, at tp > 1 row-parallel (summed over the group),
    rounded once."""
    return row_sum(cfg, x, (p["w_dkv"],), tg)[0].to(torch.bfloat16)


def project_qkv_mla(cfg: ModelConfig, p, xg: torch.Tensor,
                    positions: torch.Tensor, tg=None):
    """MLA projections, non-absorbed: xg (B,S,D) -> (QKV with the rank's
    per-head q/k (B,Hq,S,dn+dr) rope'd and v (B,Hq,S,dv), the latent
    (B,S,lora+dr) that the decode cache stores: c_kv normed, k_rope NOT
    rotated; the whole latent on every rank)."""
    m = cfg.mla
    tp = cl.world(tg)
    hq = cfg.padded_heads(tp) // tp
    dn, dr, dv = m.qk_nope_dim, m.qk_rope_dim, m.v_dim
    q = _heads(pdot(xg, p["wq"]), hq, dn + dr)
    lat = _latent(cfg, p, xg, tg)
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
                 want_cache: bool = False, tg=None):
    """Full-sequence attention: xg (B,S,D) -> (o-projection (B,S,D) f32,
    the decode cache's payload or None: (k, v), or MLA's latent).  At
    tp > 1 the o-projection is the rank's partial (its heads' rows of
    ``wo``) and (k, v) as ``project_qkv`` returns them."""
    if cfg.mla is not None:
        qkv, latent = project_qkv_mla(cfg, p, xg, positions, tg)
        spec = spec._replace(scale=mla_scale(cfg))
        cache = latent
    else:
        qkv, cache = project_qkv(cfg, p, xg, positions, tg)
    b, hq, s, _ = qkv.q.shape
    out = layers.flash_attention(
        qkv.q, qkv.k, qkv.v, positions, positions, spec, window=window,
        chunk_q=run.attn_chunk_q, chunk_kv=run.attn_chunk_kv)
    out = out.transpose(1, 2).reshape(b, s, hq * qkv.v.shape[-1])
    o = matmul_f32(out, p["wo"])
    return o, (cache if want_cache else None)


def decode_qkv_mla(cfg: ModelConfig, p, h: torch.Tensor,
                   pos: torch.Tensor, tg=None):
    """MLA decode projections, absorbed: h (B,1,D), pos (B,) -> (q
    (B,Hq,1,lora+dr) = [q_nope · W_uk per head (f32, rounded to bf16) ‖
    q_rope rotated], new_vals (B, lora+dr) = [c_kv ‖ k_rope rotated]).
    At tp > 1 the rank absorbs its own heads and q is gathered to full
    heads; the latent is the group's row-parallel sum."""
    m = cfg.mla
    tp = cl.world(tg)
    hq = cfg.padded_heads(tp) // tp
    dn, dr, lora = m.qk_nope_dim, m.qk_rope_dim, m.kv_lora_rank
    b = h.shape[0]
    q = pdot(h, p["wq"]).reshape(b, 1, hq, dn + dr).transpose(1, 2)
    lat = _latent(cfg, p, h, tg)[:, 0]                   # (B, W)
    c_kv = layers.rms_norm(lat[..., :lora], p["kv_norm"], cfg.norm_eps)
    cos, sin = rope_tables(pos.reshape(b, 1), dr, cfg.rope_theta)
    cos, sin = cos[:, None], sin[:, None]                # (B,1,1,dr/2)
    k_rope = apply_rope(lat[:, None, None, lora:], cos, sin)[:, 0, 0]
    new_vals = torch.cat([c_kv, k_rope], dim=-1)
    w_uk = raw_weight(p["w_uk"]).reshape(lora, hq, dn)
    q_lat = torch.einsum("bhsd,lhd->bhsl", q[..., :dn].float(),
                         w_uk.float()).to(torch.bfloat16)
    q_full = torch.cat([q_lat, apply_rope(q[..., dn:], cos, sin)], dim=-1)
    if tp > 1:
        q_full = cl.fold_parts(cl.gather_many((q_full,), tg)[0], 1)
    return q_full, new_vals


def decode_qkv(cfg: ModelConfig, p, h: torch.Tensor, pos: torch.Tensor,
               tg=None):
    """h (B,1,D), pos (B,) rope positions -> (q (B,Hq,1,hd), new_vals
    (B, W)) with the new token's K‖V laid out (Hkv, 2, hd) per row (MLA:
    ``decode_qkv_mla``).  At tp > 1 q (and in ``col`` mode k and v) are
    gathered from the ranks to full heads: every rank gets all of them."""
    if cfg.mla is not None:
        return decode_qkv_mla(cfg, p, h, pos, tg)
    hd, tp = cfg.head_dim, cl.world(tg)
    hq_loc = cfg.padded_heads(tp) // tp
    b = h.shape[0]
    col = kv_mode(cfg, tp) == "col"
    q = pdot(h, p["wq"], p.get("bq")).reshape(b, 1, hq_loc, hd) \
        .transpose(1, 2)
    if col:
        nkv = cfg.n_kv_heads // tp
        k = pdot(h, p["wk"], p.get("bk")).reshape(b, 1, nkv, hd) \
            .transpose(1, 2)
        v = pdot(h, p["wv"], p.get("bv")).reshape(b, 1, nkv, hd) \
            .transpose(1, 2)
    else:
        k, v = _row_kv(cfg, p, h, tg)
        k = k.reshape(b, 1, cfg.n_kv_heads, hd).transpose(1, 2)
        v = v.reshape(b, 1, cfg.n_kv_heads, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = layers.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = layers.rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_tables(pos.reshape(b, 1), hd, cfg.rope_theta)
    cos, sin = cos[:, None], sin[:, None]                # (B,1,1,hd/2)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    if cl.world(tg) > 1:                 # one exchange for q (and k, v)
        parts = cl.gather_many((q, k, v) if col else (q,), tg)
        q = cl.fold_parts(parts[0], 1)
        if col:
            k, v = cl.fold_parts(parts[1], 1), cl.fold_parts(parts[2], 1)
    new_vals = torch.stack([k[:, :, 0], v[:, :, 0]], dim=2)  # (B,Hkv,2,hd)
    return q, new_vals.reshape(b, -1)


def decode_out(cfg: ModelConfig, p, merged: torch.Tensor,
               tg=None) -> torch.Tensor:
    """merged (B,Hq,1,hd_v) -> o-projection (B,1,D) f32: at tp > 1 the
    rank's partial, its heads through its rows of ``wo``.  MLA first maps
    each head's attended latent (hd_v = lora) through its W_uv slice, in
    f32, rounded to bf16."""
    b = merged.shape[0]
    tp = cl.world(tg)
    if tp > 1:
        hq_loc = merged.shape[1] // tp
        merged = merged[:, tg.rank * hq_loc:(tg.rank + 1) * hq_loc]
    if cfg.mla is not None:
        m = cfg.mla
        w_uv = raw_weight(p["w_uv"]).reshape(m.kv_lora_rank,
                                             merged.shape[1], m.v_dim)
        merged = torch.einsum("bhsl,lhv->bhsv", merged.float(),
                              w_uv.float()).to(torch.bfloat16)
    return matmul_f32(merged.transpose(1, 2).reshape(b, 1, -1), p["wo"])
