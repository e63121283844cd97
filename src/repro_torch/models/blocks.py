"""Transformer blocks (ports ``repro/models/blocks.py``): the dense family
(attention + MLP), the MoE family (attention, plain or MLA, + the MoE FFN
of ``models/moe.py``), the parallel hybrid (attention ∥ Mamba2 on the
same normed input, + MLP or MoE), the attention-free SSM block (Mamba2
alone, no FFN: mamba2-370m) and an encoder-decoder's decoder block
(self attention, then cross attention to the encoder's memory, then the
MLP; ``cross_attn_forward``).  The VLM (a vision stub in front of a dense
trunk) takes dense blocks.

Tensor parallelism (``tg`` a ``launch.mesh.TPGroup``; every family):
boundary activations are sequence-sharded (B, S/tp, D) in prefill, and
each mixer and MLP entry gathers the normed activations with
``collectives.compressed_all_gather`` -- the paper's codec at the link
port: LEXI-packed on the wire -- and reduce-scatters its f32 partial,
rounded to bf16, back to the sequence shards with a raw
``psum_scatter`` (a sum cannot cross compressed).  A hybrid's attention
and SSM share one gather and one reduce-scatter of their summed partial;
a pure SSM block has that one gather and reduce-scatter and no FFN.  The
MLP is column- (w_gate, w_up) then row-parallel (w_down); the MoE FFN
runs on the sequence shard with no gather (its tokens cross to the
experts' ranks in ``moe.moe_forward``'s all-to-alls).  An
encoder-decoder's cross attention gathers ``ln_x(x)`` too (its own wire
``kind``, ``cross``), attends the rank's query heads over the whole
memory and reduce-scatters its partial (``repro/models/blocks.py:
161-176``).  Decode activations are replicated (B, 1, D) and the
partials are psum'd in bf16.

Training: ``gather_fsdp`` gathers a layer's sharded weights before its
forward, LEXI-packed on the wire, over the data ranks (the megatron
strategy) or over ("data", "model") (the fsdp strategy, whose blocks
then run with ``tg`` None: no model-axis collective).  The prefill
path's gathers (``collectives.lexi_all_gather``) and reduce-scatters
(``collectives.psum_scatter``) are differentiable, so ``block_forward``
with ``tg`` trains: sequence parallelism, the gathers' backward a raw
reduce-scatter and the reduce-scatters' a raw all-gather
(``repro/models/blocks.py:136-191``).

At tp = 1 the port drops the collectives.  The reference's gather still
round-trips activations through ``fixed.compress``/``decompress`` there,
which is the identity as long as no escape overflows its side channel;
the port has no such round trip (the tests check that the reference's
gathers saw no overflow on their inputs).  The mixer outputs are summed
in f32 (attention's o-projection plus, for a hybrid, the SSM's output
projection) and the sum is rounded to bf16 before the residual add, as
the reference's bf16 reduce-scatter does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import collectives as cl
from . import attention, layers, moe as moe_mod, ssm as ssm_mod
from .params import PDef


def mlp_table(cfg: ModelConfig) -> Dict[str, PDef]:
    d, f = cfg.d_model, cfg.d_ff
    col, row = (None, "model"), ("model", None)
    return {"w_gate": PDef((d, f), spec=col), "w_up": PDef((d, f), spec=col),
            "w_down": PDef((f, d), spec=row)}


def block_table(cfg: ModelConfig, tp: int = 1, cross: bool = False) -> Dict:
    """Parameter table for ONE layer (unstacked), as the reference's:
    attention (none when ``n_heads == 0``) and a hybrid's or an SSM
    model's ``ssm`` subtable beside it; with ``cross`` (an
    encoder-decoder's decoder) ``ln_x`` and the cross-attention ``xattn``;
    then a ``moe`` FFN, or an ``mlp`` unless the block is a pure SSM's;
    ``spec``s for ``tp`` ranks."""
    d = cfg.d_model
    has_attn, has_ssm = cfg.n_heads > 0, cfg.ssm is not None
    t: Dict = {"ln1": PDef((d,), "ones")}
    if has_attn:
        t["attn"] = attention.attn_table(cfg, tp)
    if has_ssm:
        t["ssm"] = ssm_mod.ssm_table(cfg, tp)
    if cfg.post_norm:
        t["ln1b"] = PDef((d,), "ones")
    if cross:
        t["ln_x"] = PDef((d,), "ones")
        t["xattn"] = attention.attn_table(cfg, tp)
    if cfg.moe is not None:
        t["ln2"] = PDef((d,), "ones")
        t["moe"] = moe_mod.moe_table(cfg, tp)
    elif cfg.d_ff and (has_attn or not has_ssm):
        t["ln2"] = PDef((d,), "ones")
        t["mlp"] = mlp_table(cfg)
        if cfg.post_norm:
            t["ln2b"] = PDef((d,), "ones")
    return t


def fsdp_axes(run: RunConfig):
    """Mesh axes parameter shards live on (and are gathered over)."""
    return ("data", "model") if run.tp_strategy == "fsdp" else ("data",)


def gather_fsdp(params, dims, run: RunConfig, mesh, in_scan: bool = True):
    """All-gather the FSDP-sharded leaves of ``params`` over the ranks of
    ``mesh`` (a ``launch.mesh.Mesh``) on ``fsdp_axes(run)``,
    differentiably: with ``codec.weights`` on, a bf16 leaf goes through
    ``lexi_all_gather``
    (LEXI-packed on the wire when ``codec.enabled``; the reference's
    gather is plain otherwise, as ``CodecConfig.weights_only()`` has it),
    every other leaf through a plain gather; the backward of either is a
    raw reduce-scatter of the cotangent; the bytes are labelled ``fsdp``
    in ``collectives.wire.kinds``.  ``dims`` indexes the stacked
    table, so a layer's leaf (``in_scan``) gathers one dim lower."""
    tg = mesh.axis_group(fsdp_axes(run))
    plain = dataclasses.replace(run.codec, enabled=False)

    def one(w, d):
        if isinstance(w, dict):
            return {k: one(w[k], d[k]) for k in w}
        if d is None:
            return w
        ax = d - 1 if in_scan else d
        codec = run.codec if run.codec.weights and \
            w.dtype == torch.bfloat16 else plain
        return cl.lexi_all_gather(w, tg, codec, gather_axis=ax, kind="fsdp")

    return one(params, dims)


def _gather(h: torch.Tensor, run: RunConfig, tg, groups: int = 1,
            kind: str = "all_gather") -> torch.Tensor:
    """A prefill mixer's or FFN's entry: the sequence-sharded normed
    activations gathered, LEXI-compressed on the wire (each of ``groups``
    groups of sequences on its own; ``kind`` labels the bytes);
    differentiable."""
    return cl.lexi_all_gather(h, tg, run.codec, gather_axis=1,
                              groups=groups, kind=kind)


def _reduce(y: torch.Tensor, tg, prefill: bool) -> torch.Tensor:
    """A bf16 partial back to the block's layout: reduce-scattered over
    the sequence in prefill, summed in decode (raw: it sums)."""
    if prefill:
        return cl.psum_scatter(y, tg, 1)
    return cl.psum(y, tg)


def mlp(cfg: ModelConfig, p, x: torch.Tensor, run: RunConfig = None,
        tg=None, prefill: bool = False, groups: int = 1,
        kind: str = "all_gather") -> torch.Tensor:
    """The MLP sub-block with its residual: x + W_down(swiglu(...)); at
    tp > 1 (``run``'s codec for the gather, ``kind`` its label) column-
    then row-parallel."""
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    if prefill and cl.world(tg) > 1:
        h = _gather(h, run, tg, groups, kind)
    m = p["mlp"]
    act = layers.swiglu(layers.pdot(h, m["w_gate"]),
                        layers.pdot(h, m["w_up"]))
    y = _reduce(layers.matmul_f32(act, m["w_down"]).to(torch.bfloat16), tg,
                prefill)
    if cfg.post_norm:
        y = layers.rms_norm(y, p["ln2b"], cfg.norm_eps)
    return x + y


def ffn(cfg: ModelConfig, run: RunConfig, p, x: torch.Tensor,
        groups: int = 1, tg=None, kind: str = "all_gather") -> torch.Tensor:
    """The FFN tail of a full-sequence layer with its residual: the MoE
    FFN where the layer has one (its tokens dispatched in ``groups``
    groups, see ``moe.moe_forward``; at tp > 1 on the sequence shard, not
    gathered; the aux loss is dropped: serving ignores it), else the MLP,
    else (a pure SSM block) nothing."""
    if "moe" in p:
        h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + moe_mod.moe_forward(cfg, run, p["moe"], h,
                                       groups=groups, tg=tg)[0]
    if "mlp" in p:
        return mlp(cfg, p, x, run, tg, prefill=True, groups=groups,
                   kind=kind)
    return x


def ffn_decode(cfg: ModelConfig, p, x: torch.Tensor, tg=None) -> torch.Tensor:
    """The FFN tail of a decode layer (ports ``serve/engine.py:
    _ffn_decode``): ``moe.moe_decode`` where the layer has a MoE FFN,
    else the MLP, else (a pure SSM block) nothing."""
    if "moe" in p:
        h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + moe_mod.moe_decode(cfg, p["moe"], h, tg)
    if "mlp" in p:
        return mlp(cfg, p, x, tg=tg)
    return x


def mixer_residual(cfg: ModelConfig, p, x: torch.Tensor,
                   partial: torch.Tensor, tg=None,
                   prefill: bool = False) -> torch.Tensor:
    """The mixers' f32 sum rounded to bf16 (at tp > 1 reduced over the
    ranks, see ``_reduce``), (post-normed,) added to the residual; the FFN
    tail comes after (``ffn`` / ``ffn_decode``)."""
    out = _reduce(partial.to(torch.bfloat16), tg, prefill)
    if cfg.post_norm:
        out = layers.rms_norm(out, p["ln1b"], cfg.norm_eps)
    return x + out


def block_forward(cfg: ModelConfig, run: RunConfig, p, x: torch.Tensor,
                  positions: torch.Tensor, spec: layers.AttnSpec,
                  window=None, want_cache: bool = False,
                  groups: int = 1, tg=None, memory=None, mem_positions=None,
                  kind: str = "all_gather"):
    """x (B,S,D) -> (x', the decode cache payload or None: (k, v), or an
    MLA layer's latent (B,S,W); None without attention; the SSM's final
    ``SSMState`` or None).  A hybrid's attention and SSM outputs are
    summed in f32.  The B sequences run as ``groups`` separate prefills:
    a MoE FFN dispatches each group's tokens on its own, and at tp > 1
    the gathers compress each group's activations on their own (their
    bytes labelled ``kind``: an encoder layer's are ``encoder``).  At
    tp > 1 x is the rank's sequence shard (B, S/tp, D) and (k, v) the
    rank's cache payload heads (``attention.project_qkv``).

    ``memory`` (B, Sm, D) (an encoder-decoder's decoder layer: the whole
    memory on every rank; ``mem_positions`` its (Sm,) positions) adds the
    cross attention between the mixers and the FFN -- at tp > 1 its input
    gathered (``cross``) and its partial reduce-scattered -- and a fourth
    item: its cache payload, the memory's (k, v) (``cross_attn_forward``),
    or None."""
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    if cl.world(tg) > 1:
        h = _gather(h, run, tg, groups, kind)
    o = kv = st = None
    if "attn" in p:
        o, kv = attention.attn_forward(cfg, run, p["attn"], h, positions,
                                       spec, window=window,
                                       want_cache=want_cache, tg=tg)
    if "ssm" in p:
        o_ssm, st = ssm_mod.ssm_forward(cfg, p["ssm"], h,
                                        want_state=want_cache, tg=tg)
        o = o_ssm if o is None else o + o_ssm
    x = mixer_residual(cfg, p, x, o, tg, prefill=True)
    if memory is None:
        return ffn(cfg, run, p, x, groups, tg, kind), kv, st
    hx = layers.rms_norm(x, p["ln_x"], cfg.norm_eps)
    if cl.world(tg) > 1:
        hx = _gather(hx, run, tg, groups, "cross")
    o, xkv = cross_attn_forward(cfg, run, p["xattn"], hx, memory, positions,
                                mem_positions, want_cache, tg)
    x = x + _reduce(o.to(torch.bfloat16), tg, prefill=True)
    return ffn(cfg, run, p, x, groups, tg, kind), kv, st, xkv


def cross_attn_forward(cfg: ModelConfig, run: RunConfig, p,
                       h: torch.Tensor, memory: torch.Tensor,
                       q_pos: torch.Tensor, kv_pos: torch.Tensor,
                       want_cache: bool = False, tg=None):
    """Cross attention: queries from h (B,S,D), keys and values from the
    encoder's memory (B,Sm,D), no rope, no norm, no bias on k and v;
    non-causal, no softcap.  At tp > 1 (the reference's two kv regimes,
    ``attention.kv_mode``) the rank's query heads attend: in ``col`` mode
    over its n_kv / tp kv heads of the whole memory, in ``row`` mode over
    the kv head of each (``attention.local_q_kv_index``) taken from every
    kv head, the rank's d_model slice of the memory times its rows of
    wk / wv summed in f32 over the group.  Returns (the o-projection
    (B,S,D) f32, at tp > 1 the rank's partial; the memory's (k, v) with
    ``want_cache``, else None: the rank's kv heads in ``col`` mode, every
    kv head in ``row`` mode, (B, Hkv, Sm, hd) each).

    ``row`` mode stores every kv head where the reference stores the
    rank's query heads' picks (``repro/models/blocks.py:226-232``), which
    fits its store only at hq / tp = n_kv = 1, where the two are the same
    bytes (``ROADMAP.md`` section 3, item 8)."""
    hd, tp = cfg.head_dim, cl.world(tg)
    hq_loc = cfg.padded_heads(tp) // tp
    b, s, _ = h.shape
    sm = memory.shape[1]
    q = layers.pdot(h, p["wq"], p.get("bq")).reshape(b, s, hq_loc, hd) \
        .transpose(1, 2)
    if attention.kv_mode(cfg, tp) == "col":
        nkv = cfg.n_kv_heads // tp
        k = layers.pdot(memory, p["wk"]).reshape(b, sm, nkv, hd) \
            .transpose(1, 2)
        v = layers.pdot(memory, p["wv"]).reshape(b, sm, nkv, hd) \
            .transpose(1, 2)
        kq, vq = k, v
    else:
        k, v = (t.to(torch.bfloat16).reshape(b, sm, cfg.n_kv_heads, hd)
                .transpose(1, 2) for t in attention.row_sum(
                    cfg, memory, (p["wk"], p["wv"]), tg))
        idx = attention.local_q_kv_index(cfg, tg).to(k.device)
        kq, vq = k.index_select(1, idx), v.index_select(1, idx)
    out = layers.flash_attention(
        q, kq, vq, q_pos, kv_pos, layers.AttnSpec(causal=False, softcap=None),
        chunk_q=run.attn_chunk_q, chunk_kv=run.attn_chunk_kv)
    out = out.transpose(1, 2).reshape(b, s, hq_loc * hd)
    return layers.matmul_f32(out, p["wo"]), ((k, v) if want_cache else None)
