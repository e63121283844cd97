"""Mixture-of-Experts FFN with expert parallelism (ports
``repro/models/moe.py`` and the decode MoE of ``repro/serve/engine.py``).

Routing: f32 router logits, softmax, top-k (ties to the lower expert id,
as ``jax.lax.top_k``), gates renormalised over the k choices, and the
Switch-style load-balancing aux loss.  Dispatch: capacity-factor slots,
drop on overflow -- a one-hot cumsum in token-major, then choice, order
gives each (token, choice) its slot in its expert's (cap, D) buffer, and a
slot at or past the capacity is dropped.  Then the expert SwiGLU over the
(E, cap, D) buffer, the f32 combine of each token's kept choices in
choice order, and the shared experts (a dense FFN on every token).

Expert parallelism (``tg`` a ``launch.mesh.TPGroup`` of tp ranks): the
expert stacks are sharded over the ranks (rank r holds experts
``[r * E/tp, (r + 1) * E/tp)``), the shared FFN is column- then
row-sharded.  In prefill each rank routes its own sequence shard; the
(E, cap, D) dispatch buffer crosses to the experts' ranks through
``collectives.compressed_all_to_all`` -- the inter-chiplet activation
traffic the paper compresses -- the local experts run on every rank's
slots, and their outputs return through a second compressed all-to-all
before the f32 combine.  The shared experts' partial is rounded to bf16
and summed over the ranks: as in the reference, whose prefill input is
sequence-sharded, each token's shared output adds in the partials of the
other ranks' tokens at the same position (ROADMAP.md, section 3).  In
decode the tokens are replicated: each rank runs its own experts' hits
(the others masked off) and the bf16 partials are summed.  At tp = 1
every expert is local and the collectives are dropped.

Port-specific: ``groups`` dispatches G independent groups of tokens at
once, each with its own capacity and slots, as the reference's vmapped
B = 1 admission prefills do (``serve/scheduler.py:_admit_for``); the
expert products of all groups run in one batched matmul.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import collectives as cl
from . import layers
from .params import PDef


def moe_table(cfg: ModelConfig, tp: int = 1) -> Dict[str, PDef]:
    d, e = cfg.d_model, cfg.moe
    if e.n_experts % tp:
        raise ValueError(f"{cfg.name}: {e.n_experts} experts do not split "
                         f"over tp {tp}")
    ep = ("model", None, None)
    t = {
        "router": PDef((d, e.n_experts), "normal:0.006"),
        "w_gate": PDef((e.n_experts, d, e.d_ff), spec=ep),
        "w_up": PDef((e.n_experts, d, e.d_ff), spec=ep),
        "w_down": PDef((e.n_experts, e.d_ff, d), spec=ep),
    }
    if e.n_shared:
        f = e.n_shared * e.d_ff
        t["ws_gate"] = PDef((d, f), spec=(None, "model"))
        t["ws_up"] = PDef((d, f), spec=(None, "model"))
        t["ws_down"] = PDef((f, d), spec=("model", None))
    return t


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    e = cfg.moe
    c = int(n_tokens * e.top_k * e.capacity_factor / e.n_experts) + 1
    return -(-c // 8) * 8    # pad to 8 for tidy layouts


def route(cfg: ModelConfig, p, xt: torch.Tensor):
    """xt (..., D) bf16 -> (probs (..., E) f32, gates (..., k) f32
    renormalised, experts (..., k) int64).  The top k come from a stable
    descending sort, so equal probabilities go to the lower expert id."""
    probs = torch.softmax(layers.matmul_f32(xt, p["router"]), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = top.values[..., :cfg.moe.top_k]
    experts = top.indices[..., :cfg.moe.top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gates, experts


def dispatch(cfg: ModelConfig, experts: torch.Tensor, cap: int):
    """Capacity slots of a group's choices: experts (G, n, k) -> (flat
    experts (G, n*k), slot (G, n*k), keep (G, n*k)).  A (token, choice)'s
    slot is its rank among its expert's entries in token-major, then
    choice, order (a one-hot cumsum); it is kept if the slot is below the
    capacity ``cap``."""
    flat_e = experts.reshape(experts.shape[0], -1)
    onehot = torch.nn.functional.one_hot(flat_e, cfg.moe.n_experts)
    slot = (onehot.cumsum(dim=1) - 1).gather(2, flat_e[..., None])[..., 0]
    return flat_e, slot, slot < cap


def expert_ffn(h: torch.Tensor, wg, wu, wd,
               out_f32: bool = False) -> torch.Tensor:
    """The experts' SwiGLU, batched: h (E, T, D) bf16 through stacks wg/wu
    (E, D, F) and wd (E, F, D) -> (E, T, D).  The gate and up products
    are rounded to bf16 before the SwiGLU (the reference's f32
    ``einsum``s); the down product is rounded to bf16 too, or kept in f32
    with ``out_f32`` (the decode step's)."""
    act = layers.swiglu(layers.bmm_f32(h, wg).to(torch.bfloat16),
                        layers.bmm_f32(h, wu).to(torch.bfloat16))
    out = layers.bmm_f32(act, wd)
    return out if out_f32 else out.to(torch.bfloat16)


def shared_ffn(p, xt: torch.Tensor) -> torch.Tensor:
    """The shared experts on every token: (N, D) -> (N, D) f32."""
    hs = layers.swiglu(layers.pdot(xt, p["ws_gate"]),
                       layers.pdot(xt, p["ws_up"]))
    return layers.matmul_f32(hs, p["ws_down"])


def moe_forward(cfg: ModelConfig, run: RunConfig, p, x: torch.Tensor,
                groups: int = 1, tg=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (output (B, S, D) bf16, aux loss (groups,) f32).

    The B * S tokens form ``groups`` equal groups in order (1: the whole
    batch dispatched jointly, as the reference's ``moe_forward``; B: each
    sequence on its own, as its vmapped B = 1 prefills); each group has
    its own capacity ``_capacity(B * S / groups)`` and its own aux loss.
    At tp > 1 x is the rank's sequence shard (not gathered: routing is per
    token), the capacity comes from the rank's tokens, and the output is
    whole (no caller reduction)."""
    e = cfg.moe
    b, s, d = x.shape
    n = b * s // groups
    k, ne = e.top_k, e.n_experts
    tp = cl.world(tg)
    el = ne // tp
    xt = x.reshape(groups, n, d)
    probs, gates, experts = route(cfg, p, xt)           # (G, n, E|k)

    # aux load-balancing loss (Switch-style), per group
    me = probs.mean(dim=1)
    ce = torch.zeros((groups, ne), dtype=torch.float32, device=x.device)
    ce.scatter_add_(1, experts.reshape(groups, -1),
                    torch.ones((groups, n * k), dtype=torch.float32,
                               device=x.device))
    aux = ne * (me * (ce / (n * k))).sum(-1)

    cap = _capacity(n, cfg)
    flat_e, slot, keep = dispatch(cfg, experts, cap)
    flat_t = torch.arange(n, device=x.device).repeat_interleave(k)
    g_idx = torch.arange(groups, device=x.device)[:, None]
    # dropped entries write to a scratch slot ``cap`` that no one reads
    buf = torch.zeros((groups, ne, cap + 1, d), dtype=torch.bfloat16,
                      device=x.device)
    buf[g_idx, flat_e, torch.where(keep, slot, cap)] = xt[:, flat_t]
    buf = buf[:, :, :cap]
    if tp > 1:
        # each group's slots to the experts' ranks; received (G, tp, el,
        # cap, D): rank j's slots for this rank's el experts
        buf = cl.compressed_all_to_all(buf.contiguous(), tg, run.codec,
                                       split_axis=1, concat_axis=1,
                                       groups=groups, kind="dispatch")
    h = buf.reshape(groups, tp, el, cap, d).permute(2, 0, 1, 3, 4) \
        .reshape(el, groups * tp * cap, d)

    # the local experts over every group's (and rank's) slots at once
    # (stacked packed leaves are decoded exactly through raw_weight)
    out = expert_ffn(h, layers.raw_weight(p["w_gate"]),
                     layers.raw_weight(p["w_up"]),
                     layers.raw_weight(p["w_down"]))
    out = out.reshape(el, groups, tp, cap, d).permute(1, 2, 0, 3, 4) \
        .reshape(groups, ne, cap, d)
    if tp > 1:                          # back to the tokens' ranks
        out = cl.compressed_all_to_all(out.contiguous(), tg, run.codec,
                                       split_axis=1, concat_axis=1,
                                       groups=groups, kind="return")

    # combine: each token's kept choices times their gates, summed in f32
    # in choice order
    got = out[g_idx, flat_e, torch.where(keep, slot, 0)]   # (G, n*k, D)
    got = torch.where(keep[..., None], got, 0).float() \
        * gates.reshape(groups, n * k, 1)
    got = got.reshape(groups, n, k, d)
    y = torch.zeros((groups, n, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        y = y + got[:, :, j]
    if e.n_shared:
        ys = shared_ffn(p, xt.reshape(groups * n, d))
        if tp > 1:
            ys = cl.psum(ys.to(torch.bfloat16), tg).float()
        y = y + ys.reshape(y.shape)
    return y.to(torch.bfloat16).reshape(b, s, d), aux


def moe_decode(cfg: ModelConfig, p, x: torch.Tensor, tg=None) -> torch.Tensor:
    """The decode step's MoE (ports ``serve/engine.py:_moe_decode``): x
    (B, 1, D) -> (B, 1, D) bf16, no capacity.  Each of the k choices
    gathers its (D, F) expert slices per token (a copy of B slices a
    stack) and runs the per-token SwiGLU as a batched matmul; the
    contributions add up in f32 in choice order, then the shared experts.
    At tp > 1 the tokens are replicated and a rank holds experts ``[lo,
    lo + E/tp)``: a choice outside them gathers a local slice that its
    mask then drops, and the bf16 partials are summed over the ranks."""
    xt = x[:, 0]                                          # (B, D)
    _, gates, experts = route(cfg, p, xt)
    ewg = layers.raw_weight(p["w_gate"])
    ewu = layers.raw_weight(p["w_up"])
    ewd = layers.raw_weight(p["w_down"])
    tp = cl.world(tg)
    el = ewg.shape[0]
    lo = cl.rank(tg) * el
    xb = xt[:, None]                                      # (B, 1, D)
    y = torch.zeros((xt.shape[0], cfg.d_model), dtype=torch.float32,
                    device=x.device)
    for j in range(cfg.moe.top_k):
        idx = experts[:, j]
        if tp > 1:
            local = (idx >= lo) & (idx < lo + el)
            idx = (idx - lo).clamp(0, el - 1)
        o = expert_ffn(xb, ewg.index_select(0, idx), ewu.index_select(0, idx),
                       ewd.index_select(0, idx), out_f32=True)
        o = o[:, 0] * gates[:, j:j + 1]
        y = y + (torch.where(local[:, None], o, 0.0) if tp > 1 else o)
    if cfg.moe.n_shared:
        y = y + shared_ffn(p, xt)
    return cl.psum(y.to(torch.bfloat16), tg)[:, None]
