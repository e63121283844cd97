"""Mixture-of-Experts FFN at tp = 1 (ports ``repro/models/moe.py``).

Routing: f32 router logits, softmax, top-k (ties to the lower expert id,
as ``jax.lax.top_k``), gates renormalised over the k choices, and the
Switch-style load-balancing aux loss.  Dispatch: capacity-factor slots,
drop on overflow -- a one-hot cumsum in token-major, then choice, order
gives each (token, choice) its slot in its expert's (cap, D) buffer, and a
slot at or past the capacity is dropped.  Then the expert SwiGLU over the
(E, cap, D) buffer, the f32 combine of each token's kept choices in
choice order, and the shared experts (a dense FFN on every token).

Collectives dropped at tp = 1: the expert-parallel ``lexi_all_to_all`` of
the dispatch and return (every expert is local).

Port-specific: ``groups`` dispatches G independent groups of tokens at
once, each with its own capacity and slots, as the reference's vmapped
B = 1 admission prefills do (``serve/scheduler.py:_admit_for``); the
expert products of all groups run in one batched matmul.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from . import layers
from .params import PDef


def moe_table(cfg: ModelConfig) -> Dict[str, PDef]:
    d, e = cfg.d_model, cfg.moe
    t = {
        "router": PDef((d, e.n_experts), "normal:0.006"),
        "w_gate": PDef((e.n_experts, d, e.d_ff)),
        "w_up": PDef((e.n_experts, d, e.d_ff)),
        "w_down": PDef((e.n_experts, e.d_ff, d)),
    }
    if e.n_shared:
        f = e.n_shared * e.d_ff
        t["ws_gate"] = PDef((d, f))
        t["ws_up"] = PDef((d, f))
        t["ws_down"] = PDef((f, d))
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
                groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (output (B, S, D) bf16, aux loss (groups,) f32).

    The B * S tokens form ``groups`` equal groups in order (1: the whole
    batch dispatched jointly, as the reference's ``moe_forward``; B: each
    sequence on its own, as its vmapped B = 1 prefills); each group has
    its own capacity ``_capacity(B * S / groups)`` and its own aux loss."""
    e = cfg.moe
    b, s, d = x.shape
    n = b * s // groups
    k, ne = e.top_k, e.n_experts
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
    h = buf[:, :, :cap].transpose(0, 1).reshape(ne, groups * cap, d)

    # expert FFN over every group's slots at once (stacked packed leaves
    # are decoded exactly through raw_weight)
    out = expert_ffn(h, layers.raw_weight(p["w_gate"]),
                     layers.raw_weight(p["w_up"]),
                     layers.raw_weight(p["w_down"]))
    out = out.reshape(ne, groups, cap, d).transpose(0, 1)

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
        y = y + shared_ffn(p, xt.reshape(groups * n, d)).reshape(y.shape)
    return y.to(torch.bfloat16).reshape(b, s, d), aux


def moe_decode(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """The decode step's MoE (ports ``serve/engine.py:_moe_decode`` at tp =
    1): x (B, 1, D) -> (B, 1, D) bf16, no capacity.  Each of the k choices
    gathers its (D, F) expert slices per token (a copy of B slices a
    stack) and runs the per-token SwiGLU as a batched matmul; the
    contributions add up in f32 in choice order, then the shared experts."""
    xt = x[:, 0]                                          # (B, D)
    _, gates, experts = route(cfg, p, xt)
    ewg = layers.raw_weight(p["w_gate"])
    ewu = layers.raw_weight(p["w_up"])
    ewd = layers.raw_weight(p["w_down"])
    xb = xt[:, None]                                      # (B, 1, D)
    y = torch.zeros((xt.shape[0], cfg.d_model), dtype=torch.float32,
                    device=x.device)
    for j in range(cfg.moe.top_k):
        idx = experts[:, j]
        o = expert_ffn(xb, ewg.index_select(0, idx), ewu.index_select(0, idx),
                       ewd.index_select(0, idx), out_f32=True)
        y = y + o[:, 0] * gates[:, j:j + 1]
    if cfg.moe.n_shared:
        y = y + shared_ffn(p, xt)
    return y.to(torch.bfloat16)[:, None]
