"""Model primitives on torch tensors (ports ``repro/models/layers.py``).

Numerics follow the reference: params and activations bf16; matmuls
accumulate in f32 and round to bf16 only after the bias add; norms,
attention logits and softmax in f32.

Collectives dropped at tp = 1: ``merge_partials``' pmax/psum (one shard:
the merge is ``out / max(l, 1e-30)``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.weights import PackedWeight, unpack_weight
from repro_torch.kernels import ops as kops

NEG_INF = -2.0e38


def matmul_f32(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` of bf16 operands as the f32 product (not rounded to bf16),
    the single weight-consuming matmul primitive.

    ``w`` is a raw tensor or a ``PackedWeight`` leaf of the packed serving
    store; packed leaves go to ``kernels.ops.matmul_packed`` on the backend
    baked in at pack time.  A raw ``w`` on CUDA is cuBLAS through
    ``torch.mm(..., out_dtype=float32)`` (``aten::mm.dtype``: bf16 inputs,
    f32 accumulate and output); TF32 is irrelevant there and is left off
    for f32 products.  On the CPU, where ``aten::mm.dtype`` does not
    exist, both operands are upcast to f32, which gives the same exact
    products."""
    if isinstance(w, PackedWeight):
        return kops.matmul_packed(x, w)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cuda":
        out = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        out = torch.mm(x2.float(), w.float())
    return out.reshape(lead + (w.shape[-1],))


def raw_weight(w):
    """A weight for non-matmul consumers: the exact bf16 decode of a
    ``PackedWeight``, a raw tensor as it is."""
    return unpack_weight(w) if isinstance(w, PackedWeight) else w


def pdot(x: torch.Tensor, w,
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w with f32 accumulation, bf16 result."""
    out = matmul_f32(x, w)
    if bias is not None:
        out = out + bias.float()
    return out.to(torch.bfloat16)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(torch.bfloat16)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> (cos, sin) of shape (..., S, dim/2), f32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B,H,S,hd); cos/sin (S,hd/2) or broadcastable; pairs interleaved."""
    xf = x.float()
    x1, x2 = xf[..., ::2], xf[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Flash attention (prefill): chunked online softmax, causal/window/softcap,
# GQA by kv-head groups.
# ---------------------------------------------------------------------------

class AttnSpec(NamedTuple):
    causal: bool = True
    softcap: Optional[float] = None
    scale: Optional[float] = None
    windowed: bool = False             # if True a window size is given


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor,
                    spec: AttnSpec, *, window=None, chunk_q: int = 512,
                    chunk_kv: int = 512) -> torch.Tensor:
    """q (B,Hq,Sq,hd), k/v (B,Hkv,Skv,hd) -> (B,Hq,Sq,hd) bf16.

    The reference's rectangle schedule: per query chunk, an online softmax
    over key chunks.  For causal self-attention (``q_pos is kv_pos``,
    ascending positions, as prefill passes them) key chunks lying wholly
    after the query chunk are skipped: they add exactly nothing (p = 0,
    alpha = 1), which the reference's triangle-only pair schedule relies
    on too.
    """
    b, hq, sq, hd = q.shape
    _, hkv, skv, _ = k.shape
    hd_v = v.shape[-1]
    g = hq // hkv
    scale = spec.scale if spec.scale is not None else hd ** -0.5
    cq, ckv = min(chunk_q, sq), min(chunk_kv, skv)
    assert sq % cq == 0 and skv % ckv == 0, (sq, cq, skv, ckv)
    qg = q.reshape(b, hkv, g, sq, hd).float()
    kf, vf = k.float(), v.float()
    outs = []
    for q0 in range(0, sq, cq):
        qb = qg[:, :, :, q0:q0 + cq]
        qp = q_pos[q0:q0 + cq]
        out = torch.zeros((b, hkv, g, cq, hd_v), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, hkv, g, cq), NEG_INF, device=q.device)
        l = torch.zeros((b, hkv, g, cq), device=q.device)
        for k0 in range(0, skv, ckv):
            if spec.causal and q_pos is kv_pos and k0 >= q0 + cq:
                continue
            kp = kv_pos[k0:k0 + ckv]
            s = torch.einsum("bhgqd,bhkd->bhgqk", qb,
                             kf[:, :, k0:k0 + ckv]) * scale
            s = softcap(s, spec.softcap)
            msk = torch.ones((cq, kp.shape[0]), dtype=torch.bool,
                             device=q.device)
            if spec.causal:
                msk &= kp[None, :] <= qp[:, None]
            if spec.windowed:
                msk &= kp[None, :] > (qp[:, None] - window)
            s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m, s.max(-1).values)
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            out = out * alpha[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vf[:, :, k0:k0 + ckv])
            m = m_new
        outs.append((out / l.clamp(min=1e-30)[..., None]).to(torch.bfloat16))
    return torch.cat(outs, dim=3).reshape(b, hq, sq, hd_v)


def merge_partials(out: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Normalise one shard's attention partials (the tp = 1 merge):
    out (..., hd) f32 unnormalised, l (...) -> bf16.  The running max is
    not needed: one shard's max is the global max."""
    return (out / l.clamp(min=1e-30)[..., None]).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Activation functions
# ---------------------------------------------------------------------------

def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return (F.silu(gate.float()) * up.float()).to(torch.bfloat16)
