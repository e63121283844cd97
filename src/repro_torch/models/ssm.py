"""Mamba2 (SSD, state-space duality) mixer (ports ``repro/models/ssm.py``).

Prefill runs the chunked SSD scan (quadratic within a chunk, a linear
recurrence across chunks); decode is the O(1) recurrent update of the
fixed-size state, the "state cache" half of the paper's hybrid caches.

The reference's dtype points are kept: the prefill conv output is rounded
to bf16, the scan output is rounded to bf16 and the ``d_skip`` term added
in bf16 at prefill but in f32 at decode, the gate product is normalised in
f32, the recurrent state ``h`` stays f32 and the conv rings hold the
pre-activation inputs.  ``ssd_chunked`` contracts the reference's
four-operand einsums in an explicit order (decay and dt folded into the
(Q, Q, H) weights first, then one batched product over P), so no
(B, nc, Q, Q, H, P) intermediate is built.

Tensor parallelism (``tg`` a ``launch.mesh.TPGroup``): the heads
(d_inner) are column-sharded over the ranks -- ``w_zx``, ``w_dt``, the
per-head vectors, ``conv_x`` and ``gate_norm`` -- and the shared B/C
projection is row-parallel: each rank's ``d_model / tp`` slice of the
(gathered) input against its ``w_bc`` rows, the f32 partials summed over
the ranks (``collectives.psum``, rank order), then rounded to bf16.  The
output projection is row-sharded, so the caller reduces the f32 partial.
Two of the reference's choices are kept as it has them, so the model at
tp > 1 is not the tp = 1 model (ROADMAP.md, section 3): each rank splits
ITS ``w_zx`` columns in half into z and x, and ``gate_norm``'s RMS runs
over the rank's ``d_inner / tp`` channels.  The state a rank keeps is
its heads': ``h`` (..., nh/tp, hd, n), ``conv_x`` (..., k, d_inner/tp),
``conv_bc`` whole.  At tp = 1 the collectives are dropped.  The
attention-free model's block is this mixer alone (``blocks.
block_forward``: one compressed gather at its entry, the rank's heads, a
``psum_scatter`` of the partial in prefill, a ``psum`` in decode).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as cl
from . import layers
from .params import PDef


def ssm_dims(cfg: ModelConfig, tp: int = 1):
    """(d_inner, SSM heads, head dim, state size), whole; the heads split
    over ``tp`` ranks."""
    s = cfg.ssm
    di, nh = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
    if nh % tp:
        raise ValueError(f"{cfg.name}: {nh} SSM heads do not split over "
                         f"tp {tp}")
    return di, nh, s.headdim, s.d_state


def ssm_table(cfg: ModelConfig, tp: int = 1) -> Dict[str, PDef]:
    d = cfg.d_model
    di, nh, _, n = ssm_dims(cfg, tp)
    k = cfg.ssm.d_conv
    col, row, vec = (None, "model"), ("model", None), ("model",)
    return {
        "w_zx": PDef((d, 2 * di), spec=col),
        "w_bc": PDef((d, 2 * n), spec=row),
        "w_dt": PDef((d, nh), spec=col),
        "dt_bias": PDef((nh,), "zeros", spec=vec),
        "a_log": PDef((nh,), "zeros", spec=vec),   # A = -exp(a_log)
        "d_skip": PDef((nh,), "ones", spec=vec),
        "conv_x": PDef((k, di), "normal:0.1", spec=col),
        "conv_bc": PDef((k, 2 * n), "normal:0.1"),
        "gate_norm": PDef((di,), "ones", spec=vec),
        "w_out": PDef((di, d), spec=row),
    }


class SSMState(NamedTuple):
    """Decode-phase recurrent state (the paper's SSM "state cache") of
    one rank's heads; leaves may carry leading (L, ...) stack axes."""
    h: torch.Tensor          # (B, H/tp, P, N) f32
    conv_x: torch.Tensor     # (B, d_conv-1, di/tp) bf16 ring, pre-activation
    conv_bc: torch.Tensor    # (B, d_conv-1, 2N) bf16 ring, pre-activation


def empty_state(cfg: ModelConfig, lead: Tuple[int, ...],
                device="cpu", tp: int = 1) -> SSMState:
    """Zeroed state of one of ``tp`` ranks with leading axes ``lead``
    (e.g. (L, n_slots))."""
    di, nh, hd, n = ssm_dims(cfg, tp)
    k = cfg.ssm.d_conv - 1
    return SSMState(
        h=torch.zeros(lead + (nh // tp, hd, n), dtype=torch.float32,
                      device=device),
        conv_x=torch.zeros(lead + (k, di // tp), dtype=torch.bfloat16,
                           device=device),
        conv_bc=torch.zeros(lead + (k, 2 * n), dtype=torch.bfloat16,
                            device=device))


def state_nbytes(st: Optional[SSMState]) -> int:
    return 0 if st is None else sum(t.numel() * t.element_size()
                                    for t in st)


def take(st: SSMState, idx) -> SSMState:
    """``st`` indexed on its leading axis (views for an int or a slice)."""
    return SSMState(*(t[idx] for t in st))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(exp(x) + 1) with no switch to the identity
    (``F.softplus`` returns x above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq + silu: x (B,S,C), w (K,C) ->
    (B,S,C) bf16, summed tap by tap in f32 as the reference does."""
    k = w.shape[0]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    wf = w.float()
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + s, :].float() * wf[i]
    return F.silu(out).to(torch.bfloat16)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  x (B,S,H,P); dt (B,S,H) post-softplus; a (H,)
    negative; b/c (B,S,N) shared across heads.  Returns (y (B,S,H,P) bf16,
    final state (B,H,P,N) f32).  A tail that is not a multiple of the
    chunk is zero-padded: dt = 0 there, so its decay is 1 and it adds
    nothing (exact)."""
    bs, s, h, p_ = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        def zc(t):
            return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        x, dt, b, c = zc(x), zc(dt), zc(b), zc(c)
    nc = (s + pad) // q

    xf = x.float().reshape(bs, nc, q, h, p_)
    dtf = dt.float().reshape(bs, nc, q, h)
    bf = b.float().reshape(bs, nc, q, n)
    cf = c.float().reshape(bs, nc, q, n)
    lcum = torch.cumsum(dtf * a, dim=2)                 # (B,nc,Q,H) <= 0

    # intra-chunk: Y[t] = sum_{s<=t} (C_t.B_s) exp(l_t-l_s) dt_s x_s, with
    # (C.B) * decay * dt folded into one (B,nc,Q,Q,H) weight first
    g = torch.einsum("bcqn,bckn->bcqk", cf, bf)
    ldiff = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    decay = torch.where(mask[None, None, :, :, None], torch.exp(ldiff),
                        torch.zeros((), device=x.device))
    wts = g[..., None] * decay * dtf[:, :, None, :, :]
    y = torch.einsum("bcqkh,bckhp->bcqhp", wts, xf)

    # chunk states: S_c = sum_t B_t (dt_t x_t) exp(l_Q - l_t)
    tail = torch.exp(lcum[:, :, -1:, :] - lcum)         # (B,nc,Q,H)
    st = torch.einsum("bcqn,bcqhp->bchnp", bf,
                      (dtf * tail)[..., None] * xf)

    # inter-chunk recurrence over nc, then C_t . h_{c-1} * exp(l_t)
    chunk_decay = torch.exp(lcum[:, :, -1, :])          # (B,nc,H)
    hcur = torch.zeros((bs, h, n, p_), dtype=torch.float32, device=x.device)
    hprevs = []
    for ci in range(nc):
        hprevs.append(hcur)
        hcur = hcur * chunk_decay[:, ci, :, None, None] + st[:, ci]
    hprev = torch.stack(hprevs, dim=1)                  # (B,nc,H,N,P)
    y = y + torch.einsum("bcqn,bchnp->bcqhp", cf, hprev) \
        * torch.exp(lcum)[..., None]
    y = y.reshape(bs, nc * q, h, p_)[:, :s]
    return y.to(torch.bfloat16), hcur.transpose(-1, -2)


def _proj(cfg: ModelConfig, p, x: torch.Tensor, tg=None):
    """The input projections of the rank's heads: (z, x_in) bf16 (the
    rank's ``w_zx`` columns split in half), dt f32, (B‖C) bf16 (at
    tp > 1 row-parallel: the rank's slice of x against its ``w_bc`` rows,
    the f32 partials summed over the ranks, then rounded)."""
    tp = cl.world(tg)
    di_loc = ssm_dims(cfg, tp)[0] // tp
    zx = layers.pdot(x, p["w_zx"])
    dt = layers.matmul_f32(x, p["w_dt"])
    if tp == 1:
        bc = layers.matmul_f32(x, p["w_bc"])
    else:
        dsh = cfg.d_model // tp
        xs = x[..., tg.rank * dsh:(tg.rank + 1) * dsh].contiguous()
        bc = cl.psum(layers.matmul_f32(xs, p["w_bc"]), tg)
    return zx[..., :di_loc], zx[..., di_loc:], dt, bc.to(torch.bfloat16)


def _gate_out(cfg: ModelConfig, p, y: torch.Tensor,
              z: torch.Tensor) -> torch.Tensor:
    """rms_norm of the f32 gate product, then the output projection (f32,
    not rounded)."""
    y = layers.rms_norm(y.float() * F.silu(z.float()), p["gate_norm"],
                        cfg.norm_eps)
    return layers.matmul_f32(y, p["w_out"])


def ssm_forward(cfg: ModelConfig, p, x: torch.Tensor,
                want_state: bool = False, tg=None
                ) -> Tuple[torch.Tensor, Optional[SSMState]]:
    """Full-sequence SSD block: x (B,S,D) (gathered at tp > 1) -> (output
    (B,S,D) f32, at tp > 1 the rank's partial; the rank's final recurrent
    state for the prefill -> decode transition or None).  The conv
    weights are consumed by broadcast, not matmul, so they go through
    ``layers.raw_weight`` (decoded if the store packed them)."""
    tp = cl.world(tg)
    di, nh, hd, n = ssm_dims(cfg, tp)
    nh, di = nh // tp, di // tp
    bs, s, _ = x.shape
    z, xin_raw, dt, bc_raw = _proj(cfg, p, x, tg)
    xin = _causal_conv(xin_raw, layers.raw_weight(p["conv_x"]))
    bc = _causal_conv(bc_raw, layers.raw_weight(p["conv_bc"]))
    a = -torch.exp(p["a_log"].float())
    dt = softplus(dt + p["dt_bias"].float())
    xh = xin.reshape(bs, s, nh, hd)
    y, state = ssd_chunked(xh, dt, a, bc[..., :n], bc[..., n:],
                           cfg.ssm.chunk)
    y = y + xh * p["d_skip"].to(torch.bfloat16)[None, None, :, None]
    out = _gate_out(cfg, p, y.reshape(bs, s, di), z)
    if not want_state:
        return out, None
    k = cfg.ssm.d_conv - 1

    def ring(t):       # the last k pre-activation inputs, zeros before 0
        return F.pad(t, (0, 0, max(k - s, 0), 0))[:, -k:]

    return out, SSMState(h=state, conv_x=ring(xin_raw), conv_bc=ring(bc_raw))


def ssm_decode_step(cfg: ModelConfig, p, x: torch.Tensor, state: SSMState,
                    tg=None) -> Tuple[torch.Tensor, SSMState]:
    """One-token recurrent update: x (B,1,D) normed input (replicated at
    tp > 1) -> (output (B,1,D) f32, at tp > 1 the rank's partial; the
    rank's new state as fresh tensors).  The caller writes the new state
    into its persistent buffers (``write_state``)."""
    tp = cl.world(tg)
    di, nh, hd, n = ssm_dims(cfg, tp)
    nh, di = nh // tp, di // tp
    bs = x.shape[0]
    z, xin, dt, bc = _proj(cfg, p, x, tg)
    ring_x = torch.cat([state.conv_x, xin], dim=1)      # (B,K,di)
    ring_bc = torch.cat([state.conv_bc, bc], dim=1)
    xin_c = F.silu(torch.einsum("bkc,kc->bc", ring_x.float(),
                                layers.raw_weight(p["conv_x"]).float()))
    bc_c = F.silu(torch.einsum("bkc,kc->bc", ring_bc.float(),
                               layers.raw_weight(p["conv_bc"]).float()))
    b_, c_ = bc_c[:, :n], bc_c[:, n:]
    a = -torch.exp(p["a_log"].float())
    dt = softplus(dt[:, 0] + p["dt_bias"].float())      # (B,H)
    xh = xin_c.reshape(bs, nh, hd)
    decay = torch.exp(dt * a)
    upd = (dt[:, :, None] * xh)[..., None] * b_[:, None, None, :]
    h = state.h * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", h, c_)
    y = y + xh * p["d_skip"].float()[None, :, None]
    out = _gate_out(cfg, p, y.reshape(bs, 1, di), z)
    return out, SSMState(h=h, conv_x=ring_x[:, 1:], conv_bc=ring_bc[:, 1:])


def write_state(dst: SSMState, new: SSMState,
                active: Optional[torch.Tensor] = None) -> None:
    """Copy ``new`` into the persistent buffers ``dst`` in place (the
    addresses a captured step reads stay put); with ``active`` (B,) bool on
    the device, only its rows: inactive slots keep their state."""
    for d, v in zip(dst, new):
        if active is not None:
            v = torch.where(active.reshape((-1,) + (1,) * (v.ndim - 1)),
                            v, d)
        d.copy_(v)
