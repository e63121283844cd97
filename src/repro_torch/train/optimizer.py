"""AdamW with f32 master weights, gradient sync, global-norm clipping and a
warmup + cosine schedule (ports ``repro/train/optimizer.py``).

Each rank runs it on its own shards: master, m and v are stored like the
(sharded) params, so FSDP params get ZeRO-3-style optimizer sharding for
free.  ``table`` (the ``models.lm.lm_table`` the params were made from)
says which mesh axes shard each leaf, as the reference's PartitionSpecs
do; ``mesh`` (a ``launch.mesh.Mesh``) gives the group of a collective over
mesh axes.  Trees are nested dicts; leaves go in JAX's order
(``core.tree``).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core import collectives as cl
from repro_torch.core import tree
from repro_torch.models.params import spec_axes

MESH_AXES = ("data", "model")


class OptState(NamedTuple):
    step: torch.Tensor       # () int32
    master: Any              # f32 copy of params (same sharding)
    m: Any
    v: Any


def init_opt_state(params: Any) -> OptState:
    leaves = tree.leaves(params)
    dev = leaves[0].device if leaves else "cpu"
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        master=tree.map_(lambda x: x.float(), params),
        m=tree.map_(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), params),
        v=tree.map_(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), params))


def sync_grads(grads: Any, table: Any, mesh, run: RunConfig) -> Any:
    """Sum each leaf over the mesh axes its spec does NOT shard: the
    sharded dims were reduced by the gathers' backward reduce-scatters,
    the replicated leaves still hold per-rank partials (at model > 1 the
    norms' partials of the rank's sequence shard or batch slice).  The
    all-gather half of each sum is LEXI-compressed when ``codec.grads``
    is on (its bytes labelled ``grads``)."""

    def one(g, d):
        covered = set(spec_axes(d))
        axes = tuple(a for a in MESH_AXES if a not in covered)
        if not axes:
            return g
        tg = mesh.axis_group(axes)
        if run.codec.enabled and run.codec.grads:
            return cl.compressed_psum(g, tg, run.codec, kind="grads")
        return cl.psum(g, tg)

    return tree.map_(one, grads, table)


def global_norm(grads: Any, table: Any, mesh) -> torch.Tensor:
    """The global L2 norm of a synced gradient tree: each leaf's local sum
    of squares is summed over its SHARDED axes only (a replicated leaf is
    counted once), then the leaves are added in order."""
    total = None
    for g, d in zip(tree.leaves(grads), tree.leaves(table)):
        loc = (g.float() ** 2).sum()
        axes = spec_axes(d)
        if axes:
            loc = cl.psum(loc, mesh.axis_group(axes))
        total = loc if total is None else total + loc
    return torch.sqrt(total)


def lr_at(run: RunConfig, step: torch.Tensor,
          total_steps: int = 10_000) -> torch.Tensor:
    warm = torch.clamp(step / max(run.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - run.warmup_steps)
                    / max(total_steps - run.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return run.lr * warm * (0.1 + 0.9 * cos)


NO_DECAY_MIN_NDIM = 2   # norms/biases (ndim < 2) skip weight decay


def adamw_update(run: RunConfig, params: Any, grads: Any, opt: OptState,
                 table: Any, mesh, total_steps: int = 10_000):
    """One AdamW step.  Returns (new params, each in its old dtype, the
    new ``OptState``, metrics: grad_norm, lr, clip_scale).  ``opt``'s
    master, m and v are updated in place and become the new state's."""
    gnorm = global_norm(grads, table, mesh)
    scale = torch.clamp(run.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = opt.step + 1
    lr = lr_at(run, step, total_steps)
    b1, b2, eps, wd = run.beta1, run.beta2, run.eps, run.weight_decay
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    def one(p_master, g, m, v):
        # in place (the old state is not kept: at full width a second copy
        # of master, m and v would not fit two ranks on one card); each
        # product is rounded before its sum, as in the reference
        gf = g.float() * scale
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * gf * gf)
        upd = (m / c1) / (torch.sqrt(v / c2) + eps)
        if p_master.ndim >= NO_DECAY_MIN_NDIM:
            upd = upd + wd * p_master
        p_master.sub_(lr * upd)

    for xs in zip(*(tree.leaves(t) for t in (opt.master, grads, opt.m,
                                             opt.v))):
        one(*xs)
    new_params = tree.map_(lambda pm, old: pm.to(old.dtype), opt.master,
                           params)
    return new_params, opt._replace(step=step), {
        "grad_norm": gnorm, "lr": lr, "clip_scale": scale}
