"""The training step and ``TrainState`` plumbing (ports
``repro/train/train_step.py``).

The reference jits one SPMD step under ``shard_map``; the port runs one
step function per rank (``make_train_step``): the rank's loss share and
its gradients by autograd (the FSDP gathers' backward reduce-scatters
the sharded leaves' gradients), the replicated leaves' gradients summed
over the ranks (``optimizer.sync_grads``), then AdamW on the rank's
shards.  The reported loss is the ranks' shares summed outside autograd.

Scope: the dense family (qwen*, codeqwen, gemma2) on a data x model mesh
(pod = 1) under both tp strategies, megatron and fsdp; ``check_train``
refuses the rest.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import collectives as cl
from repro_torch.core import tree
from repro_torch.models import lm, params as PM
from . import optimizer as opt_mod


class TrainState(NamedTuple):
    params: Any
    opt: opt_mod.OptState


def check_train(cfg: ModelConfig, mesh, run: RunConfig) -> None:
    """Raise for what this slice's trainer does not cover, naming its
    ROADMAP.md item."""
    if mesh.pod > 1:
        raise NotImplementedError(
            f"training at pod = {mesh.pod} waits for its slice (ROADMAP.md, "
            "queue 1, item 4)")
    if run.tp_strategy not in ("megatron", "fsdp"):
        raise ValueError(f"unknown tp_strategy {run.tp_strategy!r}")
    where = "waits for its slice (ROADMAP.md, queue 1, item 4.2)"
    for what, on in (("MoE", cfg.moe is not None),
                     ("SSM and hybrid", cfg.ssm is not None
                      or cfg.n_heads == 0),
                     ("MLA", cfg.mla is not None),
                     ("enc-dec", cfg.encdec),
                     ("VLM (vision stub)", cfg.frontend == "vision_stub")):
        if on:
            raise NotImplementedError(f"{cfg.name}: {what} training {where}")


def make_train_step(cfg: ModelConfig, run: RunConfig, mesh, table,
                    total_steps: int = 10_000):
    """Returns ``train_step(state, batch) -> (state, metrics)`` for this
    rank of ``mesh`` (a ``launch.mesh.Mesh``; ``batch`` the rank's slice of
    the global batch, ``state`` its shards).  Every rank of the mesh calls
    it in lockstep."""
    check_train(cfg, mesh, run)
    dims = lm.lm_fsdp_dims(table)
    loss_group = mesh.axis_group(opt_mod.MESH_AXES)

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState,
                                                            Dict]:
        params = tree.map_(lambda x: x.detach().requires_grad_(),
                           state.params)
        local_loss = lm.train_loss(cfg, run, params, batch, mesh, dims)
        grads = tree.unflatten(params, torch.autograd.grad(
            local_loss, tree.leaves(params)))
        del params
        # the global mean loss: every rank's share summed once, over
        # every mesh axis
        loss = cl.psum(local_loss.detach(), loss_group)
        grads = opt_mod.sync_grads(grads, table, mesh, run)
        new_params, new_opt, metrics = opt_mod.adamw_update(
            run, state.params, grads, state.opt, table, mesh, total_steps)
        return TrainState(new_params, new_opt), dict(metrics, loss=loss)

    return train_step


def init_state(table, seed: int = 0, device="cpu", mesh=None,
               base=None) -> TrainState:
    """Seeded random params (``params.init_params`` of the whole table on
    ``device``, so every rank draws the same numbers) cut to this rank's
    shards, and a fresh optimizer state.  ``base`` (the model's tp = 1
    table, ``lm.lm_table(cfg)``): the draw is ``base``'s, each leaf
    zero-padded at the end of every dim to ``table``'s shape (the padded
    vocabulary rows and query heads, as ``params.pad_for_tp`` pads), so
    a seed is the same model at every model size."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    params = PM.init_params(table if base is None else base, gen,
                            device=device)
    if base is not None:
        params = tree.map_(_pad_to, params, table)
    if mesh is not None:
        params = PM.shard_data(params, table, mesh.shape, mesh.index)
    return TrainState(params, opt_mod.init_opt_state(params))


def _pad_to(x: torch.Tensor, d) -> torch.Tensor:
    """``x`` zero-padded at the end of each dim to ``d.shape``."""
    if tuple(x.shape) == tuple(d.shape):
        return x
    out = x.new_zeros(d.shape)
    out[tuple(slice(0, n) for n in x.shape)] = x
    return out


def shard_state(state: TrainState, table, mesh) -> TrainState:
    """A whole (logical) state cut to this rank's shards on both mesh
    axes: params, master, m and v alike."""
    cut = lambda t: PM.shard_data(t, table, mesh.shape, mesh.index)
    o = state.opt
    return TrainState(cut(state.params), o._replace(
        master=cut(o.master), m=cut(o.m), v=cut(o.v)))


def full_tree(t, table, mesh):
    """The whole (logical) leaves of a tree of this rank's shards: each
    sharded dim gathered (a plain all-gather) over its spec entry's mesh
    axes, a tuple over the world in its data-major order; every rank
    calls this together."""
    def whole(x, d):
        for dim, sp in enumerate(PM.spec_of(d)):
            tg = mesh.axis_group(PM.entry_axes(sp))
            if tg is not None:
                x = cl.all_gather(x, tg, dim)
        return x
    return tree.map_(whole, t, table)


def full_state(state: TrainState, table, mesh) -> TrainState:
    """The whole (logical) state from every rank's shards, the
    model-sharded leaves gathered too, so a checkpoint holds the logical
    arrays, as the reference's does; every rank calls this together."""
    o = state.opt
    whole = lambda t: full_tree(t, table, mesh)
    return TrainState(whole(state.params), o._replace(
        master=whole(o.master), m=whole(o.m), v=whole(o.v)))


def from_jax_state(state, device="cpu") -> TrainState:
    """The reference's ``TrainState(params, OptState(step, master, m,
    v))`` (any array-like leaves) as the port's, bit for bit."""
    o = state.opt
    carry = lambda t: PM.from_jax_params(t, device)
    return TrainState(carry(state.params), opt_mod.OptState(
        step=PM.from_jax_params(o.step, device).to(torch.int32),
        master=carry(o.master), m=carry(o.m), v=carry(o.v)))
