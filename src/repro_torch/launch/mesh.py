"""Tensor-parallel process groups (ports ``repro/launch/mesh.py``).

The reference runs every shard of a mesh inside one program
(``shard_map`` over named axes).  The port runs one process per shard
("rank") joined by ``torch.distributed``: ``TPGroup`` names a rank of the
model axis, ``init_tp`` joins the group, ``spawn`` starts ``world`` ranks
running one function and returns what each returned.

The backend is always the caller's choice: NCCL moves CUDA tensors
between cards; gloo moves CPU tensors (the CPU tests, and two ranks that
share one card, which NCCL refuses).  ``core.collectives`` stages CUDA
tensors through host memory for gloo, explicitly, by backend.

``spawn`` joins its ranks through a rendezvous file in a fresh temporary
directory, never a fixed port, so several groups can run side by side.

Training runs on a data x model ``Mesh`` (``make_mesh``, the counterpart
of the reference's ``make_mesh_from_config``): ``axis_group(axes)`` is
the group a collective over those mesh axes runs on.  Only model = 1 is
ported: the data axis is the whole world and the model axis one rank.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import traceback
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence

import torch

from repro_torch.configs.base import MeshConfig

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """Rank ``rank`` of a tensor-parallel group of ``world`` ranks over
    ``backend``; ``device`` is where this rank's model tensors live."""
    rank: int
    world: int
    backend: Optional[str]
    device: torch.device


def solo(device="cpu") -> TPGroup:
    """The one-rank group: every collective is the identity."""
    return TPGroup(0, 1, None, torch.device(device))


def mesh_config(*, model: int = 1) -> MeshConfig:
    """The serving mesh as data: one replica (data = pod = 1), ``model``
    tensor-parallel ranks."""
    return MeshConfig(data=1, model=model, pod=1)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A data x model mesh of ranks (``MeshConfig`` sizes, pod = 1) as
    seen from one rank: ``group`` is that rank in the whole world (None
    at one rank), ``data_rank`` its index on the data axis."""
    data: int
    model: int
    group: Optional[TPGroup]

    @property
    def data_rank(self) -> int:
        return 0 if self.group is None else self.group.rank // self.model

    def size(self, axes: Sequence[str]) -> int:
        sizes = {"data": self.data, "model": self.model, "pod": 1}
        n = 1
        for a in axes:
            n *= sizes[a]
        return n

    def axis_group(self, axes: Sequence[str]) -> Optional[TPGroup]:
        """The group of a collective over mesh ``axes``: None (every
        collective the identity) where they span one rank, else the whole
        world (at model = 1 every axis of size > 1 is the data axis)."""
        return None if self.size(axes) == 1 else self.group


def make_mesh(mc: MeshConfig, tg: Optional[TPGroup] = None) -> Mesh:
    """The ``Mesh`` of ``mc`` whose ranks are ``tg``'s world (``tg`` None
    or a one-rank group at 1 x 1)."""
    if mc.model > 1 or mc.pod > 1:
        raise NotImplementedError(
            f"mesh {mc.data}x{mc.model} (pod {mc.pod}): training at model > 1"
            " waits for its slice (ROADMAP.md, queue 1, item 4)")
    world = 1 if tg is None else tg.world
    if world != mc.data * mc.model:
        raise ValueError(f"mesh {mc.data}x{mc.model} needs "
                         f"{mc.data * mc.model} ranks, got {world}")
    return Mesh(mc.data, mc.model, None if world == 1 else tg)


def rank_device(device, rank: int) -> torch.device:
    """Where ``rank`` keeps its tensors: ``device``, but a CUDA device
    without an index is card ``rank`` modulo the cards (one card a rank
    where there are enough; ranks share cards round-robin where not)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def init_tp(rank: int, world: int, *, backend: str, device,
            init_method: str) -> TPGroup:
    """Join the default process group as ``rank`` of ``world`` and return
    its ``TPGroup``, whose device is ``rank_device(device, rank)``.  A
    CUDA device becomes this process's current device first (NCCL binds
    to it)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.distributed.init_process_group(
        backend=backend, init_method=init_method, world_size=world,
        rank=rank)
    return TPGroup(rank, world, backend, dev)


def _child(rank: int, fn: Callable, world: int, backend: str, device,
           init_method: str, args: Sequence[Any], out_dir: str) -> None:
    """A spawned rank: join, run ``fn(group, *args)``, pickle the result
    (or the traceback) to ``out_dir/rank<r>.pkl``, leave the group."""
    torch.set_num_threads(1)
    try:
        tg = init_tp(rank, world, backend=backend, device=device,
                     init_method=init_method)
        try:
            result = (True, fn(tg, *args))
        finally:
            torch.distributed.destroy_process_group()
    except BaseException:                      # reported by the parent
        result = (False, traceback.format_exc())
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def spawn(fn: Callable, world: int, *, backend: str, device="cpu",
          args: Sequence[Any] = ()) -> List[Any]:
    """Run ``fn(group, *args)`` on ``world`` fresh processes (start method
    ``spawn``), one rank each, and return their results in rank order.
    ``fn`` must be importable by name (a module-level function); the
    children import its module, torch and nothing else of the caller.
    A rank that raises makes ``spawn`` raise with its traceback."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="repro_tp_") as tmp:
        init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
        mp.start_processes(_child, args=(fn, world, backend, device,
                                         init_method, tuple(args), tmp),
                           nprocs=world, join=True, start_method="spawn")
        results = []
        for r in range(world):
            path = Path(tmp) / f"rank{r}.pkl"
            if not path.exists():
                raise RuntimeError(f"tp rank {r} left no result")
            with open(path, "rb") as f:
                ok, value = pickle.load(f)
            if not ok:
                raise RuntimeError(f"tp rank {r} of {world} failed:\n{value}")
            results.append(value)
    return results
