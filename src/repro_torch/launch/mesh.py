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
of the reference's ``make_mesh_from_config``): rank r is (data rank,
model rank) = divmod(r, model), the device order of the reference's
``jax.make_mesh((D, M), ("data", "model"))``, and ``axis_group(axes)`` is
the group a collective over those mesh axes runs on: the M ranks of one
data index for ("model",), the D ranks of one model index for
("data",), the world for both.  A ``TPGroup`` carries its process group
(``pg``, None for the default: the world) and its members' global ranks,
so every exchange of ``core.collectives`` runs on it.  pod > 1 is not
ported.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import MeshConfig

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """Rank ``rank`` of a tensor-parallel group of ``world`` ranks over
    ``backend``; ``device`` is where this rank's model tensors live.
    ``pg`` is the ``torch.distributed`` process group (None: the default
    group, the whole world) and ``ranks`` its members' global ranks in
    group-rank order (None: the identity)."""
    rank: int
    world: int
    backend: Optional[str]
    device: torch.device
    pg: Any = dataclasses.field(default=None, compare=False, repr=False)
    ranks: Optional[Tuple[int, ...]] = None

    def global_rank(self, r: int) -> int:
        """The global rank of group rank ``r``."""
        return r if self.ranks is None else self.ranks[r]


def solo(device="cpu") -> TPGroup:
    """The one-rank group: every collective is the identity."""
    return TPGroup(0, 1, None, torch.device(device))


def mesh_config(*, model: int = 1) -> MeshConfig:
    """The serving mesh as data: one replica (data = pod = 1), ``model``
    tensor-parallel ranks."""
    return MeshConfig(data=1, model=model, pod=1)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A data x model mesh of ranks (``MeshConfig`` sizes; ``make_mesh``
    builds pod = 1 only) as seen from one rank: ``group`` is that rank in
    the whole world (None at one rank); ``groups`` its sub-groups by axis
    ("data", "model"), where neither spans one rank or the world."""
    data: int
    model: int
    group: Optional[TPGroup]
    groups: Dict[str, TPGroup] = dataclasses.field(default_factory=dict,
                                                   compare=False)
    pod: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        """Each mesh axis's size."""
        return {"data": self.data, "model": self.model, "pod": self.pod}

    @property
    def index(self) -> Dict[str, int]:
        """This rank's index on each mesh axis."""
        return {"data": self.data_rank, "model": self.model_rank, "pod": 0}

    @property
    def data_rank(self) -> int:
        return 0 if self.group is None else self.group.rank // self.model

    @property
    def model_rank(self) -> int:
        return 0 if self.group is None else self.group.rank % self.model

    def size(self, axes: Sequence[str]) -> int:
        n = 1
        for a in axes:
            n *= self.shape[a]
        return n

    def axis_group(self, axes: Sequence[str]) -> Optional[TPGroup]:
        """The group of a collective over mesh ``axes``: None (every
        collective the identity) where they span one rank, the world
        where they span it, else the sub-group of the one axis of size
        > 1 that holds this rank (its ranks in data-major order, as the
        reference's axis tuples order them)."""
        n = self.size(axes)
        if n == 1:
            return None
        if n == self.data * self.model:
            return self.group
        (axis,) = [a for a in axes if self.size((a,)) > 1]
        return self.groups[axis]


def make_mesh(mc: MeshConfig, tg: Optional[TPGroup] = None) -> Mesh:
    """The ``Mesh`` of ``mc`` whose ranks are ``tg``'s world (``tg`` None
    or a one-rank group at 1 x 1).  Where both axes exceed one rank,
    every rank creates every sub-group (``torch.distributed.new_group``,
    collective) in one fixed order: the model groups by data index, then
    the data groups by model index."""
    if mc.pod > 1:
        raise NotImplementedError(
            f"mesh {mc.pod}x{mc.data}x{mc.model}: pod > 1 waits for its slice"
            " (ROADMAP.md, queue 1, item 4)")
    world = 1 if tg is None else tg.world
    if world != mc.data * mc.model:
        raise ValueError(f"mesh {mc.data}x{mc.model} needs "
                         f"{mc.data * mc.model} ranks, got {world}")
    if world == 1:
        return Mesh(mc.data, mc.model, None)
    groups: Dict[str, TPGroup] = {}
    if mc.data > 1 and mc.model > 1:
        di, mi = divmod(tg.rank, mc.model)
        members = {"model": [[d * mc.model + m for m in range(mc.model)]
                             for d in range(mc.data)],
                   "data": [[d * mc.model + m for d in range(mc.data)]
                            for m in range(mc.model)]}
        for axis, mine in (("model", di), ("data", mi)):
            for i, ranks in enumerate(members[axis]):
                pg = torch.distributed.new_group(ranks, backend=tg.backend)
                if i == mine:
                    groups[axis] = TPGroup(ranks.index(tg.rank), len(ranks),
                                           tg.backend, tg.device, pg,
                                           tuple(ranks))
    return Mesh(mc.data, mc.model, tg, groups)


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
