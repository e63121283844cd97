"""End-to-end trainer (ports ``repro/launch/train.py``): a data x model
mesh (FSDP over data ranks, tensor and sequence parallelism over model
ranks) with LEXI-compressed weight and activation gathers and gradient
sync, checkpoint/restart fault tolerance, straggler monitoring.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-1.8b \\
        --reduced --mesh 2x1 --device cpu --steps 8 --batch 4 --seq 32 \\
        --ckpt-dir /tmp/ckpt --ckpt-every 4 [--simulate-failure 6]
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-1.8b \\
        --reduced --mesh 1x2 --device cpu --steps 8 --batch 4 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-1.8b \\
        --no-reduced --mesh 2x1 --steps 3 --batch 4 --seq 512

``--mesh DxM`` runs D x M ranks, one process each (``launch.mesh.spawn``)
joined over ``--dist-backend``: gloo (the CPU, or several ranks sharing
one card: NCCL refuses two ranks on one device) or nccl (one card a
rank); the default is gloo where ranks share a device, else nccl.  Rank
r is (data rank, model rank) = divmod(r, M).  The dense family trains
under the megatron tp strategy; the fsdp strategy is reached through
``RunConfig(tp_strategy="fsdp")`` and ``train_loop`` only, as the
reference's CLI has no flag for it.  It runs on the card unless given
``--device cpu``.  Every rank runs the same loop in lockstep and
restarts with the others after a failure; rank 0 prints and writes the
checkpoints (the whole logical state, gathered from the ranks), which
restore at the same M only: the padded vocabulary depends on it.
``--reduced`` (the default) trains ``make_reduced(cfg, tp=M)``,
``--no-reduced`` the published width.  Weights are a seeded random init,
the same model at every M (``train_step.init_state``'s ``base``).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import time
from typing import Dict, Optional

import torch

from repro_torch.configs import get_config, make_reduced
from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
from repro_torch.core import tree
from repro_torch.core.collectives import CodecConfig
from repro_torch.data import pipeline as data_mod
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import lm, params as PM
from repro_torch.serve.engine import resolve_device
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import fault
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_step as TS


def state_like(table) -> TS.TrainState:
    """A whole state's structure and shapes, on the meta device (what
    ``checkpoint.restore`` checks a checkpoint against)."""
    shapes = PM.tmap(lambda d: torch.empty(d.shape, device="meta"), table)
    return TS.TrainState(shapes, opt_mod.OptState(
        torch.empty((), device="meta"), shapes, shapes, shapes))


def restore_state(ckpt_dir: str, table, mesh, dev) -> TS.TrainState:
    """The latest checkpoint under ``ckpt_dir`` cut to this rank's shards
    on ``dev``; a checkpoint written at another model size M does not fit
    ``table`` (its padded vocabulary and heads depend on M) and raises."""
    try:
        whole = ckpt_mod.restore(ckpt_dir, state_like(table))
    except ValueError as e:
        raise ValueError(
            f"{ckpt_dir}: the checkpoint does not fit the mesh's table "
            f"({e}); a checkpoint restores at the model size (tp) it was "
            f"written at, here {mesh.model}: the padded vocabulary "
            f"({table['embed'].shape[0]} rows here) depends on it") from e
    return tree.map_(lambda x: x.to(dev), TS.shard_state(whole, table, mesh))


def _save(ckpt_dir: str, step: int, state, table, mesh, log) -> None:
    """Every rank gathers the whole state; rank 0 writes it."""
    whole = TS.full_state(state, table, mesh)
    if mesh.group is None or mesh.group.rank == 0:
        path = ckpt_mod.save(ckpt_dir, step, whole)
        sz = ckpt_mod.stored_size(ckpt_dir, step)
        log(f"[ckpt] step {step} -> {path} "
            f"({sz['stored_bytes'] / 1e6:.1f} MB vs "
            f"{sz['raw_bytes'] / 1e6:.1f} MB raw, LEXI "
            f"{sz['raw_bytes'] / max(sz['stored_bytes'], 1):.2f}x)")
    del whole
    if mesh.group is not None:
        torch.distributed.barrier()


def train_loop(cfg, shape: ShapeConfig, mesh_cfg: MeshConfig,
               run: RunConfig, *, steps: int, ckpt_dir: Optional[str],
               ckpt_every: int, resume: bool, fail_at: Optional[int] = None,
               log=print, tg=None, device="cuda") -> Dict:
    """Train ``steps`` steps as this rank (``tg``, None at 1 x 1) of
    ``mesh_cfg``.  Returns the first and final loss, the straggler steps
    and ``history``: each step's loss, grad_norm, lr, clip_scale and ms."""
    mesh = mesh_mod.make_mesh(mesh_cfg, tg)
    dev = resolve_device(device if tg is None else tg.device)
    table = lm.lm_table(cfg, tp=mesh_cfg.model, data=mesh_cfg.data,
                        run=run)
    step_fn = TS.make_train_step(cfg, run, mesh, table, total_steps=steps)
    data = data_mod.for_config(cfg, shape, seed=run.seed)

    start = 0
    state = TS.init_state(table, seed=run.seed, device=dev, mesh=mesh,
                          base=lm.lm_table(cfg))
    if resume and ckpt_dir and (ckpt_mod.latest_step(ckpt_dir) is not None):
        start = ckpt_mod.latest_step(ckpt_dir)
        del state
        state = restore_state(ckpt_dir, table, mesh, dev)
        log(f"[train] resumed from step {start}")

    mon = fault.StragglerMonitor(
        on_straggler=lambda s, dt, p95: log(
            f"[fault] straggler at step {s}: {dt * 1e3:.0f}ms vs p95 "
            f"{p95 * 1e3:.0f}ms"))
    wd = fault.Watchdog(deadline_s=600.0)
    history = []
    for step in range(start, steps):
        if fail_at is not None and step == fail_at:
            raise fault.SimulatedFailure(f"injected failure at step {step}")
        batch = data_mod.shard_batch(data.batch_at(step), mesh.data_rank,
                                     mesh.data)
        batch = {k: v.to(dev) for k, v in batch.items()}
        wd.arm()
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        rec = {k: float(v) for k, v in metrics.items()}
        dt = time.time() - t0
        wd.disarm()
        mon.record(step, dt)
        history.append(dict(rec, step=step, ms=dt * 1e3))
        if step % max(1, steps // 20) == 0 or step == steps - 1:
            log(f"[train] step {step:5d} loss {rec['loss']:.4f} "
                f"gnorm {rec['grad_norm']:.3f} "
                f"lr {rec['lr']:.2e} {dt * 1e3:.0f}ms")
        if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
            _save(ckpt_dir, step + 1, state, table, mesh, log)
    if ckpt_dir:
        _save(ckpt_dir, steps, state, table, mesh, log)
    losses = [h["loss"] for h in history]
    return {"final_loss": losses[-1] if losses else float("nan"),
            "first_loss": losses[0] if losses else float("nan"),
            "stragglers": mon.straggler_steps, "history": history}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL, e.g. 2x1 or 1x2")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--codec", default="full",
                    choices=["full", "weights", "off"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--simulate-failure", type=int, default=None,
                    help="inject a failure at this step once, then recover")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"],
                    default=None,
                    help="ranks' process-group backend (default: gloo on "
                         "the CPU or where ranks share a card, else nccl)")
    args = ap.parse_args(argv)

    d, m = (int(x) for x in args.mesh.split("x"))
    mesh_cfg = MeshConfig(data=d, model=m, pod=1)
    codec = {"full": CodecConfig(), "weights": CodecConfig.weights_only(),
             "off": CodecConfig.off()}[args.codec]
    run = RunConfig(codec=codec, warmup_steps=max(args.steps // 10, 1))
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg, tp=m)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    dev = resolve_device(args.device)
    if d * m == 1:
        return _run(None, cfg, shape, mesh_cfg, run, args)
    backend = args.dist_backend or (
        "nccl" if dev.type == "cuda"
        and torch.cuda.device_count() >= d * m else "gloo")
    if backend == "nccl" and (dev.type != "cuda"
                              or torch.cuda.device_count() < d * m):
        raise SystemExit(f"--dist-backend nccl needs one card per rank: "
                         f"{d * m} ranks")
    codes = mesh_mod.spawn(_run, d * m, backend=backend, device=dev,
                           args=(cfg, shape, mesh_cfg, run, args))
    return max(codes)


def _run(tg, cfg, shape, mesh_cfg, run, args) -> int:
    """One rank's loop with restarts (every rank restarts together; only
    rank 0 prints)."""
    quiet = tg is not None and tg.rank != 0
    failed_once = {"done": False}

    def run_once() -> Dict:
        fail_at = None
        if args.simulate_failure is not None and not failed_once["done"]:
            failed_once["done"] = True
            fail_at = args.simulate_failure
        return train_loop(cfg, shape, mesh_cfg, run, steps=args.steps,
                          ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every or 0,
                          resume=True, fail_at=fail_at, tg=tg,
                          device=args.device)

    with contextlib.redirect_stdout(io.StringIO()) if quiet \
            else contextlib.nullcontext():
        out = fault.run_with_restarts(run_once, max_restarts=2)
        print(f"[train] done: loss {out['first_loss']:.4f} -> "
              f"{out['final_loss']:.4f}, restarts={out['restarts']}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
