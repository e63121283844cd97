#!/usr/bin/env python3
"""Where a training step's time goes on one NVIDIA GPU.

    python3 scripts/train_profile.py

Builds the kernel library, then runs ``train.train_step`` on the card on
``chip_smoke.py``'s train phase's model and shapes (``TRAIN_ARCH``,
``TRAIN_SHAPE``: full-width qwen1.5-1.8b, global batch 4 x 512, 2 steps),
at all 24 layers (the train phase runs the first ``TRAIN_LAYERS``),
from seed 0 (codec full, remat on, warmup 1), once at
mesh 1x1 in this process and once at mesh 2x1 as two ranks on the card
over gloo (``launch.mesh.spawn``; CUDA tensors staged through host
memory).  Each step is read by the host's clock from a synchronised
card, and split by the time spent in the wire's parts, each wrapped with
a synchronise before and after: ``collectives.gather_bytes`` (the packed
all-gathers), ``collectives.exchange_bytes`` (the raw reduce-scatters),
``fixed.compress_many`` and ``kernels.ops.unpack``, with their call
counts.  The first step in a process also pays one-time costs (the first
non-reentrant ``torch.utils.checkpoint`` imports dynamo).  Prints one
line per step per mesh and the card's name and power limit.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PARTS = (("collectives", "gather_bytes"), ("collectives", "exchange_bytes"),
         ("fixed", "compress_many"), ("ops", "unpack"))


def _timed(times, mod, name):
    """Wrap ``mod.name`` to add its synchronised wall time and calls."""
    import torch
    fn = getattr(mod, name)

    def wrap(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0
        times[name + " calls"] = times.get(name + " calls", 0) + 1
        return out
    setattr(mod, name, wrap)


def steps(tg, arch: str, n: int, batch: int, seq: int):
    """``n`` train steps as this rank (``tg`` None: mesh 1x1); one line
    each."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MeshConfig, RunConfig
    from repro_torch.core import collectives, fixed
    from repro_torch.data.pipeline import SyntheticLM, shard_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import lm
    from repro_torch.train import train_step as TS

    torch.backends.cuda.matmul.allow_tf32 = False
    times = {}
    mods = {"collectives": collectives, "fixed": fixed, "ops": ops}
    for mod, name in PARTS:
        _timed(times, mods[mod], name)
    cfg = get_config(arch)
    world = 1 if tg is None else tg.world
    run = RunConfig(warmup_steps=1)
    mesh = mesh_mod.make_mesh(MeshConfig(world, 1, 1), tg)
    table = lm.lm_table(cfg, data=world, run=run)
    state = TS.init_state(table, 0, "cuda", mesh)
    step = TS.make_train_step(cfg, run, mesh, table, total_steps=n)
    data = SyntheticLM(cfg.vocab_size, batch, seq, seed=0)
    lines = []
    for i in range(n):
        b = {k: v.cuda() for k, v in shard_batch(
            data.batch_at(i), mesh.data_rank, world).items()}
        times.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        loss = float(m["loss"])
        dt = time.perf_counter() - t0
        lines.append(
            f"{world}x1 step {i}: {dt:.3f} s, loss {loss:.6f}, grad norm "
            f"{float(m['grad_norm']):.6f} | " + ", ".join(
                f"{k} {v:.3f} s" if isinstance(v, float) else f"{k} {v}"
                for k, v in sorted(times.items())))
    return lines


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import gc
    import torch
    import chip_smoke as cs
    from repro_torch.launch import mesh

    if not torch.cuda.is_available():
        print("train_profile.py: no CUDA device", file=sys.stderr)
        return 1
    smi = cs.device_phase()
    cs.build_phase()
    batch, seq, n = cs.TRAIN_SHAPE
    a = (cs.TRAIN_ARCH, n, batch, seq)
    for line in steps(None, *a):
        print(f"[train_profile] {line} | {smi}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    for rank, lines in enumerate(mesh.spawn(steps, 2, backend="gloo",
                                            device="cuda", args=a)):
        for line in lines:
            print(f"[train_profile] rank {rank}: {line} | {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
