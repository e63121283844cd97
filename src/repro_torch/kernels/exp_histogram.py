"""256-bin exponent histogram: the CUDA kernel ``csrc/exp_histogram.cu``
(replaces the Pallas kernel ``repro/kernels/exp_histogram.py``) and its
plain PyTorch twin.

``exp_histogram`` launches the kernel on CUDA tensors only; ``plain`` is
the same function in torch ops (``ref.histogram_ref``).  Callers go
through ``kernels.ops.histogram``, which picks one by the tensor's device.
``plan`` is the launch's host plan (pure Python, tested on the CPU).

One launch per call, no memset: a row counted by several CTAs is summed
by the last of them from their partials, which live with the rows'
arrival counters in a workspace cached per (device, stream)
(``_workspace``); the kernel leaves the counters zeroed.  Launches on one
stream run in order and share it; a launch on another stream gets its
own.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from . import ref, workspace

plain = ref.histogram_ref

launches = 0          # kernel launches since the last reset

MAX_ROWS = 65535      # grid.y
THREADS = 256
VEC_ELEMS = 8         # a 16-byte load of bf16
FOLD_ROUNDS = 28      # rounds between folds: 8 x 28 counts fit a byte
UNROLL = 4            # rounds whose loads are in flight at once
MIN_ROUNDS = UNROLL   # a CTA counts at least this many rounds
FILL_CTAS = 264       # two 64 KB CTAs on each of 132 SMs (three fit)
SMEM_BYTES = 256 * THREADS   # one 8-bit counter per (bin, thread), dynamic


class Plan(NamedTuple):
    """One launch: grid (ctas, rows) of THREADS threads; CTA c counts the
    items [c * span, (c + 1) * span) of its row (16-byte vectors if
    ``vec``, else elements), one item per thread per round."""
    ctas: int
    rows: int
    span: int
    items: int
    vec: bool

    def workspace(self) -> Tuple[int, int]:
        """int32 elements of (partials, arrival counters) the launch reads:
        none when each row is one CTA's."""
        if self.ctas == 1:
            return 0, 0
        return self.rows * self.ctas * 256, self.rows


def vector_path(n: int, x_ptr: int) -> bool:
    """16-byte loads only if every row of x starts 16-byte aligned."""
    return n % VEC_ELEMS == 0 and x_ptr % 16 == 0


def plan(g: int, n: int, vec: bool) -> Plan:
    """CTAs per row: about FILL_CTAS in all (never more, unless there are
    more rows), none with fewer than MIN_ROUNDS rounds unless the row is
    shorter; each CTA's span a whole number of rounds, and none empty."""
    items = n // VEC_ELEMS if vec else n
    rounds = max(1, -(-items // THREADS))
    ctas = max(1, min(-(-rounds // MIN_ROUNDS), FILL_CTAS // max(g, 1)))
    span = -(-rounds // ctas) * THREADS
    return Plan(ctas=max(1, -(-items // span)), rows=g, span=span,
                items=items, vec=vec)


_workspaces: Dict[Tuple[torch.device, int],
                  Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device, stream: int, p: Plan
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The partials and arrival counters for one launch on ``stream``
    (the counters allocated zeroed; every launch leaves them zero), grown
    as ``kernels.workspace`` says."""
    need, rows = p.workspace()
    part, arrived = _workspaces.get((device, stream), (None, None))
    part = workspace.sized(part, need, torch.int32, device)
    arrived = workspace.sized(arrived, rows, torch.int32, device, zeroed=True)
    _workspaces[(device, stream)] = (part, arrived)
    return part, arrived


def exp_histogram(x: torch.Tensor) -> torch.Tensor:
    """(G, n) bf16 CUDA tensor -> (G, 256) int32 exponent counts per row."""
    global launches
    from .ops import check_cuda, library, raise_on_error

    check_cuda(x, torch.bfloat16, 2, "x")
    g, n = x.shape
    if g > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} rows per launch, got {g}")
    if g == 0 or n == 0:
        return torch.zeros((g, 256), dtype=torch.int32, device=x.device)
    hist = torch.empty((g, 256), dtype=torch.int32, device=x.device)
    xp = x.data_ptr()
    p = plan(g, n, vector_path(n, xp))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    part, arrived = _workspace(x.device, stream, p)
    rc = library().exp_histogram_launch(
        xp, hist.data_ptr(), part.data_ptr(), arrived.data_ptr(), g, n,
        p.ctas, p.span, int(p.vec), stream)
    raise_on_error(rc, "exp_histogram")
    launches += 1
    return hist
