"""LEXI-FW exponent pack: the CUDA kernel ``csrc/lexi_pack.cu`` (replaces
the Pallas kernel ``repro/kernels/lexi_pack.py``) and its plain PyTorch
twin.

``lexi_pack`` launches the kernel on CUDA tensors only; ``plain`` is the
same function in torch ops (``ref.pack_ref``).  Callers go through
``kernels.ops.pack``, which picks one by the tensor's device.  ``plan``
is the launch's host plan (pure Python, tested on the CPU).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import packing
from . import ref

plain = ref.pack_ref

launches = 0          # kernel launches since the last reset

MAX_ROWS = 65535      # grid.y
THREADS = 256         # per CTA, one 32-element word each
FILL_CTAS = 396       # three CTAs of 256 threads on each of 132 SMs
SMEM_BYTES = 256      # the row's encode LUT as 8-bit codes (static)


class Plan(NamedTuple):
    """One launch: grid (ctas, rows) of THREADS threads; words below
    ``nfull`` take the vector path (a thread each, grid stride), the rest
    the scalar path (a warp each, grid stride over the warps)."""
    ctas: int
    rows: int
    nw: int
    nfull: int


def vector_path(n: int, x_ptr: int, sm_ptr: int) -> bool:
    """Whole words take 16-byte loads and stores only if every row of x
    and of signman starts 16-byte aligned."""
    return n % 16 == 0 and x_ptr % 16 == 0 and sm_ptr % 16 == 0


def plan(g: int, n: int, vec: bool) -> Plan:
    """CTAs per row: one per 256 words, at most about FILL_CTAS in all;
    the CTAs then stream their row's words with a grid stride (as
    ``lexi_unpack.ctas_per_row``)."""
    nw = packing.pad_to_lanes(n) // packing.LANES
    ctas = max(1, min(-(-nw // THREADS), -(-FILL_CTAS // max(g, 1))))
    return Plan(ctas=ctas, rows=g, nw=nw,
                nfull=n // packing.LANES if vec else 0)


def lexi_pack(x: torch.Tensor, enc_lut: torch.Tensor, k: int):
    """(G, n) bf16 + per-row encode LUTs (G, 256) int32 -> (signman (G, n)
    uint8, planes (G, k, pad32(n)/32) int32-held uint32 words)."""
    global launches
    from .ops import check_cuda, library, raise_on_error

    check_cuda(x, torch.bfloat16, 2, "x")
    check_cuda(enc_lut, torch.int32, 2, "enc_lut")
    g, n = x.shape
    if enc_lut.shape != (g, 256):
        raise ValueError(f"enc_lut must be ({g}, 256), got "
                         f"{tuple(enc_lut.shape)}")
    if not 1 <= k <= 8:
        raise ValueError(f"k must be in 1..8, got {k}")
    if g > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} rows per launch, got {g}")
    nw = packing.pad_to_lanes(n) // 32
    signman = torch.empty((g, n), dtype=torch.uint8, device=x.device)
    planes = torch.empty((g, k, nw), dtype=torch.int32, device=x.device)
    if g == 0 or n == 0:
        return signman, planes
    xp, sp = x.data_ptr(), signman.data_ptr()
    vec = vector_path(n, xp, sp)
    rc = library().lexi_pack_launch(
        xp, enc_lut.data_ptr(), sp, planes.data_ptr(), g, n, k,
        plan(g, n, vec).ctas, int(vec),
        torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error(rc, "lexi_pack")
    launches += 1
    return signman, planes
