"""LEXI-FW exponent unpack: the CUDA kernel ``csrc/lexi_unpack.cu``
(replaces the Pallas kernel ``repro/kernels/lexi_unpack.py``) and its
plain PyTorch twin.

``lexi_unpack`` launches the kernel on CUDA tensors only; ``plain`` is the
same function in torch ops (``ref.unpack_ref``).  Callers go through
``kernels.ops.unpack_rows`` (raw rows) or ``kernels.ops.unpack`` (a
``fixed.Compressed``, escapes patched), which pick one by the tensor's
device.
"""

from __future__ import annotations

import torch

from repro_torch.core import packing
from . import ref

plain = ref.unpack_ref

launches = 0          # kernel launches since the last reset

MAX_ROWS = 65535      # grid.y
THREADS = 256         # per CTA, one 32-element word each
FILL_CTAS = 264       # two CTAs of 256 threads on each of 132 SMs


def ctas_per_row(g: int, n: int) -> int:
    """CTAs per row: one per 256 words, at most FILL_CTAS in all; the CTAs
    then stream their row's words with a grid stride.  Measured on the
    H100: a full wave of resident CTAs (1056) streams slower than 132-264,
    whose accesses stay in one dense window of the rows."""
    nw = -(-n // packing.LANES)
    return max(1, min(-(-nw // THREADS), -(-FILL_CTAS // max(g, 1))))


def lexi_unpack(signman: torch.Tensor, planes: torch.Tensor,
                dicts: torch.Tensor, k: int) -> torch.Tensor:
    """(G, n) uint8 signman, (G, k, pad32(n)/32) int32-held plane words,
    (G, 2^k) uint8 per-row dictionaries -> (G, n) bf16, escape-free."""
    global launches
    from .ops import check_cuda, library, raise_on_error

    check_cuda(signman, torch.uint8, 2, "signman")
    check_cuda(planes, torch.int32, 3, "planes")
    check_cuda(dicts, torch.uint8, 2, "dicts")
    g, n = signman.shape
    if not 1 <= k <= 8:
        raise ValueError(f"k must be in 1..8, got {k}")
    if planes.shape != (g, k, packing.pad_to_lanes(n) // 32) \
            or dicts.shape != (g, 1 << k):
        raise ValueError(f"planes {tuple(planes.shape)} / dicts "
                         f"{tuple(dicts.shape)} do not match signman "
                         f"{(g, n)} at k={k}")
    if g > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} rows per launch, got {g}")
    out = torch.empty((g, n), dtype=torch.bfloat16, device=signman.device)
    if g == 0 or n == 0:
        return out
    sp, op = signman.data_ptr(), out.data_ptr()
    rc = library().lexi_unpack_launch(
        sp, planes.data_ptr(), dicts.data_ptr(), op, g, n, k,
        ctas_per_row(g, n), int(n % 16 == 0 and sp % 16 == 0
                                    and op % 16 == 0),
        torch.cuda.current_stream(signman.device).cuda_stream)
    raise_on_error(rc, "lexi_unpack")
    launches += 1
    return out
