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

import ctypes

import torch

from repro_torch.core import packing
from . import ref

plain = ref.unpack_ref

launches = 0          # kernel launches since the last reset

MAX_ROWS = 65535      # grid.y


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
    rc = library().lexi_unpack_launch(
        ctypes.c_void_p(signman.data_ptr()),
        ctypes.c_void_p(planes.data_ptr()), ctypes.c_void_p(dicts.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), ctypes.c_int(g),
        ctypes.c_longlong(n), ctypes.c_int(k),
        ctypes.c_void_p(torch.cuda.current_stream(signman.device)
                        .cuda_stream))
    raise_on_error(rc, "lexi_unpack")
    launches += 1
    return out
