"""LEXI-FW exponent pack: the CUDA kernel ``csrc/lexi_pack.cu`` (replaces
the Pallas kernel ``repro/kernels/lexi_pack.py``) and its plain PyTorch
twin.

``lexi_pack`` launches the kernel on CUDA tensors only; ``plain`` is the
same function in torch ops (``ref.pack_ref``).  Callers go through
``kernels.ops.pack``, which picks one by the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import packing
from . import ref

plain = ref.pack_ref

launches = 0          # kernel launches since the last reset


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
    nw = packing.pad_to_lanes(n) // 32
    signman = torch.empty((g, n), dtype=torch.uint8, device=x.device)
    planes = torch.empty((g, k, nw), dtype=torch.int32, device=x.device)
    if g == 0 or n == 0:
        return signman, planes
    rc = library().lexi_pack_launch(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(enc_lut.data_ptr()),
        ctypes.c_void_p(signman.data_ptr()),
        ctypes.c_void_p(planes.data_ptr()), ctypes.c_int(g),
        ctypes.c_longlong(n), ctypes.c_int(k),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    raise_on_error(rc, "lexi_pack")
    launches += 1
    return signman, planes
