"""256-bin exponent histogram: the CUDA kernel ``csrc/exp_histogram.cu``
(replaces the Pallas kernel ``repro/kernels/exp_histogram.py``) and its
plain PyTorch twin.

``exp_histogram`` launches the kernel on CUDA tensors only; ``plain`` is
the same function in torch ops (``ref.histogram_ref``).  Callers go
through ``kernels.ops.histogram``, which picks one by the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from . import ref

plain = ref.histogram_ref

launches = 0          # kernel launches since the last reset


def exp_histogram(x: torch.Tensor) -> torch.Tensor:
    """(G, n) bf16 CUDA tensor -> (G, 256) int32 exponent counts per row."""
    global launches
    from .ops import check_cuda, library, raise_on_error

    check_cuda(x, torch.bfloat16, 2, "x")
    g, n = x.shape
    hist = torch.zeros((g, 256), dtype=torch.int32, device=x.device)
    if g == 0 or n == 0:
        return hist
    rc = library().exp_histogram_launch(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(hist.data_ptr()),
        ctypes.c_int(g), ctypes.c_longlong(n),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    raise_on_error(rc, "exp_histogram")
    launches += 1
    return hist
