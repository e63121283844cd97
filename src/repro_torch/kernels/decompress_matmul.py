"""Fused just-in-time weight decompression + matmul: the CUDA kernel
``csrc/decompress_matmul.cu`` (replaces the Pallas kernel
``repro/kernels/decompress_matmul.py:decompress_matmul``) and its plain
PyTorch twin.

``decompress_matmul`` launches the kernel on CUDA tensors only; ``plain``
is the same function in torch ops (``ref.decompress_matmul_ref``: exact
unpack, then an f32 product).  Callers go through
``kernels.ops.matmul_compressed`` / ``kernels.ops.matmul_packed``.

Unlike the reference's wrapper, nothing is padded on the host: the kernel
masks the ragged M, K and N edges itself.  N must be a multiple of 32
(the packed format's word).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import packing
from . import ref

plain = ref.decompress_matmul_ref

launches = 0          # kernel launches since the last reset

MAX_M_TILES = 65535   # grid.y, in 64-row tiles


def decompress_matmul(x: torch.Tensor, signman: torch.Tensor,
                      planes: torch.Tensor, dict_syms: torch.Tensor,
                      k: int) -> torch.Tensor:
    """x (M, K) bf16 @ packed W (K, N) -> (M, N) f32.  W: signman (K, N)
    uint8, planes (k, K, N/32) int32-held words, dict_syms (2^k,) uint8."""
    global launches
    from .ops import check_cuda, library, raise_on_error

    check_cuda(x, torch.bfloat16, 2, "x")
    check_cuda(signman, torch.uint8, 2, "signman")
    check_cuda(planes, torch.int32, 3, "planes")
    check_cuda(dict_syms, torch.uint8, 1, "dict_syms")
    m, kk = x.shape
    if not 1 <= k <= 8:
        raise ValueError(f"k must be in 1..8, got {k}")
    if signman.shape[0] != kk:
        raise ValueError(f"x has K={kk}, W has K={signman.shape[0]}")
    n = signman.shape[1]
    if n % packing.LANES:
        raise ValueError(f"N must be a multiple of 32, got {n}")
    if planes.shape != (k, kk, n // packing.LANES) \
            or dict_syms.shape != (1 << k,):
        raise ValueError(f"planes {tuple(planes.shape)} / dict "
                         f"{tuple(dict_syms.shape)} do not match W {(kk, n)} "
                         f"at k={k}")
    if signman.data_ptr() % 16:
        raise ValueError("signman must be 16-byte aligned")
    if -(-m // 64) > MAX_M_TILES or max(m, kk, n) >= 1 << 31:
        raise ValueError(f"shape {(m, kk, n)} is too large for one launch")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    vec_x = kk % 8 == 0 and x.data_ptr() % 16 == 0
    rc = library().decompress_matmul_launch(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(signman.data_ptr()),
        ctypes.c_void_p(planes.data_ptr()),
        ctypes.c_void_p(dict_syms.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), ctypes.c_int(m), ctypes.c_int(kk),
        ctypes.c_int(n), ctypes.c_int(k), ctypes.c_int(int(vec_x)),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    raise_on_error(rc, "decompress_matmul")
    launches += 1
    return out
