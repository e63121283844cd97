"""Shared helpers for the PyTorch port's CPU tests (``test_torch_*.py``):
numpy <-> torch/JAX conversion with exact bf16 bits."""

import ml_dtypes
import numpy as np
import torch


def to_torch(a, device="cpu") -> torch.Tensor:
    """Any array-like (numpy, JAX) -> torch, bf16 bits preserved."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()) \
            .view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def to_np(t: torch.Tensor) -> np.ndarray:
    """torch -> numpy; bf16 as ml_dtypes.bfloat16 (same bits)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def bits(a) -> np.ndarray:
    """Raw bytes of an array, flat (for byte-identity asserts)."""
    a = to_np(a) if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def bf16_np(rng, shape, std=1.0, spread=0) -> np.ndarray:
    """Normal bf16 values; ``spread`` > 0 multiplies each by 2^U(-s, s)
    (more distinct exponents -> escapes)."""
    x = rng.normal(0, std, shape)
    if spread:
        x = x * np.exp2(rng.integers(-spread, spread + 1, shape))
    return x.astype(ml_dtypes.bfloat16)
