"""Declarative parameter tables, seeded init, and the bridge from the JAX
package's parameter tree (ports ``repro/models/params.py``).

A table is a nested dict with ``PDef`` leaves.  The port keeps the JAX
package's layouts — stacked ``(L, ...)`` block leaves, ``wq`` (D, Hq*hd),
``embed`` (Vp, D), ``lm_head`` (D, Vp) over the padded vocabulary — so a
bridged tree and the reference compare leaf for leaf.  Mesh sharding specs
are dropped: this slice runs on one GPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PDef:
    shape: Tuple[int, ...]
    init: str = "normal"              # normal | zeros | ones | normal:<std>
    dtype: torch.dtype = torch.bfloat16


Table = Dict[str, Any]   # nested dict with PDef leaves


def tmap(fn: Callable[[PDef], Any], table: Table) -> Any:
    if isinstance(table, PDef):
        return fn(table)
    return {k: tmap(fn, v) for k, v in table.items()}


def stack(table: Table, n: int) -> Table:
    """Prepend a layer dimension to every leaf."""
    return tmap(lambda d: dataclasses.replace(d, shape=(n,) + d.shape), table)


def init_params(table: Table, generator: torch.Generator,
                device="cpu") -> Any:
    """Seeded random init: normal(0, std) leaves drawn in f32 and rounded
    to bf16, ones/zeros as the ``PDef`` says (std 0.02 unless given).  It
    does not reproduce JAX's PRNG stream; use ``from_jax_params`` where
    numbers must match the reference."""

    def one(d: PDef) -> torch.Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=d.dtype, device=device)
        std = float(d.init.split(":")[1]) if ":" in d.init else 0.02
        a = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (a * std).to(d.dtype)

    return tmap(one, table)


def _to_tensor(a) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":       # ml_dtypes.bfloat16, exact
        return torch.from_numpy(arr.view(np.uint16).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def from_jax_params(tree, device="cpu") -> Any:
    """The reference's parameter tree (``models/params.py:init_params``
    output; any array-like leaves) as torch tensors, bit for bit."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    return _to_tensor(tree).to(device)


def to_device(params, device) -> Any:
    """A copy of a tensor tree on ``device``."""
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    return params.to(device)

