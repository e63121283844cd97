"""Declarative parameter tables, seeded init, and the bridge from the JAX
package's parameter tree (ports ``repro/models/params.py``).

A table is a nested dict with ``PDef`` leaves.  The port keeps the JAX
package's layouts — stacked ``(L, ...)`` block leaves, ``wq`` (D, Hq*hd),
``embed`` (Vp, D), ``lm_head`` (D, Vp) over the padded vocabulary — so a
bridged tree and the reference compare leaf for leaf.  A leaf's ``spec``
names the mesh axis that shards each dim, as the reference's
PartitionSpecs do: "model" (tensor parallelism; ``shard_params`` cuts a
whole tree into rank ``ti``'s local tensors) and, in a training table,
"data" on the dim that ``apply_fsdp`` picks for FSDP (``fsdp_dim``), or
the axis tuple ("data", "model") under the fsdp tp_strategy
(``shard_data`` cuts a whole tree into mesh rank (di, mi)'s shards).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.weights import PackedWeight


@dataclasses.dataclass(frozen=True)
class PDef:
    shape: Tuple[int, ...]
    init: str = "normal"              # normal | zeros | ones | normal:<std>
    dtype: torch.dtype = torch.bfloat16
    # the mesh axis ("model" or "data") or axes (("data", "model"), data
    # major) sharding each dim, else None; () = replicated
    spec: Tuple[Any, ...] = ()
    fsdp_dim: Optional[int] = None    # the FSDP dim, set by apply_fsdp


Table = Dict[str, Any]   # nested dict with PDef leaves


def tmap(fn: Callable[[PDef], Any], table: Table) -> Any:
    if isinstance(table, PDef):
        return fn(table)
    return {k: tmap(fn, v) for k, v in table.items()}


def stack(table: Table, n: int) -> Table:
    """Prepend a layer dimension (never sharded) to every leaf."""
    return tmap(lambda d: dataclasses.replace(
        d, shape=(n,) + d.shape, spec=(None,) + d.spec if d.spec else (),
        fsdp_dim=None if d.fsdp_dim is None else d.fsdp_dim + 1), table)


def spec_of(d: PDef) -> Tuple[Optional[str], ...]:
    """``d``'s spec with one entry per dim (() = all None)."""
    return d.spec if d.spec else (None,) * len(d.shape)


def entry_axes(sp) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None, an axis, or a tuple)."""
    if sp is None:
        return ()
    return tuple(sp) if isinstance(sp, tuple) else (sp,)


def spec_axes(d: PDef) -> Tuple[str, ...]:
    """The mesh axes that shard ``d`` (the reference's ``_spec_axes``)."""
    return tuple(a for sp in spec_of(d) for a in entry_axes(sp))


def apply_fsdp(table: Table, n: int, min_size: int,
               skip_dim0: bool = False, axes: Tuple[str, ...] = ("data",)
               ) -> Table:
    """Shard the largest eligible replicated dim of every leaf of at least
    ``min_size`` elements over the ``n`` ranks of mesh ``axes`` (ties:
    the first such dim); a leaf with no replicated dim that ``n`` divides
    stays as it is.  ``skip_dim0``: never the leading (layer) dim of a
    stacked table (the reference's ``lm._fsdp_skip_scan_dim``).  The
    spec entry is the axis, or the axis tuple where there are several."""
    entry = axes[0] if len(axes) == 1 else tuple(axes)

    def one(d: PDef) -> PDef:
        if math.prod(d.shape) < min_size:
            return d
        spec = spec_of(d)
        cands = [(dim, s) for dim, (s, sp) in enumerate(zip(d.shape, spec))
                 if sp is None and s % n == 0 and s > 1
                 and not (skip_dim0 and dim == 0)]
        if not cands:
            return d
        dim = max(cands, key=lambda c: c[1])[0]
        return dataclasses.replace(
            d, spec=tuple(entry if i == dim else sp
                          for i, sp in enumerate(spec)), fsdp_dim=dim)

    return tmap(one, table)


def strip_model_specs(table: Table) -> Table:
    """The table with every "model" spec entry replaced by None (the fsdp
    tp_strategy's blocks: built at tp = 1, sharded by ``apply_fsdp``)."""
    return tmap(lambda d: dataclasses.replace(d, spec=tuple(
        None if sp == "model" else sp for sp in d.spec)), table)


def fsdp_dims(table: Table) -> Any:
    """The tree of each leaf's FSDP dim (None: replicated over data)."""
    return tmap(lambda d: d.fsdp_dim, table)


def shard_data(params: Any, table: Table, sizes: Dict[str, int],
               index: Dict[str, int]) -> Any:
    """Mesh rank ``index``'s shards of a whole tree (``sizes`` and
    ``index``: each mesh axis's size and this rank's index on it): each
    leaf cut along every sharded dim into as many contiguous chunks as
    its axes have ranks, the rank's chunk kept (an axis tuple counts
    data major, as the reference's mesh orders it); a replicated leaf
    as it is."""
    if isinstance(table, PDef):
        t = params if isinstance(params, torch.Tensor) else _to_tensor(params)
        cut = False
        for dim, sp in enumerate(spec_of(table)):
            n, i = 1, 0
            for a in entry_axes(sp):
                n, i = n * sizes[a], i * sizes[a] + index[a]
            if n > 1:
                t, cut = torch.chunk(t, n, dim=dim)[i], True
        return t.clone() if cut else t
    return {k: shard_data(params[k], v, sizes, index)
            for k, v in table.items()}


def shard_dim(d: PDef) -> Optional[int]:
    """The dim of ``d`` the model axis shards, or None (replicated)."""
    dims = [i for i, sp in enumerate(d.spec) if sp == "model"]
    return dims[0] if dims else None


def local_shape(d: PDef, tp: int) -> Tuple[int, ...]:
    """``d``'s shape on one of ``tp`` ranks."""
    i = shard_dim(d)
    if i is None or tp == 1:
        return d.shape
    if d.shape[i] % tp:
        raise ValueError(f"dim {i} of {d.shape} does not split over tp {tp}")
    return d.shape[:i] + (d.shape[i] // tp,) + d.shape[i + 1:]


def shard_params(params: Any, table: Table, tp: int, ti: int) -> Any:
    """Rank ``ti``'s local tensors of a whole parameter tree (torch
    tensors or array-likes, e.g. the reference's numpy tree): each leaf
    cut along its table entry's sharded dim into ``tp`` contiguous
    chunks, chunk ``ti`` kept (a copy); replicated leaves as they are.
    The padded query heads of the reference's ``row`` kv mode come with
    the tree, as the reference initialised them."""
    return shard_data(params, table, {"model": tp}, {"model": ti})


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


def pad_for_tp(params: Any, cfg, tp: int) -> Any:
    """A tp = 1 parameter tree (``lm.lm_table(cfg)``) as the whole tree of
    ``lm.lm_table(cfg, tp)``: the vocabulary padded to
    ``cfg.padded_vocab(tp)`` with zero rows of ``embed`` (and zero columns
    of ``lm_head``), the query heads padded to ``cfg.padded_heads(tp)``
    with zero columns of ``wq`` (and ``bq``; MLA's ``w_uk`` and ``w_uv``)
    and zero rows of ``wo``.  The padded vocab ids are masked in the
    logits and a zero head adds nothing, so a dense model is the same at
    every tp.  Expert stacks and SSM heads are not padded: their counts
    must divide by tp (``moe.moe_table``, ``ssm.ssm_dims``)."""
    vp1, vp = cfg.padded_vocab(1), cfg.padded_vocab(tp)
    extra = cfg.padded_heads(tp) - cfg.n_heads

    def pad(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        if n == 0:
            return t
        shape = list(t.shape)
        shape[dim] = n
        return torch.cat([t, t.new_zeros(shape)], dim=dim)

    out = dict(params)
    out["embed"] = pad(params["embed"], 0, vp - vp1)
    if "lm_head" in params:
        out["lm_head"] = pad(params["lm_head"], 1, vp - vp1)
    if extra and cfg.n_heads:
        attn = dict(params["blocks"]["attn"])
        m = cfg.mla
        if m is None:
            widths = dict(wq=cfg.head_dim, wo=cfg.head_dim, bq=cfg.head_dim)
        else:               # MLA: per-head columns of its projections
            widths = dict(wq=m.qk_nope_dim + m.qk_rope_dim,
                          w_uk=m.qk_nope_dim, w_uv=m.v_dim, wo=m.v_dim)
        for name, hw in widths.items():
            if name in attn:
                attn[name] = pad(attn[name], 1 if name in ("wo", "bq")
                                 else 2, extra * hw)
        out["blocks"] = dict(params["blocks"], attn=attn)
    return out


def _to_tensor(a) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":       # ml_dtypes.bfloat16, exact
        return torch.from_numpy(arr.view(np.uint16).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def from_jax_params(tree, device="cpu") -> Any:
    """The reference's parameter tree (``models/params.py:init_params``
    output, or ``core/weights.py:pack_serving_params`` output; any
    array-like leaves) as torch tensors, bit for bit.  A reference
    ``PackedWeight`` (recognised by its fields) becomes the port's, its
    uint32 plane words held as int32, with ``device``'s default weight
    backend."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if all(hasattr(tree, f) for f in ("signman", "planes", "dict_syms", "k")):
        planes = np.asarray(tree.planes)
        if planes.dtype != np.uint32:
            raise ValueError(f"packed planes must be uint32, got "
                             f"{planes.dtype}")
        return PackedWeight(_to_tensor(tree.signman),
                            _to_tensor(planes.view(np.int32)),
                            _to_tensor(tree.dict_syms), int(tree.k)
                            ).to(device)
    return _to_tensor(tree).to(device)


def to_device(params, device) -> Any:
    """A copy of a parameter tree on ``device`` (``PackedWeight.to`` for
    packed leaves)."""
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    return params.to(device)

