"""Serving weight plane: whole-model weights packed at rest in the LEXI-FW
layout and decompressed just in time near compute (ports the serving half
of ``repro/core/weights.py``).

Bulk 2-D matmul weights become :class:`PackedWeight` leaves; every matmul
against one goes through ``kernels.ops.matmul_packed`` on the backend baked
in at pack time: the fused ``decompress_matmul`` kernel (``cuda``), the
``lexi_unpack`` kernel and then the raw weights' product (``unpack``), or
the plain version on the CPU (``torch``).  The store is escape-free by
construction: a leaf packs at the smallest k in 4..max_k at which no slice
needs the ESCAPE code, else it stays raw.

Packing runs on the leaf's device, a whole stacked leaf at a time: its
(L, K, N) slices are L rows of K*N elements (with N % 32 == 0 a row of the
codec's flat word layout is exactly the (k, K, N/32) plane layout of one
slice), so one ``ops.histogram`` and one ``ops.pack`` encode the leaf,
each slice with its own dictionary.  Escapes are counted from the
histograms and the encode LUTs, with no pass over the elements.

Left out until training is ported: ``compress_params``,
``fsdp_gather_params`` and ``MaybeCompressed``; and the PartitionSpec half
of ``pack_serving_params`` (one GPU holds every parameter).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

MIN_COMPRESS_SIZE = 1 << 12   # leaves below 4096 elements stay raw
WEIGHT_K = 6                  # largest exponent-code width tried
LANES = 32                    # bit-plane word width (columns per word)
# top-level subtrees of ``models.lm.lm_table`` whose leaves carry a leading
# layer axis: one layer's slice of such a leaf is what its consumer sees
STACKED = ("blocks",)


@dataclasses.dataclass
class PackedWeight:
    """A bulk 2-D (or stacked 2-D) weight leaf in LEXI-FW packed form.

      signman   (..., K, N)       uint8  sign<<7 | mantissa
      planes    (..., k, K, N/32) int32  bit-planes of k-bit exponent
                                         codes (uint32 words, bit for bit)
      dict_syms (..., 2^k)        uint8  per-slice exponent dictionary

    ``k`` and the concrete matmul ``backend`` (cuda | unpack | torch) are
    fixed at pack time.  Indexing slices the leading stack dims of all
    three fields (``models.lm.layer_params``)."""

    signman: torch.Tensor
    planes: torch.Tensor
    dict_syms: torch.Tensor
    k: int = WEIGHT_K
    backend: str = "torch"

    @property
    def shape(self) -> Tuple[int, ...]:   # logical (unpacked) weight shape
        return tuple(self.signman.shape)

    @property
    def ndim(self) -> int:
        return self.signman.ndim

    @property
    def device(self) -> torch.device:
        return self.signman.device

    def __getitem__(self, idx) -> "PackedWeight":
        if self.ndim <= 2:
            raise IndexError("a 2-D packed weight has no stack dims")
        return dataclasses.replace(self, signman=self.signman[idx],
                                   planes=self.planes[idx],
                                   dict_syms=self.dict_syms[idx])

    def to(self, device) -> "PackedWeight":
        """A copy on ``device``.  A backend that cannot run there becomes
        that device's default (``torch`` on the CPU, ``cuda`` on a GPU)."""
        from repro_torch.kernels import ops as kops

        dev = torch.device(device)
        be = self.backend
        if (be == "torch") != (dev.type == "cpu"):
            be = kops.resolve_weight_backend(None, dev)
        return PackedWeight(self.signman.to(dev), self.planes.to(dev),
                            self.dict_syms.to(dev), self.k, be)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.signman, self.planes, self.dict_syms))


def unpack_weight(pw: PackedWeight) -> torch.Tensor:
    """Exact decode of a packed leaf back to bf16, all stack slices in one
    ``ops.unpack_rows`` (the ``lexi_unpack`` kernel on a GPU)."""
    from repro_torch.kernels import ops as kops

    lead, (kk, n) = pw.shape[:-2], pw.shape[-2:]
    g = math.prod(lead)
    rows = kops.unpack_rows(pw.signman.reshape(g, kk * n),
                            pw.planes.reshape(g, pw.k, kk * n // LANES),
                            pw.dict_syms.reshape(g, -1), pw.k)
    return rows.reshape(pw.shape)


def _leaf_eligible(path: Tuple[str, ...], x) -> bool:
    """Bulk 2-D matmul operands only.  Raw stays raw when:

    - it is an embedding table (consumed by gather, not matmul),
    - it is not bf16 or is under 2-D, counted per layer for a leaf of a
      stacked subtree: a stacked norm scale or bias (L, d) is 1-D in each
      layer and is consumed by a norm or an add, not a matmul,
    - it is small (the dictionary costs more than the packing saves),
    - its column count breaks the 32-lane bit-plane alignment, or
    - (checked at pack time) a 2-D slice needs escape symbols.

    The reference judges the whole stacked leaf, so it packs an (L, d)
    norm scale with L * d >= 4096 as one (L, d) matrix and then cannot
    serve it (ROADMAP.md, queue 3); this is the one place the port's
    choice of leaves differs."""
    if any("embed" in key for key in path):
        return False
    per_layer = x.ndim - (1 if path[:1] and path[0] in STACKED else 0)
    if x.dtype != torch.bfloat16 or x.ndim < 2 or per_layer < 2:
        return False
    if x.shape[-2] * x.shape[-1] < MIN_COMPRESS_SIZE:
        return False
    return x.shape[-1] % LANES == 0


def _pack_leaf(x: torch.Tensor, max_k: int):
    """Pack one leaf on its device at the smallest escape-free code width
    k in 4..max_k, the same k for every stack slice.  Returns
    ``((signman, planes, dict_syms), k)``, or None if even max_k would need
    escapes (the leaf then stays raw)."""
    from repro_torch.core import fixed
    from repro_torch.kernels import ops as kops

    lead, (kk, n) = tuple(x.shape[:-2]), x.shape[-2:]
    rows = x.reshape(math.prod(lead), kk * n).contiguous()
    hist = kops.histogram(rows)                       # (L, 256), one launch
    for k in range(4, max_k + 1):
        dict_syms, enc_lut = fixed.build_dictionary(hist, k)
        n_escapes = (hist * (enc_lut == fixed.esc_index(k))).sum(-1)
        if bool(n_escapes.any()):
            continue
        signman, planes = kops.pack(rows, enc_lut, k)  # one launch
        return (signman.reshape(x.shape),
                planes.reshape(lead + (k, kk, n // LANES)),
                dict_syms.reshape(lead + (1 << k,))), k
    return None


def pack_serving_params(params: Any, *, k: int = WEIGHT_K,
                        backend: str = "torch") -> Any:
    """Whole-model serving store: eligible leaves -> :class:`PackedWeight`
    (escape-free LEXI-FW layout at the smallest code width <= ``k``) with
    the concrete matmul ``backend``; everything else raw.  Idempotent:
    already-packed leaves keep their fields and take ``backend``."""
    from repro_torch.kernels import ops as kops

    def walk(t, path):
        if isinstance(t, dict):
            return {key: walk(v, path + (key,)) for key, v in t.items()}
        if isinstance(t, PackedWeight):
            kops.check_weight_backend(backend, t.device)
            return dataclasses.replace(t, backend=backend)
        packed: Optional[tuple] = (_pack_leaf(t, k)
                                   if _leaf_eligible(path, t) else None)
        if packed is None:
            return t
        kops.check_weight_backend(backend, t.device)
        fields, leaf_k = packed
        return PackedWeight(*fields, k=leaf_k, backend=backend)

    return walk(params, ())


def leaves(params: Any):
    """The tensor and PackedWeight leaves of a parameter tree, in order."""
    if isinstance(params, dict):
        for v in params.values():
            yield from leaves(v)
    else:
        yield params


def weight_plane_bytes(params: Any) -> Tuple[int, int]:
    """(stored, raw_bf16) device bytes of the serving weight store, the way
    the reference meters them: ``stored`` counts the packed fields of
    PackedWeight leaves and the full bytes of raw ones; ``raw_bf16`` is the
    same store with every leaf unpacked."""
    stored = raw = 0
    for leaf in leaves(params):
        if isinstance(leaf, PackedWeight):
            stored += leaf.nbytes()
            raw += leaf.signman.numel() * 2
        else:
            stored += leaf.numel() * leaf.element_size()
            raw += leaf.numel() * leaf.element_size()
    return stored, raw
