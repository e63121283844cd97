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

Tensor parallelism (the PartitionSpec half of the reference's
``pack_serving_params``): the reference packs each WHOLE leaf -- one
dictionary and one code width per slice, from the slice's histogram over
every shard -- and shards the packed fields like the raw leaf.  A rank
here holds only its shard, so it sums its slices' histograms with the
other ranks' (an exact integer psum), picks k and the dictionaries from
the sums, and packs its shard with them: its fields are the reference's
shard byte for byte.  A leaf sharded on a stack dim (the MoE expert
stacks) holds whole slices: each keeps its own histogram, and only the
escape test that picks the leaf's one k is summed over the ranks.  A
leaf stays raw when its tp-local column count breaks the 32-lane
alignment; the size threshold is on the whole leaf.

The training half (the reference's ``MaybeCompressed`` store): a tree
compressed at rest with the fixed-width codec, leaf by leaf
(``compress_params``), decoded exactly (``decompress_params``, through
``kernels.ops.unpack``), metered (``stored_bytes``, ``param_bytes``), and
the FSDP gather of a store sharded on dim 0, packed on the wire
(``fsdp_gather_params``).
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
# layer axis (an encoder-decoder's encoder too): one layer's slice of such
# a leaf is what its consumer sees
STACKED = ("blocks", "enc_blocks")


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


def _leaf_eligible(path: Tuple[str, ...], x,
                   shape: Optional[Tuple[int, ...]] = None) -> bool:
    """Bulk 2-D matmul operands only.  Raw stays raw when:

    - it is an embedding table (consumed by gather, not matmul),
    - it is not bf16 or is under 2-D, counted per layer for a leaf of a
      stacked subtree: a stacked norm scale or bias (L, d) is 1-D in each
      layer and is consumed by a norm or an add, not a matmul,
    - it is small (the dictionary costs more than the packing saves;
      judged on the whole leaf's ``shape``, default x's),
    - its (local) column count breaks the 32-lane bit-plane alignment, or
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
    shape = tuple(x.shape) if shape is None else tuple(shape)
    if shape[-2] * shape[-1] < MIN_COMPRESS_SIZE:
        return False
    return x.shape[-1] % LANES == 0


def _pack_leaf(x: torch.Tensor, max_k: int, tg=None,
               slices_whole: bool = False):
    """Pack one leaf on its device at the smallest escape-free code width
    k in 4..max_k, the same k for every stack slice.  Returns
    ``((signman, planes, dict_syms), k)``, or None if even max_k would need
    escapes (the leaf then stays raw).  With ``tg`` (a sharded leaf at
    tp > 1) the histograms are summed over the ranks first, so k and the
    dictionaries are the whole leaf's; with ``slices_whole`` too (sharded
    on a stack dim: the rank's slices are whole) each slice keeps its own
    histogram and only the escape counts are summed, so k is the whole
    leaf's."""
    from repro_torch.core import collectives as cl
    from repro_torch.core import fixed
    from repro_torch.kernels import ops as kops

    lead, (kk, n) = tuple(x.shape[:-2]), x.shape[-2:]
    rows = x.reshape(math.prod(lead), kk * n).contiguous()
    hist = kops.histogram(rows)                       # (L, 256), one launch
    if not slices_whole:
        hist = cl.psum(hist, tg)
    for k in range(4, max_k + 1):
        dict_syms, enc_lut = fixed.build_dictionary(hist, k)
        n_escapes = (hist * (enc_lut == fixed.esc_index(k))).sum()
        if slices_whole:
            n_escapes = cl.psum(n_escapes.reshape(1), tg)
        if bool(n_escapes.any()):
            continue
        signman, planes = kops.pack(rows, enc_lut, k)  # one launch
        return (signman.reshape(x.shape),
                planes.reshape(lead + (k, kk, n // LANES)),
                dict_syms.reshape(lead + (1 << k,))), k
    return None


def pack_serving_params(params: Any, *, k: int = WEIGHT_K,
                        backend: str = "torch", table: Any = None,
                        tg=None) -> Any:
    """Whole-model serving store: eligible leaves -> :class:`PackedWeight`
    (escape-free LEXI-FW layout at the smallest code width <= ``k``) with
    the concrete matmul ``backend``; everything else raw.  Idempotent:
    already-packed leaves keep their fields and take ``backend``.

    At tp > 1 ``params`` is a rank's shard, ``table`` its parameter table
    (``models.lm.lm_table(cfg, tp)``, whose specs say which dim each leaf
    is sharded on) and ``tg`` the rank's ``TPGroup``: every rank must call
    this together (the sharded leaves' histograms are summed over the
    group)."""
    from repro_torch.core import collectives as cl
    from repro_torch.kernels import ops as kops

    tp = cl.world(tg)

    def whole(t, d):
        """(the whole leaf's shape, the group to sum histograms over,
        whether the rank's 2-D slices are whole: sharded on a stack
        dim)."""
        if tp == 1 or d is None or "model" not in d.spec:
            return tuple(t.shape), None, False
        i = d.spec.index("model")
        return tuple(t.shape[:i]) + (t.shape[i] * tp,) \
            + tuple(t.shape[i + 1:]), tg, i < t.ndim - 2

    def walk(t, path, d):
        if isinstance(t, dict):
            return {key: walk(v, path + (key,),
                              None if d is None else d[key])
                    for key, v in t.items()}
        if isinstance(t, PackedWeight):
            kops.check_weight_backend(backend, t.device)
            return dataclasses.replace(t, backend=backend)
        shape, group, slices_whole = whole(t, d)
        packed: Optional[tuple] = (_pack_leaf(t, k, group, slices_whole)
                                   if _leaf_eligible(path, t, shape)
                                   else None)
        if packed is None:
            return t
        kops.check_weight_backend(backend, t.device)
        fields, leaf_k = packed
        return PackedWeight(*fields, k=leaf_k, backend=backend)

    if tp > 1 and table is None:
        raise ValueError("pack_serving_params at tp > 1 needs the "
                         "parameter table (which dims are sharded)")
    return walk(params, (), table)


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


# ---------------------------------------------------------------------------
# compressed-at-rest parameters (the reference's training-side store)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MaybeCompressed:
    """A leaf that is either raw or a :class:`fixed.Compressed`."""

    value: Any           # torch.Tensor | fixed.Compressed
    compressed: bool


def _should_compress(x: torch.Tensor) -> bool:
    return (x.ndim >= 1 and x.numel() >= MIN_COMPRESS_SIZE
            and x.dtype in (torch.bfloat16, torch.float32))


def compress_params(params: Any, cfg) -> Any:
    """Tree of tensors -> tree of MaybeCompressed (``cfg`` a
    ``CodecConfig``: with ``cfg.weights`` off every leaf stays raw).  An
    f32 leaf is rounded to bf16 first, as in the reference."""
    from repro_torch.core import fixed, tree

    def one(x):
        if cfg.weights and _should_compress(x):
            return MaybeCompressed(
                fixed.compress(x.to(torch.bfloat16), k=cfg.k,
                               esc_capacity=cfg.esc_capacity(x.numel())),
                True)
        return MaybeCompressed(x, False)

    return tree.map_(one, params)


def decompress_params(cparams: Any) -> Any:
    """Inverse of :func:`compress_params` (exact for the compressed leaves
    unless an escape overflowed its side channel)."""
    from repro_torch.core import tree
    from repro_torch.kernels import ops as kops

    return tree.map_(lambda leaf: kops.unpack(leaf.value)
                     if leaf.compressed else leaf.value, cparams)


def stored_bytes(cparams: Any) -> int:
    """Device bytes of the compressed store (the paper's Fig-1b metric)."""
    total = 0
    for leaf in leaves(cparams):
        if leaf.compressed:
            total += leaf.value.wire_bytes()
        else:
            total += leaf.value.numel() * leaf.value.element_size()
    return total


def param_bytes(params: Any) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(params))


def fsdp_gather_params(cparams: Any, tg) -> Any:
    """FSDP weight all-gather with the packed wire format: each rank holds
    a dim-0 shard of every leaf, compressed or raw; a compressed leaf
    crosses packed (its ``Compressed`` fields) and is decoded by the
    receiver, shard by shard, then the shards concatenated; a raw leaf is
    gathered as it is.  Every rank of ``tg`` calls this together."""
    from repro_torch.core import collectives as cl, tree

    def one(leaf: MaybeCompressed):
        if not leaf.compressed:
            return cl.all_gather(leaf.value, tg, 0)
        ct = leaf.value
        if cl.world(tg) == 1:
            return cl._decompress(ct)
        got = cl.gather_bytes(cl.pack_wire(ct), tg)
        parts = cl._decompress(cl.unpack_wire(got, ct.shape, ct.k,
                                              ct.esc_pos.shape[-1]))
        return parts.reshape((-1,) + tuple(parts.shape[2:]))

    return tree.map_(one, cparams)
