"""``CodecConfig`` and the LEXI-compressed collectives (ports
``repro/core/collectives.py``).

The paper places codecs at the ports of the chiplet links, so that
activations cross them compressed.  In the reference the "ports" are the
TPU's collectives; here they are ``torch.distributed`` collectives between
the ranks of a ``launch.mesh.TPGroup``.  Each compressed collective is

    pack (``core.fixed.compress``: the exp_histogram and lexi_pack kernels
    on the card)  ->  the collective on the packed bytes  ->  unpack
    (``kernels.ops.unpack``: the lexi_unpack kernel, then the escape side
    channel)

and moves ``Compressed.wire_bytes()`` bytes per part, the bytes of the
reference's ``fixed.compress`` of the same tensor.  With
``CodecConfig.enabled=False`` each is the plain collective.  As in the
reference the round trip is exact unless an escape overflows its side
channel, where both lose the same values (the overflowing escapes decode
with exponent 0).

The plain helpers the model needs (``psum``, ``pmax``, ``pmin``,
``all_gather``, ``all_to_all``, ``psum_scatter``, ``ppermute``) take the
group too; at world 1 (``tg`` None or one rank) every one is the
identity.  Data moves as raw bytes, so a gather or an all-to-all is exact
for every dtype, and every sum is taken locally after the exchange, in
rank order with an f32 accumulator, rounded once to the input's dtype --
what XLA's CPU ``psum`` / ``psum_scatter`` do on the reference's mesh --
so every rank holds the same bits and they are the reference's.  Over a
gloo group a CUDA tensor is copied to the host and back around the
exchange (gloo takes CPU tensors only for gather and all-to-all); NCCL
moves it in place.  Several tensors may share one exchange
(``gather_many``).

The plain ``psum``, ``all_gather``, ``psum_scatter`` and ``all_to_all``
are differentiable with JAX's transposes (a psum's backward a psum, an
all-gather's a reduce-scatter and back, an all-to-all's its swap), as
the reference's ``jax.lax`` collectives are; the sequence-parallel
blocks and the vocab-sharded loss train through them.

The differentiable wrappers (``lexi_all_gather``, ``lexi_psum``,
``lexi_all_to_all``, ``lexi_ppermute``) are ``torch.autograd.Function``s
with the reference's custom VJPs: the all-gather's backward is a raw
reduce-scatter (it sums), the psum's a compressed psum, the all-to-all's
a compressed all-to-all with split and concat swapped, the ppermute's a
compressed ppermute over the inverse permutation.  ``sync_gradients`` is
the reference's fused data-parallel gradient mean.

``CodecConfig``'s class name, field order and defaults match the JAX
package's, so ``repr(CodecConfig())`` is the same string in both
packages; only the backend vocabulary differs, as documented per field.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import torch

from . import fixed, tree
from .fixed import DEFAULT_ESC_FRAC, DEFAULT_K


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Where/how LEXI applies in a model run (first-class config knob)."""

    enabled: bool = True                # master switch (activations/ICI)
    weights: bool = True                # compressed-at-rest params (+FSDP AG)
    cache: bool = True                  # block-compressed hybrid caches
    grads: bool = True                  # compressed AG half of grad sync
    k: int = DEFAULT_K                  # dictionary index width (bits)
    esc_frac: int = DEFAULT_ESC_FRAC    # escape capacity = N // esc_frac
    cache_block: int = 256              # tokens per compressed KV block
    # decode-attention backend: auto | cuda | torch (see
    # repro_torch.kernels.ops.resolve_decode_backend).  auto = the CUDA
    # kernel for CUDA tensors, the plain PyTorch version for CPU tensors.
    decode_backend: str = "auto"
    # serving weight-matmul backend: auto | cuda | unpack | torch (see
    # repro_torch.kernels.ops.resolve_weight_backend).  How PackedWeight
    # leaves are multiplied: auto = the fused decompress_matmul kernel for
    # CUDA tensors, the plain version for CPU tensors; unpack = the
    # lexi_unpack kernel, then the raw weights' product.
    weight_backend: str = "auto"

    def esc_capacity(self, n: int) -> int:
        return max(n // self.esc_frac, 8)

    @classmethod
    def off(cls) -> "CodecConfig":
        return cls(enabled=False, weights=False, cache=False, grads=False)

    @classmethod
    def weights_only(cls) -> "CodecConfig":
        """Paper Table 3 middle row: offline-compressed weights only."""
        return cls(enabled=False, weights=True, cache=False, grads=False)


DEFAULT_CODEC = CodecConfig()


# ---------------------------------------------------------------------------
# wire accounting: what the compressed collectives moved (this rank's parts)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WireStats:
    """Bytes this rank put on the wire in compressed collectives since the
    last reset, beside the raw bytes of the same tensors, and the parts
    whose escapes overflowed their side channel (lossy, as in the
    reference)."""
    calls: int = 0
    wire_bytes: int = 0
    raw_bytes: int = 0
    parts: int = 0
    overflows: int = 0
    # a list: the packed bytes (numpy (parts, wire_bytes)) of every call
    # are appended to it (tests hold them against the reference's)
    keep: Optional[list] = None
    # the same counts by the kind of call ("all_gather", "ppermute", or
    # the call's ``kind``: the MoE all-to-all's "dispatch" and "return",
    # an encoder-decoder's "encoder", "memory" and "cross" gathers, the
    # trainer's "fsdp" weight gathers, "loss" gathers and "grads" sync):
    # kind -> {"calls", "wire_bytes", "raw_bytes", "parts", "overflows"}
    kinds: dict = dataclasses.field(default_factory=dict)

    def reset(self) -> None:
        self.calls = self.wire_bytes = self.raw_bytes = 0
        self.parts = self.overflows = 0
        self.kinds = {}

    def snapshot(self) -> dict:
        """The counts as a dict that later calls leave as it is."""
        return dict(self.__dict__,
                    kinds={k: dict(v) for k, v in self.kinds.items()})


wire = WireStats()


def world(tg) -> int:
    return 1 if tg is None else tg.world


def rank(tg) -> int:
    return 0 if tg is None else tg.rank


# ---------------------------------------------------------------------------
# byte exchanges
# ---------------------------------------------------------------------------

def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(b: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    return b.contiguous().view(dtype).reshape(shape)


def _staged(tg, t: torch.Tensor) -> bool:
    return tg.backend == "gloo" and t.device.type == "cuda"


def gather_bytes(b: torch.Tensor, tg) -> torch.Tensor:
    """(n,) uint8 from every rank -> (world, n) in rank order."""
    n = b.numel()
    out = torch.empty((tg.world * n,), dtype=torch.uint8,
                      device="cpu" if _staged(tg, b) else b.device)
    src = b.cpu() if _staged(tg, b) else b.contiguous()
    torch.distributed.all_gather(list(out.chunk(tg.world)), src,
                                 group=tg.pg)
    return out.to(b.device).reshape(tg.world, n)


def exchange_bytes(chunks: torch.Tensor, tg) -> torch.Tensor:
    """All-to-all of byte chunks: ``chunks`` (world, n) uint8, row j for
    rank j -> (world, n), row r from rank r."""
    staged = _staged(tg, chunks)
    src = chunks.cpu() if staged else chunks.contiguous()
    out = torch.empty_like(src)
    torch.distributed.all_to_all_single(out.reshape(-1), src.reshape(-1),
                                        group=tg.pg)
    return out.to(chunks.device)


def gather_parts(x: torch.Tensor, tg) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order: (world, *x.shape)."""
    return _from_bytes(gather_bytes(_as_bytes(x), tg), x.dtype,
                       (tg.world,) + tuple(x.shape))


def gather_many(xs: Sequence[torch.Tensor], tg) -> List[torch.Tensor]:
    """``gather_parts`` of several tensors (one device, any dtypes and
    shapes) in ONE exchange: their bytes back to back."""
    sizes = [x.numel() * x.element_size() for x in xs]
    got = gather_bytes(torch.cat([_as_bytes(x) for x in xs]), tg)
    out, off = [], 0
    for x, nb in zip(xs, sizes):
        out.append(_from_bytes(got[:, off:off + nb], x.dtype,
                               (tg.world,) + tuple(x.shape)))
        off += nb
    return out


def exchange_parts(parts: torch.Tensor, tg) -> torch.Tensor:
    """``parts`` (world, ...), part j for rank j -> (world, ...), part r
    from rank r."""
    w = parts.shape[0]
    got = exchange_bytes(parts.contiguous().view(torch.uint8)
                         .reshape(w, -1), tg)
    return _from_bytes(got, parts.dtype, parts.shape)


def host_max(v: int, tg) -> int:
    """The largest of every rank's host int (all ranks get it)."""
    if world(tg) == 1:
        return int(v)
    dev = "cpu" if tg.backend == "gloo" else tg.device
    return int(gather_parts(torch.tensor([int(v)], dtype=torch.int64,
                                         device=dev), tg).max())


def gather_objects(obj, tg) -> list:
    """Every rank's picklable ``obj``, in rank order."""
    if world(tg) == 1:
        return [obj]
    out = [None] * tg.world
    torch.distributed.all_gather_object(out, obj, group=tg.pg)
    return out


def broadcast_object(obj, tg, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank (the others pass
    anything, e.g. None)."""
    if world(tg) == 1:
        return obj
    box = [obj]
    torch.distributed.broadcast_object_list(box, src=tg.global_rank(src),
                                            group=tg.pg)
    return box[0]


# ---------------------------------------------------------------------------
# plain collectives
# ---------------------------------------------------------------------------

def sum_parts(parts: torch.Tensor) -> torch.Tensor:
    """Gathered parts (world, ...) summed as ``psum`` sums them: in rank
    order with an f32 accumulator (f64 for f64; integers exactly),
    rounded once to their dtype."""
    acc_t = torch.float64 if parts.dtype == torch.float64 else torch.float32
    if not parts.dtype.is_floating_point:
        acc_t = parts.dtype
    acc = parts[0].to(acc_t)
    for p in parts[1:]:
        acc = acc + p.to(acc_t)
    return acc.to(parts.dtype)


def _tracked(x: torch.Tensor) -> bool:
    """Whether autograd records an op on ``x`` here."""
    return x.requires_grad and torch.is_grad_enabled()


def psum(x: torch.Tensor, tg) -> torch.Tensor:
    """Sum over the group, replicated on every rank.  Differentiable, with
    JAX's rule: the backward is a psum of the cotangent (every rank's
    loss reads the sum that every rank holds whole)."""
    if world(tg) == 1:
        return x
    if _tracked(x):
        return _PsumAD.apply(x, tg)
    return sum_parts(gather_parts(x, tg))


def pmax(x: torch.Tensor, tg) -> torch.Tensor:
    if world(tg) == 1:
        return x
    return gather_parts(x, tg).max(0).values


def pmin(x: torch.Tensor, tg) -> torch.Tensor:
    if world(tg) == 1:
        return x
    return gather_parts(x, tg).min(0).values


def all_gather(x: torch.Tensor, tg, axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """``jax.lax.all_gather``: the ranks' shards concatenated along
    ``axis`` (tiled) or stacked on a new axis there (untiled).
    Differentiable: the backward reduce-scatters the cotangent."""
    if world(tg) == 1:
        return x if tiled else x.unsqueeze(axis)
    if _tracked(x):
        return _AllGatherAD.apply(x, tg, axis, tiled)
    parts = gather_parts(x, tg)
    return _fold(parts, axis, tiled, x.ndim)


def fold_parts(parts: torch.Tensor, axis: int) -> torch.Tensor:
    """Gathered parts (world, ...) concatenated along ``axis`` of a part
    (the tiled ``all_gather`` of ``gather_many``'s output)."""
    return _fold(parts, axis, True, parts.ndim - 1)


def _fold(parts: torch.Tensor, axis: int, tiled: bool,
          ndim: int) -> torch.Tensor:
    """(world, *shape) -> the gathered tensor (the reference's moveaxis +
    reshape)."""
    if not tiled:
        return torch.movedim(parts, 0, axis % (ndim + 1))
    axis = axis % ndim
    moved = torch.movedim(parts, 0, axis)
    shape = list(parts.shape[1:])
    shape[axis] *= parts.shape[0]
    return moved.reshape(shape)


def psum_scatter(x: torch.Tensor, tg, axis: int) -> torch.Tensor:
    """``jax.lax.psum_scatter(..., tiled=True)``: the sum over the group,
    rank r keeping chunk r of ``axis``.  Differentiable: the backward is
    a raw tiled all-gather of the cotangent."""
    n = world(tg)
    if n == 1:
        return x
    if _tracked(x):
        return _PsumScatterAD.apply(x, tg, axis)
    chunks = torch.stack(torch.chunk(x, n, dim=axis))
    return sum_parts(exchange_parts(chunks, tg))


def all_to_all(x: torch.Tensor, tg, split_axis: int, concat_axis: int
               ) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: ``split_axis`` cut into
    world chunks, chunk j to rank j; the chunks received concatenated
    along ``concat_axis`` in rank order.  Differentiable: its own
    transpose with the two axes swapped."""
    n = world(tg)
    if n == 1:
        return x
    if _tracked(x):
        return _AllToAllAD.apply(x, tg, split_axis, concat_axis)
    got = exchange_parts(torch.stack(torch.chunk(x, n, dim=split_axis)), tg)
    return torch.cat(list(got), dim=concat_axis)


def ppermute(x: torch.Tensor, tg, perm: Sequence[Tuple[int, int]]
             ) -> torch.Tensor:
    """``jax.lax.ppermute``: rank d gets the x of the rank s with (s, d)
    in ``perm``; a rank that no pair names gets zeros."""
    if world(tg) == 1:
        return x if (0, 0) in perm else torch.zeros_like(x)
    src = _source(perm, tg.rank)
    parts = gather_parts(x, tg)
    return torch.zeros_like(x) if src is None else parts[src]


def _source(perm, me: int) -> Optional[int]:
    srcs = [s for s, d in perm if d == me]
    return srcs[0] if srcs else None


# ---------------------------------------------------------------------------
# the packed wire format of one Compressed part
# ---------------------------------------------------------------------------

_WIRE_FIELDS = ("signman", "planes", "dict_syms", "esc_pos", "esc_raw",
                "n_escapes")


def pack_wire(ct: fixed.Compressed) -> torch.Tensor:
    """A ``Compressed`` (with leading batch axes ``lead``) as bytes (*lead,
    wire_bytes): signman, the plane words, the dictionary, the escape
    positions and raw exponents, the escape count -- the reference's
    ``Compressed`` fields back to back."""
    lead = tuple(ct.signman.shape[:-1])
    g = math.prod(lead)
    parts = [getattr(ct, f).contiguous().reshape(g, -1).view(torch.uint8)
             for f in _WIRE_FIELDS]
    return torch.cat(parts, dim=1).reshape(lead + (-1,))


def unpack_wire(b: torch.Tensor, shape: Tuple[int, ...], k: int,
                c: int) -> fixed.Compressed:
    """Inverse of :func:`pack_wire` for parts of ``shape`` with escape
    capacity ``c``: b (*lead, wire_bytes) -> ``Compressed`` with leading
    axes ``lead``."""
    from . import packing

    n = math.prod(shape)
    nw = packing.pad_to_lanes(n) // 32
    lead = tuple(b.shape[:-1])
    spec = (("signman", torch.uint8, (n,)),
            ("planes", torch.int32, (k, nw)),
            ("dict_syms", torch.uint8, (1 << k,)),
            ("esc_pos", torch.int32, (c,)),
            ("esc_raw", torch.uint8, (c,)),
            ("n_escapes", torch.int32, ()))
    flat = b.reshape(-1, b.shape[-1])
    out, off = {}, 0
    for name, dt, shp in spec:
        nb = math.prod(shp) * torch.tensor([], dtype=dt).element_size()
        out[name] = flat[:, off:off + nb].contiguous().view(dt) \
            .reshape(lead + shp)
        off += nb
    if off != b.shape[-1]:
        raise ValueError(f"wire buffer of {b.shape[-1]} bytes does not hold "
                         f"a part of {shape} (k {k}, C {c}: {off} bytes)")
    return fixed.Compressed(**out, shape=tuple(shape), k=k)


def _compress(x: torch.Tensor, cfg: CodecConfig) -> fixed.Compressed:
    return fixed.compress(x, k=cfg.k, esc_capacity=cfg.esc_capacity(
        x.numel()))


def _count(ct: fixed.Compressed, raw_bytes: int, parts: int,
           packed: torch.Tensor, kind: str) -> None:
    if wire.keep is not None:
        wire.keep.append(packed.reshape(parts, -1).cpu().numpy())
    add = dict(calls=1, parts=parts, wire_bytes=packed.numel(),
               raw_bytes=raw_bytes,
               overflows=int((ct.n_escapes > ct.esc_pos.shape[-1]).sum()))
    for f, v in add.items():
        setattr(wire, f, getattr(wire, f) + v)
    counts = wire.kinds.setdefault(kind, dict.fromkeys(add, 0))
    for f, v in add.items():
        counts[f] += v


def _decompress(ct: fixed.Compressed) -> torch.Tensor:
    from repro_torch.kernels import ops
    return ops.unpack(ct)


# ---------------------------------------------------------------------------
# compressed collectives
# ---------------------------------------------------------------------------

def compressed_all_gather(x: torch.Tensor, tg, cfg: CodecConfig = DEFAULT_CODEC,
                          *, gather_axis: int = 0, tiled: bool = True,
                          groups: int = 1,
                          kind: str = "all_gather") -> torch.Tensor:
    """all_gather with LEXI-FW packing on the wire: ``x`` (bf16) is this
    rank's shard; the result concatenates all shards along ``gather_axis``
    (tiled) or stacks a new axis there (untiled).  ``groups`` > 1: x's
    leading axis holds that many groups, each compressed on its own, with
    its own dictionary and escape capacity (the reference's gather under
    ``vmap``, as its per-sequence admission prefills run it).  ``kind``
    labels its bytes in ``wire.kinds`` (an encoder-decoder's gathers:
    ``encoder``, ``memory``, ``cross``)."""
    if not cfg.enabled or world(tg) == 1:
        return all_gather(x, tg, gather_axis, tiled)
    xs = x.reshape((groups, -1))
    ct = fixed.compress_many(xs, k=cfg.k,
                             esc_capacity=cfg.esc_capacity(xs.shape[1]))
    packed = pack_wire(ct)
    _count(ct, x.numel() * x.element_size(), groups, packed, kind)
    got = gather_bytes(packed.reshape(-1), tg).reshape(
        (tg.world, groups, -1))
    parts = _decompress(unpack_wire(got, (xs.shape[1],), ct.k,
                                    ct.esc_pos.shape[-1]))
    return _fold(parts.reshape((tg.world,) + tuple(x.shape)), gather_axis,
                 tiled, x.ndim)


def compressed_psum(x: torch.Tensor, tg, cfg: CodecConfig = DEFAULT_CODEC, *,
                    scatter_axis: Optional[int] = None,
                    kind: str = "all_gather") -> torch.Tensor:
    """Allreduce as a raw reduce-scatter (it sums) and a LEXI-compressed
    all-gather (its bytes labelled ``kind``).  ``scatter_axis`` must
    divide by the group size; by default the first axis that does; with
    none, a plain psum."""
    if not cfg.enabled or world(tg) == 1:
        return psum(x, tg)
    n = tg.world
    if scatter_axis is None:
        scatter_axis = next((i for i, d in enumerate(x.shape) if d % n == 0),
                            None)
        if scatter_axis is None:
            return psum(x, tg)
    part = psum_scatter(x, tg, scatter_axis)
    return compressed_all_gather(part, tg, cfg, gather_axis=scatter_axis,
                                 kind=kind)


def compressed_all_to_all(x: torch.Tensor, tg,
                          cfg: CodecConfig = DEFAULT_CODEC, *,
                          split_axis: int = 0, concat_axis: int = 0,
                          groups: int = 1,
                          kind: str = "all_to_all") -> torch.Tensor:
    """all_to_all with per-destination packing: ``split_axis`` (divisible
    by the group size) cut into world slices, each compressed with its own
    dictionary, shuffled packed and decompressed at the receiver; the
    received slices take the split axis's place, which then moves to
    ``concat_axis`` (the reference's layout).  ``groups`` > 1: x's
    leading axis holds that many groups (the axes above count it), each
    exchanged with its own dictionaries and escape capacity (the
    reference's all-to-all under ``vmap``, as its per-sequence admission
    prefills run it); all groups cross in one exchange.  ``kind`` labels
    its bytes in ``wire.kinds``."""
    n = world(tg)
    if not cfg.enabled or n == 1:
        return all_to_all(x, tg, split_axis, concat_axis)
    xg = x if groups > 1 else x[None]
    sa = split_axis % x.ndim + (0 if groups > 1 else 1)
    xm = torch.movedim(xg, sa, 1)                   # (G, lead, ...)
    g, lead, rest = xm.shape[0], xm.shape[1], tuple(xm.shape[2:])
    xs = xm.reshape((g, n, lead // n) + rest).transpose(0, 1) \
        .reshape(n * g, -1)                         # rank-major parts
    ct = fixed.compress_many(xs, k=cfg.k,
                             esc_capacity=cfg.esc_capacity(xs.shape[1]))
    packed = pack_wire(ct)
    _count(ct, x.numel() * x.element_size(), n * g, packed, kind)
    got = exchange_bytes(packed.reshape(n, -1), tg)
    parts = _decompress(unpack_wire(got.reshape(n * g, -1), (xs.shape[1],),
                                    ct.k, ct.esc_pos.shape[-1]))
    parts = parts.reshape((n, g, lead // n) + rest).transpose(0, 1) \
        .reshape((g, lead) + rest)
    parts = torch.movedim(parts, 1, sa)
    if groups == 1:
        parts = parts[0]
    if concat_axis != split_axis:
        parts = torch.movedim(parts, split_axis, concat_axis)
    return parts


def compressed_ppermute(x: torch.Tensor, tg,
                        perm: Sequence[Tuple[int, int]],
                        cfg: CodecConfig = DEFAULT_CODEC) -> torch.Tensor:
    """collective_permute with LEXI packing; a rank that no pair names
    gets zeros (the decode of all-zero fields)."""
    if not cfg.enabled or world(tg) == 1:
        return ppermute(x, tg, perm)
    ct = _compress(x, cfg)
    packed = pack_wire(ct)
    _count(ct, x.numel() * x.element_size(), 1, packed, "ppermute")
    got = gather_bytes(packed, tg)
    src = _source(perm, tg.rank)
    if src is None:
        return torch.zeros_like(x)
    return _decompress(unpack_wire(got[src], tuple(x.shape), ct.k,
                                   ct.esc_pos.shape[-1]))


# ---------------------------------------------------------------------------
# data-parallel gradient sync (fused)
# ---------------------------------------------------------------------------

def sync_gradients(grads: Any, tg, cfg: CodecConfig = DEFAULT_CODEC) -> Any:
    """Data-parallel gradient mean of a nested dict of tensors over the
    group: the leaves flattened (JAX's order) into one bf16 buffer, padded
    to the group size, summed with the compressed RS + AG schedule (a
    plain psum with ``cfg.grads`` or ``cfg.enabled`` off), divided by the
    group size (in f32, rounded to bf16, as XLA divides a bf16 array) and
    cut back into the leaves, each in its own dtype."""
    leaves = tree.leaves(grads)
    flat = torch.cat([leaf.reshape(-1).to(torch.bfloat16)
                      for leaf in leaves])
    n = world(tg)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad,))])
    if cfg.enabled and cfg.grads:
        total = compressed_psum(flat, tg, cfg)
    else:
        total = psum(flat, tg)
    total = (total.float() / n).to(torch.bfloat16)
    out, off = [], 0
    for leaf in leaves:
        out.append(total[off:off + leaf.numel()].reshape(leaf.shape)
                   .to(leaf.dtype))
        off += leaf.numel()
    return tree.unflatten(grads, out)


# ---------------------------------------------------------------------------
# the plain collectives' autograd rules (JAX's transposes)
# ---------------------------------------------------------------------------

class _PsumAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tg):
        ctx.tg = tg
        return psum(x, tg)

    @staticmethod
    def backward(ctx, ct):
        return psum(ct.contiguous(), ctx.tg), None


class _AllGatherAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tg, axis, tiled):
        ctx.args = (tg, axis, tiled, x.ndim)
        return all_gather(x, tg, axis, tiled)

    @staticmethod
    def backward(ctx, ct):
        tg, axis, tiled, ndim = ctx.args
        if tiled:
            return psum_scatter(ct.contiguous(), tg, axis), None, None, None
        axis = axis % (ndim + 1)
        return psum_scatter(ct.contiguous(), tg, axis).squeeze(axis), \
            None, None, None


class _PsumScatterAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tg, axis):
        ctx.tg, ctx.axis = tg, axis
        return psum_scatter(x, tg, axis)

    @staticmethod
    def backward(ctx, ct):
        return all_gather(ct.contiguous(), ctx.tg, ctx.axis), None, None


class _AllToAllAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tg, split_axis, concat_axis):
        ctx.args = (tg, split_axis, concat_axis)
        return all_to_all(x, tg, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, ct):
        tg, split_axis, concat_axis = ctx.args
        return all_to_all(ct.contiguous(), tg, concat_axis, split_axis), \
            None, None, None


# ---------------------------------------------------------------------------
# differentiable wrappers (the reference's custom VJPs)
# ---------------------------------------------------------------------------

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tg, cfg, gather_axis, groups, kind):
        ctx.tg, ctx.axis = tg, gather_axis
        return compressed_all_gather(x, tg, cfg, gather_axis=gather_axis,
                                     groups=groups, kind=kind)

    @staticmethod
    def backward(ctx, ct):
        # transpose of a tiled all-gather = psum_scatter; it sums: raw
        return psum_scatter(ct.contiguous(), ctx.tg, ctx.axis), None, None, \
            None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tg, cfg):
        ctx.tg, ctx.cfg = tg, cfg
        return compressed_psum(x, tg, cfg)

    @staticmethod
    def backward(ctx, ct):
        # transpose(psum) = psum: the same compressed RS + AG schedule
        return compressed_psum(ct.contiguous(), ctx.tg, ctx.cfg), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tg, cfg, split_axis, concat_axis):
        ctx.args = (tg, cfg, split_axis, concat_axis)
        return compressed_all_to_all(x, tg, cfg, split_axis=split_axis,
                                     concat_axis=concat_axis)

    @staticmethod
    def backward(ctx, ct):
        tg, cfg, split_axis, concat_axis = ctx.args
        # its own transpose with split and concat swapped, compressed too
        return lexi_all_to_all(ct.contiguous(), tg, cfg, concat_axis,
                               split_axis), None, None, None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tg, perm, cfg):
        ctx.args = (tg, perm, cfg)
        return compressed_ppermute(x, tg, perm, cfg)

    @staticmethod
    def backward(ctx, ct):
        tg, perm, cfg = ctx.args
        inv = tuple((d, s) for (s, d) in perm)
        return lexi_ppermute(ct.contiguous(), tg, inv, cfg), None, None, None


def lexi_all_gather(x: torch.Tensor, tg, cfg: CodecConfig = DEFAULT_CODEC,
                    gather_axis: int = 0, groups: int = 1,
                    kind: str = "all_gather") -> torch.Tensor:
    """Differentiable compressed all-gather (tiled along ``gather_axis``;
    ``groups`` and ``kind`` as ``compressed_all_gather`` takes them); its
    backward reduce-scatters the cotangent raw."""
    return _AllGather.apply(x, tg, cfg, gather_axis, groups, kind)


def lexi_psum(x: torch.Tensor, tg,
              cfg: CodecConfig = DEFAULT_CODEC) -> torch.Tensor:
    """Differentiable psum whose all-gather half is compressed (see
    :func:`compressed_psum`); its backward is the same psum."""
    return _Psum.apply(x, tg, cfg)


def lexi_all_to_all(x: torch.Tensor, tg, cfg: CodecConfig = DEFAULT_CODEC,
                    split_axis: int = 0,
                    concat_axis: int = 0) -> torch.Tensor:
    """Differentiable compressed all-to-all (MoE dispatch and return)."""
    return _AllToAll.apply(x, tg, cfg, split_axis, concat_axis)


def lexi_ppermute(x: torch.Tensor, tg, perm: Sequence[Tuple[int, int]],
                  cfg: CodecConfig = DEFAULT_CODEC) -> torch.Tensor:
    """Differentiable compressed collective permute (pipeline forwarding);
    its backward permutes the cotangent back."""
    return _Ppermute.apply(x, tg, tuple(tuple(p) for p in perm), cfg)
