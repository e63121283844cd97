"""LEXI-compressed KV caches (ports ``repro/models/cache.py``).

Two stores, as in the reference:

* ``KVBlocks`` — a block store of B sequences.  Every full block of
  ``cache_block`` positions is LEXI-FW-compressed, and a bf16 ring per
  sequence holds the partial tail.  Sequences are compressed in groups of
  ``group``:
  - ``group = B`` is the reference's fixed-batch store (``batch_loc = B``):
    one ``Compressed`` record per block for all B sequences' (B, block, W)
    payload, under one dictionary and one escape side channel.  The
    fixed-batch decode loop appends to it (``append_token``) and attends
    over it (``attend_cache``);
  - ``group = 1`` is B single-sequence stores, each byte-identical to the
    reference's ``batch_loc = 1`` store (the reference's vmapped B = 1
    prefills): the continuous-batching scheduler copies their blocks into
    pages.
* ``PagedKV`` — the continuous-batching pool: fixed-size pages, each one
  compressed block of ONE sequence (byte-identical to a ``group = 1``
  block, so prefilled blocks copy straight in), a per-slot page table and
  per-slot rings.

Port-specific layout: ``PagedKV`` holds every layer's pool fields stacked
(L, P, ...) on the device, but ONE host-side page table and ``page_used``
bitmap for all layers.  In the reference each layer keeps its own table,
yet all layers allocate in lockstep (same flushes, same stable argsort of
``page_used``), so their tables are always equal; one host copy lets the
allocator run once per step with no device sync.  Page allocation takes
the lowest free ids in slot order (``np.argsort(used, kind="stable")``,
the reference's ``jnp.argsort``), so page ids and tables match the
reference's exactly.  The device sees the table as one persistent
tensor refreshed in place, and each step's per-slot values through one
staged buffer (``PagedKV.step``), so a decode step's device work has the
same shapes and addresses every step and replays from a CUDA graph.
Likewise the fixed-batch store's length is a host int kept by the caller
(beside a device copy that indexes the ring), so flushes are decided on
the host.

Tensor parallelism, as in the reference: the caches are sequence-sharded,
interleaved.  Rank ``ti`` of ``tp`` owns the global positions p % tp ==
ti of every sequence, at its local slot p // tp, for every kv head (the
cache payload is full width on every rank).  A rank appends only the
tokens it owns, its pages hold its slots, its page table and page use are
its own (page ids may differ between ranks), and decode attention runs
the kernels' ``tp, ti`` path over the rank's slots; the partials of the
ranks merge with one pmax and two psums (``merge_shards``, the
reference's ``layers.merge_partials``).  At tp = 1 a rank owns every
position.  An encoder-decoder's cross-attention store of the memory
(Sm rows, static after prefill) takes the same layout: shard ``ti`` holds
``local_length(Sm, tp, ti)`` rows, every kv head, attended at the
memory's length.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import collectives as cl
from repro_torch.core import fixed, packing
from repro_torch.core.collectives import CodecConfig
from repro_torch.kernels import ops as kops
from . import layers

WINDOW_NONE = kops.ref.WINDOW_NONE  # "no window" sentinel (huge i32)

_FIELDS = ("signman", "planes", "dict_syms", "esc_pos", "esc_raw")


def kv_width(cfg: ModelConfig) -> int:
    if cfg.mla is not None:
        return cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim
    return 2 * cfg.n_kv_heads * cfg.head_dim


def _page_geometry(cfg: ModelConfig, run: RunConfig, group: int = 1):
    """(blk, W, n, npad, C, k) of one compressed record: a page, or a
    block of ``group`` sequences."""
    blk, w = run.codec.cache_block, kv_width(cfg)
    n = group * blk * w
    return blk, w, n, packing.pad_to_lanes(n), run.codec.esc_capacity(n), \
        run.codec.k


def _empty_fields(lead: Tuple[int, ...], n: int, npad: int, c: int, k: int,
                  device) -> dict:
    """Zeroed compressed fields with leading axes ``lead`` (esc_pos holds
    the empty-slot sentinel, as the reference initialises it)."""
    return dict(
        signman=torch.zeros(lead + (n,), dtype=torch.uint8, device=device),
        planes=torch.zeros(lead + (k, npad // 32), dtype=torch.int32,
                           device=device),
        dict_syms=torch.zeros(lead + (1 << k,), dtype=torch.uint8,
                              device=device),
        esc_pos=torch.full(lead + (c,), npad, dtype=torch.int32,
                           device=device),
        esc_raw=torch.zeros(lead + (c,), dtype=torch.uint8, device=device))


def effective_window(spec: layers.AttnSpec, window) -> int:
    """Window size with the huge-sentinel convention: masking is always
    ``pos > L - 1 - window``."""
    if spec.windowed and window is not None:
        return int(window)
    return WINDOW_NONE


stream_mask = kops.ref.stream_mask     # the kernel's live/window mask
local_length = kops.ref.local_length   # slots a rank holds of a sequence


def local_full_pages(length: int, ti: int, blk: int, tp: int) -> int:
    """Full pages rank ``ti`` of ``tp`` holds of a sequence of ``length``
    tokens (interleaved ownership)."""
    return local_length(int(length), tp, ti) // blk


def merge_shards(out: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                 tg=None) -> torch.Tensor:
    """The ranks' unnormalised attention partials (out (..., hd) f32, m,
    l) merged and normalised -> bf16 (the reference's
    ``layers.merge_partials``: m_g = pmax m, w = e^(m - m_g), psum of
    out * w over psum of l * w; here one gather of every rank's partials,
    then the same sums in the same order on every rank)."""
    if cl.world(tg) == 1:
        return layers.merge_partials(out, l)
    outs, ms, ls = cl.gather_many((out, m, l), tg)   # one exchange
    w = torch.exp(ms - ms.max(0).values)
    num = cl.sum_parts(outs * w[..., None])
    den = cl.sum_parts(ls * w)
    return (num / den.clamp(min=1e-30)[..., None]).to(torch.bfloat16)


def gqa_head_table(cfg: ModelConfig, hq: int) -> tuple:
    """Static per-query-head kv index (pad heads clip onto the last kv
    head)."""
    g = max(cfg.n_heads // max(cfg.n_kv_heads, 1), 1)
    return tuple(int(x) for x in
                 np.clip(np.arange(hq) // g, 0, cfg.n_kv_heads - 1))


def kernel_statics(cfg: ModelConfig, run: RunConfig, q: torch.Tensor,
                   spec: layers.AttnSpec) -> dict:
    """The keyword arguments both attention kernels take for q (S,Hq,1,hd)
    (the reference's ``_kernel_statics``): an MLA payload is the latent
    that every head shares -- an empty head map, ``mla_lora`` set, the
    output lora wide (the MLA scale comes in ``spec``)."""
    mla = cfg.mla is not None
    return dict(
        k=run.codec.k,
        kv_idx=() if mla else gqa_head_table(cfg, q.shape[1]),
        scale=spec.scale if spec.scale is not None else q.shape[-1] ** -0.5,
        softcap=spec.softcap,
        mla_lora=cfg.mla.kv_lora_rank if mla else None)


# ---------------------------------------------------------------------------
# block store: fixed batch (group = B) and prefill side (group = 1)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVBlocks:
    """Block store of B = G * g sequences of one layer, compressed in G
    groups of g sequences (``group``).

    Payload width W = kv_width(cfg); a group's block value is (g, block, W),
    flat in that order.  With g = B, ``field[0]`` is the reference's
    fixed-batch field (nblk, ...).
    """
    signman: Optional[torch.Tensor]    # (G, nblk, N) u8, N = g*block*W
    planes: Optional[torch.Tensor]     # (G, nblk, k, Npad/32) int32
    dict_syms: Optional[torch.Tensor]  # (G, nblk, 2^k) u8
    esc_pos: Optional[torch.Tensor]    # (G, nblk, C) i32
    esc_raw: Optional[torch.Tensor]    # (G, nblk, C) u8
    raw_blocks: Optional[torch.Tensor] # (G, nblk, g, block, W) bf16, off
    ring: torch.Tensor                 # (B, block, W) bf16 in-flight block

    @property
    def _stored(self) -> torch.Tensor:
        return self.signman if self.signman is not None else self.raw_blocks

    @property
    def group(self) -> int:
        """Sequences per compressed record (g)."""
        return self.ring.shape[0] // self._stored.shape[0]

    @property
    def nblk(self) -> int:
        """Blocks per sequence the store holds (the ring holds one more)."""
        return self._stored.shape[1]


def n_blocks(run: RunConfig, max_len: int, tp: int = 1) -> int:
    """Capacity in blocks per sequence and rank (prefill + decode growth
    room): a rank holds max_len // tp slots."""
    return (max_len // tp) // run.codec.cache_block + 2


def empty_kv(cfg: ModelConfig, run: RunConfig, n_seqs: int, max_len: int,
             group: int = 1, device="cpu", tp: int = 1) -> KVBlocks:
    """Zeroed store of ``n_seqs`` sequences compressed in groups of
    ``group`` (``n_seqs`` for the fixed-batch store), one rank's of
    ``tp``."""
    if group < 1 or n_seqs % group:
        raise ValueError(f"group {group} does not divide {n_seqs} sequences")
    blk, w, n, npad, c, k = _page_geometry(cfg, run, group)
    nblk = n_blocks(run, max_len, tp)
    lead = (n_seqs // group, nblk)
    ring = torch.zeros((n_seqs, blk, w), dtype=torch.bfloat16, device=device)
    if run.codec.cache:
        return KVBlocks(**_empty_fields(lead, n, npad, c, k, device),
                        raw_blocks=None, ring=ring)
    return KVBlocks(signman=None, planes=None, dict_syms=None, esc_pos=None,
                    esc_raw=None,
                    raw_blocks=torch.zeros(lead + (group, blk, w),
                                           dtype=torch.bfloat16,
                                           device=device),
                    ring=ring)


def store_block(kv: KVBlocks, idx, vals: torch.Tensor,
                codec: CodecConfig) -> KVBlocks:
    """Write full blocks into block ``idx`` of the store (in place): vals
    (B, blk, W) for an int ``idx``, (B, n, blk, W) for a slice of n
    blocks.  Each group's block is compressed on its own, all in one
    batched pass."""
    g = kv.group
    v = vals if vals.dim() == 4 else vals[:, None]
    b, nb, blk, w = v.shape
    grouped = v.reshape(b // g, g, nb, blk, w).transpose(1, 2)
    if codec.cache:
        ct = fixed.compress_many(
            grouped.reshape(b // g * nb, g * blk * w), k=codec.k,
            esc_capacity=codec.esc_capacity(g * blk * w))
        for f in _FIELDS:
            dst = getattr(kv, f)
            dst[:, idx] = getattr(ct, f).reshape(dst[:, idx].shape)
    else:
        dst = kv.raw_blocks
        dst[:, idx] = grouped.to(torch.bfloat16).reshape(dst[:, idx].shape)
    return kv


def load_block(kv: KVBlocks, idx: int, codec: CodecConfig) -> torch.Tensor:
    """Block ``idx`` of every sequence, decompressed: (B, blk, W) bf16."""
    b, blk, w = kv.ring.shape
    if codec.cache:
        ct = fixed.Compressed(
            *(getattr(kv, f)[:, idx] for f in _FIELDS),
            n_escapes=torch.zeros((), dtype=torch.int32),
            shape=(kv.group, blk, w), k=codec.k)
        return fixed.decompress(ct).reshape(b, blk, w)
    return kv.raw_blocks[:, idx].reshape(b, blk, w)


def fill_from_prefill(cfg: ModelConfig, run: RunConfig, kv: KVBlocks,
                      vals: torch.Tensor) -> KVBlocks:
    """Load B prefilled sequences, vals (B, S, W) (at tp > 1 the rank's
    S/tp interleaved slots), into the block store: the full blocks
    through one ``store_block``, the partial tail into the ring (in
    place)."""
    b, s, w = vals.shape
    blk = run.codec.cache_block
    nfull = s // blk
    if nfull:
        store_block(kv, slice(0, nfull),
                    vals[:, :nfull * blk].reshape(b, nfull, blk, w),
                    run.codec)
    if s > nfull * blk:
        kv.ring[:, :s - nfull * blk] = vals[:, nfull * blk:] \
            .to(torch.bfloat16)
    return kv


def append_token(cfg: ModelConfig, run: RunConfig, kv: KVBlocks,
                 new_vals: torch.Tensor, length: int,
                 length_dev: Optional[torch.Tensor] = None, tp: int = 1,
                 ti: int = 0) -> None:
    """Append one token's K/V (B, W) of every sequence at position
    ``length`` (a host int): a ring write at ``length % blk``; when that
    fills the ring, the ring is compressed into block ``length // blk``
    (in place).  The ring row is indexed on the device, from
    ``length_dev`` (the same length as a 0-d int32 on the ring's device;
    made from ``length`` when not given), so a CUDA graph of a step that
    does not fill the ring replays at every length; the host int decides
    the flush.  As in the reference the
    ring is not cleared after a flush: rows past the length are dead by
    the live mask.  At tp > 1 only the owner of the position, rank
    ``length % tp``, writes: at its slot ``length // tp`` (a host
    decision; the tp > 1 loop runs no CUDA graph)."""
    blk = run.codec.cache_block
    if tp > 1:
        if length % tp != ti:
            return
        loc = length // tp
        kv.ring[:, loc % blk] = new_vals.to(torch.bfloat16)
        if loc % blk == blk - 1:
            store_block(kv, loc // blk, kv.ring, run.codec)
        return
    if length_dev is None:
        length_dev = torch.tensor(length, dtype=torch.int32,
                                  device=kv.ring.device)
    kv.ring.index_copy_(1, (length_dev % blk).long().reshape(1),
                        new_vals.to(torch.bfloat16)[:, None])
    if length % blk == blk - 1:
        store_block(kv, length // blk, kv.ring, run.codec)


def attend_cache(cfg: ModelConfig, run: RunConfig, kv: KVBlocks,
                 q: torch.Tensor, length, spec: layers.AttnSpec,
                 window=None, tg=None) -> torch.Tensor:
    """Fixed-batch decode attention: q (B,Hq,1,hd) over the batch-shared
    store (group = B) whose sequences hold ``length`` tokens (post-append;
    a host int, or a 0-d int32 tensor on q's device, which the kernel
    reads there).  Returns (B,Hq,1,hd_v) bf16 (hd_v = lora for MLA).

    ``kernels.ops.decode_attend`` launches the CUDA kernel on CUDA tensors
    and runs its plain version on CPU ones; ``run.codec.decode_backend`` is
    checked against q's device first.  At tp > 1 each rank attends its
    slots (the kernels' ``tp, ti`` path) and ``merge_shards`` merges."""
    b = q.shape[0]
    if kv.group != b:
        raise ValueError(f"attend_cache needs the batch-shared store "
                         f"(group {b}), got group {kv.group}")
    kops.resolve_decode_backend(run.codec, q.device)
    fields = tuple(None if f is None else f[0] for f in
                   (kv.signman, kv.planes, kv.dict_syms, kv.esc_pos,
                    kv.esc_raw, kv.raw_blocks))
    out, m, l = kops.decode_attend(
        q[:, :, 0].contiguous(), *fields, kv.ring, length,
        effective_window(spec, window), **kernel_statics(cfg, run, q, spec),
        tp=cl.world(tg), ti=cl.rank(tg))
    return merge_shards(out, m, l, tg)[:, :, None]


# ---------------------------------------------------------------------------
# paged pool (continuous batching)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PagedKV:
    """Paged KV store of all layers, one sequence per slot.

    Pages are immutable once full: written once (a prefill insert or a
    ring flush), never rewritten while ``page_used`` is set.  The mutable
    tail of a sequence is its slot's ring row.
    """
    signman: Optional[torch.Tensor]    # (L, P, N) u8, N = block*W
    planes: Optional[torch.Tensor]     # (L, P, k, Npad/32) int32
    dict_syms: Optional[torch.Tensor]  # (L, P, 2^k) u8
    esc_pos: Optional[torch.Tensor]    # (L, P, C) i32
    esc_raw: Optional[torch.Tensor]    # (L, P, C) u8
    raw_pages: Optional[torch.Tensor]  # (L, P, block, W) bf16, codec off
    ring: torch.Tensor                 # (L, S, block, W) bf16
    page_table: np.ndarray             # (S, maxp) int32, -1 = unmapped
    page_used: np.ndarray              # (P,) bool
    # device copy of page_table, unmapped entries clipped to page 0 (they
    # are dead by length); one tensor for the pool's life, refreshed in
    # place (``touch``), so a captured CUDA graph reads the current table
    ids: Optional[torch.Tensor] = None          # (S, maxp) int32
    # one decode step's per-slot values, staged by ``stage_append``:
    # rows [flat ring row s * block + length % block, active, length,
    # length + active] (``device_plan`` reads them)
    step: Optional[torch.Tensor] = None         # (4, S) int32

    def __post_init__(self):
        dev = self.ring.device
        if self.ids is None:
            self.ids = torch.from_numpy(np.maximum(self.page_table, 0)).to(dev)
        if self.step is None:
            self.step = empty_step(self.page_table.shape[0], dev)

    def page_ids(self) -> torch.Tensor:
        return self.ids

    def touch(self) -> None:
        """Refresh ``ids`` in place after a host-side change to
        ``page_table`` (one asynchronous copy from host memory)."""
        self.ids.copy_(torch.from_numpy(np.maximum(self.page_table, 0)),
                       non_blocking=True)

    def layer_fields(self, layer: int):
        """This layer's (signman, planes, dicts, esc_pos, esc_raw,
        raw_pages) views, ``None`` where the codec setting has none."""
        return tuple(None if f is None else f[layer] for f in
                     (self.signman, self.planes, self.dict_syms,
                      self.esc_pos, self.esc_raw, self.raw_pages))


def max_pages_per_slot(run: RunConfig, max_len: int, tp: int = 1) -> int:
    return (max_len // tp) // run.codec.cache_block + 2


def page_bytes(cfg: ModelConfig, run: RunConfig) -> Tuple[int, int]:
    """(stored_bytes, raw_bytes) per page and layer — the serving metric,
    from the shapes ``empty_paged_kv`` allocates."""
    if cfg.n_heads == 0:
        return 0, 0
    blk, w, n, npad, c, k = _page_geometry(cfg, run)
    raw = blk * w * 2
    if not run.codec.cache:
        return raw, raw
    return n + k * (npad // 32) * 4 + (1 << k) + c * 4 + c, raw


def empty_paged_kv(cfg: ModelConfig, run: RunConfig, n_slots: int,
                   max_len: int, n_pages: Optional[int] = None,
                   device="cpu", tp: int = 1) -> Optional[PagedKV]:
    """One rank's zeroed pool (of ``tp``): pages, rings and tables for
    ``n_slots`` sequences of up to ``max_len`` tokens.  An attention-free
    model has no KV pages at all: None (its pool holds only SSM state;
    ``page_bytes`` is (0, 0), and a step stages its lengths alone,
    ``stage_append`` with ``pkv`` None)."""
    if cfg.n_heads == 0:
        return None
    blk, w, n, npad, c, k = _page_geometry(cfg, run)
    L = cfg.n_layers
    maxp = max_pages_per_slot(run, max_len, tp)
    if n_pages is not None and n_pages < n_slots * maxp:
        raise ValueError(
            f"page pool oversubscription unsupported: n_pages={n_pages} < "
            f"n_slots*max_pages={n_slots * maxp}")
    P_ = n_pages if n_pages is not None else n_slots * maxp
    ring = torch.zeros((L, n_slots, blk, w), dtype=torch.bfloat16,
                       device=device)
    pt = np.full((n_slots, maxp), -1, np.int32)
    used = np.zeros((P_,), bool)
    if run.codec.cache:
        return PagedKV(**_empty_fields((L, P_), n, npad, c, k, device),
                       raw_pages=None, ring=ring, page_table=pt,
                       page_used=used)
    return PagedKV(signman=None, planes=None, dict_syms=None, esc_pos=None,
                   esc_raw=None,
                   raw_pages=torch.zeros((L, P_, blk, w),
                                         dtype=torch.bfloat16, device=device),
                   ring=ring, page_table=pt, page_used=used)


def _alloc_pages(pkv: PagedKV, count: int) -> np.ndarray:
    """The ``count`` lowest free page ids (free pages first, stable), now
    marked used.  The pool is sized so this cannot run dry (see
    ``empty_paged_kv``); a dry pool raises."""
    free = np.argsort(pkv.page_used, kind="stable")[:count]
    if count and pkv.page_used[free].any():
        raise RuntimeError("page pool exhausted")
    pkv.page_used[free] = True
    return free.astype(np.int32)


def empty_step(n_slots: int, device) -> torch.Tensor:
    """A zeroed (4, n_slots) int32 step buffer (``PagedKV.step``'s rows;
    a KV-less pool's own, staged by ``stage_append`` with ``pkv`` None)."""
    return torch.zeros((4, n_slots), dtype=torch.int32, device=device)


class AppendPlan(NamedTuple):
    """One decode step's cache appends, shared by every layer (all layers
    append at the same positions and flush together).  The device part
    is views of the step buffer (``PagedKV.step``), the same tensors every
    step, so a CUDA graph of a step reads each step's values; the flush
    part is host-side and runs only in an eager step."""
    rows: torch.Tensor             # (S,) int64 flat ring row of every slot
    # (S,) bool: the slot appends this step, to this rank's ring (at
    # tp > 1: only where the rank owns the position)
    active: torch.Tensor
    pos: torch.Tensor              # (S,) int32 lengths before the step
    post: torch.Tensor             # (S,) int32 lengths after it
    flush_slots: np.ndarray        # (nf,) int64 slots whose ring fills
    flush_pages: np.ndarray        # (nf,) int64 their new pages


def stage_append(run: RunConfig, pkv: Optional[PagedKV], lengths: np.ndarray,
                 active: np.ndarray, tp: int = 1, ti: int = 0,
                 step: Optional[torch.Tensor] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The host part of a step's appends: decide where each slot's token
    goes and which active rings fill (host arithmetic only), allocate the
    filling rings' pages, map them into the page table, and stage the
    step's per-slot values into ``pkv.step`` (one copy from host memory).
    Returns (flush slots, their pages).  Mirrors the reference's in-graph
    ``append_token_paged`` bookkeeping: on rank ``ti`` of ``tp`` a slot
    writes only where it owns the position (``length % tp == ti``), at
    its slot ``length // tp``.  ``pkv`` None (an attention-free model's
    pool: no pages) stages the lengths into ``step`` and flushes
    nothing."""
    blk = run.codec.cache_block
    lengths = np.asarray(lengths, np.int64)
    active = np.asarray(active, bool)
    write = active & (lengths % tp == ti)
    loc = lengths // tp
    r = loc % blk
    if pkv is None:
        flush, pages = np.zeros((0,), np.int64), np.zeros((0,), np.int32)
    else:
        step = pkv.step
        flush = np.flatnonzero(write & (r == blk - 1))
        pages = _alloc_pages(pkv, len(flush))
        if len(flush):
            pkv.page_table[flush, loc[flush] // blk] = pages
            pkv.touch()
    host = np.stack([np.arange(len(lengths)) * blk + r, write, lengths,
                     lengths + active]).astype(np.int32)
    step.copy_(torch.from_numpy(host), non_blocking=True)
    return flush, pages.astype(np.int64)


def device_plan(step: torch.Tensor, flush_slots=(),
                flush_pages=()) -> AppendPlan:
    """The plan of the step staged in ``step`` (a pool's ``PagedKV.step``;
    no flush by default: the form a CUDA graph captures)."""
    return AppendPlan(step[0].long(), step[1].bool(), step[2], step[3],
                      np.asarray(flush_slots, np.int64),
                      np.asarray(flush_pages, np.int64))


def plan_append(run: RunConfig, pkv: PagedKV, lengths: np.ndarray,
                active: np.ndarray, tp: int = 1, ti: int = 0) -> AppendPlan:
    """``stage_append`` then ``device_plan``: one eager step's plan."""
    return device_plan(pkv.step,
                       *stage_append(run, pkv, lengths, active, tp, ti))


def append_token_paged(cfg: ModelConfig, run: RunConfig, pkv: PagedKV,
                       layer: int, new_vals: torch.Tensor,
                       plan: AppendPlan) -> None:
    """Append one token's K/V (S, W) of ``layer`` at every slot's ring row
    under the active mask -- an inactive slot writes back the bytes it
    read, so its row stays bit for bit what it was, and the write has the
    same shape every step -- then compress the rings that just filled into
    their planned pages: only the flushing rings are compressed (the
    reference compresses every ring and drops the rest; the stored bytes
    are the same).  Updates the pool in place."""
    ring = pkv.ring[layer]
    flat = ring.view(-1, ring.shape[-1])
    old = flat.index_select(0, plan.rows)
    flat.index_copy_(0, plan.rows, torch.where(
        plan.active[:, None], new_vals.to(torch.bfloat16), old))
    if len(plan.flush_slots):
        dev = ring.device
        full = ring[torch.as_tensor(plan.flush_slots, device=dev)]
        pages = torch.as_tensor(plan.flush_pages, device=dev)
        if run.codec.cache:
            ct = fixed.compress_many(
                full, k=run.codec.k,
                esc_capacity=run.codec.esc_capacity(full[0].numel()))
            for f in _FIELDS:
                getattr(pkv, f)[layer][pages] = getattr(ct, f)
        else:
            pkv.raw_pages[layer][pages] = full


def attend_paged(cfg: ModelConfig, run: RunConfig, pkv: PagedKV, layer: int,
                 q: torch.Tensor, lengths: torch.Tensor,
                 spec: layers.AttnSpec, window=None, tg=None) -> torch.Tensor:
    """Per-slot paged decode attention of ``layer``: q (S,Hq,1,hd),
    ``lengths`` (S,) int32 post-append token counts on q's device.
    Returns (S,Hq,1,hd_v) bf16 (hd_v = lora for MLA).

    ``kernels.ops.decode_attend_paged`` launches the CUDA kernel on CUDA
    tensors and runs its plain version on CPU ones (``ServeEngine`` checks
    ``run.codec.decode_backend`` against the device once).  At tp > 1
    each rank attends its slots and ``merge_shards`` merges."""
    out, m, l = kops.decode_attend_paged(
        q[:, :, 0].contiguous(), *pkv.layer_fields(layer), pkv.ring[layer],
        pkv.page_ids(), lengths, effective_window(spec, window),
        **kernel_statics(cfg, run, q, spec), tp=cl.world(tg),
        ti=cl.rank(tg))
    return merge_shards(out, m, l, tg)[:, :, None]


def paged_insert_many(cfg: ModelConfig, run: RunConfig, pkv: PagedKV,
                      kvbs: List[KVBlocks], slots: np.ndarray,
                      seq_len: int, tp: int = 1) -> None:
    """Copy B prefilled single-sequence stores (``kvbs[layer]``, group 1,
    leading axis B) into slots ``slots``: each sequence's full blocks
    become fresh pages byte for byte (the block layout IS the page
    layout), its partial tail becomes the slot's ring row.  Pages are
    allocated once for all layers, sequence-major, lowest free ids first
    (in place).  At tp > 1 ``seq_len`` is a multiple of tp and the stores
    hold the rank's seq_len / tp slots."""
    blk = run.codec.cache_block
    slots = np.asarray(slots, np.int64)
    nb = len(slots)
    assert seq_len % tp == 0, (seq_len, tp)
    nfull = (seq_len // tp) // blk
    maxp = pkv.page_table.shape[1]
    assert nfull <= maxp, (nfull, maxp)
    pages = _alloc_pages(pkv, nb * nfull).reshape(nb, nfull)
    rows = np.full((nb, maxp), -1, np.int32)
    rows[:, :nfull] = pages
    pkv.page_table[slots] = rows
    pkv.touch()
    dev = pkv.ring.device
    tgt = torch.as_tensor(pages.reshape(-1), dtype=torch.int64, device=dev)
    slots_t = torch.as_tensor(slots, device=dev)
    for layer, kvb in enumerate(kvbs):
        if nfull:
            if run.codec.cache:
                for f in _FIELDS:
                    src = getattr(kvb, f)[:, :nfull]
                    getattr(pkv, f)[layer][tgt] = src.reshape(
                        (nb * nfull,) + src.shape[2:])
            else:
                pkv.raw_pages[layer][tgt] = kvb.raw_blocks[:, :nfull] \
                    .reshape((nb * nfull,) + kvb.raw_blocks.shape[3:])
        pkv.ring[layer][slots_t] = kvb.ring


def map_prefix_pages(pkv: PagedKV, slot: int, page_ids: np.ndarray,
                     n_cols: int) -> None:
    """Map already-filled shared pages into slot ``slot``'s table row (all
    layers): ``page_ids`` (maxp,) holds the matched full prefix columns'
    page ids (entries from ``n_cols`` on are ignored).  The slot's ring
    starts empty (the shared prefix is block-aligned; the tail is
    private).  No page data moves: sharing is page-table indirection, the
    host scheduler owns the refcounts.  The ring is cleared on the device
    outside any captured step; the table reaches the device through
    ``touch``."""
    maxp = pkv.page_table.shape[1]
    ids = np.asarray(page_ids, np.int32)[:n_cols]
    row = np.full((maxp,), -1, np.int32)
    row[:n_cols] = ids
    pkv.page_table[slot] = row
    pkv.page_used[ids] = True        # live already: a re-assert
    pkv.ring[:, slot].zero_()
    pkv.touch()


class PageWire(NamedTuple):
    """One slot's cache payload in transfer layout, every layer: the
    dense, column-ordered view of a sequence's pages that
    ``export_sequence`` gathers out of a pool and ``import_sequence``
    scatters into one (ports ``repro/models/cache.py:PageWire`` as
    ``engine.export_slot`` stacks it over layers).  Compressed fields are
    byte-identical to the pool pages they came from; page ids never cross
    the wire.  Leaves are ``None`` exactly as in ``PagedKV``.  Shapes
    (n_cols exported columns; columns past the sequence's full pages are
    zeroed):

      signman   (L, n_cols, N) u8          N = block*W
      planes    (L, n_cols, k, Npad/32) int32 (the reference's u32 bits)
      dict_syms (L, n_cols, 2^k) u8
      esc_pos   (L, n_cols, C) i32
      esc_raw   (L, n_cols, C) u8
      raw_pages (L, n_cols, block, W) bf16
      ring      (L, block, W) bf16         the in-flight partial block
    """
    signman: Optional[torch.Tensor]
    planes: Optional[torch.Tensor]
    dict_syms: Optional[torch.Tensor]
    esc_pos: Optional[torch.Tensor]
    esc_raw: Optional[torch.Tensor]
    raw_pages: Optional[torch.Tensor]
    ring: torch.Tensor


_WIRE_FIELDS = _FIELDS + ("raw_pages",)


def export_n_cols(length: int, blk: int, tp: int = 1) -> int:
    """Page columns of a wire payload of a sequence of ``length`` tokens:
    the most full pages any of the ``tp`` ranks holds."""
    return max(local_full_pages(length, t, blk, tp) for t in range(tp))


def export_sequence(pkv: PagedKV, slot: int, n_cols: int, length: int,
                    col0: int = 0, tp: int = 1, ti: int = 0) -> PageWire:
    """Gather slot ``slot``'s pages ``[col0, col0 + n_cols)`` and its ring
    into transfer layout (one gather per field from the host table's
    ids, no decompression).  Columns at or past the sequence's full pages
    on this rank (``local_full_pages``) are zeroed, so the payload is
    deterministic."""
    blk = pkv.ring.shape[2]
    maxp = pkv.page_table.shape[1]
    cols = col0 + np.arange(n_cols)
    valid = (cols < local_full_pages(length, ti, blk, tp)) & (cols < maxp)
    row = pkv.page_table[slot]
    pid = np.where(valid, np.maximum(row[np.clip(cols, 0, maxp - 1)], 0), 0)
    dev = pkv.ring.device
    pid_t = torch.as_tensor(pid, dtype=torch.int64, device=dev)
    dead = torch.as_tensor(~valid, device=dev)

    def take(field):
        if field is None:
            return None
        out = field.index_select(1, pid_t)
        out[:, dead] = 0
        return out

    return PageWire(*(take(getattr(pkv, f)) for f in _WIRE_FIELDS),
                    ring=pkv.ring[:, slot].clone())


def import_sequence(pkv: PagedKV, slot: int, wire: PageWire, length: int,
                    col0: int = 0, tp: int = 1, ti: int = 0) -> None:
    """Scatter a :class:`PageWire` into slot ``slot`` of this pool, the
    inverse of ``export_sequence`` up to page ids: fresh pages come from
    this pool's free list (``_alloc_pages``, lowest free ids first, as the
    reference's stable argsort), the fields are byte-copied into them, and
    the row maps them in column order.  Wire columns land at ``[col0,
    col0 + n_cols)``; the row below ``col0`` is kept (prefix reuse maps
    shared pages there first); columns at or past the rank's full pages
    (``local_full_pages``) are dropped.  The host checks capacity: a dry
    pool raises before any device write."""
    lead = wire.signman if pkv.signman is not None else wire.raw_pages
    n_cols = lead.shape[1]
    blk = pkv.ring.shape[2]
    maxp = pkv.page_table.shape[1]
    nfull = local_full_pages(length, ti, blk, tp)
    n_valid = max(min(n_cols, nfull - col0), 0)
    assert col0 + n_valid <= maxp, (col0, n_valid, maxp)
    pages = _alloc_pages(pkv, n_valid)
    dev = pkv.ring.device
    tgt = torch.as_tensor(pages, dtype=torch.int64, device=dev)
    for f in _WIRE_FIELDS:
        dst = getattr(pkv, f)
        if dst is not None and n_valid:
            dst[:, tgt] = getattr(wire, f)[:, :n_valid].to(dev)
    row = pkv.page_table[slot].copy()
    row[col0:] = -1
    row[col0:max(nfull, col0)] = 0       # the reference's zero padding
    row[col0:col0 + n_valid] = pages
    pkv.page_table[slot] = row
    pkv.ring[:, slot] = wire.ring.to(dev)
    pkv.touch()


def release_pages(pkv: PagedKV, slots_mask: np.ndarray,
                  free_mask: Optional[np.ndarray] = None) -> None:
    """Unmap the masked slots' table rows and free pages (in place; host
    bookkeeping only).  ``free_mask`` None: every page of a masked row is
    freed.  With prefix sharing the host passes ``free_mask`` (n_pages,)
    bool, exactly the pages whose last reference went, so pages that
    other rows or the retained prefix index still hold stay used."""
    if free_mask is None:
        rows = pkv.page_table[slots_mask]
        pkv.page_used[rows[rows >= 0]] = False
    else:
        pkv.page_used &= ~np.asarray(free_mask, bool)
    pkv.page_table[slots_mask] = -1
    pkv.touch()
