"""Fused block decompress + decode attention: the CUDA kernels
``csrc/decode_attend.cu`` (replaces the Pallas kernel
``repro/kernels/decode_attend.py:decode_attend``, the fixed-batch store)
and ``csrc/decode_attend_paged.cu`` (replaces ``decode_attend_paged``, the
paged pool), both built on ``csrc/decode_attend_body.cuh``, and their plain
PyTorch twins.

Both take the reference's shard arguments: ``tp`` and ``ti`` (keywords,
default 1 and 0).  Shard ``ti`` of ``tp`` holds the interleaved global
positions p % tp == ti of each sequence: stream row (local slot) sl holds
position sl * tp + ti, so a sequence of global length L gives it
``ref.local_length(L, tp, ti)`` rows; the live and window masks test the
global positions against the global L (``ref.stream_mask``).  A shard that
holds no live position of a sequence returns m = ``ref.NEG_INF``, l = 0
for it, as an empty slot does.

Shared calling convention (as the reference's): q (S, H, hd) bf16 with
hd % 16 == 0; ring (S, blk, W) bf16; window the layer's window
(``ref.WINDOW_NONE`` for global layers).  Two payloads:

* plain attention (``mla_lora`` None): W = Hkv * 2 * hd (K‖V per kv
  head); ``kv_idx`` the GQA/MQA/MHA head map min(h // (Hq // Hkv), Hkv -
  1) (``cache.gqa_head_table``; any other map is refused);
* MLA latent (``mla_lora`` = lora): each row is one latent c_kv ‖ k_rope
  of W = hd columns that every query head shares (the absorbed query is
  W wide); k is the whole row, v its first lora columns; ``kv_idx`` is
  empty, as the reference's ``_kernel_statics`` passes it.

Both return unnormalised (out (S, H, hd_v) f32, m (S, H), l (S, H)),
hd_v = hd, or lora for MLA.

``decode_attend`` (fixed-batch store; S = B sequences at one length):
signman (nblk, B·blk·W) uint8, planes (nblk, k, B·blk·W/32) int32-held
words, dicts (nblk, 2^k) uint8, esc_pos / esc_raw (nblk, C) int32 / uint8
— one record per block for all B sequences — or raw_blocks
(nblk, B, blk, W) bf16 when the codec is off; ``length`` the
post-append token count shared by every sequence: a host int, or a 0-d
int32 CUDA tensor, which the kernel reads on the device (the launch form
a CUDA graph can replay at every length) and clamps to the store's
capacity, (nblk + 1)·blk - 1.

``decode_attend_paged``: the page pool's fields with leading n_pages —
signman (P, n), planes (P, k, n/32), dicts (P, 2^k), esc_pos / esc_raw
(P, C), or raw_pages (P, blk, W); page_ids (S, maxp) int32 with unmapped
entries already clipped to a valid id (they are dead by length); lengths
(S,) int32 post-append token counts.

Both kernels split each sequence's stream into spans of ``span_rows(blk)``
rows, one CTA per (kv head, sequence, span), and merge the spans' partials
in the kernel (``csrc/decode_attend_body.cuh``).  The grid comes from
host-side values only (``paged_splits``; ``fixed_splits`` for a host
length, ``capacity_splits`` for a device one); the partials and the
per-(sequence, kv head) arrival counters live in a workspace cached per
(device, stream) (``_workspace``, grown as ``kernels.workspace`` says),
which the kernels leave zeroed.  Launches on one stream run in order and
share it; a launch on another stream gets its own.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import ref, workspace

plain = ref.decode_attend_plain
plain_paged = ref.paged_decode_attend_plain

# kernel launches since the last reset, by kernel
launches = {"decode_attend": 0, "decode_attend_paged": 0}

SPAN_ROWS = 128            # stream rows one CTA walks, at most


def span_rows(blk: int) -> int:
    """P, the rows of one split: the largest power of two that divides the
    block and is at most SPAN_ROWS, so a span never straddles a record."""
    return math.gcd(blk, SPAN_ROWS)


def paged_splits(maxp: int, blk: int) -> int:
    """Splits per (slot, kv head) of the paged kernel: every span the page
    table's ``maxp`` columns and the ring could hold.  The slots' lengths
    are device values, so the spans past a slot's length are in the grid
    too (and load nothing)."""
    return (maxp + 1) * blk // span_rows(blk)


def fixed_splits(length: int, window: int, blk: int, tp: int = 1,
                 ti: int = 0) -> Tuple[int, int]:
    """(first span, splits) of the fixed-batch kernel at the host-side
    ``length`` on shard ``ti`` of ``tp``: the spans from the first one
    holding a row whose position is inside the window (positions >
    length - 1 - window) to the last one below the shard's rows; one dead
    split when nothing is live."""
    p = span_rows(blk)
    end = -(-ref.local_length(length, tp, ti) // p)
    w0 = length - window - ti            # first live row: ceil(w0 / tp)
    first = min((-(-w0 // tp) if w0 > 0 else 0) // p, end)
    return first, max(1, end - first)


def capacity_splits(nblk: int, blk: int) -> int:
    """Splits of the fixed-batch kernel's device-length launch: every span
    the store's ``nblk`` blocks and the ring could hold.  The length is a
    device value, so the grid cannot follow it (a CUDA graph replays one
    grid); the spans outside [first live, last live] load nothing."""
    return (nblk + 1) * blk // span_rows(blk)


def geometry(hd: int, gmax: int, span: int,
             mla_lora: Optional[int] = None) -> Dict[str, int]:
    """What both kernels launch for (hd, gmax, P) (and an MLA latent of
    hd columns, ``mla_lora`` of them values): chunk rows, threads per
    (head, row) dot, dynamic shared memory and threads per CTA."""
    from .ops import library

    out = (ctypes.c_int * 4)()
    rw, dv = (hd, mla_lora) if mla_lora else (2 * hd, hd)
    library().decode_attend_geometry(rw, hd, dv, gmax, span, out)
    return dict(zip(("chunk_rows", "dot_threads", "smem_bytes", "threads"),
                    out))


# (device, stream handle) -> (partials, arrival counters), grown on demand
_workspaces: Dict[Tuple[torch.device, int],
                  Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device, stream: int, n_s: int, hkv: int, nsplit: int,
               gmax: int, hd: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The merge workspace for one launch on ``stream``: (n_s, hkv,
    nsplit, gmax, hd + 2) f32 partials (``hd`` the output width hd_v) and n_s * hkv int32 counters
    (allocated zeroed; every launch leaves them zero).  The kernels of one
    stream run one after another, so they can share it; two streams could
    overlap, so each has its own."""
    need = n_s * hkv * nsplit * gmax * (hd + 2)
    ws, cnt = _workspaces.get((device, stream), (None, None))
    ws = workspace.sized(ws, need, torch.float32, device)
    cnt = workspace.sized(cnt, n_s * hkv, torch.int32, device, zeroed=True)
    _workspaces[(device, stream)] = (ws, cnt)
    return ws, cnt


@functools.lru_cache(maxsize=None)
def _head_map(h: int, hkv: int) -> Tuple[int, ...]:
    """The head map the kernels take for h query heads over hkv kv heads:
    min(i // (h // hkv), hkv - 1)."""
    g = h // hkv
    return tuple(min(i // g, hkv - 1) for i in range(h))


def _check_attend(q, ring, kv_idx, mla_lora, n_seqs_name: str):
    """Validate the operands both kernels share; (S, H, hd, blk, W, Hkv,
    hd_v, lora), lora 0 for plain attention."""
    from .ops import check_cuda

    check_cuda(q, torch.bfloat16, 3, "q")
    check_cuda(ring, torch.bfloat16, 3, "ring")
    n_s, h, hd = q.shape
    _, blk, w = ring.shape
    if hd % 16:
        raise ValueError(f"head_dim must be a multiple of 16, got {hd}")
    if mla_lora is not None:
        lora = int(mla_lora)
        if w != hd or w % 32 or lora % 16 or not 0 < lora <= w:
            raise ValueError(f"MLA latent: payload width {w} must equal the "
                             f"query's {hd} (a multiple of 32) and hold "
                             f"lora {lora} (a multiple of 16)")
        if tuple(kv_idx):
            raise ValueError("MLA latent: the head map must be empty")
        hkv, hd_v = 1, lora
    else:
        lora = 0
        if w % (2 * hd):
            raise ValueError(f"payload width {w} is not Hkv * 2 * {hd}")
        hkv, hd_v = w // (2 * hd), hd
        if not 1 <= hkv <= h or tuple(kv_idx) != _head_map(h, hkv):
            raise ValueError(f"unsupported head map {tuple(kv_idx)} for {h} "
                             f"query heads over {hkv} kv heads")
    if ring.shape[0] != n_s:
        raise ValueError(f"q and ring disagree on {n_seqs_name}")
    return n_s, h, hd, blk, w, hkv, hd_v, lora


def _check_codec(signman, planes, dicts, esc_pos, esc_raw, n: int, k: int,
                 what: str) -> int:
    """Validate a store's compressed fields (records of n elements);
    returns the escape capacity C."""
    from .ops import check_cuda

    check_cuda(signman, torch.uint8, 2, "signman")
    check_cuda(planes, torch.int32, 3, "planes")
    check_cuda(dicts, torch.uint8, 2, "dicts")
    check_cuda(esc_pos, torch.int32, 2, "esc_pos")
    check_cuda(esc_raw, torch.uint8, 2, "esc_raw")
    recs = signman.shape[0]
    if signman.shape[1] != n or planes.shape != (recs, k, n // 32) \
            or dicts.shape != (recs, 1 << k) or not 1 <= k <= 8 \
            or esc_pos.shape[0] != recs or esc_raw.shape != esc_pos.shape:
        raise ValueError(f"{what} fields do not match the geometry "
                         f"(n={n}, k={k})")
    return esc_pos.shape[1]


def _outputs(q, hd_v: int):
    n_s, h, _ = q.shape
    return (torch.empty((n_s, h, hd_v), dtype=torch.float32,
                        device=q.device),
            torch.empty((n_s, h), dtype=torch.float32, device=q.device),
            torch.empty((n_s, h), dtype=torch.float32, device=q.device))


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(q) -> int:
    return torch.cuda.current_stream(q.device).cuda_stream


def _check_shard(tp: int, ti: int) -> Tuple[int, int]:
    tp, ti = int(tp), int(ti)
    if tp < 1 or not 0 <= ti < tp:
        raise ValueError(f"shard {ti} of tp {tp} does not exist")
    return tp, ti


def decode_attend(q, signman, planes, dicts, esc_pos, esc_raw, raw_blocks,
                  ring, length: int, window: int, *, k: int,
                  kv_idx: Sequence[int], scale: float,
                  softcap: Optional[float] = None,
                  mla_lora: Optional[int] = None, tp: int = 1, ti: int = 0):
    """Launch the fixed-batch kernel (CUDA tensors only)."""
    from .ops import check_cuda, library, raise_on_error

    b, h, hd, blk, w, hkv, hd_v, lora = _check_attend(
        q, ring, kv_idx, mla_lora, "sequences")
    codec_on = signman is not None
    n = b * blk * w
    if codec_on:
        c = _check_codec(signman, planes, dicts, esc_pos, esc_raw, n, k,
                         "block store")
        nblk = signman.shape[0]
        store = (signman, planes, dicts, esc_pos, esc_raw, None)
    else:
        check_cuda(raw_blocks, torch.bfloat16, 4, "raw_blocks")
        if raw_blocks.shape[1:] != (b, blk, w):
            raise ValueError("raw blocks do not match the ring geometry")
        c, nblk = 0, raw_blocks.shape[0]
        store = (None,) * 5 + (raw_blocks,)
    tp, ti = _check_shard(tp, ti)
    on_device = isinstance(length, torch.Tensor)
    if on_device:
        check_cuda(length, torch.int32, 0, "length")
    else:
        length = int(length)
        if length < 0 or ref.local_length(length, tp, ti) // blk > nblk:
            raise ValueError(f"length {length} does not fit {nblk} blocks "
                             f"of {blk} and the ring (shard {ti} of {tp})")
    out, m, l = _outputs(q, hd_v)
    if b == 0:
        return out, m, l
    window = int(window)
    span0, nsplit = (0, capacity_splits(nblk, blk)) if on_device \
        else fixed_splits(length, window, blk, tp, ti)
    stream = _stream(q)
    ws, cnt = _workspace(q.device, stream, b, hkv, nsplit,
                         h - (hkv - 1) * (h // hkv), hd_v)
    common = (_ptr(q), *(_ptr(t) for t in store), _ptr(ring), _ptr(out),
              _ptr(m), _ptr(l), _ptr(ws), _ptr(cnt), b, h, hkv, hd, lora,
              blk, w, k, c)
    tail = (n // 32, float(scale), float(softcap or 0.0), int(codec_on),
            tp, ti, stream)
    if on_device:
        rc = library().decode_attend_dev_launch(
            *common, _ptr(length), window, span_rows(blk), nsplit, *tail)
    else:
        rc = library().decode_attend_launch(
            *common, length, window, span_rows(blk), span0, nsplit, *tail)
    raise_on_error(rc, "decode_attend")
    launches["decode_attend"] += 1
    return out, m, l


def decode_attend_paged(q, signman, planes, dicts, esc_pos, esc_raw,
                        raw_pages, ring, page_ids, lengths, window: int, *,
                        k: int, kv_idx: Sequence[int], scale: float,
                        softcap: Optional[float] = None,
                        mla_lora: Optional[int] = None, tp: int = 1,
                        ti: int = 0):
    """Launch the paged kernel (CUDA tensors only)."""
    from .ops import check_cuda, library, raise_on_error

    tp, ti = _check_shard(tp, ti)
    n_s, h, hd, blk, w, hkv, hd_v, lora = _check_attend(
        q, ring, kv_idx, mla_lora, "slots")
    check_cuda(page_ids, torch.int32, 2, "page_ids")
    check_cuda(lengths, torch.int32, 1, "lengths")
    maxp = page_ids.shape[1]
    if page_ids.shape[0] != n_s or lengths.shape[0] != n_s:
        raise ValueError("q, page_ids and lengths disagree on slots")
    codec_on = signman is not None
    if codec_on:
        c = _check_codec(signman, planes, dicts, esc_pos, esc_raw, blk * w,
                         k, "page pool")
        pool = (signman, planes, dicts, esc_pos, esc_raw, None)
    else:
        check_cuda(raw_pages, torch.bfloat16, 3, "raw_pages")
        if raw_pages.shape[1:] != (blk, w):
            raise ValueError("raw pages do not match the ring geometry")
        c = 0
        pool = (None,) * 5 + (raw_pages,)
    out, m, l = _outputs(q, hd_v)
    if n_s == 0:
        return out, m, l
    nsplit = paged_splits(maxp, blk)
    stream = _stream(q)
    ws, cnt = _workspace(q.device, stream, n_s, hkv, nsplit,
                         h - (hkv - 1) * (h // hkv), hd_v)
    rc = library().decode_attend_paged_launch(
        _ptr(q), *(_ptr(t) for t in pool), _ptr(ring), _ptr(page_ids),
        _ptr(lengths), _ptr(out), _ptr(m), _ptr(l), _ptr(ws), _ptr(cnt),
        n_s, h, hkv, hd, lora, blk, w, maxp, k, c, int(window),
        span_rows(blk),
        nsplit, float(scale), float(softcap or 0.0), int(codec_on), tp, ti,
        stream)
    raise_on_error(rc, "decode_attend_paged")
    launches["decode_attend_paged"] += 1
    return out, m, l
