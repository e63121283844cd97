"""Fused page decompress + decode attention: the CUDA kernel
``csrc/decode_attend_paged.cu`` (replaces the Pallas kernel
``repro/kernels/decode_attend.py:decode_attend_paged``) and its plain
PyTorch twin.

Only the paged entry point is ported; the fixed-batch ``decode_attend``
waits for the fixed-batch store.  The port runs at tp = 1, so the
reference's shard arguments (``tp``, ``ti``) are gone: every slot owns all
its positions.  MLA latent payloads are not covered yet (the dense family
is this slice's path).

Calling convention (as the reference's): q (S, H, hd) bf16; the page
pool's fields with leading n_pages — signman (P, n) uint8, planes
(P, k, n/32) int32-held words, dicts (P, 2^k) uint8, esc_pos (P, C) int32,
esc_raw (P, C) uint8 — or raw_pages (P, blk, W) bf16 when the codec is
off; ring (S, blk, W) bf16; page_ids (S, maxp) int32 with unmapped entries
already clipped to a valid id (they are dead by length); lengths (S,)
post-append token counts; window the layer's window (``ref.WINDOW_NONE`` for
global layers).  Returns unnormalised (out (S, H, hd) f32, m (S, H),
l (S, H)).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import ref

plain = ref.paged_decode_attend_plain

launches = 0          # kernel launches since the last reset


def decode_attend_paged(q, signman, planes, dicts, esc_pos, esc_raw,
                        raw_pages, ring, page_ids, lengths, window: int, *,
                        k: int, kv_idx: Sequence[int], scale: float,
                        softcap: Optional[float] = None):
    """Launch the kernel (CUDA tensors only).  ``kv_idx`` maps each query
    head to its kv head; the kernel takes the GQA/MQA/MHA map
    min(h // (Hq // Hkv), Hkv - 1) (``cache.gqa_head_table``) and refuses
    any other."""
    global launches
    from .ops import check_cuda, library, raise_on_error

    codec_on = signman is not None
    check_cuda(q, torch.bfloat16, 3, "q")
    check_cuda(ring, torch.bfloat16, 3, "ring")
    check_cuda(page_ids, torch.int32, 2, "page_ids")
    check_cuda(lengths, torch.int32, 1, "lengths")
    n_s, h, hd = q.shape
    _, blk, w = ring.shape
    maxp = page_ids.shape[1]
    if hd % 16:
        raise ValueError(f"head_dim must be a multiple of 16, got {hd}")
    if w % (2 * hd):
        raise ValueError(f"payload width {w} is not Hkv * 2 * {hd}")
    hkv = w // (2 * hd)
    g = h // max(hkv, 1)
    if g < 1 or tuple(kv_idx) != tuple(min(i // g, hkv - 1)
                                       for i in range(h)):
        raise ValueError(f"unsupported head map {tuple(kv_idx)} for {h} "
                         f"query heads over {hkv} kv heads")
    if ring.shape[0] != n_s or page_ids.shape[0] != n_s \
            or lengths.shape[0] != n_s:
        raise ValueError("q, ring, page_ids and lengths disagree on slots")
    n = blk * w
    if codec_on:
        check_cuda(signman, torch.uint8, 2, "signman")
        check_cuda(planes, torch.int32, 3, "planes")
        check_cuda(dicts, torch.uint8, 2, "dicts")
        check_cuda(esc_pos, torch.int32, 2, "esc_pos")
        check_cuda(esc_raw, torch.uint8, 2, "esc_raw")
        if signman.shape[1] != n or planes.shape[1:] != (k, n // 32) \
                or dicts.shape[1] != 1 << k or not 1 <= k <= 8 \
                or esc_raw.shape != esc_pos.shape:
            raise ValueError("page pool fields do not match the page "
                             f"geometry (blk={blk}, W={w}, k={k})")
        c = esc_pos.shape[1]
        pool = (signman, planes, dicts, esc_pos, esc_raw, None)
    else:
        check_cuda(raw_pages, torch.bfloat16, 3, "raw_pages")
        if raw_pages.shape[1:] != (blk, w):
            raise ValueError("raw pages do not match the ring geometry")
        c = 0
        pool = (None, None, None, None, None, raw_pages)
    out = torch.empty((n_s, h, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((n_s, h), dtype=torch.float32, device=q.device)
    l = torch.empty((n_s, h), dtype=torch.float32, device=q.device)
    if n_s == 0:
        return out, m, l
    ptr = lambda t: ctypes.c_void_p(0 if t is None else t.data_ptr())
    rc = library().decode_attend_paged_launch(
        ptr(q), *(ptr(t) for t in pool), ptr(ring), ptr(page_ids),
        ptr(lengths), ptr(out), ptr(m), ptr(l), ctypes.c_int(n_s),
        ctypes.c_int(h), ctypes.c_int(hkv), ctypes.c_int(hd),
        ctypes.c_int(blk), ctypes.c_int(w), ctypes.c_int(maxp),
        ctypes.c_int(k), ctypes.c_int(c), ctypes.c_int(int(window)),
        ctypes.c_float(scale), ctypes.c_float(softcap or 0.0),
        ctypes.c_int(int(codec_on)),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    raise_on_error(rc, "decode_attend_paged")
    launches += 1
    return out, m, l
