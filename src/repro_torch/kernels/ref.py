"""Plain PyTorch versions of the port's kernels (ports ``repro/kernels/ref.py``).

They run on any device.  On the CPU they ARE the computation (every
wrapper in ``kernels.ops`` takes them for CPU tensors); on the card they
are what ``chip_smoke.py`` holds each kernel against.  Nothing on the
serving path calls them for a CUDA tensor.

Layout contract, shared with the kernels and bit-compatible with
``core.fixed``/``core.packing``: a stream is processed as (G, n) rows, one
row per independently coded tensor; exponent codes are bit-plane packed in
flat groups of 32 consecutive elements (plane words held as int32); the
encode LUT maps the 8-bit exponent to a k-bit index with ESCAPE = 2^k - 1.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import entropy as E
from repro_torch.core import packing

NEG_INF = -2.0e38
WINDOW_NONE = 1 << 30      # "no window" sentinel (matches the reference)


def histogram_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain ``exp_histogram``: (G, n) bf16 -> (G, 256) int32 exponent
    counts per row."""
    exp = E.exponent(E.to_u16(x))
    hist = torch.zeros((x.shape[0], 256), dtype=torch.int32, device=x.device)
    return hist.scatter_add_(1, exp, torch.ones_like(exp, dtype=torch.int32))


def pack_ref(x: torch.Tensor, enc_lut: torch.Tensor, k: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain ``lexi_pack``: (G, n) bf16 with per-row encode LUTs (G, 256)
    -> (signman (G, n) uint8, planes (G, k, pad32(n)/32) int32)."""
    g, n = x.shape
    u16 = E.to_u16(x)
    codes = torch.gather(enc_lut.to(torch.int64), 1, E.exponent(u16))
    pad = packing.pad_to_lanes(n) - n
    codes = torch.nn.functional.pad(codes, (0, pad))       # pad codes are 0
    return E.signman(u16), packing.bitplane_pack(codes, k)


def unpack_ref(signman: torch.Tensor, planes: torch.Tensor,
               dict_syms: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_ref` without the escape side channel:
    (G, n) uint8, (G, k, W) int32, (G, 2^k) uint8 -> (G, n) bf16."""
    n = signman.shape[-1]
    codes = packing.bitplane_unpack(planes, k)[..., :n]
    exp = torch.gather(dict_syms.to(torch.int64), -1, codes)
    return E.from_u16(E.combine(signman, exp))


# ---------------------------------------------------------------------------
# packed weights: the (K, N) matmul layout of the serving weight plane
# ---------------------------------------------------------------------------

def compress_weight_2d(w: torch.Tensor, k: int = 6):
    """Plain packer for a matmul weight (ports the reference's
    ``compress_weight_2d``): (K, N) bf16, N % 32 == 0 -> (signman (K, N)
    uint8, planes (k, K, N/32) int32-held words, dict (2^k,) uint8,
    n_escapes).  The planes are one ``pack_ref`` row of K*N elements:
    with N % 32 == 0 every 32-element word lies inside one row of W, so
    word (b, r, c) holds bit b of W[r, 32c .. 32c + 31]."""
    from repro_torch.core import fixed

    kk, n = w.shape
    if n % packing.LANES:
        raise ValueError(f"N must be a multiple of 32, got {n}")
    row = w.reshape(1, kk * n).to(torch.bfloat16)
    hist = histogram_ref(row)[0]
    dict_syms, enc_lut = fixed.build_dictionary(hist, k)
    n_escapes = (hist * (enc_lut == fixed.esc_index(k))).sum()
    signman, planes = pack_ref(row, enc_lut[None], k)
    return (signman.reshape(kk, n), planes.reshape(k, kk, n // packing.LANES),
            dict_syms, n_escapes.to(torch.int32))


def decompress_matmul_ref(x: torch.Tensor, signman: torch.Tensor,
                          planes: torch.Tensor, dict_syms: torch.Tensor,
                          k: int) -> torch.Tensor:
    """Plain ``decompress_matmul``: x (M, K) bf16 @ packed W (K, N) ->
    (M, N) f32.  W is decoded exactly (escape-free layout), then both
    operands are widened to f32: bf16 products are exact in f32, so only
    the summation order can differ from the kernel."""
    kk, n = signman.shape
    w = unpack_ref(signman.reshape(1, kk * n), planes.reshape(1, k, -1),
                   dict_syms.reshape(1, -1), k).reshape(kk, n)
    return torch.mm(x.float(), w.float())


# ---------------------------------------------------------------------------
# decode attention: the fixed-batch store and the paged pool
# ---------------------------------------------------------------------------

def stream_mask(lengths: torch.Tensor, i: int, blk: int, window: int,
                ring: bool) -> torch.Tensor:
    """Live mask (S, blk) for page column ``i`` (or the ring) of each
    slot's stream at tp = 1: column i is live iff i < L // blk, ring row j
    iff (L // blk) * blk + j < L; every position must also satisfy
    pos > L - 1 - window."""
    L = lengths.to(torch.int64)[:, None]
    nfull = L // blk
    j = torch.arange(blk, device=lengths.device)[None]
    if ring:
        pos = nfull * blk + j
        live = pos < L
    else:
        pos = (i * blk + j).expand(L.shape[0], -1)
        live = (i < nfull).expand(-1, blk)
    return live & (pos < L) & (pos > L - 1 - window)


def _stream_ok(lengths: torch.Tensor, maxp: int, blk: int, window: int):
    """Live mask (S, maxp*blk + blk) over [pages ‖ ring]."""
    return torch.cat([stream_mask(lengths, i, blk, window, False)
                      for i in range(maxp)]
                     + [stream_mask(lengths, 0, blk, window, True)], dim=1)


def _attend_partials(q, vals, ok, kv_idx: Sequence[int], scale: float,
                     softcap: Optional[float]):
    """Single-pass masked softmax partials over a gathered payload.

    q (S, H, hd) bf16; vals (S, T, W) bf16 with W = Hkv*2*hd (K‖V per kv
    head); ok (S, T).  Returns unnormalised (out (S,H,hd) f32, m, l)."""
    s_, t, w = vals.shape
    hd = q.shape[-1]
    kv = vals.reshape(s_, t, w // (2 * hd), 2, hd)
    idx = torch.as_tensor(list(kv_idx), device=vals.device)
    k = kv[..., 0, :].index_select(2, idx).float()          # (S,T,H,hd)
    v = kv[..., 1, :].index_select(2, idx).float()
    sc = torch.einsum("shd,sthd->sht", q.float(), k) * scale
    if softcap is not None:
        sc = torch.tanh(sc / softcap) * softcap
    okb = ok[:, None, :]
    sc = torch.where(okb, sc, NEG_INF)
    m = sc.max(-1).values
    p = torch.where(okb, torch.exp(sc - m[..., None]), 0.0)
    out = torch.einsum("sht,sthd->shd", p, v)
    return out, m, p.sum(-1)


def paged_decode_attend_ref(q, pages_bf16, page_table, lengths, ring, *,
                            kv_idx, scale, softcap=None, window=WINDOW_NONE):
    """Oracle for ``decode_attend_paged`` on DEcompressed pages:
    q (S,H,hd); pages (P,blk,W) bf16; page_table (S,maxp) (-1 unmapped);
    lengths (S,); ring (S,blk,W).  Returns normalised (S,H,hd) f32."""
    n_s, maxp = page_table.shape
    _, blk, w = pages_bf16.shape
    gathered = pages_bf16[page_table.clamp(min=0).to(torch.int64)]
    vals = torch.cat([gathered.reshape(n_s, maxp * blk, w), ring], dim=1)
    ok = _stream_ok(lengths, maxp, blk, window)
    out, _, l = _attend_partials(q, vals, ok, kv_idx, scale, softcap)
    return out / l.clamp(min=1e-30)[..., None]


def paged_decode_attend_plain(q, signman, planes, dicts, esc_pos, esc_raw,
                              raw_pages, ring, page_ids, lengths, window, *,
                              k: int, kv_idx: Sequence[int], scale: float,
                              softcap: Optional[float] = None):
    """Plain ``decode_attend_paged``: the kernel's arguments and its
    unnormalised (out, m, l) partials, computed by decompressing every
    page the table names (``core.fixed.decompress``: dictionary LUT, then
    the escape side channel by position) and one masked softmax over
    [pages ‖ ring].  ``page_ids`` must already be clipped to valid ids."""
    vals, ok = paged_stream(signman, planes, dicts, esc_pos, esc_raw,
                            raw_pages, ring, page_ids, lengths, window, k=k)
    return _attend_partials(q, vals, ok, kv_idx, scale, softcap)


def paged_stream(signman, planes, dicts, esc_pos, esc_raw, raw_pages, ring,
                 page_ids, lengths, window, *, k: int):
    """The paged kernel's stream, gathered: (vals (S, maxp*blk + blk, W)
    bf16, every page the table names decompressed, then the ring; ok
    (S, maxp*blk + blk) live mask)."""
    from repro_torch.core import fixed

    n_s, maxp = page_ids.shape
    blk, w = ring.shape[-2], ring.shape[-1]
    pid = page_ids.to(torch.int64).reshape(-1)
    if signman is not None:
        ct = fixed.Compressed(
            signman=signman[pid], planes=planes[pid], dict_syms=dicts[pid],
            esc_pos=esc_pos[pid], esc_raw=esc_raw[pid],
            n_escapes=torch.zeros(pid.shape, dtype=torch.int32),
            shape=(blk, w), k=k)
        pages = fixed.decompress(ct)
    else:
        pages = raw_pages[pid]
    vals = torch.cat([pages.reshape(n_s, maxp * blk, w), ring], dim=1)
    return vals, _stream_ok(lengths, maxp, blk, window)


def fixed_stream(blocks_bf16, ring, length: int, window: int):
    """A fixed-batch stream, gathered: blocks (nb, B, blk, W) bf16
    decompressed, then the ring (B, blk, W); every sequence at ``length``.
    Returns (vals (B, nb*blk + blk, W), ok (B, nb*blk + blk))."""
    nb, b, blk, w = blocks_bf16.shape
    vals = torch.cat([blocks_bf16.transpose(0, 1).reshape(b, nb * blk, w),
                      ring], dim=1)
    lengths = torch.full((b,), int(length), dtype=torch.int32,
                         device=ring.device)
    return vals, _stream_ok(lengths, nb, blk, window)


def _fixed_partials(q, blocks_bf16, ring, length: int, window: int, kv_idx,
                    scale, softcap):
    vals, ok = fixed_stream(blocks_bf16, ring, length, window)
    return _attend_partials(q, vals, ok, kv_idx, scale, softcap)


def decode_attend_ref(q, blocks_bf16, ring, length: int, *, kv_idx, scale,
                      softcap=None, window=WINDOW_NONE):
    """Oracle for ``decode_attend`` (fixed-batch store) on DEcompressed
    blocks: q (B,H,hd); blocks (nblk,B,blk,W) bf16; ring (B,blk,W);
    ``length`` tokens of every sequence.  Returns normalised (B,H,hd) f32."""
    out, _, l = _fixed_partials(q, blocks_bf16, ring, length, window, kv_idx,
                                scale, softcap)
    return out / l.clamp(min=1e-30)[..., None]


def decode_attend_plain(q, signman, planes, dicts, esc_pos, esc_raw,
                        raw_blocks, ring, length, window: int, *, k: int,
                        kv_idx: Sequence[int], scale: float,
                        softcap: Optional[float] = None):
    """Plain ``decode_attend``: the kernel's arguments and its unnormalised
    (out, m, l) partials, computed by decompressing the store's live blocks
    (``core.fixed.decompress`` of each whole B-sequence block: one
    dictionary, escapes by position across the batch) and one masked
    softmax over [blocks ‖ ring].  ``length``: a host int or, as the
    kernel's device-length launch takes it, a 0-d int32 tensor (read here
    on the host)."""
    vals, ok = fixed_store_stream(signman, planes, dicts, esc_pos, esc_raw,
                                  raw_blocks, ring, int(length), window, k=k)
    return _attend_partials(q, vals, ok, kv_idx, scale, softcap)


def fixed_store_stream(signman, planes, dicts, esc_pos, esc_raw, raw_blocks,
                       ring, length: int, window: int, *, k: int):
    """The fixed-batch kernel's stream, gathered (``fixed_stream``) from
    its arguments: the store's live blocks decompressed, then the ring."""
    from repro_torch.core import fixed

    b, blk, w = ring.shape
    nb = int(length) // blk                       # live full blocks
    if nb == 0:
        blocks = ring.new_zeros((0, b, blk, w))
    elif signman is not None:
        blocks = fixed.decompress(fixed.Compressed(
            signman=signman[:nb], planes=planes[:nb], dict_syms=dicts[:nb],
            esc_pos=esc_pos[:nb], esc_raw=esc_raw[:nb],
            n_escapes=torch.zeros((nb,), dtype=torch.int32),
            shape=(b, blk, w), k=k))
    else:
        blocks = raw_blocks[:nb]
    return fixed_stream(blocks, ring, length, window)


# ---------------------------------------------------------------------------
# the kernels' split of the stream across CTAs, and their merge
# ---------------------------------------------------------------------------

def merge_split_partials(outs, ms, ls):
    """The kernels' in-kernel merge of per-split partials (leading split
    axis: outs (n, S, H, hd), ms and ls (n, S, H)), in split order:
    m = max m_i, out = sum out_i e^(m_i - m), l = sum l_i e^(m_i - m).  A
    split with m_i = NEG_INF is dead and adds nothing: its out_i is never
    read (the kernel never writes it)."""
    m = ms.max(0).values
    out = torch.zeros_like(outs[0])
    l = torch.zeros_like(ls[0])
    for o_i, m_i, l_i in zip(outs, ms, ls):
        live = m_i != NEG_INF
        w = torch.where(live, torch.exp(m_i - m), 0.0)
        out = out + torch.where(live[..., None], o_i * w[..., None], 0.0)
        l = l + torch.where(live, l_i * w, 0.0)
    return out, m, l


def split_partials_plain(q, vals, ok, span: int, *, kv_idx, scale,
                         softcap=None, first: int = 0,
                         nsplit: Optional[int] = None):
    """FlashDecoding on a gathered stream (``paged_stream``,
    ``fixed_stream``): the plain partials of each span of ``span``
    positions, spans first .. first + nsplit - 1 (default: every span of
    the stream), merged by :func:`merge_split_partials`.  Returns
    ((out, m, l), (outs, ms, ls)) with the splits' partials stacked."""
    t = vals.shape[1]
    if nsplit is None:
        nsplit = -(-t // span) - first
    pos = torch.arange(t, device=vals.device)
    parts = []
    for j in range(nsplit):
        lo = (first + j) * span
        in_span = (pos >= lo) & (pos < lo + span)
        parts.append(_attend_partials(q, vals, ok & in_span[None], kv_idx,
                                      scale, softcap))
    outs, ms, ls = (torch.stack(x) for x in zip(*parts))
    return merge_split_partials(outs, ms, ls), (outs, ms, ls)
