"""The page-payload half of ``repro/serve/transport.py``: one immutable
page's wire payload, its inverse, and the content-addressed
``DigestStore`` that the tiered ``PageCache`` spills into.  Pure host
code (numpy), byte-compatible with the reference.

A page payload is the concatenation of a page's compressed fields,
little-endian, C order (the page section of the WIRE FORMAT that
``repro/models/cache.py:export_sequence`` specifies):

    codec on : signman (N u8) ‖ planes (k*npad/32 u32) ‖ dict_syms (2^k u8)
               ‖ esc_pos (C i32) ‖ esc_raw (C u8)
    codec off: the raw page (block*w bf16)

Raw bf16 travels as ``uint16`` bits (``BF16``): the reference falls back
to the same dtype when no numpy bfloat16 is installed, and the bytes are
the same.  The port's pool keeps ``planes`` as int32; callers view them
as ``uint32`` at this byte boundary.

Not ported yet (they wait for disaggregated serving): ``SequenceBlob``
and its framing, the streaming chunks, ``PageTransport`` and its link
metering (``repro/hw/noc.py``, ``telemetry.MetricsRegistry``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Set

import numpy as np

from .digest import page_digest

BF16 = np.dtype(np.uint16)


def page_payload(kv: Dict[str, np.ndarray], codec_on: bool,
                 t: int, l: int, c: int) -> bytes:
    """One page's wire payload from a ``(tp, L, cols, ...)`` field dict."""
    if codec_on:
        return b"".join((
            kv["signman"][t, l, c].tobytes(),
            kv["planes"][t, l, c].tobytes(),
            kv["dict_syms"][t, l, c].tobytes(),
            kv["esc_pos"][t, l, c].tobytes(),
            kv["esc_raw"][t, l, c].tobytes()))
    return kv["raw_pages"][t, l, c].tobytes()


def payload_nbytes(codec_on: bool, blk: int, w: int, k: int,
                   esc_cap: int, npad: int) -> int:
    """Byte size of one page payload under the given codec geometry."""
    n = blk * w
    if not codec_on:
        return n * 2
    return (n + k * (npad // 32) * 4 + (1 << k) + esc_cap * 4 + esc_cap)


def empty_page_fields(codec_on: bool, tp: int, n_layers: int, n_cols: int,
                      blk: int, w: int, k: int, esc_cap: int,
                      npad: int) -> Dict[str, np.ndarray]:
    """Zeroed ``(tp, L, cols, ...)`` field arrays for ``n_cols`` page
    columns (the host-side shape :func:`scatter_page_payload` fills)."""
    n = blk * w
    if codec_on:
        return {
            "signman": np.zeros((tp, n_layers, n_cols, n), np.uint8),
            "planes": np.zeros((tp, n_layers, n_cols, k, npad // 32),
                               np.uint32),
            "dict_syms": np.zeros((tp, n_layers, n_cols, 1 << k), np.uint8),
            "esc_pos": np.zeros((tp, n_layers, n_cols, esc_cap), np.int32),
            "esc_raw": np.zeros((tp, n_layers, n_cols, esc_cap), np.uint8),
        }
    return {"raw_pages": np.zeros((tp, n_layers, n_cols, blk, w), BF16)}


def scatter_page_payload(kv: Dict[str, np.ndarray], codec_on: bool,
                         t: int, l: int, c: int, payload: bytes, *,
                         blk: int, w: int, k: int, esc_cap: int,
                         npad: int) -> None:
    """Inverse of :func:`page_payload`: split one payload back into the
    ``(tp, L, cols, ...)`` field dict at ``[t, l, c]``.  Loud on a length
    mismatch: a payload that does not fit the geometry never lands."""
    size = payload_nbytes(codec_on, blk, w, k, esc_cap, npad)
    if len(payload) != size:
        raise ValueError(
            f"page payload is {len(payload)} bytes, geometry says "
            f"{size} (shard {t}, layer {l}, col {c})")
    if not codec_on:
        kv["raw_pages"][t, l, c] = np.frombuffer(
            payload, BF16).reshape(blk, w)
        return
    n = blk * w
    o = 0
    kv["signman"][t, l, c] = np.frombuffer(payload, np.uint8, n, o)
    o += n
    npl = k * (npad // 32)
    kv["planes"][t, l, c] = np.frombuffer(
        payload, np.uint32, npl, o).reshape(k, npad // 32)
    o += npl * 4
    nd = 1 << k
    kv["dict_syms"][t, l, c] = np.frombuffer(payload, np.uint8, nd, o)
    o += nd
    kv["esc_pos"][t, l, c] = np.frombuffer(payload, np.int32, esc_cap, o)
    o += esc_cap * 4
    kv["esc_raw"][t, l, c] = np.frombuffer(payload, np.uint8, esc_cap, o)


class DigestStore:
    """Content-addressed page store: digest -> payload, LRU-bounded with
    pinning.

    Every insert is verified against its digest, so a corrupted payload
    fails loudly at ingest.  Eviction is explicit: :meth:`trim` drops
    least-recently-used entries down to ``max_pages``, skipping pinned
    ones (:meth:`pin` / :meth:`release` per transfer), so the store may
    overshoot its bound while pins are held.
    """

    def __init__(self, max_pages: int = 4096):
        if max_pages < 1:
            raise ValueError("max_pages must be >= 1")
        self.max_pages = max_pages
        self._lru: "OrderedDict[bytes, bytes]" = OrderedDict()
        self._pins: Dict[int, Set[bytes]] = {}
        self._pin_count: Dict[bytes, int] = {}
        self.n_inserted = 0
        self.n_evicted = 0
        self.n_hits = 0

    def __len__(self) -> int:
        return len(self._lru)

    def __contains__(self, digest: bytes) -> bool:
        return digest in self._lru

    def __getitem__(self, digest: bytes) -> bytes:
        payload = self._lru[digest]
        self._lru.move_to_end(digest)
        self.n_hits += 1
        return payload

    def __setitem__(self, digest: bytes, payload: bytes) -> None:
        if page_digest(payload) != digest:
            raise ValueError(
                f"payload does not hash to its digest {digest.hex()} — "
                "corrupted page on the wire")
        if digest in self._lru:
            self._lru.move_to_end(digest)
            return
        self._lru[digest] = payload
        self.n_inserted += 1

    def digests(self) -> Set[bytes]:
        """The inventory a sender dedups against."""
        return set(self._lru)

    def pin(self, seq_id: int, digest: bytes) -> None:
        """Protect ``digest`` from eviction until transfer ``seq_id``
        completes (:meth:`release`)."""
        pins = self._pins.setdefault(seq_id, set())
        if digest not in pins:
            pins.add(digest)
            self._pin_count[digest] = self._pin_count.get(digest, 0) + 1

    def release(self, seq_id: int) -> None:
        for digest in self._pins.pop(seq_id, ()):  # absent seq is a no-op
            n = self._pin_count[digest] - 1
            if n:
                self._pin_count[digest] = n
            else:
                del self._pin_count[digest]

    def trim(self) -> int:
        """Evict LRU entries (skipping pinned) down to ``max_pages``;
        returns how many were dropped."""
        evicted = 0
        if len(self._lru) > self.max_pages:
            for digest in list(self._lru):
                if len(self._lru) <= self.max_pages:
                    break
                if digest in self._pin_count:
                    continue
                del self._lru[digest]
                evicted += 1
        self.n_evicted += evicted
        return evicted
