"""Compressed page transfer between serving replicas (ports
``repro/serve/transport.py``; pure host code, numpy, byte-compatible with
the reference).

A prefill replica exports each admitted sequence as a :class:`SequenceBlob`
-- the LEXI-FW-compressed full pages (byte-identical to its pool pages, see
``repro/models/cache.py:export_sequence`` for the WIRE FORMAT), the
partial-tail ring, the slot's length and its emitted tokens -- and ships
it through a :class:`PageTransport` to a decode replica, which scatters it
into its own pool (``serve.disagg``).

The transport meters every transfer twice, ``wire_bytes`` (what crossed:
compressed pages and dedup references) against ``raw_bytes`` (the
bf16-dense bytes of the same payload), and prices both through
``hw.noc.LinkModel``, so a serving run reports the paper's link-byte
reduction next to tokens/s.

**Content-addressed page dedup (receiver-side).**  Full pages are
immutable and content-deterministic, so the receiver of a link owns a
:class:`DigestStore` (digest -> payload, LRU-bounded) and the sender
queries its inventory before serializing: pages the receiver already
holds ship as 13-byte references (tag + sha256[:12]).  The codec-only
number is metered separately (``wire_bytes_nodedup``).  A reference
resolves to the byte-identical payload, or the import fails loudly.

**Streaming chunks.**  Full pages can stream ahead of the tail as
:func:`pack_chunk` frames, landing in the receiver's digest store (pinned
until the transfer completes); the closing blob then carries tag-1
references for every streamed page, so ``from_wire`` is also the
completeness check.

``LoopbackTransport`` keeps both replica kinds in one process;
``serve.net.client.SocketTransport`` carries the same bytes over TCP.
Both meter into the same :class:`TransportStats`.

A page payload is the concatenation of a page's compressed fields,
little-endian, C order:

    codec on : signman (N u8) ‖ planes (k*npad/32 u32) ‖ dict_syms (2^k u8)
               ‖ esc_pos (C i32) ‖ esc_raw (C u8)
    codec off: the raw page (block*w bf16)

Raw bf16 (raw pages, the ring) travels as ``uint16`` bits (``BF16``): the
reference falls back to the same dtype when no numpy bfloat16 is
installed, and the bytes are the same.  The port's pool keeps ``planes``
as int32; callers view them as ``uint32`` at this byte boundary.  Blobs
keep the reference's leading ``(tp, n_layers)`` axes, every rank's shard
of the sequence shard-major (``DisaggEngine(group=)`` at tp > 1), so that
the wire bytes match.  A hybrid's blob carries the SSM section: per
layer the slot's f32 recurrent state ``h`` and its bf16 conv rings (as
``uint16`` bits), raw, as the reference ships them; ``raw_bytes`` and the
wire bytes count it beside the pages.
"""

from __future__ import annotations

import dataclasses
import itertools
import struct
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.hw.noc import LinkModel, MeteredLink

from .digest import DIGEST_BYTES as _DIGEST_BYTES
from .digest import page_digest as _page_digest
from .telemetry import MetricsRegistry

BF16 = np.dtype(np.uint16)

MAGIC = b"LXSQ"
VERSION = 1
_FLAG_CODEC, _FLAG_KV, _FLAG_SSM = 1, 2, 4
_HDR = struct.Struct("<4sBBHHHHIHIIIiH")   # through n_emitted

CHUNK_MAGIC = b"LXPC"
_CHDR = struct.Struct("<4sBIH")            # magic, version, seq_id, entries
_CENT = struct.Struct("<HHHB")             # shard, layer, col, tag


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


# ---------------------------------------------------------------------------
# streaming page chunks
# ---------------------------------------------------------------------------


def pack_chunk(seq_id: int, entries: Sequence[Tuple[int, int, int, bytes]],
               known: Optional[Set[bytes]] = None
               ) -> Tuple[bytes, List[Tuple[bytes, bytes]], List[bytes]]:
    """Serialize one streaming page chunk.

    ``entries`` are ``(shard, layer, col, payload)`` for full pages that
    just became available; ``known`` are digests the receiver already holds
    (those ship as tag-1 references).  Returns ``(data, inline, refs)``
    like :meth:`SequenceBlob.to_wire`.  Chunk entries are self-describing
    (explicit payload length) so a receiver can parse them before it has
    seen any geometry header.
    """
    parts = [_CHDR.pack(CHUNK_MAGIC, VERSION, seq_id, len(entries))]
    inline: List[Tuple[bytes, bytes]] = []
    refs: List[bytes] = []
    known = set(known) if known is not None else None
    for t, l, c, payload in entries:
        digest = _page_digest(payload)
        if known is not None and digest in known:
            parts.append(_CENT.pack(t, l, c, 1) + digest)
            refs.append(digest)
        else:
            parts.append(_CENT.pack(t, l, c, 0) + digest
                         + struct.pack("<I", len(payload)) + payload)
            inline.append((digest, payload))
            if known is not None:
                known.add(digest)
    return b"".join(parts), inline, refs


def unpack_chunk(data: bytes
                 ) -> Tuple[int, List[Tuple[int, int, int, int, bytes,
                                            Optional[bytes]]]]:
    """Parse a streaming chunk; loud ``ValueError`` on bad magic/version,
    a truncated entry, or a corrupted payload length.  Returns
    ``(seq_id, [(shard, layer, col, tag, digest, payload-or-None)])``."""
    if len(data) < _CHDR.size:
        raise ValueError(f"truncated chunk header ({len(data)} bytes)")
    magic, version, seq_id, n_entries = _CHDR.unpack_from(data, 0)
    if magic != CHUNK_MAGIC:
        raise ValueError(f"bad chunk magic {magic!r}")
    if version != VERSION:
        raise ValueError(f"unsupported chunk version {version} "
                         f"(this codec speaks {VERSION})")
    off = _CHDR.size
    out = []
    for _ in range(n_entries):
        if off + _CENT.size + _DIGEST_BYTES > len(data):
            raise ValueError("truncated chunk entry")
        t, l, c, tag = _CENT.unpack_from(data, off)
        off += _CENT.size
        digest = data[off:off + _DIGEST_BYTES]
        off += _DIGEST_BYTES
        payload = None
        if tag == 0:
            if off + 4 > len(data):
                raise ValueError("truncated chunk payload length")
            (size,) = struct.unpack_from("<I", data, off)
            off += 4
            if off + size > len(data):
                raise ValueError(
                    f"corrupted chunk payload length {size} overruns the "
                    f"frame ({len(data) - off} bytes left)")
            payload = data[off:off + size]
            off += size
        elif tag != 1:
            raise ValueError(f"unknown chunk entry tag {tag}")
        out.append((t, l, c, tag, digest, payload))
    if off != len(data):
        raise ValueError(f"{len(data) - off} trailing bytes after the last "
                         f"chunk entry")
    return seq_id, out


@dataclasses.dataclass
class SequenceBlob:
    """One admitted sequence's transferable cache state (host arrays).

    Array layout is per-shard, shard-major: every array carries a leading
    ``(tp, n_layers)`` axis pair, as the reference's stacked per-shard
    views (at tp > 1 each rank's shard, gathered from the ranks).  Raw
    bf16 arrays (``ring``, ``raw_pages``) are ``BF16`` bits.  ``kv`` is
    None for attention-free configs, ``ssm`` for attention-only ones.  See
    ``repro/models/cache.py:export_sequence`` for the byte-level WIRE FORMAT
    this serializes to.  In streaming mode, page payloads travel ahead of
    the blob as :func:`pack_chunk` frames and the blob's page section
    carries tag-1 references to them (the receiver resolves them from its
    digest store, where the chunks landed).
    """
    codec_on: bool
    tp: int
    n_layers: int
    n_cols: int
    blk: int
    w: int
    k: int
    esc_cap: int
    npad: int
    length: int
    cur_token: int
    emitted: List[int]
    kv: Optional[Dict[str, np.ndarray]]     # field name -> (tp, L, ...) array
    ssm: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]

    # -- geometry ----------------------------------------------------------

    def valid_cols(self, shard: int) -> int:
        """Full pages shard ``shard`` contributed (host mirror of
        ``cache.local_full_pages``)."""
        if self.length <= 0:
            return 0
        loc = max((self.length - 1 - shard) // self.tp + 1, 0)
        return loc // self.blk

    @property
    def n_valid_pages(self) -> int:
        return sum(self.valid_cols(t) for t in range(self.tp)) * self.n_layers

    @property
    def raw_bytes(self) -> int:
        """bf16-dense bytes of the same payload — the uncompressed-transfer
        baseline the link metering divides by (pages at 2 B/value + the
        ring rows + the SSM state at its native width)."""
        n = 0
        if self.kv is not None:
            n += self.n_valid_pages * self.blk * self.w * 2
            n += self.kv["ring"].nbytes
        if self.ssm is not None:
            n += sum(a.nbytes for a in self.ssm)
        return n

    # -- page payload extraction ------------------------------------------

    def _page_payload(self, t: int, l: int, c: int) -> bytes:
        return page_payload(self.kv, self.codec_on, t, l, c)

    def page_entries(self) -> Iterator[Tuple[int, int, int, bytes]]:
        """(shard, layer, col, payload) for every VALID page, in wire
        order (shard-major, then layer, then column)."""
        for t in range(self.tp):
            for l in range(self.n_layers):
                for c in range(self.valid_cols(t)):
                    yield t, l, c, self._page_payload(t, l, c)

    # -- serialization -----------------------------------------------------

    def to_wire(self, known: Optional[Set[bytes]] = None
                ) -> Tuple[bytes, List[Tuple[bytes, bytes]], List[bytes]]:
        """Serialize to the version-1 wire format.

        ``known``: digests the receiver already holds — matching pages ship
        as 13-byte references instead of payloads.  Returns ``(data,
        inline, refs)`` where ``inline`` lists the (digest, payload) pairs
        that crossed in full (the sender adds them to its picture of the
        receiver's store after a successful send) and ``refs`` the digests
        that shipped as references.
        """
        flags = ((_FLAG_CODEC if self.codec_on else 0)
                 | (_FLAG_KV if self.kv is not None else 0)
                 | (_FLAG_SSM if self.ssm is not None else 0))
        parts = [_HDR.pack(MAGIC, VERSION, flags, self.tp, self.n_layers,
                           self.n_cols, self.blk, self.w, self.k,
                           self.esc_cap, self.npad, self.length,
                           self.cur_token, len(self.emitted))]
        parts.append(np.asarray(self.emitted, np.int32).tobytes())
        if self.ssm is not None:
            h, cx, cbc = self.ssm
            nh_loc, hd, nst = h.shape[2:]
            parts.append(struct.pack("<HHHHI", nh_loc, hd, nst,
                                     cx.shape[2], cx.shape[3]))
            parts += [h.tobytes(), cx.tobytes(), cbc.tobytes()]
        if self.kv is not None:
            parts.append(self.kv["ring"].tobytes())
        inline: List[Tuple[bytes, bytes]] = []
        refs: List[bytes] = []
        if self.kv is not None:
            known = set(known) if known is not None else None
            for _, _, _, payload in self.page_entries():
                digest = _page_digest(payload)
                if known is not None and digest in known:
                    parts.append(b"\x01" + digest)
                    refs.append(digest)
                else:
                    parts.append(b"\x00" + digest + payload)
                    inline.append((digest, payload))
                    if known is not None:
                        known.add(digest)          # dedupe within one blob
        return b"".join(parts), inline, refs

    @classmethod
    def from_wire(cls, data: bytes,
                  store: Optional["DigestStore"] = None
                  ) -> "SequenceBlob":
        """Parse a version-1 wire blob.  ``store`` resolves tag-1 page
        references (content digest -> payload; a plain dict works too); an
        unknown digest or a version/magic mismatch raises ``ValueError``
        before any state is touched."""
        if len(data) < _HDR.size:
            raise ValueError(f"truncated wire header ({len(data)} bytes)")
        (magic, version, flags, tp, n_layers, n_cols, blk, w, k, esc_cap,
         npad, length, cur_token, n_emitted) = _HDR.unpack_from(data, 0)
        if magic != MAGIC:
            raise ValueError(f"bad wire magic {magic!r}")
        if version != VERSION:
            raise ValueError(f"unsupported wire version {version} "
                             f"(this codec speaks {VERSION})")
        off = _HDR.size
        codec_on = bool(flags & _FLAG_CODEC)
        emitted = np.frombuffer(data, np.int32, n_emitted, off).tolist()
        off += 4 * n_emitted

        def rd(dtype, shape):
            nonlocal off
            dt = np.dtype(dtype)
            n = int(np.prod(shape))
            if off + n * dt.itemsize > len(data):
                raise ValueError(
                    f"truncated wire section at offset {off}: need "
                    f"{n * dt.itemsize} bytes, {len(data) - off} left")
            a = np.frombuffer(data, dt, n, off).reshape(shape).copy()
            off += n * dt.itemsize
            return a

        ssm = None
        if flags & _FLAG_SSM:
            nh_loc, hd, nst, kc, di_loc = struct.unpack_from("<HHHHI",
                                                             data, off)
            off += struct.calcsize("<HHHHI")
            ssm = (rd(np.float32, (tp, n_layers, nh_loc, hd, nst)),
                   rd(BF16, (tp, n_layers, kc, di_loc)),
                   rd(BF16, (tp, n_layers, kc, 2 * nst)))

        kv = None
        if flags & _FLAG_KV:
            ring = rd(BF16, (tp, n_layers, blk, w))
            kv = empty_page_fields(codec_on, tp, n_layers, n_cols, blk, w,
                                   k, esc_cap, npad)
            kv["ring"] = ring
            blob = cls(codec_on=codec_on, tp=tp, n_layers=n_layers,
                       n_cols=n_cols, blk=blk, w=w, k=k, esc_cap=esc_cap,
                       npad=npad, length=length, cur_token=cur_token,
                       emitted=emitted, kv=kv, ssm=ssm)
            size = blob._payload_size()
            for t in range(tp):
                for l in range(n_layers):
                    for c in range(blob.valid_cols(t)):
                        if off + 1 + _DIGEST_BYTES > len(data):
                            raise ValueError(
                                f"truncated page entry (shard {t}, layer "
                                f"{l}, col {c})")
                        tag = data[off]
                        digest = data[off + 1:off + 1 + _DIGEST_BYTES]
                        off += 1 + _DIGEST_BYTES
                        if tag == 1:
                            if store is None or digest not in store:
                                raise ValueError(
                                    "unknown page digest on wire — the "
                                    "receiver's content store is missing "
                                    f"{digest.hex()} (shard {t}, layer {l},"
                                    f" col {c})")
                            payload = store[digest]
                        else:
                            if off + size > len(data):
                                raise ValueError(
                                    f"truncated page payload (shard {t}, "
                                    f"layer {l}, col {c}): need {size} "
                                    f"bytes, {len(data) - off} left")
                            payload = data[off:off + size]
                            off += size
                            if store is not None:
                                store[digest] = payload
                        blob._scatter_payload(t, l, c, payload)
            return blob
        return cls(codec_on=codec_on, tp=tp, n_layers=n_layers,
                   n_cols=n_cols, blk=blk, w=w, k=k, esc_cap=esc_cap,
                   npad=npad, length=length, cur_token=cur_token,
                   emitted=emitted, kv=None, ssm=ssm)

    def _payload_size(self) -> int:
        return payload_nbytes(self.codec_on, self.blk, self.w, self.k,
                              self.esc_cap, self.npad)

    def _scatter_payload(self, t: int, l: int, c: int,
                         payload: bytes) -> None:
        scatter_page_payload(self.kv, self.codec_on, t, l, c, payload,
                             blk=self.blk, w=self.w, k=self.k,
                             esc_cap=self.esc_cap, npad=self.npad)


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
        if _page_digest(payload) != digest:
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


@dataclasses.dataclass
class TransportStats:
    """Cumulative link accounting across transfers (one link / direction).

    Since the telemetry refactor this is a *view*: every field is backed
    by a ``transport.*`` / ``link.*`` counter in the transport's
    :class:`~repro_torch.serve.telemetry.MetricsRegistry` (see
    :meth:`from_registry`); ``PageTransport.stats`` materializes it on
    read, so the field names every test and bench row keys on are
    unchanged while the counters themselves live in the unified
    namespace.

    ``wire_bytes`` counts the data plane only — streaming chunks plus the
    closing wire blobs; a socket transport's control frames (hello,
    inventory, acks) are not metered, matching the loopback baseline."""
    n_transfers: int = 0
    wire_bytes: int = 0          # bytes that actually crossed (with dedup)
    wire_bytes_nodedup: int = 0  # same transfers, dedup disabled (codec only)
    raw_bytes: int = 0           # bf16-dense bytes of the same payloads
    pages_inline: int = 0        # page payloads shipped in full (incl. chunks)
    pages_ref: int = 0           # pages replaced by content references
    pages_streamed: int = 0      # inline payloads that went ahead in chunks
    stream_chunk_bytes: int = 0  # bytes of those chunk frames
    pages_resent: int = 0        # inline payloads re-sent after receiver
                                 # eviction (the store forgot them)
    store_evicted: int = 0       # receiver-store pages dropped by LRU trim
    pages_fetched: int = 0       # payloads pulled BACK by digest (FETCH —
                                 # the remote tier of the PageCache)
    fetch_bytes: int = 0         # bytes of those fetched payloads
    model_ns: float = 0.0        # LinkModel latency of the wire bytes
    model_ns_raw: float = 0.0    # LinkModel latency of the raw baseline

    @property
    def reduction(self) -> float:
        """Fractional link-byte reduction vs the bf16-dense transfer —
        the serving-stack analogue of the paper's Table 3 column."""
        return 1.0 - self.wire_bytes / max(self.raw_bytes, 1)

    @classmethod
    def from_registry(cls, reg: MetricsRegistry) -> "TransportStats":
        v = reg.value
        return cls(
            n_transfers=v("transport.transfers"),
            wire_bytes=v("transport.wire_bytes"),
            wire_bytes_nodedup=v("transport.wire_bytes_nodedup"),
            raw_bytes=v("transport.raw_bytes"),
            pages_inline=v("transport.pages_inline"),
            pages_ref=v("transport.pages_ref"),
            pages_streamed=v("transport.pages_streamed"),
            stream_chunk_bytes=v("transport.stream_chunk_bytes"),
            pages_resent=v("transport.pages_resent"),
            store_evicted=v("transport.store_evicted"),
            pages_fetched=v("transport.pages_fetched"),
            fetch_bytes=v("transport.fetch_bytes"),
            model_ns=float(v("link.model_ns")),
            model_ns_raw=float(v("link.model_ns_raw")))


class PageTransport:
    """Interface of the prefill→decode handoff link.

    ``send`` serializes (and meters) a blob for a destination; ``recv``
    reconstructs it on the destination side; ``stream_pages`` ships full
    pages ahead of the tail (``new_stream`` mints the transfer id,
    ``abort_stream`` cancels one whose sequence never transferred).
    Implementations own (or speak to) the per-destination
    :class:`DigestStore` that backs page dedup, and expose its
    ``inventory`` so senders ship only unknown digests.  In-process:
    :class:`LoopbackTransport`; across OS processes:
    ``repro_torch.serve.net.client.SocketTransport`` (same WIRE FORMAT, framed
    over TCP — see ``repro_torch.serve.net.framing``).
    """

    def __init__(self):
        # every byte/latency counter lives here (transport.* / link.*);
        # ``stats`` below is the compatibility view over it
        self.registry = MetricsRegistry()
        self._seq_ids = itertools.count(1)
        self._ever_sent: Dict[str, Set[bytes]] = {}

    @property
    def stats(self) -> TransportStats:
        return TransportStats.from_registry(self.registry)

    def new_stream(self) -> int:
        """Mint a transfer id for a streamed sequence."""
        return next(self._seq_ids)

    def _count_resent(self, dst: str,
                      inline: List[Tuple[bytes, bytes]]) -> None:
        """Meter inline payloads this link already shipped once: a repeat
        means the receiver's store evicted them (``pages_resent``)."""
        seen = self._ever_sent.setdefault(dst, set())
        resent = self.registry.counter("transport.pages_resent")
        for digest, _ in inline:
            if digest in seen:
                resent.inc()
            seen.add(digest)

    def inventory(self, dst: str) -> Set[bytes]:
        """Digests the receiver behind ``dst`` currently holds."""
        raise NotImplementedError

    def stream_pages(self, dst: str, seq_id: int,
                     entries: Sequence[Tuple[int, int, int, bytes]]) -> None:
        raise NotImplementedError

    def abort_stream(self, dst: str, seq_id: int) -> None:
        raise NotImplementedError

    def send(self, blob: SequenceBlob, dst: str,
             seq_id: Optional[int] = None) -> bytes:
        raise NotImplementedError

    def recv(self, data: bytes, dst: str,
             seq_id: Optional[int] = None) -> SequenceBlob:
        raise NotImplementedError

    def fetch(self, dst: str,
              digests: Sequence[bytes]) -> Dict[bytes, bytes]:
        """Remote tier: pull page payloads back OUT of ``dst``'s store by
        content digest (the reverse direction of ``send``).  Returns the
        subset found — a missing digest is not an error, the caller falls
        back to its next tier (ultimately re-prefill)."""
        raise NotImplementedError


class LoopbackTransport(PageTransport):
    """In-process transport: full serialize → bytes → parse round trip (so
    the byte format is exercised on every handoff), with receiver-side
    content-addressed page dedup and LinkModel metering.

    ``dedup=False`` ships every page inline (the codec-only baseline).
    ``hops`` positions the prefill and decode replicas on the chiplet mesh
    for the latency model.  Each destination owns a :class:`DigestStore`
    bounded at ``max_store_pages`` (LRU; in-flight streams are pinned).
    Loopback contract: ``recv`` a wire blob before the next ``send`` to the
    same destination — the store is only trimmed at ``recv``/abort
    boundaries, so references never dangle mid-transfer.
    """

    def __init__(self, dedup: bool = True, hops: int = 2,
                 link: Optional[LinkModel] = None,
                 max_store_pages: int = 4096):
        super().__init__()
        self.dedup = dedup
        self.hops = hops
        self.link = link if link is not None else LinkModel()
        # actual traffic is priced through the meter (-> link.bytes /
        # link.model_ns); the bare ``self.link`` stays for hypothetical
        # baselines (model_ns_raw) so they never pollute link bytes
        self._meter = MeteredLink(self.link, self.registry)
        self.max_store_pages = max_store_pages
        self._stores: Dict[str, DigestStore] = {}

    def store(self, dst: str) -> DigestStore:
        return self._stores.setdefault(dst,
                                       DigestStore(self.max_store_pages))

    def inventory(self, dst: str) -> Set[bytes]:
        return self.store(dst).digests()

    def stream_pages(self, dst, seq_id, entries) -> None:
        store = self.store(dst)
        known = store.digests() if self.dedup else None
        data, inline, refs = pack_chunk(seq_id, entries, known)
        if self.dedup:
            self._count_resent(dst, inline)
        reg = self.registry
        reg.counter("transport.stream_chunk_bytes").inc(len(data))
        reg.counter("transport.wire_bytes").inc(len(data))
        reg.counter("transport.pages_streamed").inc(len(inline))
        reg.counter("transport.pages_inline").inc(len(inline))
        reg.counter("transport.pages_ref").inc(len(refs))
        self._meter.transfer_ns(len(data), self.hops)
        for digest, payload in inline:
            store[digest] = payload
        for digest in itertools.chain((d for d, _ in inline), refs):
            store.pin(seq_id, digest)

    def abort_stream(self, dst, seq_id) -> None:
        store = self.store(dst)
        store.release(seq_id)
        self.registry.counter("transport.store_evicted").inc(store.trim())

    def send(self, blob: SequenceBlob, dst: str,
             seq_id: Optional[int] = None) -> bytes:
        store = self.store(dst)
        known = store.digests() if self.dedup else None
        data, inline, refs = blob.to_wire(known)
        if self.dedup:
            self._count_resent(dst, inline)
        # a ref entry is the inline entry minus its payload, so the
        # dedup-off size is pure arithmetic — no second serialization
        nodedup_len = len(data) + len(refs) * blob._payload_size()
        reg = self.registry
        reg.counter("transport.transfers").inc()
        reg.counter("transport.wire_bytes").inc(len(data))
        reg.counter("transport.wire_bytes_nodedup").inc(nodedup_len)
        reg.counter("transport.raw_bytes").inc(blob.raw_bytes)
        reg.counter("transport.pages_inline").inc(len(inline))
        reg.counter("transport.pages_ref").inc(len(refs))
        self._meter.transfer_ns(len(data), self.hops)
        reg.counter("link.model_ns_raw").inc(
            self.link.transfer_ns(blob.raw_bytes, self.hops))
        if self.dedup:
            for digest, payload in inline:
                store[digest] = payload
        return data

    def recv(self, data: bytes, dst: str,
             seq_id: Optional[int] = None) -> SequenceBlob:
        # the loopback receiver shares the sender-maintained store (same
        # host); a remote receiver maintains its own from inline payloads
        store = self.store(dst)
        blob = SequenceBlob.from_wire(data, store if self.dedup else None)
        if seq_id is not None:
            store.release(seq_id)
        self.registry.counter("transport.store_evicted").inc(store.trim())
        return blob

    def fetch(self, dst: str,
              digests: Sequence[bytes]) -> Dict[bytes, bytes]:
        store = self.store(dst)
        out = {d: store[d] for d in digests if d in store}
        nbytes = sum(len(p) for p in out.values())
        reg = self.registry
        reg.counter("transport.pages_fetched").inc(len(out))
        reg.counter("transport.fetch_bytes").inc(nbytes)
        self._meter.transfer_ns(nbytes, self.hops)
        return out
