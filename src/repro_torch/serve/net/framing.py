"""Socket framing + control protocol for multi-process page transport (a
copy of ``repro/serve/net/framing.py``, its imports pointed at the
port's ``transport``).

Everything that crosses a
:class:`~repro_torch.serve.net.client.SocketTransport` connection is a
length-prefixed FRAME:

    length  u32   bytes of (type + payload); bounded by ``MAX_FRAME``
    type    u8    one of the ``MSG_*`` constants below
    payload       type-specific bytes

Truncation is LOUD: a socket that closes mid-frame (or a length field
pointing past ``MAX_FRAME``) raises :class:`FrameError` — never a partial
parse.  The data plane rides three payload formats defined elsewhere
(``repro_torch.serve.transport``): streaming page chunks
(``pack_chunk``), the closing
:class:`~repro_torch.serve.transport.SequenceBlob` wire bytes, and raw
digest lists; control payloads are small JSON objects.

Control protocol (client = the prefill/driver side, server = the decode
host; every request frame gets exactly one response frame):

    HELLO         → HELLO_OK | ERROR     version + config negotiation: the
                                         hello carries the protocol magic/
                                         version, the blob WIRE version,
                                         and a 16-byte config fingerprint
                                         (``config_fingerprint``); any
                                         mismatch kills the session before
                                         a single page moves.
    INVENTORY_REQ → INVENTORY            the receiver's digest-store
                                         inventory; the sender ships only
                                         digests the receiver lacks.
    PAGE_CHUNK    → CHUNK_OK | ERROR     streamed full pages, landing in
                                         the receiver's digest store and
                                         pinned to their transfer id.
    ABORT         → ABORT_OK             a streamed transfer whose sequence
                                         finished at admission: unpin.
    SEQ           → SEQ_OK | ERROR       request metadata + the closing
                                         blob; the server imports it into
                                         a decode slot (all failures leave
                                         the pool untouched).
    STEP          → RESULTS              run one fused decode window,
                                         return newly finished requests.
    STATUS_REQ    → STATUS               free slots / live slots / store
                                         occupancy + capacity / decode and
                                         PageCache counters (routing +
                                         stats).
    FETCH         → FETCH_OK             pull pages back OUT of the host's
                                         digest store by content digest —
                                         the remote tier of the tiered
                                         PageCache (a replica restores a
                                         spilled prefix column from a peer
                                         instead of re-prefilling).
                                         Request: a digest list
                                         (``pack_inventory``); reply: the
                                         subset held, digest + payload
                                         (``pack_pages``) — a missing
                                         digest is not an error.
    METRICS_REQ   → METRICS              versioned metrics-registry
                                         snapshot of the host replica's
                                         engine (JSON;
                                         ``repro_torch.serve.telemetry.
                                         MetricsRegistry.snapshot`` —
                                         the driver folds per-replica
                                         snapshots into fleet totals
                                         with ``MetricsRegistry.merge``).
    BYE           → BYE_OK               orderly session end.
"""

from __future__ import annotations

import hashlib
import json
import socket
import struct
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from ..transport import VERSION as WIRE_VERSION
from ..transport import _DIGEST_BYTES

PROTO_MAGIC = b"LXNT"
PROTO_VERSION = 1
MAX_FRAME = 1 << 28              # 256 MiB: far above any real blob here
_FINGERPRINT_BYTES = 16

_FRAME_HDR = struct.Struct("<IB")           # length (type+payload), type
_HELLO = struct.Struct("<4sHB16s")          # magic, proto, wire, fingerprint

(MSG_HELLO, MSG_HELLO_OK, MSG_ERROR, MSG_INVENTORY_REQ, MSG_INVENTORY,
 MSG_PAGE_CHUNK, MSG_CHUNK_OK, MSG_ABORT, MSG_ABORT_OK, MSG_SEQ,
 MSG_SEQ_OK, MSG_STEP, MSG_RESULTS, MSG_STATUS_REQ, MSG_STATUS,
 MSG_BYE, MSG_BYE_OK, MSG_FETCH, MSG_FETCH_OK,
 MSG_METRICS_REQ, MSG_METRICS) = range(1, 22)


class FrameError(ConnectionError):
    """A frame could not be read/validated: truncation mid-frame, an
    oversized or negative length, or an unexpected message type."""


def send_frame(sock: socket.socket, msg_type: int,
               payload: bytes = b"") -> None:
    if len(payload) + 1 > MAX_FRAME:
        raise FrameError(f"frame of {len(payload)} bytes exceeds "
                         f"MAX_FRAME={MAX_FRAME}")
    sock.sendall(_FRAME_HDR.pack(len(payload) + 1, msg_type) + payload)


def recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes; loud on EOF mid-read."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise FrameError(
                f"connection closed mid-frame ({got}/{n} bytes read)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_frame(sock: socket.socket) -> Tuple[int, bytes]:
    hdr = recv_exact(sock, _FRAME_HDR.size)
    length, msg_type = _FRAME_HDR.unpack(hdr)
    if length < 1 or length > MAX_FRAME:
        raise FrameError(f"bad frame length {length} (corrupted stream?)")
    payload = recv_exact(sock, length - 1)
    return msg_type, payload


# -- hello / negotiation ----------------------------------------------------


def config_fingerprint(cfg, codec, tp: int, n_slots: int, max_len: int,
                       seed: int, eos_id: Optional[int] = None,
                       stop_seqs=None) -> bytes:
    """16-byte digest of everything both processes must agree on for
    byte-identical streams: the model config, the codec config, the
    parallel/pool geometry, the param seed, the engine-level termination
    defaults (eos / stop sequences — per-request overrides travel in the
    SEQ metadata instead), and the blob wire version.  Dataclass ``repr``
    is deterministic, so both sides compute this from their own
    constructed objects."""
    stops = (tuple(tuple(int(t) for t in s) for s in stop_seqs)
             if stop_seqs else ())
    canon = (f"{cfg!r}|{codec!r}|tp={tp}|slots={n_slots}"
             f"|max_len={max_len}|seed={seed}|eos={eos_id}|stops={stops!r}"
             f"|wire={WIRE_VERSION}")
    return hashlib.sha256(canon.encode()).digest()[:_FINGERPRINT_BYTES]


def pack_hello(fingerprint: bytes) -> bytes:
    return _HELLO.pack(PROTO_MAGIC, PROTO_VERSION, WIRE_VERSION,
                       fingerprint)


def unpack_hello(payload: bytes) -> bytes:
    """Validate a hello payload; returns the peer's config fingerprint.
    Magic / protocol-version / wire-version mismatches raise — the caller
    compares the fingerprint itself (so the error can say which side)."""
    if len(payload) != _HELLO.size:
        raise FrameError(f"hello payload is {len(payload)} bytes, "
                         f"expected {_HELLO.size}")
    magic, proto, wire, fingerprint = _HELLO.unpack(payload)
    if magic != PROTO_MAGIC:
        raise FrameError(f"bad protocol magic {magic!r}")
    if proto != PROTO_VERSION:
        raise FrameError(f"peer speaks protocol v{proto}, "
                         f"this side v{PROTO_VERSION}")
    if wire != WIRE_VERSION:
        raise FrameError(f"peer ships wire-format v{wire}, "
                         f"this side v{WIRE_VERSION}")
    return fingerprint


# -- control payloads -------------------------------------------------------


def pack_inventory(digests: Set[bytes]) -> bytes:
    return struct.pack("<I", len(digests)) + b"".join(sorted(digests))


def unpack_inventory(payload: bytes) -> Set[bytes]:
    (n,) = struct.unpack_from("<I", payload, 0)
    if len(payload) != 4 + n * _DIGEST_BYTES:
        raise FrameError(f"inventory of {n} digests is "
                         f"{len(payload) - 4} bytes")
    return {payload[4 + i * _DIGEST_BYTES:4 + (i + 1) * _DIGEST_BYTES]
            for i in range(n)}


def pack_pages(pages: Dict[bytes, bytes]) -> bytes:
    """FETCH_OK payload: the subset of requested pages the store holds —
    u32 count, then per page (sorted by digest) the digest, a u32 payload
    length and the payload bytes."""
    out = [struct.pack("<I", len(pages))]
    for digest in sorted(pages):
        body = pages[digest]
        out.append(digest + struct.pack("<I", len(body)) + body)
    return b"".join(out)


def unpack_pages(payload: bytes) -> Dict[bytes, bytes]:
    (n,) = struct.unpack_from("<I", payload, 0)
    off = 4
    pages: Dict[bytes, bytes] = {}
    for _ in range(n):
        if off + _DIGEST_BYTES + 4 > len(payload):
            raise FrameError("page list overruns the frame")
        digest = payload[off:off + _DIGEST_BYTES]
        (ln,) = struct.unpack_from("<I", payload, off + _DIGEST_BYTES)
        off += _DIGEST_BYTES + 4
        if off + ln > len(payload):
            raise FrameError(f"page payload of {ln} bytes overruns "
                             "the frame")
        pages[digest] = payload[off:off + ln]
        off += ln
    if off != len(payload):
        raise FrameError(f"{len(payload) - off} trailing bytes after "
                         f"{n} pages")
    return pages


def pack_json(obj: Any) -> bytes:
    return json.dumps(obj).encode()


def unpack_json(payload: bytes) -> Any:
    return json.loads(payload.decode())


def pack_seq(meta: Dict[str, Any], blob_bytes: bytes) -> bytes:
    meta_b = pack_json(meta)
    return struct.pack("<I", len(meta_b)) + meta_b + blob_bytes


def unpack_seq(payload: bytes) -> Tuple[Dict[str, Any], bytes]:
    (n,) = struct.unpack_from("<I", payload, 0)
    if 4 + n > len(payload):
        raise FrameError(f"seq metadata length {n} overruns the frame")
    return unpack_json(payload[4:4 + n]), payload[4 + n:]
