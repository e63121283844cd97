"""Sender side of the multi-process page transport (ports
``repro/serve/net/client.py``).

:class:`SocketTransport` is the
:class:`~repro_torch.serve.transport.PageTransport` that carries
compressed page transfer over TCP: one persistent connection per
destination (a decode host running ``repro_torch.launch.disagg_host``),
hello / version / config negotiation up front, then the same bytes
``LoopbackTransport`` would produce (streaming page chunks and closing
:class:`~repro_torch.serve.transport.SequenceBlob` wire blobs) inside
length-prefixed frames (``repro_torch.serve.net.framing``).

Dedup is receiver-owned: the sender fetches the receiver's digest-store
INVENTORY at connect, mirrors it locally (extending it with every inline
digest shipped, re-fetching when an ack reports evictions), and inlines
only digests the receiver lacks — eviction on the receiver simply surfaces
as a re-send (metered as ``pages_resent``), never as corruption.  Every
transfer is priced through
``repro_torch.hw.noc.LinkModel`` exactly as loopback transfers are; only the
data plane (chunks + blobs) is metered, not the control frames.

:class:`RemoteDecodeReplica` is the driver-side proxy with the same
surface the disagg router uses on a local ``DecodeReplica`` (``free_slots``
/ ``idle`` / ``deliver`` / ``step_window`` / ``decode_stats``), each method
one request/response round trip.  Request latency is computed driver-side
(the two processes' clocks are unrelated).
"""

from __future__ import annotations

import socket
import struct
import time
from typing import Dict, List, Optional, Sequence, Set

from repro_torch.hw.noc import LinkModel, MeteredLink

from ..scheduler import RequestResult
from ..telemetry import ENGINE_LANE, Tracer
from ..transport import PageTransport, SequenceBlob, pack_chunk
from . import framing as fr


class SocketTransport(PageTransport):
    """TCP implementation of the page-transport seam (sender half).

    ``connect`` performs the hello handshake: protocol magic/version, blob
    wire version, and the 16-byte config fingerprint must all match the
    decode host's, else the session dies before any page moves.  ``hops``
    positions the link on the modeled chiplet mesh, as in loopback.
    """

    def __init__(self, dedup: bool = True, hops: int = 2,
                 link: Optional[LinkModel] = None, timeout: float = 600.0):
        super().__init__()
        self.dedup = dedup
        self.hops = hops
        self.link = link if link is not None else LinkModel()
        # actual data-plane traffic prices through the meter (link.bytes
        # / link.model_ns); the bare link stays for raw-bytes baselines
        self._meter = MeteredLink(self.link, self.registry)
        self.timeout = timeout
        self._socks: Dict[str, socket.socket] = {}
        # local mirror of each receiver's digest-store inventory: fetched
        # once at connect, extended with every inline digest we ship, and
        # re-fetched only when an ack reports evictions — the receiver's
        # store mutates only through THIS session, so the mirror stays
        # exact without an inventory round trip per chunk
        self._known: Dict[str, Set[bytes]] = {}

    # -- session ----------------------------------------------------------

    def connect(self, dst: str, host: str, port: int,
                fingerprint: bytes, connect_timeout: float = 30.0) -> None:
        if dst in self._socks:
            raise RuntimeError(f"destination {dst!r} already connected")
        sock = socket.create_connection((host, port),
                                        timeout=connect_timeout)
        sock.settimeout(self.timeout)
        try:
            fr.send_frame(sock, fr.MSG_HELLO, fr.pack_hello(fingerprint))
            msg, payload = fr.recv_frame(sock)
            if msg == fr.MSG_ERROR:
                raise RuntimeError(
                    f"decode host {host}:{port} rejected the session: "
                    f"{payload.decode(errors='replace')}")
            if msg != fr.MSG_HELLO_OK:
                raise fr.FrameError(f"expected HELLO_OK, got type {msg}")
            peer_fp = fr.unpack_hello(payload)
            if peer_fp != fingerprint:
                raise RuntimeError(
                    f"config fingerprint mismatch with {host}:{port}: the "
                    "decode host was launched with a different model/codec/"
                    "geometry/seed — token streams would diverge")
        except BaseException:
            sock.close()
            raise
        self._socks[dst] = sock
        self._known[dst] = self.inventory(dst)

    def close(self, dst: Optional[str] = None) -> None:
        """Orderly BYE to one destination (or all)."""
        for name in ([dst] if dst is not None else list(self._socks)):
            sock = self._socks.pop(name)
            try:
                fr.send_frame(sock, fr.MSG_BYE)
                fr.recv_frame(sock)
            except OSError:
                pass
            finally:
                sock.close()

    def _rpc(self, dst: str, msg_type: int, payload: bytes,
             expect: int) -> bytes:
        sock = self._socks[dst]
        fr.send_frame(sock, msg_type, payload)
        msg, reply = fr.recv_frame(sock)
        if msg == fr.MSG_ERROR:
            raise RuntimeError(f"decode host {dst!r}: "
                               f"{reply.decode(errors='replace')}")
        if msg != expect:
            raise fr.FrameError(
                f"expected message type {expect} from {dst!r}, got {msg}")
        return reply

    # -- the PageTransport surface ----------------------------------------

    def inventory(self, dst: str) -> Set[bytes]:
        return fr.unpack_inventory(
            self._rpc(dst, fr.MSG_INVENTORY_REQ, b"", fr.MSG_INVENTORY))

    def stream_pages(self, dst, seq_id, entries) -> None:
        known = self._known[dst] if self.dedup else None
        data, inline, refs = pack_chunk(seq_id, entries, known)
        if self.dedup:
            self._count_resent(dst, inline)
        self._rpc(dst, fr.MSG_PAGE_CHUNK, data, fr.MSG_CHUNK_OK)
        self._known[dst].update(d for d, _ in inline)
        reg = self.registry
        reg.counter("transport.stream_chunk_bytes").inc(len(data))
        reg.counter("transport.wire_bytes").inc(len(data))
        reg.counter("transport.pages_streamed").inc(len(inline))
        reg.counter("transport.pages_inline").inc(len(inline))
        reg.counter("transport.pages_ref").inc(len(refs))
        self._meter.transfer_ns(len(data), self.hops)

    def fetch(self, dst: str,
              digests: Sequence[bytes]) -> Dict[bytes, bytes]:
        """Pull pages back OUT of the host's digest store by content
        digest — the remote tier of the tiered PageCache.  Returns the
        subset held (a missing digest is not an error); transfer is
        priced through the LinkModel like every data-plane move."""
        pages = fr.unpack_pages(self._rpc(
            dst, fr.MSG_FETCH, fr.pack_inventory(set(digests)),
            fr.MSG_FETCH_OK))
        nbytes = sum(len(p) for p in pages.values())
        reg = self.registry
        reg.counter("transport.pages_fetched").inc(len(pages))
        reg.counter("transport.fetch_bytes").inc(nbytes)
        self._meter.transfer_ns(nbytes, self.hops)
        return pages

    def abort_stream(self, dst, seq_id) -> None:
        reply = fr.unpack_json(self._rpc(
            dst, fr.MSG_ABORT, struct.pack("<I", seq_id), fr.MSG_ABORT_OK))
        evicted = int(reply.get("evicted", 0))
        self.registry.counter("transport.store_evicted").inc(evicted)
        if evicted:
            self._known[dst] = self.inventory(dst)   # resync the mirror

    def deliver(self, h, dst: str) -> int:
        """Ship handoff ``h`` (request metadata + closing blob) and have
        the decode host import it; returns the remote slot id.  The
        counterpart of ``DecodeReplica.deliver`` for a remote replica —
        serialization, dedup against the remote inventory, and LinkModel
        metering all happen here, import happens in the host process."""
        blob: SequenceBlob = h.blob
        known = self._known[dst] if self.dedup else None
        data, inline, refs = blob.to_wire(known)
        if self.dedup:
            self._count_resent(dst, inline)
        req = h.req
        meta = {
            "uid": int(req.uid),
            "prompt": [int(t) for t in req.prompt],
            "max_new_tokens": int(req.max_new_tokens),
            "eos_id": None if req.eos_id is None else int(req.eos_id),
            "stop_seqs": (None if req.stop_seqs is None else
                          [[int(t) for t in s] for s in req.stop_seqs]),
            "seq_id": h.seq_id,
        }
        reply = fr.unpack_json(self._rpc(
            dst, fr.MSG_SEQ, fr.pack_seq(meta, data), fr.MSG_SEQ_OK))
        self._known[dst].update(d for d, _ in inline)
        evicted = int(reply.get("evicted", 0))
        if evicted:
            self._known[dst] = self.inventory(dst)   # resync the mirror
        reg = self.registry
        reg.counter("transport.transfers").inc()
        reg.counter("transport.wire_bytes").inc(len(data))
        reg.counter("transport.wire_bytes_nodedup").inc(
            len(data) + len(refs) * blob._payload_size())
        reg.counter("transport.raw_bytes").inc(blob.raw_bytes)
        reg.counter("transport.pages_inline").inc(len(inline))
        reg.counter("transport.pages_ref").inc(len(refs))
        reg.counter("transport.store_evicted").inc(evicted)
        self._meter.transfer_ns(len(data), self.hops)
        reg.counter("link.model_ns_raw").inc(
            self.link.transfer_ns(blob.raw_bytes, self.hops))
        return int(reply["slot"])

    # the in-process serialize/parse surface is loopback-only: a socket
    # transport's recv half lives in the decode host process
    def send(self, blob, dst, seq_id=None) -> bytes:
        raise RuntimeError("SocketTransport ships sequences via deliver(); "
                           "send/recv is the in-process loopback surface")

    def recv(self, data, dst, seq_id=None) -> SequenceBlob:
        raise RuntimeError("SocketTransport ships sequences via deliver(); "
                           "send/recv is the in-process loopback surface")

    # -- decode-replica control rpcs --------------------------------------

    def status(self, dst: str) -> Dict[str, int]:
        return fr.unpack_json(
            self._rpc(dst, fr.MSG_STATUS_REQ, b"", fr.MSG_STATUS))

    def metrics(self, dst: str) -> Dict:
        """Versioned metrics-registry snapshot of the remote replica's
        engine (``repro_torch.serve.telemetry.MetricsRegistry.snapshot``);
        fold per-replica snapshots with ``MetricsRegistry.merge``."""
        return fr.unpack_json(
            self._rpc(dst, fr.MSG_METRICS_REQ, b"", fr.MSG_METRICS))

    def step(self, dst: str) -> List[Dict]:
        return fr.unpack_json(self._rpc(dst, fr.MSG_STEP, b"",
                                        fr.MSG_RESULTS))


class RemoteDecodeReplica:
    """Driver-side proxy for a decode replica living in another OS process
    (behind a :class:`SocketTransport` destination).  Presents the same
    surface the disagg router drives on a local ``DecodeReplica``."""

    def __init__(self, transport: SocketTransport, dst: str,
                 tracer: Optional[Tracer] = None, name: str = "remote"):
        self.transport = transport
        self.dst = dst
        # driver-side span recording: the host process's clock is
        # unrelated, so wire/decode spans for remote replicas are stamped
        # here, around the RPCs
        self.tracer = tracer if tracer is not None else Tracer(False)
        self.name = name
        self._admit_t: Dict[int, float] = {}

    def free_slots(self) -> int:
        return int(self.transport.status(self.dst)["free_slots"])

    def idle(self) -> bool:
        return int(self.transport.status(self.dst)["live"]) == 0

    def decode_stats(self) -> Dict[str, int]:
        st = self.transport.status(self.dst)
        return {k: int(st.get(k, 0))
                for k in ("steps", "dispatches", "shared_hits",
                          "cache_hot_hits", "cache_spilled_pages",
                          "cache_spilled_bytes", "cache_fetched_pages",
                          "cache_fetched_bytes", "cache_reprefill_cols")}

    def deliver(self, h, transport, dst) -> None:
        uid = int(h.req.uid)
        self._admit_t[uid] = h.admit_t
        tr, reg = self.tracer, self.transport.registry
        wb0 = reg.value("transport.wire_bytes")
        t0 = tr.now()
        w0 = time.perf_counter()
        self.transport.deliver(h, self.dst)
        reg.histogram("latency.transfer_s").observe(
            time.perf_counter() - w0)
        tr.request_span(uid, "wire", t0=t0, t1=tr.now(),
                        args={"wire_bytes":
                              reg.value("transport.wire_bytes") - wb0,
                              "raw_bytes": h.blob.raw_bytes,
                              "dst": self.dst})

    def step_window(self) -> List[RequestResult]:
        tr = self.tracer
        t0 = tr.now()
        replies = self.transport.step(self.dst)
        t1 = tr.now()
        tr.emit("decode_rpc", cat="dispatch", pid=self.name,
                tid=ENGINE_LANE, t0=t0, t1=t1,
                args={"dst": self.dst, "finished": len(replies)})
        now = time.perf_counter()
        out = []
        for r in replies:
            # the host's clock is unrelated to ours: latency is measured
            # driver-side, admission -> result arrival
            uid = int(r["uid"])
            admit_t = self._admit_t.pop(uid)
            tokens = [int(t) for t in r["tokens"]]
            tr.request_end(uid, args={"stop_reason": str(r["stop_reason"]),
                                      "tokens": len(tokens)})
            out.append(RequestResult(
                uid=uid, prompt_len=int(r["prompt_len"]),
                tokens=tokens,
                latency_s=now - admit_t,
                stop_reason=str(r["stop_reason"])))
        return out

    def metrics_snapshot(self) -> Dict:
        return self.transport.metrics(self.dst)
