"""Receiver side of the multi-process page transport (ports
``repro/serve/net/server.py``).

:class:`PageHost` runs in the decode-replica process
(``repro_torch.launch.disagg_host --role decode``): it owns the replica,
the content-addressed :class:`~repro_torch.serve.transport.DigestStore`
that backs cross-process page dedup, and the per-transfer pins of
in-flight streamed chunks.  One driver connection at a time; every
request frame gets exactly one response frame
(``repro_torch.serve.net.framing`` documents the protocol).

Failure containment: a bad frame, a corrupted chunk, a geometry-mismatched
blob, or an oversubscribed import all answer with an ERROR frame and leave
the replica's pool untouched (imports validate host-side before any device
dispatch; chunk payloads are digest-verified at ingest).  A connection that
dies mid-stream releases its pins and trims the store — staged pages
simply become ordinary LRU content, and the sequence they belonged to was
never imported.
"""

from __future__ import annotations

import socket
import struct
import time
from typing import Set

import numpy as np

from ..disagg import DecodeReplica, Handoff
from ..scheduler import Request
from ..transport import (DigestStore, SequenceBlob, _page_digest,
                         unpack_chunk)
from . import framing as fr


class PageHost:
    """Session handler wrapping one decode replica for remote drivers."""

    def __init__(self, replica: DecodeReplica, fingerprint: bytes,
                 max_store_pages: int = 4096):
        self.replica = replica
        self.fingerprint = fingerprint
        self.store = DigestStore(max_store_pages)
        # remote tier of the replica's tiered PageCache: a warm prefix
        # column whose payload fell out of the engine-side store restores
        # from the transport store (streamed/deduped pages land here and
        # often outlive the engine's own spill window)
        self.replica.engine.cache.remote_fetch = self._fetch_pages

    def _fetch_pages(self, digests):
        return {d: self.store[d] for d in digests if d in self.store}

    # -- lifecycle ---------------------------------------------------------

    def serve_forever(self, listener: socket.socket,
                      once: bool = False) -> None:
        """Accept driver sessions one at a time; ``once`` returns after the
        first session ends (orderly BYE or dropped connection)."""
        while True:
            conn, _ = listener.accept()
            try:
                self.serve_connection(conn)
            except OSError:
                pass                 # driver died mid-reply: session over
            finally:
                conn.close()
            if once:
                return

    def serve_connection(self, conn: socket.socket) -> None:
        open_seqs: Set[int] = set()
        try:
            if not self._handshake(conn):
                return
            while True:
                try:
                    msg, payload = fr.recv_frame(conn)
                except fr.FrameError:
                    return          # driver gone (possibly mid-stream)
                if msg == fr.MSG_BYE:
                    fr.send_frame(conn, fr.MSG_BYE_OK)
                    return
                try:
                    reply_type, reply = self._handle(msg, payload,
                                                     open_seqs)
                except Exception as e:
                    # the import/parse contract keeps the pool untouched;
                    # report and keep the session alive (struct.error,
                    # KeyError on malformed metadata, ... — any payload
                    # problem answers ERROR, never kills the host)
                    reply_type, reply = (fr.MSG_ERROR,
                                         f"{type(e).__name__}: {e}"
                                         .encode())
                fr.send_frame(conn, reply_type, reply)
        finally:
            # a dead session must not pin its half-streamed transfers
            # forever: release them (the chunks stay in the store as
            # ordinary LRU content) and trim.  Likewise its imported-but-
            # unfinished sequences can never be stepped or collected again
            # — evict them so the NEXT driver session starts with a clean
            # replica (an orderly session finished everything: no-op).
            for seq_id in open_seqs:
                self.store.release(seq_id)
            self.store.trim()
            self.replica.drop_live()

    def _handshake(self, conn: socket.socket) -> bool:
        try:
            msg, payload = fr.recv_frame(conn)
            if msg != fr.MSG_HELLO:
                raise fr.FrameError(f"expected HELLO, got type {msg}")
            peer_fp = fr.unpack_hello(payload)
        except fr.FrameError as e:
            try:
                fr.send_frame(conn, fr.MSG_ERROR, str(e).encode())
            except OSError:
                pass
            return False
        if peer_fp != self.fingerprint:
            fr.send_frame(conn, fr.MSG_ERROR,
                          b"config fingerprint mismatch: this decode host "
                          b"was launched with a different model/codec/"
                          b"geometry/seed")
            return False
        fr.send_frame(conn, fr.MSG_HELLO_OK,
                      fr.pack_hello(self.fingerprint))
        return True

    # -- request handling --------------------------------------------------

    def _handle(self, msg: int, payload: bytes, open_seqs: Set[int]):
        if msg == fr.MSG_INVENTORY_REQ:
            return fr.MSG_INVENTORY, fr.pack_inventory(self.store.digests())
        if msg == fr.MSG_PAGE_CHUNK:
            return fr.MSG_CHUNK_OK, self._ingest_chunk(payload, open_seqs)
        if msg == fr.MSG_ABORT:
            (seq_id,) = struct.unpack("<I", payload)
            self.store.release(seq_id)
            open_seqs.discard(seq_id)
            return fr.MSG_ABORT_OK, fr.pack_json(
                {"evicted": self.store.trim()})
        if msg == fr.MSG_SEQ:
            return fr.MSG_SEQ_OK, self._import_seq(payload, open_seqs)
        if msg == fr.MSG_STEP:
            results = self.replica.step_window()
            return fr.MSG_RESULTS, fr.pack_json(
                [{"uid": r.uid, "prompt_len": r.prompt_len,
                  "tokens": r.tokens, "stop_reason": r.stop_reason}
                 for r in results])
        if msg == fr.MSG_STATUS_REQ:
            return fr.MSG_STATUS, fr.pack_json(dict(
                free_slots=self.replica.free_slots(),
                live=len(self.replica.ls.live_slots()),
                store_pages=len(self.store),
                store_capacity=self.store.max_pages,
                **self.replica.decode_stats()))
        if msg == fr.MSG_METRICS_REQ:
            return fr.MSG_METRICS, fr.pack_json(
                self.replica.metrics_snapshot())
        if msg == fr.MSG_FETCH:
            digests = fr.unpack_inventory(payload)
            return fr.MSG_FETCH_OK, fr.pack_pages(self._fetch_pages(digests))
        raise ValueError(f"unknown message type {msg}")

    def _ingest_chunk(self, payload: bytes, open_seqs: Set[int]) -> bytes:
        seq_id, entries = unpack_chunk(payload)
        # validate everything BEFORE mutating the store: a corrupted chunk
        # must not leave half its pages behind
        for t, l, c, tag, digest, body in entries:
            if tag == 1 and digest not in self.store:
                raise ValueError(
                    f"chunk references unknown digest {digest.hex()} "
                    f"(shard {t}, layer {l}, col {c})")
            if tag == 0 and _page_digest(body) != digest:
                raise ValueError(
                    f"chunk payload does not hash to its digest "
                    f"{digest.hex()} (shard {t}, layer {l}, col {c})")
        # track the transfer BEFORE pinning so session teardown always
        # releases, even if an insert below fails unexpectedly
        open_seqs.add(seq_id)
        for _, _, _, tag, digest, body in entries:
            if tag == 0:
                self.store[digest] = body   # digest-verified at ingest
            self.store.pin(seq_id, digest)
        return fr.pack_json({"pinned": len(entries)})

    def _import_seq(self, payload: bytes, open_seqs: Set[int]) -> bytes:
        meta, blob_bytes = fr.unpack_seq(payload)
        blob = SequenceBlob.from_wire(blob_bytes, self.store)
        req = Request(
            uid=int(meta["uid"]),
            prompt=np.asarray(meta["prompt"], np.int32),
            max_new_tokens=int(meta["max_new_tokens"]),
            eos_id=(None if meta.get("eos_id") is None
                    else int(meta["eos_id"])),
            stop_seqs=(None if meta.get("stop_seqs") is None else
                       tuple(tuple(int(t) for t in s)
                             for s in meta["stop_seqs"])))
        # host-clock admit time: latency is recomputed driver-side
        slot = self.replica.import_handoff(
            Handoff(req=req, blob=blob, admit_t=time.perf_counter()))
        seq_id = meta.get("seq_id")
        if seq_id is not None:
            self.store.release(int(seq_id))
            open_seqs.discard(int(seq_id))
        return fr.pack_json({"slot": slot, "evicted": self.store.trim()})
