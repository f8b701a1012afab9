"""The source half of the migration wire: the dump streams its bytes
straight to the destination while it drains.

Counterpart of the sending side of ``grit_tpu/agent/copy.py``, Python
plane only. Frames are the reference's, so its ``WireReceiver`` takes them
as they come::

    u32 header_len (big-endian) | header JSON | payload (header["n"] bytes)

    {"t": "chunk", "rel", "off", "n", "crc"}   a piece of a dump-fed file;
        a codec record adds "c" (its codec) and "rn" (its raw size), and
        then "off" is the raw offset and "crc" the crc32 of the raw bytes
    {"t": "eof", "rel", "total"}               the stream of "rel" is done
    {"t": "fail", "msg"}                       the source gave up

:class:`WireSender` round-robins frames over ``streams`` connections, each
drained by a thread through a queue of :data:`_WIRE_QUEUE_FRAMES` frames:
a full queue blocks the producer (``stall_s``), so the source buffers a
bounded number of bytes whatever the destination does. Any stream error
poisons the sender. :class:`WireDumpSink` is what the snapshot writer's tee
hands each drained chunk (or codec block) to; a wire failure only flips
its ``ok``, never fails the dump.

The sender carries the reference's seams: the ``wire.send`` fault point at
every frame (an injected raise travels as :class:`WireError`, so the tee
takes the path a dead wire takes), the ``wire.open`` and ``wire.close``
flight events, the ``wire_stream`` span, and ``WIRE_BYTES``,
``WIRE_SECONDS``, ``WIRE_STALL_SECONDS`` (one observation a stall episode)
and ``WIRE_FRAME_SEND_SECONDS`` (one a frame).

Not here: the reference's native send plane and its pacer (``libgritio``),
``send_file``/``send_tree``/``commit`` (the agent ships the rest of the
checkpoint and commits) and the receiver.
"""

from __future__ import annotations

import json
import logging
import queue
import socket
import struct
import threading
import time
import zlib

from grit_tpu_torch import faults
from grit_tpu_torch.api import config
from grit_tpu_torch.codec import CODEC_NONE
from grit_tpu_torch.obs import flight, trace
from grit_tpu_torch.obs.metrics import (
    WIRE_BYTES,
    WIRE_FRAME_SEND_SECONDS,
    WIRE_SECONDS,
    WIRE_STALL_SECONDS,
)

log = logging.getLogger(__name__)

WIRE_FRAME_BYTES = 4 * 1024 * 1024
# Frames queued per stream: the source holds at most streams x this many
# frames for a destination that does not read.
_WIRE_QUEUE_FRAMES = 4


class WireError(RuntimeError):
    """The wire transport failed; the caller falls back to the PVC path."""


def _wire_frame(header: dict, payload: bytes = b"") -> bytes:
    raw = json.dumps(header, separators=(",", ":")).encode()
    return struct.pack(">I", len(raw)) + raw + payload


def _wire_ifaces() -> list[str]:
    """``GRIT_WIRE_IFACES`` as a list (empty: no pinning)."""
    return [i.strip() for i in config.WIRE_IFACES.get().split(",")
            if i.strip()]


def _dial_stream(host: str, port: int, timeout: float,
                 iface: str | None) -> socket.socket:
    """One stream's connection, pinned to ``iface`` before it connects when
    given (a refused pin, which needs CAP_NET_RAW, logs and dials
    unpinned). Every getaddrinfo result is tried in order."""
    last_exc: OSError | None = None
    for af, kind, proto, _cn, addr in socket.getaddrinfo(
            host, port, type=socket.SOCK_STREAM):
        s = socket.socket(af, kind, proto)
        if iface:
            try:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_BINDTODEVICE,
                             iface.encode() + b"\0")
            except OSError as exc:
                log.warning("wire stream: SO_BINDTODEVICE(%s) refused (%s); "
                            "dialing unpinned", iface, exc)
        s.settimeout(timeout)
        try:
            s.connect(addr)
            return s
        except OSError as exc:
            s.close()
            last_exc = exc
    if last_exc is not None:
        raise last_exc
    raise OSError(f"getaddrinfo returned no addresses for {host!r}")


class WireSender:
    """Frames queued onto ``streams`` connections to ``endpoint``
    (``host:port``), each drained by a worker thread.

    A frame's ``done`` callback (see :meth:`send_chunk`) runs once its
    worker is through with the payload (sent, or dropped by a dead
    sender), so a caller can reuse the payload's memory then."""

    def __init__(self, endpoint: str, streams: int = 2,
                 timeout: float = 120.0) -> None:
        host, _, port = endpoint.rpartition(":")
        self.endpoint = endpoint
        self._timeout = timeout
        self._socks: list[socket.socket] = []
        self._queues: list[queue.Queue] = []
        self._threads: list[threading.Thread] = []
        self._dead: str | None = None
        self._rr = 0
        self._lock = threading.Lock()
        self._closed = False
        self._sent_bytes = 0
        self._send_s = 0.0
        self._stall_s = 0.0
        ifaces = _wire_ifaces()
        try:
            for k in range(max(1, streams)):
                self._socks.append(_dial_stream(
                    host, int(port), timeout,
                    ifaces[k % len(ifaces)] if ifaces else None))
        except (OSError, ValueError) as exc:  # ValueError: a junk endpoint
            for s in self._socks:
                s.close()
            raise WireError(f"wire connect to {endpoint} failed: {exc}") \
                from exc
        flight.emit("wire.open", endpoint=endpoint, streams=len(self._socks))
        for k in range(len(self._socks)):
            q: queue.Queue = queue.Queue(maxsize=_WIRE_QUEUE_FRAMES)
            t = threading.Thread(target=self._worker, args=(k, q),
                                 name=f"grit-wire-send-{k}", daemon=True)
            self._queues.append(q)
            self._threads.append(t)
            t.start()

    def _worker(self, k: int, q: queue.Queue) -> None:
        sock = self._socks[k]
        idle = 0
        while True:
            try:
                # Bounded get: a producer that died without the sentinel
                # must not park this thread silently.
                frame = q.get(timeout=1.0)
            except queue.Empty:
                idle += 1
                if idle % 60 == 0:
                    log.warning("wire send stream %d idle for %ds with no "
                                "frames and no shutdown sentinel", k, idle)
                continue
            idle = 0
            if frame is None:
                q.task_done()
                return
            header, payload, done = frame
            try:
                if self._dead is None:
                    t0 = time.monotonic()
                    # Header and payload as two sends: no concatenation
                    # copy of the payload.
                    sock.sendall(header)
                    if len(payload):
                        sock.sendall(payload)
                    frame_s = time.monotonic() - t0
                    with self._lock:
                        self._send_s += frame_s
                        self._sent_bytes += len(header) + len(payload)
                    WIRE_FRAME_SEND_SECONDS.observe(frame_s)
                # A dead sender drains its queue so producers never block.
            except OSError as exc:
                self._dead = self._dead or f"{type(exc).__name__}: {exc}"
            finally:
                del payload, frame
                if done is not None:
                    done()
                q.task_done()

    @property
    def sent_bytes(self) -> int:
        return self._sent_bytes

    @property
    def send_s(self) -> float:
        return self._send_s

    @property
    def stall_s(self) -> float:
        return self._stall_s

    def _enqueue(self, header: dict, payload=b"", done=None) -> None:
        faults.fault_point("wire.send", wrap=WireError)
        if self._dead is not None:
            raise WireError(f"wire send failed: {self._dead}")
        raw = json.dumps(header, separators=(",", ":")).encode()
        frame = (struct.pack(">I", len(raw)) + raw, payload, done)
        with self._lock:
            q = self._queues[self._rr % len(self._queues)]
            self._rr += 1
        t0 = time.monotonic()
        episode = 0.0  # this frame's whole backpressure block
        while True:
            try:
                q.put(frame, timeout=0.5)
                break
            except queue.Full:
                # Stall accrues while it lasts, not only once it ends.
                now = time.monotonic()
                with self._lock:
                    self._stall_s += now - t0
                episode += now - t0
                t0 = now
                if self._dead is not None:
                    raise WireError(f"wire send failed: {self._dead}")
        tail = time.monotonic() - t0
        with self._lock:
            self._stall_s += tail
        episode += tail
        if episode > 0.005:
            # Episodes, not their sum: many short blocks are pacing, a
            # few long ones a wedged consumer.
            WIRE_STALL_SECONDS.observe(episode)

    def send_chunk(self, rel: str, offset: int, data, done=None) -> None:
        """A raw piece of a dump-fed file at ``offset``; ``done`` (if any)
        runs once the worker is through with ``data``. It does not run
        when this raises: the frame was never queued."""
        self._enqueue({"t": "chunk", "rel": rel, "off": offset,
                       "n": len(data), "crc": zlib.crc32(data) & 0xFFFFFFFF},
                      data, done)

    def send_record(self, rel: str, raw_off: int, payload, codec_name: str,
                    raw_n: int, crc_raw: int, done=None) -> None:
        """One post-codec block as a chunk frame: ``off`` is its raw
        offset, ``n`` the payload on the wire, ``crc`` the crc32 of its raw
        bytes (checked after decode); ``done`` as for :meth:`send_chunk`."""
        header = {"t": "chunk", "rel": rel, "off": raw_off,
                  "n": len(payload), "crc": crc_raw}
        if codec_name != CODEC_NONE:
            header["c"] = codec_name
            header["rn"] = raw_n
        self._enqueue(header, payload, done)

    def eof(self, rel: str, total: int) -> None:
        """Terminate the dump-fed stream of ``rel`` at ``total`` raw bytes."""
        self._enqueue({"t": "eof", "rel": rel, "total": total})

    def fail(self, msg: str) -> None:
        """Best-effort abort frame, so the receiver fails at once instead
        of waiting out its timeout."""
        try:
            self._socks[0].settimeout(self._timeout)
            self._socks[0].sendall(_wire_frame({"t": "fail", "msg": msg}))
        except OSError:
            pass

    def close(self) -> None:
        """Send what is queued (bounded by the timeout) and close."""
        if self._closed:
            return
        self._closed = True
        for q in self._queues:
            q.put(None)
        for t in self._threads:
            t.join(timeout=self._timeout)
        for s in self._socks:
            try:
                s.close()
            except OSError:
                pass
        WIRE_BYTES.inc(self.sent_bytes, role="send")
        WIRE_SECONDS.inc(self.send_s, phase="send")
        WIRE_SECONDS.inc(self.stall_s, phase="stall")
        trace.record_span("wire_stream", time.time_ns(),
                          bytes=self.sent_bytes, streams=len(self._socks),
                          send=round(self.send_s, 4),
                          stall=round(self.stall_s, 4))
        flight.emit("wire.close", bytes=self.sent_bytes,
                    streams=len(self._socks), send_s=round(self.send_s, 4),
                    stall_s=round(self.stall_s, 4))


class Countdown:
    """Runs ``done`` once :meth:`tick` has been called ``n`` times (at once
    for ``n`` 0): the release of a buffer lent to ``n`` frames or blocks."""

    def __init__(self, n: int, done) -> None:
        self._n = n
        self._done = done
        self._lock = threading.Lock()
        if n == 0:
            done()

    def tick(self) -> None:
        with self._lock:
            self._n -= 1
            last = self._n == 0
        if last:
            self._done()


class WireDumpSink:
    """The snapshot tee's hand-off to the wire: :meth:`put` frames a
    drained chunk's raw bytes, :meth:`put_record` one codec block, both in
    data-file order, as the stream of ``rel``. A wire failure flips ``ok``
    (``error`` says why) and the rest is dropped; it never raises into the
    dump. Backpressure from the sender's queues reaches the tee's thread,
    not host memory.

    ``done``, where given, runs once the wire is through with the buffer
    (at once when it was not framed), so the tee can reuse it."""

    def __init__(self, sender: WireSender, rel: str) -> None:
        self._sender = sender
        self.rel = rel
        self.ok = True
        self.error: str | None = None
        self.nbytes = 0       # raw bytes streamed (the receiver's accounting)
        self.comp_bytes = 0   # payload bytes framed onto the wire
        # Bytes on a socket by the time the dump's tee finished.
        self.bytes_during_dump = 0

    def put(self, view, done=None) -> None:
        mv = memoryview(view).cast("B")
        spans = [(o, min(WIRE_FRAME_BYTES, len(mv) - o))
                 for o in range(0, len(mv), WIRE_FRAME_BYTES)]
        count = Countdown(len(spans), done) if done is not None else None
        tick = count.tick if count is not None else None
        for i, (off, n) in enumerate(spans):
            if not self.ok:
                self._release(tick, len(spans) - i)
                return
            try:
                # Zero-copy: the slice rides the queue to the socket.
                self._sender.send_chunk(self.rel, self.nbytes, mv[off:off + n],
                                        done=tick)
            except WireError as exc:
                self.ok = False
                self.error = str(exc)
                self._release(tick, len(spans) - i)
                return
            self.nbytes += n
            self.comp_bytes += n

    @staticmethod
    def _release(tick, n: int) -> None:
        """Tick for the ``n`` frames that were never queued."""
        for _ in range(n if tick is not None else 0):
            tick()

    def put_record(self, codec_name: str, payload, raw_off: int,
                   raw_n: int, crc_raw: int, done=None) -> None:
        if not self.ok:
            if done is not None:
                done()
            return
        try:
            self._sender.send_record(self.rel, raw_off, payload, codec_name,
                                     raw_n, crc_raw, done=done)
        except WireError as exc:
            self.ok = False
            self.error = str(exc)
            if done is not None:
                done()
            return
        self.nbytes += raw_n
        self.comp_bytes += len(payload)

    def mark_failed(self, msg: str) -> None:
        self.ok = False
        self.error = self.error or msg

    def finish(self, ok: bool = True) -> bool:
        """The tee drained its last chunk: send the stream's terminator.
        Returns whether the wire stayed healthy."""
        if not ok:
            self.mark_failed("dump tee failed before wire eof")
        if self.ok:
            try:
                self._sender.eof(self.rel, self.nbytes)
                self.bytes_during_dump = self._sender.sent_bytes
            except WireError as exc:
                self.ok = False
                self.error = str(exc)
        return self.ok
