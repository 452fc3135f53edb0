"""Async SSF span client: record -> bounded queue -> backend worker.

The port's copy of ``veneur_tpu/trace/client.py``.

Mirrors the reference trace client (trace/client.go:56 ``Client``;
trace/backend.go:47 ``ClientBackend``, :94 ``packetBackend``, :128
``streamBackend``): spans are recorded onto a bounded queue and pumped
by one worker thread into a backend.  A full queue drops the span and
counts it (the reference's backpressure contract — the client must
never block the code being traced).

Backends:

- ``ChannelBackend``: hands spans straight to a callback — the
  in-process loopback the server uses to feed its own span pipeline
  (reference ``NewChannelClient``, server.go:348).
- ``PacketBackend``: one bare-protobuf span per datagram over UDP or
  unixgram (trace/backend.go:94).
- ``StreamBackend``: framed spans over a unix SOCK_STREAM with a
  buffered writer, interval flush, and linear-backoff reconnect that
  discards the poison span (trace/backend.go:128, :85-93 contract).
"""

from __future__ import annotations

import io
import logging
import queue
import socket
import threading
import time

from veneur_tpu_torch.protocol import wire
from veneur_tpu_torch.protocol.addr import parse_addr

log = logging.getLogger("veneur_tpu_torch.trace")

# reference trace/backend.go:14-27: linear backoff between reconnect
# attempts, capped
DEFAULT_BACKOFF = 0.02
MAX_BACKOFF = 1.0
DEFAULT_CAPACITY = 64
_FLUSH = object()  # sentinel op on the span queue
_STOP = object()


class ChannelBackend:
    """In-process loopback: send = callback(span)."""

    def __init__(self, callback):
        self._cb = callback

    def send(self, span) -> None:
        self._cb(span)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class PacketBackend:
    """Bare-protobuf datagrams over udp:// or unix:// (SOCK_DGRAM).

    Sockets are connectionless; a send error drops the span, counts
    it, and rebuilds the socket for the next one.
    """

    def __init__(self, address: str):
        scheme, host, port, path = parse_addr(address)
        if scheme == "udp":
            self._target = (host, port)
            self._family = socket.AF_INET
        elif scheme in ("unix", "unixgram"):
            # the reference's documented datagram form is unixgram://
            self._target = path
            self._family = socket.AF_UNIX
        else:
            raise ValueError(
                f"packet backend needs udp://, unix:// or "
                f"unixgram://, got {address}")
        self._sock: socket.socket | None = None

    def send(self, span) -> None:
        if self._sock is None:
            self._sock = socket.socket(self._family, socket.SOCK_DGRAM)
        try:
            self._sock.sendto(span.SerializeToString(), self._target)
        except OSError:
            try:
                self._sock.close()
            finally:
                self._sock = None
            raise

    def flush(self) -> None:
        pass

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None


class StreamBackend:
    """Framed spans over a connected stream socket with buffering.

    The buffer flushes when ``flush()`` is called (the client issues
    one per ``flush_interval``).  Any send/connect error closes the
    connection and schedules a reconnect with linear backoff; the span
    that hit the error is discarded, not retried (reference
    backend.go:85-93: 'the poison span is dropped')."""

    def __init__(self, address: str, buffer_size: int = 1 << 16):
        scheme, host, port, path = parse_addr(address)
        if scheme == "unix":
            self._target = path
            self._family = socket.AF_UNIX
        elif scheme == "tcp":
            self._target = (host, port)
            self._family = socket.AF_INET
        else:
            raise ValueError(
                f"stream backend needs unix:// or tcp://, got {address}")
        self._buffer_size = buffer_size
        self._sock: socket.socket | None = None
        self._buf: io.BufferedWriter | None = None
        self._backoff = DEFAULT_BACKOFF
        self._next_attempt = 0.0

    def _connect(self) -> None:
        now = time.monotonic()
        if now < self._next_attempt:
            raise ConnectionError("reconnect backoff in effect")
        try:
            s = socket.socket(self._family, socket.SOCK_STREAM)
            s.connect(self._target)
        except OSError:
            self._next_attempt = now + self._backoff
            self._backoff = min(self._backoff + DEFAULT_BACKOFF,
                                MAX_BACKOFF)
            raise
        self._sock = s
        self._buf = io.BufferedWriter(
            socket.SocketIO(s, "w"), buffer_size=self._buffer_size)
        self._backoff = DEFAULT_BACKOFF
        self._next_attempt = 0.0

    def _teardown(self) -> None:
        if self._buf is not None:
            try:
                self._buf.detach()
            except Exception:
                pass
            self._buf = None
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def send(self, span) -> None:
        if self._buf is None:
            self._connect()
        try:
            wire.write_ssf(self._buf, span)
        except OSError:
            self._teardown()
            raise

    def flush(self) -> None:
        if self._buf is None:
            return
        try:
            self._buf.flush()
        except OSError:
            self._teardown()
            raise

    def close(self) -> None:
        try:
            self.flush()
        except OSError:
            pass
        self._teardown()


class Client:
    """Bounded-queue async span recorder.

    ``record(span)`` never blocks: a full queue drops the span and
    bumps ``dropped`` (trace/client.go backpressure counters).  One
    worker thread drains the queue into the backend; a periodic flush
    op keeps stream backends moving even when idle."""

    def __init__(self, backend, capacity: int = DEFAULT_CAPACITY,
                 flush_interval: float = 0.2):
        self.backend = backend
        self._q: queue.Queue = queue.Queue(maxsize=capacity)
        self.dropped = 0
        self.sent = 0
        self.errors = 0
        self._lock = threading.Lock()
        self._flush_interval = flush_interval
        self._worker = threading.Thread(target=self._work, daemon=True,
                                        name="trace-client")
        self._worker.start()

    def record(self, span) -> bool:
        try:
            self._q.put_nowait(span)
            return True
        except queue.Full:
            with self._lock:
                self.dropped += 1
            return False

    def flush(self, timeout: float = 1.0) -> None:
        """Enqueue a flush op and wait until the queue drains."""
        try:
            self._q.put_nowait(_FLUSH)
        except queue.Full:
            return
        deadline = time.monotonic() + timeout
        while not self._q.empty() and time.monotonic() < deadline:
            time.sleep(0.005)

    def close(self) -> None:
        try:
            self._q.put(_STOP, timeout=0.5)
        except queue.Full:
            pass
        self._worker.join(timeout=2.0)
        self.backend.close()

    def _work(self) -> None:
        while True:
            try:
                item = self._q.get(timeout=self._flush_interval)
            except queue.Empty:
                self._safe_flush()
                continue
            if item is _STOP:
                self._safe_flush()
                return
            if item is _FLUSH:
                self._safe_flush()
                continue
            try:
                self.backend.send(item)
                with self._lock:
                    self.sent += 1
            except Exception:
                with self._lock:
                    self.errors += 1
                    self.dropped += 1

    def _safe_flush(self) -> None:
        try:
            self.backend.flush()
        except Exception:
            with self._lock:
                self.errors += 1
