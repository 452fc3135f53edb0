"""SSF framing codec and span normalization.

The port's copy of ``veneur_tpu/protocol/wire.py``.

The reference's stream protocol (protocol/wire.go): one frame is
``[version byte = 0][u32 big-endian length][length bytes of protobuf
SSFSpan]``, 16 MiB max.  Datagram transports (UDP/unixgram) carry a
bare protobuf SSFSpan with no frame.

Normalization on ingest (ssf/sample.proto compatibility notes,
protocol/wire.go:137 ParseSSF): an empty span name adopts a "name"
tag (which is then removed); metric samples with sample_rate 0 get 1.
"""

from __future__ import annotations

import struct
from typing import BinaryIO

from veneur_tpu_torch.protocol.gen import ssf_pb2

MAX_SSF_PACKET_LENGTH = 16 * 1024 * 1024
FRAME_VERSION = 0


class FramingError(ValueError):
    """Stream is unrecoverably out of sync (reference IsFramingError
    semantics: the connection must be dropped)."""


class SSFParseError(ValueError):
    """One message was bad; the stream remains usable."""


def normalize_span(span: ssf_pb2.SSFSpan) -> ssf_pb2.SSFSpan:
    if not span.name and "name" in span.tags:
        span.name = span.tags.pop("name")
    for m in span.metrics:
        if m.sample_rate == 0:
            m.sample_rate = 1.0
    return span


def parse_ssf(data: bytes) -> ssf_pb2.SSFSpan:
    """Bare-protobuf datagram -> normalized span."""
    try:
        span = ssf_pb2.SSFSpan.FromString(data)
    except Exception as e:
        raise SSFParseError(f"bad SSF payload: {e}") from e
    return normalize_span(span)


def valid_trace(span: ssf_pb2.SSFSpan) -> bool:
    """Criteria for a usable trace span (protocol/wire.go:82
    ValidTrace)."""
    return (span.id != 0 and span.trace_id != 0 and
            span.start_timestamp != 0 and span.end_timestamp != 0 and
            bool(span.name))


def write_ssf(out: BinaryIO, span: ssf_pb2.SSFSpan) -> int:
    """Frame and write one span (protocol/wire.go:186 WriteSSF)."""
    body = span.SerializeToString()
    if len(body) > MAX_SSF_PACKET_LENGTH:
        raise FramingError(f"span too large: {len(body)}")
    frame = struct.pack(">BI", FRAME_VERSION, len(body)) + body
    out.write(frame)
    return len(frame)


def read_ssf(stream: BinaryIO) -> ssf_pb2.SSFSpan | None:
    """Read one framed span; None on clean EOF at a frame boundary
    (protocol/wire.go:108 ReadSSF)."""
    head = stream.read(1)
    if head == b"":
        return None
    version = head[0]
    if version != FRAME_VERSION:
        raise FramingError(f"unknown SSF frame version {version}")
    raw_len = _read_exact(stream, 4)
    (length,) = struct.unpack(">I", raw_len)
    if length > MAX_SSF_PACKET_LENGTH:
        raise FramingError(f"frame length {length} over 16MiB cap")
    body = _read_exact(stream, length)
    try:
        span = ssf_pb2.SSFSpan.FromString(body)
    except Exception as e:
        # one bad payload does not desync the stream: the frame was
        # fully consumed
        raise SSFParseError(f"bad SSF payload: {e}") from e
    return normalize_span(span)


def _read_exact(stream: BinaryIO, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = stream.read(n - len(buf))
        if not chunk:
            raise FramingError("stream closed mid-frame")
        buf += chunk
    return buf
