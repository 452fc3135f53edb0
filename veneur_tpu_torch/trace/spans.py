"""Span construction and the context-manager tracing API.

The port's copy of ``veneur_tpu/trace/spans.py``.

The reference's ``Trace`` struct and helpers (trace/trace.go:53
``Trace``, :269 ``StartSpanFromContext``, :329 ``StartTrace``) carried
over to idiomatic Python: a ``Span`` wraps an ``SSFSpan`` protobuf,
children link via ``trace_id``/``parent_id``, and ``start_span`` is a
context manager that times the block, marks errors, and records to a
client on exit.

IDs are random positive 63-bit ints, matching the reference's
``proto.Int64(rand.Int63())`` id scheme.
"""

from __future__ import annotations

import contextlib
import secrets
import time

from veneur_tpu_torch.protocol.gen import ssf_pb2


def _new_id() -> int:
    # positive 63-bit, never 0 (0 means "unset" on the wire)
    return secrets.randbits(63) | 1


class Span:
    """A live span: mutate via add_tag/set_error, then ``finish()``
    (or use the ``start_span`` context manager)."""

    def __init__(self, name: str, service: str = "",
                 trace_id: int | None = None,
                 parent_id: int = 0,
                 tags: dict[str, str] | None = None,
                 indicator: bool = False):
        self.proto = ssf_pb2.SSFSpan(
            id=_new_id(),
            trace_id=trace_id if trace_id is not None else _new_id(),
            parent_id=parent_id,
            name=name,
            service=service,
            indicator=indicator,
            start_timestamp=time.time_ns(),
        )
        for k, v in (tags or {}).items():
            self.proto.tags[k] = v

    # -- identity ------------------------------------------------------
    @property
    def trace_id(self) -> int:
        return self.proto.trace_id

    @property
    def span_id(self) -> int:
        return self.proto.id

    # -- mutation ------------------------------------------------------
    def add_tag(self, key: str, value: str) -> None:
        self.proto.tags[key] = value

    def set_error(self, err: BaseException | bool = True) -> None:
        self.proto.error = bool(err)
        if isinstance(err, BaseException):
            self.proto.tags["error.msg"] = str(err)
            self.proto.tags["error.type"] = type(err).__name__

    def add_sample(self, sample: ssf_pb2.SSFSample) -> None:
        """Attach a metric sample that flushes with the span (the
        samples ride the span to the server's ssfmetrics extraction)."""
        self.proto.metrics.append(sample)

    def child(self, name: str, **kw) -> "Span":
        """A child span in the same trace."""
        kw.setdefault("service", self.proto.service)
        return Span(name, trace_id=self.proto.trace_id,
                    parent_id=self.proto.id, **kw)

    # -- completion ----------------------------------------------------
    def finish(self, client=None) -> ssf_pb2.SSFSpan:
        if not self.proto.end_timestamp:
            self.proto.end_timestamp = time.time_ns()
        if client is not None:
            client.record(self.proto)
        return self.proto

    def duration_ns(self) -> int:
        if not self.proto.end_timestamp:
            return 0
        return self.proto.end_timestamp - self.proto.start_timestamp


def start_trace(name: str, **kw) -> Span:
    """A new root span with a fresh trace id (trace/trace.go:329)."""
    return Span(name, **kw)


@contextlib.contextmanager
def start_span(client, name: str, parent: Span | None = None, **kw):
    """Context manager: times the block, marks raised exceptions as
    span errors (re-raising), records to ``client`` on exit.

    >>> with start_span(client, "flush", service="veneur") as sp:
    ...     sp.add_tag("part", "sinks")
    """
    sp = parent.child(name, **kw) if parent is not None else Span(
        name, **kw)
    try:
        yield sp
    except BaseException as e:
        sp.set_error(e)
        raise
    finally:
        sp.finish(client)
