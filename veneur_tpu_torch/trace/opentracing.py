"""Opentracing-compatible tracer shim over the native span API.

The port's copy of ``veneur_tpu/trace/opentracing.py``.

The reference's public client-compat surface
(/root/reference/trace/opentracing.go:1-659): an opentracing
``Tracer``/``Span`` pair with context propagation over HTTP headers
(four supported header naming schemes, tried in order), text maps and
a binary format (the SSF span protobuf).  Python has no canonical
opentracing ABI to satisfy, so the shim exposes the same METHOD
surface and semantics — ``start_span(child_of=...)``,
``inject``/``extract`` with the same carrier formats and the same
header groups byte-for-byte — so a client ported from the Go library
finds the identical contract.
"""

from __future__ import annotations

import io
import time
from dataclasses import dataclass, field

from veneur_tpu_torch.protocol.gen import ssf_pb2
from veneur_tpu_torch.trace import spans as _spans

# tag key carrying the trace resource (reference trace/trace.go:22)
RESOURCE_KEY = "resource"

# carrier formats (opentracing.BuiltinFormat equivalents)
FORMAT_BINARY = "binary"
FORMAT_TEXT_MAP = "text_map"
FORMAT_HTTP_HEADERS = "http_headers"


class UnsupportedFormatError(ValueError):
    """opentracing.ErrUnsupportedFormat."""


class SpanContextCorruptedError(ValueError):
    """No usable trace/span ids in the carrier."""


@dataclass
class HeaderGroup:
    """One supported tracing-header naming scheme
    (reference opentracing.go:22 HeaderGroup)."""
    trace_id: str
    span_id: str
    hexadecimal: bool = False
    outgoing_headers: dict = field(default_factory=dict)


# Supported header formats, tried in order on extract; the FIRST is
# what inject writes (reference opentracing.go:38 HeaderFormats).
# Matching is case-insensitive, exactly as textMapReaderGet.
HEADER_FORMATS = [
    # Envoy/Lightstep naming; checked first because Envoy is usually
    # the nearest parent when present
    HeaderGroup("ot-tracer-traceid", "ot-tracer-spanid",
                hexadecimal=True,
                outgoing_headers={"ot-tracer-sampled": "true"}),
    HeaderGroup("Trace-Id", "Span-Id"),        # OpenTracing
    HeaderGroup("X-Trace-Id", "X-Span-Id"),    # Ruby
    HeaderGroup("Traceid", "Spanid"),          # Veneur
]


class SpanContext:
    """Propagated identity of a span (reference spanContext; baggage
    carries the ids, opentracing.go:128-199)."""

    def __init__(self, trace_id: int, span_id: int,
                 parent_id: int = 0, resource: str = "",
                 baggage: dict[str, str] | None = None):
        self.baggage: dict[str, str] = dict(baggage or {})
        self.baggage.setdefault("traceid", str(trace_id))
        self.baggage.setdefault("spanid", str(span_id))
        self.baggage.setdefault("parentid", str(parent_id))
        if resource:
            self.baggage.setdefault(RESOURCE_KEY, resource)

    def _int(self, key: str) -> int:
        try:
            return int(self.baggage.get(key, "0"))
        except ValueError:
            return 0

    @property
    def trace_id(self) -> int:
        return self._int("traceid")

    @property
    def span_id(self) -> int:
        return self._int("spanid")

    @property
    def parent_id(self) -> int:
        return self._int("parentid")

    @property
    def resource(self) -> str:
        return self.baggage.get(RESOURCE_KEY, "")

    def foreach_baggage_item(self, handler) -> None:
        """handler(k, v) -> False stops iteration (the opentracing
        ForeachBaggageItem contract)."""
        for k, v in self.baggage.items():
            if handler(k, v) is False:
                return


class Span:
    """Opentracing-shaped wrapper over the native span
    (reference opentracing.go:202 Span embeds Trace)."""

    def __init__(self, inner: _spans.Span, tracer: "Tracer"):
        self.inner = inner
        self._tracer = tracer
        self._baggage: dict[str, str] = {}

    # -- opentracing surface ------------------------------------------

    def context(self) -> SpanContext:
        return SpanContext(self.inner.trace_id, self.inner.span_id,
                           self.inner.proto.parent_id,
                           self.inner.proto.tags.get(RESOURCE_KEY, ""),
                           baggage=dict(self._baggage))

    def set_operation_name(self, name: str) -> "Span":
        self.inner.proto.name = name
        return self

    def set_tag(self, key: str, value) -> "Span":
        self.inner.add_tag(key, str(value))
        if key == "name":
            self.inner.proto.name = str(value)
        return self

    def set_baggage_item(self, key: str, value: str) -> "Span":
        self._baggage[key] = value
        return self

    def baggage_item(self, key: str) -> str:
        return self._baggage.get(key, "")

    def log_fields(self, **fields) -> None:
        """Reference LogFields records fields as tags."""
        for k, v in fields.items():
            self.inner.add_tag(k, str(v))

    def log_kv(self, **fields) -> None:
        self.log_fields(**fields)

    def tracer(self) -> "Tracer":
        return self._tracer

    def finish(self, client=None) -> None:
        """Finish and (with a client) record the span — Finish /
        ClientFinish (opentracing.go:214/:219)."""
        self.inner.finish(client)

    def finish_with_options(self, finish_time: float | None = None,
                            client=None) -> None:
        if finish_time is not None:
            self.inner.proto.end_timestamp = int(finish_time * 1e9)
        self.inner.finish(client)

    # convenience parity with the native API
    def __enter__(self) -> "Span":
        return self

    def __exit__(self, etype, err, tb) -> bool:
        if err is not None:
            self.inner.set_error(err)
        self.finish()
        return False


class Tracer:
    """The reference's Tracer (opentracing.go:354): span creation from
    contexts plus inject/extract over the supported carriers."""

    # ------------------------------------------------------------------

    def start_span(self, operation_name: str = "",
                   child_of: "Span | SpanContext | None" = None,
                   tags: dict | None = None,
                   start_time: float | None = None,
                   service: str = "") -> Span:
        if child_of is None:
            inner = _spans.start_trace(operation_name, service=service)
        else:
            ctx = (child_of.context()
                   if isinstance(child_of, Span) else child_of)
            inner = _spans.Span(operation_name, service=service,
                                trace_id=ctx.trace_id,
                                parent_id=ctx.span_id)
            if ctx.resource:
                inner.add_tag(RESOURCE_KEY, ctx.resource)
        if start_time is not None:
            inner.proto.start_timestamp = int(start_time * 1e9)
        span = Span(inner, self)
        for k, v in (tags or {}).items():
            span.set_tag(k, v)
        return span

    # ------------------------------------------------------------------

    def inject(self, span_context: SpanContext, format: str,
               carrier) -> None:
        """Write the context into the carrier (opentracing.go:525
        Inject): binary = the SSF span protobuf, HTTP headers = the
        default (first) header group, text maps = the baggage."""
        if format == FORMAT_BINARY:
            if not hasattr(carrier, "write"):
                raise UnsupportedFormatError("binary carrier must be "
                                             "a writable stream")
            pb = ssf_pb2.SSFSpan(
                trace_id=span_context.trace_id,
                id=span_context.span_id,
                parent_id=span_context.parent_id)
            pb.tags[RESOURCE_KEY] = span_context.resource
            carrier.write(pb.SerializeToString())
            return
        if format == FORMAT_HTTP_HEADERS:
            hdr = HEADER_FORMATS[0]
            base = 16 if hdr.hexadecimal else 10
            fmt = "{:x}" if base == 16 else "{:d}"
            carrier[hdr.span_id] = fmt.format(span_context.span_id)
            carrier[hdr.trace_id] = fmt.format(span_context.trace_id)
            for name, value in hdr.outgoing_headers.items():
                carrier[name] = value
            return
        if format == FORMAT_TEXT_MAP:
            for k, v in span_context.baggage.items():
                carrier[k] = v
            return
        raise UnsupportedFormatError(format)

    def extract(self, format: str, carrier) -> SpanContext:
        """Read a PARENT context out of the carrier
        (opentracing.go:583 Extract): header groups are tried in
        order, names case-insensitively."""
        if format == FORMAT_BINARY:
            data = (carrier.read() if hasattr(carrier, "read")
                    else bytes(carrier))
            pb = ssf_pb2.SSFSpan.FromString(data)
            return SpanContext(pb.trace_id, pb.id,
                               resource=pb.tags.get(RESOURCE_KEY, ""))
        if not hasattr(carrier, "items"):
            raise UnsupportedFormatError(format)
        lower = {k.lower(): v for k, v in carrier.items()}
        for hdr in HEADER_FORMATS:
            base = 16 if hdr.hexadecimal else 10
            try:
                trace_id = int(lower.get(hdr.trace_id.lower(), "0"),
                               base)
                span_id = int(lower.get(hdr.span_id.lower(), "0"),
                              base)
            except ValueError:
                continue
            if trace_id and span_id:
                return SpanContext(
                    trace_id, span_id,
                    resource=lower.get(RESOURCE_KEY, ""))
        raise SpanContextCorruptedError(
            "error parsing fields from TextMapReader")

    # ------------------------------------------------------------------
    # HTTP conveniences (opentracing.go:485-520)

    def inject_header(self, span: Span | SpanContext,
                      headers) -> None:
        ctx = span.context() if isinstance(span, Span) else span
        self.inject(ctx, FORMAT_HTTP_HEADERS, headers)

    def extract_request_child(self, resource: str, headers,
                              name: str) -> Span:
        """Extract a parent from request headers and start its child
        (opentracing.go:499 ExtractRequestChild)."""
        parent = self.extract(FORMAT_HTTP_HEADERS, headers)
        inner = _spans.Span(name, trace_id=parent.trace_id,
                            parent_id=parent.span_id)
        inner.add_tag(RESOURCE_KEY, resource)
        return Span(inner, self)


# the module-level default, as the reference's GlobalTracer
GLOBAL_TRACER = Tracer()
