"""Client-side tracing: the server's self-telemetry transport and span
API.

The port's copy of ``veneur_tpu/trace/``: the span client and the span
API (the server's loopback trace client and its flush tracer use
them), one-off metric reporting, the scoped client and the
opentracing shim.

``client``   — async span pump with channel / datagram / framed-stream
               backends (trace/client.go:56, trace/backend.go:47-160)
``spans``    — Trace/Span construction and context-manager API
               (trace/trace.go:53, :269, :329)
``metrics``  — one-off metric reporting via metrics-only spans
               (trace/metrics/client.go:22-50)
``scoped``   — tag-adding, scope-forcing wrapper client
               (scopedstatsd/client.go:13)
``opentracing`` — the opentracing tracer shim
"""

from veneur_tpu_torch.trace.client import (ChannelBackend, Client,
                                           PacketBackend, StreamBackend)
from veneur_tpu_torch.trace.spans import Span, start_trace, start_span
from veneur_tpu_torch.trace import metrics, scoped

__all__ = ["Client", "ChannelBackend", "PacketBackend",
           "StreamBackend", "Span", "start_trace", "start_span",
           "metrics", "scoped"]
