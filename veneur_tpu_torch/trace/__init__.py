"""Client-side tracing: the server's self-telemetry transport and span
API.

The port's cut of ``veneur_tpu/trace/``: the span client and the span
API, which the server's loopback trace client and its flush tracer
use.

``client``   — async span pump with channel / datagram / framed-stream
               backends (trace/client.go:56, trace/backend.go:47-160)
``spans``    — Trace/Span construction and context-manager API
               (trace/trace.go:53, :269, :329)
"""

from veneur_tpu_torch.trace.client import (ChannelBackend, Client,
                                           PacketBackend, StreamBackend)
from veneur_tpu_torch.trace.spans import Span, start_trace, start_span

__all__ = ["Client", "ChannelBackend", "PacketBackend",
           "StreamBackend", "Span", "start_trace", "start_span"]
