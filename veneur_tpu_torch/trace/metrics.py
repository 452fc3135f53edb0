"""One-off metric reporting through the trace plane: the proxy's
self-telemetry gauges.

Port of the part of ``veneur_tpu/trace/metrics.py`` the port runs: the
gauge constructor (ssf/samples.go:172 ``Gauge``) and ``report_batch``
(trace/metrics/client.go:22 ``ReportBatch``), which sends samples as a
span that carries only metrics — no name, no ids.
"""

from __future__ import annotations

import time

from veneur_tpu_torch.protocol.gen import ssf_pb2

def gauge(name: str, value: float) -> ssf_pb2.SSFSample:
    return ssf_pb2.SSFSample(
        metric=ssf_pb2.SSFSample.GAUGE, name=name, value=value,
        timestamp=time.time_ns(), sample_rate=1.0,
        scope=ssf_pb2.SSFSample.DEFAULT)


def report_batch(client, samples) -> bool:
    """Send samples as a metrics-only span (trace/metrics/client.go:22
    ``Report``).  Returns False when the client dropped it."""
    span = ssf_pb2.SSFSpan()
    span.metrics.extend(samples)
    return client.record(span)
