"""One-off metric reporting through the trace plane.

The port's copy of ``veneur_tpu/trace/metrics.py``.

Sample constructors mirror ssf/samples.go (:159 ``Count``, :172
``Gauge``, :185 ``Histogram``, :197 ``Set``, :209 ``Timing``, :216
``Status``) and the report helpers mirror trace/metrics/client.go
(:22-50 ``Report``/``ReportBatch``/``ReportOne``): samples are sent
as a span that carries ONLY metrics — no name, no ids — which the
server's ssfmetrics extraction turns back into table updates.
"""

from __future__ import annotations

import time

from veneur_tpu_torch.protocol.gen import ssf_pb2

# module-wide name prefix, the role of ssf.NamePrefix
name_prefix = ""


def _mk(metric, name: str, value: float,
        tags: dict[str, str] | None = None, unit: str = "",
        sample_rate: float = 1.0,
        scope: int = ssf_pb2.SSFSample.DEFAULT) -> ssf_pb2.SSFSample:
    s = ssf_pb2.SSFSample(
        metric=metric, name=name_prefix + name, value=value,
        timestamp=time.time_ns(), unit=unit, sample_rate=sample_rate,
        scope=scope)
    for k, v in (tags or {}).items():
        s.tags[k] = v
    return s


def count(name: str, value: float, tags=None, **kw) -> ssf_pb2.SSFSample:
    return _mk(ssf_pb2.SSFSample.COUNTER, name, value, tags, **kw)


def gauge(name: str, value: float, tags=None, **kw) -> ssf_pb2.SSFSample:
    return _mk(ssf_pb2.SSFSample.GAUGE, name, value, tags, **kw)


def histogram(name: str, value: float, tags=None,
              **kw) -> ssf_pb2.SSFSample:
    return _mk(ssf_pb2.SSFSample.HISTOGRAM, name, value, tags, **kw)


def set_sample(name: str, member: str, tags=None,
               **kw) -> ssf_pb2.SSFSample:
    s = _mk(ssf_pb2.SSFSample.SET, name, 0.0, tags, **kw)
    s.message = member
    return s


def timing(name: str, seconds: float, tags=None,
           **kw) -> ssf_pb2.SSFSample:
    """Duration in seconds -> millisecond histogram (ssf/samples.go:209
    Timing reports in the unit given; ms is the DogStatsD timer
    convention)."""
    return _mk(ssf_pb2.SSFSample.HISTOGRAM, name, seconds * 1000.0,
               tags, unit="ms", **kw)


def status(name: str, state: int, message: str = "",
           tags=None, **kw) -> ssf_pb2.SSFSample:
    s = _mk(ssf_pb2.SSFSample.STATUS, name, float(state), tags, **kw)
    s.status = state
    s.message = message
    return s


def report_batch(client, samples) -> bool:
    """Send samples as a metrics-only span (trace/metrics/client.go:22
    ``Report``).  Returns False when the client dropped it."""
    span = ssf_pb2.SSFSpan()
    span.metrics.extend(samples)
    return client.record(span)


def report_one(client, sample: ssf_pb2.SSFSample) -> bool:
    return report_batch(client, [sample])
