"""Scope-forcing, tag-adding metric client wrapper.

The port's copy of ``veneur_tpu/trace/scoped.py``.

The reference's scopedstatsd (scopedstatsd/client.go:13 ``Client``,
:40 ``ScopedClient``) wraps a statsd client so every emission picks up
fixed tags and a forced aggregation scope per metric class (e.g. all
gauges host-local, all counters global).  Here the wrapped transport
is the trace client's metrics-only span path; scopes map onto the SSF
``scope`` field, which the server's SSF conversion turns into the
``veneurlocalonly``/``veneurglobalonly`` magic-tag semantics.
"""

from __future__ import annotations

from veneur_tpu_torch.protocol.gen import ssf_pb2
from veneur_tpu_torch.trace import metrics as m

# scope constants (ssf/sample.proto Scope)
DEFAULT = ssf_pb2.SSFSample.DEFAULT
LOCAL = ssf_pb2.SSFSample.LOCAL
GLOBAL = ssf_pb2.SSFSample.GLOBAL


class ScopedClient:
    """Wraps a trace ``Client``: fixed tags on everything, optional
    per-class forced scope (scopedstatsd's MetricScopes)."""

    def __init__(self, client, tags: dict[str, str] | None = None,
                 count_scope: int = DEFAULT,
                 gauge_scope: int = DEFAULT,
                 histogram_scope: int = DEFAULT):
        self._client = client
        self._tags = dict(tags or {})
        self._scopes = {"count": count_scope, "gauge": gauge_scope,
                        "histogram": histogram_scope}

    def _tagged(self, tags) -> dict[str, str]:
        out = dict(self._tags)
        out.update(tags or {})
        return out

    def count(self, name: str, value: float = 1.0, tags=None) -> bool:
        return m.report_one(self._client, m.count(
            name, value, self._tagged(tags),
            scope=self._scopes["count"]))

    def incr(self, name: str, tags=None) -> bool:
        return self.count(name, 1.0, tags)

    def gauge(self, name: str, value: float, tags=None) -> bool:
        return m.report_one(self._client, m.gauge(
            name, value, self._tagged(tags),
            scope=self._scopes["gauge"]))

    def histogram(self, name: str, value: float, tags=None) -> bool:
        return m.report_one(self._client, m.histogram(
            name, value, self._tagged(tags),
            scope=self._scopes["histogram"]))

    def timing(self, name: str, seconds: float, tags=None) -> bool:
        return m.report_one(self._client, m.timing(
            name, seconds, self._tagged(tags),
            scope=self._scopes["histogram"]))

    def set(self, name: str, member: str, tags=None) -> bool:
        return m.report_one(self._client,
                            m.set_sample(name, member,
                                         self._tagged(tags)))
