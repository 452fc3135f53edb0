"""Datadog-shape metric sink: chunked JSON series POSTs.

Re-creation of the reference's datadog sink behavior
(sinks/datadog/datadog.go): flushed InterMetrics become DD ``series``
entries ``{metric, points: [[ts, value]], type, hostname, tags,
interval}``, POSTed to ``<api_hostname>/api/v1/series?api_key=`` in
chunks of at most ``flush_max_per_body`` (reference server.go:569-578),
with zlib-deflate bodies.  Counters are emitted as DD "rate" with the
flush interval, matching the reference's rate conversion.

Port of ``veneur_tpu/sinks/datadog.py``.
"""

from __future__ import annotations

import json
import threading
import logging
import urllib.error
import urllib.request
import zlib

from veneur_tpu_torch.core.frame import TYPE_COUNTER as COUNTER_CODE
from veneur_tpu_torch.core.metrics import COUNTER, STATUS, InterMetric
from veneur_tpu_torch.sinks import base as sinks_base
from veneur_tpu_torch.sinks.base import SinkBase

from veneur_tpu_torch.sinks.base import jfloat as _jfloat

log = logging.getLogger("veneur_tpu_torch.sinks.datadog")


class DatadogMetricSink(SinkBase):
    name = "datadog"

    def __init__(self, api_key: str, api_hostname: str,
                 interval_seconds: float, hostname: str = "",
                 flush_max_per_body: int = 25000, timeout: float = 10.0,
                 metric_name_prefix_drops: tuple[str, ...] = (),
                 exclude_tags_prefix_by_prefix_metric: list | None = None):
        super().__init__()
        self.api_key = api_key
        self.api_hostname = api_hostname.rstrip("/")
        self.interval = interval_seconds
        self.hostname = hostname
        self.max_per_body = flush_max_per_body
        self.timeout = timeout
        # drop whole metrics by name prefix (config.go
        # DatadogMetricNamePrefixDrops)
        self.name_prefix_drops = tuple(metric_name_prefix_drops)
        # strip tag PREFIXES from metrics whose name matches a prefix
        # ([{metric_prefix, tags: [...]}], server.go datadog wiring)
        self.tag_prefix_rules = [
            (r.get("metric_prefix", ""), tuple(r.get("tags", ())))
            for r in (exclude_tags_prefix_by_prefix_metric or ())]

    def _finalize_tags(self, m: InterMetric
                       ) -> tuple[list[str], str, str]:
        """Tag housekeeping shared by series and status entries: the
        reference's "magic tags" — ``host:``/``device:`` override the
        DDMetric hostname/device fields and are REMOVED from the tag
        list — run FIRST, matching datadog.go:300-329's single-pass
        order, so a per-metric-prefix exclude rule covering "host:"
        never suppresses the hostname override; prefix stripping then
        applies to the remaining tags."""
        return self._finalize_raw(m.name, m.tags,
                                  m.hostname or self.hostname)

    def _finalize_raw(self, name: str, tags, hostname: str
                      ) -> tuple[list[str], str, str]:
        device = ""
        kept = []
        for t in tags:
            if t.startswith("host:"):
                hostname = t[5:]
            elif t.startswith("device:"):
                device = t[7:]
            else:
                kept.append(t)
        for metric_prefix, tag_prefixes in self.tag_prefix_rules:
            if name.startswith(metric_prefix):
                kept = [t for t in kept
                        if not any(t.startswith(p)
                                   for p in tag_prefixes)]
        return kept, hostname, device

    def _series(self, m: InterMetric) -> dict:
        tags, hostname, device = self._finalize_tags(m)
        entry = {
            "metric": m.name,
            "points": [[m.timestamp, m.value]],
            "tags": tags,
            "host": hostname,
        }
        if device:
            entry["device_name"] = device
        if m.type == COUNTER:
            # DD rate semantics: value averaged over the interval
            entry["type"] = "rate"
            entry["interval"] = int(self.interval) or 1
            entry["points"] = [[m.timestamp,
                                m.value / (self.interval or 1.0)]]
        else:
            entry["type"] = "gauge"
        return entry

    def _status_check(self, m: InterMetric) -> dict:
        """A STATUS InterMetric is a service check, not a series entry
        (reference finalizeMetrics, datadog.go:337-350)."""
        tags, hostname, _ = self._finalize_tags(m)
        return {
            "check": m.name,
            "status": int(m.value),
            "host_name": hostname,
            "timestamp": m.timestamp,
            "message": m.message,
            "tags": tags,
        }

    def flush(self, metrics: list[InterMetric]) -> None:
        if self.name_prefix_drops:
            metrics = [m for m in metrics
                       if not any(m.name.startswith(p)
                                  for p in self.name_prefix_drops)]
        if not metrics:
            return
        checks = [self._status_check(m) for m in metrics
                  if m.type == STATUS]
        series = [self._series(m) for m in metrics
                  if m.type != STATUS]
        if checks:
            self._post_raw(
                f"{self.api_hostname}/api/v1/check_run"
                f"?api_key={self.api_key}", checks)
        for i in range(0, len(series), self.max_per_body):
            self._post(series[i:i + self.max_per_body])

    def flush_frame(self, frame) -> None:
        """Columnar fast path: encode DD series JSON straight off the
        frame's blocks — one pass over the columns per chunk, no
        intermediate dict per metric.  The per-row tag/host/device
        fragment is finalized once per POOL ROW and shared by every
        aggregate block over that row (a histogram's 8 blocks reuse
        it); it is only cacheable when no per-metric-prefix tag rules
        exist, since those match on the full suffixed name."""
        if frame.extra:
            # status checks and synthesized riders take the legacy
            # dict path (they are few and may be STATUS type)
            self.flush(frame.extra)
        frags = self._encode_frame(frame)
        for i in range(0, len(frags), self.max_per_body):
            self._post_body(
                b'{"series":['
                + b",".join(frags[i:i + self.max_per_body]) + b"]}")

    def _encode_frame(self, frame) -> list[bytes]:
        ts = frame.ts
        interval = int(self.interval) or 1
        rate_div = self.interval or 1.0
        drops = self.name_prefix_drops
        cacheable = not self.tag_prefix_rules
        row_cache: dict = {}
        frags: list[bytes] = []
        default_host = frame.hostname or self.hostname
        for b in frame.blocks:
            metas = b.metas
            suffix = b.suffix
            counter = b.type_code == COUNTER_CODE
            vals = b.values
            for j in range(len(b.rows)):
                r = int(b.rows[j])
                name = metas[r].name + suffix
                if drops and any(name.startswith(p) for p in drops):
                    continue
                key = (id(metas), r)
                tail = row_cache.get(key) if cacheable else None
                if tail is None:
                    tags, hostname, device = self._finalize_raw(
                        name, frame.block_tags(b, j), default_host)
                    tail = ('"tags":%s,"host":%s%s}' % (
                        json.dumps(tags), json.dumps(hostname),
                        ',"device_name":%s' % json.dumps(device)
                        if device else "")).encode()
                    if cacheable:
                        row_cache[key] = tail
                v = float(vals[j])
                if counter:
                    head = ('{"metric":%s,"points":[[%d,%s]],'
                            '"type":"rate","interval":%d,' % (
                                json.dumps(name), ts,
                                _jfloat(v / rate_div), interval))
                else:
                    head = ('{"metric":%s,"points":[[%d,%s]],'
                            '"type":"gauge",' % (
                                json.dumps(name), ts, _jfloat(v)))
                frags.append(head.encode() + tail)
        return frags

    def flush_other_samples(self, samples: list) -> None:
        """Events -> the /intake endpoint, service checks ->
        /api/v1/check_run (reference datadog.go:122,:234
        FlushOtherSamples; neither endpoint takes deflate).  Field
        names and omitempty semantics follow DDEvent/DDServiceCheck
        (datadog.go:49-82): events carry msg_title/msg_text, unset
        optionals are OMITTED rather than serialized null."""
        from veneur_tpu_torch.protocol.dogstatsd import ServiceCheck

        def drop_empty(d: dict) -> dict:
            return {k: v for k, v in d.items()
                    if v not in (None, "", [])}

        events, checks = [], []
        for s in samples:
            if isinstance(s, ServiceCheck):
                # check/status/host_name have no omitempty in the
                # reference struct — always present
                checks.append({
                    "check": s.name,
                    "status": int(s.status),
                    "host_name": s.hostname or self.hostname,
                } | drop_empty({
                    "timestamp": s.timestamp,
                    "message": s.message,
                    "tags": list(s.tags)}))
            else:
                events.append(drop_empty({
                    "msg_title": s.title,
                    "msg_text": s.text,
                    "timestamp": s.timestamp,
                    "host": s.hostname or self.hostname,
                    "aggregation_key": s.aggregation_key,
                    "priority": s.priority or "normal",
                    "source_type_name": s.source_type,
                    "alert_type": s.alert_type or "info",
                    "tags": list(s.tags)}))
        if checks:
            self._post_raw(
                f"{self.api_hostname}/api/v1/check_run"
                f"?api_key={self.api_key}", checks)
        if events:
            # the reference wraps events in the undocumented intake
            # shape {"events": {"api": [...]}} (datadog.go:234)
            self._post_raw(
                f"{self.api_hostname}/intake?api_key={self.api_key}",
                {"events": {"api": events}})

    def _post_raw(self, url: str, payload) -> None:
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                r.read()
        except urllib.error.URLError as e:
            log.warning("datadog event/check flush failed: %s", e)

    def _post(self, chunk: list[dict]) -> None:
        self._post_body(json.dumps({"series": chunk}).encode())

    def _post_body(self, raw: bytes) -> None:
        body = zlib.compress(raw)
        url = f"{self.api_hostname}/api/v1/series?api_key={self.api_key}"
        req = urllib.request.Request(
            url, data=body, method="POST",
            headers={"Content-Type": "application/json",
                     "Content-Encoding": "deflate"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                r.read()
        except urllib.error.URLError as e:
            # drop-and-count, never retry within a flush (reference
            # flusher.go:536-549 error handling stance)
            log.warning("datadog flush failed: %s", e)

class DatadogSpanSink(sinks_base.SpanTagExcluder):
    """Span half of the datadog sink (reference
    sinks/datadog/datadog.go:409 DatadogSpanSink): spans buffer
    between flushes, group by trace id, and PUT to the local trace
    agent's ``/v0.3/traces`` as ``[[span, ...], ...]`` with the
    DatadogTraceSpan JSON shape (datadog.go:394)."""
    name = "datadog"

    def __init__(self, trace_api_address: str, hostname: str = "",
                 buffer_size: int = 16384, timeout: float = 10.0):
        self.trace_api_address = trace_api_address.rstrip("/")
        self.hostname = hostname
        self.buffer_size = buffer_size
        self.timeout = timeout
        self._buf: list = []
        self._lock = threading.Lock()
        self.submitted = 0
        self.dropped = 0

    def start(self) -> None:
        pass

    def ingest(self, span) -> None:
        with self._lock:
            if len(self._buf) < self.buffer_size:
                self._buf.append(span)
            else:
                self.dropped += 1

    def _ddspan(self, span) -> dict:
        meta = self.filter_span_tags(span.tags)
        if self.hostname:
            meta.setdefault("host", self.hostname)
        # the resource tag maps to DD's resource field, not meta
        # (datadog.go:89 datadogResourceKey)
        resource = meta.pop("resource", span.name)
        return {
            "trace_id": span.trace_id,
            "span_id": span.id,
            "parent_id": span.parent_id,
            "name": span.name,
            "resource": resource,
            "service": span.service,
            "start": span.start_timestamp,
            "duration": span.end_timestamp - span.start_timestamp,
            "error": 1 if span.error else 0,
            "meta": meta,
            "metrics": {},
            "type": "web",
        }

    def flush(self) -> None:
        with self._lock:
            batch, self._buf = self._buf, []
        if not batch:
            return
        traces: dict[int, list] = {}
        for span in batch:
            traces.setdefault(span.trace_id, []).append(
                self._ddspan(span))
        body = json.dumps(list(traces.values())).encode()
        req = urllib.request.Request(
            f"{self.trace_api_address}/v0.3/traces", data=body,
            method="PUT",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                r.read()
            self.submitted += len(batch)
        except urllib.error.URLError as e:
            log.warning("datadog trace flush failed: %s", e)
