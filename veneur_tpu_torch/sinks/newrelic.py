"""New Relic sinks (reference sinks/newrelic, 621 LoC: the harvester
SDK's metric + span ingest APIs, here as direct HTTP).

Metrics POST to the Metric API (``/metric/v1``) and spans to the Trace
API (``/trace/v1``) with Api-Key auth and common attributes.

Port of ``veneur_tpu/sinks/newrelic.py``.
"""

from __future__ import annotations

import gzip
import json
import logging
import threading
import urllib.request

from veneur_tpu_torch.core.metrics import COUNTER, STATUS, InterMetric
from veneur_tpu_torch.sinks import base as sinks_base
from veneur_tpu_torch.sinks.base import SinkBase

log = logging.getLogger("veneur_tpu_torch.sinks")


def _tags_to_attrs(tags) -> dict:
    out = {}
    for t in tags:
        k, _, v = t.partition(":")
        out[k] = v
    return out


class NewRelicMetricSink(SinkBase):
    name = "newrelic"

    def __init__(self, insert_key: str,
                 endpoint: str = "https://metric-api.newrelic.com",
                 common_attributes: dict | None = None,
                 interval: float = 10.0,
                 account_id: int = 0, region: str = "",
                 event_type: str = "veneur",
                 service_check_event_type: str = "veneurCheck"):
        super().__init__()
        self.insert_key = insert_key
        # newrelic_region: eu routes to the EU data centers (the
        # harvester SDK's region option); explicit endpoints win
        if region.lower() == "eu" and "newrelic.com" in endpoint and \
                ".eu." not in endpoint:
            endpoint = endpoint.replace("metric-api.",
                                        "metric-api.eu.")
        self.endpoint = endpoint.rstrip("/")
        self.common = dict(common_attributes or {})
        self.interval = interval
        # events/service checks go to the Insights Event API, which is
        # account-scoped (newrelic_account_id) with configurable
        # eventType names
        self.account_id = int(account_id)
        self.event_type = event_type
        self.service_check_event_type = service_check_event_type
        # the Event API is region-scoped too (EU license keys are
        # rejected by the US collector)
        self.events_endpoint = (
            "https://insights-collector.eu01.nr-data.net"
            if region.lower() == "eu"
            else "https://insights-collector.newrelic.com")
        self.flushed_total = 0

    def _post_events(self, out: list, what: str) -> bool:
        body = gzip.compress(json.dumps(out).encode())
        req = urllib.request.Request(
            f"{self.events_endpoint}/v1/accounts/"
            f"{self.account_id}/events", data=body,
            headers={"Content-Type": "application/json",
                     "Content-Encoding": "gzip",
                     "Api-Key": self.insert_key}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=10.0) as r:
                r.read()
            return True
        except OSError as e:
            log.warning("newrelic %s flush failed: %s", what, e)
            return False

    def flush_other_samples(self, samples: list) -> None:
        """Events + service checks -> the account-scoped Event API
        (reference newrelic sink's FlushOtherSamples)."""
        if not samples or self.account_id <= 0:
            return
        out = []
        for s in samples:
            is_check = hasattr(s, "status")
            item = {"eventType": (self.service_check_event_type
                                  if is_check else self.event_type)}
            item.update(_tags_to_attrs(getattr(s, "tags", ())))
            item["title"] = getattr(s, "title", "") or \
                getattr(s, "name", "")
            if is_check:
                item["status"] = int(s.status)
            msg = getattr(s, "message", "") or getattr(s, "text", "")
            if msg:
                item["message"] = msg
            out.append(item)
        self._post_events(out, "event")

    _STATUS_NAMES = {0: "OK", 1: "WARNING", 2: "CRITICAL"}

    def _flush_status_checks(self, checks: list[InterMetric]) -> None:
        """STATUS metrics are service-check EVENTS, not metric
        entries (reference metric.go:142-166: eventType/name/
        statusCode/status attributes through the Event API)."""
        if self.account_id <= 0:
            # Event API is account-scoped: without newrelic_account_id
            # checks cannot be delivered anywhere (loud, not silent)
            log.warning("newrelic: dropping %d service checks — "
                        "newrelic_account_id is not configured",
                        len(checks))
            return
        out = []
        for m in checks:
            attrs = _tags_to_attrs(m.tags)
            if m.hostname:
                attrs["hostname"] = m.hostname
            if m.message:
                attrs["message"] = m.message
            attrs.update({
                "eventType": self.service_check_event_type,
                "name": m.name,
                "timestamp": m.timestamp,
                "statusCode": int(m.value),
                "status": self._STATUS_NAMES.get(int(m.value),
                                                 "UNKNOWN"),
            })
            out.append(attrs)
        if self._post_events(out, "service-check"):
            self.flushed_total += len(out)

    def flush(self, metrics: list[InterMetric]) -> None:
        if not metrics:
            return
        checks = [m for m in metrics if m.type == STATUS]
        if checks:
            self._flush_status_checks(checks)
        out = []
        for m in metrics:
            if m.type == STATUS:
                continue
            attrs = _tags_to_attrs(m.tags)
            # hostname/message ride as attributes (metric.go:117-122)
            if m.hostname:
                attrs["hostname"] = m.hostname
            if m.message:
                attrs["message"] = m.message
            item = {"name": m.name,
                    "timestamp": m.timestamp * 1000,
                    "attributes": attrs}
            if m.type == COUNTER:
                item["type"] = "count"
                item["value"] = m.value
                item["interval.ms"] = int(self.interval * 1000)
            else:
                item["type"] = "gauge"
                item["value"] = m.value
            out.append(item)
        if not out:
            return
        body = gzip.compress(json.dumps(
            [{"common": {"attributes": self.common}, "metrics": out}]
        ).encode())
        req = urllib.request.Request(
            f"{self.endpoint}/metric/v1", data=body,
            headers={"Content-Type": "application/json",
                     "Content-Encoding": "gzip",
                     "Api-Key": self.insert_key}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=10.0) as r:
                r.read()
            self.flushed_total += len(out)
        except OSError as e:
            log.warning("newrelic metric flush failed: %s", e)


class NewRelicSpanSink(sinks_base.SpanTagExcluder):
    name = "newrelic"

    def __init__(self, insert_key: str,
                 endpoint: str = "https://trace-api.newrelic.com",
                 service_name: str = "veneur",
                 trace_observer_url: str = "", region: str = ""):
        self.insert_key = insert_key
        # newrelic_trace_observer_url (Infinite Tracing) overrides the
        # default Trace API endpoint entirely
        if trace_observer_url:
            endpoint = trace_observer_url
        elif region.lower() == "eu" and "newrelic.com" in endpoint \
                and ".eu." not in endpoint:
            endpoint = endpoint.replace("trace-api.", "trace-api.eu.")
        self.endpoint = endpoint.rstrip("/")
        self.service_name = service_name
        self._buf: list[dict] = []
        self._lock = threading.Lock()
        self.submitted = 0

    def start(self) -> None:
        pass

    def ingest(self, span) -> None:
        attrs = _tags_to_attrs(
            f"{k}:{v}" for k, v in
            self.filter_span_tags(span.tags).items())
        attrs.update({
            "service.name": span.service or self.service_name,
            "name": span.name,
            "duration.ms": (span.end_timestamp -
                            span.start_timestamp) / 1e6,
            "error": span.error,
        })
        if span.parent_id:
            attrs["parent.id"] = str(span.parent_id)
        with self._lock:
            self._buf.append({
                "id": str(span.id),
                "trace.id": str(span.trace_id),
                "timestamp": span.start_timestamp // 1_000_000,
                "attributes": attrs,
            })

    def flush(self) -> None:
        with self._lock:
            batch, self._buf = self._buf, []
        if not batch:
            return
        body = gzip.compress(json.dumps(
            [{"common": {}, "spans": batch}]).encode())
        req = urllib.request.Request(
            f"{self.endpoint}/trace/v1", data=body,
            headers={"Content-Type": "application/json",
                     "Content-Encoding": "gzip",
                     "Api-Key": self.insert_key,
                     "Data-Format": "newrelic",
                     "Data-Format-Version": "1"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=10.0) as r:
                r.read()
            self.submitted += len(batch)
        except OSError as e:
            log.warning("newrelic span flush failed: %s", e)
