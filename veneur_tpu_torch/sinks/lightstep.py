"""LightStep span sink (reference sinks/lightstep, 386 LoC).

The reference drives the opentracing LightStep tracer pool; without
that SDK here, spans convert directly to LightStep report JSON and
POST to the collector's HTTP endpoint per flush.  Functionally
equivalent for span delivery; the reference's client-pool load
spreading collapses to one buffered reporter.

Port of ``veneur_tpu/sinks/lightstep.py``.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.request

log = logging.getLogger("veneur_tpu_torch.sinks")


from veneur_tpu_torch.sinks.base import SpanTagExcluder


class LightStepSpanSink(SpanTagExcluder):
    name = "lightstep"

    def __init__(self, access_token: str,
                 collector_host: str = "https://collector.lightstep.com",
                 component_name: str = "veneur",
                 maximum_spans: int = 100000,
                 num_clients: int = 1,
                 reconnect_period: float = 300.0):
        self.access_token = access_token
        self.collector = collector_host.rstrip("/")
        self.component_name = component_name
        # buffer cap between flushes (lightstep_maximum_spans); spans
        # past it are dropped-and-counted like the reference's
        # bounded tracer buffers
        self.maximum_spans = max(1, int(maximum_spans))
        # lightstep_num_clients spreads reports across N parallel
        # submissions per flush (the reference's client pool)
        self.num_clients = max(1, int(num_clients))
        # lightstep_reconnect_period is accepted for config parity;
        # reports here are connectionless (urllib dials per POST), so
        # every flush already reconnects and the period is trivially
        # satisfied
        self.reconnect_period = float(reconnect_period)
        self._buf: list[dict] = []
        self._lock = threading.Lock()
        self.submitted = 0
        self.dropped = 0

    def start(self) -> None:
        pass

    def ingest(self, span) -> None:
        with self._lock:
            if len(self._buf) >= self.maximum_spans:
                self.dropped += 1
                return
            self._buf.append({
                "span_guid": str(span.id),
                "trace_guid": str(span.trace_id),
                "runtime_guid": span.service or self.component_name,
                "span_name": span.name,
                "oldest_micros": span.start_timestamp // 1000,
                "youngest_micros": span.end_timestamp // 1000,
                "error_flag": bool(span.error),
                # synthesized attributes the reference sets on every
                # span (lightstep.go:159-167): indicator as a string
                # bool, the hardcoded type, and error-code (0/1);
                # span tags follow and may override
                "attributes": [
                    {"Key": "indicator",
                     "Value": str(bool(getattr(span, "indicator",
                                               False))).lower()},
                    {"Key": "type", "Value": "http"},
                    {"Key": "error-code",
                     "Value": str(1 if span.error else 0)},
                ] + [
                    {"Key": k, "Value": v}
                    for k, v in self.filter_span_tags(
                        span.tags).items()],
            })

    def _report(self, batch: list[dict]) -> None:
        body = json.dumps({
            "auth": {"access_token": self.access_token},
            "span_records": batch,
        }).encode()
        req = urllib.request.Request(
            f"{self.collector}/api/v0/reports", data=body,
            headers={"Content-Type": "application/json"},
            method="POST")
        try:
            with urllib.request.urlopen(req, timeout=10.0) as r:
                r.read()
            with self._lock:
                self.submitted += len(batch)
        except OSError as e:
            log.warning("lightstep flush failed: %s", e)

    def flush(self) -> None:
        with self._lock:
            batch, self._buf = self._buf, []
        if not batch:
            return
        n = self.num_clients
        parts = [batch[i::n] for i in range(n)]
        parts = [p for p in parts if p]
        if len(parts) == 1:
            self._report(parts[0])
            return
        # the client pool: N genuinely concurrent submissions
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(len(parts)) as pool:
            list(pool.map(self._report, parts))
