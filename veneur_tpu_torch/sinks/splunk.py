"""Splunk HEC span sink (reference sinks/splunk, 1291 LoC).

Spans buffer between flushes and POST to the HTTP Event Collector
(``/services/collector/event``) as newline-delimited JSON events with
token auth.  The reference's operational behavior is kept:

- sampling: 1/N of traces keep their spans, keyed on trace id so
  whole traces sample together; ONLY indicator spans are exempt
  (kept despite sampling, marked ``partial``) — error spans are
  sampled like any other (reference splunk.go:452-495);
- batched submission across ``submission_workers`` threads, at most
  ``batch_size`` events per POST (reference SplunkHecBatchSize /
  SplunkHecSubmissionWorkers);
- connection recycling: each worker's HTTP connection is abandoned
  after ``max_connection_lifetime`` plus a uniform random slice of
  ``connection_lifetime_jitter`` (reference server.go:660-697) so a
  fleet's connections don't stampede one indexer forever — a HEC
  endpoint behind a load balancer rebalances only on reconnect;
- ``tls_validate_hostname``: pin the expected server hostname on the
  TLS handshake (empty = default verification).

Port of ``veneur_tpu/sinks/splunk.py``.
"""

from __future__ import annotations

import http.client
import json
import logging
import random
import ssl
import threading
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor

log = logging.getLogger("veneur_tpu_torch.sinks")


from veneur_tpu_torch.sinks.base import SpanTagExcluder


class SplunkSpanSink(SpanTagExcluder):
    name = "splunk"

    def __init__(self, hec_address: str, token: str,
                 sample_rate: int = 1, max_per_flush: int = 10000,
                 hostname: str = "", batch_size: int = 100,
                 submission_workers: int = 1,
                 send_timeout: float = 10.0,
                 ingest_timeout: float = 0.0,
                 max_connection_lifetime: float = 0.0,
                 connection_lifetime_jitter: float = 0.0,
                 tls_validate_hostname: str = ""):
        self.hec_address = hec_address.rstrip("/")
        self.token = token
        self.sample_rate = max(1, int(sample_rate))
        self.max_per_flush = max_per_flush
        self.hostname = hostname
        self.batch_size = max(1, int(batch_size))
        self.submission_workers = max(1, int(submission_workers))
        self.send_timeout = send_timeout or 10.0
        self.ingest_timeout = ingest_timeout
        self.max_connection_lifetime = max_connection_lifetime
        self.connection_lifetime_jitter = connection_lifetime_jitter
        self.tls_validate_hostname = tls_validate_hostname
        self._buf: list[dict] = []
        self._lock = threading.Lock()
        self._pool: ThreadPoolExecutor | None = None
        # per-worker (opener, deadline) so recycling is independent
        self._local = threading.local()
        self.submitted = 0
        self.skipped = 0

    def start(self) -> None:
        self._pool = ThreadPoolExecutor(
            max_workers=self.submission_workers,
            thread_name_prefix="splunk-hec")

    def stop(self) -> None:
        """End the submission workers (a POST in progress ends within
        its send timeout)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def ingest(self, span) -> None:
        # 1/sample_rate of traces kept, keyed on trace id so a
        # trace's spans sample together; ONLY indicator spans are
        # exempt (reference splunk.go:452-458 — error spans are not)
        would_drop = span.trace_id % self.sample_rate != 0
        if would_drop and not span.indicator:
            self.skipped += 1
            return
        # a span carrying any excluded tag KEY is skipped ENTIRELY —
        # Splunk bills on volume, not tag cardinality, so this sink
        # drops the span rather than stripping the tag
        # (splunk.go:461-466 and the SetExcludedTags comment)
        if any(k in self.excluded_tags for k in span.tags):
            self.skipped += 1
            return
        # SerializedSSF wire shape (splunk.go:531-543): hex ids,
        # second-resolution float timestamps, ns duration; sourcetype
        # is the span's service (splunk.go:503)
        serialized = {
            "trace_id": format(span.trace_id, "x"),
            "id": format(span.id, "x"),
            "parent_id": format(span.parent_id, "x"),
            "start_timestamp": span.start_timestamp / 1e9,
            "end_timestamp": span.end_timestamp / 1e9,
            "duration_ns": span.end_timestamp -
            span.start_timestamp,
            "error": span.error,
            "service": span.service,
            "tags": dict(span.tags),
            "indicator": span.indicator,
            "name": span.name,
        }
        if would_drop:
            # indicator span kept despite sampling: mark the trace
            # partial so full traces remain searchable (splunk.go:489)
            serialized["partial"] = True
        event = {
            "host": self.hostname,
            "sourcetype": span.service,
            "time": span.start_timestamp / 1e9,
            "event": serialized,
        }
        with self._lock:
            if len(self._buf) < self.max_per_flush:
                self._buf.append(event)
            else:
                self.skipped += 1

    # ------------------------------------------------------------------

    def _connection(self):
        """Per-worker PERSISTENT http.client connection (keep-alive
        across POSTs), torn down and redialed once the jittered
        lifetime deadline passes — a fresh dial is what lets a load
        balancer in front of the HEC endpoint rebalance."""
        now = time.monotonic()
        st = getattr(self._local, "state", None)
        if st is not None and (self.max_connection_lifetime <= 0 or
                               now < st[1]):
            return st[0]
        if st is not None:
            try:
                st[0].close()
            except OSError:
                pass
        u = urllib.parse.urlsplit(self.hec_address)
        if u.scheme == "https":
            ctx = ssl.create_default_context()
            conn = http.client.HTTPSConnection(
                u.hostname, u.port or 443,
                timeout=self.send_timeout, context=ctx)
            if self.tls_validate_hostname:
                # validate the certificate against the PINNED name
                # instead of the URL host (HEC behind a load balancer
                # addressed by IP, certs carrying the service name)
                pinned = self.tls_validate_hostname

                def connect(conn=conn, ctx=ctx, pinned=pinned):
                    import socket as _s
                    conn.sock = _s.create_connection(
                        (conn.host, conn.port), conn.timeout)
                    conn.sock = ctx.wrap_socket(
                        conn.sock, server_hostname=pinned)
                conn.connect = connect
        else:
            conn = http.client.HTTPConnection(
                u.hostname, u.port or 80, timeout=self.send_timeout)
        deadline = float("inf")
        if self.max_connection_lifetime > 0:
            deadline = now + self.max_connection_lifetime + \
                random.uniform(0.0, self.connection_lifetime_jitter)
        self._local.state = (conn, deadline)
        return conn

    def _drop_connection(self) -> None:
        st = getattr(self._local, "state", None)
        if st is not None:
            try:
                st[0].close()
            except OSError:
                pass
            self._local.state = None

    def _post(self, batch: list[dict]) -> None:
        body = "\n".join(json.dumps(e) for e in batch).encode()
        path = urllib.parse.urlsplit(self.hec_address).path + \
            "/services/collector/event"
        headers = {"Authorization": f"Splunk {self.token}",
                   "Content-Type": "application/json"}
        # one retry: a keep-alive connection the server idled out
        # raises on the first reuse
        for attempt in (0, 1):
            conn = self._connection()
            try:
                conn.request("POST", path, body=body,
                             headers=headers)
                resp = conn.getresponse()
                detail = resp.read()
                if resp.status >= 300:
                    # bad token / malformed event: the POST "worked"
                    # but nothing was indexed — drop-and-log, no retry
                    log.warning("splunk HEC rejected batch: %s %s",
                                resp.status, detail[:200])
                    return
                with self._lock:
                    self.submitted += len(batch)
                return
            except OSError as e:
                self._drop_connection()
                if attempt:
                    log.warning("splunk HEC flush failed: %s", e)

    def flush(self) -> None:
        with self._lock:
            batch, self._buf = self._buf, []
        if not batch:
            return
        chunks = [batch[i:i + self.batch_size]
                  for i in range(0, len(batch), self.batch_size)]
        if self._pool is None:
            for c in chunks:
                self._post(c)
            return
        futs = [self._pool.submit(self._post, c) for c in chunks]
        deadline = (time.monotonic() + self.ingest_timeout
                    if self.ingest_timeout > 0 else None)
        for f in futs:
            try:
                timeout = (None if deadline is None else
                           max(0.0, deadline - time.monotonic()))
                f.result(timeout=timeout)
            except Exception as e:
                log.warning("splunk HEC submission worker: %s", e)
