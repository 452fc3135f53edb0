"""SignalFx metric sink (reference sinks/signalfx, 1413 LoC).

Flushed InterMetrics POST to ``/v2/datapoint`` as JSON datapoints with
tag dimensions.  The reference's headline features are kept: counters
vs gauges split, per-tag API-key routing (``vary_key_by``: metrics
carrying that tag key use the matching token's client,
server.go:520-545), and chunked bodies.

Port of ``veneur_tpu/sinks/signalfx.py``.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.request

from veneur_tpu_torch.core.frame import TYPE_COUNTER as COUNTER_CODE
from veneur_tpu_torch.core.metrics import COUNTER, InterMetric
from veneur_tpu_torch.sinks.base import SinkBase, jfloat as _jfloat

log = logging.getLogger("veneur_tpu_torch.sinks")


class SignalFxSink(SinkBase):
    name = "signalfx"

    def __init__(self, api_key: str,
                 endpoint: str = "https://ingest.signalfx.com",
                 vary_key_by: str = "",
                 per_tag_api_keys: dict[str, str] | None = None,
                 max_per_body: int = 5000, hostname: str = "",
                 hostname_tag: str = "host",
                 metric_name_prefix_drops: tuple[str, ...] = (),
                 metric_tag_prefix_drops: tuple[str, ...] = (),
                 dynamic_per_tag_api_keys_enable: bool = False,
                 dynamic_per_tag_api_keys_refresh_period: float = 600.0,
                 endpoint_api: str = ""):
        super().__init__()
        self.api_key = api_key
        self.endpoint = endpoint.rstrip("/")
        self.vary_key_by = vary_key_by
        self.per_tag_api_keys = dict(per_tag_api_keys or {})
        self.max_per_body = max_per_body
        self.hostname = hostname
        self.hostname_tag = hostname_tag or "host"
        self.name_prefix_drops = tuple(metric_name_prefix_drops)
        self.tag_prefix_drops = tuple(metric_tag_prefix_drops)
        # dynamic per-tag token refresh (reference server.go:530-541):
        # periodically re-fetch the <vary_key_by> -> token map from the
        # org's API endpoint so new orgs get keys without a restart
        self.dynamic_keys_enable = dynamic_per_tag_api_keys_enable
        self.dynamic_refresh_period = float(
            dynamic_per_tag_api_keys_refresh_period)
        self.endpoint_api = (endpoint_api or endpoint).rstrip("/")
        self._keys_lock = threading.Lock()
        self._refresh_thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.flushed_total = 0

    def start(self) -> None:
        if self.dynamic_keys_enable:
            # the initial fetch runs ON the refresh thread: a slow or
            # partitioned API endpoint must not block Server.start()
            # (the watchdog's crash-and-restart path needs startup
            # fast; keep-last-good covers the gap)
            self._refresh_thread = threading.Thread(
                target=self._refresh_loop, daemon=True,
                name="signalfx-key-refresh")
            self._refresh_thread.start()

    def stop(self) -> None:
        """End the key-refresh thread (a fetch in progress ends within
        its 10 s timeout)."""
        self._stop.set()
        if self._refresh_thread is not None:
            self._refresh_thread.join(timeout=11.0)
            self._refresh_thread = None

    def _refresh_loop(self) -> None:
        self._refresh_keys()
        while not self._stop.wait(self.dynamic_refresh_period):
            self._refresh_keys()

    def _refresh_keys(self) -> None:
        """Fetch {name -> token} from the API endpoint's token list
        (the reference walks /v2/token pages); keep-last-good on any
        error."""
        try:
            req = urllib.request.Request(
                f"{self.endpoint_api}/v2/token",
                headers={"X-SF-Token": self.api_key,
                         "Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=10.0) as r:
                doc = json.loads(r.read())
            fetched = {it["name"]: it["secret"]
                       for it in doc.get("results", ())
                       if it.get("name") and it.get("secret")}
            if fetched:
                with self._keys_lock:
                    self.per_tag_api_keys.update(fetched)
        except Exception as e:
            log.warning("signalfx dynamic key refresh failed "
                        "(keeping last good map): %s", e)

    def _token_for(self, m: InterMetric) -> str:
        return self._token_for_tags(m.tags)

    def _token_for_tags(self, tags) -> str:
        if self.vary_key_by:
            with self._keys_lock:
                for t in tags:
                    k, _, v = t.partition(":")
                    if (k == self.vary_key_by and
                            v in self.per_tag_api_keys):
                        return self.per_tag_api_keys[v]
        return self.api_key

    def _datapoint(self, m: InterMetric) -> dict:
        dims = {}
        for t in m.tags:
            k, _, v = t.partition(":")
            dims[k] = v
        if m.hostname:
            dims.setdefault(self.hostname_tag, m.hostname)
        return {"metric": m.name, "value": m.value,
                "timestamp": m.timestamp * 1000, "dimensions": dims}

    def _dropped(self, m: InterMetric) -> bool:
        """Name-prefix drops AND tag-prefix drops both skip the WHOLE
        metric (reference Flush's `continue METRICLOOP`,
        signalfx.go:406-423 — a tag match does not merely strip the
        tag)."""
        if any(m.name.startswith(p) for p in self.name_prefix_drops):
            return True
        return any(t.startswith(p) for t in m.tags
                   for p in self.tag_prefix_drops)

    def flush(self, metrics: list[InterMetric]) -> None:
        if self.name_prefix_drops or self.tag_prefix_drops:
            metrics = [m for m in metrics if not self._dropped(m)]
        # group by token so vary-by-tag keys hit their own org
        by_token: dict[str, dict] = {}
        for m in metrics:
            body = by_token.setdefault(self._token_for(m),
                                       {"gauge": [], "counter": []})
            kind = "counter" if m.type == COUNTER else "gauge"
            body[kind].append(self._datapoint(m))
        for token, body in by_token.items():
            # cap applies to TOTAL points per POST (the reference's
            # maxPointsInBatch slices the combined list), so chunk
            # the kinds together, not with a shared per-kind index
            points = ([("gauge", p) for p in body["gauge"]] +
                      [("counter", p) for p in body["counter"]])
            for i in range(0, len(points), self.max_per_body):
                chunk = {"gauge": [], "counter": []}
                for kind, p in points[i:i + self.max_per_body]:
                    chunk[kind].append(p)
                self._post(token, chunk)

    def flush_frame(self, frame) -> None:
        """Columnar fast path: JSON datapoint fragments straight off
        the frame columns.  Dimensions, drop decisions, and the
        vary-by-tag token are resolved once per POOL ROW and reused by
        every aggregate block over that row; only the suffixed name
        and the value vary per point."""
        if frame.extra:
            self.flush(frame.extra)
        by_token: dict[str, list] = {}  # token -> [(kind, frag)]
        row_cache: dict = {}
        ts_ms = frame.ts * 1000
        drops = self.name_prefix_drops
        for b in frame.blocks:
            metas = b.metas
            suffix = b.suffix
            kind = "counter" if b.type_code == COUNTER_CODE else "gauge"
            vals = b.values
            for j in range(len(b.rows)):
                r = int(b.rows[j])
                name = metas[r].name + suffix
                if drops and any(name.startswith(p) for p in drops):
                    continue
                key = (id(metas), r)
                hit = row_cache.get(key)
                if hit is None:
                    tags = frame.block_tags(b, j)
                    if any(t.startswith(p) for t in tags
                           for p in self.tag_prefix_drops):
                        hit = (None, "")  # whole-metric drop
                    else:
                        dims = {}
                        for t in tags:
                            k, _, v = t.partition(":")
                            dims[k] = v
                        if frame.hostname:
                            dims.setdefault(self.hostname_tag,
                                            frame.hostname)
                        hit = (self._token_for_tags(tags),
                               json.dumps(dims))
                    row_cache[key] = hit
                token, dims_json = hit
                if token is None:
                    continue
                by_token.setdefault(token, []).append((kind, (
                    '{"metric":%s,"value":%s,"timestamp":%d,'
                    '"dimensions":%s}' % (json.dumps(name),
                                          _jfloat(float(vals[j])),
                                          ts_ms, dims_json))))
        for token, points in by_token.items():
            for i in range(0, len(points), self.max_per_body):
                chunk = points[i:i + self.max_per_body]
                raw = ('{"gauge":[%s],"counter":[%s]}' % (
                    ",".join(f for k, f in chunk if k == "gauge"),
                    ",".join(f for k, f in chunk
                             if k == "counter"))).encode()
                self._post_body(token, raw, len(chunk))

    def _post(self, token: str, body: dict) -> None:
        self._post_body(token, json.dumps(body).encode(),
                        len(body["gauge"]) + len(body["counter"]))

    def _post_body(self, token: str, raw: bytes, npoints: int) -> None:
        req = urllib.request.Request(
            f"{self.endpoint}/v2/datapoint", data=raw,
            headers={"Content-Type": "application/json",
                     "X-SF-Token": token}, method="POST")
        with urllib.request.urlopen(req, timeout=10.0) as r:
            r.read()
        self.flushed_total += npoints

    # -- events (reference FlushOtherSamples/reportEvent,
    #    signalfx.go:501-592) ------------------------------------------

    _EVENT_MAX = 256  # EventNameMaxLength / EventDescriptionMaxLength

    def flush_other_samples(self, samples: list) -> None:
        """DogStatsD events serialize as SignalFx custom events on
        ``/v2/event``; service checks are ignored (the reference only
        reports samples carrying the event identifier tag)."""
        events = []
        for s in samples:
            if not hasattr(s, "title"):
                continue  # service check: reference skips these
            dims = {self.hostname_tag: self.hostname}
            for t in s.tags:
                k, _, v = t.partition(":")
                dims[k] = v
            # per-sink tag exclusion applies to event dimensions too
            # (reference reportEvent, signalfx.go:559-561)
            for k in self.excluded_tags:
                dims.pop(k, None)
            # truncate FIRST, then chop the DD markdown fencing and
            # trim — the reference's exact order (signalfx.go:566-577)
            msg = (s.text or "")[:self._EVENT_MAX]
            msg = msg.replace("%%% \n", "", 1)
            msg = msg.replace("\n %%%", "", 1).strip()
            ev = {
                "eventType": s.title[:self._EVENT_MAX],
                "category": "USERDEFINED",
                "dimensions": dims,
                "properties": {"description": msg},
            }
            if s.timestamp:
                ev["timestamp"] = s.timestamp * 1000
            events.append(ev)
        if not events:
            return
        req = urllib.request.Request(
            f"{self.endpoint}/v2/event",
            data=json.dumps(events).encode(),
            headers={"Content-Type": "application/json",
                     "X-SF-Token": self.api_key}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=10.0) as r:
                r.read()
        except Exception as e:
            log.warning("signalfx event flush failed: %s", e)
