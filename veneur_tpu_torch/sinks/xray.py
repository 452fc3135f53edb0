"""AWS X-Ray span sink (reference sinks/xray, 668 LoC): segment JSON
over UDP to the X-Ray daemon, ``{"format":"json","version":1}\\n``
header per datagram (xray.go:22), trace ids in X-Ray's
``1-<epoch8>-<24 hex>`` form (xray.go:262-279 CalculateTraceID),
deterministic crc32 sampling on the trace id (xray.go:155-160), and
the reference's full segment shape (xray.go:150-236): metadata =
common tags + every span tag, annotations = the configured subset,
an http block assembled from the ``http.url``/``http.method``/
``http.status_code``/``client_ip`` tags with the service:name URL
default, name cleaned by the X-Ray charset regex and capped at 190
with the ``-indicator`` suffix, namespace ``remote``.  On top of the
reference's single ``error`` flag, status codes map onto X-Ray's full
taxonomy (segment-document spec): 429 -> ``throttle``, other 4xx ->
``error``, 5xx -> ``fault``.

Port of ``veneur_tpu/sinks/xray.py``.
"""

from __future__ import annotations

import json
import logging
import re
import socket
import zlib

log = logging.getLogger("veneur_tpu_torch.sinks")

_HEADER = b'{"format": "json", "version": 1}\n'

# valid X-Ray name characters (xray.go:106): everything else -> "_"
_NAME_RE = re.compile(r"[^a-zA-Z0-9_\.\:\/\%\&#=+\-\@\s\\]+")

_TAG_CLIENT_IP = "client_ip"          # xray.go:24
_TAG_HTTP_URL = "http.url"            # xray.go:25
_TAG_HTTP_STATUS = "http.status_code"  # xray.go:26
_TAG_HTTP_METHOD = "http.method"      # xray.go:27


from veneur_tpu_torch.sinks.base import SpanTagExcluder


class XRaySpanSink(SpanTagExcluder):
    name = "xray"

    def __init__(self, daemon_address: str = "127.0.0.1:2000",
                 sample_percentage: float = 100.0,
                 annotation_tags: tuple[str, ...] = (),
                 common_tags: dict[str, str] | None = None):
        host, _, port = daemon_address.rpartition(":")
        self._addr = (host or "127.0.0.1", int(port))
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        pct = sample_percentage
        if not 0.0 <= pct <= 100.0:
            log.warning("xray sample rate %s invalid, clamping", pct)
            pct = max(0.0, min(100.0, pct))
        # threshold in crc32 space so the hash compares directly
        # (xray.go:99-102)
        self._sample_threshold = int(pct * 0xFFFFFFFF / 100)
        self.annotation_tags = set(annotation_tags)
        self.common_tags = dict(common_tags or {})
        self.submitted = 0
        self.skipped = 0
        self.malformed_status = 0

    def start(self) -> None:
        pass

    @staticmethod
    def _trace_id(span) -> str:
        """X-Ray trace id ``1-<8 hex epoch>-<24 hex>``: every segment
        of a trace must agree, so the epoch comes from the ROOT
        span's start when the client ships it, else from the span's
        own start quantized to a ~4min bucket so siblings still match
        (xray.go:262-279)."""
        epoch = span.root_start_timestamp // 1_000_000_000
        if epoch == 0:
            # only the FALLBACK epoch is bucket-masked, exactly like
            # the reference (xray.go:268-275) — a root-supplied epoch
            # ships unmasked, so clients must send
            # root_start_timestamp on every span of a trace or none
            epoch = (span.start_timestamp // 1_000_000_000) & \
                ~0xFF
        return (f"1-{epoch & 0xFFFFFFFF:08x}-"
                f"{span.trace_id & ((1 << 96) - 1):024x}")

    def ingest(self, span) -> None:
        # deterministic sampling: crc32 of the DECIMAL trace id
        # string vs the percentage threshold (xray.go:155-160)
        if (zlib.crc32(str(span.trace_id).encode()) >
                self._sample_threshold):
            self.skipped += 1
            return
        metadata = dict(self.common_tags)
        annotations: dict[str, str] = {}
        http_request = {"url": f"{span.service}:{span.name}"}
        http_response: dict = {}
        tags = self.filter_span_tags(span.tags)
        client_ip = tags.get(_TAG_CLIENT_IP)
        if client_ip:
            http_request["client_ip"] = client_ip
        status = 0
        for k, v in tags.items():
            if k == _TAG_CLIENT_IP:
                continue  # http-only (xray.go:174-176)
            if k == _TAG_HTTP_URL:
                http_request["url"] = v
            elif k == _TAG_HTTP_METHOD:
                http_request["method"] = v
            elif k == _TAG_HTTP_STATUS:
                try:
                    code = int(v)
                except ValueError:
                    code = 0
                if 100 <= code <= 599:
                    status = code
                    http_response["status"] = code
                else:
                    # counted, not warned: one misbehaving client
                    # stamping every span would otherwise log at
                    # span-ingest rate
                    self.malformed_status += 1
                    log.debug("xray: malformed status code %r", v)
            metadata[k] = v
            if k in self.annotation_tags:
                annotations[k] = v
        ind = "true" if span.indicator else "false"
        metadata["indicator"] = ind
        annotations["indicator"] = ind

        seg_name = _NAME_RE.sub("_", span.service or "unknown")[:190]
        if span.indicator:
            seg_name += "-indicator"

        seg = {
            "name": seg_name,
            "id": f"{span.id & 0xFFFFFFFFFFFFFFFF:016x}",
            "trace_id": self._trace_id(span),
            "start_time": span.start_timestamp / 1e9,
            "end_time": span.end_timestamp / 1e9,
            "namespace": "remote",
            # error taxonomy (X-Ray segment-document spec): client
            # errors -> error, throttling -> throttle, server faults
            # -> fault; the span's own error flag keeps mapping to
            # error like the reference's single flag (xray.go:230)
            "error": bool(span.error) or 400 <= status <= 499,
            "annotations": annotations,
            "metadata": metadata,
            "http": {"request": http_request,
                     **({"response": http_response}
                        if http_response else {})},
        }
        if status == 429:
            seg["throttle"] = True
        if 500 <= status <= 599:
            seg["fault"] = True
        if span.parent_id:
            seg["parent_id"] = \
                f"{span.parent_id & 0xFFFFFFFFFFFFFFFF:016x}"
            seg["type"] = "subsegment"
        try:
            self._sock.sendto(_HEADER + json.dumps(seg).encode(),
                              self._addr)
            self.submitted += 1
        except OSError as e:
            log.warning("xray send failed: %s", e)

    def flush(self) -> None:
        pass
