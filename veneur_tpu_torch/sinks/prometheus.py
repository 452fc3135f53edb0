"""Prometheus "statsd repeater" sink.

The reference's prometheus sink does NOT expose a scrape endpoint — it
re-emits flushed metrics as statsd lines to a repeater address
(sinks/prometheus/prometheus.go, "StatsdRepeater", config keys
``prometheus_repeater_address`` / ``prometheus_network_type``).  Same
behavior here: each InterMetric becomes ``name:value|type|#tags`` sent
over UDP or TCP.

Port of ``veneur_tpu/sinks/prometheus.py``.
"""

from __future__ import annotations

import logging
import socket

from veneur_tpu_torch.core.frame import TYPE_COUNTER as COUNTER_CODE
from veneur_tpu_torch.core.metrics import COUNTER, InterMetric
from veneur_tpu_torch.sinks.base import SinkBase

log = logging.getLogger("veneur_tpu_torch.sinks.prometheus")


class PrometheusRepeaterSink(SinkBase):
    name = "prometheus"

    def __init__(self, repeater_address: str, network_type: str = "tcp"):
        super().__init__()
        # accept scheme-ful addresses (udp://host:port, the
        # example.yaml form) — the scheme selects network_type
        if "://" in repeater_address:
            from veneur_tpu_torch.protocol.addr import parse_addr
            scheme, host, port, _ = parse_addr(repeater_address)
            if scheme != network_type and network_type != "tcp":
                log.warning(
                    "prometheus repeater scheme %s overrides "
                    "prometheus_network_type %s", scheme, network_type)
            network_type = scheme
        else:
            host, _, port = repeater_address.rpartition(":")
            port = int(port)
        self.addr = (host or "127.0.0.1", port)
        if network_type not in ("tcp", "udp"):
            raise ValueError(f"bad network type {network_type}")
        self.network_type = network_type

    @staticmethod
    def _fmt_value(v: float) -> str:
        """Go %v float rendering (template Execute -> FormatFloat
        'g' -1): integral values print WITHOUT a decimal point.
        Python repr agrees with Go's shortest form elsewhere in the
        value ranges metrics occupy (both flip to e-notation for
        tiny magnitudes)."""
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)

    def _line(self, m: InterMetric) -> bytes:
        # the reference's template is "{Name}:{Value}|{Type}|#{Tags}"
        # (prometheus.go:27) — the "|#" section is ALWAYS present,
        # even with no tags; keep byte parity
        token = "c" if m.type == COUNTER else "g"
        return (f"{m.name}:{self._fmt_value(m.value)}|{token}|#"
                f"{','.join(m.tags)}\n").encode()

    def flush(self, metrics: list[InterMetric]) -> None:
        if not metrics:
            return
        self._send(self._line(m) for m in metrics)

    def flush_frame(self, frame) -> None:
        """Columnar fast path: stream statsd lines straight off the
        frame blocks.  The joined tag string is built once per POOL
        ROW and shared by every aggregate block over that row."""
        self._send(self._frame_lines(frame))

    def _frame_lines(self, frame):
        fmt = self._fmt_value
        tag_cache: dict = {}
        for b in frame.blocks:
            metas = b.metas
            suffix = b.suffix
            token = "c" if b.type_code == COUNTER_CODE else "g"
            vals = b.values
            for j in range(len(b.rows)):
                r = int(b.rows[j])
                key = (id(metas), r)
                tagstr = tag_cache.get(key)
                if tagstr is None:
                    tagstr = ",".join(frame.block_tags(b, j))
                    tag_cache[key] = tagstr
                yield (f"{metas[r].name}{suffix}:"
                       f"{fmt(float(vals[j]))}|{token}|#"
                       f"{tagstr}\n").encode()
        for m in frame.extra:
            yield self._line(m)

    _TCP_BUF = 1 << 16

    def _send(self, lines) -> None:
        """Streaming writer: UDP sends one datagram per line (stay
        under MTU); TCP coalesces lines into ~64KB writes on one
        connection instead of materializing the whole payload."""
        try:
            if self.network_type == "udp":
                s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                for line in lines:
                    s.sendto(line, self.addr)
                s.close()
            else:
                buf: list[bytes] = []
                size = 0
                sock = None
                for line in lines:
                    if sock is None:
                        sock = socket.create_connection(self.addr,
                                                        timeout=5.0)
                    buf.append(line)
                    size += len(line)
                    if size >= self._TCP_BUF:
                        sock.sendall(b"".join(buf))
                        buf, size = [], 0
                if sock is not None:
                    if buf:
                        sock.sendall(b"".join(buf))
                    sock.close()
        except OSError as e:
            log.warning("prometheus repeater flush failed: %s", e)
