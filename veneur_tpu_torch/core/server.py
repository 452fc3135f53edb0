"""The server: UDP DogStatsD in, interval flushes out to the sinks.

Port of the single-node path of ``veneur_tpu/core/server.py``: one
reader thread per ``udp://`` statsd address parses each datagram with
the pure-Python DogStatsD parser and ingests it into the table
(``handle_packet``); a flush thread swaps the table every interval and
emits the flushed InterMetrics to the flush-file plugin and any extra
sinks (``flush_once``).  ``shutdown`` stops and joins every thread and
closes every socket.
"""

from __future__ import annotations

import logging
import socket
import threading
import time

import torch

from veneur_tpu_torch import resolve_device
from veneur_tpu_torch.core import metrics as im
from veneur_tpu_torch.core.config import Config
from veneur_tpu_torch.core.flusher import FlushResult, Flusher
from veneur_tpu_torch.core.table import MetricTable, TableConfig
from veneur_tpu_torch.protocol import addr as addrmod
from veneur_tpu_torch.protocol import dogstatsd as dsd
from veneur_tpu_torch.sinks.base import route
from veneur_tpu_torch.sinks.simple import LocalFilePlugin

log = logging.getLogger("veneur_tpu_torch.server")

_RECV_BYTES = 65536
# socket receive buffer: the reference's read_buffer_size_bytes default
_RCVBUF_BYTES = 2 * 1048576


class Server:
    def __init__(self, config: Config,
                 device: "str | torch.device" = "cuda",
                 extra_sinks: list | None = None):
        self.config = config
        self.device = resolve_device(device)
        self.interval = config.interval_seconds()
        self.table = MetricTable(TableConfig(
            counter_rows=config.tpu_counter_rows,
            gauge_rows=config.tpu_gauge_rows,
            histo_rows=config.tpu_histo_rows,
            set_rows=config.tpu_set_rows), device=self.device)
        self.flusher = Flusher(
            percentiles=tuple(config.percentiles),
            aggregates=tuple(config.aggregates),
            hostname=config.hostname or socket.gethostname(),
            device=self.device)
        self.metric_sinks = list(extra_sinks or [])
        self.plugins = []
        if config.flush_file:
            self.plugins.append(LocalFilePlugin(
                config.flush_file, self.flusher.hostname,
                fmt=config.flush_file_format, interval=self.interval))
        self.lock = threading.Lock()
        self._flush_serial = threading.Lock()
        self._shutdown = threading.Event()
        self._threads: list[threading.Thread] = []
        self.sockets: list[socket.socket] = []
        self.stats = {"packets_received": 0, "packet_errors": 0,
                      "metrics_processed": 0, "metrics_dropped": 0,
                      "flushes": 0}

    # ------------------------------------------------------------------

    def start(self) -> None:
        for a in self.config.statsd_listen_addresses:
            _, host, port, _ = addrmod.parse_addr(a)
            sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                            _RCVBUF_BYTES)
            sock.bind((host, port))
            sock.settimeout(0.2)
            self.sockets.append(sock)
            self._spawn(f"udp-reader-{len(self.sockets) - 1}",
                        self._udp_reader, sock)
        self._spawn("flush-loop", self._flush_loop)

    def _spawn(self, name: str, fn, *args) -> None:
        t = threading.Thread(target=fn, args=args, name=name, daemon=True)
        t.start()
        self._threads.append(t)

    def bound_ports(self) -> list[int]:
        return [s.getsockname()[1] for s in self.sockets]

    def _udp_reader(self, sock: socket.socket) -> None:
        while not self._shutdown.is_set():
            try:
                data = sock.recv(_RECV_BYTES)
            except socket.timeout:
                continue
            except OSError:
                return
            self.handle_packet(data)

    def handle_packet(self, data: bytes) -> None:
        """Parse one datagram (possibly multi-line) into the table: the
        lines parse outside the lock, then one lock round ingests them
        and counts the packet."""
        samples = []
        errors = 0
        for line in dsd.split_packet(data):
            try:
                parsed = dsd.parse_line(line)
            except dsd.ParseError:
                errors += 1
                continue
            if isinstance(parsed, dsd.Sample):
                samples.append(parsed)
            elif isinstance(parsed, dsd.ServiceCheck):
                samples.append(dsd.Sample(
                    name=parsed.name, type=dsd.STATUS,
                    value=float(parsed.status), tags=parsed.tags,
                    message=parsed.message))
        dropped = 0
        with self.lock:
            for s in samples:
                if not self.table.ingest(s):
                    dropped += 1
            # bound host staging between flushes
            if (self.table.staged() >=
                    self.table.config.histo_merge_samples):
                self.table.device_step()
            self.stats["packets_received"] += 1
            self.stats["packet_errors"] += errors
            self.stats["metrics_processed"] += len(samples)
            self.stats["metrics_dropped"] += dropped

    # ------------------------------------------------------------------

    def _flush_loop(self) -> None:
        next_tick = time.monotonic() + self.interval
        while not self._shutdown.wait(
                max(0.0, next_tick - time.monotonic())):
            next_tick += self.interval
            try:
                self.flush_once()
            except Exception:
                log.exception("flush failed")

    def flush_once(self) -> FlushResult:
        """One flush: swap the table, read out, emit to sinks."""
        with self._flush_serial:
            with self.lock:
                pend = self.table.begin_swap()
                status = self.table.take_status()
            snap = self.table.complete_swap(pend)
            res = self.flusher.flush(snap)
            ts = int(time.time())
            for (name, _, _, _), (val, msg, stags) in status.items():
                res.metrics.append(im.InterMetric(
                    name=name, timestamp=ts, value=val, tags=stags,
                    type=im.STATUS, message=msg,
                    hostname=self.flusher.hostname))
            for sink in self.metric_sinks:
                sink.flush(route(res.metrics, sink.name, sink))
            for plugin in self.plugins:
                plugin.flush(res.metrics, self.flusher.hostname)
            self.stats["flushes"] += 1
            return res

    def shutdown(self) -> None:
        self._shutdown.set()
        for sock in self.sockets:
            sock.close()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
        self.sockets = []
