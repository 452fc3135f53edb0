"""The server: UDP DogStatsD and HTTP /import in, interval flushes out.

Port of ``veneur_tpu/core/server.py``.  Each ``udp://`` statsd address
gets ``num_readers`` reader threads, each on its own socket (bound with
SO_REUSEPORT when there is more than one, so the kernel spreads the
senders over them).  A reader blocks on its first datagram, then drains
whatever else is queued with one native recvmmsg sweep
(``vtpu_recv_drain``; datagrams over ``metric_max_length`` are rejected
whole and counted as packet errors) and hands the batch to
``handle_packet_batch``.  One reader runs the fused native parse +
probe + combine (``MetricTable.ingest_buffer``) under the table lock;
several each parse into a ``ReaderShard`` of their own without the
lock and merge under it (or, with ``tpu_multi_reader_fused: false``,
parse into columns outside the lock and ``ingest_columns`` under it).
Events, service checks and malformed lines take the per-line parser.

Every ingest and import site checks the staging against
``tpu_stage_flush_samples``: past it the staged work is detached under
the lock and applied to the device after the lock is released
(``tpu_pipeline``; the flush's ``complete_swap`` waits for every pending
apply), or, with the pipeline off, applied inline.  A flush thread swaps
the table every interval, reads it out as a columnar ``MetricFrame``
(``tpu_columnar_emit``), routes the frame to each sink and hands the
flush-file plugin the materialized list (``flush_once``).

With ``http_address`` set, a ``ThreadingHTTPServer`` answers
``/healthcheck``, ``/debug/vars`` (the server's counters) and ``POST
/import``: each body is decoded and merged into the table under the
table lock (``http_import.apply_import``); a malformed body is answered
400 and counted.  Each ``grpc_listen_addresses`` entry starts an
``ImportServer`` (``forward/grpc_forward.py``): ``forwardrpc.Forward/
SendMetrics`` decodes each wire natively outside the table lock and
merges it under the lock, ``dogstatsd.DogstatsdGRPC/SendPacket`` feeds
``handle_packet``, and ``grpc.health.v1.Health/Check`` answers.  With
``forward_address`` set the node is a local: its flusher forwards
mergeable state after every flush, POSTed to the global's ``/import``
or, with ``forward_use_grpc``, sent as one MetricList through a client
dialled once (a failed send is counted and logged, never retried).
``shutdown`` stops every listener, joins every thread and closes every
socket and channel.
"""

from __future__ import annotations

import ctypes
import http.server
import json
import logging
import os
import socket
import threading
import time
import urllib.request
import zlib

import grpc
import numpy as np
import torch

from veneur_tpu_torch import native, resolve_device
from veneur_tpu_torch.core import metrics as im
from veneur_tpu_torch.core.config import Config
from veneur_tpu_torch.core.flusher import FlushResult, Flusher, ForwardRow
from veneur_tpu_torch.core.table import MetricTable, TableConfig
from veneur_tpu_torch.forward import grpc_forward, http_import
from veneur_tpu_torch.protocol import addr as addrmod
from veneur_tpu_torch.protocol import columnar
from veneur_tpu_torch.protocol import dogstatsd as dsd
from veneur_tpu_torch.sinks.base import route
from veneur_tpu_torch.sinks.simple import LocalFilePlugin

log = logging.getLogger("veneur_tpu_torch.server")

# drain sweep bound: vtpu_recv_drain takes at most this many datagrams
_DRAIN_MAX = 512
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
            set_rows=config.tpu_set_rows,
            compression=float(config.tpu_compression),
            histo_slots=config.tpu_histo_slots), device=self.device)
        self.is_local = config.is_local()
        self.pipeline = bool(config.tpu_pipeline)
        self.flusher = Flusher(
            is_local=self.is_local,
            percentiles=tuple(config.percentiles),
            aggregates=tuple(config.aggregates),
            hostname=config.hostname or socket.gethostname(),
            device=self.device, columnar=bool(config.tpu_columnar_emit))
        self.metric_sinks = list(extra_sinks or [])
        self.plugins = []
        if config.flush_file:
            self.plugins.append(LocalFilePlugin(
                config.flush_file, self.flusher.hostname,
                fmt=config.flush_file_format, interval=self.interval))
        self.lock = threading.Lock()
        # the counters have a lock of their own: a reader never takes
        # the ingest lock only to count
        self._stats_lock = threading.Lock()
        self._parsers = threading.local()  # split path: one per reader
        self._flush_serial = threading.Lock()
        self._shutdown = threading.Event()
        self._threads: list[threading.Thread] = []
        self.sockets: list[socket.socket] = []
        self._httpd: http.server.ThreadingHTTPServer | None = None
        self.http_port: int | None = None
        self.grpc_servers: list[grpc_forward.ImportServer] = []
        self.grpc_ports: list[int] = []
        self._grpc_client: grpc_forward.ForwardClient | None = None
        self.stats = {"packets_received": 0, "packet_errors": 0,
                      "metrics_processed": 0, "metrics_dropped": 0,
                      "flushes": 0, "imports_received": 0,
                      "import_errors": 0, "import_flagged_wires": 0,
                      "received_grpc": 0, "received_dogstatsd-grpc": 0,
                      "forward_errors": 0, "forwarded_rows": 0}

    # ------------------------------------------------------------------

    def start(self) -> None:
        n = max(1, self.config.num_readers)
        for a in self.config.statsd_listen_addresses:
            _, host, port, _ = addrmod.parse_addr(a)
            for i in range(n):
                sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                if n > 1:
                    sock.setsockopt(socket.SOL_SOCKET,
                                    socket.SO_REUSEPORT, 1)
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                _RCVBUF_BYTES)
                sock.bind((host, port))
                # the kernel hashes a wake datagram to one member of a
                # reuseport group: the timeout is what makes every
                # reader see shutdown
                sock.settimeout(0.2)
                port = sock.getsockname()[1]  # port 0 resolved once
                self.sockets.append(sock)
                self._spawn(f"udp-reader-{len(self.sockets) - 1}",
                            self._udp_reader, sock, i)
        if self.config.http_address:
            self._start_http(self.config.http_address)
        for a in self.config.grpc_listen_addresses:
            _, host, port, _ = addrmod.parse_addr(a)
            srv = grpc_forward.ImportServer(self, f"{host}:{port}")
            srv.start()
            self.grpc_servers.append(srv)
            self.grpc_ports.append(srv.port)
        self._spawn("flush-loop", self._flush_loop)

    def _start_http(self, address: str) -> None:
        host, _, port = address.rpartition(":")
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _ok(self, body: bytes = b"ok",
                    ctype: str = "text/plain") -> None:
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthcheck":
                    self._ok()
                elif self.path == "/debug/vars":
                    # the reference's expvar page, cut to the counters
                    with server._stats_lock:
                        body = json.dumps({
                            "stats": server.stats,
                            # per-thread native decode scratch kept by
                            # the gRPC import handlers
                            "forward": {"decode_scratch_bytes":
                                        grpc_forward.decode_scratch_bytes()}})
                    self._ok(body.encode(), "application/json")
                else:
                    self.send_error(404)

            def do_POST(self):
                if self.path != "/import":
                    self.send_error(404)
                    return
                body = self.rfile.read(
                    int(self.headers.get("Content-Length", 0)))
                try:
                    acc = server.handle_import(
                        body, self.headers.get("Content-Encoding", ""),
                        self.headers)
                except (ValueError, zlib.error) as e:
                    server.bump("import_errors")
                    self.send_error(400, str(e))
                    return
                self._ok(json.dumps({"accepted": acc}).encode(),
                         "application/json")

        self._httpd = http.server.ThreadingHTTPServer(
            (host or "127.0.0.1", int(port)), Handler)
        self._httpd.daemon_threads = True
        self.http_port = self._httpd.server_port
        self._spawn("http", self._httpd.serve_forever)

    def handle_import(self, body: bytes, content_encoding: str = "",
                      headers=None) -> int:
        """Decode one ``/import`` body and merge it into the table under
        the table lock (past the staging bound, the device step follows
        the lock's release).  The trace, drain, replay, recovery and
        handoff headers are decoded and otherwise ignored: the ledger,
        spool, checkpoints and handoff they feed are not in this
        server.  Raises ValueError (or zlib.error) on a malformed body,
        before anything is merged.  Returns the accepted item count."""
        items = http_import.decode_body(body, content_encoding)
        flags = http_import.decode_headers(headers or {})
        flagged = any(flags[k] for k in ("drain", "replay", "recovery",
                                         "handoff"))
        with self.lock:
            acc, dropped = http_import.apply_import(self.table, items)
            work = self._maybe_device_step_locked()
        self._apply_staged(work)
        self.bump("imports_received", acc)
        self.bump("metrics_dropped", dropped)
        self.bump("import_flagged_wires", int(flagged))
        return acc

    def bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] = self.stats.get(key, 0) + n

    def _spawn(self, name: str, fn, *args) -> None:
        t = threading.Thread(target=fn, args=args, name=name, daemon=True)
        t.start()
        self._threads.append(t)

    def bound_ports(self) -> list[int]:
        """The statsd sockets' ports, then the gRPC listeners'."""
        return [s.getsockname()[1] for s in self.sockets] + self.grpc_ports

    def _pin_reader_core(self, index: int) -> bool:
        """Pin this reader thread to one core (``tpu_reader_pin_cores``:
        "auto" = reader i on the i-th usable core when there are at
        least as many cores as readers, "off", or a comma list).
        Returns whether it pinned; pinning never fails a reader."""
        pin = self.config.tpu_reader_pin_cores
        if pin == "off" or not hasattr(os, "sched_setaffinity"):
            return False
        try:
            avail = sorted(os.sched_getaffinity(0))
            if pin == "auto":
                if len(avail) < max(1, self.config.num_readers):
                    return False  # oversubscribed: pins would stack
                core = avail[index % len(avail)]
            else:
                cores = [int(c) for c in pin.split(",") if c.strip()]
                core = cores[index % len(cores)]
                if core not in avail:
                    return False
            os.sched_setaffinity(0, {core})
        except (OSError, ValueError):
            return False
        return True

    def _reader_shard(self):
        """A reader's ReaderShard on the multi-reader fused path, None
        where one reader (``ingest_buffer``) or the split columnar path
        (``tpu_multi_reader_fused: false``) runs."""
        if (self.config.num_readers > 1 and
                self.config.tpu_multi_reader_fused):
            return self.table.make_reader_shard()
        return None

    def _udp_reader(self, sock: socket.socket, index: int = 0) -> None:
        self._pin_reader_core(index)
        shard = self._reader_shard()
        lib = native.load()
        max_len = self.config.metric_max_length
        # one byte past the limit: a longer datagram arrives truncated
        # to max_len + 1 and is rejected
        bufsize = max_len + 1
        sweep = min(self.config.reader_batch_packets - 1, _DRAIN_MAX)
        drain_buf = np.empty(max(1, sweep) * (bufsize + 1), np.uint8)
        drain_ptr = native.ptr(drain_buf, ctypes.c_uint8)
        n_msgs = ctypes.c_int32(0)
        n_over = ctypes.c_int32(0)
        while not self._shutdown.is_set():
            try:
                data = sock.recv(bufsize)
            except socket.timeout:
                continue
            except OSError:
                return
            if not data:
                continue
            # the first read blocks (shutdown and socket errors surface
            # here); the rest of the queue comes in one recvmmsg sweep
            nbytes = lib.vtpu_recv_drain(
                sock.fileno(), drain_ptr, drain_buf.nbytes, sweep, max_len,
                ctypes.byref(n_msgs), ctypes.byref(n_over))
            self.handle_packet_batch(
                [data], drained=drain_buf[:nbytes].tobytes() if nbytes
                else None,
                drained_pkts=int(n_msgs.value) if nbytes else 0,
                oversize=int(n_over.value), shard=shard)

    def handle_packet(self, data: bytes) -> None:
        """Ingest one datagram (possibly multi-line)."""
        self.handle_packet_batch([data])

    def handle_packet_batch(self, packets: list[bytes],
                            drained: bytes | None = None,
                            drained_pkts: int = 0,
                            oversize: int = 0, shard=None) -> int:
        """Ingest many datagrams in one native pass.  ``drained`` is the
        recvmmsg sweep's newline-joined chunk of ``drained_pkts``
        datagrams, already length-checked; ``oversize`` counts datagrams
        the sweep rejected.  With ``shard`` (this reader's ReaderShard)
        the pass runs without the lock and only the merge holds it; a
        single-reader server runs ``ingest_buffer`` under the lock;
        otherwise (the split path, and a multi-reader server's packets
        from elsewhere, e.g. gRPC SendPacket) the batch parses into
        columns outside the lock and ``ingest_columns`` runs under it.
        Returns the processed sample count."""
        errors = oversize
        good = []
        for p in packets:
            if len(p) > self.config.metric_max_length:
                errors += 1
            else:
                good.append(p)
        n_pkts = len(good) + drained_pkts
        if drained is not None:
            good.append(drained)
        buf = b"\n".join(good)
        if shard is not None:
            shard.parse(buf)
            with self.lock:
                processed, dropped, others = shard.commit()
                work = self._maybe_device_step_locked()
            self._apply_staged(work)
            shard.reset()
            lines = [buf[off:off + ln] for off, ln, _kind in others]
        elif self.config.num_readers <= 1:
            with self.lock:
                processed, dropped, others = self.table.ingest_buffer(buf)
                work = self._maybe_device_step_locked()
            self._apply_staged(work)
            lines = [buf[off:off + ln] for off, ln, _kind in others]
        else:
            # views into this thread's own parser scratch, consumed
            # before the thread parses again
            parser = getattr(self._parsers, "p", None)
            if parser is None:
                parser = self._parsers.p = columnar.ColumnarParser()
            pb = parser.parse(buf, copy=False)
            with self.lock:
                processed, dropped = self.table.ingest_columns(pb)
                work = self._maybe_device_step_locked()
            self._apply_staged(work)
            lines = [pb.line(int(i)) for i in np.nonzero(
                pb.type_code[:pb.n] > columnar.CODE_SET)[0]]
        # events, service checks and malformed lines: per-line parse
        slow = []
        for line in lines:
            try:
                parsed = dsd.parse_line(line)
            except dsd.ParseError:
                errors += 1
                continue
            if isinstance(parsed, dsd.Sample):
                slow.append(parsed)
            elif isinstance(parsed, dsd.ServiceCheck):
                slow.append(dsd.Sample(
                    name=parsed.name, type=dsd.STATUS,
                    value=float(parsed.status), tags=parsed.tags,
                    message=parsed.message))
        if slow:
            with self.lock:
                for sample in slow:
                    if not self.table.ingest(sample):
                        dropped += 1
                work = self._maybe_device_step_locked()
            self._apply_staged(work)
            processed += len(slow)
        with self._stats_lock:
            self.stats["packets_received"] += n_pkts
            self.stats["packet_errors"] += errors
            self.stats["metrics_processed"] += processed
            self.stats["metrics_dropped"] += dropped
        return processed

    def _maybe_device_step_locked(self):
        """Past ``tpu_stage_flush_samples`` staged samples, the
        mid-interval device step (it bounds host staging).  Caller
        holds the lock.  Pipelined, it returns the detached work, which
        the caller hands to ``_apply_staged`` once the lock is released;
        serial, it applies inline and returns None."""
        if self.table.staged() < self.config.tpu_stage_flush_samples:
            return None
        if self.pipeline:
            return self.table.take_staged()
        self.table.device_step()
        return None

    def _apply_staged(self, work) -> None:
        """Apply detached work outside the lock (``complete_swap`` waits
        for it, so nothing crosses the swap)."""
        if work is not None:
            self.table.apply_staged(work)

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
        """One flush: swap the table (pipelined: detach under the lock,
        apply the final staging outside it), read it out, route it to
        every sink and plugin, forward on a local.  Returns the
        FlushResult with the frame materialized into ``metrics``."""
        with self._flush_serial:
            with self.lock:
                if self.pipeline:
                    pend = self.table.begin_swap()
                else:
                    snap = self.table.swap()
                status = self.table.take_status()
            if self.pipeline:
                snap = self.table.complete_swap(pend)
            res = self.flusher.flush(snap, retain_frame=True)
            ts = int(time.time())
            for (name, _, _, _), (val, msg, stags) in status.items():
                res.metrics.append(im.InterMetric(
                    name=name, timestamp=ts, value=val, tags=stags,
                    type=im.STATUS, message=msg,
                    hostname=self.flusher.hostname))
            for sink in self.metric_sinks:
                if res.frame is not None and hasattr(sink, "flush_frame"):
                    sink.flush_frame(res.frame.route(
                        sink.name, sink,
                        extra=route(res.metrics, sink.name, sink)))
                else:
                    sink.flush(route(res.all_metrics(), sink.name, sink))
            for plugin in self.plugins:
                plugin.flush(res.all_metrics(), self.flusher.hostname)
            if self.is_local and res.forward:
                if self.config.forward_use_grpc:
                    self._forward_grpc(res.forward)
                else:
                    self._forward_http(res.forward)
            self.bump("flushes")
            if res.frame is not None:
                res.metrics = res.frame.materialize() + res.metrics
                res.frame = None
            return res

    def _forward_http(self, rows: list[ForwardRow]) -> None:
        """POST a flush's forward rows to the global's /import (the
        reference's flusher.go flushForward); a failed send drops and
        counts the rows and logs, as the reference does."""
        try:
            if self.config.forward_json_schema == "reference":
                body, headers = http_import.encode_rows_reference(
                    rows, compression=float(self.config.tpu_compression))
            else:
                body, headers = http_import.encode_rows(rows)
            url = self.config.forward_address.rstrip("/") + "/import"
            if not url.startswith("http"):
                url = "http://" + url
            req = urllib.request.Request(url, data=body, headers=headers,
                                         method="POST")
            with urllib.request.urlopen(req, timeout=10.0) as r:
                r.read()
        except Exception as e:  # forwarding never aborts the flush
            self.bump("metrics_dropped", len(rows))
            self.bump("forward_errors")
            log.warning("forward failed: %s", e)
            return
        self.bump("forwarded_rows", len(rows))

    def _forward_grpc(self, rows: list[ForwardRow]) -> None:
        """Send a flush's forward rows to the global's Forward service
        through a client dialled once (flusher.go:499 forwardGRPC); a
        failed send drops and counts the rows and logs, never retried."""
        if self._grpc_client is None:
            self._grpc_client = grpc_forward.ForwardClient(
                self.config.forward_address,
                compression=float(self.config.tpu_compression))
        try:
            self._grpc_client.send(rows)
        except grpc.RpcError as e:
            self.bump("metrics_dropped", len(rows))
            self.bump("forward_errors")
            log.warning("grpc forward failed: %s", e)
            return
        self.bump("forwarded_rows", len(rows))

    def shutdown(self) -> None:
        self._shutdown.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        for g in self.grpc_servers:
            g.stop()
        self.grpc_servers = []
        for sock in self.sockets:
            sock.close()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
        self.sockets = []
        if self._grpc_client is not None:
            self._grpc_client.close()
            self._grpc_client = None
