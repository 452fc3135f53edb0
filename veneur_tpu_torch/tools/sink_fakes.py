"""Local stand-ins for the remote ends of the sinks, and decoders for
what they receive.

Each fake binds a free loopback port and records what arrives, so a
server's sinks can be pointed at them and their payloads read back:

- ``HttpCapture``: an HTTP server recording every request (method,
  path, headers, body); ``stall_s`` makes it sleep before answering,
  to stand in for a backend that hangs.  ``decoded`` undoes the
  body's ``Content-Encoding`` (deflate or gzip).
- ``UdpCapture``: a datagram socket drained by a thread;
  ``UdpCaptureProcess`` drains it in a child process of its own, so a
  burst of datagrams is read at the pace it is sent, whatever the
  sending process's threads are doing.
- ``TcpCapture``: a listening socket; every connection is read to its
  end.
- ``FakeKafkaBroker``: answers Metadata v1 (one broker, ``partitions``
  partitions a topic) and Produce v3 (no error; no answer at acks 0),
  recording each (topic, partition, record batch).
  ``record_values`` decodes a RecordBatch v2.

The gRPC span sink's far end is ``sinks.grpsink.GRPCSpanSinkServer``.
Every fake's ``close`` stops its threads and closes its sockets.

``Backends`` starts one fake for every sink a server can configure and
gives the config keys that point the server at them (plus a
``prometheus_tcp`` repeater to pass as an extra sink); ``payloads``
decodes what they received into an order-free form, and
``metric_values`` reads the metric sinks' rows out of it.
"""

from __future__ import annotations

import gzip
import http.server
import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time
import zlib


def _loopback_url(port: int) -> str:
    return f"http://127.0.0.1:{port}"


class _Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def _handle(self):
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n)
        headers = {k.lower(): v for k, v in self.headers.items()}
        cap = self.server.capture
        if cap.stall_s:
            time.sleep(cap.stall_s)
        with cap.lock:
            cap.requests.append((self.command, self.path, headers, body))
        self.send_response(200)
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"ok")

    do_POST = do_PUT = do_GET = _handle

    def log_message(self, *a):
        pass


class HttpCapture:
    def __init__(self, stall_s: float = 0.0):
        self.requests: list[tuple[str, str, dict, bytes]] = []
        self.lock = threading.Lock()
        self.stall_s = stall_s
        self._srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                    _Handler)
        self._srv.daemon_threads = True
        self._srv.capture = self
        self.port = self._srv.server_address[1]
        self.url = _loopback_url(self.port)
        self._t = threading.Thread(target=self._srv.serve_forever,
                                   daemon=True, name="fake-http")
        self._t.start()

    def take(self) -> list[tuple[str, str, dict, bytes]]:
        """The requests so far, cleared."""
        with self.lock:
            out, self.requests = self.requests, []
        return out

    @staticmethod
    def decoded(headers: dict, body: bytes) -> bytes:
        enc = headers.get("content-encoding", "")
        if enc == "deflate":
            return zlib.decompress(body)
        if enc == "gzip":
            return gzip.decompress(body)
        return body

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        self._t.join(timeout=5.0)


class UdpCapture:
    def __init__(self, rcvbuf: int = 64 << 20):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for opt in (getattr(socket, "SO_RCVBUFFORCE", None),
                    socket.SO_RCVBUF):
            if opt is None:
                continue
            try:
                self.sock.setsockopt(socket.SOL_SOCKET, opt, rcvbuf)
                break
            except OSError:
                continue
        self.sock.bind(("127.0.0.1", 0))
        self.sock.settimeout(0.2)
        self.port = self.sock.getsockname()[1]
        self.datagrams: list[bytes] = []
        self.lock = threading.Lock()
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True,
                                   name="fake-udp")
        self._t.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                data = self.sock.recv(65536)
            except socket.timeout:
                continue
            except OSError:
                return
            with self.lock:
                self.datagrams.append(data)

    def count(self) -> int:
        with self.lock:
            return len(self.datagrams)

    def take(self, settle: float = 0.05) -> list[bytes]:
        """The datagrams so far, cleared, once none has arrived for
        ``settle`` seconds."""
        n = -1
        while n != self.count():
            n = self.count()
            time.sleep(settle)
        with self.lock:
            out, self.datagrams = self.datagrams, []
        return out

    def close(self) -> None:
        self._stop.set()
        self._t.join(timeout=5.0)
        self.sock.close()


# the child of UdpCaptureProcess: binds, prints its port, drains the
# socket into memory; each "take" line on stdin answers with the
# datagrams so far (a count, then length-prefixed datagrams) and clears
_UDP_CHILD = r"""
import os, select, socket, struct, sys
s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
for opt in (getattr(socket, "SO_RCVBUFFORCE", None), socket.SO_RCVBUF):
    if opt is not None:
        try:
            s.setsockopt(socket.SOL_SOCKET, opt, int(sys.argv[1]))
            break
        except OSError:
            pass
s.bind(("127.0.0.1", 0))
s.setblocking(False)
out = sys.stdout.buffer
out.write(b"%d\n" % s.getsockname()[1])
out.flush()
got = []
while True:
    r, _, _ = select.select([s, sys.stdin], [], [])
    if s in r:
        while True:
            try:
                got.append(s.recv(65536))
            except BlockingIOError:
                break
    if sys.stdin in r:
        line = sys.stdin.readline()
        if not line:
            break
        while True:
            try:
                got.append(s.recv(65536))
            except BlockingIOError:
                break
        out.write(struct.pack(">I", len(got)))
        for d in got:
            out.write(struct.pack(">I", len(d)) + d)
        out.flush()
        got = []
"""


class UdpCaptureProcess:
    def __init__(self, rcvbuf: int = 64 << 20):
        self._p = subprocess.Popen(
            [sys.executable, "-c", _UDP_CHILD, str(rcvbuf)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        self.port = int(self._p.stdout.readline())

    def _read(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._p.stdout.read(n - len(buf))
            if not chunk:
                raise OSError("udp capture child exited")
            buf += chunk
        return buf

    def take(self) -> list[bytes]:
        self._p.stdin.write(b"take\n")
        self._p.stdin.flush()
        (n,) = struct.unpack(">I", self._read(4))
        out = []
        for _ in range(n):
            (ln,) = struct.unpack(">I", self._read(4))
            out.append(self._read(ln))
        return out

    def close(self) -> None:
        try:
            self._p.stdin.close()
        except OSError:
            pass
        try:
            self._p.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            self._p.kill()
            self._p.wait()
        self._p.stdout.close()


class TcpCapture:
    def __init__(self):
        self.lsock = socket.socket()
        self.lsock.bind(("127.0.0.1", 0))
        self.lsock.listen(16)
        self.lsock.settimeout(0.2)
        self.port = self.lsock.getsockname()[1]
        self.streams: list[bytes] = []
        self.lock = threading.Lock()
        self._stop = threading.Event()
        self._conns: list[threading.Thread] = []
        self._t = threading.Thread(target=self._accept, daemon=True,
                                   name="fake-tcp")
        self._t.start()

    def _accept(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self.lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._read, args=(conn,),
                                 daemon=True, name="fake-tcp-conn")
            t.start()
            self._conns.append(t)

    def _read(self, conn: socket.socket) -> None:
        chunks = []
        conn.settimeout(30.0)
        try:
            while True:
                data = conn.recv(1 << 16)
                if not data:
                    break
                chunks.append(data)
        except OSError:
            pass
        finally:
            conn.close()
        with self.lock:
            self.streams.append(b"".join(chunks))

    def take(self) -> list[bytes]:
        with self.lock:
            out, self.streams = self.streams, []
        return out

    def close(self) -> None:
        self._stop.set()
        self._t.join(timeout=5.0)
        for t in self._conns:
            t.join(timeout=5.0)
        self.lsock.close()


class FakeKafkaBroker:
    def __init__(self, partitions: int = 2):
        self.partitions = partitions
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.sock.settimeout(0.2)
        self.addr = f"127.0.0.1:{self.sock.getsockname()[1]}"
        self.produced: list[tuple[str, int, bytes]] = []
        self.lock = threading.Lock()
        self._stop = threading.Event()
        self._conns: list[tuple[socket.socket, threading.Thread]] = []
        self._t = threading.Thread(target=self._accept, daemon=True,
                                   name="fake-kafka")
        self._t.start()

    def _accept(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True, name="fake-kafka-conn")
            t.start()
            self._conns.append((conn, t))

    @staticmethod
    def _read_exact(conn, n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                raise OSError("closed")
            buf += chunk
        return buf

    def _serve(self, conn) -> None:
        try:
            while True:
                (length,) = struct.unpack(">i", self._read_exact(conn, 4))
                msg = self._read_exact(conn, length)
                api_key, _ver, corr = struct.unpack_from(">hhi", msg)
                (cid_len,) = struct.unpack_from(">h", msg, 8)
                body = msg[10 + cid_len:]
                if api_key == 3:
                    resp = self._metadata(body)
                else:
                    resp = self._produce(body)
                    if resp is None:  # acks 0: no response
                        continue
                out = struct.pack(">i", corr) + resp
                conn.sendall(struct.pack(">i", len(out)) + out)
        except OSError:
            pass
        finally:
            conn.close()

    def _metadata(self, body):
        (tlen,) = struct.unpack_from(">h", body, 4)
        topic = body[6:6 + tlen]
        out = struct.pack(">i", 1)  # one broker
        out += struct.pack(">i", 0) + struct.pack(
            ">h", 9) + b"localhost" + struct.pack(">i", 9092)
        out += struct.pack(">h", -1)  # null rack
        out += struct.pack(">i", 0)  # controller
        out += struct.pack(">i", 1)  # one topic
        out += struct.pack(">h", 0)  # no error
        out += struct.pack(">h", len(topic)) + topic
        out += b"\x00"  # not internal
        out += struct.pack(">i", self.partitions)
        for p in range(self.partitions):
            out += struct.pack(">hii", 0, p, 0)
            out += struct.pack(">i", 0)  # replicas
            out += struct.pack(">i", 0)  # isr
        return out

    def _produce(self, body):
        off = 2  # null transactional id
        (acks,) = struct.unpack_from(">h", body, off)
        off += 2 + 4  # acks, timeout
        off += 4  # topic array length
        (tlen,) = struct.unpack_from(">h", body, off)
        off += 2
        topic = body[off:off + tlen].decode()
        off += tlen + 4  # partition array length
        (part,) = struct.unpack_from(">i", body, off)
        off += 4
        (blen,) = struct.unpack_from(">i", body, off)
        off += 4
        with self.lock:
            self.produced.append((topic, part, body[off:off + blen]))
        if acks == 0:
            return None
        out = struct.pack(">i", 1)
        out += struct.pack(">h", len(topic)) + topic.encode()
        out += struct.pack(">i", 1)  # one partition
        out += struct.pack(">ihq", part, 0, 0)  # index, no error, offset
        out += struct.pack(">q", -1)  # log append time
        out += struct.pack(">i", 0)  # throttle
        return out

    def take(self) -> list[tuple[str, int, bytes]]:
        with self.lock:
            out, self.produced = self.produced, []
        return out

    def close(self) -> None:
        self._stop.set()
        self._t.join(timeout=5.0)
        for conn, t in self._conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            t.join(timeout=5.0)
        self.sock.close()


def _unvarint(buf: bytes, pos: int) -> tuple[int, int]:
    shift = u = 0
    while True:
        b = buf[pos]
        pos += 1
        u |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return (u >> 1) ^ -(u & 1), pos


def record_values(batch: bytes) -> list[tuple[bytes | None, bytes]]:
    """A RecordBatch v2's (key, value) pairs."""
    (count,) = struct.unpack_from(">i", batch, 57)
    pos = 61
    out = []
    for _ in range(count):
        _rlen, pos = _unvarint(batch, pos)
        pos += 1  # attributes
        _, pos = _unvarint(batch, pos)  # timestamp delta
        _, pos = _unvarint(batch, pos)  # offset delta
        klen, pos = _unvarint(batch, pos)
        key = None
        if klen >= 0:
            key = batch[pos:pos + klen]
            pos += klen
        vlen, pos = _unvarint(batch, pos)
        out.append((key, batch[pos:pos + vlen]))
        pos += vlen
        _, pos = _unvarint(batch, pos)  # headers
    return out


# ----------------------------------------------------------------------
# every sink at once

# the server's own flush spans carry this tag (random ids, measured
# durations); ``ssf.names_unique`` is drawn at random by the span
# extraction; ``payloads`` leaves both out
INTERNAL = "veneur.internal"
SAMPLED = "ssf.names_unique"
# the JSON keys whose lists hold one metric or span an element
_LEAF_LISTS = ("series", "gauge", "counter", "metrics", "spans",
               "span_records")


def kept(item) -> bool:
    text = item if isinstance(item, str) else (
        item.decode("latin-1") if isinstance(item, bytes)
        else json.dumps(item))
    return INTERNAL not in text and SAMPLED not in text


def _sorted(items) -> list:
    return sorted(items, key=lambda v: json.dumps(v, sort_keys=True))


def _leaves(items) -> list:
    return _sorted(order_free(v) for v in items if kept(v))


def order_free(doc):
    """A decoded JSON body with its lists of objects sorted by their
    text, recursively (the span sinks' trace grouping and the per-token
    bodies are dict- and thread-ordered), without the server's own
    flush spans and the sampled metric."""
    if isinstance(doc, dict):
        return {k: (_leaves(v) if k in _LEAF_LISTS else order_free(v))
                for k, v in doc.items()}
    if isinstance(doc, list):
        if doc and all(isinstance(v, list) and v and
                       all(isinstance(x, dict) for x in v) for v in doc):
            # datadog traces: a list of each trace's spans
            return _sorted(g for g in map(_leaves, doc) if g)
        items = [order_free(v) for v in doc]
        if all(isinstance(v, (dict, list)) for v in items):
            return _sorted(items)
        return items
    return doc


class Backends:
    """One fake for every sink: HTTP captures for datadog (metrics and
    the trace agent), signalfx, newrelic, splunk, lightstep and s3; UDP
    for the prometheus repeater (drained in a child process: a flush
    sends one datagram a row) and X-Ray; TCP for a second prometheus
    repeater; a Kafka broker; a grpsink server for Falconer.
    ``stall`` names HTTP fakes that sleep ``stall_s`` before
    answering."""

    HTTP = ("datadog", "datadog_trace", "signalfx", "newrelic",
            "splunk", "lightstep", "s3")

    def __init__(self, directory: str, stall=(), stall_s: float = 0.0):
        from veneur_tpu_torch.sinks.grpsink import GRPCSpanSinkServer
        self.http = {k: HttpCapture(stall_s if k in stall else 0.0)
                     for k in self.HTTP}
        self.prom = UdpCaptureProcess()
        self.prom_tcp = TcpCapture()
        self.xray = UdpCapture()
        self.kafka = FakeKafkaBroker(partitions=2)
        self.falconer = GRPCSpanSinkServer()
        self.falconer.start()
        self.flush_file = os.path.join(directory, "flush.tsv")
        self.rows: dict = {}
        self.bodies: dict = {}

    def config(self) -> dict:
        """The sink keys: every metric sink (signalfx keyed by ``team``
        with two per-tag keys), every span sink, s3 and the flush
        file.  A server built on them must get ``patch`` before its
        first flush."""
        h = self.http
        return {
            "datadog_api_key": "dk", "datadog_api_hostname":
                h["datadog"].url,
            "datadog_trace_api_address": h["datadog_trace"].url,
            "prometheus_repeater_address":
                f"udp://127.0.0.1:{self.prom.port}",
            "signalfx_api_key": "sk",
            "signalfx_endpoint_base": h["signalfx"].url,
            "signalfx_vary_key_by": "team",
            "signalfx_per_tag_api_keys": {"t1": "k1", "t2": "k2"},
            "newrelic_insert_key": "nk",
            "newrelic_metric_endpoint": h["newrelic"].url,
            "newrelic_trace_endpoint": h["newrelic"].url,
            "newrelic_account_id": 42,
            "newrelic_common_tags": ["env:fake"],
            "kafka_broker": self.kafka.addr,
            "kafka_span_topic": "spans", "kafka_check_topic": "checks",
            "kafka_event_topic": "events",
            "splunk_hec_address": h["splunk"].url,
            "splunk_hec_token": "st",
            "xray_address": f"127.0.0.1:{self.xray.port}",
            "lightstep_access_token": "lt",
            "lightstep_collector_host": h["lightstep"].url,
            "falconer_address": f"127.0.0.1:{self.falconer.port}",
            "aws_s3_bucket": "bkt", "aws_s3_endpoint": h["s3"].url,
            "aws_access_key_id": "AK", "aws_secret_access_key": "SK",
            "flush_file": self.flush_file,
        }

    def extra_sinks(self) -> list:
        """A prometheus repeater over TCP, named ``prometheus_tcp``
        (one server configures one repeater)."""
        from veneur_tpu_torch.sinks.prometheus import \
            PrometheusRepeaterSink
        sink = PrometheusRepeaterSink(f"127.0.0.1:{self.prom_tcp.port}",
                                      "tcp")
        sink.name = "prometheus_tcp"
        return [sink]

    def patch(self, server) -> None:
        """Point the newrelic sink's account-scoped event endpoint
        (fixed by region in the sink) at its fake."""
        for sink in server.metric_sinks:
            if sink.name == "newrelic":
                sink.events_endpoint = self.http["newrelic"].url

    def payloads(self) -> dict:
        """What every fake received since the last call, decoded:
        HTTP requests as JSON text of [method, path, token, encoding,
        body] (bodies decompressed and ``order_free``, a body of rows
        cut into one record a row; s3's object key cut to its prefix,
        TSV and HEC lines sorted), datagrams and
        TCP streams as lines, Kafka records as (topic, partition, key,
        value), Falconer's spans serialized; all sorted.  ``rows``
        counts each metric sink's metric rows before the filter (what
        the server's ledger credits the sink with), ``bodies`` the
        requests each HTTP fake took."""
        out = {}
        self.rows = {k: 0 for k in ("datadog", "signalfx", "newrelic")}
        for k, fake in self.http.items():
            reqs = []
            for method, path, headers, body in fake.take():
                raw = fake.decoded(headers, body)
                if k in self.rows:
                    self.rows[k] += _metric_rows(path, json.loads(raw))
                if k == "s3":
                    path = path.rsplit("/", 1)[0]
                    doc = sorted(line for line in gzip.decompress(raw)
                                 .decode().splitlines() if kept(line))
                elif k == "splunk":
                    doc = sorted(line for line in raw.decode().splitlines()
                                 if kept(line))
                else:
                    doc = order_free(json.loads(raw))
                head = [method, path, headers.get("x-sf-token", ""),
                        headers.get("content-encoding", "")]
                self.bodies[k] = self.bodies.get(k, 0) + 1
                # one record a row: how rows fall into bodies is the
                # sink's chunking over the frame's row order
                for part in _rows_of(doc):
                    reqs.append(json.dumps(head + [part], sort_keys=True))
            out[k] = sorted(reqs)
        prom = self.prom.take()
        tcp = [ln + b"\n" for s in self.prom_tcp.take()
               for ln in s.splitlines()]
        kafka = [(t, p, key, v) for t, p, b in self.kafka.take()
                 for key, v in record_values(b)]
        self.rows.update(prometheus=len(prom), prometheus_tcp=len(tcp),
                         kafka=sum(1 for r in kafka
                                   if r[0] == "veneur_metrics"))
        out["prometheus"] = sorted(d for d in prom if kept(d))
        out["prometheus_tcp"] = sorted(d for d in tcp if kept(d))
        out["xray"] = sorted(d for d in self.xray.take() if kept(d))
        out["kafka"] = sorted(r for r in kafka if kept(r[3]))
        out["falconer"] = sorted(
            sp.SerializeToString() for sp in self.falconer.spans
            if INTERNAL not in sp.tags)
        self.falconer.spans.clear()
        lines = []
        if os.path.exists(self.flush_file):
            with open(self.flush_file) as f:
                lines = f.read().splitlines()
            os.unlink(self.flush_file)
        out["flush_file"] = sorted(ln for ln in lines if kept(ln))
        return out

    def close(self) -> None:
        for fake in self.http.values():
            fake.close()
        self.prom.close()
        self.prom_tcp.close()
        self.xray.close()
        self.kafka.close()
        self.falconer.stop()


def _metric_rows(path: str, doc) -> int:
    """The flushed metric rows in one request of a metric sink: series
    entries and the checks of STATUS rows (their timestamp set) for
    datadog, datapoints for signalfx, metrics and the events of STATUS
    rows (their ``statusCode``) for newrelic."""
    if path.startswith(("/api/v1/series", "/metric/v1")):
        return len(doc["series"] if "series" in doc
                   else doc[0]["metrics"])
    if path == "/v2/datapoint":
        return len(doc["gauge"]) + len(doc["counter"])
    if path.startswith("/api/v1/check_run"):
        return sum(1 for c in doc if "timestamp" in c)
    if path.endswith("/events"):
        return sum(1 for e in doc if "statusCode" in e)
    return 0


def _rows_of(doc) -> list:
    """A body of metric rows (datadog's ``series``, signalfx's
    ``gauge`` and ``counter``, newrelic's ``metrics``) as one body a
    row; any other body as itself."""
    if isinstance(doc, dict) and ("series" in doc or "gauge" in doc):
        return [{k: [row]} for k in ("series", "gauge", "counter")
                for row in doc.get(k, ())]
    if (isinstance(doc, list) and len(doc) == 1
            and isinstance(doc[0], dict) and "metrics" in doc[0]):
        return [[dict(doc[0], metrics=[row])]
                for row in doc[0]["metrics"]]
    return [doc]


def _statsd_line(line: bytes) -> tuple:
    head, _, tags = line.rstrip(b"\n").rpartition(b"|#")
    name, _, rest = head.partition(b":")
    value, _, kind = rest.rpartition(b"|")
    return ((name.decode(), kind.decode(), tags.decode()),
            float(value))


def metric_values(p: dict) -> dict:
    """The metric sinks' rows out of ``Backends.payloads``: per sink a
    map of each row's identity (name, kind and tags in the sink's own
    spelling) to its value; ``checks`` and ``events`` hold the datadog
    and kafka deliveries of events and service checks as decoded
    bodies."""
    out: dict = {k: {} for k in ("datadog", "signalfx", "newrelic",
                                 "prometheus", "prometheus_tcp", "kafka",
                                 "s3", "flush_file")}
    out["other"] = []
    for r in p["datadog"]:
        _m, path, _t, _e, doc = json.loads(r)
        if path.startswith("/api/v1/series"):
            for e in doc["series"]:
                key = ("series", e["metric"], e["type"], e["host"],
                       e.get("device_name", ""), tuple(e["tags"]))
                out["datadog"][key] = e["points"][0][1]
        elif path.startswith("/api/v1/check_run"):
            # a STATUS metric's check carries the flush's timestamp
            for c in doc:
                key = ("check", c["check"], c["host_name"],
                       tuple(c.get("tags", ())), c.get("message", ""),
                       "timestamp" in c)
                out["datadog"][key] = c["status"]
        else:
            out["other"].append(("datadog", path, doc))
    for r in p["signalfx"]:
        _m, path, token, _e, doc = json.loads(r)
        if path == "/v2/datapoint":
            for kind in ("gauge", "counter"):
                for d in doc.get(kind, ()):
                    key = (token, kind, d["metric"],
                           tuple(sorted(d["dimensions"].items())))
                    out["signalfx"][key] = d["value"]
        else:
            out["other"].append(("signalfx", path, doc))
    for r in p["newrelic"]:
        _m, path, _t, _e, doc = json.loads(r)
        if path == "/metric/v1":
            for d in doc[0]["metrics"]:
                key = (d["name"], d["type"],
                       tuple(sorted(d["attributes"].items())))
                out["newrelic"][key] = d["value"]
        elif path.endswith("/events"):
            out["other"].append(("newrelic", path, doc))
    for name in ("prometheus", "prometheus_tcp"):
        for line in p[name]:
            key, value = _statsd_line(line)
            out[name][key] = value
    for topic, _part, _key, value in p["kafka"]:
        if topic == "veneur_metrics":
            doc = json.loads(value)
            out["kafka"][(doc["name"], doc["type"],
                          tuple(doc["tags"]))] = doc["value"]
        elif topic in ("events", "checks"):
            out["other"].append(("kafka", topic, json.loads(value)))
    for name in ("s3", "flush_file"):
        lines = (json.loads(p["s3"][0])[4] if name == "s3" and p["s3"]
                 else p[name] if name == "flush_file" else [])
        for line in lines:
            cols = line.split("\t")
            out[name][(cols[0], cols[1], cols[2])] = float(cols[5])
    return out
