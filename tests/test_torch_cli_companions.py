"""The port's three CLI companions against the reference's.

``python -m veneur_tpu_torch.cli.{emit,prometheus,top}`` run the same
arguments as ``veneur_tpu.cli.{emit,prometheus,top}`` and must send or
print the same thing: emit's datagrams (statsd lines, events, service
checks, SSF spans) and gRPC bodies; the prometheus poller's statsd
lines and counter diffs from the same scrapes; vtop's ``--json`` and
table from the same ``/debug/signals`` summaries.  Each port CLI runs
against a port server too.
"""

from __future__ import annotations

import http.server
import json
import random
import socket
import subprocess
import sys
import threading
import time
from concurrent import futures

import grpc
import pytest

from veneur_tpu.cli import emit as jemit
from veneur_tpu.cli import prometheus as jprom
from veneur_tpu.cli import top as jtop
from veneur_tpu_torch.cli import emit, prometheus, top
from veneur_tpu_torch.core.config import read_config
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.protocol.gen import ssf_pb2


class _Udp:
    def __init__(self):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.addr = f"127.0.0.1:{self.sock.getsockname()[1]}"

    def drain(self, wait: float = 0.3) -> list[bytes]:
        out = []
        self.sock.settimeout(wait)
        try:
            while True:
                out.append(self.sock.recv(65536))
        except socket.timeout:
            pass
        return out

    def close(self):
        self.sock.close()


@pytest.fixture
def udp():
    u = _Udp()
    yield u
    u.close()


EMIT_CASES = [
    ["-name", "a.b", "-count", "3", "-tag", "env:v", "-tag", "x:y"],
    ["-name", "a.g", "-gauge", "-2.5"],
    ["-name", "a.t", "-timing", "12.75", "-rate", "0.5"],
    ["-name", "a.s", "-set", "user-9"],
    ["-mode", "event", "-e_title", "deploy\nok", "-e_text", "went out",
     "-e_time", "1700000000", "-e_priority", "low",
     "-e_event_tags", "svc:web,env:prod"],
    ["-mode", "sc", "-sc_name", "db.up", "-sc_status", "1",
     "-sc_msg", "slow", "-sc_tags", "env:prod", "-sc_time",
     "1700000000"],
]


@pytest.mark.parametrize("case", range(len(EMIT_CASES)))
def test_emit_datagrams_equal_jax(udp, case):
    argv = ["-hostport", f"udp://{udp.addr}"] + EMIT_CASES[case]
    assert jemit.main(argv) == 0
    want = udp.drain()
    assert emit.main(argv) == 0
    got = udp.drain()
    assert got == want and got


def test_emit_build_line_equal_jax():
    for args in (("n", 1.5, "c", ["a:b"], 0.25), ("n", 3, "g", [], 1.0),
                 ("n", "m", "s", ["k"], 1.0)):
        assert emit.build_line(*args) == jemit.build_line(*args)


def _span(data: bytes):
    s = ssf_pb2.SSFSpan.FromString(data)
    for m in s.metrics:
        m.timestamp = 0
    return s


def test_emit_ssf_span_equal_jax(udp):
    argv = ["-hostport", f"udp://{udp.addr}", "-ssf", "-name", "op",
            "-count", "2", "-timing", "40", "-tag", "k:v",
            "-span_starttime", "1700000000", "-span_endtime",
            "1700000001", "-span_tags", "req:9", "-indicator"]
    random.seed(11)
    assert jemit.main(argv) == 0
    want = udp.drain()
    random.seed(11)
    assert emit.main(argv) == 0
    got = udp.drain()
    assert len(got) == len(want) == 1
    assert _span(got[0]) == _span(want[0])
    assert len(_span(got[0]).metrics) == 2


class _GrpcCapture:
    """A gRPC server that records every unary request's raw body."""

    def __init__(self):
        self.bodies: list[tuple[str, bytes]] = []

        def handler(method):
            def fn(request, context):
                self.bodies.append((method, request))
                return b""
            return grpc.unary_unary_rpc_method_handler(fn)

        self.server = grpc.server(futures.ThreadPoolExecutor(2))
        self.server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler("dogstatsd.DogstatsdGRPC",
                                                 {"SendPacket":
                                                  handler("packet")}),
            grpc.method_handlers_generic_handler("ssf.SSFGRPC",
                                                 {"SendSpan":
                                                  handler("span")})))
        self.port = self.server.add_insecure_port("127.0.0.1:0")
        self.server.start()

    def close(self):
        self.server.stop(None)


def test_emit_grpc_bodies_equal_jax():
    cap = _GrpcCapture()
    try:
        argv = ["-hostport", f"127.0.0.1:{cap.port}", "-grpc", "-name",
                "g.m", "-count", "4", "-gauge", "1.5", "-tag", "t:1"]
        assert jemit.main(argv) == 0
        assert emit.main(argv) == 0
        span_argv = argv + ["-ssf", "-span_starttime", "1700000000",
                            "-span_endtime", "1700000002"]
        for mod in (jemit, emit):
            random.seed(5)
            assert mod.main(span_argv) == 0
    finally:
        cap.close()
    (m1, b1), (m2, b2), (m3, b3), (m4, b4) = cap.bodies
    assert m1 == m2 == "packet" and b1 == b2 and b1
    assert m3 == m4 == "span" and _span(b3) == _span(b4)


def test_emit_drives_a_port_server():
    srv = Server(read_config(data={
        "statsd_listen_addresses": ["udp://127.0.0.1:0"],
        "interval": "10s"}), device="cpu")
    srv.start()
    try:
        port = srv.statsd_ports[0]
        for i in range(5):
            assert emit.main(["-hostport", f"udp://127.0.0.1:{port}",
                              "-name", "emit.hits", "-count", "2"]) == 0
        deadline = time.monotonic() + 10
        while (srv.stats["metrics_processed"] < 5
               and time.monotonic() < deadline):
            time.sleep(0.02)
        res = srv.flush_once()
        got = {m.name: m.value for m in res.metrics}
        assert got["emit.hits"] == 10.0
    finally:
        srv.shutdown()


def test_emit_runs_as_a_module(udp):
    out = subprocess.run(
        [sys.executable, "-m", "veneur_tpu_torch.cli.emit", "-hostport",
         f"udp://{udp.addr}", "-name", "mod.c", "-count", "1"],
        capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert udp.drain() == [b"mod.c:1.0|c"]


SCRAPE_1 = """\
# TYPE http_requests_total counter
http_requests_total{method="get",code="200"} 100
http_requests_total{method="post",code="200"} 3
# TYPE queue_depth gauge
queue_depth 7.5
# TYPE rpc_duration_seconds summary
rpc_duration_seconds{quantile="0.5"} 0.05
rpc_duration_seconds_sum 12.5
rpc_duration_seconds_count 200
# TYPE req_size histogram
req_size_bucket{le="100"} 40
req_size_bucket{le="+Inf"} 50
req_size_sum 4000
req_size_count 50
untyped_thing 9
esc{path="a\\\\b\\"c"} 1
"""

SCRAPE_2 = SCRAPE_1.replace(" 100\n", " 150\n").replace(
    "queue_depth 7.5", "queue_depth 6").replace(
    "_count 200", "_count 230").replace(" 3\n", " 1\n")


def test_prometheus_translation_and_diffs_equal_jax():
    """One fake scrape, then a second: the same statsd lines, counter
    diffs and reset suppression, label handling included."""
    assert prometheus.parse_exposition(SCRAPE_1) == \
        jprom.parse_exposition(SCRAPE_1)
    for kw in ({}, {"ignored_labels": ("code",),
                    "added_tags": ("dc:east",)}):
        cache, jcache = {}, {}
        for scrape in (SCRAPE_1, SCRAPE_2):
            got = prometheus.translate(prometheus.parse_exposition(scrape),
                                       cache, **kw)
            want = jprom.translate(jprom.parse_exposition(scrape),
                                   jcache, **kw)
            assert got == want
        assert cache == jcache


def test_prometheus_main_once_equal_jax(udp):
    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.end_headers()
            self.wfile.write(SCRAPE_1.encode())

        def log_message(self, *a):
            pass

    httpd = http.server.HTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        argv = ["-host", f"http://127.0.0.1:{httpd.server_port}/metrics",
                "-statsd-host", udp.addr, "-once", "-p", "pfx."]
        assert jprom.main(argv) == 0
        want = udp.drain()
        assert prometheus.main(argv) == 0
        got = udp.drain()
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert got == want and b"pfx.queue_depth:7.5|g" in b"\n".join(got)


@pytest.fixture
def signal_nodes():
    """A port server with /debug listeners, one interval flushed, and
    a fixed copy of its /debug/signals summary served by a static
    endpoint (so both CLIs read the same bytes)."""
    srv = Server(read_config(data={
        "statsd_listen_addresses": [], "http_address": "127.0.0.1:0",
        "interval": "10s", "hostname": "vtop-port"}), device="cpu")
    srv.start()
    for i in range(8):
        srv.handle_packet(f"vt.lat.{i}:12|ms\nvt.c:{i}|c".encode())
    srv.flush_once()
    live = f"127.0.0.1:{srv.http_port}"
    body = top.scrape_node(live)
    body.pop("addr")
    payload = json.dumps(body).encode()

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        yield live, f"127.0.0.1:{httpd.server_port}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.shutdown()


def test_vtop_json_and_table_equal_jax(signal_nodes, capsys):
    live, static = signal_nodes
    nodes = ",".join([static, "127.0.0.1:1"])  # one node down
    outs = []
    for mod in (jtop, top):
        assert mod.main(["--nodes", nodes, "--json"]) == 1
        doc = json.loads(capsys.readouterr().out)
        doc.pop("scraped_unix")
        assert mod.main(["--nodes", nodes]) == 1
        outs.append((doc, capsys.readouterr().out))
    (jdoc, jtable), (pdoc, ptable) = outs
    assert pdoc == jdoc and ptable == jtable
    assert "vtop-port" in ptable and "DOWN" in ptable
    # and against the live port server
    assert top.main(["--nodes", live, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["nodes"][0]["node"] == "vtop-port"
    assert not [t for t in threading.enumerate()
                if t.name.startswith("vtop-scrape-")]
