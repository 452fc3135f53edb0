"""A port server and a JAX server, both on the CPU, with every sink
configured, against local fakes.

Both servers take the same config (every metric sink, every span sink,
the s3 plugin and the flush file; ``tags_exclude`` with a global and a
``|sink``-scoped rule; the same ``tpu_overload``), each against fakes
of its own (``veneur_tpu_torch.tools.sink_fakes``), with the wall clock
pinned so both flushes carry one timestamp.  They are fed the same
DogStatsD text, events and service checks among it, and the same SSF
spans; one flush each.  Every fake's decoded payload must be equal:
HTTP bodies decompressed and decoded, Kafka records decoded, datagrams
and streams as received, gRPC spans as serialized, in an order-free
form where the order is a thread's.  DogStatsD events and service
checks reach ``flush_other_samples`` in both.  Also the reference's
``test_config_wires_sink_family`` and
``test_flush_file_format_reference_end_to_end`` on the port server.
"""

from __future__ import annotations

import importlib
import json
import threading
import time

import pytest

from veneur_tpu.core.config import read_config as jread_config
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.protocol.gen import ssf_pb2
from veneur_tpu_torch.core.config import read_config
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.protocol import dogstatsd as dsd
from veneur_tpu_torch.tools import sink_fakes

_ROWS = {"tpu_counter_rows": 64, "tpu_gauge_rows": 64,
         "tpu_histo_rows": 32, "tpu_set_rows": 8}
NOW = 1_700_000_000.0


def _config(backends, **over) -> dict:
    return {"interval": "60s", "hostname": "sinkhost", **_ROWS,
            "statsd_listen_addresses": [], "percentiles": [0.5, 0.99],
            "tpu_overload": True, "tpu_sink_workers": 1,
            "tags_exclude": ["secret", "team|datadog"],
            "datadog_flush_max_per_body": 7,
            "signalfx_flush_max_per_body": 5,
            **backends.config(), **over}


TEXT = [
    b"hits:3|c|#team:t1,secret:x", b"hits:2|c|@0.5|#team:t1,secret:x",
    b"api:1|c|#route:a,team:t2", b"temp:9|g|#host:other,device:sda",
    b"temp:4|g|#room:b", b"users:a|s", b"users:b|s|#team:t1",
    b"lat:10|ms", b"lat:20|ms", b"lat:30|ms|#team:t2",
    b"only.dd:5|c|#veneursinkonly:datadog",
    b"_e{6,2}:deploy|v2|d:1700000000|h:web1|k:agg|p:low|s:ci|t:warning"
    b"|#env:prod",
    b"_e{5,4}:alert|oops|#team:t1",
    b"_sc|db.up|2|d:1700000000|h:db1|#env:prod|m:down",
    b"_sc|cache.up|0|#team:t2",
]


def _spans():
    out = []
    for i in range(6):
        sp = ssf_pb2.SSFSpan(
            version=0, trace_id=100 + i // 2, id=200 + i,
            parent_id=(200 + i - 1) if i % 2 else 0, name=f"op{i % 3}",
            service=f"svc{i % 2}", error=bool(i % 3 == 0),
            indicator=(i == 4),
            start_timestamp=1_700_000_000_000_000_000 + i,
            end_timestamp=1_700_000_001_000_000_000 + 7 * i)
        sp.tags["route"] = f"r{i}"
        sp.tags["secret"] = "x"
        out.append(sp)
    return out


class _PinnedTime:
    """The ``time`` module with ``time()`` pinned (monotonic clocks,
    and so every timeout, stay real)."""

    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def time() -> float:
        return NOW


def _pin_flush_time(monkeypatch) -> None:
    """Both servers stamp their flush (and the s3 object key) with one
    wall-clock time."""
    for pkg in ("veneur_tpu", "veneur_tpu_torch"):
        for name in ("core.server", "core.flusher", "sinks.s3"):
            monkeypatch.setattr(importlib.import_module(f"{pkg}.{name}"),
                                "time", _PinnedTime())


def _run(server, spans, packet) -> None:
    server.start()
    for sp in spans:
        c = ssf_pb2.SSFSpan()
        c.CopyFrom(sp)
        server.handle_ssf(c)
    packet(b"\n".join(TEXT))
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        with server._stats_lock:
            n = server.stats.get("spans_processed", 0)
        if n >= len(spans):
            break
        time.sleep(0.02)
    server.flush_once()


def test_port_and_jax_servers_deliver_equal_payloads_to_every_sink(
        tmp_path, monkeypatch):
    _pin_flush_time(monkeypatch)
    from veneur_tpu.sinks.prometheus import PrometheusRepeaterSink as JProm
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    tfakes = sink_fakes.Backends(str(tmp_path / "port"))
    jfakes = sink_fakes.Backends(str(tmp_path / "jax"))
    port = Server(read_config(data=_config(tfakes), env={}),
                  device="cpu", extra_sinks=tfakes.extra_sinks())
    jtcp = JProm(f"127.0.0.1:{jfakes.prom_tcp.port}", "tcp")
    jtcp.name = "prometheus_tcp"
    jax = JServer(jread_config(data=_config(jfakes), env={}),
                  extra_sinks=[jtcp])
    tfakes.patch(port)
    jfakes.patch(jax)
    try:
        assert ([type(s).__name__ for s in port.metric_sinks] ==
                [type(s).__name__ for s in jax.metric_sinks])
        assert ([type(s).__name__ for s in port.span_sinks] ==
                [type(s).__name__ for s in jax.span_sinks])
        assert ([type(s).__name__ for s in port.plugins] ==
                [type(s).__name__ for s in jax.plugins])
        _run(port, _spans(), port.handle_packet)
        _run(jax, _spans(), jax.handle_packet)
        got, want = tfakes.payloads(), jfakes.payloads()
        for key in want:
            assert got[key] == want[key], key
        # every fake heard something, and the rules held
        for key, val in got.items():
            assert val, key
        dd = [json.loads(r)[4] for r in got["datadog"]]
        series = [e for d in dd if "series" in d for e in d["series"]]
        assert series and not any(t.startswith(("team:", "secret:"))
                                  for e in series for t in e["tags"])
        assert any(e["metric"] == "only.dd" for e in series)
        sfx = [json.loads(r) for r in got["signalfx"]]
        assert {r[2] for r in sfx} >= {"sk", "k1", "k2"}
        assert not any("secret" in p["dimensions"] for r in sfx
                       if r[1] == "/v2/datapoint"
                       for kind in ("gauge", "counter")
                       for p in r[4].get(kind, ()))
        # events and service checks reached flush_other_samples
        paths = {json.loads(r)[1].split("?")[0] for r in got["datadog"]}
        assert {"/intake", "/api/v1/check_run"} <= paths
        assert any(json.loads(r)[1] == "/v1/accounts/42/events"
                   for r in got["newrelic"])
        topics = {t for t, _, _, _ in got["kafka"]}
        assert {"events", "checks", "veneur_metrics", "spans"} <= topics
        assert any(json.loads(r)[1] == "/v2/event"
                   for r in got["signalfx"])
        # the ledger's per-sink emission is what each sink was routed
        rec = port.ledger.last()
        assert rec.balanced
        assert set(rec.emitted_per_sink) == {
            "datadog", "prometheus", "signalfx", "newrelic", "kafka",
            "prometheus_tcp"}
        for name in ("prometheus", "prometheus_tcp", "kafka"):
            assert rec.emitted_per_sink[name] == tfakes.rows[name]
        jrec = jax.ledger.last()
        assert set(jrec.emitted_per_sink) == set(rec.emitted_per_sink)
        assert (rec.fanout_busy_drops, rec.fanout_retries,
                rec.fanout_timeouts) == (0, 0, 0)
    finally:
        port.shutdown()
        jax.shutdown()
        tfakes.close()
        jfakes.close()


def test_events_and_checks_reach_other_samples_in_order():
    """The port buffers DogStatsD events and service checks from every
    ingest path and hands them to each metric sink once, in arrival
    order, as the JAX server does; the checks also flush as STATUS
    metrics."""
    from veneur_tpu.sinks.simple import CaptureSink as JCapture
    from veneur_tpu_torch.sinks.simple import CaptureSink

    data = {"interval": "10s", "hostname": "h", **_ROWS,
            "tpu_overload": False}
    cap, jcap = CaptureSink(), JCapture()
    port = Server(read_config(data=data, env={}), device="cpu",
                  extra_sinks=[cap])
    jax = JServer(jread_config(data=data, env={}), extra_sinks=[jcap])
    try:
        from veneur_tpu.protocol import dogstatsd as jdsd
        for srv, parse in ((port, dsd.parse_line),
                           (jax, jdsd.parse_line)):
            srv.handle_packet(b"\n".join(TEXT))
            srv.ingest_parsed(parse(b"_e{3,1}:one|x"))
            srv.ingest_parsed(parse(b"_sc|solo|1"))
            srv.flush_once()
            srv.flush_once()  # nothing left for a second interval

        def key(o):
            return (type(o).__name__, repr(o))
        assert [key(o) for o in cap.other] == [key(o) for o in jcap.other]
        assert len(cap.other) == 6
        status = sorted((m.name, m.value, m.tags, m.message)
                        for m in cap.metrics if m.type == "status")
        assert status == sorted((m.name, m.value, m.tags, m.message)
                                for m in jcap.metrics
                                if m.type == "status")
        assert [s[0] for s in status] == ["cache.up", "db.up", "solo"]
        assert port.stats["metrics_processed"] == \
            jax.stats["metrics_processed"]
    finally:
        port.shutdown()
        jax.shutdown()


@pytest.mark.parametrize("workers", [0, 1])
def test_tags_exclude_rules_per_sink(workers):
    """A bare rule strips the tag on every sink, a ``|sink`` rule on
    the named sinks only, on metric and span sinks alike."""
    from veneur_tpu_torch.sinks.simple import CaptureSink

    class Named(CaptureSink):
        def __init__(self, name):
            super().__init__()
            self.name = name

    a, b = Named("alpha"), Named("beta")
    port = Server(read_config(data={
        "interval": "10s", "hostname": "h", **_ROWS,
        "tpu_sink_workers": workers,
        "tags_exclude": ["secret", "team|beta"]}, env={}),
        device="cpu", extra_sinks=[a, b])
    try:
        assert a.excluded_tags == frozenset({"secret"})
        assert b.excluded_tags == frozenset({"secret", "team"})
        port.handle_packet(b"x:1|c|#secret:s,team:t,keep:k")
        port.flush_once()
        ta = {m.tags for m in a.metrics if m.name == "x"}
        tb = {m.tags for m in b.metrics if m.name == "x"}
        assert ta == {("keep:k", "team:t")} and tb == {("keep:k",)}
    finally:
        port.shutdown()


def test_config_wires_sink_family():
    srv = Server(read_config(data={
        "interval": "10s", "hostname": "h", **_ROWS,
        "signalfx_api_key": "t", "newrelic_insert_key": "k",
        "kafka_broker": "127.0.0.1:9092", "kafka_span_topic": "spans",
        "datadog_trace_api_address": "http://127.0.0.1:8126",
        "splunk_hec_address": "http://127.0.0.1:8088",
        "splunk_hec_token": "tok", "xray_address": "127.0.0.1:2000",
        "lightstep_access_token": "lt",
        "falconer_address": "127.0.0.1:1", "aws_s3_bucket": "b",
    }, env={}), device="cpu")
    try:
        metric_names = [type(s).__name__ for s in srv.metric_sinks]
        span_names = [type(s).__name__ for s in srv.span_sinks]
        for want in ("SignalFxSink", "NewRelicMetricSink",
                     "KafkaMetricSink"):
            assert want in metric_names
        for want in ("NewRelicSpanSink", "KafkaSpanSink",
                     "DatadogSpanSink", "SplunkSpanSink", "XRaySpanSink",
                     "LightStepSpanSink", "FalconerSpanSink"):
            assert want in span_names
        assert [type(p).__name__ for p in srv.plugins] == ["S3Plugin"]
    finally:
        srv.shutdown()


def test_flush_file_format_reference_end_to_end(tmp_path):
    path = tmp_path / "flush.tsv"
    srv = Server(read_config(data={
        "interval": "10s", "hostname": "h0", **_ROWS,
        "flush_file": str(path), "flush_file_format": "reference"},
        env={}), device="cpu")
    try:
        srv.table.ingest(dsd.Sample(name="ref.hits", type=dsd.COUNTER,
                                    value=20.0))
        srv.flush_once()
    finally:
        srv.shutdown()
    rows = [r.split("\t") for r in path.read_text().splitlines()]
    hit = [r for r in rows if r[0] == "ref.hits"]
    assert hit, rows
    assert len(hit[0]) == 8
    assert hit[0][2] == "rate" and hit[0][6] == "2" and hit[0][4] == "10"


def test_stalled_plugin_skips_not_queues():
    """A plugin still busy from the last interval skips this one,
    counted as ``flush_skipped_busy``; the sinks keep flowing."""
    from veneur_tpu_torch.sinks.simple import CaptureSink

    release = threading.Event()

    class Slow:
        name = "slow"

        def flush(self, metrics, hostname=""):
            release.wait(timeout=30)

    cap = CaptureSink()
    srv = Server(read_config(data={
        "interval": "1s", "hostname": "h", **_ROWS}, env={}),
        device="cpu", extra_sinks=[cap], extra_plugins=[Slow()])
    try:
        for i in range(2):
            srv.handle_packet(b"p%d:1|c" % i)
            srv.flush_once()
        assert srv.stats["flush_slow_tasks"] >= 1
        assert srv.stats["flush_skipped_busy"] == 1
        assert {"p0", "p1"} <= {m.name for m in cap.metrics}
    finally:
        release.set()
        srv.shutdown()


def test_shutdown_returns_while_a_plugin_is_blocked():
    """``shutdown`` leaves a plugin still blocked in its flush behind:
    the server stops, the fan-out and telemetry close, and the call
    returns without waiting on the plugin."""
    from veneur_tpu_torch.sinks.simple import CaptureSink

    entered, release = threading.Event(), threading.Event()

    class Wedged:
        name = "wedged"

        def flush(self, metrics, hostname=""):
            entered.set()
            release.wait(timeout=60)

    srv = Server(read_config(data={
        "interval": "1s", "hostname": "h", **_ROWS}, env={}),
        device="cpu", extra_sinks=[CaptureSink()], extra_plugins=[Wedged()])
    try:
        srv.handle_packet(b"w:1|c")
        srv.flush_once()
        assert entered.is_set()
        t0 = time.monotonic()
        srv.shutdown()
        assert time.monotonic() - t0 < 10
        assert not release.is_set()
        assert all(not w._thread.is_alive()
                   for w in srv._fanout._workers.values())
    finally:
        release.set()


def test_wedged_forward_skips_not_holds_flush():
    """A local's forward runs on the flush pool, as the reference's
    does: a global that never answers costs the flush one bounded wait
    (``flush_slow_tasks``), the next interval's forward is skipped as
    busy, and the sinks keep flowing."""
    import socket

    from veneur_tpu_torch.sinks.simple import CaptureSink

    held = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    held.bind(("127.0.0.1", 0))
    held.listen(4)  # never accepted: the POST waits for an answer
    cap = CaptureSink()
    srv = Server(read_config(data={
        "interval": "1s", "hostname": "h", **_ROWS,
        "forward_address": f"http://127.0.0.1:{held.getsockname()[1]}"},
        env={}), device="cpu", extra_sinks=[cap])
    try:
        for i in range(2):
            srv.handle_packet(b"fw.lat:%d|ms" % (i + 1))
            srv.handle_packet(b"fw%d:1|c" % i)
            t0 = time.monotonic()
            srv.flush_once()
            assert time.monotonic() - t0 < 5
        assert srv.stats["flush_slow_tasks"] >= 1
        assert srv.stats["flush_skipped_busy"] == 1
        assert {"fw0", "fw1"} <= {m.name for m in cap.metrics}
    finally:
        held.close()  # resets the queued connection: the POST fails
        srv.shutdown()
