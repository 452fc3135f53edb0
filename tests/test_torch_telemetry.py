"""The port's self-telemetry and flush records against the reference's.

A port server on the CPU and a JAX server take the same traffic and
flush three times (the data interval, then two intervals carrying the
first ticks' loopback telemetry).  The ``veneur.*`` rows are held by
name on both sides; the count rows that come from the servers' stats
deltas and the ledger (``veneur.worker.*``, ``veneur.packet.*``,
``veneur.listen.*``, ``veneur.import.request_error_total``,
``veneur.ledger.*``, ``veneur.tier.*``, ``veneur.signals.rows_total``,
``veneur.flush.error_total``, ``veneur.forward.*_total``) by value;
timing rows (``*_duration_ns``, gc, memory, the flush timestamp) and
the device-cost registry's rows (``veneur.device.*``) by name only.
Every user metric is held as ``tests/test_torch_slice.py`` holds it.
The two registries' compile counters read zero (the reference counts
JIT compiles, the port library builds); both servers run their
ssfmetrics span sink, whose delivery counts (``veneur.sink.*``) are
held by value too.  The flush ring's stage names must be equal too.

Also: the ``stats_address`` path (DogStatsD datagrams), scopes and
extra tags, the per-protocol receive counter over a real socket, and
the new configuration keys with the reference's defaults and
environment overrides.
"""

from __future__ import annotations

import socket
import time

import numpy as np
import pytest

import veneur_tpu.observe as jobs
from veneur_tpu.core.config import Config as JConfig
from veneur_tpu.core.config import read_config as jread_config
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.protocol import columnar as jcolumnar
from veneur_tpu.sinks.simple import CaptureSink as JCaptureSink
from veneur_tpu_torch import observe
from veneur_tpu_torch.core.config import Config, read_config
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.sinks.simple import CaptureSink

_ROWS = {"tpu_counter_rows": 64, "tpu_gauge_rows": 64,
         "tpu_histo_rows": 64, "tpu_set_rows": 8}

# count rows whose values come from stats deltas or the ledger
_BY_VALUE = ("veneur.worker.", "veneur.packet.", "veneur.listen.",
             "veneur.import.request_error_total", "veneur.ledger.",
             "veneur.tier.", "veneur.signals.", "veneur.flush.error_total",
             "veneur.forward.post_metrics_total",
             "veneur.forward.error_total", "veneur.flight.",
             "veneur.sink.spans_", "veneur.sink.metrics_flushed_total")


@pytest.fixture(autouse=True)
def zero_compile_counters(monkeypatch):
    for reg in (jobs.REGISTRY, observe.REGISTRY):
        totals = reg.totals

        def zeroed(totals=totals):
            out = dict(totals())
            for k in ("compile_total", "compile_duration_ns",
                      "compile_cache_hits", "compile_cache_misses"):
                out[k] = 0
            return out
        monkeypatch.setattr(reg, "totals", zeroed)


def _pair(**cfg):
    # overload off on both servers: with the small classes here a
    # flush's pressure tick would engage it; its parity is held in
    # tests/test_torch_overload.py
    data = {"interval": "10s", "hostname": "h", **_ROWS,
            "tpu_overload": False, **cfg}
    jsrv = JServer(jread_config(data=data),
                   extra_sinks=[JCaptureSink()])
    tsrv = Server(read_config(data=data), device="cpu",
                  extra_sinks=[CaptureSink()])
    return jsrv, tsrv


def _traffic(seed: int) -> list[list[bytes]]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(16):
        lines = [b"c%d:%d|c" % (j % 5, j) for j in range(1 + i % 3)]
        lines += [b"t%d:%.3f|ms" % (j % 4, v)
                  for j, v in enumerate(rng.gamma(2.0, 30.0, 5 + i % 7))]
        lines += [b"g:%d|g" % i, b"u:m%d|s" % i]
        if i % 4 == 0:
            lines += [b"_sc|chk|1", b"bad line here"]
        out.append([b"\n".join(lines[k::2]) for k in range(2)])
    return out


def _by_key(metrics):
    out: dict = {}
    for m in metrics:
        out.setdefault((m.name, m.tags), []).append(m)
    return out


def _assert_same_telemetry(jm, tm):
    """The flushes' metric lists: user metrics held as the slice tests
    hold them, ``veneur.*`` by name and the stats-delta counts by
    value."""
    j, t = _by_key(jm), _by_key(tm)
    assert set(t) == set(j), (sorted(set(t) - set(j)),
                              sorted(set(j) - set(t)))
    n_value = 0
    for key, jv in j.items():
        tv = t[key]
        name = key[0]
        assert [m.type for m in tv] == [m.type for m in jv], key
        if name.startswith("veneur."):
            if name.startswith(_BY_VALUE) and jv[0].type == "counter":
                assert [m.value for m in tv] == [m.value for m in jv], key
                n_value += 1
            continue
        for a, b in zip(tv, jv):
            if name.endswith(("percentile", ".median")):
                np.testing.assert_allclose(a.value, b.value, rtol=2e-3,
                                           atol=1e-3, err_msg=str(key))
            else:
                assert a.value == b.value, (key, a.value, b.value)
    return n_value


@pytest.mark.parametrize("variant", ["pipelined", "serial", "columnar_off",
                                     "four_readers", "tiered"])
def test_telemetry_rows_match_jax(variant, monkeypatch):
    cfg, shards = {}, 0
    if variant == "serial":
        cfg["tpu_pipeline"] = False
    elif variant == "columnar_off":
        cfg["tpu_columnar_emit"] = False
    elif variant == "four_readers":
        cfg["num_readers"], shards = 4, 4
    elif variant == "tiered":
        monkeypatch.setenv("VENEUR_TPU_PLANE_TIERS", "2")
        monkeypatch.setenv("VENEUR_TPU_PROMOTE_HISTO_SAMPLES", "8")
    jsrv, tsrv = _pair(**cfg)
    try:
        parser = jcolumnar.ColumnarParser()
        js = [jsrv.table.make_reader_shard() for _ in range(shards)]
        ts = [tsrv.table.make_reader_shard() for _ in range(shards)]
        for i, pkts in enumerate(_traffic(4)):
            jsrv.handle_packet_batch(pkts, parser,
                                     shard=js[i % shards] if js else None)
            tsrv.handle_packet_batch(pkts,
                                     shard=ts[i % shards] if ts else None)
        for _ in range(3):
            jsrv.flush_once()
            tsrv.flush_once()
        n = _assert_same_telemetry(jsrv.metric_sinks[0].metrics,
                                   tsrv.metric_sinks[0].metrics)
        jst = [sorted(r.stages) for r in jsrv.flush_ring.records()]
        tst = [sorted(r.stages) for r in tsrv.flush_ring.records()]
        assert tst == jst
        names = {m.name for m in tsrv.metric_sinks[0].metrics}
    finally:
        jsrv.shutdown()
        tsrv.shutdown()
    assert n >= 6
    assert "veneur.worker.metrics_processed_total" in names
    assert "veneur.flush.stage_duration_ns.count" in names
    assert "veneur.ledger.received_total" in names
    if variant == "tiered":
        assert "veneur.device.plane_bytes" in names
        assert "veneur.tier.promotions_total" in names
    assert {"snapshot", "dispatch", "device_wait", "host_emit",
            "sink_flush", "sink.capture"} <= set(tst[0])


def test_telemetry_via_stats_address_matches_jax():
    """With ``stats_address`` the samples go out as DogStatsD datagrams
    (and stay out of the server's table): the same metric names and
    types as the JAX server's."""
    socks, got = [], {}
    for k in ("jax", "torch"):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", 0))
        s.settimeout(5)
        socks.append(s)
    jsrv, tsrv = None, None
    try:
        addrs = [f"127.0.0.1:{s.getsockname()[1]}" for s in socks]
        jsrv = JServer(jread_config(data={
            "interval": "10s", **_ROWS, "tpu_overload": False,
            "stats_address": addrs[0]}))
        tsrv = Server(read_config(data={
            "interval": "10s", **_ROWS, "tpu_overload": False,
            "stats_address": f"udp://{addrs[1]}"}), device="cpu")
        parser = jcolumnar.ColumnarParser()
        for pkts in _traffic(5):
            jsrv.handle_packet_batch(pkts, parser)
            tsrv.handle_packet_batch(pkts)
        for k, srv, s in (("jax", jsrv, socks[0]),
                          ("torch", tsrv, socks[1])):
            srv.flush_once()
            lines = s.recv(65536).decode().split("\n")
            got[k] = sorted({(ln.split(":")[0], ln.split("|")[1])
                             for ln in lines})
            # nothing was injected into the table
            srv.flush_once()
            assert srv.ledger.last().received == {}
    finally:
        for srv in (jsrv, tsrv):
            if srv is not None:
                srv.shutdown()
        for s in socks:
            s.close()
    assert got["torch"] == got["jax"]
    assert ("veneur.worker.metrics_processed_total", "c") in got["torch"]


def test_scopes_and_additional_tags():
    """``veneur_metrics_scopes`` and ``veneur_metrics_additional_tags``
    reach the server's own metrics, as in the reference."""
    srv = Server(read_config(data={
        "interval": "10s", **_ROWS,
        "veneur_metrics_scopes": {"counter": "global", "gauge": "local"},
        "veneur_metrics_additional_tags": ["team:obs"]}), device="cpu",
        extra_sinks=[CaptureSink()])
    seen = []
    ingest = srv.table.ingest

    def spy(s):
        if s.name.startswith("veneur."):
            seen.append(s)
        return ingest(s)
    srv.table.ingest = spy
    srv.handle_packet(b"a:1|c")
    srv.flush_once()
    srv.shutdown()
    assert seen and all("team:obs" in s.tags for s in seen)
    scopes = {s.type: s.scope for s in seen}
    assert scopes["counter"] == "global" and scopes["gauge"] == "local"
    assert scopes["timer"] == "local"


def test_received_per_protocol_over_udp():
    """A reader's datagrams count as ``received_dogstatsd-udp`` and the
    tick reports them under ``protocol:dogstatsd-udp``."""
    srv = Server(read_config(data={
        "interval": "300s", **_ROWS,
        "statsd_listen_addresses": ["udp://127.0.0.1:0"]}), device="cpu",
        extra_sinks=[CaptureSink()])
    srv.start()
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for i in range(5):
            s.sendto(b"udp.c:%d|c" % i, ("127.0.0.1", srv.bound_ports()[0]))
        s.close()
        deadline = time.monotonic() + 10
        while srv.stats["metrics_processed"] < 5:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        srv.flush_once()
        srv.flush_once()
        rows = {(m.name, m.tags): m.value
                for m in srv.metric_sinks[0].metrics}
        readers = srv.debug_vars()["devicecost"]["readers"]
    finally:
        srv.shutdown()
    assert rows[("veneur.listen.received_per_protocol_total",
                 ("protocol:dogstatsd-udp",))] == 5.0
    assert rows[("veneur.worker.metrics_processed_total",
                 ("worker:0",))] == 5.0
    assert sum(r["samples"] for r in readers.values()) >= 5


_KEYS = ("stats_address", "veneur_metrics_scopes",
         "veneur_metrics_additional_tags", "enable_profiling", "tpu_ledger_strict", "tpu_trace_propagation",
         "tpu_signal_history", "tpu_flight_dir", "tpu_flight_max_bundles",
         "tpu_flight_max_bytes", "tpu_flight_cooldown",
         "tpu_cluster_peers")


@pytest.mark.parametrize("key", _KEYS)
def test_config_key_default_and_env_as_reference(key):
    """Each observability key has the reference's default, and its
    ``VENEUR_<KEY>`` override coerces as the reference's does."""
    assert getattr(Config(), key) == getattr(JConfig(), key)
    raw = {"stats_address": "127.0.0.1:8125",
           "veneur_metrics_scopes": "counter:global,gauge:default",
           "veneur_metrics_additional_tags": "a:b, c:d",
           "enable_profiling": "0",
           "tpu_ledger_strict": "1", "tpu_trace_propagation": "0",
           "tpu_signal_history": "7", "tpu_flight_dir": "/tmp/x",
           "tpu_flight_max_bundles": "3", "tpu_flight_max_bytes": "9000",
           "tpu_flight_cooldown": "2s",
           "tpu_cluster_peers": "a:1,b:2"}[key]
    env = {"VENEUR_" + key.upper(): raw}
    assert getattr(read_config(data={}, env=env), key) == \
        getattr(jread_config(data={}, env=env), key)


@pytest.mark.parametrize("addr", ["localhost", "127.0.0.1:", "host:port"])
def test_stats_address_without_port_is_config_error(addr):
    with pytest.raises(ValueError, match="numeric port"):
        Server(read_config(data={"stats_address": addr, **_ROWS}),
               device="cpu")


def test_unknown_scope_refused_and_later_keys_still_refused():
    with pytest.raises(ValueError, match="veneur_metrics_scopes"):
        read_config(data={"veneur_metrics_scopes": {"counter": "nope"}})
    for key in ("datadog_api_key", "tpu_mesh_shards", "sentry_dsn"):
        with pytest.raises(ValueError, match="not supported"):
            read_config(data={key: 1})
