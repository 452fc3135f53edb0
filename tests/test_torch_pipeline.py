"""The port's pipelined device step against the reference's: no sample
lost or counted twice across the swap, ``complete_swap`` waits for
every detached apply, and a port server detaches staged work at the
same points as a JAX server fed the same stream.

Ports ``tests/test_pipeline.py:45`` (exact totals under concurrent
ingest and flushes, pipelined and serial) and ``:149`` (pipelined and
serial flushes agree), the latter also held against a JAX server.

Tolerances: counters and counts exact; the JAX comparison as in
``tests/test_torch_slice.py`` (sums rtol 1e-6, percentiles rtol 2e-3 /
atol 1e-3, the rest exact).
"""

from __future__ import annotations

import sys
import threading

import numpy as np
import pytest

from veneur_tpu.core.config import read_config as jread_config
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.protocol import columnar as jcolumnar
from veneur_tpu.sinks.simple import CaptureSink as JCaptureSink
from veneur_tpu_torch.core.config import read_config
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.core.table import MetricTable, TableConfig
from veneur_tpu_torch.protocol import dogstatsd as dsd
from veneur_tpu_torch.sinks.simple import CaptureSink

_ROWS = {"tpu_counter_rows": 64, "tpu_gauge_rows": 64,
         "tpu_histo_rows": 64, "tpu_set_rows": 8}


def _make_server(pipeline: bool, histo_merge_samples: int | None = None,
                 **overrides):
    cfg = read_config(data={"interval": "10s", "hostname": "test-host",
                            "tpu_pipeline": pipeline, **_ROWS,
                            **overrides})
    cap = CaptureSink()
    srv = Server(cfg, device="cpu", extra_sinks=[cap])
    if histo_merge_samples is not None:
        # detach histogram staging at every step, not at 4 Mi samples
        srv.table.config.histo_merge_samples = histo_merge_samples
    return srv, cap


def _totals(cap):
    out: dict = {}
    for m in cap.metrics:
        if m.type == "counter":
            out[m.name] = out.get(m.name, 0.0) + m.value
    return out


@pytest.mark.parametrize("pipeline", [True, False])
def test_concurrent_ingest_exact_totals_across_swaps(pipeline):
    """Reader threads ingest multi-line packets while a flusher thread
    swaps over and over; with a tiny staging bound the mid-interval
    steps fire constantly (pipelined: detached under the lock, applied
    on the reader threads).  Counter totals and histogram counts over
    every flush are exact."""
    srv, cap = _make_server(pipeline, histo_merge_samples=32,
                            tpu_stage_flush_samples=64)
    assert srv.pipeline is pipeline
    applies = [0]
    apply = srv.table.apply_staged

    def counting_apply(w):
        applies[0] += 1
        apply(w)
    srv.table.apply_staged = counting_apply
    n_threads, n_packets, lines = 4, 120, 5
    start = threading.Barrier(n_threads + 1)
    stop = threading.Event()

    def reader():
        pkt = b"\n".join(b"hits:1|c\nlat:%d|ms" % (i % 37)
                         for i in range(lines))
        start.wait()
        for _ in range(n_packets):
            srv.handle_packet(pkt)

    def flusher():
        start.wait()
        while not stop.is_set():
            srv.flush_once()

    threads = [threading.Thread(target=reader) for _ in range(n_threads)]
    ft = threading.Thread(target=flusher)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads + [ft]:
            t.start()
        for t in threads:
            t.join(timeout=120)
        stop.set()
        ft.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads + [ft])
    srv.flush_once()  # what the last interval staged
    srv.shutdown()
    expect = n_threads * n_packets * lines
    tot = _totals(cap)
    assert tot.get("hits") == float(expect)
    assert tot.get("lat.count") == float(expect)
    assert srv.stats["metrics_processed"] == 2 * expect
    assert srv.stats["metrics_dropped"] == 0
    assert (applies[0] > 0) is pipeline


def _stream():
    pkts = [b"hits:3|c\nlat:%d|ms\ntemp:%d|g\nusers:u%d|s"
            % (i % 50, i % 11, i % 7) for i in range(300)]
    return pkts + [b"_sc|db.up|0|m:fine"]


def _flush_set(cap):
    return sorted((m.name, m.type, round(float(m.value), 6))
                  for m in cap.metrics)


def test_pipeline_and_serial_flush_outputs_agree():
    """A deterministic single-threaded stream flushes the same metrics
    pipelined and serial."""
    def run(pipeline):
        srv, cap = _make_server(pipeline, histo_merge_samples=64,
                                tpu_stage_flush_samples=128)
        for pkt in _stream():
            srv.handle_packet(pkt)
        srv.flush_once()
        srv.shutdown()
        return _flush_set(cap)

    assert run(True) == run(False)


def test_complete_swap_waits_for_held_apply():
    """Work detached before the swap but not yet applied holds
    ``complete_swap`` until it lands, and its samples flush in the
    interval they were staged in, not the next."""
    t = MetricTable(TableConfig(histo_rows=16, histo_merge_samples=8),
                    device="cpu")
    for v in range(20):
        t.ingest(dsd.parse_metric(f"lat:{v}|ms".encode()))
    w = t.take_staged()
    assert w is not None and w.state.pending == 1
    pend = t.begin_swap()
    t.ingest(dsd.parse_metric(b"lat:99|ms"))  # the next interval
    out = {}
    waiter = threading.Thread(
        target=lambda: out.setdefault("snap", t.complete_swap(pend)))
    waiter.start()
    waiter.join(timeout=0.3)
    assert waiter.is_alive(), "complete_swap did not wait"
    t.apply_staged(w)
    waiter.join(timeout=10)
    assert not waiter.is_alive() and w.state.pending == 0
    stats = np.asarray(out["snap"].histo_stats)
    assert stats[0, 0] == 20.0  # weight: the held 20 samples
    assert stats[0, 2] == 19.0  # max: the next interval's 99 is not here
    nxt = t.swap()
    assert np.asarray(nxt.histo_stats)[0, 0] == 1.0


def _spy_detach(table, log):
    take = table.take_staged

    def spy(final=False):
        staged = table.staged()
        w = take(final)
        histo = 0
        if w is not None and w.histo is not None:
            histo = len(w.histo)
        log.append((staged, w is not None, histo))
        return w
    table.take_staged = spy


def test_detach_points_match_jax_server():
    """A port server and a JAX server, fed the same packets through
    ``handle_packet_batch`` with the same staging bounds, call the
    pipelined step at the same staged counts, detach the same histogram
    batches, and flush the same metrics."""
    data = {"interval": "10s", "hostname": "h",
            "tpu_stage_flush_samples": 100, "percentiles": [0.5, 0.99],
            "aggregates": ["min", "max", "count"], **_ROWS}
    jsrv = JServer(jread_config(data=data), extra_sinks=[JCaptureSink()])
    jsrv.table.config.histo_merge_samples = 150
    jcap = jsrv.metric_sinks[0]
    tsrv, tcap = _make_server(True, histo_merge_samples=150,
                              **{k: v for k, v in data.items()
                                 if k not in _ROWS})
    assert jsrv.pipeline and tsrv.pipeline
    jlog, tlog = [], []
    _spy_detach(jsrv.table, jlog)
    _spy_detach(tsrv.table, tlog)
    rng = np.random.default_rng(5)
    parser = jcolumnar.ColumnarParser()
    for i in range(40):
        lines = [b"c%d:1|c" % (j % 9) for j in range(i % 5)]
        lines += [b"t%d:%.2f|ms" % (j % 6, v)
                  for j, v in enumerate(rng.gamma(2.0, 30.0, 7 + i % 13))]
        lines += [b"g:%d|g" % i, b"u%d:m%d|s" % (i % 3, i)]
        pkts = [b"\n".join(lines[k::3]) for k in range(3)]
        jsrv.handle_packet_batch(pkts, parser)
        tsrv.handle_packet_batch(pkts)
    assert tlog == jlog
    assert any(h for _s, _w, h in tlog)  # histogram batches detached
    jsrv.flush_once()
    tsrv.flush_once()
    jsrv.shutdown()
    tsrv.shutdown()
    t = {(m.name, m.tags): m.value for m in tcap.metrics}
    j = {(m.name, m.tags): m.value for m in jcap.metrics
         if not m.name.startswith("veneur.")}
    assert set(t) == set(j)
    for key, jv in j.items():
        if "percentile" in key[0]:
            np.testing.assert_allclose(t[key], jv, rtol=2e-3, atol=1e-3)
        else:
            assert t[key] == jv, key
