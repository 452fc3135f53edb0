"""CPU parity of the PyTorch port's whole slice against the JAX package:
``entry()``, the table + flusher interval, state carried across, the
UDP server, and the port's own rules (no JAX imported, explicit
device).

Tolerances (each comparison states its own): counters, gauges, counts,
min/max and HLL-derived set values match exactly; float sums to rtol
1e-6; percentiles to rtol 2e-3 / atol 1e-3, the reference's merge
tolerance (tests/test_pallas_merge.py).
"""

from __future__ import annotations

import json
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import __graft_entry__
from veneur_tpu import native
from veneur_tpu.core.flusher import Flusher as JFlusher
from veneur_tpu.core.table import MetricTable as JTable
from veneur_tpu.core.table import TableConfig as JConfig
from veneur_tpu.ops import tdigest as jtd
from veneur_tpu.protocol import columnar as jcol
from veneur_tpu_torch import convert
from veneur_tpu_torch.core.config import read_config
from veneur_tpu_torch.core.flusher import Flusher
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.core.table import MetricTable, TableConfig
from veneur_tpu_torch.entry import entry
from veneur_tpu_torch.ops import cluster_merge, tdigest
from veneur_tpu_torch.protocol import columnar, dogstatsd as dsd
from veneur_tpu_torch.sinks.simple import CaptureSink
from veneur_tpu_torch.utils import hashing

PCTS = (0.5, 0.9, 0.99)
AGGS = ("min", "max", "count", "sum", "avg", "median", "hmean")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---- entry ------------------------------------------------------------

def test_entry_matches_graft_entry():
    jstep, jargs = __graft_entry__.entry()
    tstep, targs = entry("cpu")
    for a, b in zip(jargs, targs):
        np.testing.assert_array_equal(np.asarray(a), _np(b))
    jc, js, jm, jw, jr, jq, je = (np.asarray(x) for x in jstep(*jargs))
    tc, ts, tm, tw, tr, tq, te = (_np(x) for x in tstep(*targs))
    np.testing.assert_allclose(tc, jc, rtol=1e-6)        # scatter-add
    np.testing.assert_array_equal(tr, jr)                 # registers
    np.testing.assert_array_equal(ts[:, 1:3], js[:, 1:3])  # min/max
    np.testing.assert_allclose(ts, js, rtol=1e-6)
    np.testing.assert_allclose(tw.sum(1), jw.sum(1), rtol=1e-6)
    np.testing.assert_allclose(tq, jq, rtol=2e-3, atol=1e-3,
                               equal_nan=True)
    np.testing.assert_allclose(te, je, rtol=1e-6)


# ---- the interval: table + flusher ------------------------------------

def _lines(rng, deep=True):
    out = [b"hits:2|c", b"hits:3|c|#env:a", b"hits:1|c|@0.5",
           b"temp:7|g", b"temp:9|g", b"temp:1|g|#env:a",
           b"glob:4|c|#veneurglobalonly", b"loc:1|ms|#veneurlocalonly"]
    for v in range(200):
        out.append(f"lat:{v}|ms".encode())
    for v in rng.gamma(2.0, 30.0, 1500 if deep else 300):
        out.append(f"deep:{v:.3f}|h|#k:v".encode())   # > 512 per row
    for i in range(30):
        for v in rng.normal(100.0, 5.0, 20):
            out.append(f"t{i}:{v:.4f}|ms".encode())
    out.append(b"zero:0|ms")
    for i in range(300):
        out.append(f"users:u{i}|s".encode())
        out.append(f"ids:{i % 40}|s|#env:b".encode())
    return out


def _batch(lines) -> tuple:
    """A ParsedBatch (port and reference shapes) built from lines with
    the pure-Python parser: one entry per line, keyed by series."""
    buf = b"\n".join(lines)
    offs = np.cumsum([0] + [len(x) + 1 for x in lines[:-1]])
    codes = {dsd.COUNTER: columnar.CODE_COUNTER,
             dsd.GAUGE: columnar.CODE_GAUGE,
             dsd.TIMER: columnar.CODE_TIMER,
             dsd.HISTOGRAM: columnar.CODE_HISTOGRAM,
             dsd.SET: columnar.CODE_SET}
    n = len(lines)
    cols = dict(key_hash=np.zeros(n, np.uint64),
                type_code=np.zeros(n, np.uint8),
                value=np.zeros(n, np.float64),
                member_hash=np.zeros(n, np.uint64),
                weight=np.ones(n, np.float32),
                scope=np.zeros(n, np.uint8),
                line_off=offs.astype(np.int64),
                line_len=np.array([len(x) for x in lines], np.int32))
    members = []
    for i, line in enumerate(lines):
        s = dsd.parse_metric(line)
        code = codes[s.type]
        sc = columnar.SCOPE_CODES.index(s.scope)
        cols["key_hash"][i] = hashing.key_hash64(s.name, code, s.tags, sc)
        cols["type_code"][i] = code
        cols["scope"][i] = sc
        cols["weight"][i] = 1.0 / s.sample_rate
        if s.type == dsd.SET:
            members.append((i, s.value.encode()))
        else:
            cols["value"][i] = s.value
    idx = [i for i, _ in members]
    cols["member_hash"][idx] = hashing.hash64([m for _, m in members])
    return (columnar.ParsedBatch(buf=buf, n=n, **cols),
            jcol.ParsedBatch(buf=buf, n=n, **cols))


def _by_name(metrics):
    out = {}
    for m in metrics:
        out[(m.name, m.tags)] = m
    assert len(out) == len(metrics), "duplicate metric keys"
    return out


def _assert_same_flush(tm, jm):
    t, j = _by_name(tm), _by_name(jm)
    assert set(t) == set(j)
    for key, jv in j.items():
        tv = t[key]
        assert tv.type == jv.type, key
        name = key[0]
        if name.endswith(("percentile", ".median")):
            np.testing.assert_allclose(tv.value, jv.value, rtol=2e-3,
                                       atol=1e-3, err_msg=str(key))
        elif name.endswith((".sum", ".avg", ".hmean")):
            np.testing.assert_allclose(tv.value, jv.value, rtol=1e-6,
                                       err_msg=str(key))
        else:  # counters, gauges, count/min/max, set estimates
            assert tv.value == jv.value, (key, tv.value, jv.value)


_SIZES = dict(counter_rows=32, gauge_rows=32, histo_rows=64, set_rows=8)


def _tables(monkeypatch, **extra):
    monkeypatch.setattr(native, "load", lambda: None)
    jt = JTable(JConfig(**_SIZES, **extra))
    assert jt._lib is None
    tt = MetricTable(TableConfig(**_SIZES, **extra), device="cpu")
    return jt, tt


@pytest.mark.parametrize("path,extra,deep", [
    ("samples", {}, True),
    ("samples", {}, False),
    ("columns", {}, True),
    ("columns", {"host_set_plane_max_bytes": 0}, False),
    ("columns", {"histo_slots": 128}, True),
])
def test_interval_matches_jax(monkeypatch, path, extra, deep):
    """The same lines through the JAX table (no native library) +
    flusher and through the port's: slow-path samples or a columnar
    batch; host-folded or device sets; a histogram batch that fits one
    merge width (the superbatch arm) or one with a row deeper than it
    (host stats fold + one merge per chunk)."""
    rng = np.random.default_rng(21)
    lines = _lines(rng, deep)
    jt, tt = _tables(monkeypatch, **extra)
    if path == "samples":
        for line in lines:
            s = dsd.parse_metric(line)
            jt.ingest(s)
            tt.ingest(s)
    else:
        tb, jb = _batch(lines)
        assert jt.ingest_columns(jb) == tt.ingest_columns(tb)
    before = cluster_merge.launches
    jsnap, tsnap = jt.swap(), tt.swap()
    assert cluster_merge.launches == before  # CPU: plain version only
    assert tt.superbatch_applies == 1
    kw = dict(percentiles=PCTS, aggregates=AGGS, hostname="h")
    jr = JFlusher(is_local=False, **kw).flush(jsnap, now=1)
    tr = Flusher(**kw, device="cpu").flush(tsnap, now=1)
    assert len(tr.metrics) > 300
    _assert_same_flush(tr.metrics, jr.metrics)
    assert tr.tally == {k: v for k, v in jr.tally.items()
                        if k in tr.tally}


def test_two_intervals_and_compaction(monkeypatch):
    """Rows persist across intervals; idle rows compact away at the
    swap in both tables the same way."""
    jt, tt = _tables(monkeypatch)
    kw = dict(percentiles=PCTS, aggregates=AGGS)
    for interval in range(3):
        lines = [f"c{interval}_{i}:1|c".encode() for i in range(20)]
        lines += [f"lat:{v}|ms".encode() for v in range(50)]
        for line in lines:
            s = dsd.parse_metric(line)
            jt.ingest(s)
            tt.ingest(s)
        jr = JFlusher(is_local=False, **kw).flush(jt.swap(), now=1)
        tr = Flusher(**kw, device="cpu").flush(tt.swap(), now=1)
        _assert_same_flush(tr.metrics, jr.metrics)
        assert ([m.name for m in tt.counter_idx.meta] ==
                [m.name for m in jt.counter_idx.meta])


def test_snapshot_carried_across(monkeypatch):
    """A JAX interval's planes + row metadata, converted, flush through
    the port's Flusher as through the JAX one."""
    rng = np.random.default_rng(3)
    jt, _ = _tables(monkeypatch, host_set_plane_max_bytes=0)
    for line in _lines(rng):
        jt.ingest(dsd.parse_metric(line))
    snap = jt.swap()
    state = {k: np.asarray(getattr(snap, k)) for k in convert.PLANES}
    for k in ("counter_meta", "gauge_meta", "histo_meta", "set_meta",
              "counter_touched", "gauge_touched", "histo_touched",
              "set_touched", "hll_host_plane", "hll_device_touched"):
        state[k] = getattr(snap, k)
    tsnap = convert.snapshot_from_numpy(state, device="cpu")
    back = convert.planes_to_numpy(
        {k: getattr(tsnap, k) for k in convert.PLANES})
    for k in convert.PLANES:
        np.testing.assert_array_equal(back[k], state[k])
    kw = dict(percentiles=PCTS, aggregates=AGGS)
    jr = JFlusher(is_local=False, **kw).flush(snap, now=1)
    tr = Flusher(**kw, device="cpu").flush(tsnap, now=1)
    _assert_same_flush(tr.metrics, jr.metrics)


# ---- server -------------------------------------------------------------

def test_server_udp_flush_file(tmp_path):
    out = tmp_path / "flush.tsv"
    cfg = read_config(data={
        "interval": "60s", "hostname": "h",
        "statsd_listen_addresses": ["udp://127.0.0.1:0"],
        "flush_file": str(out), "percentiles": [0.5, 0.99],
        "tpu_counter_rows": 64, "tpu_gauge_rows": 64,
        "tpu_histo_rows": 64, "tpu_set_rows": 8})
    cap = CaptureSink()
    srv = Server(cfg, device="cpu", extra_sinks=[cap])
    srv.start()
    threads = list(srv._threads)
    assert len(threads) == 2
    try:
        port = srv.bound_ports()[0]
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        msgs = [b"hits:1|c"] * 3 + [b"temp:4.5|g"]
        msgs += [f"lat:{v}|ms".encode() for v in range(200)]
        msgs += [b"\n".join(f"uniq:u{i}|s".encode()
                            for i in range(j, j + 50))
                 for j in range(0, 300, 50)]
        for m in msgs:
            s.sendto(m, ("127.0.0.1", port))
        s.close()
        deadline = time.monotonic() + 20
        while (srv.stats["metrics_processed"] < 504 and
               time.monotonic() < deadline):
            time.sleep(0.02)
        assert srv.stats["metrics_processed"] == 504
        srv.flush_once()
    finally:
        srv.shutdown()
    rows = [r.split("\t") for r in out.read_text().splitlines()]
    vals = {r[0]: float(r[5]) for r in rows}
    assert vals["hits"] == 3.0
    assert vals["temp"] == 4.5
    assert vals["lat.count"] == 200.0
    # the value the JAX server flushes for this stream
    assert repr(vals["lat.99percentile"]) == "197.00999450683594"
    assert abs(vals["uniq"] - 300) <= 15
    assert {m.name: m.value for m in cap.metrics}["hits"] == 3.0
    assert not any(t.is_alive() for t in threads)


def test_config_refuses_unknown_keys(tmp_path):
    with pytest.raises(ValueError, match="http_address"):
        read_config(data={"interval": "2s",
                          "http_address": "127.0.0.1:1"})
    p = tmp_path / "c.yaml"
    p.write_text(json.dumps({"interval": "2s", "percentiles": [0.5]}))
    assert read_config(str(p)).percentiles == [0.5]


# ---- the port's rules ------------------------------------------------------

def test_port_imports_no_jax():
    """Importing the package and every module loads neither jax nor
    any veneur_tpu module (checked in a fresh interpreter: this test
    process has imported both)."""
    code = """
import importlib, pkgutil, sys
import veneur_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    veneur_tpu_torch.__path__, "veneur_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib",
                                            "veneur_tpu.")))
print(len(names), bad)
assert not bad, bad
"""
    out = subprocess.run([sys.executable, "-c", code],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 20


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a card every entry point refuses to run unless the
    caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = read_config(data={"tpu_histo_rows": 8})
    for make in (lambda: MetricTable(),
                 lambda: MetricTable(TableConfig(histo_rows=8)),
                 lambda: Server(cfg),
                 lambda: entry(),
                 lambda: Flusher(),
                 lambda: convert.planes_from_numpy({})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert MetricTable(TableConfig(histo_rows=8),
                       device="cpu").device.type == "cpu"


def test_merge_capacity_guard():
    m, w = tdigest.empty_state(2, 40)
    with pytest.raises(ValueError, match="capacity"):
        tdigest._merge_impl(m, w, m, w, compression=100.0)
    assert jtd.capacity_for(100.0) == tdigest.capacity_for(100.0)
