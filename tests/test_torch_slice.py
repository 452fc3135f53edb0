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
import threading
import time

import numpy as np
import pytest
import torch

import __graft_entry__
from veneur_tpu.core.flusher import Flusher as JFlusher
from veneur_tpu.core.table import MetricTable as JTable
from veneur_tpu.core.table import TableConfig as JConfig
from veneur_tpu.ops import superbatch as jsb
from veneur_tpu.ops import tdigest as jtd
from veneur_tpu.protocol import columnar as jcol
from veneur_tpu_torch import convert
from veneur_tpu_torch.core.config import read_config
from veneur_tpu_torch.core.flusher import Flusher
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.core.table import MetricTable, TableConfig
from veneur_tpu_torch.entry import entry
from veneur_tpu_torch.ops import cluster_merge, superbatch, tdigest
from veneur_tpu_torch.protocol import columnar, dogstatsd as dsd
from veneur_tpu_torch.sinks.simple import CaptureSink
from veneur_tpu_torch.utils import hashing
from tests.torch_fixtures import unsampled_span_uniqueness  # noqa: F401


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


def _assert_same_flush(tm, jm, percentiles=True):
    """``percentiles=False`` checks only the order-free values: digests
    depend on the order samples arrive in, so two arrival orders may
    differ in percentiles by more than the merge tolerance."""
    t, j = _by_name(tm), _by_name(jm)
    assert set(t) == set(j)
    for key, jv in j.items():
        tv = t[key]
        assert tv.type == jv.type, key
        name = key[0]
        if name.endswith(("percentile", ".median")):
            if not percentiles:
                continue
            np.testing.assert_allclose(tv.value, jv.value, rtol=2e-3,
                                       atol=1e-3, err_msg=str(key))
        elif name.endswith((".sum", ".avg", ".hmean")):
            np.testing.assert_allclose(tv.value, jv.value, rtol=1e-6,
                                       err_msg=str(key))
        else:  # counters, gauges, count/min/max, set estimates
            assert tv.value == jv.value, (key, tv.value, jv.value)


_SIZES = dict(counter_rows=32, gauge_rows=32, histo_rows=64, set_rows=8)


def _tables(sizes=_SIZES, **extra):
    """The JAX table with its native library (the port always has
    its own) and the port's, on the same configuration."""
    jt = JTable(JConfig(**sizes, **extra))
    assert jt._lib is not None
    tt = MetricTable(TableConfig(**sizes, **extra), device="cpu")
    return jt, tt


class _Routes:
    """Spies, in both packages alike, on which route each histogram
    and set batch took: ``events[pkg]`` lists (route, detail) in call
    order, and ``steps[pkg]`` counts superbatch steps."""

    def __init__(self, monkeypatch):
        self.events = {"jax": [], "torch": []}
        self.steps = {"jax": 0, "torch": 0}
        pkgs = (("jax", jtd, jsb, JTable), ("torch", tdigest, superbatch,
                                            MetricTable))
        for pkg, td, sb, table in pkgs:
            self._spy_plane(monkeypatch, pkg, td, "ingest_plane_pre_unit",
                            5, "unit")
            self._spy_plane(monkeypatch, pkg, td, "ingest_plane_pre", 4,
                            "weighted")
            self._spy_step(monkeypatch, pkg, sb)
            self._spy_table(monkeypatch, pkg, table)

    def _spy_plane(self, mp, pkg, td, name, v_arg, kind):
        fn = getattr(td, name)

        def spy(*a, **kw):
            dt = "f16" if "16" in str(a[v_arg].dtype) else "f32"
            self.events[pkg].append(("plane", f"{kind}_{dt}"))
            return fn(*a, **kw)
        mp.setattr(td, name, spy)

    def _spy_step(self, mp, pkg, sb):
        fn = sb.step

        def spy(*a, **kw):
            self.steps[pkg] += 1
            return fn(*a, **kw)
        mp.setattr(sb, "step", spy)

    def _spy_table(self, mp, pkg, table):
        ev = self.events[pkg]
        plane, merge, scan = (table._histo_plane_step, table._digest_merge,
                              table._digest_merge_scan)
        set_pack, host_fold = table._sb_set_pack, table._hll_host_fold

        def plane_spy(t, *a, **kw):
            handled, spill = plane(t, *a, **kw)
            if spill is not None:
                ev.append(("spill", len(spill[0])))
            return handled, spill

        def merge_spy(t, st, rows, vals, wts, rank, unit, with_stats):
            ev.append(("ranked", "stats" if with_stats else "digest"))
            return merge(t, st, rows, vals, wts, rank, unit, with_stats)

        def scan_spy(t, *a, **kw):
            ev.append(("deep_scan", "digest"))
            return scan(t, *a, **kw)

        def set_spy(t, parts):
            out = set_pack(t, parts)
            if out is not None:
                ev.append(("set", out[0]))
            return out

        def fold_spy(t, st, rows, pos):
            ev.append(("set", "host_fold"))
            return host_fold(t, st, rows, pos)
        for name, spy in (("_histo_plane_step", plane_spy),
                          ("_digest_merge", merge_spy),
                          ("_digest_merge_scan", scan_spy),
                          ("_sb_set_pack", set_spy),
                          ("_hll_host_fold", fold_spy)):
            mp.setattr(table, name, spy)

    def same(self) -> list:
        assert self.events["torch"] == self.events["jax"]
        assert self.steps["torch"] == self.steps["jax"]
        return self.events["torch"]


@pytest.mark.parametrize("path,extra,deep", [
    ("samples", {}, True),
    ("samples", {}, False),
    ("columns", {}, True),
    ("columns", {"host_set_plane_max_bytes": 0}, False),
    ("columns", {"histo_slots": 128}, True),
])
def test_interval_matches_jax(monkeypatch, path, extra, deep):
    """The same lines through the JAX table (with its native library)
    + flusher and through the port's: slow-path samples or a columnar
    batch; host-folded or device sets; a histogram batch that fits one
    merge width or one with a row deeper than it.  Both packages take
    the same route for every batch."""
    rng = np.random.default_rng(21)
    lines = _lines(rng, deep)
    jt, tt = _tables(**extra)
    routes = _Routes(monkeypatch)
    if path == "samples":
        for line in lines:
            s = dsd.parse_metric(line)
            jt.ingest(s)
            tt.ingest(s)
    else:
        tb, jb = _batch(lines)
        assert jt.ingest_columns(jb) == tt.ingest_columns(tb)
    before = cluster_merge.launch_count()
    jsnap, tsnap = jt.swap(), tt.swap()
    assert cluster_merge.launch_count() == before  # CPU: plain only
    routes.same()
    assert tt.superbatch_applies == routes.steps["torch"] == 1
    kw = dict(percentiles=PCTS, aggregates=AGGS, hostname="h")
    jr = JFlusher(is_local=False, **kw).flush(jsnap, now=1)
    tr = Flusher(**kw, device="cpu").flush(tsnap, now=1)
    assert len(tr.metrics) > 300
    _assert_same_flush(tr.metrics, jr.metrics)
    assert tr.tally == {k: v for k, v in jr.tally.items()
                        if k in tr.tally}


def _route_lines(rng, case: str) -> tuple[list[bytes], dict, dict]:
    """Text for one route case: (lines, table sizes, extra config).
    Every case also carries counters and gauges for the superbatch."""
    out = [f"c{i}:{i}|c".encode() for i in range(10)]
    out += [f"g{i}:{i * 0.5}|g".encode() for i in range(10)]
    sizes, extra = dict(_SIZES), {}
    if case == "plane_f16":
        # 40 timer rows x 60 unit samples: dense enough for the plane,
        # values inside f16's normal range
        for i in range(40):
            out += [f"p{i}:{v:.3f}|ms".encode()
                    for v in rng.gamma(2.0, 30.0, 60)]
    elif case == "plane_f32_weighted":
        # every histo row x 100 samples, half of them at @0.5: weights
        # ship, both planes f32
        for i in range(sizes["histo_rows"]):
            for j, v in enumerate(rng.gamma(2.0, 30.0, 100)):
                rate = "|@0.5" if j % 2 else ""
                out.append(f"w{i}:{v:.3f}|h{rate}".encode())
    elif case in ("spill_ranked", "spill_deep"):
        # 255 rows of 40 set the plane width (128); the hot row spills
        # its samples past it digest-only, through the ranked merge or,
        # past one merge width, the deep scan
        sizes["histo_rows"] = 256
        for i in range(255):
            out += [f"s{i}:{v:.3f}|ms".encode()
                    for v in rng.gamma(2.0, 30.0, 40)]
        hot = 600 if case == "spill_ranked" else 2000
        out += [f"hot:{v:.3f}|ms".encode()
                for v in rng.gamma(2.0, 30.0, hot)]
    elif case == "hll_compact_plane":
        # two set rows x 8000 members: a compact 8-row plane is the
        # smaller transfer
        extra["host_set_plane_max_bytes"] = 0
        for i in range(2):
            out += [f"u{i}:m{j}|s".encode() for j in range(8000)]
    elif case == "hll_full_plane":
        # six rows x 500 members: on the CPU a full plane's elementwise
        # max beats the scatter
        extra["host_set_plane_max_bytes"] = 0
        for i in range(6):
            out += [f"u{i}:m{j}|s".encode() for j in range(500)]
    elif case == "host_sets":
        # the default bound: sets fold on the host, estimated from the
        # fold's (ez, inv) statistics
        for i in range(6):
            out += [f"u{i}:m{j}|s".encode() for j in range(40 * (i + 1))]
    return out, sizes, extra


_ROUTE_CASES = {
    "plane_f16": ("plane", "unit_f16"),
    "plane_f32_weighted": ("plane", "weighted_f32"),
    "spill_ranked": ("ranked", "digest"),
    "spill_deep": ("deep_scan", "digest"),
    "hll_compact_plane": ("set", "plane"),
    "hll_full_plane": ("set", "plane_full"),
    "host_sets": ("set", "host_fold"),
}


@pytest.mark.parametrize("case", sorted(_ROUTE_CASES))
def test_ingest_buffer_interval_matches_jax(monkeypatch, case):
    """DogStatsD text through ``ingest_buffer`` in both tables (two
    buffers, with a device step between them), then swap and flush:
    both packages take the intended route for every batch, spied on in
    each, and flush the same values within the stated tolerances."""
    rng = np.random.default_rng(len(case))
    lines, sizes, extra = _route_lines(rng, case)
    lines = [lines[i] for i in rng.permutation(len(lines))]
    jt, tt = _tables(sizes=sizes, **extra)
    routes = _Routes(monkeypatch)
    half = len(lines) // 2
    for part in (lines[:half], lines[half:]):
        buf = b"\n".join(part)
        assert tt.ingest_buffer(buf) == jt.ingest_buffer(buf)
        jt.device_step()
        tt.device_step()
    jsnap, tsnap = jt.swap(), tt.swap()
    events = routes.same()
    assert _ROUTE_CASES[case] in events, events
    if case.startswith("spill"):
        assert ("spill", 600 - 128 if case == "spill_ranked"
                else 2000 - 128) in events
    if case == "host_sets":
        assert tsnap.host_only_sets and jsnap.host_only_sets
        assert tsnap.hll_host_ez is not None
        np.testing.assert_array_equal(tsnap.hll_host_ez, jsnap.hll_host_ez)
        np.testing.assert_array_equal(tsnap.hll_host_inv,
                                      jsnap.hll_host_inv)
        np.testing.assert_array_equal(tsnap.host_set_estimates(),
                                      jsnap.host_set_estimates())
    kw = dict(percentiles=PCTS, aggregates=AGGS, hostname="h")
    jr = JFlusher(is_local=False, **kw).flush(jsnap, now=1)
    tr = Flusher(**kw, device="cpu").flush(tsnap, now=1)
    assert len(tr.metrics) >= 20
    _assert_same_flush(tr.metrics, jr.metrics)


def _f1_lines(case: str) -> list[bytes]:
    """ROADMAP Queue 3's F1 inputs: f32 subnormal samples on each path
    (and a gauge, which both packages keep, as the control)."""
    if case == "counter":
        return [b"tc:1e-40|c"]
    if case == "gauge":
        return [b"tg:1e-40|g"]
    if case == "ranked":  # the superbatch's ranked merge
        return [b"tiny:1e-40|ms"] * 2
    if case == "min_hmean":
        return [b"mm:1e-40|ms", b"mm:5|ms"]
    if case == "weighted":
        return [b"tw:1e-40|ms|@0.5", b"tw:2e-40|ms|@0.5"]
    # a dense f32 plane row: 40 rows x 60 samples, then the subnormal
    rng = np.random.default_rng(1)
    return [f"p{i}:{v:.3f}|ms".encode() for i in range(40)
            for v in rng.gamma(2.0, 30.0, 60)] + [b"p0:1e-40|ms"]


@pytest.mark.parametrize("case", ["counter", "gauge", "ranked",
                                  "min_hmean", "weighted", "dense_plane"])
def test_f32_subnormals_flush_as_jax(case):
    """F1: the reference flushes f32 subnormal samples to zero inside
    its jitted ops; the port does the same, so the same text flushes
    the same metrics (``.hmean`` present or not alike) with every
    counter, min, max, sum and count bit-equal, signed zeros included.
    A gauge is a select in both and keeps its subnormal."""
    jt, tt = _tables()
    buf = b"\n".join(_f1_lines(case))
    assert tt.ingest_buffer(buf) == jt.ingest_buffer(buf)
    kw = dict(percentiles=PCTS, aggregates=AGGS, hostname="h")
    jr = JFlusher(is_local=False, **kw).flush(jt.swap(), now=1)
    tr = Flusher(**kw, device="cpu").flush(tt.swap(), now=1)
    _assert_same_flush(tr.metrics, jr.metrics)
    t, j = _by_name(tr.metrics), _by_name(jr.metrics)
    for key, jv in j.items():
        if key[0][:2] in ("tc", "tg", "ti", "mm", "tw") or \
                key[0].startswith("p0."):
            if not key[0].endswith("percentile"):
                assert (np.float64(t[key].value).tobytes() ==
                        np.float64(jv.value).tobytes()), key
    if case == "gauge":
        assert t[("tg", ())].value == 9.99994610111476e-41
    if case == "min_hmean":
        assert t[("mm.min", ())].value == 0.0
        assert ("mm.hmean", ()) in t
    if case in ("ranked", "weighted"):
        name = "tiny" if case == "ranked" else "tw"
        assert (name + ".hmean", ()) not in t
        assert t[(name + ".99percentile", ())].value == 0.0


def test_two_intervals_and_compaction():
    """Rows persist across intervals; idle rows compact away at the
    swap in both tables the same way."""
    jt, tt = _tables()
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


def test_snapshot_carried_across():
    """A JAX interval's planes + row metadata, converted, flush through
    the port's Flusher as through the JAX one."""
    rng = np.random.default_rng(3)
    jt, _ = _tables(host_set_plane_max_bytes=0)
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
        # an event (not a metric), a service check, and a datagram over
        # metric_max_length: rejected whole, a packet error
        msgs += [b"_e{5,4}:title|text|#a:b", b"_sc|svc.up|1|#x:y",
                 b"evil:1|c\n" + b"x" * 5000]
        for m in msgs:
            s.sendto(m, ("127.0.0.1", port))
        s.close()
        deadline = time.monotonic() + 20
        while ((srv.stats["metrics_processed"] < 505 or
                srv.stats["packet_errors"] < 1) and
               time.monotonic() < deadline):
            time.sleep(0.02)
        assert srv.stats["metrics_processed"] == 505
        assert srv.stats["packet_errors"] == 1
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
    assert vals["svc.up"] == 1.0
    assert not any(name.startswith("evil") for name in vals)
    assert {m.name: m.value for m in cap.metrics}["hits"] == 3.0
    assert not any(t.is_alive() for t in threads)


def test_config_refuses_unknown_keys(tmp_path):
    # a key neither package knows is refused by name
    with pytest.raises(ValueError, match="forward_grpc_tsl"):
        read_config(data={"interval": "2s",
                          "forward_grpc_tsl": True})
    p = tmp_path / "c.yaml"
    p.write_text(json.dumps({"interval": "2s", "percentiles": [0.5]}))
    assert read_config(str(p)).percentiles == [0.5]


@pytest.mark.parametrize("key,default", [
    ("metric_max_length", 4096), ("reader_batch_packets", 512),
    ("tpu_histo_slots", 512)])
def test_config_reader_keys(key, default):
    """The reader's and the table's keys keep the reference's names and
    defaults, and refuse non-positive values."""
    assert getattr(read_config(data={}), key) == default
    assert getattr(read_config(data={key: 77}), key) == 77
    with pytest.raises(ValueError, match=key):
        read_config(data={key: 0})


_READER_KEYS = ("num_readers", "tpu_multi_reader_fused",
                "tpu_reader_pin_cores", "tpu_stage_flush_samples",
                "tpu_pipeline", "tpu_columnar_emit")


def test_config_reader_pipeline_emit_keys_as_reference():
    """The reader, pipeline and emit keys keep the reference's names
    and defaults, read the reference's example.yaml values, take the
    reference's environment overrides, and validate alike, the drain
    tier key (``tpu_ingest_backend``) with them."""
    import os

    import yaml
    from veneur_tpu.core import config as jconfig
    jdef = jconfig.Config()
    tdef = read_config(data={}, env={})
    for key in _READER_KEYS:
        assert getattr(tdef, key) == getattr(jdef, key), key
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "example.yaml")) as f:
        ex = yaml.safe_load(f)
    data = {k: ex[k] for k in _READER_KEYS if k in ex}
    assert data == {"num_readers": 4}
    assert read_config(data=data, env={}).num_readers == 4
    env = {"VENEUR_TPU_PIPELINE": "0", "VENEUR_TPU_MULTI_READER_FUSED":
           "false", "VENEUR_TPU_READER_PIN_CORES": "2,3",
           "VENEUR_TPU_COLUMNAR_EMIT": "0"}
    tenv = read_config(data={}, env=env)
    jenv = jconfig.read_config(data={}, env=env)
    for key in ("tpu_pipeline", "tpu_multi_reader_fused",
                "tpu_reader_pin_cores", "tpu_columnar_emit"):
        assert getattr(tenv, key) == getattr(jenv, key), key
    assert (tenv.tpu_pipeline, tenv.tpu_reader_pin_cores) == (False, "2,3")
    for bad in ({"tpu_stage_flush_samples": 0},
                {"tpu_reader_pin_cores": "x,y"}):
        with pytest.raises(ValueError, match=next(iter(bad))):
            read_config(data=bad, env={})
    assert read_config(data={"tpu_ingest_backend": "recvmmsg"},
                       env={}).tpu_ingest_backend == jconfig.read_config(
        data={"tpu_ingest_backend": "recvmmsg"},
        env={}).tpu_ingest_backend == "recvmmsg"
    with pytest.raises(ValueError, match="tpu_ingest_backend") as got:
        read_config(data={"tpu_ingest_backend": "rcvmmsg"}, env={})
    with pytest.raises(ValueError) as want:
        jconfig.read_config(data={"tpu_ingest_backend": "rcvmmsg"}, env={})
    assert str(got.value) == str(want.value)


def _udp_config(num_readers: int, fused: bool = True):
    # the recvmmsg tier: its readers hand each sweep to
    # handle_packet_batch, which the tests below watch (the ring tier's
    # readers are held against the JAX server in test_torch_uring.py)
    return read_config(data={
        "interval": "60s", "hostname": "h", "num_readers": num_readers,
        "tpu_multi_reader_fused": fused, "tpu_ingest_backend": "recvmmsg",
        "statsd_listen_addresses": ["udp://127.0.0.1:0"],
        "percentiles": [0.5, 0.99], "tpu_counter_rows": 64,
        "tpu_gauge_rows": 64, "tpu_histo_rows": 64, "tpu_set_rows": 8},
        env={})


def _record_commits(srv: Server, commits: list) -> None:
    """Append each buffer the server's table commits, in commit order:
    a reader shard's ``commit`` and the split path's ``ingest_columns``
    both run under the server's lock."""
    table = srv.table
    make_shard, ingest_columns = (table.make_reader_shard,
                                  table.ingest_columns)

    def shard_spy():
        shard = make_shard()
        commit = shard.commit

        def commit_spy():
            commits.append(shard._buf)
            return commit()
        shard.commit = commit_spy
        return shard

    def columns_spy(pb):
        commits.append(pb.buf)
        return ingest_columns(pb)
    table.make_reader_shard = shard_spy
    table.ingest_columns = columns_spy


def _replay_flush(commits: list) -> dict:
    """A one-reader server fed ``commits`` in order, as recvmmsg chunks
    (no sockets), flushed once: metrics by (name, tags)."""
    cap = CaptureSink()
    srv = Server(_udp_config(1), device="cpu", extra_sinks=[cap])
    try:
        for buf in commits:
            srv.handle_packet_batch([], drained=buf, drained_pkts=1)
        srv.flush_once()
    finally:
        srv.shutdown()
    return _by_name(cap.metrics)


def _udp_flush(num_readers: int, packets: dict, fused: bool = True,
               commits: list | None = None):
    """A port server with ``num_readers`` readers on one address, fed
    ``packets`` ({source socket index: [datagram, ...]}) from that many
    source sockets, flushed once.  Returns (metrics by (name, tags),
    the reader threads that took a batch); ``commits`` collects the
    buffers the table committed, in commit order."""
    cap = CaptureSink()
    srv = Server(_udp_config(num_readers, fused), device="cpu",
                 extra_sinks=[cap])
    if commits is not None:
        _record_commits(srv, commits)
    readers = set()
    batch = srv.handle_packet_batch

    def spy(*a, **kw):
        readers.add((threading.current_thread().name,
                     kw.get("shard") is not None))
        return batch(*a, **kw)
    srv.handle_packet_batch = spy
    srv.start()
    try:
        assert len(srv.sockets) == num_readers
        port = srv.bound_ports()[0]
        assert all(s.getsockname()[1] == port for s in srv.sockets)
        expect = sum(p.count(b"\n") + 1 for pk in packets.values()
                     for p in pk)
        socks = {i: socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                 for i in packets}
        for i, pk in packets.items():
            for p in pk:
                socks[i].sendto(p, ("127.0.0.1", port))
                time.sleep(0.0002)
        for sk in socks.values():
            sk.close()
        deadline = time.monotonic() + 20
        while (srv.stats["metrics_processed"] < expect and
               time.monotonic() < deadline):
            time.sleep(0.02)
        assert srv.stats["metrics_processed"] == expect
        srv.flush_once()
    finally:
        srv.shutdown()
    return _by_name(cap.metrics), readers


@pytest.mark.parametrize("fused", [True, False])
def test_udp_server_four_readers_flush_as_one(fused):
    """Eight source sockets into a server with ``num_readers: 4``
    (SO_REUSEPORT spreads them over the readers, each with its own
    ReaderShard, or with ``tpu_multi_reader_fused: false`` the split
    columnar path) and into a one-reader server: the same metrics, with
    counters, gauges (each series from one socket), counts, min/max and
    set values equal, sums within 1e-6.  Percentiles depend on the order
    the readers committed in, so they are held bit for bit to a
    one-reader replay of that order."""
    rng = np.random.default_rng(9)
    packets = {}
    for i in range(8):
        lines = [b"hits:1|c", b"g%d:%d|g" % (i, i * 3 + 1)]
        lines += [b"lat:%.3f|ms" % v for v in rng.gamma(2.0, 30.0, 40)]
        lines += [b"uniq:u%d|s" % (i * 100 + j) for j in range(30)]
        packets[i] = [b"\n".join(lines[k::4]) for k in range(4)] * 5
    commits = []
    many, readers = _udp_flush(4, packets, fused, commits)
    one, one_readers = _udp_flush(1, packets)
    assert all(shard is fused for _name, shard in readers)
    assert len(readers) >= 2, readers
    assert not any(shard for _name, shard in one_readers)
    _assert_same_flush(list(many.values()), list(one.values()),
                       percentiles=False)
    assert many[("hits", ())].value == 8 * 5
    replay = _replay_flush(commits)
    assert set(replay) == set(many)
    for key, m in many.items():
        assert (m.type, m.value) == (replay[key].type,
                                     replay[key].value), key
    assert ("lat.99percentile", ()) in replay


# ---- the port's rules ------------------------------------------------------

def test_port_imports_no_jax():
    """Importing the package and every module, building a table
    (untiered and tiered, the latter through an interval), running a
    server through two observed flushes and a device profile capture,
    a sharded local forwarding through a proxy to a global over gRPC
    (routed columnar by the native entries, drained on shutdown), and a
    global with overload control, a checkpointer writing segments and
    an arc handoff to a second global, loads neither jax nor any
    veneur_tpu module, maps the port's own native library, never the
    JAX package's, and exits with every worker thread stopped (checked
    in a fresh interpreter: this test process has imported both)."""
    code = """
import importlib, pkgutil, sys
import veneur_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    veneur_tpu_torch.__path__, "veneur_tpu_torch.")]
for n in names:
    importlib.import_module(n)
assert {"veneur_tpu_torch.core.frame",
        "veneur_tpu_torch.core.tiers",
        "veneur_tpu_torch.forward.http_import",
        "veneur_tpu_torch.forward.gob_codec",
        "veneur_tpu_torch.forward.hll_codec",
        "veneur_tpu_torch.forward.grpc_forward",
        "veneur_tpu_torch.forward.gen.forward_pb2",
        "veneur_tpu_torch.protocol.gen.health_pb2",
        "veneur_tpu_torch.protocol.gen.ssf_pb2",
        "veneur_tpu_torch.protocol.wire",
        "veneur_tpu_torch.trace.spans",
        "veneur_tpu_torch.trace.client",
        "veneur_tpu_torch.core.spans",
        "veneur_tpu_torch.core.debughttp",
        "veneur_tpu_torch.core.telemetry",
        "veneur_tpu_torch.observe.devicecost",
        "veneur_tpu_torch.observe.flushring",
        "veneur_tpu_torch.observe.traceindex",
        "veneur_tpu_torch.observe.tracer",
        "veneur_tpu_torch.observe.ledger",
        "veneur_tpu_torch.observe.signals",
        "veneur_tpu_torch.observe.recorder",
        "veneur_tpu_torch.observe.profiler",
        "veneur_tpu_torch.forward.ring",
        "veneur_tpu_torch.forward.route",
        "veneur_tpu_torch.forward.breaker",
        "veneur_tpu_torch.forward.destpool",
        "veneur_tpu_torch.forward.discovery",
        "veneur_tpu_torch.forward.spool",
        "veneur_tpu_torch.forward.shard",
        "veneur_tpu_torch.core.proxy",
        "veneur_tpu_torch.cli.proxy",
        "veneur_tpu_torch.trace.metrics",
        "veneur_tpu_torch.core.overload",
        "veneur_tpu_torch.ops.checkpoint",
        "veneur_tpu_torch.ops.fdpass",
        "veneur_tpu_torch.forward.handoff",
        "veneur_tpu_torch.chaos",
        "veneur_tpu_torch.chaos.injector",
        "veneur_tpu_torch.native.uring"} <= set(names)
from veneur_tpu_torch.core.table import MetricTable, TableConfig
from veneur_tpu_torch.forward import gob_codec
MetricTable(TableConfig(histo_rows=8), device="cpu")
import os
os.environ["VENEUR_TPU_PLANE_TIERS"] = "2"
tiered = MetricTable(TableConfig(histo_rows=64), device="cpu")
assert tiered.tiers is not None
tiered.ingest_buffer(b"t:1|ms\\nu:a|s")
tiered.swap()
gob_codec.decode_batch([gob_codec.encode_counter(1)], [1])
from veneur_tpu_torch.forward import grpc_forward
assert grpc_forward.decode_metric_list(b"")["n"] == 0
from veneur_tpu_torch.core.config import read_config
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.observe import capture_device_profile
srv = Server(read_config(data={"tpu_histo_rows": 8}), device="cpu")
srv.handle_packet(b"a:1|c")
srv.flush_once()
srv.flush_once()
assert srv.ledger.last().balanced and srv.signals.rows() == 2
srv.shutdown()
capture_device_profile(0.05)
import threading, time
from veneur_tpu_torch.core.config import ProxyConfig
from veneur_tpu_torch.core.proxy import ProxyServer
glob = Server(read_config(data={"tpu_histo_rows": 8,
    "grpc_listen_addresses": ["tcp://127.0.0.1:0"]}), device="cpu")
glob.start()
px = ProxyServer(ProxyConfig(grpc_address="127.0.0.1:0",
    forward_address=f"127.0.0.1:{glob.grpc_ports[0]}"))
px.start()
loc = Server(read_config(data={"tpu_histo_rows": 8,
    "forward_use_grpc": True, "tpu_sharded_global": True,
    "forward_address": f"127.0.0.1:{px.grpc_port}"}),
    device="cpu")
loc.handle_packet(b"g:1|c|#veneurglobalonly\\nh:2|c|#veneurglobalonly")
loc.shutdown()
assert loc.stats["drain_flushes"] == 1
deadline = time.monotonic() + 20
while (px.stats.get("metrics_routed", 0) < 1 or
       glob.stats.get("imports_received", 0) < px.stats["metrics_routed"]):
    assert time.monotonic() < deadline, (px.stats, glob.stats)
    time.sleep(0.02)
assert px.stats.get("columnar_fallbacks", 0) == 0
px.shutdown()
glob.shutdown()
import tempfile
ckdir = tempfile.mkdtemp()
gcfg = {"tpu_histo_rows": 8, "grpc_listen_addresses": ["tcp://127.0.0.1:0"]}
g1 = Server(read_config(data=dict(gcfg, tpu_checkpoint_dir=ckdir,
    tpu_checkpoint_interval="50ms")), device="cpu")
g1.start()
g2 = Server(read_config(data=gcfg), device="cpu")
g2.start()
assert g1.overload is not None and g1._checkpointer is not None
g1.handle_packet(b"\\n".join(b"k%d:1|c" % i for i in range(20)))
deadline = time.monotonic() + 20
while g1._checkpointer.stats["written"] < 1:
    assert time.monotonic() < deadline, g1._checkpointer.stats
    time.sleep(0.02)
addrs = [f"127.0.0.1:{g.grpc_ports[0]}" for g in (g1, g2)]
ho = g1.arc_handoff(addrs, addrs[0])
assert ho["errors"] == 0 and ho["moved_rows"] == ho["items"] > 0
g1.shutdown()
g2.shutdown()
left = [t.name for t in threading.enumerate()
        if t.name.startswith(("proxy-dest-", "discovery-refresh",
                              "checkpointer"))
        and t.is_alive()]
assert not left, left
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib",
                                            "veneur_tpu.")))
with open("/proc/self/maps") as f:
    libs = {ln.split()[-1] for ln in f if ".so" in ln}
bad += sorted(p for p in libs if "/veneur_tpu/native/" in p)
assert any("/veneur_tpu_torch/_build/libdsd_parse-" in p for p in libs)
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
    m, w = tdigest.empty_state(2, 40, "cpu")
    with pytest.raises(ValueError, match="capacity"):
        tdigest._merge_impl(m, w, m, w, compression=100.0)
    assert jtd.capacity_for(100.0) == tdigest.capacity_for(100.0)
