"""CPU parity of the port's global tier over gRPC against the JAX package.

The MetricList codec (``rows_to_metric_list``), the columnar import
(``decode_metric_list``, ``apply_decoded``, the row and wire-plan
caches), the per-item protobuf path, the decode scratch, the frozen
Go-side wire fixture, an in-process ``ImportServer`` and a local ->
global chain of two port servers over real gRPC.  Every parity case
feeds the same seeded inputs through ``veneur_tpu`` and
``veneur_tpu_torch``.

Tolerances (each comparison states its own): serialized wires, decoded
columns, identity hashes, counters, gauges, counts, min/max, HLL
registers and set estimates match exactly; float sums to rtol 1e-6;
percentiles to rtol 2e-3 / atol 1e-3 (tests/test_pallas_merge.py).
"""

from __future__ import annotations

import base64
import json
import os
import socket
import sys
import threading
import time
import urllib.request

import grpc
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veneur_tpu.core.flusher import Flusher as JFlusher
from veneur_tpu.core.table import MetricTable as JTable
from veneur_tpu.core.table import TableConfig as JConfig
from veneur_tpu.forward import grpc_forward as jgf
from veneur_tpu.ops import tdigest as jtd
from veneur_tpu_torch.core.config import read_config
from veneur_tpu_torch.core.flusher import Flusher
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.core.table import MetricTable, TableConfig
from veneur_tpu_torch.forward import grpc_forward as gf
from veneur_tpu_torch.forward.gen import forward_pb2, metric_pb2
from veneur_tpu_torch.ops import tdigest
from veneur_tpu_torch.protocol import dogstatsd as dsd
from veneur_tpu_torch.protocol.gen import dogstatsd_grpc_pb2, health_pb2
from veneur_tpu_torch.sinks.simple import CaptureSink
from tests.torch_fixtures import unsampled_span_uniqueness  # noqa: F401


PCTS = (0.5, 0.9, 0.99)
AGGS = ("min", "max", "count", "sum", "avg", "median", "hmean")
QS = np.array([0.1, 0.5, 0.9, 0.99], np.float32)
_SIZES = dict(counter_rows=64, gauge_rows=64, histo_rows=64, set_rows=8)
FIXTURE = os.path.join(os.path.dirname(__file__), "testdata",
                       "forward_fixture.b64")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same_flush(tm, jm):
    t = {(m.name, m.tags): m for m in tm}
    j = {(m.name, m.tags): m for m in jm}
    assert len(t) == len(tm) and len(j) == len(jm), "duplicate keys"
    assert set(t) == set(j)
    for key, jv in j.items():
        tv = t[key]
        assert tv.type == jv.type, key
        if key[0].endswith(("percentile", ".median")):
            np.testing.assert_allclose(tv.value, jv.value, rtol=2e-3,
                                       atol=1e-3, err_msg=str(key))
        elif key[0].endswith((".sum", ".avg", ".hmean")):
            np.testing.assert_allclose(tv.value, jv.value, rtol=1e-6,
                                       err_msg=str(key))
        else:  # counters, gauges, count/min/max, set estimates
            assert tv.value == jv.value, (key, tv.value, jv.value)


def _flush(table, is_jax=False):
    kw = dict(percentiles=PCTS, aggregates=AGGS, hostname="h")
    if is_jax:
        return JFlusher(is_local=False, **kw).flush(table.swap(), now=1)
    return Flusher(**kw, device="cpu").flush(table.swap(), now=1)


def _local_rows(rng, prefix="t", n_timer=12):
    """One port local's forward rows: global-only counters and gauges,
    mixed- and global-scope timers (tagged), a histogram, sets."""
    lines = [b"req:3|c|#veneurglobalonly", b"req:2|c|#veneurglobalonly,e:b",
             b"depth:4|g|#veneurglobalonly", b"depth:9|g|#veneurglobalonly",
             b"gh:2.5|h|#veneurglobalonly", b"gh:7|h|#veneurglobalonly"]
    for i in range(n_timer):
        tags = b"|#k:v" if i % 2 else b""
        lines += [b"%s%d:%.3f|ms%s" % (prefix.encode(), i, v, tags)
                  for v in rng.gamma(2.0, 30.0, 50)]
    for i in range(3):
        lines += [b"users%d:u%d|s" % (i, j)
                  for j in rng.integers(0, 400, 120)]
    lines = [lines[i] for i in rng.permutation(len(lines))]
    t = MetricTable(TableConfig(**_SIZES), device="cpu")
    t.ingest_buffer(b"\n".join(lines))
    return Flusher(is_local=True, percentiles=PCTS, aggregates=AGGS,
                   device="cpu").flush(t.swap(), now=1).forward


def _wires(n=3, seed=0) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [gf.rows_to_metric_list(_local_rows(rng)).SerializeToString()
            for _ in range(n)]


def _riders() -> bytes:
    """Malformed items in one wire: a NaN gauge, non-finite centroids,
    a bad HLL sketch, an empty value oneof, and a histogram overwritten
    by a later counter field (its centroids orphaned in the columns)."""
    ms = []
    m = metric_pb2.Metric(name="bad.nan", type=metric_pb2.Gauge)
    m.gauge.value = float("nan")
    ms.append(m)
    m = metric_pb2.Metric(name="bad.cent", type=metric_pb2.Histogram)
    c = m.histogram.t_digest.main_centroids.add()
    c.mean, c.weight = float("inf"), 1.0
    ms.append(m)
    m = metric_pb2.Metric(name="bad.hll", type=metric_pb2.Set)
    m.set.hyper_log_log = b"\x01\x02"
    ms.append(m)
    ms.append(metric_pb2.Metric(name="bad.empty", type=metric_pb2.Counter))
    h = metric_pb2.Metric(name="orph", type=metric_pb2.Histogram)
    d = h.histogram.t_digest
    d.min, d.max, d.reciprocalSum = 1.0, 9.0, 0.5
    for v in (1.0, 5.0, 9.0):
        c = d.main_centroids.add()
        c.mean, c.weight = v, 2.0
    # field 5 (counter {value = 4}) after the histogram: last one wins
    orphan = h.SerializeToString() + b"\x2a\x02\x08\x04"
    body = forward_pb2.MetricList(metrics=ms).SerializeToString()
    return body + b"\x0a" + bytes([len(orphan)]) + orphan


def _wire(names_vals, mtype=dsd.COUNTER, sizes=None):
    """A MetricList of scalar series through the real encoder: a port
    local's flush of the samples."""
    src = MetricTable(TableConfig(**(sizes or _SIZES)), device="cpu")
    for name, v in names_vals:
        src.ingest(dsd.Sample(name=name, type=mtype, value=v,
                              scope=dsd.SCOPE_GLOBAL))
    res = Flusher(is_local=True, device="cpu").flush(src.swap(), now=1)
    return gf.rows_to_metric_list(res.forward).SerializeToString()


def _values(table) -> dict:
    return {m.name: m.value for m in _flush(table).metrics}


# ---- codec and decode ---------------------------------------------------

@pytest.mark.parametrize("compression", [100.0, 37.5])
def test_rows_to_metric_list_byte_identical(compression):
    """The same ForwardRows serialize to the same bytes in both
    packages."""
    rows = _local_rows(np.random.default_rng(3))
    assert {r.kind for r in rows} == {"counter", "gauge", "histo", "set"}
    t = gf.rows_to_metric_list(rows, compression).SerializeToString()
    j = jgf.rows_to_metric_list(rows, compression).SerializeToString()
    assert t == j
    assert forward_pb2.MetricList is jgf.forward_pb2.MetricList


@pytest.mark.parametrize("which", ["fleet", "riders", "empty"])
def test_decode_metric_list_matches_jax(which):
    """The lock-free decode: every column of every item and the identity
    hashes bit-equal to the JAX package's."""
    data = {"fleet": _wires(1)[0], "riders": _riders(), "empty": b""}[which]
    t, j = gf.decode_metric_list(data), jgf.decode_metric_list(data)
    n = t["n"]
    assert n == j["n"] == len(forward_pb2.MetricList.FromString(
        data).metrics)
    for k in ("name_off", "name_len", "kind", "mtype", "scope", "scalar",
              "dstats", "cent_start", "cent_cnt", "tag_start", "tag_cnt",
              "hll_off", "hll_len"):
        np.testing.assert_array_equal(t[k][:n], j[k][:n], err_msg=k)
    nc = int((t["cent_start"][:n] + t["cent_cnt"][:n]).max(initial=0))
    for k in ("means", "weights"):
        np.testing.assert_array_equal(t[k][:nc], j[k][:nc], err_msg=k)
    nt = int((t["tag_start"][:n] + t["tag_cnt"][:n]).max(initial=0))
    for k in ("tag_off", "tag_len"):
        np.testing.assert_array_equal(t[k][:nt], j[k][:nt], err_msg=k)
    np.testing.assert_array_equal(t["khash"], j.get(
        "khash", np.empty(0, np.uint64)))
    assert gf.decode_metric_list(b"\xff\xff\xff\x01garbage") is None


def test_metadata_decoders_fail_open():
    md = [(gf.TRACE_ID_KEY, "12"), (gf.SPAN_ID_KEY, "34"),
          (gf.DRAIN_KEY, "1"), (gf.RECOVERY_KEY, "bad"),
          (gf.HANDOFF_KEY, "0"), (gf.REPLAY_KEY, "1")]
    got = gf.decode_metadata(md)
    assert got == {"trace": (12, 34), "drain": True, "replay": True,
                   "recovery": "", "handoff": False}
    assert got["trace"] == jgf.decode_trace_metadata(md)
    assert gf.decode_recovery_metadata([(gf.RECOVERY_KEY, "3:7")]) == "3:7"
    assert gf.decode_metadata(None)["trace"] == (0, 0)
    assert gf.decode_trace_metadata([(gf.TRACE_ID_KEY, "x")]) == (0, 0)
    for key in ("TRACE_ID_KEY", "SPAN_ID_KEY", "DRAIN_KEY", "REPLAY_KEY",
                "RECOVERY_KEY", "HANDOFF_KEY"):
        assert getattr(gf, key) == getattr(jgf, key)


# ---- apply against the JAX table --------------------------------------------

@pytest.mark.parametrize("path", ["bytes", "protobuf"])
def test_apply_metric_list_matches_jax(path):
    """Three wires plus a wire of malformed riders into a JAX global and
    a port global by the same path: the same (accepted, dropped) per
    wire and the same flush, registers bit-equal.  The port's bytes
    path also equals its per-item protobuf oracle: stat rows and planes
    to rtol 1e-6, counters, gauges and registers bit-equal (the
    counterpart of tests/test_grpc_forward.py's native-vs-protobuf
    pin)."""
    wires = _wires(3, seed=1) + [_riders()]

    def run(pkg, table, kind):
        for w in wires:
            if kind == "bytes":
                yield pkg.apply_metric_list_bytes(table, w)
            else:
                yield pkg.apply_metric_list(
                    table, forward_pb2.MetricList.FromString(w))

    jt, tt = JTable(JConfig(**_SIZES)), MetricTable(TableConfig(**_SIZES),
                                                    device="cpu")
    got = list(run(gf, tt, path))
    assert got == list(run(jgf, jt, path))
    assert got[-1] == (1, 4)  # the orphan merges as a counter
    jr, tr = _flush(jt, True), _flush(tt)
    assert len(tr.metrics) > 50
    _assert_same_flush(tr.metrics, jr.metrics)
    assert {m.name: m.value for m in tr.metrics}["orph"] == 4.0

    a = MetricTable(TableConfig(**_SIZES), device="cpu")
    b = MetricTable(TableConfig(**_SIZES), device="cpu")
    assert list(run(gf, a, "bytes")) == list(run(gf, b, "protobuf"))
    sa, sb = a.swap(), b.swap()
    for k in ("histo_import_stats", "histo_means", "histo_weights"):
        np.testing.assert_allclose(_np(getattr(sa, k)),
                                   _np(getattr(sb, k)), rtol=1e-6,
                                   err_msg=k)
    for k in ("counters", "gauges", "hll_regs"):
        assert torch.equal(getattr(sa, k), getattr(sb, k)), k
    jt2 = JTable(JConfig(**_SIZES))
    list(run(jgf, jt2, "bytes"))
    js = jt2.swap()
    np.testing.assert_array_equal(_np(sa.hll_regs), js.set_registers())
    np.testing.assert_array_equal(_np(sa.counters), np.asarray(js.counters))
    np.testing.assert_allclose(_np(sa.histo_import_stats),
                               np.asarray(js.histo_import_stats),
                               rtol=1e-6)
    np.testing.assert_allclose(_np(sa.histo_weights).sum(1),
                               np.asarray(js.histo_weights).sum(1),
                               rtol=1e-6)
    qt = _np(tdigest.quantile(sa.histo_means, sa.histo_weights,
                              torch.from_numpy(QS)))
    qj = np.asarray(jtd.quantile(js.histo_means, js.histo_weights,
                                 jnp.asarray(QS)))
    np.testing.assert_allclose(qt, qj, rtol=2e-3, atol=1e-3,
                               equal_nan=True)


def test_orphaned_centroids_stay_out_of_sums():
    """A histogram between two orphans: its stat row sums only its own
    centroids (paired reduceat segments), as the protobuf path does."""
    h = metric_pb2.Metric(name="h", type=metric_pb2.Histogram)
    d = h.histogram.t_digest
    d.min, d.max, d.reciprocalSum = 2.0, 3.0, 0.8
    for v in (2.0, 3.0):
        c = d.main_centroids.add()
        c.mean, c.weight = v, 1.0
    orph = metric_pb2.Metric(name="o", type=metric_pb2.Histogram)
    for v in (100.0, 200.0):
        c = orph.histogram.t_digest.main_centroids.add()
        c.mean, c.weight = v, 5.0
    ob = orph.SerializeToString() + b"\x2a\x02\x08\x01"
    rec = b"\x0a" + bytes([len(ob)]) + ob
    hb = forward_pb2.MetricList(metrics=[h]).SerializeToString()
    wire = rec + hb + rec
    stats = []
    for apply in (gf.apply_metric_list_bytes,
                  lambda t, w: gf.apply_metric_list(
                      t, forward_pb2.MetricList.FromString(w))):
        t = MetricTable(TableConfig(**_SIZES), device="cpu")
        assert apply(t, wire) == (3, 0)
        row = t.histo_idx.rows[("h", dsd.HISTOGRAM, (), dsd.SCOPE_DEFAULT)]
        stats.append(_np(t.swap().histo_import_stats)[row])
    np.testing.assert_array_equal(stats[0], stats[1])
    assert stats[0][0] == 2.0 and stats[0][3] == 5.0


def test_wire_fixture_through_the_port():
    """The frozen Go-side MetricList (tests/testdata/forward_fixture.b64)
    through both port paths: what tests/test_grpc_forward.py's fixture
    test asserts, and the JAX flush."""
    wire = base64.b64decode(open(FIXTURE, "rb").read())
    assert len(forward_pb2.MetricList.FromString(wire).metrics) == 4
    sizes = dict(histo_rows=8, set_rows=8)
    outs = []
    for apply in (gf.apply_metric_list_bytes,
                  lambda t, w: gf.apply_metric_list(
                      t, forward_pb2.MetricList.FromString(w))):
        t = MetricTable(TableConfig(**sizes), device="cpu")
        assert apply(t, wire) == (4, 0)
        outs.append(Flusher(percentiles=(0.5,), aggregates=("count",),
                            device="cpu").flush(t.swap(), now=1).metrics)
    jt = JTable(JConfig(**sizes))
    jgf.apply_metric_list_bytes(jt, wire)
    jm = JFlusher(is_local=False, percentiles=(0.5,),
                  aggregates=("count",)).flush(jt.swap(), now=1).metrics
    for metrics in outs:
        _assert_same_flush(metrics, jm)
        m = {x.name: x.value for x in metrics}
        assert m["fix.total"] == 7.0 and m["fix.depth"] == 3.5
        assert "fix.lat.count" not in m
        assert m["fix.lat.50percentile"] == pytest.approx(52.87, rel=0.05)
        assert m["fix.users"] == pytest.approx(250, rel=0.05)


def test_garbage_wire_raises_and_table_stays_usable():
    t = MetricTable(TableConfig(**_SIZES), device="cpu")
    from google.protobuf.message import DecodeError
    with pytest.raises(DecodeError):
        gf.apply_metric_list_bytes(t, b"\xff\xff\xff\x01garbage")
    assert t.import_counter("c", (), 1.0)


# ---- the row and wire-plan caches (tests/test_import_cache.py) -------------

def test_cache_hits_accumulate_like_slow_path():
    wire = _wire([("c.a", 2.0), ("c.b", 5.0)])
    t = MetricTable(TableConfig(**_SIZES), device="cpu")
    jt = JTable(JConfig(**_SIZES))
    for _ in range(3):
        assert gf.apply_metric_list_bytes(t, wire) == (2, 0)
        assert jgf.apply_metric_list_bytes(jt, wire) == (2, 0)
    assert len(t.import_row_cache) == 2
    assert (t.wire_plan_misses, t.wire_plan_hits) == (1, 2)
    vals = _values(t)
    assert (vals["c.a"], vals["c.b"]) == (6.0, 15.0)
    jv = {m.name: m.value for m in _flush(jt, True).metrics}
    assert {k: vals[k] for k in jv} == jv


def test_cache_cleared_on_compaction_and_rows_remap():
    """Compaction renumbers rows: the swap clears the row cache and the
    plans, and the next wire re-resolves."""
    t = MetricTable(TableConfig(counter_rows=8, compact_threshold=0.5,
                                gauge_rows=8, histo_rows=8, set_rows=8),
                    device="cpu")
    gf.apply_metric_list_bytes(t, _wire([(f"churn.{i}", 1.0)
                                         for i in range(5)]))
    t.swap()
    wire_b = _wire([("keep.x", 7.0)])
    gf.apply_metric_list_bytes(t, wire_b)
    t.swap()  # occupancy 6/8 > 0.5: compacts, clears the caches
    assert len(t.import_row_cache) == 0 and not t._wire_plan_cache
    gf.apply_metric_list_bytes(t, wire_b)
    vals = {k: v for k, v in _values(t).items()
            if k.startswith(("keep.", "churn."))}
    assert vals == {"keep.x": 7.0}


def test_cache_size_bound_clears_and_rebuilds():
    t = MetricTable(TableConfig(**_SIZES), device="cpu")
    t.import_row_cache_limit = 4
    for i in range(4):
        gf.apply_metric_list_bytes(t, _wire([(f"s.{i}", 1.0)]))
    assert len(t.import_row_cache) == 4
    gf.apply_metric_list_bytes(t, _wire([("s.new", 1.0)]))
    assert len(t.import_row_cache) == 1


def test_gauge_validity_not_cached():
    """A NaN gauge drops for its wire only; the same series with a
    finite value in the next wire lands."""
    t = MetricTable(TableConfig(**_SIZES), device="cpu")
    bad = _wire([("g.x", float("nan"))], mtype=dsd.GAUGE)
    good = _wire([("g.x", 3.25)], mtype=dsd.GAUGE)
    assert gf.apply_metric_list_bytes(t, bad) == (0, 1)
    assert gf.apply_metric_list_bytes(t, good) == (1, 0)
    assert _values(t)["g.x"] == 3.25


def test_gauge_last_write_wins_within_wire_via_cache():
    t = MetricTable(TableConfig(**_SIZES), device="cpu")
    ml = forward_pb2.MetricList()
    for v in (1.0, 2.0, 9.0):
        m = ml.metrics.add()
        m.name, m.type = "g.dup", metric_pb2.Gauge
        m.gauge.value = v
    wire = ml.SerializeToString()
    for _ in range(2):  # the miss, then the plan
        gf.apply_metric_list_bytes(t, wire)
        assert _values(t)["g.dup"] == 9.0
    assert t.wire_plan_hits == 1


def test_cached_overflow_drops_keep_counting():
    """An identity cached as overflow (-1) counts one drop per sample on
    every wire that carries it, as the uncached path does."""
    wire = _wire([(f"ov.{i}", 1.0) for i in range(4)])
    for t, pkg in ((MetricTable(TableConfig(counter_rows=2, histo_rows=8),
                                device="cpu"), gf),
                   (JTable(JConfig(counter_rows=2, histo_rows=8)), jgf)):
        assert pkg.apply_metric_list_bytes(t, wire) == (2, 2)
        assert t.counter_idx.overflow == 2
        assert pkg.apply_metric_list_bytes(t, wire) == (2, 2)
        assert t.counter_idx.overflow == 4
        assert t.overflow_total() == 4
        t.import_row_cache_limit = 0  # clears the row cache; plans stay
        t._wire_plan_cache.clear()
        assert pkg.apply_metric_list_bytes(t, wire) == (2, 2)
        assert t.counter_idx.overflow == 6


def test_malformed_drops_do_not_count_as_overflow():
    """Cache sentinel -2 (empty value oneof) is a drop, never overflow."""
    ml = forward_pb2.MetricList()
    m = ml.metrics.add()
    m.name, m.type = "no.value.oneof", metric_pb2.Counter
    wire = ml.SerializeToString()
    t = MetricTable(TableConfig(**_SIZES), device="cpu")
    for _ in range(3):
        assert gf.apply_metric_list_bytes(t, wire) == (0, 1)
    assert t.counter_idx.overflow == 0 and t.overflow_total() == 0
    assert list(t.import_row_cache.values()) == [-2]


def test_name_length_mismatch_reresolves():
    """Collision guard: an entry whose name length disagrees with the
    wire (a 64-bit hash collision) resolves through the slow path
    instead of merging two series."""
    wire = _wire([("cg.abc", 3.0)])
    t = MetricTable(TableConfig(**_SIZES), device="cpu")
    gf.apply_metric_list_bytes(t, wire)
    (h, ent), = t.import_row_cache.items()
    row = ent & 0xFFFFFFFF
    t.import_row_cache[h] = (999 << 32) | row
    # a repeated wire replays its plan and never reads the entry: drop
    # the plan so the identity arrives as in another wire
    t._wire_plan_cache.clear()
    assert gf.apply_metric_list_bytes(t, wire) == (1, 0)
    assert t.import_row_cache[h] == ent
    assert float(t.swap().counters[row]) == 6.0


# ---- decode scratch --------------------------------------------------------

def test_decode_scratch_cap_and_shrink(monkeypatch):
    """The per-thread scratch shows in decode_scratch_bytes, is not kept
    above _SCRATCH_MAX_BYTES, and high-water buffers are released after
    _SCRATCH_SHRINK_AFTER consecutive small decodes (the counterpart of
    tests/test_grpc_forward.py's scratch test)."""
    from veneur_tpu_torch import native
    from veneur_tpu_torch.core.flusher import ForwardRow
    from veneur_tpu_torch.core.table import RowMeta
    lib = native.load()

    def wire(n_rows):
        rows = [ForwardRow(RowMeta(f"scratch.cnt.{i:07d}", (),
                                   dsd.SCOPE_GLOBAL, dsd.COUNTER),
                           "counter", value=float(i))
                for i in range(n_rows)]
        return gf.rows_to_metric_list(rows).SerializeToString()

    small, big = wire(2), wire(2600)
    assert len(big) // 48 > 4 * max(256, len(small) // 48)
    tid = threading.get_ident()

    def mine():
        with gf._scratch_lock:
            return gf._scratch_bytes.get(tid, 0)

    saved_cols = getattr(gf._decode_scratch, "cols", None)
    saved_streak = getattr(gf._decode_scratch, "oversized_streak", 0)
    with gf._scratch_lock:
        saved_bytes = gf._scratch_bytes.pop(tid, None)
    gf._decode_scratch.cols = None
    gf._decode_scratch.oversized_streak = 0
    try:
        monkeypatch.setattr(gf, "_SCRATCH_MAX_BYTES", 1024)
        assert gf._decode_native(lib, small)["n"] == 2
        assert gf._decode_scratch.cols is None and mine() == 0
        monkeypatch.setattr(gf, "_SCRATCH_MAX_BYTES", 32 << 20)
        assert gf._decode_native(lib, small)["n"] == 2
        small_bytes = mine()
        assert small_bytes == gf._cols_nbytes(gf._decode_scratch.cols) > 0
        assert gf._decode_native(lib, big)["n"] == 2600
        big_bytes = mine()
        assert big_bytes > small_bytes
        for _ in range(gf._SCRATCH_SHRINK_AFTER - 1):
            assert gf._decode_native(lib, small)["n"] == 2
        assert mine() == big_bytes
        assert gf._decode_native(lib, small)["n"] == 2
        assert mine() == small_bytes
        assert gf.decode_scratch_bytes() >= mine()
    finally:
        gf._decode_scratch.cols = saved_cols
        gf._decode_scratch.oversized_streak = saved_streak
        with gf._scratch_lock:
            if saved_bytes is None:
                gf._scratch_bytes.pop(tid, None)
            else:
                gf._scratch_bytes[tid] = saved_bytes


# ---- the import server -------------------------------------------------------

_SRV = {"tpu_counter_rows": 64, "tpu_gauge_rows": 64, "tpu_histo_rows": 64,
        "tpu_set_rows": 8, "interval": "60s", "hostname": "h",
        "percentiles": [0.5, 0.99]}


@pytest.fixture
def grpc_global():
    cap = CaptureSink()
    srv = Server(read_config(data=dict(
        _SRV, grpc_listen_addresses=["tcp://127.0.0.1:0"],
        http_address="127.0.0.1:0")), device="cpu", extra_sinks=[cap])
    srv.start()
    chan = grpc.insecure_channel(f"127.0.0.1:{srv.grpc_ports[0]}")
    try:
        yield srv, chan, cap
    finally:
        chan.close()
        srv.shutdown()
    assert not any(t.is_alive() for t in srv._threads)


def _send_metrics(srv, body: bytes, metadata=None):
    client = gf.ForwardClient(f"127.0.0.1:{srv.grpc_ports[0]}")
    try:
        client.send_wire(body, metadata=metadata)
    finally:
        client.close()


def test_import_server_services(grpc_global):
    """One listener: SendMetrics (the Go-side fixture wire), SendPacket
    (multi-line DogStatsD), Health; SendSpan takes a span (an empty one
    is counted received and dropped by the span worker); a
    garbage body gets INVALID_ARGUMENT and is counted, and the server
    keeps importing; flagged metadata is counted; /debug/vars carries
    the decode scratch."""
    srv, chan, cap = grpc_global
    assert srv.bound_ports() == srv.grpc_ports
    check = chan.unary_unary(
        "/grpc.health.v1.Health/Check",
        request_serializer=health_pb2.HealthCheckRequest.SerializeToString,
        response_deserializer=health_pb2.HealthCheckResponse.FromString)
    for svc, want in (("", "SERVING"), ("veneur", "SERVING"),
                      ("nope", "SERVICE_UNKNOWN")):
        resp = check(health_pb2.HealthCheckRequest(service=svc), timeout=5)
        assert resp.status == getattr(health_pb2.HealthCheckResponse, want)
    send_packet = chan.unary_unary(
        "/dogstatsd.DogstatsdGRPC/SendPacket",
        request_serializer=dogstatsd_grpc_pb2.DogstatsdPacket
        .SerializeToString,
        response_deserializer=dogstatsd_grpc_pb2.Empty.FromString)
    send_packet(dogstatsd_grpc_pb2.DogstatsdPacket(
        packetBytes=b"grpc.hits:3|c\ngrpc.hits:4|c\ngrpc.g:2|g"), timeout=5)
    span = chan.unary_unary("/ssf.SSFGRPC/SendSpan",
                            request_serializer=lambda b: b,
                            response_deserializer=lambda b: b)
    assert span(b"", timeout=5) == b""
    deadline = time.monotonic() + 10.0
    while srv.stats.get("empty_ssf", 0) < 1:
        assert time.monotonic() < deadline, "the span worker's verdict"
        time.sleep(0.01)
    assert srv.stats["received_ssf-grpc"] == 1
    with pytest.raises(grpc.RpcError) as e:
        _send_metrics(srv, b"\xff\xff\xff\x01garbage")
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    assert srv.stats["import_errors"] == 1
    wire = base64.b64decode(open(FIXTURE, "rb").read())
    _send_metrics(srv, wire, metadata=[(gf.DRAIN_KEY, "1")])
    _send_metrics(srv, _riders())
    with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.http_port}/debug/vars",
            timeout=10) as r:
        vars_ = json.loads(r.read())
    assert vars_["forward"]["decode_scratch_bytes"] > 0
    stats = vars_["stats"]
    assert stats["received_dogstatsd-grpc"] == 1
    assert stats["imports_received"] == 5 and stats["received_grpc"] == 9
    assert stats["metrics_dropped"] == 4
    assert stats["import_flagged_wires"] == 1
    assert stats["metrics_processed"] == 3
    srv.flush_once()
    vals = {m.name: m.value for m in cap.metrics}
    assert vals["grpc.hits"] == 7.0 and vals["grpc.g"] == 2.0
    assert vals["fix.total"] == 7.0 and vals["fix.depth"] == 3.5
    assert vals["fix.users"] == pytest.approx(250, rel=0.05)
    assert vals["orph"] == 4.0


def test_import_server_concurrent_senders(grpc_global):
    """Eight senders on the server's eight workers, each sending the
    same counter wire many times: every increment lands (no lost
    update between the lock-free decode and the locked apply)."""
    srv, chan, cap = grpc_global
    wire = _wire([(f"cc.{i}", float(i + 1)) for i in range(20)])
    n_threads, per = 8, 12
    errors = []

    def sender():
        try:
            for _ in range(per):
                _send_metrics(srv, wire)
        except grpc.RpcError as e:  # pragma: no cover - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=sender) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    assert srv.stats["imports_received"] == 20 * n_threads * per
    srv.flush_once()
    vals = {m.name: m.value for m in cap.metrics}
    assert {f"cc.{i}": vals[f"cc.{i}"] for i in range(20)} == {
        f"cc.{i}": float((i + 1) * n_threads * per) for i in range(20)}


def test_local_global_chain_over_grpc():
    """A port local (UDP in, ``forward_use_grpc``) forwards to a port
    global's gRPC listener: the global flushes the percentile the JAX
    chain flushes for ``lat:{0..199}|ms``."""
    gcap = CaptureSink()
    glob = Server(read_config(data=dict(
        _SRV, grpc_address="127.0.0.1:0")), device="cpu",
        extra_sinks=[gcap])
    glob.start()
    local = None
    try:
        lcap = CaptureSink()
        local = Server(read_config(data=dict(
            _SRV, statsd_listen_addresses=["udp://127.0.0.1:0"],
            forward_address=f"127.0.0.1:{glob.grpc_ports[0]}",
            forward_use_grpc=True)), device="cpu", extra_sinks=[lcap])
        local.start()
        msgs = [f"lat:{v}|ms".encode() for v in range(200)]
        msgs += [b"hits:2|c|#veneurglobalonly", b"uniq:a|s", b"uniq:b|s"]
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.sendto(b"\n".join(msgs), ("127.0.0.1", local.bound_ports()[0]))
        s.close()
        deadline = time.monotonic() + 20
        while local.stats["metrics_processed"] < len(msgs):
            assert time.monotonic() < deadline, "the local's ingest"
            time.sleep(0.02)
        local.flush_once()
        assert local.stats["forwarded_rows"] == 3
        assert local.stats["forward_errors"] == 0
        lv = {m.name: m.value for m in lcap.metrics}
        assert lv["lat.count"] == 200.0 and "lat.99percentile" not in lv
        glob.flush_once()
    finally:
        if local is not None:
            local.shutdown()
        glob.shutdown()
    gv = {m.name: m.value for m in gcap.metrics}
    assert repr(gv["lat.99percentile"]) == "197.00999450683594"
    assert gv["hits"] == 2.0 and gv["uniq"] == 2.0
    assert glob.stats["imports_received"] == 3
    assert glob.stats["received_grpc"] == 3


def test_grpc_forward_failure_is_counted():
    """A send to a port nobody listens on is dropped and counted, never
    retried, and the flush completes."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    srv = Server(read_config(data=dict(
        _SRV, forward_address=f"127.0.0.1:{dead}",
        forward_use_grpc=True)), device="cpu")
    srv.table.ingest_buffer(b"lat:1|ms\nlat:2|ms\nx:1|c|#veneurglobalonly")
    srv.flush_once()
    assert srv.stats["forward_errors"] == 1
    assert srv.stats["metrics_dropped"] == 2
    assert srv.stats["flushes"] == 1
    srv.shutdown()
    assert srv._grpc_client is None


# ---- config ----------------------------------------------------------------

def test_config_grpc_keys():
    assert read_config(data={}).grpc_listen_addresses == []
    cfg = read_config(data={"grpc_address": "127.0.0.1:8128"})
    assert cfg.grpc_listen_addresses == ["tcp://127.0.0.1:8128"]
    cfg = read_config(data={"grpc_address": "127.0.0.1:1",
                            "grpc_listen_addresses": ["tcp://[::1]:2"]})
    assert cfg.grpc_listen_addresses == ["tcp://[::1]:2"]
    cfg = read_config(data={"forward_use_grpc": True,
                            "forward_address": "127.0.0.1:8128"})
    assert cfg.forward_use_grpc and cfg.is_local()
    with pytest.raises(ValueError, match="grpc listener must be tcp"):
        read_config(data={"grpc_listen_addresses": ["udp://127.0.0.1:1"]})


@pytest.mark.parametrize("key,value", [
    ("forward_grpc_tls", True), ("forward_grpc_tls_ca", "ca.pem"),
    ("tls_key", "k.pem"), ("tls_certificate", "c.pem"),
    ("tls_authority_certificate", "ca.pem")])
def test_config_tls_keys_as_jax(key, value):
    """The TLS keys read as the reference reads them, in ``Config`` and
    from ``VENEUR_<KEY>``; the two forward keys on ``ProxyConfig`` too.
    Neither package validates them at read time (a pair that cannot
    load fails the server's start: tests/test_torch_tls.py)."""
    from veneur_tpu.core.config import ProxyConfig as JProxyConfig
    from veneur_tpu.core.config import read_config as jread_config
    from veneur_tpu_torch.core.config import ProxyConfig
    got = getattr(read_config(data={key: value}, env={}), key)
    assert got == value == getattr(
        jread_config(data={key: value}, env={}), key)
    env = {"VENEUR_" + key.upper(): str(value)}
    assert getattr(read_config(data={}, env=env), key) == getattr(
        jread_config(data={}, env=env), key)
    if key.startswith("forward_"):
        data = {key: value, "forward_address": "127.0.0.1:1"}
        assert getattr(read_config(data=data, env={}, cls=ProxyConfig),
                       key) == getattr(jread_config(
                           data=data, env={}, cls=JProxyConfig), key)
