"""The port's columnar emit (``core/frame.py`` + ``Flusher(columnar=
True)``) against its per-row emit and against the JAX package's frame.

Ports the cases of ``tests/test_columnar_emit.py:97-235`` whose knobs
the port has (no common tags, percentile naming or reference
interpolation): the frame's materialized list is bit-identical to the
per-row emit on the same snapshot (names, values, tags, types,
hostnames, order-insensitive; forward rows and tallies exactly equal),
to the JAX frame on the same snapshot and readout (the JAX interval
carried over by ``convert``), and ``route`` of a frame equals ``route``
of its list.

Tolerances: every comparison is exact but one: with each package's own
readout, percentiles agree to rtol 2e-3 / atol 1e-3, the reference's
merge tolerance (their f32 cumulative sums round differently).
"""

from __future__ import annotations

import numpy as np
import pytest

from veneur_tpu.core.flusher import Flusher as JFlusher
from veneur_tpu.core.table import MetricTable as JTable
from veneur_tpu.core.table import TableConfig as JConfig
from veneur_tpu_torch import convert
from veneur_tpu_torch.core.flusher import Flusher
from veneur_tpu_torch.core.frame import MetricFrame
from veneur_tpu_torch.core.metrics import InterMetric
from veneur_tpu_torch.core.table import MetricTable, TableConfig
from veneur_tpu_torch.protocol import dogstatsd as dsd
from veneur_tpu_torch.sinks import base as sinks_base

ALL_AGGS = ("max", "min", "sum", "avg", "count", "hmean", "median")
_SIZES = dict(counter_rows=64, gauge_rows=64, histo_rows=64, set_rows=16)


def _mixed_lines():
    """Counters, gauges, histograms and sets in all three scopes,
    tagged and untagged, a zero-sum histogram and a sink-only row."""
    lines = [
        b"hits:3|c", b"hits:2|c|@0.5", b"api:1|c|#route:a,env:prod",
        b"g.hits:7|c|#veneurglobalonly", b"l.hits:4|c|#veneurlocalonly",
        b"temp:9|g", b"temp:4|g|#room:b",
        b"g.temp:2|g|#veneurglobalonly", b"l.temp:8|g|#veneurlocalonly",
        b"users:a|s", b"users:b|s", b"users:c|s|#tier:x",
        b"g.users:a|s|#veneurglobalonly", b"l.users:z|s|#veneurlocalonly",
        b"only.dd:5|c|#veneursinkonly:datadog",
        b"zs:-5|ms", b"zs:5|ms",
    ]
    rng = np.random.default_rng(3)
    for v in rng.uniform(0, 100, 400):
        lines.append(f"lat:{v}|ms".encode())
        lines.append(f"lat:{v / 2}|ms|#route:a".encode())
    for v in rng.uniform(1, 50, 200):
        lines.append(f"g.lat:{v}|ms|#veneurglobalonly".encode())
        lines.append(f"l.lat:{v}|ms|#veneurlocalonly".encode())
    return lines


def _mixed_snapshot():
    t = MetricTable(TableConfig(**_SIZES), device="cpu")
    for ln in _mixed_lines():
        t.ingest(dsd.parse_metric(ln))
    return t.swap()


def _metric_key(m):
    return (m.name, m.timestamp, m.value, m.tags, m.type, m.hostname)


def _fwd_key(f):
    return (f.kind, f.meta.name, f.meta.tags, f.meta.scope)


def _flush_pair(snap, **kw):
    """The same snapshot through the per-row emit and the frame (a
    flush does not change the snapshot)."""
    legacy = Flusher(columnar=False, device="cpu", **kw).flush(snap,
                                                               now=1234)
    col = Flusher(columnar=True, device="cpu", **kw).flush(snap, now=1234)
    return legacy, col


def _assert_parity(legacy, col):
    assert (sorted(_metric_key(m) for m in legacy.metrics) ==
            sorted(_metric_key(m) for m in col.metrics))
    assert len(legacy.forward) == len(col.forward)
    for a, b in zip(sorted(legacy.forward, key=_fwd_key),
                    sorted(col.forward, key=_fwd_key)):
        assert _fwd_key(a) == _fwd_key(b)
        assert a.value == b.value
        for attr in ("stats", "means", "weights", "regs"):
            av, bv = getattr(a, attr), getattr(b, attr)
            assert (av is None) == (bv is None)
            if av is not None:
                np.testing.assert_array_equal(av, bv)
    assert legacy.tally == col.tally


@pytest.mark.parametrize("is_local", [False, True])
def test_frame_parity_scopes_x_aggregates(is_local):
    legacy, col = _flush_pair(
        _mixed_snapshot(), is_local=is_local,
        percentiles=(0.5, 0.95, 0.999), aggregates=ALL_AGGS,
        hostname="parity-host")
    assert legacy.metrics, "the per-row emit flushed nothing"
    _assert_parity(legacy, col)


@pytest.mark.parametrize("aggregates", [(), ("count",),
                                        ("sum", "avg", "hmean")])
@pytest.mark.parametrize("is_local", [False, True])
def test_frame_parity_aggregate_subsets(aggregates, is_local):
    legacy, col = _flush_pair(_mixed_snapshot(), is_local=is_local,
                              percentiles=(0.99,), aggregates=aggregates)
    _assert_parity(legacy, col)


def test_frame_parity_no_percentiles():
    legacy, col = _flush_pair(_mixed_snapshot(), is_local=False,
                              percentiles=(), aggregates=("min", "max"))
    _assert_parity(legacy, col)


def test_retained_frame_matches_materialized_list():
    snap = _mixed_snapshot()
    fl = Flusher(is_local=True, aggregates=ALL_AGGS, percentiles=(0.5,),
                 hostname="h", device="cpu")
    res = fl.flush(snap, now=99, retain_frame=True)
    assert res.frame is not None and not res.metrics
    direct = fl.flush(snap, now=99)
    assert direct.frame is None
    assert (sorted(_metric_key(m) for m in res.all_metrics()) ==
            sorted(_metric_key(m) for m in direct.metrics))
    assert res.metric_count() == len(direct.metrics)


@pytest.mark.parametrize("is_local", [False, True])
def test_frame_matches_jax_frame_on_the_same_snapshot(monkeypatch,
                                                      is_local):
    """A JAX interval's planes and row metadata, carried into the port
    by ``convert``.  Given the port's readout, the JAX frame assembles
    the list the port's frame does, bit for bit, forward rows and
    tallies included; with its own readout, the JAX flush differs from
    the port's only in the percentiles' f32 readout rounding."""
    jt = JTable(JConfig(**_SIZES, host_set_plane_max_bytes=0))
    for ln in _mixed_lines():
        jt.ingest(dsd.parse_metric(ln))
    jsnap = jt.swap()
    state = {k: np.asarray(getattr(jsnap, k)) for k in convert.PLANES}
    for k in ("counter_meta", "gauge_meta", "histo_meta", "set_meta",
              "counter_touched", "gauge_touched", "histo_touched",
              "set_touched", "hll_host_plane", "hll_device_touched"):
        state[k] = getattr(jsnap, k)
    tsnap = convert.snapshot_from_numpy(state, device="cpu")
    kw = dict(is_local=is_local, percentiles=(0.5, 0.9, 0.99),
              aggregates=ALL_AGGS, hostname="h")
    tfl = Flusher(columnar=True, device="cpu", **kw)
    tres = tfl.flush(tsnap, now=5, retain_frame=True)
    own = JFlusher(columnar=True, **kw).flush(jsnap, now=5)
    pre = tfl._prefetch(tsnap)
    monkeypatch.setattr(JFlusher, "_prefetch", lambda *a, **k: dict(pre))
    jres = JFlusher(columnar=True, **kw).flush(jsnap, now=5,
                                               retain_frame=True)
    assert len(tres.frame.blocks) == len(jres.frame.blocks)
    assert (sorted(_metric_key(m) for m in tres.all_metrics()) ==
            sorted(_metric_key(m) for m in jres.all_metrics()))
    assert (sorted(_fwd_key(f) for f in tres.forward) ==
            sorted(_fwd_key(f) for f in jres.forward))
    assert tres.tally == {k: v for k, v in jres.tally.items()
                          if k in tres.tally}
    mine = {(m.name, m.tags): m.value for m in tres.all_metrics()}
    theirs = {(m.name, m.tags): m.value for m in own.metrics}
    assert mine.keys() == theirs.keys()
    for key, v in theirs.items():
        if key[0].endswith(("percentile", ".median")):
            np.testing.assert_allclose(mine[key], v, rtol=2e-3, atol=1e-3)
        else:
            assert mine[key] == v, key


@pytest.mark.parametrize("columnar", [False, True])
def test_zero_sum_histogram_still_emits_sum_and_avg(columnar):
    t = MetricTable(TableConfig(histo_rows=16), device="cpu")
    t.ingest(dsd.parse_metric(b"zs:-5|ms"))
    t.ingest(dsd.parse_metric(b"zs:5|ms"))
    res = Flusher(is_local=True, aggregates=("sum", "avg", "count"),
                  columnar=columnar, device="cpu").flush(t.swap())
    m = {x.name: x for x in res.metrics}
    assert m["zs.sum"].value == 0.0
    assert m["zs.avg"].value == 0.0
    assert m["zs.count"].value == 2.0


@pytest.mark.parametrize("columnar", [False, True])
def test_tally_slices_stale_touch_bits(columnar):
    """Touch bits past len(meta) do not inflate the tallies."""
    t = MetricTable(TableConfig(**_SIZES), device="cpu")
    for ln in (b"a:1|c", b"b:2|c", b"g:3|g", b"lat:4|ms", b"u:x|s"):
        t.ingest(dsd.parse_metric(ln))
    snap = t.swap()
    snap.counter_touched[len(snap.counter_meta) + 3] = True
    snap.gauge_touched[len(snap.gauge_meta) + 3] = True
    snap.histo_touched[len(snap.histo_meta) + 3] = True
    snap.set_touched[len(snap.set_meta) + 3] = True
    res = Flusher(is_local=False, columnar=columnar,
                  device="cpu").flush(snap)
    assert res.tally["counters"] == 2
    assert res.tally["gauges"] == 1
    assert res.tally["histograms"] == 1
    assert res.tally["sets"] == 1


def _frame_for(snap, **kw) -> MetricFrame:
    return Flusher(columnar=True, device="cpu", **kw).flush(
        snap, now=77, retain_frame=True).frame


def test_frame_route_matches_list_route():
    frame = _frame_for(_mixed_snapshot(), is_local=False,
                       aggregates=ALL_AGGS, percentiles=(0.5,))
    legacy = frame.materialize()

    class Sink(sinks_base.SinkBase):
        name = "datadog"
    sink = Sink()
    sink.set_excluded_tags(("env",))
    routed = frame.route(sink.name, sink)
    want = sinks_base.route(legacy, sink.name, sink)
    assert (sorted((m.name, m.value, m.tags) for m in routed.materialize())
            == sorted((m.name, m.value, m.tags) for m in want))
    # the whitelisted row reaches datadog and no other sink
    other = frame.route("signalfx", None)
    assert "only.dd" not in {m.name for m in other.materialize()}
    assert any(m.name == "only.dd" for m in routed.materialize())
    assert (sorted(_metric_key(m) for m in other.materialize()) ==
            sorted(_metric_key(m) for m in
                   sinks_base.route(legacy, "signalfx")))


def test_frame_route_no_filter_shares_self_and_materialization():
    t = MetricTable(TableConfig(counter_rows=16), device="cpu")
    t.ingest(dsd.parse_metric(b"a:1|c"))
    frame = _frame_for(t.swap(), is_local=False)
    assert frame.route("blackhole", None) is frame
    extra = [InterMetric(name="x", timestamp=1, value=1.0, tags=(),
                         type="gauge")]
    with_extra = frame.route("blackhole", None, extra=extra)
    assert with_extra is not frame
    assert with_extra.blocks is frame.blocks
    base = frame.materialize()
    assert with_extra.materialize()[:len(base)] == base  # shared cache
    assert with_extra.materialize()[-1].name == "x"


def test_sink_base_flush_frame_materializes_the_routed_frame():
    """A sink without a frame encoder gets ``flush`` of the routed
    frame's list (``SinkBase.flush_frame``)."""
    frame = _frame_for(_mixed_snapshot(), is_local=False,
                       aggregates=("count",), percentiles=())
    got = []

    class Sink(sinks_base.SinkBase):
        name = "plain"

        def flush(self, metrics):
            got.extend(metrics)
    sink = Sink()
    sink.flush_frame(frame.route(sink.name, sink))
    assert (sorted(_metric_key(m) for m in got) ==
            sorted(_metric_key(m) for m in
                   sinks_base.route(frame.materialize(), sink.name, sink)))
