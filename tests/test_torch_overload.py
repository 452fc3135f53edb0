"""The port's overload control against the reference's.

Port counterparts of every test in ``tests/test_overload_smoke.py``:
the same datagrams, pressure inputs and index operations go through a
port ``Server`` (on the CPU) or the port's ``Overload`` /
``PressureSignals`` / ``_ClassIndex`` and through the JAX package's, and
the outcomes must be equal: shed totals, the ledger's shed attribution
by tenant and reason, sealed records, flushed values, the pressure
state, the coalesce arm and the index rows.  Token buckets refill on
the wall clock, so the servers compared here run with the refill frozen
at the burst (each bucket holds exactly its burst): the two packages
then admit the same samples.  Also ``admit_columns`` on one seeded
batch (shed count, ``shed_by`` and every rewritten type code equal) and
the histogram width ladder at levels 0-3 (the effective width equal at
each level, and a level-3 flush equal to the JAX table's: order-free
values bit for bit, percentiles within rtol 2e-3 / atol 1e-3, the
tolerance of ``tests/test_pallas_merge.py``).  Exact equality
elsewhere: admission counts integers.
"""

from __future__ import annotations

import socket

import numpy as np
import pytest

from veneur_tpu.core import overload as joverload
from veneur_tpu.core.config import read_config as jread_config
from veneur_tpu.core.flusher import Flusher as JFlusher
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.core.table import MetricTable as JTable
from veneur_tpu.core.table import TableConfig as JTableConfig
from veneur_tpu.core.table import _ClassIndex as JClassIndex
from veneur_tpu.protocol import columnar as jcolumnar
from veneur_tpu.protocol import dogstatsd as jdsd
from veneur_tpu_torch.core import overload
from veneur_tpu_torch.core.config import read_config
from veneur_tpu_torch.core.flusher import Flusher
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.core.table import MetricTable, TableConfig
from veneur_tpu_torch.core.table import _ClassIndex
from veneur_tpu_torch.protocol import columnar
from veneur_tpu_torch.protocol import dogstatsd as tdsd

_ROWS = {"tpu_counter_rows": 256, "tpu_gauge_rows": 256,
         "tpu_histo_rows": 256, "tpu_set_rows": 16}


def _pair(**kw):
    """A JAX server and a port server on one config, token refill
    frozen (buckets start full at the burst)."""
    data = {"interval": "10s", "hostname": "h", **_ROWS, **kw}
    j = JServer(jread_config(data=data))
    t = Server(read_config(data=data), device="cpu")
    for srv in (j, t):
        srv.overload._refill = lambda: None
    return j, t


def _shutdown(*servers):
    for s in servers:
        s.shutdown()


def _rec(srv) -> dict:
    """The last sealed record's admission fields (the servers' own
    self-telemetry samples differ in number between the packages: the
    reference's also report its JIT compiles)."""
    d = srv.ledger.last().to_dict()
    d["received"] = {k: v for k, v in d["received"].items()
                     if k != "self-telemetry"}
    return {k: d[k] for k in ("received", "shed", "balanced", "status",
                              "dropped", "coalesced", "parse_errors",
                              "observed_unattributed")}


def _user(res) -> dict:
    return {m.name: m.value for m in res.metrics
            if not m.name.startswith("veneur.")}


def _batch(srv, pkts, parser=None):
    if isinstance(srv, JServer):
        srv.handle_packet_batch(pkts, parser or jcolumnar.ColumnarParser())
    else:
        srv.handle_packet_batch(pkts)


# -- the smoke: 2x burst, balanced ledger, attributed shed ------------


def test_burst_sheds_attributed_and_ledger_balances():
    j, t = _pair(tpu_overload_tenant_rate=5.0,
                 tpu_overload_tenant_burst=5.0)
    try:
        for srv in (j, t):
            assert srv.overload.buckets_enabled
            assert srv.overload.admission_active
            for i in range(20):
                srv.handle_packet(b"g.metric:%d|g|#tenant:acme,i:%d"
                                  % (i, i))
            _batch(srv, [b"h.metric.%d:%d|ms|#tenant:zipf" % (i % 4, i)
                         for i in range(30)])
            srv.flush_once()
        jr, tr = _rec(j), _rec(t)
        assert tr["balanced"], tr
        assert tr["shed"] == jr["shed"]
        # all but one burst of 5 per tenant: 15 gauges, 25 timers
        assert tr["shed"]["total"] == 40
        assert set(tr["shed"]["by"]) == {"acme", "zipf"}
        assert t.stats.get("metrics_shed") == j.stats.get("metrics_shed")
        assert t.overload.shed_total == j.overload.shed_total
        assert t.overload.shed_by_total == j.overload.shed_by_total
        assert tr == jr
    finally:
        _shutdown(j, t)


def test_counters_are_never_shed():
    j, t = _pair(tpu_overload_tenant_rate=0.001,
                 tpu_overload_tenant_burst=0.001)
    try:
        out = {}
        for k, srv in (("jax", j), ("torch", t)):
            for _ in range(50):
                srv.handle_packet(b"c.metric:1|c|#tenant:acme")
            _batch(srv, [b"c.batch:1|c|#tenant:acme" for _ in range(50)])
            out[k] = _user(srv.flush_once())
        tr = _rec(t)
        assert tr["balanced"] and tr["shed"]["total"] == 0
        assert out["torch"] == out["jax"]
        assert out["torch"]["c.metric"] == out["torch"]["c.batch"] == 50.0
        assert tr == _rec(j)
    finally:
        _shutdown(j, t)


def test_pressure_freezes_new_series_and_sheds_classes():
    """Level 3: known histograms shed as ``pressure:histogram``, new
    gauges as ``series_freeze``, counters pass; equal attribution."""
    j, t = _pair()
    try:
        for srv in (j, t):
            seed = [b"known.h.%d:5|ms|#tenant:a" % i for i in range(8)]
            _batch(srv, [b"\n".join(seed)])
            srv.overload.pressure.update(10_000_000, 0.0, 0.0, 0)
            assert srv.overload.pressure.level == 3
            pkts = [b"known.h.%d:7|ms|#tenant:a" % i for i in range(8)]
            pkts += [b"new.gauge.%d:1|g|#tenant:b" % i for i in range(20)]
            pkts += [b"cnt.%d:1|c|#tenant:b" % i for i in range(10)]
            _batch(srv, [b"\n".join(pkts)])
            srv.handle_packet(b"scalar.new:1|g|#tenant:c")
            srv.handle_packet(b"scalar.cnt:1|c|#tenant:c")
            srv.flush_once()
        tr, jr = _rec(t), _rec(j)
        assert tr["balanced"], tr
        assert tr["shed"] == jr["shed"]
        reasons = {r for by in tr["shed"]["by"].values() for r in by}
        assert {"pressure:histogram", "series_freeze"} <= reasons
        assert tr["shed"]["total"] == 8 + 20 + 1
        assert t.overload.snapshot()["shed_by"] == \
            j.overload.snapshot()["shed_by"]
    finally:
        _shutdown(j, t)


def test_width_ladder_steps_and_restores():
    j, t = _pair()
    try:
        base = t.table._eff_histo_slots_base
        assert base == j.table._eff_histo_slots_base
        for level in (1, 2, 3, 0):
            t.table.set_pressure_level(level)
            j.table.set_pressure_level(level)
            assert t.table._eff_histo_slots == j.table._eff_histo_slots
        assert t.table._eff_histo_slots == base
        t.table.set_pressure_level(3)
        assert t.table._eff_histo_slots < base
        # the stacked wire fold keeps the width the table was built at
        assert t.table._wire_stack_kmax == j.table._wire_stack_kmax
    finally:
        _shutdown(j, t)


def test_flush_overrun_coalesces_next_tick():
    j, t = _pair()
    try:
        for srv in (j, t):
            srv.handle_packet(b"before:1|c")
            srv.flush_once()
            srv.overload.note_flush(duration_s=99.0, budget_s=1.0)
            assert srv.overload.flush_overruns >= 1
            srv.handle_packet(b"after:1|c")
            res = srv.flush_once()          # coalesced: no swap
            assert not res.metrics and not res.forward
            assert srv.stats.get("flush_coalesced") == 1
            res = srv.flush_once()          # covers both intervals
            assert _user(res)["after"] == 1.0
            rec = srv.ledger.last()
            assert rec.coalesced and rec.balanced
            assert srv.overload.coalesced_total == 1
        assert _rec(t) == _rec(j)
    finally:
        _shutdown(j, t)


def test_idle_hot_path_stays_cheap():
    j, t = _pair()
    try:
        for srv in (j, t):
            assert srv.overload is not None
            assert not srv.overload.buckets_enabled
            assert not srv.overload.admission_active
    finally:
        _shutdown(j, t)


# -- pressure-signal unit coverage ------------------------------------


def _both_pressure(*args):
    return (overload.PressureSignals(*args),
            joverload.PressureSignals(*args))


def _same_updates(pair, updates):
    p, jp = pair
    for u in updates:
        p.update(*u)
        jp.update(*u)
        assert p.to_dict() == jp.to_dict()
    return p


def test_pressure_hysteresis_band():
    p = _same_updates(_both_pressure(100, 0.95, 1.0, 0.7),
                      [(100, 0.0, 0.0, 0), (80, 0.0, 0.0, 0),
                       (60, 0.0, 0.0, 0)])
    assert not p.engaged and p.level == 0 and p.transitions == 2


def test_pressure_levels_scale_with_score():
    pair = _both_pressure(100, 0.95, 1.0, 0.7)
    levels = []
    for u in [(140, 0.0, 0.0, 0), (200, 0.0, 0.0, 0), (300, 0.0, 0.0, 0)]:
        levels.append(_same_updates(pair, [u]).level)
    assert levels == [1, 2, 3]


def test_kernel_drop_engages_pressure():
    p = _same_updates(_both_pressure(1_000_000, 0.95, 1.0, 0.7),
                      [(0, 0.0, 0.0, 1)])
    assert p.engaged and p.score >= 1.0


def test_lag_ewma_smooths_single_slow_flush():
    pair = _both_pressure(1_000_000, 0.95, 1.0, 0.7)
    assert not _same_updates(pair, [(0, 0.0, 1.5, 0)]).engaged
    assert _same_updates(pair, [(0, 0.0, 1.5, 0)]).engaged


def test_read_kernel_drops_finds_real_socket():
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.bind(("127.0.0.1", 0))
        drops = overload.read_kernel_drops([s])
        assert drops == joverload.read_kernel_drops([s])
        assert len(drops) == 1 and all(v >= 0 for v in drops.values())
    finally:
        s.close()


def test_coalesce_arm_is_consumed_once():
    got = []
    for mod in (overload, joverload):
        ovl = mod.Overload()
        ovl.note_flush(duration_s=5.0, budget_s=1.0)
        seq = [ovl.take_coalesce(), ovl.take_coalesce()]
        ovl.note_flush(duration_s=0.5, budget_s=1.0)
        seq.append(ovl.take_coalesce())
        got.append(seq)
    assert got[0] == got[1] == [True, False, False]


def test_compile_warmup_overrun_is_exempt():
    got = []
    for mod in (overload, joverload):
        ovl = mod.Overload()
        ovl.note_flush(duration_s=5.0, budget_s=1.0, compiled=True)
        seq = [ovl.flush_overruns, ovl.take_coalesce()]
        ovl.note_flush(duration_s=5.0, budget_s=1.0, compiled=False)
        seq += [ovl.flush_overruns, ovl.take_coalesce()]
        got.append(seq)
    assert got[0] == got[1] == [0, False, 1, True]


def test_coalesce_disabled_never_arms():
    for mod in (overload, joverload):
        ovl = mod.Overload(coalesce=False)
        ovl.note_flush(duration_s=5.0, budget_s=1.0)
        assert ovl.take_coalesce() is False
        assert ovl.flush_overruns == 1


# -- _ClassIndex capacity boundary ------------------------------------


def _both_index(capacity):
    return _ClassIndex(capacity=capacity), JClassIndex(capacity=capacity)


def _look(pair, name, gen, **kw):
    key = (name, "gauge", (), "")
    rows = [idx.lookup(key, name, (), "", "gauge", gen, **kw)
            for idx in pair]
    assert rows[0] == rows[1]
    assert pair[0].overflow == pair[1].overflow
    return rows[0]


def test_class_index_admits_exactly_capacity():
    pair = _both_index(4)
    assert [_look(pair, f"m{i}", 1) for i in range(4)] == [0, 1, 2, 3]
    assert _look(pair, "m4", 1) is None
    assert pair[0].overflow == 1
    assert _look(pair, "m0", 2) == 0
    assert pair[0].overflow == 1


def test_class_index_one_below_capacity_admits_one_more():
    pair = _both_index(4)
    for i in range(3):
        _look(pair, f"m{i}", 1)
    assert _look(pair, "m3", 1) == 3
    assert pair[0].overflow == 0


def test_class_index_compaction_reopens_capacity():
    pair = _both_index(4)
    for i in range(4):
        _look(pair, f"m{i}", 1)
    for i in (1, 3):
        _look(pair, f"m{i}", 2)
    maps = [idx.compact(keep_gen=2) for idx in pair]
    np.testing.assert_array_equal(maps[0], maps[1])
    assert pair[0].rows == pair[1].rows
    assert set(pair[0].rows.values()) == {0, 1}
    for name in ("m1", "m9", "m10"):
        assert _look(pair, name, 3) is not None
    assert _look(pair, "m11", 3) is None
    assert pair[0].overflow == 1


def test_class_index_overflow_not_counted_when_asked():
    pair = _both_index(1)
    _look(pair, "m0", 1)
    assert _look(pair, "x", 1, count_overflow=False) is None
    assert pair[0].overflow == 0


# -- admit_columns on one seeded batch --------------------------------


def test_admit_columns_matches_jax_on_seeded_batch():
    """One seeded mixed batch (six tenants, every class, known and new
    series, a tenant-less share) through both packages' ``admit_columns``
    with tenant buckets and pressure at level 2: the shed count, the
    attribution and every rewritten type code are equal."""
    rng = np.random.default_rng(7)
    kinds = (b"c", b"g", b"ms", b"h", b"s")
    known, lines = [], []
    for i in range(600):
        kind = kinds[int(rng.integers(0, 5))]
        name = b"adm.%s.%d" % (kind, int(rng.integers(0, 40)))
        t = int(rng.zipf(1.6))
        tag = b"|#tenant:t%d" % t if t < 7 else b""
        val = (b"m%d" % int(rng.integers(0, 99)) if kind == b"s"
               else b"%d" % int(rng.integers(0, 1000)))
        line = name + b":" + val + b"|" + kind + tag
        (known if i < 150 else lines).append(line)
    buf = b"\n".join(lines)
    out = {}
    for k, mod, parser in (
            ("torch", overload, columnar.ColumnarParser()),
            ("jax", joverload, jcolumnar.ColumnarParser())):
        if k == "torch":
            table = MetricTable(TableConfig(
                counter_rows=256, gauge_rows=256, histo_rows=256,
                set_rows=16), device="cpu")
        else:
            table = JTable(JTableConfig(counter_rows=256, gauge_rows=256,
                                        histo_rows=256, set_rows=16))
        seed = parser.parse(b"\n".join(known), copy=True)
        table.ingest_columns(seed)
        ovl = mod.Overload(tenant_rate=40.0, tenant_burst=40.0,
                           max_tenants=8, staging_hi=100)
        ovl._refill = lambda: None
        ovl.pressure.update(200, 0.0, 0.0, 0)
        assert ovl.pressure.level == 2
        pb = parser.parse(buf, copy=True)
        n_shed, by = ovl.admit_columns(pb, table)
        out[k] = (n_shed, by, pb.type_code[:pb.n].copy(),
                  ovl.snapshot())
    assert out["torch"][0] == out["jax"][0] > 0
    assert out["torch"][1] == out["jax"][1]
    np.testing.assert_array_equal(out["torch"][2], out["jax"][2])
    assert int((out["torch"][2] == columnar.CODE_SHED).sum()) == \
        out["torch"][0]
    assert out["torch"][3] == out["jax"][3]
    reasons = {r for _t, r in out["torch"][1]}
    assert {"tenant_budget", "series_freeze", "pressure:set"} <= reasons


# -- the width ladder's level-3 flush ---------------------------------


def _ladder_text(seed: int) -> bytes:
    """40 timer series, 300 gamma(2, 30) samples each: every row's
    batch is deeper than the level-3 width, so the narrowed merge
    runs."""
    rng = np.random.default_rng(seed)
    vals = rng.gamma(2.0, 30.0, size=(40, 300)).astype(np.float32)
    lines = [b"lad.t%d:%r|ms" % (r, float(v))
             for r in range(40) for v in vals[r]]
    lines += [b"lad.c%d:%d|c" % (r, r) for r in range(10)]
    return b"\n".join(lines)


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_pressure_level_flush_matches_jax(level):
    """A table at pressure level 0-3 (histo slots 256, so the levels
    step the merge width 256 -> 128 -> 64 -> 32): the effective width
    equals the JAX table's, and the flush matches it — counts, sums,
    min and max bit for bit, percentiles within rtol 2e-3 / atol
    1e-3."""
    kw = dict(counter_rows=64, gauge_rows=64, histo_rows=64, set_rows=8,
              histo_slots=256)
    table = MetricTable(TableConfig(**kw), device="cpu")
    jtable = JTable(JTableConfig(**kw))
    table.set_pressure_level(level)
    jtable.set_pressure_level(level)
    assert table._eff_histo_slots == jtable._eff_histo_slots
    text = _ladder_text(11)
    parser, jparser = columnar.ColumnarParser(), jcolumnar.ColumnarParser()
    table.ingest_columns(parser.parse(text, copy=True))
    jtable.ingest_columns(jparser.parse(text, copy=True))
    table.device_step()
    jtable.device_step()
    got = Flusher(device="cpu").flush(table.swap(), now=1)
    want = JFlusher(is_local=False).flush(jtable.swap(), now=1)
    g = {m.name: m.value for m in got.metrics}
    w = {m.name: m.value for m in want.metrics}
    assert set(g) == set(w)
    n_pct = 0
    for name, v in w.items():
        if "percentile" in name:
            n_pct += 1
            assert g[name] == pytest.approx(v, rel=2e-3, abs=1e-3), name
        else:
            assert g[name] == v, name
    assert n_pct == 40 * 3


@pytest.mark.parametrize("burst", [None, 5.0])
def test_ingest_parsed_matches_jax(burst):
    """``Server.ingest_parsed``, the reference's one-object entry (the
    span plane's samples go through the same ``ingest_samples``), with
    and without tenant admission: the same returns, shed, stats, ledger
    record and flush as the JAX server's."""
    kw = {} if burst is None else {"tpu_overload_tenant_rate": burst,
                                   "tpu_overload_tenant_burst": burst}
    j, t = _pair(**kw)
    try:
        out = {}
        for k, srv, mod in (("jax", j, jdsd), ("torch", t, tdsd)):
            got = []
            for i in range(12):
                got.append(srv.ingest_parsed(mod.Sample(
                    f"p.timer.{i % 3}", mod.TIMER, float(i),
                    tags=("tenant:acme",))))
                got.append(srv.ingest_parsed(mod.Sample(
                    "p.count", mod.COUNTER, 1.0, tags=("tenant:acme",))))
            got.append(srv.ingest_parsed(mod.ServiceCheck(
                "p.check", 1, tags=("tenant:acme",), message="warn")))
            out[k] = (got, _user(srv.flush_once()),
                      {s: srv.stats.get(s, 0) for s in (
                          "metrics_processed", "metrics_dropped",
                          "metrics_shed")})
        assert out["torch"] == out["jax"]
        tr = _rec(t)
        assert tr == _rec(j) and tr["balanced"]
        assert tr["shed"]["total"] == (0 if burst is None else 7)
    finally:
        _shutdown(j, t)
