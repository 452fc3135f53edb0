"""Adaptive sketch tiers in the port against the JAX package, on the CPU.

Ports the guarantees of ``tests/test_adaptive_planes.py`` and holds the
port's tier modules to ``veneur_tpu/core/tiers.py`` and the tiered
paths of ``veneur_tpu/core/table.py`` / ``flusher.py``: the native tier
partition, the compact stores and the tier directory, a tiered table
over several intervals (promotion, escalation, pool exhaustion,
demotion, re-promotion, compaction), a tiered local's forward rows and
a tiered global's ``/import`` and ``SendMetrics`` folds, the auto gate,
and a reader shard's commit.  Tiers are switched on through the
reference's own environment names, read by both packages.

The file imports the JAX package only where it is installed: on a
host with only PyTorch, the ``cuda``-marked case (the tiered table on
the card against the CPU) runs alone, from the repo root with

    python -m pytest --noconftest -q -m cuda tests/test_torch_tiers.py

Tolerances (each comparison states its own): tier and slot arrays,
movements, counters, gauges, counts, min/max, set estimates and
registers, and compact-row percentiles match exactly; sums to rtol
1e-6; wide-row percentiles to rtol 2e-3 / atol 1e-3, the reference's
merge tolerance.  Port tiered against port untiered keeps the
reference's own pins: bit-equal but for the promoted row's percentiles
(rel 2e-2).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

try:
    from veneur_tpu import native as jnative
    from veneur_tpu.core import tiers as jtiers
    from veneur_tpu.core.flusher import Flusher as JFlusher
    from veneur_tpu.core.table import MetricTable as JTable
    from veneur_tpu.core.table import TableConfig as JConfig
    from veneur_tpu.forward import grpc_forward as jgf
    from veneur_tpu.forward import http_import as jhttp
except ImportError:  # a host with only PyTorch: the cuda case runs
    jtiers = None
from veneur_tpu_torch import native
from veneur_tpu_torch.core import tiers
from veneur_tpu_torch.core.config import read_config
from veneur_tpu_torch.core.flusher import Flusher
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.core.table import MetricTable, TableConfig
from veneur_tpu_torch.forward import grpc_forward as gf
from veneur_tpu_torch.forward import http_import
from veneur_tpu_torch.ops import hll

PCTS = (0.5, 0.9, 0.99)
AGGS = ("min", "max", "count", "sum", "avg", "median", "hmean")
TIER_ENV = {
    "VENEUR_TPU_PLANE_TIERS": "2",
    "VENEUR_TPU_PROMOTE_HISTO_SAMPLES": "16",
    "VENEUR_TPU_PROMOTE_SET_ENTRIES": "16",
    "VENEUR_TPU_DEMOTE_IDLE_INTERVALS": "1",
}
needs_jax = pytest.mark.skipif(jtiers is None,
                               reason="needs the JAX package")
# 64 histo and set rows: pools of 8 slots each (wide_slots_for's floor)
_SIZES = dict(counter_rows=32, gauge_rows=32, histo_rows=64, set_rows=64)


@pytest.fixture
def tier_env(monkeypatch):
    for k, v in TIER_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("VENEUR_TPU_TIER_AUTO_BYTES", raising=False)
    monkeypatch.delenv("VENEUR_TPU_TIER_WIDE_SLOTS", raising=False)
    return monkeypatch


def _tables(sizes=_SIZES, **extra):
    jt = JTable(JConfig(**sizes, **extra))
    tt = MetricTable(TableConfig(**sizes, **extra), device="cpu")
    assert jt._lib is not None
    assert jt.tiers is not None and tt.tiers is not None
    return jt, tt


def _by_name(metrics):
    out = {(m.name, m.tags): m for m in metrics}
    assert len(out) == len(metrics), "duplicate metric keys"
    return out


def _assert_same_directory(jt, tt):
    for c in ("histo", "set"):
        j, t = getattr(jt.tiers, c), getattr(tt.tiers, c)
        for a in ("tier", "slot", "slot_row", "idle"):
            np.testing.assert_array_equal(getattr(t, a), getattr(j, a),
                                          err_msg=f"{c}.{a}")
        assert t.free == j.free, c
        assert t.counters() == j.counters(), c


def _tier_of(snap, metas_attr="histo_meta"):
    """Series name -> tier bit (1 wide) of the snapshot's frozen view."""
    metas = getattr(snap, metas_attr)
    tier = (snap.tiers.histo_tier if metas_attr == "histo_meta"
            else snap.tiers.set_tier)
    return {m.name: int(tier[r]) for r, m in enumerate(metas)}


def _assert_same_tiered_flush(tm, jm, htier):
    """Scalars, set estimates and compact-row percentiles bit-equal;
    sums to rtol 1e-6; wide-row percentiles to rtol 2e-3 / atol 1e-3."""
    t, j = _by_name(tm), _by_name(jm)
    assert set(t) == set(j)
    for key, jv in j.items():
        tv = t[key]
        assert tv.type == jv.type, key
        name = key[0]
        if name.endswith(("percentile", ".median")):
            series = name.rsplit(".", 1)[0]
            if htier[series]:
                np.testing.assert_allclose(tv.value, jv.value, rtol=2e-3,
                                           atol=1e-3, err_msg=str(key))
                continue
        elif name.endswith((".sum", ".avg", ".hmean")):
            np.testing.assert_allclose(tv.value, jv.value, rtol=1e-6,
                                       err_msg=str(key))
            continue
        assert tv.value == jv.value, (key, tv.value, jv.value)


# ---- the native partition and the host structures ------------------------

@needs_jax
def test_tier_split_matches_reference_and_plain():
    """vtpu_tier_split in the port's library against the JAX package's
    and against the numpy plain version: bit-equal, stable order."""
    rng = np.random.default_rng(3)
    jlib = jnative.load()
    assert jlib is not None
    for n, rows_n in ((0, 16), (1, 16), (5000, 300), (4096, 8)):
        rows = rng.integers(0, rows_n, n).astype(np.int32)
        tier = (rng.random(rows_n) < 0.3).astype(np.uint8)
        slot = np.where(tier != 0, rng.permutation(rows_n),
                        -1).astype(np.int32)
        cls = jtiers.ClassTiers(rows_n, rows_n)
        cls.tier[:], cls.slot[:] = tier, slot
        got = native.tier_split(rows, tier, slot)
        ref = jtiers.split_by_tier(rows, cls, jlib)
        plain = native.tier_split_plain(rows, tier, slot)
        for g, r, p in zip(got, ref, plain):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, r)
            np.testing.assert_array_equal(g, p)
        tcls = tiers.ClassTiers(rows_n, rows_n)
        tcls.tier[:], tcls.slot[:] = tier, slot
        for g, r in zip(tiers.split_by_tier(rows, tcls), got):
            np.testing.assert_array_equal(g, r)


@needs_jax
def test_stores_match_reference():
    """The same appends, consolidations and drains through both
    packages' CompactHistoStore and SparseSetStore: equal arrays, counts,
    statistics and materialized registers."""
    rng = np.random.default_rng(11)
    th, jh = tiers.CompactHistoStore(40), jtiers.CompactHistoStore(40)
    ts, js = tiers.SparseSetStore(40), jtiers.SparseSetStore(40)
    for step in range(6):
        rows = rng.integers(0, 40, 300).astype(np.int32)
        vals = rng.gamma(2.0, 30.0, 300).astype(np.float32)
        wts = rng.integers(1, 4, 300).astype(np.float32)
        pos = ((rng.integers(0, hll.M, 300) << 6) |
               rng.integers(1, 30, 300)).astype(np.int32)
        for h in (th, jh):
            h.append(rows, vals, wts)
        for s in (ts, js):
            s.append(rows, pos)
        np.testing.assert_array_equal(th.counts, jh.counts)
        np.testing.assert_array_equal(ts.counts, js.counts)
        if step % 2:
            r = int(rows[0])
            for a, b in zip(th.drain_row(r), jh.drain_row(r)):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(ts.drain_row(r),
                                          js.drain_row(r))
    np.testing.assert_array_equal(np.sort(th.touched_rows()),
                                  np.sort(jh.touched_rows()))
    assert th.max_count() == jh.max_count()
    assert th.nbytes() == jh.nbytes() and ts.nbytes() == js.nbytes()
    for r in range(40):
        assert th.count(r) == jh.count(r)
        for a, b in zip(th.samples(r), jh.samples(r)):
            np.testing.assert_array_equal(a, b)
        assert ts.distinct(r) == js.distinct(r)
        assert ts.stats(r) == js.stats(r)
        np.testing.assert_array_equal(ts.materialize(r),
                                      js.materialize(r))
    np.testing.assert_array_equal(ts.counts, js.counts)


@needs_jax
def test_class_tiers_match_reference(tier_env):
    """ClassTiers promote / escalate / refuse / demote / renumber and
    take_delta, the thresholds and the pool size, in both packages."""
    assert vars(tiers.TierThresholds.from_env()) == vars(
        jtiers.TierThresholds.from_env()) == dict(
            set_entries=16, histo_samples=16, demote_idle=1)
    for rows in (4, 64, 65536):
        assert tiers.wide_slots_for(rows) == jtiers.wide_slots_for(rows)
    rng = np.random.default_rng(5)
    t, j = tiers.ClassTiers(64, 8), jtiers.ClassTiers(64, 8)
    for step in range(40):
        r = int(rng.integers(0, 64))
        op = step % 5
        for c in (t, j):
            if op in (0, 1, 2):
                c.ensure_wide(r, escalation=op == 2)
            elif op == 3:
                c.demote(r)
            else:
                mapping = np.full(64, -1, np.int32)
                keep = np.nonzero(rng.random(64) < 0.7)[0]
                mapping[keep] = np.arange(len(keep), dtype=np.int32)
        if op == 4:
            t.renumber(mapping)
            j.renumber(mapping)
        for a in ("tier", "slot", "slot_row", "idle"):
            np.testing.assert_array_equal(getattr(t, a), getattr(j, a))
        assert t.free == j.free
        assert t.occupancy() == j.occupancy()
        if step % 7 == 0:
            assert t.take_delta() == j.take_delta()
    assert t.counters() == j.counters()
    assert t.promote_refused > 0 and t.demotions > 0


@needs_jax
def test_auto_gate_resolves_as_reference(monkeypatch):
    """``auto`` tiers a table exactly when the JAX package does: the
    dense sketch planes past 256 MiB (65,536 timer rows, or 16,384 set
    rows), or past VENEUR_TPU_TIER_AUTO_BYTES; "1"/"2" force."""
    for k in ("VENEUR_TPU_PLANE_TIERS", "VENEUR_TPU_TIER_AUTO_BYTES",
              "VENEUR_TPU_TIER_WIDE_SLOTS"):
        monkeypatch.delenv(k, raising=False)
    cap = 616
    for mode in ("", "auto", "1", "off", "2", "on", "bogus"):
        monkeypatch.setenv("VENEUR_TPU_PLANE_TIERS", mode)
        assert tiers.tier_mode() == jtiers.tier_mode()
        for h_rows, s_rows in ((16384, 1024), (32768, 1024),
                               (65536, 1024), (4096, 16384),
                               (4096, 16383), (54000, 1024)):
            dense = s_rows * hll.M + h_rows * 2 * cap * 4
            assert tiers.tiers_enabled(dense) == \
                jtiers.tiers_enabled(dense)
    monkeypatch.setenv("VENEUR_TPU_PLANE_TIERS", "auto")
    dense = 1024 * hll.M + 65536 * 2 * cap * 4
    assert tiers.tiers_enabled(dense)
    assert not tiers.tiers_enabled(1024 * hll.M + 16384 * 2 * cap * 4)
    monkeypatch.setenv("VENEUR_TPU_TIER_AUTO_BYTES", str(dense))
    assert not tiers.tiers_enabled(dense) and not jtiers.tiers_enabled(
        dense)
    monkeypatch.delenv("VENEUR_TPU_TIER_AUTO_BYTES")
    # both tables at 65,536 timer rows: tiered, with the same pools
    sizes = dict(counter_rows=8, gauge_rows=8, histo_rows=65536,
                 set_rows=1024)
    jt = JTable(JConfig(**sizes))
    tt = MetricTable(TableConfig(**sizes), device="cpu")
    assert tt.tiers is not None and jt.tiers is not None
    assert (tt._histo_pool_rows, tt._set_pool_rows) == (
        jt._histo_pool_rows, jt._set_pool_rows) == (8192, 128)
    assert tuple(tt._state.histo_means.shape) == (8192, cap)
    assert tuple(tt._state.histo_stats.shape) == (65536, 5)
    assert tuple(tt._state.hll_regs.shape) == (128, hll.M)


# ---- a tiered table over several intervals ---------------------------------

def _interval_lines(rng, it: int) -> list[bytes]:
    """One interval's text.  Hot timers h0-h11 and hot sets s0-s11 (12
    series each against 8-slot pools) cross the thresholds in intervals
    0, 1 and 3 and go quiet in interval 2, so rows escalate, are refused
    when the pool runs out, demote and re-promote; in interval 2 the
    "mid" series m0-m3 / ms0-ms3 cross the thresholds late, in the
    apply at the swap, and promote at the boundary that demotes the hot
    rows.  Cold series stay compact throughout."""
    out = [b"c:1|c", b"c:2|c|#env:a", b"g:%d|g" % it]
    hot = it != 2
    for i in range(12):
        n = (30 + 3 * i) if hot else 0
        out += [b"h%d:%.3f|ms" % (i, v) for v in rng.gamma(2.0, 30.0, n)]
        if hot:
            out += [b"s%d:m%d|s" % (i, int(x))
                    for x in rng.integers(0, 5000, 30 + 2 * i)]
    for i in range(4 if it == 2 else 0):
        out += [b"m%d:%.3f|ms" % (i, v) for v in rng.gamma(2.0, 30.0, 18)]
        out += [b"ms%d:m%d|s" % (i, j) for j in range(18)]
    for i in range(30):
        out += [b"cold%d:%.3f|h|@0.5" % (i, v) if i % 3 == 0 else
                b"cold%d:%.3f|ms" % (i, v)
                for v in rng.gamma(2.0, 30.0, int(rng.integers(1, 12)))]
        out += [b"cs%d:m%d|s" % (i, int(x))
                for x in rng.integers(0, 100, int(rng.integers(1, 9)))]
    return [out[k] for k in rng.permutation(len(out))]


def _feed(jt, tt, lines, chunks=4):
    """The same buffers through both tables, an apply after each but the
    last, which the swap applies (the histo staging bound is small, so
    the mid-interval applies escalate and the swap's does not)."""
    step = -(-len(lines) // chunks)
    for k in range(0, len(lines), step):
        buf = b"\n".join(lines[k:k + step])
        assert tt.ingest_buffer(buf) == jt.ingest_buffer(buf)
        if k + step < len(lines):
            jt.device_step()
            tt.device_step()


@needs_jax
def test_tiered_table_matches_jax(tier_env):
    """Four intervals through a tiered JAX table and a tiered port table:
    after every boundary the same tier / slot / idle arrays, free lists,
    movements, occupancy and pool rows; every flush the same within the
    stated tolerances.  Escalation, refusal, boundary promotion,
    demotion and re-promotion all happen."""
    rng = np.random.default_rng(21)
    jt, tt = _tables(histo_merge_samples=64)
    kw = dict(percentiles=PCTS, aggregates=AGGS, hostname="h")
    total = {c: {} for c in ("histo", "set")}
    for it in range(4):
        _feed(jt, tt, _interval_lines(rng, it))
        js, ts = jt.swap(), tt.swap()
        _assert_same_directory(jt, tt)
        assert ts.tiers.movements == js.tiers.movements
        assert ts.tiers.occupancy == js.tiers.occupancy
        assert ts.tiers.pool_rows == js.tiers.pool_rows
        for a in ("histo_tier", "histo_slot", "set_tier", "set_slot"):
            np.testing.assert_array_equal(getattr(ts.tiers, a),
                                          getattr(js.tiers, a))
        np.testing.assert_array_equal(ts.host_set_estimates(),
                                      js.host_set_estimates())
        np.testing.assert_array_equal(ts.tiers.materialize_registers(ts),
                                      js.set_registers())
        for c in total:
            for k, v in ts.tiers.movements[c].items():
                total[c][k] = total[c].get(k, 0) + v
        jr = JFlusher(is_local=False, **kw).flush(js, now=1)
        tr = Flusher(**kw, device="cpu").flush(ts, now=1)
        # the per-row emit reads the same tiered readout as the frame
        per_row = Flusher(**kw, device="cpu", columnar=False).flush(ts,
                                                                    now=1)
        assert sorted((m.name, m.tags, m.value) for m in per_row.metrics) \
            == sorted((m.name, m.tags, m.value) for m in tr.metrics)
        htier = _tier_of(ts)
        # the frozen view: intervals 0-2 run the pool full of hot rows
        # (escalated mid-interval 0; idle in 2, they demote at its end),
        # interval 3 shares it with the four mid rows promoted at
        # interval 2's boundary (idle, they demote at interval 3's)
        wide_hot = sum(htier[f"h{i}"] for i in range(12))
        assert wide_hot == {0: 8, 1: 8, 2: 8, 3: 4}[it], (it, wide_hot)
        if it == 3:
            assert all(htier[f"m{i}"] for i in range(4))
        _assert_same_tiered_flush(tr.metrics, jr.metrics, htier)
        vals = {m.name: m.value for m in tr.metrics}
        if it != 2:
            assert vals["h11.count"] == 30 + 33
            assert vals["s11"] == pytest.approx(52, rel=0.02)
    for c in total:
        mv = total[c]
        assert mv["escalations"] > 0 and mv["promote_refused"] > 0, mv
        assert mv["promotions"] > 0 and mv["demotions"] > 0, mv
        assert mv == getattr(tt.tiers, c).counters(), c


@needs_jax
def test_tiered_compaction_renumbers_as_jax(tier_env):
    """A tiered table whose histogram and set indexes compact at the
    swap: the directory follows the renumbering (dropped wide rows hand
    their slots back), the boundary translates through the row maps,
    and both packages agree on every array and flush."""
    rng = np.random.default_rng(4)
    sizes = dict(_SIZES, histo_rows=32, set_rows=32)
    jt, tt = _tables(sizes, histo_merge_samples=64)
    kw = dict(percentiles=PCTS, aggregates=AGGS, hostname="h")
    epoch = tt._reindex_epoch
    for it in range(5):
        keep = range(it * 6, it * 6 + 8)
        lines = []
        for i in keep:
            n = 24 if i % 4 == 0 else 3
            lines += [b"r%d:%.3f|ms" % (i, v)
                      for v in rng.gamma(2.0, 30.0, n)]
            lines += [b"q%d:m%d|s" % (i, j) for j in range(n)]
        # fill the indexes past the compaction threshold with one-off
        # series, so the next swap drops them
        lines += [b"fill%d_%d:1|ms" % (it, i) for i in range(18)]
        lines += [b"fs%d_%d:x|s" % (it, i) for i in range(18)]
        lines = [lines[k] for k in rng.permutation(len(lines))]
        _feed(jt, tt, lines, chunks=2)
        js, ts = jt.swap(), tt.swap()
        _assert_same_directory(jt, tt)
        assert ts.tiers.movements == js.tiers.movements
        jr = JFlusher(is_local=False, **kw).flush(js, now=1)
        tr = Flusher(**kw, device="cpu").flush(ts, now=1)
        _assert_same_tiered_flush(tr.metrics, jr.metrics, _tier_of(ts))
    assert tt._reindex_epoch >= epoch + 3
    assert tt.tiers.histo.demotions > 0 and tt.tiers.set.promotions > 0


@needs_jax
def test_reader_shard_commit_into_tiered_table(tier_env):
    """Reader shards stage row-space samples and tiers route at apply
    time, so a shard's commit into a tiered table flushes bit for bit
    as ingest_buffer of the same buffers, and as the JAX table."""
    rng = np.random.default_rng(8)
    lines = _interval_lines(rng, 0)
    bufs = [b"\n".join(lines[k::3]) for k in range(3)]
    jt, tt = _tables(histo_merge_samples=64)
    ref = MetricTable(TableConfig(**_SIZES, histo_merge_samples=64),
                      device="cpu")
    shards = [tt.make_reader_shard() for _ in range(2)]
    for k, buf in enumerate(bufs):
        shard = shards[k % 2]
        shard.parse(buf)
        got = shard.commit()
        shard.reset()
        assert got == ref.ingest_buffer(buf) == jt.ingest_buffer(buf)
        for t in (tt, ref, jt):
            t.device_step()
    snaps = [t.swap() for t in (tt, ref, jt)]
    for a in ("histo", "set"):
        assert (getattr(tt.tiers, a).counters() ==
                getattr(ref.tiers, a).counters() ==
                getattr(jt.tiers, a).counters())
    kw = dict(percentiles=PCTS, aggregates=AGGS, hostname="h")
    tm = Flusher(**kw, device="cpu").flush(snaps[0], now=1).metrics
    rm = Flusher(**kw, device="cpu").flush(snaps[1], now=1).metrics
    jm = JFlusher(is_local=False, **kw).flush(snaps[2], now=1).metrics
    assert {(m.name, m.value) for m in tm} == {(m.name, m.value)
                                               for m in rm}
    _assert_same_tiered_flush(tm, jm, _tier_of(snaps[0]))


# ---- port tiered against port untiered -------------------------------------

def test_parity_tiered_vs_wide_only(monkeypatch):
    """tests/test_adaptive_planes.py's parity pins on the port: a
    tiered server and a wide-only server fed the same traffic emit
    bit-identical scalars, compact-row quantiles and set estimates;
    the promoted row's quantiles agree within merge batching (rel
    2e-2)."""
    rng = np.random.default_rng(7)
    compact_feeds = {f"pr.h{i}": np.round(
        rng.uniform(0, 100, size=int(rng.integers(3, 31))), 3)
        for i in range(6)}
    hot_feed = np.round(rng.uniform(0, 100, size=200), 3)
    set_feeds = {f"pr.s{i}": int(rng.integers(5, 40)) for i in range(4)}

    def lines():
        out = []
        for name, vals in compact_feeds.items():
            out += [b"%s:%.3f|ms" % (name.encode(), v) for v in vals]
        out += [b"pr.hot:%.3f|ms" % v for v in hot_feed]
        for name, n in set_feeds.items():
            out += [b"%s:m%d|s" % (name.encode(), j) for j in range(n)]
        out += [b"pr.shot:m%d|s" % j for j in range(300)]
        return out

    def run(mode):
        env = dict(TIER_ENV, VENEUR_TPU_PLANE_TIERS=mode,
                   VENEUR_TPU_PROMOTE_HISTO_SAMPLES="100",
                   VENEUR_TPU_PROMOTE_SET_ENTRIES="100")
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        srv = Server(read_config(data={
            "statsd_listen_addresses": [], "interval": "10s",
            "hostname": "ap", "percentiles": [0.5, 0.99],
            "aggregates": ["min", "max", "count"],
            "tpu_histo_rows": 1024, "tpu_set_rows": 512}, env={}),
            device="cpu")
        try:
            out = []
            for _ in range(2):  # interval 2 exercises the wide pool
                text = lines()
                for i in range(0, len(text), 8):
                    for ln in text[i:i + 8]:
                        srv.handle_packet(ln)
                res = srv.flush_once()
                out.append({m.name: m.value for m in res.metrics
                            if m.name.startswith("pr.")})
            if mode == "2":
                occ = srv.table.plane_bytes()["tiers"]["occupancy"]
                assert (occ["histo"]["wide"], occ["set"]["wide"]) == (1, 1)
            else:
                assert srv.table.tiers is None
            return out
        finally:
            srv.shutdown()

    tiered, oracle = run("2"), run("off")
    tolerant = {"pr.hot.50percentile", "pr.hot.99percentile"}
    for ti, orc in zip(tiered, oracle):
        assert set(ti) == set(orc)
        for name in orc:
            if name in tolerant:
                assert ti[name] == pytest.approx(orc[name],
                                                 rel=2e-2), name
            else:
                assert ti[name] == orc[name], name


# ---- both roles: a tiered local's forward, a tiered global's folds --------

def _local_lines(rng) -> list[bytes]:
    """A local's interval: 12 mixed-scope timers (6 of them hot), a
    global-only counter and gauge, 12 sets (6 hot)."""
    out = [b"req:3|c|#veneurglobalonly", b"depth:4|g|#veneurglobalonly"]
    for i in range(12):
        n = 40 if i < 6 else 5
        out += [b"t%d:%.3f|ms" % (i, v) for v in rng.gamma(2.0, 30.0, n)]
        out += [b"u%d:m%d|s" % (i, int(x))
                for x in rng.integers(0, 3000, n)]
    return [out[k] for k in rng.permutation(len(out))]


def _tiered_locals(rng, n=3):
    """``n`` tiered locals, JAX and port side by side: the forward rows
    of each local's second interval (hot rows wide, the rest compact)."""
    out = []
    kw = dict(percentiles=PCTS, aggregates=AGGS, hostname="h")
    for _ in range(n):
        jt, tt = _tables(histo_merge_samples=1 << 20)
        for it in range(2):
            buf = b"\n".join(_local_lines(rng))
            assert tt.ingest_buffer(buf) == jt.ingest_buffer(buf)
            js, ts = jt.swap(), tt.swap()
        jr = JFlusher(is_local=True, **kw).flush(js, now=1)
        tr = Flusher(is_local=True, **kw, device="cpu").flush(ts, now=1)
        out.append((tr, jr, _tier_of(ts)))
    return out


def _fwd_key(r):
    return (r.kind, r.meta.name, r.meta.tags, r.meta.scope)


@needs_jax
def test_tiered_local_forward_rows_match_jax(tier_env):
    """A tiered local forwards what the JAX local forwards: compact
    digests as their mean-sorted samples (bit-equal), wide digests
    within the merge tolerance, sets as dense registers (compact rows
    upgraded on pack), bit-equal."""
    (tr, jr, htier), = _tiered_locals(np.random.default_rng(2), n=1)
    _assert_same_tiered_flush(tr.metrics, jr.metrics, htier)
    tf = {_fwd_key(r): r for r in tr.forward}
    jf = {_fwd_key(r): r for r in jr.forward}
    assert set(tf) == set(jf)
    kinds = [k[0] for k in tf]
    assert kinds.count("histo") == 12 and kinds.count("set") == 12
    wide_seen = compact_seen = 0
    for key, j in jf.items():
        t = tf[key]
        if key[0] in ("counter", "gauge"):
            assert t.value == j.value
        elif key[0] == "set":
            np.testing.assert_array_equal(t.regs, np.asarray(j.regs))
        else:
            np.testing.assert_array_equal(t.stats, np.asarray(j.stats))
            jm, jw = np.asarray(j.means), np.asarray(j.weights)
            if htier[key[1]]:
                wide_seen += 1
                np.testing.assert_allclose(t.means, jm, rtol=2e-3,
                                           atol=1e-3)
                np.testing.assert_array_equal(t.weights, jw)
            else:
                compact_seen += 1
                np.testing.assert_array_equal(t.means, jm)
                np.testing.assert_array_equal(t.weights, jw)
                assert (np.diff(t.means) >= 0).all()
    assert wide_seen == 6 and compact_seen == 6


def _digest_mass(snap, row: int) -> float:
    """A histogram row's digest weight in a tiered snapshot: its pool
    slot's centroid weights, or its compact store's sample weights."""
    ti = snap.tiers
    if ti.histo_tier[row]:
        return float(snap.histo_weights[int(ti.histo_slot[row])].sum())
    return float(ti.histo_compact.samples(row)[1].sum())


@needs_jax
@pytest.mark.parametrize("transport", ["native", "gob", "grpc"])
def test_tiered_global_folds_match_jax(tier_env, transport):
    """Three tiered locals' forward rows into a tiered JAX global and a
    tiered port global over native JSON, the reference gob schema or
    gRPC MetricLists, an apply after each wire: forwarded digests
    force-promote until the 8-slot pool runs out, then their centroids
    stay compact as weighted samples.  Forwarded registers ship in a
    final apply: the first two wires' in one before the swap (they
    force-promote until the pool runs out, the rest land in the
    overflow sidecar), the last wire's at the swap (frozen: unions into
    wide slots, or the sidecar).  The same directory, movements and
    flush, and every forwarded centroid's weight is in the global's
    digest once.  A second interval takes the same wires again: the
    row and wire plans, row-space, serve it across the boundary's tier
    flips."""
    locals_ = _tiered_locals(np.random.default_rng(6))
    jt, tt = _tables(histo_merge_samples=64)
    kw = dict(percentiles=PCTS, aggregates=AGGS, hostname="h")
    for interval in range(2):
        for k, (tr, _jr, _) in enumerate(locals_):
            rows = tr.forward
            if transport == "grpc":
                wire = gf.rows_to_metric_list(rows).SerializeToString()
                assert gf.apply_metric_list_bytes(tt, wire) == \
                    jgf.apply_metric_list_bytes(jt, wire)
            else:
                enc = (http_import.encode_rows if transport == "native"
                       else http_import.encode_rows_reference)
                body, hdr = enc(rows)
                items = http_import.decode_body(
                    body, hdr.get("Content-Encoding", ""))
                assert http_import.apply_import(tt, items) == \
                    jhttp.apply_import(jt, items)
            jt.device_step(final=k == 1)
            tt.device_step(final=k == 1)
        js, ts = jt.swap(), tt.swap()
        _assert_same_directory(jt, tt)
        assert ts.tiers.movements == js.tiers.movements
        mv = ts.tiers.movements
        np.testing.assert_array_equal(ts.host_set_estimates(),
                                      js.host_set_estimates())
        jr = JFlusher(is_local=False, **kw).flush(js, now=1)
        tr = Flusher(**kw, device="cpu").flush(ts, now=1)
        htier = _tier_of(ts)
        _assert_same_tiered_flush(tr.metrics, jr.metrics, htier)
        if interval:
            # the first interval's wide rows keep their slots (touched,
            # so never idle) and the pool stays full
            assert sum(htier[f"t{i}"] for i in range(12)) == 8
            if transport == "grpc":
                # every wire of the second interval from its plan
                assert tt.wire_plan_hits == hits + 3
            continue
        hits = tt.wire_plan_hits
        for c in ("histo", "set"):
            assert mv[c]["escalations"] == 8, c
            assert mv[c]["promote_refused"] > 0, c
        ov = ts.tiers.set_dense_overflow
        assert len(ov) == 4 and set(ov) == set(
            js.tiers.set_dense_overflow)
        for r, regs in js.tiers.set_dense_overflow.items():
            np.testing.assert_array_equal(ov[r], regs)
        assert 0 < sum(htier[f"t{i}"] for i in range(12)) < 12
        for r, m in enumerate(ts.histo_meta):
            if m.name.startswith("t"):
                sent = sum(float(f.weights.sum()) for lt in locals_
                           for f in lt[0].forward
                           if f.kind == "histo" and f.meta.name == m.name)
                assert _digest_mass(ts, r) == sent, m.name


@pytest.mark.cuda
def test_tiered_table_cuda_matches_cpu(tier_env):
    """The tiered table on the card against the same table on the CPU:
    the same directory and movements; counters, counts, min/max, set
    estimates and compact-row percentiles bit-equal; sums to rtol 1e-6;
    wide-row percentiles within rtol 2e-3 / atol 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU "
                    "mode")
    rng = np.random.default_rng(21)
    cfg = TableConfig(**_SIZES, histo_merge_samples=64)
    dt, ct = MetricTable(cfg, device="cuda"), MetricTable(cfg, device="cpu")
    kw = dict(percentiles=PCTS, aggregates=AGGS, hostname="h")
    for it in range(4):
        lines = _interval_lines(rng, it)
        for k in range(0, len(lines), 200):
            buf = b"\n".join(lines[k:k + 200])
            assert dt.ingest_buffer(buf) == ct.ingest_buffer(buf)
            dt.device_step()
            ct.device_step()
        ds, cs = dt.swap(), ct.swap()
        assert ds.tiers.movements == cs.tiers.movements
        for c in ("histo", "set"):
            np.testing.assert_array_equal(getattr(dt.tiers, c).slot,
                                          getattr(ct.tiers, c).slot)
        dm = Flusher(**kw, device="cuda").flush(ds, now=1).metrics
        cm = Flusher(**kw, device="cpu").flush(cs, now=1).metrics
        _assert_same_tiered_flush(dm, cm, _tier_of(cs))
