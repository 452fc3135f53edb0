"""The port's mesh global (``veneur_tpu_torch/parallel/sharded.py``)
against the reference's (``veneur_tpu/parallel/sharded.py``).

Twins of ``tests/test_sharded.py``: the same seeded samples go through
the JAX ``ShardedAggregator`` on conftest's 8-device CPU mesh and the
port's on 8 CPU places, and every output is held to the reference's:
order-free values (gauges, min/max, HLL registers) bit for bit, sums
(counters, stat weight/sum/rsum) to rtol 1e-6, quantiles to rtol 2e-3 /
atol 1e-3.  The server-path twin runs a port ``Server`` with
``tpu_mesh_shards: 4`` on 8 places against a JAX ``Server`` on the same
samples; it is deterministic: no sockets, and a 600 s interval, so
the flush's bounded wait for its sinks never expires under load (the
reference's twin, with 10 s, flushed past a sink that overran its
budget in a 6-worker run).
"""

from __future__ import annotations

import logging

import jax
import numpy as np
import pytest
import torch

from veneur_tpu.core.config import read_config as jread_config
from veneur_tpu.core.flusher import Flusher as JFlusher
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.parallel import ShardedAggregator as JAgg
from veneur_tpu.parallel import ShardedConfig as JCfg
from veneur_tpu.parallel import ShardedTable as JTable
from veneur_tpu.parallel import make_mesh as jmake_mesh
from veneur_tpu.protocol import dogstatsd as jdsd
from veneur_tpu.sinks.simple import CaptureSink as JCapture
from veneur_tpu.utils import hashing
from veneur_tpu_torch import convert
from veneur_tpu_torch.core.config import read_config
from veneur_tpu_torch.core.flusher import Flusher
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.parallel import (ShardedAggregator, ShardedConfig,
                                       ShardedTable, default_places,
                                       make_mesh)
from veneur_tpu_torch.protocol import dogstatsd as dsd
from veneur_tpu_torch.sinks.simple import CaptureSink

RTOL_SUM = 1e-6
QTOL = dict(rtol=2e-3, atol=1e-3)


def _pair(n: int, places=None, **cfg):
    """A JAX aggregator on n virtual devices and a port one on n CPU
    places, same config."""
    j = JAgg(jmake_mesh(jax.devices()[:n]), JCfg(**cfg))
    p = ShardedAggregator(make_mesh(places or ["cpu"] * n),
                          ShardedConfig(**cfg))
    return j, p


def _both(j, p, fn):
    fn(j)
    fn(p)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_flush_matches(jout: dict, pout: dict) -> None:
    for k in ("gauges", "hll"):
        assert np.array_equal(_np(jout[k]), _np(pout[k])), k
    np.testing.assert_allclose(_np(pout["counters"]),
                               _np(jout["counters"]), rtol=RTOL_SUM)
    js, ps = _np(jout["histo_stats"]), _np(pout["histo_stats"])
    assert np.array_equal(js[:, 1:3], ps[:, 1:3])  # min, max
    for c in (0, 3, 4):
        np.testing.assert_allclose(ps[:, c], js[:, c], rtol=RTOL_SUM)
    np.testing.assert_allclose(_np(pout["histo_weights"]).sum(1),
                               _np(jout["histo_weights"]).sum(1),
                               rtol=RTOL_SUM)
    if "quantiles" in jout:
        np.testing.assert_allclose(_np(pout["quantiles"]),
                                   _np(jout["quantiles"]), **QTOL)
        np.testing.assert_allclose(_np(pout["hll_estimate"]),
                                   _np(jout["hll_estimate"]),
                                   rtol=RTOL_SUM)


def test_mesh_shape():
    assert len(jax.devices()) == 8, "conftest must provide 8 devices"
    mesh = make_mesh(["cpu"] * 8)
    assert mesh.shape == dict(jmake_mesh(jax.devices()).shape) == {
        "shard": 4, "series": 2}
    assert mesh.size == 8 and len(mesh.groups) == 1
    assert make_mesh(["cpu"] * 8, n_shard=8).shape == {"shard": 8,
                                                       "series": 1}
    # a split that does not divide raises, as the reference's
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(["cpu"] * 8, n_shard=3)
    with pytest.raises(ValueError):
        jmake_mesh(jax.devices(), n_shard=3)
    # the CPU's visible devices are one place
    assert default_places("cpu") == [torch.device("cpu")]


def test_counter_psum_across_shards():
    j, p = _pair(8, rows=32, set_rows=8, slots=32, batch=256)
    exact = np.zeros(32)
    rng = np.random.default_rng(1)
    for shard in range(4):
        rows = rng.integers(0, 32, 100, dtype=np.int32)
        vals = rng.normal(2, 1, 100).astype(np.float32)
        np.add.at(exact, rows, vals)
        for a in (j, p):
            a.stage(shard, counter_rows=rows, counter_vals=vals,
                    counter_wts=np.ones(100, np.float32))
    _both(j, p, lambda a: a.step())
    jout, pout = j.flush(), p.flush()
    _assert_flush_matches(jout, pout)
    np.testing.assert_allclose(_np(pout["counters"]), exact, rtol=1e-4,
                               atol=1e-3)


def test_counter_rate_correction():
    j, p = _pair(8, rows=32, set_rows=8, slots=32, batch=256)
    _both(j, p, lambda a: a.stage(0, counter_rows=[3],
                                  counter_vals=[5.0],
                                  counter_wts=[10.0]))  # 1/rate = 10
    _both(j, p, lambda a: a.step())
    got = float(_np(p.flush()["counters"])[3])
    assert got == float(_np(j.flush()["counters"])[3]) == 50.0


def test_gauge_last_write_wins_across_shards():
    """The globally latest ticket wins across shards; and, as in the
    reference's update step, a winning NEGATIVE value lands as 0 (it
    is scatter-maxed into a zero plane)."""
    j, p = _pair(8, rows=32, set_rows=8, slots=32, batch=256)
    for a in (j, p):
        t1 = a.next_ticket(1)
        t2 = a.next_ticket(1)
        a.stage(1, gauge_rows=[7], gauge_vals=[111.0], gauge_ticket=t2)
        a.stage(0, gauge_rows=[7], gauge_vals=[5.0], gauge_ticket=t1)
        a.stage(2, gauge_rows=[9], gauge_vals=[42.0],
                gauge_ticket=a.next_ticket(1))
        a.stage(3, gauge_rows=[11], gauge_vals=[-5.0],
                gauge_ticket=a.next_ticket(1))
        a.step()
    jg, pg = _np(j.flush()["gauges"]), _np(p.flush()["gauges"])
    assert np.array_equal(jg, pg)
    assert pg[7] == 111.0 and pg[9] == 42.0 and pg[11] == 0.0


def test_histo_merge_and_quantiles():
    """Samples of one series over every shard, steps interleaved: the
    merged digest matches the reference's and tracks the pooled
    quantiles."""
    j, p = _pair(8, rows=32, set_rows=8, slots=32, batch=256)
    rng = np.random.default_rng(3)
    pooled = []
    for shard in range(4):
        vals = rng.gamma(3.0, 2.0, 200).astype(np.float32)
        pooled.append(vals)
        for a in (j, p):
            a.stage(shard, histo_rows=np.zeros(200, np.int32),
                    histo_vals=vals, histo_wts=np.ones(200, np.float32))
            a.step()
    qs = (0.5, 0.9, 0.99)
    jout, pout = j.flush(qs=qs), p.flush(qs=qs)
    _assert_flush_matches(jout, pout)
    pooled = np.concatenate(pooled)
    stats = _np(pout["histo_stats"])
    assert stats[0, 0] == len(pooled)
    q = _np(pout["quantiles"])[0]
    for i, pct in enumerate(qs):
        assert q[i] == pytest.approx(np.quantile(pooled, pct), rel=0.05)


def test_hll_union_across_shards():
    """Overlapping members on different shards union (register max)."""
    j, p = _pair(8, rows=32, set_rows=8, slots=32, batch=256)
    members = [f"user-{i}".encode() for i in range(500)]
    for shard in range(4):
        idx, rank = hashing.hash_members(members[shard * 100:
                                                 shard * 100 + 200])
        for a in (j, p):
            a.stage(shard, set_rows=np.zeros(len(idx), np.int32),
                    set_idx=idx.astype(np.int32),
                    set_rank=rank.astype(np.int32))
    _both(j, p, lambda a: a.step())
    jout, pout = j.flush(), p.flush()
    _assert_flush_matches(jout, pout)
    assert float(_np(pout["hll_estimate"])[0]) == pytest.approx(
        500, rel=0.1)


def test_row_sharding_routes_all_rows():
    j, p = _pair(8, rows=32, set_rows=8, slots=32, batch=256)
    rows = np.arange(32, dtype=np.int32)
    _both(j, p, lambda a: a.stage(0, counter_rows=rows,
                                  counter_vals=np.ones(32, np.float32),
                                  counter_wts=np.ones(32, np.float32)))
    _both(j, p, lambda a: a.step())
    got = _np(p.flush()["counters"])
    assert np.array_equal(got, _np(j.flush()["counters"]))
    assert np.array_equal(got, np.ones(32, np.float32))


def test_staging_overflow_and_chunking():
    """Past-batch staging chunks across update calls (counters
    pre-combine first, histo samples chunk by within-row rank) — never
    raises, and matches the reference's chunked result."""
    j, p = _pair(4, rows=64, set_rows=16, slots=32, batch=256)
    n = 2000
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 64, n).astype(np.int32)
    vals = rng.normal(5.0, 1.0, n).astype(np.float32)
    for a in (j, p):
        a.stage(0, counter_rows=rows, counter_vals=vals,
                counter_wts=np.ones(n, np.float32),
                histo_rows=rows, histo_vals=vals,
                histo_wts=np.ones(n, np.float32))
        a.stage(1, counter_rows=np.zeros(257, np.int32),
                counter_vals=np.ones(257, np.float32),
                counter_wts=np.ones(257, np.float32))
        a.step()
    assert p.update_calls > 1
    jout, pout = j.flush(), p.flush()
    _assert_flush_matches(jout, pout)
    assert _np(pout["histo_stats"])[:, 0].sum() == n


def test_swap_resets_interval():
    j, p = _pair(4, rows=32, set_rows=8, slots=16, batch=128)
    _both(j, p, lambda a: a.stage(0, counter_rows=[3],
                                  counter_vals=[7.0], counter_wts=[1.0]))
    assert float(_np(p.swap()["counters"])[3]) == float(
        _np(j.swap()["counters"])[3]) == 7.0
    assert float(_np(p.swap()["counters"]).sum()) == 0.0


def _hmean_table(table_cls, mesh, cfg_cls, flusher):
    vals = np.asarray([1.0, 100.0, 1.0, 100.0, 2.0], np.float32)
    stats = np.asarray([len(vals), vals.min(), vals.max(), vals.sum(),
                        float((1.0 / vals).sum())], np.float32)
    t = table_cls(mesh, cfg_cls(rows=32, set_rows=8, slots=16,
                                batch=128))
    assert t.import_histo("lat", "timer", (), stats,
                          np.asarray([vals.mean()], np.float32),
                          np.asarray([5.0], np.float32))
    res = flusher.flush(t.swap())
    return {m.name: m.value for m in res.metrics}, vals


def test_sharded_import_preserves_reciprocal_sum():
    """A forwarded digest's exact reciprocal sum survives the mesh
    import (an RSUM correction beside the centroids), as in the
    reference."""
    got, vals = _hmean_table(
        ShardedTable, make_mesh(["cpu"] * 4), ShardedConfig,
        Flusher(is_local=False, percentiles=(),
                aggregates=("hmean", "count"), device="cpu"))
    want, _ = _hmean_table(
        JTable, jmake_mesh(jax.devices()[:4]), JCfg,
        JFlusher(is_local=False, percentiles=(),
                 aggregates=("hmean", "count")))
    assert got["lat.count"] == want["lat.count"]
    assert got["lat.hmean"] == pytest.approx(want["lat.hmean"],
                                             rel=RTOL_SUM)
    assert got["lat.hmean"] == pytest.approx(
        len(vals) / float((1.0 / vals).sum()), rel=1e-3)


def test_sharded_import_validates_before_staging():
    t = ShardedTable(make_mesh(["cpu"] * 4),
                     ShardedConfig(rows=32, set_rows=8, slots=16,
                                   batch=128))
    with pytest.raises(ValueError, match="stats shape"):
        t.import_histo("h", dsd.TIMER, (), np.zeros((2, 5), np.float32),
                       np.ones(3, np.float32), np.ones(3, np.float32))
    with pytest.raises(ValueError, match="register plane"):
        t.import_set("s", (), np.zeros(7, np.uint8))
    with pytest.raises(ValueError, match="register plane"):
        t.import_set_at(0, np.zeros(7, np.uint8))
    assert t.staged() == 0


def _mixed_stage(a, n_shard: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    for shard in range(n_shard):
        rows = rng.integers(0, 16, 40, dtype=np.int32)
        vals = rng.gamma(2.0, 3.0, 40).astype(np.float32)
        a.stage(shard, counter_rows=rows, counter_vals=vals,
                counter_wts=np.full(40, 2.0, np.float32),
                histo_rows=rows, histo_vals=vals,
                histo_wts=np.ones(40, np.float32),
                rsum_rows=rows[:3], rsum_vals=vals[:3])
        a.stage(shard, gauge_rows=rows[:6], gauge_vals=vals[:6],
                gauge_ticket=a.next_ticket(6))
        idx, rank = hashing.hash_members(
            [f"m{shard}-{i}".encode() for i in range(30)])
        a.stage(shard, set_rows=rows[:30] % 4,
                set_idx=idx.astype(np.int32),
                set_rank=rank.astype(np.int32))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_small_meshes_aggregate_as_jax(n):
    """Every class at mesh sizes 1, 2, 4 and 8 against the reference
    at the same size."""
    j, p = _pair(n, rows=16, set_rows=4, slots=16, batch=64)
    assert p.mesh.shape == dict(j.mesh.shape)
    for a in (j, p):
        _mixed_stage(a, a.n_shard, seed=n)
        a.step()
    _assert_flush_matches(j.flush(qs=(0.5, 0.99)), p.flush(qs=(0.5, 0.99)))


def test_places_on_two_devices_merge_as_one():
    """Places on distinct devices keep separate partial planes (one
    per device group) and merge on the home place: the result is the
    one-device mesh's, bit for bit."""
    places = [torch.device("cpu"), torch.device("cpu", 0)] * 4
    two = ShardedAggregator(make_mesh(places),
                            ShardedConfig(rows=16, set_rows=4, slots=16,
                                          batch=64))
    one = ShardedAggregator(make_mesh(["cpu"] * 8),
                            ShardedConfig(rows=16, set_rows=4, slots=16,
                                          batch=64))
    assert len(two.mesh.groups) == 2 and len(two.state) == 2
    for a in (two, one):
        _mixed_stage(a, 4, seed=5)
        a.step()
    a, b = two.flush(), one.flush()
    for k in ("counters", "gauges", "histo_stats", "histo_means",
              "histo_weights", "hll", "quantiles"):
        assert np.array_equal(_np(a[k]), _np(b[k]), equal_nan=True), k


def test_state_round_trips_through_convert():
    """A JAX aggregator's partial state loads into the port's mesh and
    both flush the same; the port's state comes back out unchanged."""
    j, p = _pair(8, rows=16, set_rows=4, slots=16, batch=64)
    _mixed_stage(j, 4, seed=9)
    j.step()
    arrays = {k: np.asarray(v) for k, v in j.state.items()}
    p.state = convert.sharded_state_from_numpy(p.mesh, p.cfg, arrays)
    back = convert.sharded_state_to_numpy(p.mesh, p.cfg, p.state)
    for k, v in arrays.items():
        assert np.array_equal(back[k], v), k
    _assert_flush_matches(j.flush(), p.flush())


_SERVER_CFG = {"interval": "600s", "tpu_mesh_shards": 4,
               "tpu_histo_rows": 4096, "tpu_set_rows": 64,
               "tpu_counter_rows": 1024, "tpu_gauge_rows": 1024,
               "percentiles": [0.5, 0.99],
               "accelerator_probe_timeout": "0s"}


def _drive_server(srv, sample_cls, rng_seed: int) -> dict:
    rng = np.random.default_rng(rng_seed)
    per_series = {}
    for s in range(64):
        vals = rng.gamma(2.0, 30.0, 256)
        per_series[s] = vals
        for v in vals:
            srv.table.ingest(sample_cls(name=f"lat.{s}", type="timer",
                                        value=float(v)))
    extra = rng.gamma(2.0, 30.0, 500).astype(np.float32)
    stats = np.asarray([len(extra), extra.min(), extra.max(),
                        extra.sum(), (1.0 / extra).sum()], np.float32)
    assert srv.table.import_histo("lat.0", "timer", (), stats, extra,
                                  np.ones(len(extra), np.float32))
    per_series[0] = np.concatenate([per_series[0], extra])
    srv.handle_packet(b"\n".join(
        f"hits.{i}:{i}|c|@0.5\ntemp.{i}:{i - 3.5}|g\nusers:u{i}|s".encode()
        for i in range(20)))
    srv.flush_once()
    return per_series


def test_sharded_table_server_path_production_rows():
    """Twin of the reference's server-path test: a port Server with
    tpu_mesh_shards 4 on 8 CPU places against a JAX Server on the same
    samples (raw ingest beside a forwarded digest import, plus
    DogStatsD counters, gauges and sets through the columnar ingest),
    flushed through CaptureSink.  Every emitted value matches; the p99s
    stay within 2% of exact."""
    pcap, jcap = CaptureSink(), JCapture()
    psrv = Server(read_config(data=_SERVER_CFG), device="cpu",
                  extra_sinks=[pcap], places=["cpu"] * 8)
    jsrv = JServer(jread_config(data=_SERVER_CFG), extra_sinks=[jcap])
    try:
        assert isinstance(psrv.table, ShardedTable)
        assert psrv.table.mesh.shape == {"shard": 4, "series": 2}
        per_series = _drive_server(psrv, dsd.Sample, 31)
        _drive_server(jsrv, jdsd.Sample, 31)
    finally:
        psrv.shutdown()
        jsrv.shutdown()
    got = {(m.name, m.tags): m.value for m in pcap.metrics}
    want = {(m.name, m.tags): m.value for m in jcap.metrics}
    assert set(got) == set(want) and len(got) > 64 * 4
    for key, v in want.items():
        if key[0].endswith("percentile"):
            assert got[key] == pytest.approx(v, rel=2e-3, abs=1e-3), key
        else:
            assert got[key] == pytest.approx(v, rel=RTOL_SUM), key
    errs = []
    for s, vals in per_series.items():
        exact = float(np.quantile(vals, 0.99))
        errs.append(abs(got[(f"lat.{s}.99percentile", ())] - exact)
                    / exact)
        assert got[(f"lat.{s}.count", ())] == len(vals)
    assert max(errs) < 0.02, max(errs)


def test_pipeline_ignored_warning_and_one_place_refuses(caplog):
    """tpu_pipeline is a no-op with the mesh table, logged; a mesh of
    4 shards over the CPU's one visible place raises, as the reference
    does on one chip."""
    cfg = {"interval": "10s", "tpu_mesh_shards": 2,
           "tpu_histo_rows": 64, "tpu_set_rows": 8,
           "tpu_counter_rows": 16, "tpu_gauge_rows": 16}
    with caplog.at_level(logging.WARNING,
                         logger="veneur_tpu_torch.server"):
        srv = Server(read_config(data=cfg), device="cpu",
                     places=["cpu"] * 4)
    try:
        assert srv.pipeline is False
        assert any("tpu_pipeline is ignored" in r.message
                   for r in caplog.records)
    finally:
        srv.shutdown()
    with pytest.raises(ValueError, match="not divisible"):
        Server(read_config(data=dict(cfg, tpu_mesh_shards=4)),
               device="cpu")


def test_pressure_freeze_on_the_mesh_table():
    """Under pressure the columnar admission freezes new non-counter
    series.  The single table answers "is this series known?" from its
    native key index; the mesh table has none, so the port asks its
    class indexes, as the per-sample admission does, and sheds what the
    single table sheds.  (The reference's columnar admission reads
    ``table.key_index`` on its mesh table too and raises there.)"""
    base = {"interval": "600s", "tpu_histo_rows": 64, "tpu_set_rows": 8,
            "tpu_counter_rows": 64, "tpu_gauge_rows": 64}
    seed = [b"\n".join(b"known.g.%d:5|g|#tenant:a" % i for i in range(8))]
    pkts = [b"\n".join([b"known.g.%d:7|g|#tenant:a" % i for i in range(8)]
                       + [b"new.g.%d:1|g|#tenant:b" % i for i in range(6)]
                       + [b"cnt.%d:1|c|#tenant:b" % i for i in range(4)])]
    shed = {}
    for name, cfg, kw in (
            ("mesh", dict(base, tpu_mesh_shards=2), {"places": ["cpu"] * 4}),
            ("single", base, {})):
        srv = Server(read_config(data=cfg), device="cpu", **kw)
        try:
            srv.handle_packet_batch(seed)
            srv.overload.pressure.update(10_000_000, 0.0, 0.0, 0)
            # level 1 sheds only sets by class: the gauges meet the
            # freeze alone
            srv.overload.pressure.level = 1
            assert srv.overload.admission_active
            srv.handle_packet_batch(pkts)
            res = srv.flush_once()
            got = {m.name: m.value for m in res.metrics}
            assert all(got[f"known.g.{i}"] == 7.0 for i in range(8))
            assert all(got[f"cnt.{i}"] == 1.0 for i in range(4))
            assert not any(k.startswith("new.g.") for k in got)
            rec = srv.ledger.last()
            assert rec.balanced
            shed[name] = srv.overload.snapshot()["shed_by"]
        finally:
            srv.shutdown()
    assert shed["mesh"] == shed["single"]
    assert sum(sum(v.values()) for v in shed["mesh"].values()) == 6
    jsrv = JServer(jread_config(data=dict(base, tpu_mesh_shards=2,
                                          accelerator_probe_timeout="0s")))
    try:
        from veneur_tpu.protocol import columnar as jcolumnar
        parser = jcolumnar.ColumnarParser()
        jsrv.handle_packet_batch(seed, parser)
        jsrv.overload.pressure.update(10_000_000, 0.0, 0.0, 0)
        with pytest.raises(AttributeError, match="key_index"):
            jsrv.handle_packet_batch(pkts, parser)
    finally:
        jsrv.shutdown()


def test_mesh_grpc_set_import_matches_single_table():
    """gRPC wires of dense (several bases), sparse and malformed HLL
    sketches, more than one 64-sketch scratch plane's worth and a row
    repeated across its boundary, into a mesh global
    (``ShardedTable.import_set_sketches``) and a single-table one: the
    same (accepted, dropped) per wire and the same flushed set
    cardinalities, a refused sketch's series empty."""
    from tests import hll_sketches as hs
    from veneur_tpu_torch.forward import grpc_forward as gf
    rng = np.random.default_rng(23)
    keys = hs.sparse_keys([f"k{i}".encode() for i in range(400)])
    bad = hs.malformed(rng)
    items = []
    for i in range(72):
        if i % 3 == 0:
            sk = hs.sparse(keys[i:i + 20], keys[i + 20::5])
        else:
            sk = hs.dense(rng.integers(0, 12, hs.M), b=i % 5)
        items.append((f"s{i % 67}", sk))
    items += [(f"bad.{k}", v) for k, v in sorted(bad.items())]
    wires = [hs.set_wire([items[i] for i in rng.permutation(len(items))])
             for _ in range(2)]
    base = {"interval": "600s", "tpu_histo_rows": 64, "tpu_set_rows": 128,
            "tpu_counter_rows": 64, "tpu_gauge_rows": 64}
    got, applied = {}, {}
    for name, cfg, kw in (
            ("mesh", dict(base, tpu_mesh_shards=2), {"places": ["cpu"] * 4}),
            ("single", base, {})):
        srv = Server(read_config(data=cfg), device="cpu", **kw)
        try:
            assert isinstance(srv.table, ShardedTable) == (name == "mesh")
            applied[name] = [gf.apply_metric_list_bytes(srv.table, w)
                             for w in wires]
            res = srv.flush_once()
            got[name] = {m.name: m.value for m in res.metrics}
        finally:
            srv.shutdown()
    assert applied["mesh"] == applied["single"] == [(72, len(bad))] * 2
    assert got["mesh"] == got["single"]
    assert all(got["mesh"][f"s{i}"] > 0 for i in range(67))
    assert all(v == 0 for k, v in got["mesh"].items()
               if k.startswith("bad."))
