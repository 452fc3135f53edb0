"""The port's last public functions against the JAX package's.

``ops/tdigest.py`` ``add_samples``, ``add_samples_unit``, ``cdf``,
``merge_digests`` and ``total_weight``; ``ops/segment.merge_counter``;
``protocol/dogstatsd.split_packet``; ``Snapshot.set_registers()`` and
``Snapshot.release()``; ``FlushResult.forward_split`` /
``account_forward_split``.  Each takes the same seeded numpy inputs as
its ``veneur_tpu`` counterpart, mirroring the cases of
``tests/test_tdigest.py``, ``tests/test_segment.py``,
``tests/test_parser.py`` and ``tests/test_table_flush.py``.

Tolerances: order-free values (HLL registers, split lines, routing
counts) bit for bit; sums and weight fractions rtol 1e-6 (f32 sums in
another order; the port's counter merge sums in f64); percentiles rtol
2e-3 / atol 1e-3 (the reference's merge tolerance): the two merges may
put a centroid on either side of a cluster boundary an ulp decides.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veneur_tpu.core.config import read_config as jread_config
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.core.table import MetricTable as JTable
from veneur_tpu.core.table import TableConfig as JConfig
from veneur_tpu.ops import segment as jseg
from veneur_tpu.ops import tdigest as jtd
from veneur_tpu.protocol import dogstatsd as jdsd
from veneur_tpu_torch.core.config import read_config
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.core.table import MetricTable, TableConfig
from veneur_tpu_torch.ops import segment, tdigest
from veneur_tpu_torch.protocol import dogstatsd as dsd

QTOL = dict(rtol=2e-3, atol=1e-3)
QS = np.asarray([0.01, 0.1, 0.5, 0.9, 0.99], np.float32)


def _pad(a: np.ndarray, n: int, fill) -> np.ndarray:
    out = np.full(n, fill, a.dtype)
    out[:len(a)] = a
    return out


def _both_digests(samples, weights=None, rows: int = 1, row_ids=None,
                  chunk: int = 1024, unit: bool = False):
    """The chunked flat-ingest path of tests/test_tdigest.py through
    both packages: chunks padded to ``chunk`` with row_id == rows."""
    pm, pw = tdigest.empty_state(rows, tdigest.DEFAULT_CAPACITY, "cpu")
    jm, jw = jtd.empty_state(rows)
    n = len(samples)
    w = np.ones(n, np.float32) if weights is None else weights
    ids = (np.zeros(n, np.int32) if row_ids is None
           else row_ids.astype(np.int32))
    for i in range(0, n, chunk):
        cid = _pad(ids[i:i + chunk], chunk, rows)
        cv = _pad(np.asarray(samples[i:i + chunk], np.float32), chunk,
                  np.float32(0))
        cw = _pad(np.asarray(w[i:i + chunk], np.float32), chunk,
                  np.float32(0))
        if unit:
            pm, pw = tdigest.add_samples_unit(
                pm, pw, torch.from_numpy(cid), torch.from_numpy(cv),
                slots=chunk)
            jm, jw = jtd.add_samples_unit(jm, jw, jnp.asarray(cid),
                                          jnp.asarray(cv), slots=chunk)
        else:
            pm, pw = tdigest.add_samples(
                pm, pw, torch.from_numpy(cid), torch.from_numpy(cv),
                torch.from_numpy(cw), slots=chunk)
            jm, jw = jtd.add_samples(jm, jw, jnp.asarray(cid),
                                     jnp.asarray(cv), jnp.asarray(cw),
                                     slots=chunk)
    return (pm, pw), (torch.from_numpy(np.array(jm)),
                      torch.from_numpy(np.array(jw)))


def _assert_digests_close(p, j, mins=None, maxs=None) -> None:
    torch.testing.assert_close(p[1].double().sum(1), j[1].double().sum(1),
                               rtol=1e-6, atol=0)
    qs = torch.from_numpy(QS)
    torch.testing.assert_close(tdigest.quantile(p[0], p[1], qs, mins, maxs),
                               tdigest.quantile(j[0], j[1], qs, mins, maxs),
                               equal_nan=True, **QTOL)


# ---- ops/tdigest.py ------------------------------------------------------

@pytest.mark.parametrize("dist", ["uniform", "lognormal"])
def test_add_samples_matches_jax(dist):
    """test_tdigest.py's build_digest: 50,000 samples into one row in
    padded chunks of 1,024."""
    rng = np.random.default_rng(42)
    samples = getattr(rng, dist)(size=50_000).astype(np.float32)
    p, j = _both_digests(samples)
    _assert_digests_close(p, j)
    assert float(p[1].sum()) == 50_000


def test_add_samples_rate_weights_and_rows_match_jax():
    """Sample-rate weights (test_sample_rate_weights) and eight rows in
    shuffled chunks (test_multi_row_independence)."""
    v = np.concatenate([np.zeros(100), np.ones(100)]).astype(np.float32)
    w = np.concatenate([np.ones(100), 2 * np.ones(100)]).astype(np.float32)
    p, j = _both_digests(v, weights=w, chunk=256)
    _assert_digests_close(p, j)
    np.testing.assert_allclose(tdigest.total_weight(p[1]).numpy(),
                               np.asarray(jtd.total_weight(j[1].numpy())),
                               rtol=1e-6)
    rng = np.random.default_rng(9)
    rows = np.repeat(np.arange(8), 5000)
    vals = np.concatenate([rng.uniform(r, r + 1, 5000)
                           for r in range(8)]).astype(np.float32)
    order = rng.permutation(len(rows))
    p, j = _both_digests(vals[order], rows=8, row_ids=rows[order],
                         chunk=2048)
    _assert_digests_close(p, j)


def test_add_samples_unit_drops_padding_as_jax():
    """test_table_flush.py's seed of 512 rows through add_samples_unit
    at 8 slots, with pad entries (row_id == num_rows) carrying values:
    neither package lands their weight."""
    R = 512
    rng = np.random.default_rng(42)
    ids = np.concatenate([np.arange(R), np.full(40, R)]).astype(np.int32)
    vals = rng.gamma(2.0, 30.0, len(ids)).astype(np.float32)
    pm, pw = tdigest.add_samples_unit(
        *tdigest.empty_state(R, tdigest.DEFAULT_CAPACITY, "cpu"),
        torch.from_numpy(ids), torch.from_numpy(vals), slots=8)
    jm, jw = jtd.add_samples_unit(*jtd.empty_state(R), jnp.asarray(ids),
                                  jnp.asarray(vals), slots=8)
    assert float(pw.sum()) == float(np.asarray(jw).sum()) == R
    # one sample a row: the planes are the same bits
    assert np.array_equal(pm.numpy(), np.asarray(jm))
    assert np.array_equal(pw.numpy(), np.asarray(jw))
    p, j = _both_digests(vals[:R], unit=True, chunk=128)
    _assert_digests_close(p, j)


def test_cdf_matches_jax():
    """The inverse map on the same planes as the JAX package's: inside
    the anchors, outside them (exact 0 and 1), with and without the
    tracked min/max, an empty row NaN; and the roundtrip of
    test_cdf_roundtrip on the port's own digest."""
    rng = np.random.default_rng(11)
    samples = rng.uniform(0, 10, 50_000).astype(np.float32)
    p, j = _both_digests(samples)
    m = np.concatenate([j[0].numpy(), np.zeros_like(j[0].numpy())])
    w = np.concatenate([j[1].numpy(), np.zeros_like(j[1].numpy())])
    xs = np.asarray([-1.0, 0.0, 1.0, 2.5, 5.0, 9.0, 9.999, 10.0, 11.0],
                    np.float32)
    mins = np.asarray([samples.min(), np.nan], np.float32)
    maxs = np.asarray([samples.max(), np.nan], np.float32)
    for lo, hi in ((None, None), (mins, maxs)):
        got = tdigest.cdf(torch.from_numpy(m), torch.from_numpy(w),
                          torch.from_numpy(xs),
                          None if lo is None else torch.from_numpy(lo),
                          None if hi is None else torch.from_numpy(hi))
        want = np.asarray(jtd.cdf(
            jnp.asarray(m), jnp.asarray(w), jnp.asarray(xs),
            None if lo is None else jnp.asarray(lo),
            None if hi is None else jnp.asarray(hi)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
        assert np.isnan(got[1].numpy()).all()
        assert got[0, 0] == 0.0 and got[0, -1] == 1.0
    fr = tdigest.cdf(p[0], p[1], [1.0, 5.0, 9.0])[0].numpy()
    np.testing.assert_allclose(fr, [0.1, 0.5, 0.9], atol=0.01)


def test_merge_digests_matches_jax_and_keeps_inputs():
    """test_merge_digests_matches_combined and _preserves_inputs: the
    union of two digests built from the same planes in both packages;
    the port's inputs come out unchanged."""
    rng = np.random.default_rng(3)
    a = rng.normal(0, 1, 20_000).astype(np.float32)
    b = rng.normal(5, 2, 20_000).astype(np.float32)
    (pa, ja), (pb, jb) = _both_digests(a), _both_digests(b)
    keep = [t.clone() for t in (*ja, *jb)]
    got = tdigest.merge_digests(ja[0], ja[1], jb[0], jb[1])
    want = jtd.merge_digests(*(jnp.asarray(t.numpy())
                               for t in (*ja, *jb)))
    for t, k in zip((*ja, *jb), keep):
        assert torch.equal(t, k)
    _assert_digests_close(got, tuple(torch.from_numpy(np.array(x))
                                     for x in want))
    both = np.concatenate([a, b])
    q = tdigest.quantile(got[0], got[1], torch.tensor([0.5]),
                         torch.tensor([both.min()]),
                         torch.tensor([both.max()]))
    assert abs(float(q[0, 0]) - float(np.quantile(both, 0.5))) < 0.1
    with pytest.raises(ValueError, match="capacity"):
        tdigest.merge_digests(torch.zeros((1, 64)), torch.zeros((1, 64)),
                              torch.zeros((1, 8)), torch.zeros((1, 8)))


def test_total_weight_matches_jax():
    """Row masses of live planes, an empty row, and a subnormal weight
    (no weight, as under XLA)."""
    rng = np.random.default_rng(0)
    w = np.where(rng.random((6, 616)) < 0.4,
                 rng.integers(1, 60, (6, 616)), 0).astype(np.float32)
    w[2] = 0
    w[3, :4] = np.float32(1e-40)
    got = tdigest.total_weight(torch.from_numpy(w)).numpy()
    want = np.asarray(jtd.total_weight(jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[2] == want[2] == 0.0
    assert got.dtype == want.dtype == np.float32


# ---- ops/segment.py, protocol/dogstatsd.py ---------------------------------

def test_merge_counter_matches_jax():
    """test_segment.py's case, then forwarded totals with pad rows
    (row_id == R, dropped by both) and repeated rows."""
    got = segment.merge_counter(segment.empty_counter_state(3, "cpu"),
                                torch.tensor([1, 1], dtype=torch.int32),
                                torch.tensor([2.0, 3.0]))
    want = jseg.merge_counter(jseg.empty_counter_state(3),
                              jnp.array([1, 1], dtype=jnp.int32),
                              jnp.array([2.0, 3.0], dtype=jnp.float32))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [0.0, 5.0, 0.0]
    rng = np.random.default_rng(76)
    R = 64
    state = rng.normal(0, 100, R).astype(np.float32)
    ids = np.concatenate([rng.integers(0, R, 500),
                          np.full(20, R)]).astype(np.int32)
    totals = rng.gamma(2.0, 50.0, len(ids)).astype(np.float32)
    got = segment.merge_counter(torch.from_numpy(state),
                                torch.from_numpy(ids),
                                torch.from_numpy(totals)).numpy()
    want = np.asarray(jseg.merge_counter(jnp.asarray(state),
                                         jnp.asarray(ids),
                                         jnp.asarray(totals)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    exact = state.astype(np.float64)
    np.add.at(exact, ids[:500], totals[:500].astype(np.float64))
    assert np.array_equal(got, exact.astype(np.float32))


@pytest.mark.parametrize("packet", [
    b"a:1|c\nb:2|g\n\nc:3|c\n", b"", b"\n\n\n", b"x:1|c", b"\nx:1|c",
    b"a:1|c\r\nb:2|c", b"_e{1,1}:a|b\n_sc|x|0\nx:1|ms|@0.5|#k:v"])
def test_split_packet_matches_jax(packet):
    assert list(dsd.split_packet(packet)) == \
        list(jdsd.split_packet(packet))
    assert list(dsd.split_packet(b"a:1|c\nb:2|g\n\nc:3|c\n")) == \
        [b"a:1|c", b"b:2|g", b"c:3|c"]


# ---- core/table.Snapshot ---------------------------------------------------

def _set_interval(t, sample_cls, imported=None, n: int = 1000):
    for i in range(n):
        t.ingest(sample_cls(name="u", type="set",
                            value=f"raw-{i}".encode()))
    t.ingest(sample_cls(name="v", type="set", value=b"only"))
    if imported is not None:
        assert t.import_set("u", (), imported)
    return t.swap()


def test_set_registers_match_jax():
    """test_set_mixed_raw_and_import_interval_unions: a host-only
    interval, then raw members plus an imported register plane (the
    device plane touched): set_registers() bit-equal to the JAX
    table's."""
    pt = MetricTable(TableConfig(set_rows=8), device="cpu")
    jt = JTable(JConfig(set_rows=8))
    p0, j0 = _set_interval(pt, dsd.Sample), _set_interval(jt, jdsd.Sample)
    assert p0.host_only_sets and j0.host_only_sets
    imported = j0.set_registers()[0].copy()
    assert np.array_equal(p0.set_registers(), j0.set_registers())
    p1 = _set_interval(pt, dsd.Sample, imported=imported)
    j1 = _set_interval(jt, jdsd.Sample, imported=imported)
    assert p1.hll_device_touched and j1.hll_device_touched
    got, want = p1.set_registers(), j1.set_registers()
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    assert np.array_equal(got, want)


def test_set_registers_tiered_view_matches_jax(monkeypatch):
    """A tiered table's interval: the materialized row-space plane
    (hot rows in wide slots, cold ones compact) as the JAX table's."""
    monkeypatch.setenv("VENEUR_TPU_PLANE_TIERS", "2")
    monkeypatch.setenv("VENEUR_TPU_PROMOTE_SET_ENTRIES", "16")
    monkeypatch.delenv("VENEUR_TPU_TIER_AUTO_BYTES", raising=False)
    monkeypatch.delenv("VENEUR_TPU_TIER_WIDE_SLOTS", raising=False)
    sizes = dict(counter_rows=32, gauge_rows=32, histo_rows=64,
                 set_rows=64)
    pt = MetricTable(TableConfig(**sizes), device="cpu")
    jt = JTable(JConfig(**sizes))
    assert pt.tiers is not None and jt.tiers is not None
    for _ in range(2):
        p, j = _set_interval(pt, dsd.Sample), _set_interval(jt, jdsd.Sample)
        assert p.tiers is not None
        assert np.array_equal(p.set_registers(), j.set_registers())


def test_release_recycles_the_host_plane_as_jax():
    """release() hands the interval's host plane back, cleared, and the
    next interval folds into that same array; the snapshot's plane and
    statistics are gone afterwards; a second release is a no-op."""
    for table, sample in ((MetricTable(TableConfig(set_rows=8),
                                       device="cpu"), dsd.Sample),
                          (JTable(JConfig(set_rows=8)), jdsd.Sample)):
        snap = _set_interval(table, sample, n=50)
        plane = snap.hll_host_plane
        regs = snap.set_registers().copy()
        assert plane is not None and regs.any()
        snap.release()
        assert snap.hll_host_plane is None and snap.hll_host_ez is None
        assert not plane.any()
        snap.release()
        nxt = _set_interval(table, sample, n=50)
        assert nxt.hll_host_plane is plane
        assert np.array_equal(nxt.set_registers(), regs)


# ---- core/flusher.FlushResult.forward_split ------------------------------

_SRV = {"interval": "60s", "tpu_counter_rows": 256, "tpu_gauge_rows": 256,
        "tpu_histo_rows": 256, "tpu_set_rows": 16,
        "percentiles": [0.5, 0.9, 0.99], "tpu_overload": False,
        "tpu_drain_on_shutdown": False}


def _local_lines(seed: int = 4, n: int = 90) -> list[bytes]:
    rng = np.random.default_rng(seed)
    out = [b"gc%d:%d|c|#veneurglobalonly" % (i, rng.integers(1, 9))
           for i in range(n)]
    out += [b"gg%d:%.3f|g|#veneurglobalonly" % (i, rng.normal())
            for i in range(n // 2)]
    out += [b"gt%d:%.3f|ms|#veneurglobalonly" % (i % 20, v)
            for i, v in enumerate(rng.gamma(2.0, 30.0, 200))]
    out += [b"s%d:m%d|s" % (i % 6, i) for i in range(60)]
    return out


def _split(server_cls, cfg_read, addrs, **dev) -> tuple[dict, dict, int]:
    local = server_cls(cfg_read(data=dict(
        _SRV, forward_use_grpc=True, tpu_sharded_global=True,
        forward_address=",".join(addrs))), **dev)
    try:
        lines = _local_lines()
        for i in range(0, len(lines), 100):
            local.handle_packet(b"\n".join(lines[i:i + 100]))
        res = local.flush_once()
        led = local.ledger.last()
        return (dict(res.forward_split), dict(led.forward_split),
                res.row_accounting["forwarded_rows"])
    finally:
        local.shutdown()


def test_forward_split_matches_the_ledger_and_jax():
    """A sharded local over three port globals: the flush result's
    per-destination rows equal its ledger record's split and sum to the
    forwarded rows; a JAX sharded local to the same globals splits the
    same rows the same way."""
    globals_ = [Server(read_config(data=dict(
        _SRV, grpc_listen_addresses=["tcp://127.0.0.1:0"])), device="cpu")
        for _ in range(3)]
    try:
        for g in globals_:
            g.start()
        addrs = [f"127.0.0.1:{g.grpc_ports[0]}" for g in globals_]
        got, led, fwd = _split(Server, read_config, addrs, device="cpu")
        want, jled, jfwd = _split(JServer, jread_config, addrs)
    finally:
        for g in globals_:
            g.shutdown()
    assert fwd > 0 and len(got) >= 2
    assert got == led and sum(got.values()) == fwd
    assert want == jled and got == want and fwd == jfwd
