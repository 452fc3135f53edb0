"""CPU parity of the PyTorch port's ops against the JAX package.

Every test feeds the same seeded numpy inputs through a ``veneur_tpu``
function and its ``veneur_tpu_torch`` counterpart and compares the
outputs with the tolerance stated beside it:

- order-free results (counter/gauge planes, HLL registers, stat
  min/max, packing) must match bit for bit;
- float sums taken in another order (counter adds, stat sums, digest
  mass) match to rtol 1e-6;
- merged digests are compared through the quantile readout at rtol
  2e-3 / atol 1e-3, the reference's own merge tolerance
  (tests/test_pallas_merge.py), because the f32 cumulative weight may
  move a boundary-straddling centroid into the neighbouring cluster.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veneur_tpu.ops import hll as jhll
from veneur_tpu.ops import pallas_merge
from veneur_tpu.ops import segment as jseg
from veneur_tpu.ops import superbatch as jsb
from veneur_tpu.ops import tdigest as jtd
from veneur_tpu_torch.ops import cluster_merge, hll, segment, superbatch
from veneur_tpu_torch.ops import tdigest

QS = np.array([0.1, 0.5, 0.9, 0.99], np.float32)


def T(a):
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def N(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _quantiles_close(jm, jw, tm, tw, mins=None, maxs=None):
    qj = N(jtd.quantile(jnp.asarray(N(jm)), jnp.asarray(N(jw)),
                        jnp.asarray(QS),
                        None if mins is None else jnp.asarray(mins),
                        None if maxs is None else jnp.asarray(maxs)))
    qt = N(tdigest.quantile(T(N(tm)), T(N(tw)), T(QS),
                            None if mins is None else T(mins),
                            None if maxs is None else T(maxs)))
    np.testing.assert_allclose(qt, qj, rtol=2e-3, atol=1e-3)


def _packing_ok(m, w):
    m, w = N(m), N(w)
    for r in range(w.shape[0]):
        occ = w[r] > 0
        n = occ.sum()
        assert occ[:n].all() and not occ[n:].any()
        assert (np.diff(m[r, :n]) >= 0).all()
        assert (m[r, n:] == 0).all()


# ---- segment ---------------------------------------------------------

def _seg_batch(rng, rows=64, n=300):
    # pad entries (row_id == rows) exercise the JAX mode="drop" contract
    rid = rng.integers(0, rows + 1, n).astype(np.int32)
    vals = rng.normal(3.0, 2.0, n).astype(np.float32)
    vals[::17] = 0.0
    wts = rng.choice([1.0, 2.0, 10.0], n).astype(np.float32)
    return rid, vals, wts


@pytest.mark.parametrize("fn", ["counter_update", "gauge_update",
                                "histo_stats_update",
                                "histo_stats_update_unit",
                                "counter_dense_update",
                                "gauge_dense_update"])
def test_segment_matches_jax(fn):
    rng = np.random.default_rng(1)
    rows = 64
    rid, vals, wts = _seg_batch(rng, rows)
    if fn == "counter_update":
        st = rng.normal(0, 1, rows).astype(np.float32)
        j = jseg.counter_update(jnp.asarray(st), jnp.asarray(rid),
                                jnp.asarray(vals), jnp.asarray(wts))
        t = segment.counter_update(T(st), T(rid), T(vals), T(wts))
        np.testing.assert_allclose(N(t), N(j), rtol=1e-6)
    elif fn == "gauge_update":
        st = rng.normal(0, 1, rows).astype(np.float32)
        j = jseg.gauge_update(jnp.asarray(st), jnp.asarray(rid),
                              jnp.asarray(vals))
        t = segment.gauge_update(T(st), T(rid), T(vals))
        np.testing.assert_array_equal(N(t), N(j))
    elif fn.startswith("histo_stats_update"):
        st0 = np.asarray(jseg.empty_histo_stats(rows))
        np.testing.assert_array_equal(
            N(segment.empty_histo_stats(rows, "cpu")), st0)
        if fn.endswith("unit"):
            j = jseg.histo_stats_update_unit(
                jnp.asarray(st0), jnp.asarray(rid), jnp.asarray(vals))
            t = segment.histo_stats_update_unit(T(st0), T(rid), T(vals))
        else:
            j = jseg.histo_stats_update(jnp.asarray(st0),
                                        jnp.asarray(rid),
                                        jnp.asarray(vals),
                                        jnp.asarray(wts))
            t = segment.histo_stats_update(T(st0), T(rid), T(vals),
                                           T(wts))
        j, t = N(j), N(t)
        for c in (segment.STAT_MIN, segment.STAT_MAX):
            np.testing.assert_array_equal(t[:, c], j[:, c])
        for c in (segment.STAT_WEIGHT, segment.STAT_SUM,
                  segment.STAT_RSUM):
            np.testing.assert_allclose(t[:, c], j[:, c], rtol=1e-6)
    elif fn == "counter_dense_update":
        st = rng.normal(0, 1, rows).astype(np.float32)
        d = rng.normal(0, 1, rows).astype(np.float32)
        np.testing.assert_array_equal(
            N(segment.counter_dense_update(T(st), T(d))),
            N(jseg.counter_dense_update(jnp.asarray(st),
                                        jnp.asarray(d))))
    else:
        st = rng.normal(0, 1, rows).astype(np.float32)
        d = rng.normal(0, 1, rows).astype(np.float32)
        mask = rng.random(rows) < 0.5
        np.testing.assert_array_equal(
            N(segment.gauge_dense_update(T(st), T(d), T(mask))),
            N(jseg.gauge_dense_update(jnp.asarray(st), jnp.asarray(d),
                                      jnp.asarray(mask))))


# ---- hll ---------------------------------------------------------------

@pytest.mark.parametrize("fn", ["insert_packed", "insert", "union",
                                "merge_rows", "estimate"])
def test_hll_matches_jax(fn):
    rng = np.random.default_rng(2)
    rows, n = 16, 5000
    rid = rng.integers(0, rows + 1, n).astype(np.int32)  # incl. pad
    idx = rng.integers(0, hll.M, n).astype(np.int32)
    rank = rng.integers(1, 30, n).astype(np.int32)
    pk = hll.pack_positions(idx, rank)
    np.testing.assert_array_equal(pk, jhll.pack_positions(idx, rank))
    base = np.zeros((rows, hll.M), np.uint8)
    base[3, :100] = 7
    if fn == "insert_packed":
        j = jhll.insert_packed(jnp.asarray(base), jnp.asarray(rid),
                               jnp.asarray(pk))
        t = hll.insert_packed(T(base), T(rid), T(pk))
        np.testing.assert_array_equal(N(t), N(j))
    elif fn == "insert":
        j = jhll.insert(jnp.asarray(base), jnp.asarray(rid),
                        jnp.asarray(idx), jnp.asarray(rank))
        t = hll.insert(T(base), T(rid), T(idx), T(rank))
        np.testing.assert_array_equal(N(t), N(j))
    elif fn == "union":
        other = rng.integers(0, 9, (rows, hll.M)).astype(np.uint8)
        np.testing.assert_array_equal(
            N(hll.union(T(base), T(other))),
            N(jhll.union(jnp.asarray(base), jnp.asarray(other))))
    elif fn == "merge_rows":
        inc = rng.integers(0, 12, (4, hll.M)).astype(np.uint8)
        rr = np.array([2, 5, 2, rows], np.int32)  # duplicate + pad
        np.testing.assert_array_equal(
            N(hll.merge_rows(T(base), T(rr), T(inc))),
            N(jhll.merge_rows(jnp.asarray(base), jnp.asarray(rr),
                              jnp.asarray(inc))))
    else:
        regs = np.asarray(jhll.insert_packed(
            jnp.asarray(base), jnp.asarray(rid), jnp.asarray(pk)))
        j = N(jhll.estimate(jnp.asarray(regs)))
        t = N(hll.estimate(T(regs)))
        np.testing.assert_allclose(t, j, rtol=1e-6)
        np.testing.assert_allclose(hll.estimate_np(regs),
                                   jhll.estimate_np(regs), rtol=0)
        assert hll._BETA14 == jhll._BETA14 and hll._ALPHA == jhll._ALPHA


# ---- cluster merge -----------------------------------------------------

def _random_case(rng, rows, cap, slots):
    """tests/test_pallas_merge.py's generator."""
    means = np.zeros((rows, cap), np.float32)
    weights = np.zeros((rows, cap), np.float32)
    occ = rng.integers(0, cap // 2, size=rows)
    for r in range(rows):
        vals = np.sort(rng.normal(200.0, 40.0, occ[r])).astype(
            np.float32)
        means[r, :occ[r]] = vals
        weights[r, :occ[r]] = rng.integers(1, 50, occ[r]).astype(
            np.float32)
    bm = rng.normal(200.0, 40.0, (rows, slots)).astype(np.float32)
    bw = (rng.random((rows, slots)) < 0.8).astype(np.float32)
    bm = np.where(bw > 0, bm, 0.0).astype(np.float32)
    return means, weights, bm, bw


def _scale(compression):
    return dict(delta=tdigest._SCALE_MULT * compression,
                tail_coeff=tdigest._TAIL_MULT * compression,
                tail_q0=tdigest._TAIL_Q0, tail_qmin=tdigest._TAIL_QMIN)


@pytest.mark.parametrize("rows,slots", [(16, 64), (32, 512), (8, 616)])
def test_cluster_merge_plain_matches_scatter_path(rows, slots):
    """Plain version vs the JAX scatter merge at compression 100
    (C = 616): ingest widths and the 616 + 616 union."""
    rng = np.random.default_rng(rows + slots)
    cap = tdigest.DEFAULT_CAPACITY
    assert cap == jtd.DEFAULT_CAPACITY == 616
    m, w, bm, bw = _random_case(rng, rows, cap, slots)
    jm, jw = jtd._merge_impl(jnp.asarray(m), jnp.asarray(w),
                             jnp.asarray(bm), jnp.asarray(bw),
                             compression=100.0)
    tm, tw = cluster_merge.cluster_merge(T(m), T(w), T(bm), T(bw),
                                         **_scale(100.0))
    total = w.sum(axis=1) + bw.sum(axis=1)
    np.testing.assert_allclose(N(tw).sum(axis=1), total, rtol=1e-6)
    _packing_ok(tm, tw)
    _quantiles_close(jm, jw, tm, tw)
    assert cluster_merge.launch_count() == 0  # CPU tensors never launch


def test_cluster_merge_plain_matches_pallas_interpret():
    """Plain version vs the Pallas kernel itself (interpret mode) at
    compression 5: C = 40, K = 24, n = 64 keeps the interpreter
    cheap."""
    rng = np.random.default_rng(5)
    cap = tdigest.capacity_for(5.0)
    assert cap == 40
    _plain_vs_pallas_interpret(*_random_case(rng, 8, cap, 24))


def test_cluster_merge_plain_matches_pallas_interpret_unsorted_state():
    """As above, with state rows permuted so that empty slots lie
    between live ones (the kernel's in-row sort branch)."""
    rng = np.random.default_rng(6)
    m, w, bm, bw = _random_case(rng, 8, tdigest.capacity_for(5.0), 24)
    perm = np.argsort(rng.random(m.shape), axis=1)
    m = np.take_along_axis(m, perm, 1)
    w = np.take_along_axis(w, perm, 1)
    key = np.where(w > 0, m, np.inf)
    assert (key[:, 1:] < key[:, :-1]).any()
    _plain_vs_pallas_interpret(m, w, bm, bw)


def _plain_vs_pallas_interpret(m, w, bm, bw):
    pm, pw = pallas_merge.merge_planes(
        jnp.asarray(m), jnp.asarray(w), jnp.asarray(bm), jnp.asarray(bw),
        interpret=True, **_scale(5.0))
    tm, tw = cluster_merge.cluster_merge_plain(T(m), T(w), T(bm), T(bw),
                                               **_scale(5.0))
    np.testing.assert_allclose(N(tw).sum(1), N(pw).sum(1), rtol=1e-6)
    _packing_ok(tm, tw)
    _quantiles_close(pm, pw, tm, tw)


def test_cluster_merge_width_bound():
    assert cluster_merge.supported(616, 512)
    assert cluster_merge.supported(616, 616)
    assert not cluster_merge.supported(1232, 1232)
    for cap in (40, 312, 616):
        assert cluster_merge.max_batch_slots(cap) == \
            pallas_merge.max_batch_slots(cap)


# ---- tdigest ------------------------------------------------------------

def _ranked_batch(rng, rows, n, slots):
    rid = rng.integers(0, rows, n).astype(np.int32)
    order = np.argsort(rid, kind="stable")
    rank = np.empty(n, np.int32)
    srt = rid[order]
    first = np.r_[True, srt[1:] != srt[:-1]]
    start = np.maximum.accumulate(np.where(first, np.arange(n), 0))
    rank[order] = np.arange(n) - start
    keep = rank < slots
    rid, rank = rid[keep], rank[keep]
    vals = rng.gamma(2.0, 30.0, len(rid)).astype(np.float32)
    wts = rng.choice([1.0, 2.0], len(rid)).astype(np.float32)
    pad = 37  # pad entries use row_id == rows
    return (np.r_[rid, np.full(pad, rows, np.int32)],
            np.r_[rank, np.zeros(pad, np.int32)],
            np.r_[vals, np.zeros(pad, np.float32)],
            np.r_[wts, np.zeros(pad, np.float32)])


_INGEST = ["ingest_ranked", "ingest_ranked_unit", "ingest_ranked_rows",
           "ingest_ranked_unit_rows", "add_samples_ranked",
           "add_samples_ranked_unit", "add_samples_ranked_rows",
           "add_samples_ranked_unit_rows"]


@pytest.mark.parametrize("name", _INGEST)
def test_tdigest_ingest_matches_jax(name):
    rng = np.random.default_rng(len(name))
    rows, slots, cap = 32, 64, tdigest.DEFAULT_CAPACITY
    m0, w0, _, _ = _random_case(rng, rows, cap, 1)
    stats0 = np.asarray(jseg.empty_histo_stats(rows))
    sub = name.endswith("_rows")
    unit = "_unit" in name
    with_stats = name.startswith("ingest")
    if sub:
        # 12 touched rows in a 16-row local space (4 pad slots)
        idx = np.r_[rng.choice(rows, 12, replace=False),
                    np.full(4, rows)].astype(np.int32)
        rid, rank, vals, wts = _ranked_batch(rng, 12, 400, slots)
        rid = np.where(rid == 12, 16, rid).astype(np.int32)
        pre = (idx,)
    else:
        rid, rank, vals, wts = _ranked_batch(rng, rows, 900, slots)
        pre = ()
    args = [m0, w0] + ([stats0] if with_stats else []) + list(pre) + [
        rid, rank, vals] + ([] if unit else [wts])
    j = getattr(jtd, name)(*[jnp.asarray(a) for a in args], slots=slots,
                           compression=100.0)
    t = getattr(tdigest, name)(*[T(a) for a in args], slots=slots,
                               compression=100.0)
    np.testing.assert_allclose(N(t[1]).sum(1), N(j[1]).sum(1), rtol=1e-6)
    _packing_ok(t[0], t[1])
    _quantiles_close(j[0], j[1], t[0], t[1])
    if with_stats:
        js, ts = N(j[2]), N(t[2])
        for c in (segment.STAT_MIN, segment.STAT_MAX):
            np.testing.assert_array_equal(ts[:, c], js[:, c])
        for c in (segment.STAT_WEIGHT, segment.STAT_SUM,
                  segment.STAT_RSUM):
            np.testing.assert_allclose(ts[:, c], js[:, c], rtol=1e-6)


@pytest.mark.parametrize("name", ["add_samples_ranked_scan",
                                  "add_samples_ranked_scan_rows",
                                  "merge_dense_scan",
                                  "merge_dense_scan_rows"])
def test_tdigest_deep_scan_matches_jax(name):
    """Deep ingest: a Python loop of merges vs JAX's lax.scan."""
    rng = np.random.default_rng(len(name) + 1)
    rows, slots, nc, cap = 16, 64, 4, tdigest.DEFAULT_CAPACITY
    m0, w0, _, _ = _random_case(rng, rows, cap, 1)
    if name.startswith("merge_dense"):
        pv = rng.gamma(2.0, 30.0, (rows, slots * nc)).astype(np.float32)
        pw = (rng.random((rows, slots * nc)) < 0.7).astype(np.float32)
        pv = np.where(pw > 0, pv, 0).astype(np.float32)
        if name.endswith("_rows"):
            idx = np.r_[np.arange(0, 2 * (rows - 2), 2),
                        [2 * rows, 2 * rows]].astype(np.int32)
            m0 = np.concatenate([m0, m0])
            w0 = np.concatenate([w0, w0])
            args = [m0, w0, idx, pv, pw]
        else:
            args = [m0, w0, pv, pw]
    else:
        rid, rank, vals, wts = _ranked_batch(rng, rows, 3000, slots * nc)
        if name.endswith("_rows"):
            idx = np.arange(rows, dtype=np.int32)[::-1].copy()
            m0 = np.concatenate([m0, m0])
            w0 = np.concatenate([w0, w0])
            args = [m0, w0, idx, rid, rank, vals, wts]
        else:
            args = [m0, w0, rid, rank, vals, wts]
    j = getattr(jtd, name)(*[jnp.asarray(a) for a in args], slots=slots,
                           n_chunks=nc, compression=100.0)
    t = getattr(tdigest, name)(*[T(a) for a in args], slots=slots,
                               n_chunks=nc, compression=100.0)
    np.testing.assert_allclose(N(t[1]).sum(1), N(j[1]).sum(1), rtol=1e-6)
    _packing_ok(t[0], t[1])
    _quantiles_close(j[0], j[1], t[0], t[1])


@pytest.mark.parametrize("name,vdtype", [
    ("ingest_plane_pre_unit", np.float16),
    ("ingest_plane_pre_unit", np.float32),
    ("ingest_plane_pre", np.float32)])
def test_tdigest_plane_pre_matches_jax(name, vdtype):
    """Host-densified plane ingest: the value plane (f16 or f32) is
    widened on the device, the unit weight plane rebuilt from counts,
    the host stats folded in; the same arrays through both packages."""
    rng = np.random.default_rng(len(name) + int(vdtype == np.float16))
    rows, width, cap = 24, 128, tdigest.DEFAULT_CAPACITY
    m0, w0, _, _ = _random_case(rng, rows, cap, 1)
    stats0 = np.asarray(jseg.empty_histo_stats(rows))
    counts = rng.integers(0, width + 1, rows).astype(np.int32)
    counts[3] = 0  # an untouched row
    live = np.arange(width)[None, :] < counts[:, None]
    pv = np.where(live, rng.gamma(2.0, 30.0, (rows, width)),
                  0.0).astype(vdtype)
    pw = np.where(live, rng.choice([1.0, 2.0, 5.0], (rows, width)),
                  0.0).astype(np.float32)
    batch = np.asarray(jseg.empty_histo_stats(rows)).copy()
    v64 = pv.astype(np.float64)
    w64 = pw.astype(np.float64) if name == "ingest_plane_pre" else (
        live.astype(np.float64))
    batch[:, segment.STAT_WEIGHT] = w64.sum(1)
    batch[:, segment.STAT_SUM] = (v64 * w64).sum(1)
    batch[:, segment.STAT_RSUM] = np.where(
        v64 > 0, w64 / np.where(v64 > 0, v64, 1.0), 0.0).sum(1)
    touched = counts > 0
    batch[touched, segment.STAT_MIN] = np.where(
        live, v64, np.inf).min(1)[touched]
    batch[touched, segment.STAT_MAX] = np.where(
        live, v64, -np.inf).max(1)[touched]
    batch = batch.astype(np.float32)
    if name == "ingest_plane_pre_unit":
        args = [m0, w0, stats0, batch, counts, pv]
    else:
        args = [m0, w0, stats0, batch, pv, pw]
    j = getattr(jtd, name)(*[jnp.asarray(a) for a in args],
                           compression=100.0)
    t = getattr(tdigest, name)(*[T(a) for a in args], compression=100.0)
    np.testing.assert_allclose(N(t[1]).sum(1), N(j[1]).sum(1), rtol=1e-6)
    _packing_ok(t[0], t[1])
    _quantiles_close(j[0], j[1], t[0], t[1])
    np.testing.assert_array_equal(N(t[2]), N(j[2]))  # elementwise fold


@pytest.mark.parametrize("method", ["interp", "reference"])
def test_tdigest_readout_matches_jax(method):
    """Quantile readout on identical centroid planes: the same
    arithmetic, so it agrees to f32 rounding (rtol 1e-5)."""
    rng = np.random.default_rng(9)
    m, w, _, _ = _random_case(rng, 24, tdigest.DEFAULT_CAPACITY, 1)
    w[5] = 0.0
    m[5] = 0.0  # an empty row reads NaN in both
    perm = rng.permutation(m.shape[1])  # unsorted planes sort first
    m, w = m[:, perm], w[:, perm]
    mins = np.where(rng.random(24) < 0.5, np.nan,
                    m.min(1) - 1).astype(np.float32)
    maxs = (m.max(1) + 1).astype(np.float32)
    j = N(jtd.quantile(jnp.asarray(m), jnp.asarray(w), jnp.asarray(QS),
                       jnp.asarray(mins), jnp.asarray(maxs),
                       method=method))
    t = N(tdigest.quantile(T(m), T(w), T(QS), T(mins), T(maxs),
                           method=method))
    np.testing.assert_allclose(t, j, rtol=1e-5, equal_nan=True)
    assert np.isnan(t[5]).all()


def test_tdigest_helpers_match_jax():
    rng = np.random.default_rng(4)
    for c in (5.0, 25.0, 100.0, 200.0):
        assert tdigest.capacity_for(c) == jtd.capacity_for(c)
    q = rng.random(1000)
    np.testing.assert_array_equal(tdigest.k_scale_np(q, 100.0),
                                  jtd.k_scale_np(q, 100.0))
    # densify: flat samples -> dense planes by within-row arrival rank
    rid = rng.integers(0, 9, 200).astype(np.int32)  # 8 rows + pad
    vals = rng.gamma(2.0, 3.0, 200).astype(np.float32)
    wts = np.ones(200, np.float32)
    jv, jw = jtd.densify(jnp.asarray(rid), jnp.asarray(vals),
                         jnp.asarray(wts), 8, 16)
    tv, tw = tdigest.densify(T(rid), T(vals), T(wts), 8, 16)
    np.testing.assert_array_equal(N(tv), N(jv))
    np.testing.assert_array_equal(N(tw), N(jw))
    stats = np.asarray(jseg.empty_histo_stats(8))
    js = N(jtd._stats_from_dense(jnp.asarray(stats), jv, jw))
    ts = N(tdigest._stats_from_dense(T(stats), tv, tw))
    np.testing.assert_array_equal(ts[:, 1:3], js[:, 1:3])
    np.testing.assert_allclose(ts, js, rtol=1e-6)
    np.testing.assert_array_equal(
        N(tdigest._combine_row_stats(T(ts), T(js))),
        N(jtd._combine_row_stats(jnp.asarray(ts), jnp.asarray(js))))


# ---- superbatch ------------------------------------------------------------

_SPECS = [
    dict(counter_rows=16, gauge_rows=16),
    dict(histo_n=384, histo_slots=64, histo_sub=256, histo_unit=True,
         histo_stats=True, compression=100.0),
    dict(counter_rows=7, histo_n=256, histo_slots=16, histo_stats=True,
         compression=100.0, pos_n=512),
    dict(plane_rows=8, plane_full=True, gauge_rows=3),
    dict(plane_rows=24, counter_rows=1),
]


@pytest.mark.parametrize("kw", _SPECS)
def test_superbatch_layout_matches_jax(kw):
    """Offsets and header bytes identical to the reference layout."""
    spec, jspec = superbatch.SBSpec(**kw), jsb.SBSpec(**kw)
    off, joff = superbatch.layout(spec), jsb.layout(jspec)
    assert off == joff
    buf = np.zeros(off["total"], np.int32)
    jbuf = np.zeros(off["total"], np.int32)
    superbatch.fill_header(buf, spec, off)
    jsb.fill_header(jbuf, jspec, joff)
    assert buf.tobytes() == jbuf.tobytes()


def test_superbatch_step_matches_jax_fused():
    """One packed buffer through the port's fused step and JAX's."""
    rng = np.random.default_rng(12)
    rows, srows, cap = 32, 8, tdigest.DEFAULT_CAPACITY
    rid, rank, vals, _ = _ranked_batch(rng, rows, 600, 64)
    b = 768
    spec_kw = dict(counter_rows=rows, gauge_rows=rows, histo_n=b,
                   histo_slots=64, histo_unit=True, histo_stats=True,
                   compression=100.0, pos_n=512)
    spec = superbatch.SBSpec(**spec_kw)
    off = superbatch.layout(spec)
    buf = np.zeros(off["total"], np.int32)
    superbatch.fill_header(buf, spec, off)
    buf[off["counter"]:off["counter"] + rows].view(np.float32)[:] = \
        rng.normal(0, 1, rows).astype(np.float32)
    buf[off["gauge_dense"]:off["gauge_dense"] + rows].view(
        np.float32)[:] = rng.normal(0, 1, rows).astype(np.float32)
    buf[off["gauge_mask"]:off["gauge_mask"] + rows] = rng.integers(
        0, 2, rows)
    n = len(rid)
    buf[off["histo_rows"]:off["histo_rows"] + b] = np.r_[
        rid, np.full(b - n, rows)]
    buf[off["histo_rank"]:off["histo_rank"] + b] = np.r_[
        rank, np.zeros(b - n)]
    buf[off["histo_vals"]:off["histo_vals"] + b].view(np.float32)[:] = \
        np.r_[vals, np.zeros(b - n, np.float32)]
    buf[off["pos_rows"]:off["pos_rows"] + 512] = rng.integers(
        0, srows + 1, 512)
    buf[off["pos_pk"]:off["pos_pk"] + 512] = hll.pack_positions(
        rng.integers(0, hll.M, 512), rng.integers(1, 20, 512))
    state = [np.zeros(rows, np.float32), np.ones(rows, np.float32),
             np.zeros((rows, cap), np.float32),
             np.zeros((rows, cap), np.float32),
             np.asarray(jseg.empty_histo_stats(rows)),
             np.zeros((srows, hll.M), np.uint8)]
    j = jsb._fused(jsb.SBSpec(**spec_kw),
                   *[jnp.asarray(a) for a in state], jnp.asarray(buf))
    t = superbatch.step(spec, *[T(a) for a in state], T(buf))
    np.testing.assert_array_equal(N(t[0]), N(j[0]))
    np.testing.assert_array_equal(N(t[1]), N(j[1]))
    np.testing.assert_array_equal(N(t[5]), N(j[5]))
    np.testing.assert_array_equal(N(t[4])[:, 1:3], N(j[4])[:, 1:3])
    np.testing.assert_allclose(N(t[3]).sum(1), N(j[3]).sum(1), rtol=1e-6)
    _quantiles_close(j[2], j[3], t[2], t[3])


def test_double_buffer_alternates():
    bufs = superbatch.DoubleBuffer()
    a = bufs.take(10)
    b = bufs.take(10)
    c = bufs.take(2000)
    assert a.dtype == np.int32 and len(c) == 2000
    assert not np.shares_memory(a, b)
    assert not np.shares_memory(b, c)
