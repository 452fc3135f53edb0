"""The cluster merge of S packed digests side by side: sorted runs.

A mesh flush merge gathers its S shards' digest slots side by side, and
a collective import fold's union its S places'; each digest is packed
and mean-sorted, so the batch is S non-decreasing runs, each with its
live slots first.  On the card the kernel merges such runs by rank
(``cluster_merge.MAX_RUNS`` of them at most) where it used to run a
bitonic sort over the whole batch; the result must be the long sort's,
bit for bit.  Real DogStatsD timers are integer milliseconds, so equal
means within and across shards are the rule, and the tie order (the
stable sort's: state first, then column order) is what decides a
cluster boundary.

On the CPU the port's merge (``tdigest._merge_impl``, the plain
version) is held to the JAX package's ``_merge_impl`` on the same
seeded planes: S in {2, 3, 4, 8, 24} runs of integer means with empty
shards, zero, negative-zero and subnormal keys and subnormal weights,
into a zero state (a mesh flush) and a live one (a fold's union); and a
24-shard mesh fed integer-valued samples is held to the JAX mesh of the
same size (in a child with 24 virtual devices, as
``test_torch_spill_merge.py`` runs it).  On the card the runs merge is
held to the long sort (``cluster_merge._launch(..., max_runs=0)``) bit
for bit, and the kernel to ``cluster_merge_plain``:

    python -m pytest --noconftest -q -m cuda tests/test_torch_runs_merge.py

Tolerances: weight mass rtol 1e-6 (f32 sums in another order);
quantiles rtol 2e-3 / atol 1e-3, the reference's merge tolerance
(tests/test_pallas_merge.py).
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from veneur_tpu_torch.ops import cluster_merge, segment, tdigest

C100 = tdigest.capacity_for(100.0)          # 616
QTOL = dict(rtol=2e-3, atol=1e-3)
QS = torch.tensor([0.01, 0.1, 0.5, 0.9, 0.99], dtype=torch.float32)
KW = dict(delta=tdigest._SCALE_MULT * 100.0,
          tail_coeff=tdigest._TAIL_MULT * 100.0,
          tail_q0=tdigest._TAIL_Q0, tail_qmin=tdigest._TAIL_QMIN)
ODD_KEYS = np.array([0.0, -0.0, 1e-40, -1e-40], np.float32)


def _digests(rng, rows: int, cap: int = C100):
    """Packed digests of integer means, up to half full, a fifth of
    them empty; weights 1-59."""
    occ = rng.integers(0, cap // 2 + 1, rows)
    occ[rng.random(rows) < 0.2] = 0
    live = np.arange(cap)[None, :] < occ[:, None]
    m = np.sort(np.where(live, np.round(rng.normal(200.0, 40.0,
                                                   (rows, cap))), np.inf),
                axis=1)
    return (np.where(live, m, 0).astype(np.float32),
            np.where(live, rng.integers(1, 60, (rows, cap)),
                     0).astype(np.float32))


def _runs(rng, rows: int, n_runs: int):
    """``n_runs`` digests side by side, with odd keys where each run
    stays sorted: in every fifth row a zero, a negative zero or a
    subnormal key at a live run's first slot, and subnormal weights
    (read as empty slots) at every third run's first slot."""
    parts = [_digests(rng, rows) for _ in range(n_runs)]
    bm = np.concatenate([p[0] for p in parts], axis=1)
    bw = np.concatenate([p[1] for p in parts], axis=1)
    for j in range(n_runs):
        c = j * C100
        sel = (np.arange(rows) % 5 == 0) & (bw[:, c] > 0)
        bm[sel, c] = ODD_KEYS[j % 4]
        if j % 3 == 1:
            bw[sel, c] = np.float32(1e-40)
    return bm, bw


def _case(n_runs: int, state: str, rows: int = 24):
    rng = np.random.default_rng(1000 * n_runs + len(state))
    bm, bw = _runs(rng, rows, n_runs)
    if state == "zero":
        z = np.zeros((rows, C100), np.float32)
        return z, z.copy(), bm, bw
    return (*_digests(rng, rows), bm, bw)


def _mass(w, bw):
    return (segment.ftz(torch.from_numpy(w)).double().sum(1) +
            segment.ftz(torch.from_numpy(bw)).double().sum(1))


def _contract(m, w, total):
    tiny = torch.finfo(torch.float32).tiny
    assert not bool(((m.abs() < tiny) & (m != 0)).any())
    assert not bool(((w.abs() < tiny) & (w != 0)).any())
    torch.testing.assert_close(w.double().sum(1), total.to(w.device),
                               rtol=1e-6, atol=0)
    occ = w > 0
    slot = torch.arange(w.shape[1], device=w.device)[None, :]
    assert torch.equal(slot < occ.sum(dim=1, keepdim=True), occ)
    assert bool((m[~occ] == 0).all())
    big = torch.where(occ, m, torch.full_like(m, float("inf")))
    assert bool((big[:, 1:] >= big[:, :-1]).all())


RUNS = [2, 3, 4, 8, 24]
STATES = ["zero", "live"]


def test_cases_hold_ties_empty_shards_and_odd_keys():
    """The generator gives what the cases claim: equal means within and
    across runs, empty shards, and every odd key in some row."""
    m, w, bm, bw = _case(8, "live")
    live = bw > 0
    assert (~live.reshape(-1, 8, C100).any(2)).any()      # empty shards
    row = bm[1][live[1]]
    assert len(np.unique(row)) < len(row)                 # ties
    first = bm[::5, ::C100]
    assert (np.signbit(first) & (first == 0)).any()       # -0
    assert ((first != 0) & (np.abs(first) < 1.2e-38)).any()  # subnormal
    assert ((bw > 0) & (bw < 1.2e-38)).any()              # subnormal w
    assert (w > 0).any()


@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("n_runs", RUNS)
def test_runs_merge_matches_jax(n_runs, state):
    """The port's ``_merge_impl`` against JAX ``_merge_impl`` on S
    tie-heavy runs side by side into a zero or a live state: mass,
    the packing contract, quantiles."""
    import jax.numpy as jnp
    from veneur_tpu.ops import tdigest as jtd
    m, w, bm, bw = _case(n_runs, state)
    pm, pw = tdigest._merge_impl(*(torch.from_numpy(x)
                                   for x in (m, w, bm, bw)), 100.0)
    jm, jw = jtd._merge_no_donate(*(jnp.asarray(x)
                                    for x in (m, w, bm, bw)),
                                  compression=100.0)
    jm, jw = (torch.from_numpy(np.array(x)) for x in (jm, jw))
    total = _mass(w, bw)
    _contract(pm, pw, total)
    torch.testing.assert_close(jw.double().sum(1), total, rtol=1e-6,
                               atol=0)
    torch.testing.assert_close(tdigest.quantile(pm, pw, QS),
                               tdigest.quantile(jm, jw, QS),
                               equal_nan=True, **QTOL)


def test_max_runs_is_the_kernels_limit_and_checked():
    """The wrapper's ``MAX_RUNS`` is the C source's ``kMaxRuns``; a
    ``max_runs`` outside 0..MAX_RUNS or a malformed ``spilled`` counter
    is refused before anything is built or launched."""
    src = cluster_merge.SOURCE.read_text()
    assert re.search(r"constexpr int kMaxRuns = (\d+);", src).group(1) == \
        str(cluster_merge.MAX_RUNS)
    a = [torch.from_numpy(x) for x in _case(2, "zero", rows=2)]
    for bad in (-1, cluster_merge.MAX_RUNS + 1):
        with pytest.raises(ValueError, match="max_runs"):
            cluster_merge._launch("wide", *a, **KW, max_runs=bad)
    with pytest.raises(ValueError, match="spilled"):
        cluster_merge._launch("spill", *a, **KW,
                              spilled=torch.zeros(2, dtype=torch.int32))


def _mesh_input(n: int) -> dict:
    """Every shard's samples from one seed: integer-valued values (a
    timer's milliseconds) over 16 rows, so shards' centroids tie."""
    from veneur_tpu.utils import hashing
    rng = np.random.default_rng(2416)
    arr = {}
    for s in range(n):
        p = f"{s}_"
        arr[p + "rows"] = rng.integers(0, 16, 40, dtype=np.int32)
        arr[p + "vals"] = rng.integers(1, 12, 40).astype(np.float32)
        arr[p + "cwts"] = np.full(40, 2.0, np.float32)
        arr[p + "hwts"] = rng.integers(1, 4, 40).astype(np.float32)
        idx, rank = hashing.hash_members(
            [f"t{s}-{i}".encode() for i in range(30)])
        arr[p + "idx"] = idx.astype(np.int32)
        arr[p + "rank"] = rank.astype(np.int32)
    return arr


def test_24_shard_mesh_of_integer_timers_matches_jax(tmp_path):
    """A port mesh of 24 shards x 1 series on CPU places, fed integer
    values, against the JAX mesh of the same size: its flush merge
    gathers 616 + 24 x 616 slots of tied centroids (a spill-route width
    on the card)."""
    import os
    import subprocess
    import sys
    import textwrap

    import test_torch_spill_merge as tsm
    from veneur_tpu_torch.parallel import (ShardedAggregator, ShardedConfig,
                                           make_mesh)
    n = 24
    arr = _mesh_input(n)
    np.savez(tmp_path / "in.npz", **arr)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=24",
               PYTHONPATH=str(tsm.ROOT))
    res = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(tsm._JAX_CHILD),
         str(tmp_path / "in.npz"), str(tmp_path / "out.npz"), str(n),
         tsm._STAGE_SRC, repr(tsm._MESH_CFG), repr(tsm._MESH_QS)],
        capture_output=True, text=True, timeout=600, env=env, cwd=tsm.ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    j = {k.split(".", 1)[1]: v for k, v in np.load(tmp_path /
                                                   "out.npz").items()}
    ns = {}
    exec(tsm._STAGE_SRC, ns)
    p = ShardedAggregator(make_mesh(["cpu"] * n, n_shard=n),
                          ShardedConfig(**tsm._MESH_CFG))
    assert cluster_merge.route(C100, n * C100) == "spill"
    ns["stage_all"](p, arr, n)
    p.step()
    got = {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
           for k, v in p.flush(qs=tsm._MESH_QS).items()}
    for k in ("gauges", "hll"):
        assert np.array_equal(j[k], got[k]), k
    np.testing.assert_allclose(got["counters"], j["counters"], rtol=1e-6)
    assert np.array_equal(j["histo_stats"][:, 1:3],
                          got["histo_stats"][:, 1:3])
    np.testing.assert_allclose(got["histo_weights"].sum(1),
                               j["histo_weights"].sum(1), rtol=1e-6)
    np.testing.assert_allclose(got["quantiles"], j["quantiles"], **QTOL)
    assert got["histo_stats"][:, 0].sum() > 0


# ---- on the card -------------------------------------------------------

def _ftz(x):
    return np.where(np.abs(x) < np.finfo(np.float32).tiny,
                    np.copysign(np.float32(0), x), x)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("n_runs", RUNS)
def test_runs_merge_equals_the_long_sort_on_the_card(n_runs, state):
    """The runs merge and the long sort (``max_runs=0``) on the route
    the width takes, and on the spill route too: equal bit for bit.  Two
    rows carry a NaN key, negative and positive; the kernel reads a NaN
    mean as +inf, so both rows take the long sort either way, and their
    output is the same from launch to launch (a NaN compared as a float
    once left merged slots unwritten)."""
    _need_cuda()
    m, w, bm, bw = _case(n_runs, state, rows=256)
    bm[3, C100] = np.uint32(0xffc00000).view(np.float32)
    bw[3, C100] = 7.0
    bm[4, 0], bw[4, 0] = np.float32(np.nan), 7.0
    bw[4, 1:C100] = 0.0
    a = [torch.from_numpy(x).cuda() for x in (m, w, bm, bw)]
    for way in {cluster_merge.route(C100, bm.shape[1]), "spill"}:
        if way == "kernel":
            continue
        runs = cluster_merge._launch(way, *a, **KW)
        long_sort = cluster_merge._launch(way, *a, **KW, max_runs=0)
        torch.cuda.synchronize()
        for x, y in zip(runs, long_sort):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32)), way


@pytest.mark.cuda
@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("n_runs", RUNS)
def test_kernel_matches_plain_on_runs(n_runs, state):
    """``cluster_merge`` on the card against ``cluster_merge_plain`` on
    the same tie-heavy runs: the contract and the quantiles."""
    _need_cuda()
    a = [torch.from_numpy(x).cuda() for x in _case(n_runs, state,
                                                   rows=256)]
    km, kw = cluster_merge.cluster_merge(*a, **KW)
    pm, pw = cluster_merge.cluster_merge_plain(*a, **KW)
    torch.cuda.synchronize()
    _contract(km, kw, segment.ftz(a[1]).double().sum(1) +
              segment.ftz(a[3]).double().sum(1))
    qs = QS.cuda()
    torch.testing.assert_close(tdigest.quantile(km, kw, qs),
                               tdigest.quantile(pm, pw, qs),
                               equal_nan=True, **QTOL)


@pytest.mark.cuda
def test_spill_rows_past_the_room_merge_in_global_memory():
    """Rows whose live union passes the spill route's shared-memory
    room, or that hold a key compaction leaves alone (here -0 among
    equal weights), merge in global memory (counted), the rest on chip,
    and both give the wide route's bits where the row fits one CTA."""
    _need_cuda()
    rng = np.random.default_rng(77)
    rows = 512
    m, w = _digests(rng, rows)
    bm, bw = _runs(rng, rows, 16)
    full = np.arange(rows) % 4 == 0
    bw[full] = np.where(bw[full] > 0, bw[full], 1.0)   # 9,856 live slots
    bm[full] = np.sort(np.round(rng.normal(200, 40, (full.sum(),
                                                     16 * C100))), 1)
    equal = np.arange(rows) % 7 == 3                   # unit weights
    bw[equal] = np.where(bw[equal] > 0, 1.0, 0.0)
    assert 16 * C100 > cluster_merge.spill_room()
    live = _ftz(bw) > 0
    neg_zero = (live & (_ftz(bm) == 0) & np.signbit(_ftz(bm))).any(1)
    want = full | (neg_zero & equal)
    assert (neg_zero & equal & ~full).any() and (neg_zero & ~equal).any()
    a = [torch.from_numpy(np.ascontiguousarray(x)).cuda()
         for x in (m, w, bm, bw)]
    spilled = torch.zeros(1, dtype=torch.int32, device="cuda")
    sm, sw = cluster_merge._launch("spill", *a, **KW, spilled=spilled)
    wm, ww = cluster_merge._launch("wide", *a, **KW)
    torch.cuda.synchronize()
    assert int(spilled) == int(want.sum())
    for x, y in ((sm, wm), (sw, ww)):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
