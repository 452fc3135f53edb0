"""The cluster merge past one CTA's shared memory: the spill route.

A merge row takes ``row_bytes(C, K)`` of working set.  Where that fits
one CTA's dynamic shared memory the kernel holds the row there (the
``kernel`` and ``wide`` routes); past it, on the ``spill`` route, the
same body runs on the row's live slots compacted into shared memory, or
over a scratch slice in global memory where they do not fit (counted as
``cluster_merge.spill``).  The reference never refuses a width: past
its Pallas bound it takes its XLA sort + scatter merge.  So on the CPU
the port is held to the JAX package where the spill route's widths
arise: a mesh global's flush merge of 24 and 32 shards (the JAX mesh
runs in a subprocess with 32 virtual devices, since conftest gives this
process 8), ``_merge_impl`` at (R, 616 + 24 x 616), and a
``tpu_compression: 2500`` server (capacity 15,112).  The route rule is
checked against the H100's limit (``H100_MAX_DYN``).  On the card the
spill route is held to ``cluster_merge_plain``, to the wide route bit
for bit where a row fits both, and a 24-shard mesh server to a CPU one.

Tolerances: order-free planes (gauges, min/max, HLL registers) bit for
bit; sums rtol 1e-6; percentiles rtol 2e-3 / atol 1e-3 (the
reference's merge tolerance, tests/test_pallas_merge.py).

The JAX package is imported inside the tests that compare with it; the
card's cases run with

    python -m pytest --noconftest -q -m cuda tests/test_torch_spill_merge.py
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from veneur_tpu_torch import observe
from veneur_tpu_torch.core.config import read_config
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.ops import cluster_merge, tdigest
from veneur_tpu_torch.parallel import (ShardedAggregator, ShardedConfig,
                                       make_mesh)

ROOT = Path(__file__).resolve().parent.parent
C100 = tdigest.capacity_for(100.0)          # 616
C2500 = tdigest.capacity_for(2500.0)        # 15,112
QTOL = dict(rtol=2e-3, atol=1e-3)
QS = torch.tensor([0.01, 0.1, 0.5, 0.9, 0.99], dtype=torch.float32)


def _scale(compression: float) -> dict:
    return dict(delta=tdigest._SCALE_MULT * compression,
                tail_coeff=tdigest._TAIL_MULT * compression,
                tail_q0=tdigest._TAIL_Q0, tail_qmin=tdigest._TAIL_QMIN)


def _digests(rng, rows: int, cap: int, fill: float = 0.5):
    """Packed, mean-sorted digest rows up to ``fill`` full, weighted."""
    occ = rng.integers(0, max(1, int(cap * fill)) + 1, rows)
    live = np.arange(cap)[None, :] < occ[:, None]
    m = np.sort(np.where(live, rng.gamma(2.0, 30.0, (rows, cap)), np.inf),
                axis=1)
    return (np.where(live, m, 0).astype(np.float32),
            np.where(live, rng.integers(1, 60, (rows, cap)),
                     0).astype(np.float32))


def _runs(rng, rows: int, n_runs: int, cap: int = C100):
    """A mesh flush merge's batch: ``n_runs`` shards' digest slots side
    by side, each run packed and mean-sorted as a shard writes it."""
    parts = [_digests(rng, rows, cap) for _ in range(n_runs)]
    return (np.concatenate([p[0] for p in parts], axis=1),
            np.concatenate([p[1] for p in parts], axis=1))


# ---- the route rule --------------------------------------------------

def _layout_bytes(cap: int, k: int) -> int:
    """The C source's ``layout(cap, k_in).bytes()``, written out."""
    wa = -(-(-(-cap // 4) * 4 + k) // 4) * 4
    sort_n = 128
    while sort_n < max(cap, k):
        sort_n *= 2
    return 4 * (2 * wa + 2 * max(wa, sort_n))


@pytest.mark.parametrize("cap", [8, 616, 1824, 3032, 6056, 15112])
def test_row_bytes_is_the_c_layout(cap):
    for k in (1, 7, 8, 96, 512, 616, 4928, 11704, 12320, 19712):
        assert cluster_merge.row_bytes(cap, k) == _layout_bytes(cap, k)
    # the mesh flush merge at S = 19 and 20 shards, by hand
    assert cluster_merge.row_bytes(616, 19 * 616) == \
        (2 * 12320 + 2 * 16384) * 4 == 229_632
    assert cluster_merge.row_bytes(616, 20 * 616) == \
        (2 * 12936 + 2 * 16384) * 4 == 234_560


def test_route_against_the_references_rule_and_the_h100_limit():
    """``kernel`` exactly where the reference's ``pallas_merge.supported``
    holds; past it, with an H100's limit, ``wide`` through S = 19 shards
    of 616 slots and ``spill`` from S = 20; compression 2500 at K = 512
    spills; the first compression whose K = 512 merge spills."""
    from veneur_tpu.ops import pallas_merge
    lim = cluster_merge.H100_MAX_DYN
    for cap in (616, 1824, 3032, 6056, 15112):
        for k in (1, 64, 512, 616, 1432, 1433, 4928, 14784, 19712):
            want = pallas_merge.supported(cap, k)
            assert (cluster_merge.route(cap, k) == "kernel") == want
            if not want:
                assert cluster_merge.route(cap, k) == (
                    "wide" if cluster_merge.row_bytes(cap, k) <= lim
                    else "spill")
    for s in range(2, 20):
        assert cluster_merge.route(616, s * 616) in ("kernel", "wide")
    for s in (20, 24, 32, 64):
        assert cluster_merge.route(616, s * 616) == "spill"
    assert cluster_merge.route(C2500, 512) == "spill"
    assert not cluster_merge.fits(C2500, 512)
    spills = [c for c in range(1800, 2101, 4)
              if cluster_merge.route(tdigest.capacity_for(c), 512) == "spill"]
    assert spills[0] == 2012 and tdigest.capacity_for(2012) == 12168


def test_spill_launch_name_and_cpu_plain():
    """The spill route is counted under its own name; a CPU tensor of
    a spill width runs the plain version and counts nothing."""
    assert cluster_merge.LAUNCH_NAMES["spill"] == "cluster_merge.spill"
    assert len(set(cluster_merge.LAUNCH_NAMES.values())) == 3
    rng = np.random.default_rng(5)
    m, w = _digests(rng, 4, C100)
    bm, bw = _runs(rng, 4, 24)
    a = [torch.from_numpy(x) for x in (m, w, bm, bw)]
    before = observe.REGISTRY.launches()
    om, ow = cluster_merge.cluster_merge(*a, **_scale(100.0))
    pm, pw = cluster_merge.cluster_merge_plain(*a, **_scale(100.0))
    assert torch.equal(om, pm) and torch.equal(ow, pw)
    assert observe.REGISTRY.launches() == before


# ---- against the JAX package on the CPU --------------------------------

def test_merge_impl_at_the_24_shard_flush_width_matches_jax():
    """The port's ``_merge_impl`` on a zero state and on a live state
    against JAX ``tdigest._merge_impl`` on the same gathered arrays at
    (R, 616 + 24 x 616)."""
    import jax.numpy as jnp
    from veneur_tpu.ops import tdigest as jtd
    rng = np.random.default_rng(24)
    rows = 32
    bm, bw = _runs(rng, rows, 24)
    for m, w in ((np.zeros((rows, C100), np.float32),
                  np.zeros((rows, C100), np.float32)),
                 _digests(rng, rows, C100)):
        pm, pw = tdigest._merge_impl(*(torch.from_numpy(x)
                                       for x in (m, w, bm, bw)), 100.0)
        jm, jw = jtd._merge_no_donate(*(jnp.asarray(x)
                                        for x in (m, w, bm, bw)),
                                      compression=100.0)
        jm, jw = (torch.from_numpy(np.array(x)) for x in (jm, jw))
        total = w.astype(np.float64).sum(1) + bw.astype(np.float64).sum(1)
        np.testing.assert_allclose(pw.double().sum(1).numpy(), total,
                                   rtol=1e-6)
        np.testing.assert_allclose(jw.double().sum(1).numpy(), total,
                                   rtol=1e-6)
        torch.testing.assert_close(tdigest.quantile(pm, pw, QS),
                                   tdigest.quantile(jm, jw, QS), **QTOL)


_MESH_CFG = dict(rows=32, set_rows=4, slots=16, batch=64)
_MESH_QS = (0.5, 0.9, 0.99)

# the staging both meshes run, from the same arrays (exec'd in the JAX
# child too)
_STAGE_SRC = """
def stage_all(a, arr, n):
    for s in range(n):
        p = f"{s}_"
        a.stage(s, counter_rows=arr[p + "rows"], counter_vals=arr[p + "vals"],
                counter_wts=arr[p + "cwts"], histo_rows=arr[p + "rows"],
                histo_vals=arr[p + "vals"], histo_wts=arr[p + "hwts"],
                rsum_rows=arr[p + "rows"][:3], rsum_vals=arr[p + "vals"][:3])
        a.stage(s, gauge_rows=arr[p + "rows"][:6],
                gauge_vals=arr[p + "vals"][:6], gauge_ticket=a.next_ticket(6))
        a.stage(s, set_rows=arr[p + "rows"][:30] % 4, set_idx=arr[p + "idx"],
                set_rank=arr[p + "rank"])
"""

_JAX_CHILD = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from veneur_tpu.parallel import ShardedAggregator, ShardedConfig, make_mesh
exec(sys.argv[4])
arr = dict(np.load(sys.argv[1]))
out = {}
for n in map(int, sys.argv[3].split(",")):
    a = ShardedAggregator(make_mesh(jax.devices()[:n], n_shard=n),
                          ShardedConfig(**eval(sys.argv[5])))
    stage_all(a, arr, n)
    a.step()
    for k, v in a.flush(qs=eval(sys.argv[6])).items():
        out[f"{n}.{k}"] = np.asarray(v)
np.savez(sys.argv[2], **out)
"""


def _mesh_input(n_max: int) -> dict:
    """Every shard's samples, from one seed: 40 samples over 16 rows a
    shard (counters at rate 0.5, histograms, gauges, the reciprocal
    sums) and 30 set members."""
    from veneur_tpu.utils import hashing
    rng = np.random.default_rng(2432)
    arr = {}
    for s in range(n_max):
        p = f"{s}_"
        arr[p + "rows"] = rng.integers(0, 16, 40, dtype=np.int32)
        arr[p + "vals"] = rng.gamma(2.0, 3.0, 40).astype(np.float32)
        arr[p + "cwts"] = np.full(40, 2.0, np.float32)
        arr[p + "hwts"] = rng.integers(1, 4, 40).astype(np.float32)
        idx, rank = hashing.hash_members(
            [f"m{s}-{i}".encode() for i in range(30)])
        arr[p + "idx"] = idx.astype(np.int32)
        arr[p + "rank"] = rank.astype(np.int32)
    return arr


@pytest.fixture(scope="module")
def jax_meshes(tmp_path_factory):
    """The JAX meshes of 24 and 32 shards x 1 series, flushed in a child
    with 32 virtual CPU devices, and the input they took."""
    d = tmp_path_factory.mktemp("spill_mesh")
    arr = _mesh_input(32)
    np.savez(d / "in.npz", **arr)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=32",
               PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_JAX_CHILD),
         str(d / "in.npz"), str(d / "out.npz"), "24,32", _STAGE_SRC,
         repr(_MESH_CFG), repr(_MESH_QS)],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    return arr, dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("n", [24, 32])
def test_mesh_of_many_shards_matches_jax(jax_meshes, n):
    """A port mesh of ``n`` shards x 1 series on CPU places against the
    JAX mesh of the same size: its flush merge gathers 616 + n x 616
    slots, a spill-route width on the card."""
    arr, jout = jax_meshes
    ns = {}
    exec(_STAGE_SRC, ns)
    p = ShardedAggregator(make_mesh(["cpu"] * n, n_shard=n),
                          ShardedConfig(**_MESH_CFG))
    assert p.mesh.shape == {"shard": n, "series": 1}
    assert cluster_merge.route(C100, n * C100) == "spill"
    ns["stage_all"](p, arr, n)
    p.step()
    pout = {k: (v.numpy() if isinstance(v, torch.Tensor) else
                np.asarray(v))
            for k, v in p.flush(qs=_MESH_QS).items()}
    j = {k.split(".", 1)[1]: v for k, v in jout.items()
         if k.startswith(f"{n}.")}
    for k in ("gauges", "hll"):
        assert np.array_equal(j[k], pout[k]), k
    np.testing.assert_allclose(pout["counters"], j["counters"], rtol=1e-6)
    assert np.array_equal(j["histo_stats"][:, 1:3],
                          pout["histo_stats"][:, 1:3])
    for c in (0, 3, 4):
        np.testing.assert_allclose(pout["histo_stats"][:, c],
                                   j["histo_stats"][:, c], rtol=1e-6)
    np.testing.assert_allclose(pout["histo_weights"].sum(1),
                               j["histo_weights"].sum(1), rtol=1e-6)
    np.testing.assert_allclose(pout["quantiles"], j["quantiles"], **QTOL)
    np.testing.assert_allclose(pout["hll_estimate"], j["hll_estimate"],
                               rtol=1e-6)
    assert pout["histo_stats"][:, 0].sum() > 0


_C2500 = {"interval": "60s", "hostname": "h", "tpu_counter_rows": 32,
          "tpu_gauge_rows": 32, "tpu_histo_rows": 32, "tpu_set_rows": 4,
          "tpu_compression": 2500.0, "tpu_overload": False}


def _stream(seed: int = 25) -> list[bytes]:
    rng = np.random.default_rng(seed)
    out = []
    for k in range(6):
        lines = [f"deep{k}:{v:.4f}|ms".encode()
                 for v in rng.gamma(2.0, 30.0, 2400)]
        out += [b"\n".join(lines[i:i + 100])
                for i in range(0, len(lines), 100)]
    out.append(b"deep.hits:5|c\ndeep.depth:3|g")
    return out


def _flush(srv) -> dict:
    try:
        for pkt in _stream():
            srv.handle_packet(pkt)
        return {(m.name, m.tags): m.value for m in srv.flush_once().metrics
                if not m.name.startswith("veneur.")}
    finally:
        srv.shutdown()


def _assert_close(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    assert any(k[0] == "deep0.99percentile" for k in got)
    for key, w in want.items():
        if key[0].endswith("percentile"):
            np.testing.assert_allclose(got[key], w, err_msg=str(key),
                                       **QTOL)
        else:
            assert got[key] == w, key


def test_compression_2500_server_matches_jax():
    """A port server at ``tpu_compression: 2500`` (capacity 15,112: every
    full-width timer merge spills on the card) flushes what the JAX
    server flushes, on the CPU."""
    from veneur_tpu.core.config import read_config as jread_config
    from veneur_tpu.core.server import Server as JServer
    assert tdigest.capacity_for(2500.0) == C2500
    got = _flush(Server(read_config(data=_C2500), device="cpu"))
    want = _flush(JServer(jread_config(data=_C2500)))
    _assert_close(got, want)


# ---- on the card -------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _spill_case(name: str):
    """(means, weights, new_means, new_weights, compression) for the
    spill route's paths, at a few hundred rows."""
    rng = np.random.default_rng(len(name) * 7)
    rows = 384
    if name == "mesh_flush_s24":
        z = np.zeros((rows, C100), np.float32)
        return (z, z.copy(), *_runs(rng, rows, 24), 100.0)
    if name == "mesh_flush_s32":
        z = np.zeros((rows, C100), np.float32)
        return (z, z.copy(), *_runs(rng, rows, 32), 100.0)
    if name == "fold_union_24_live":
        return (*_digests(rng, rows, C100), *_runs(rng, rows, 24), 100.0)
    m, w = _digests(rng, rows, C2500, fill=0.3)
    bw = (rng.random((rows, 512)) < 0.8).astype(np.float32)
    bm = np.where(bw > 0, rng.gamma(2.0, 30.0, (rows, 512)),
                  0).astype(np.float32)
    if name == "c2500_unsorted_state":
        perm = np.argsort(rng.random((rows, C2500)), axis=1)
        m = np.take_along_axis(m, perm, 1)
        w = np.take_along_axis(w, perm, 1)
    return m, w, bm, bw, 2500.0


SPILL_CASES = ["mesh_flush_s24", "mesh_flush_s32", "fold_union_24_live",
               "c2500_unit", "c2500_unsorted_state"]


def _contract(m, w, total):
    tiny = torch.finfo(torch.float32).tiny
    assert not bool(((m.abs() < tiny) & (m != 0)).any())
    assert not bool(((w.abs() < tiny) & (w != 0)).any())
    torch.testing.assert_close(w.double().sum(1), total, rtol=1e-6, atol=0)
    occ = w > 0
    slot = torch.arange(w.shape[1], device=w.device)[None, :]
    assert torch.equal(slot < occ.sum(dim=1, keepdim=True), occ)
    assert bool((m[~occ] == 0).all())
    big = torch.where(occ, m, torch.full_like(m, float("inf")))
    assert bool((big[:, 1:] >= big[:, :-1]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", SPILL_CASES)
def test_spill_route_matches_plain(name):
    _need_cuda()
    *arrays, comp = _spill_case(name)
    a = [torch.from_numpy(x).cuda() for x in arrays]
    assert cluster_merge.route(a[0].shape[1], a[2].shape[1]) == "spill"
    before = observe.REGISTRY.launches().get("cluster_merge.spill", 0)
    km, kw = cluster_merge.cluster_merge(*a, **_scale(comp))
    pm, pw = cluster_merge.cluster_merge_plain(*a, **_scale(comp))
    torch.cuda.synchronize()
    assert observe.REGISTRY.launches()["cluster_merge.spill"] == before + 1
    _contract(km, kw, a[1].double().sum(1) + a[3].double().sum(1))
    qs = QS.cuda()
    torch.testing.assert_close(tdigest.quantile(km, kw, qs),
                               tdigest.quantile(pm, pw, qs), equal_nan=True,
                               **QTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(616, 8 * 616, "runs", 4096),
                                   (1824, 512, "unit", 512),
                                   (3032, 512, "unsorted", 512)])
def test_wide_and_spill_routes_bit_equal(shape):
    """A row that fits one CTA, through both routes: the same body, so
    the same bits (the S-run batch past 2048 keys takes the shared-memory
    sort on the wide route and the tiled one on the spill route; at 4,096
    rows the spill grid's CTAs loop over several rows each)."""
    _need_cuda()
    cap, k, kind, rows = shape
    rng = np.random.default_rng(cap + k)
    m, w = _digests(rng, rows, cap)
    if kind == "runs":
        bm, bw = _runs(rng, rows, k // C100)
    else:
        bw = (rng.random((rows, k)) < 0.8).astype(np.float32)
        bm = np.where(bw > 0, rng.gamma(2.0, 30.0, (rows, k)),
                      0).astype(np.float32)
    if kind == "unsorted":
        perm = np.argsort(rng.random((rows, cap)), axis=1)
        m, w = (np.take_along_axis(x, perm, 1) for x in (m, w))
    a = [torch.from_numpy(x).cuda() for x in (m, w, bm, bw)]
    comp = {616: 100.0, 1824: 300.0, 3032: 500.0}[cap]
    assert cluster_merge.route(cap, k) == "wide"
    wm, ww = cluster_merge._launch("wide", *a, **_scale(comp))
    sm, sw = cluster_merge._launch("spill", *a, **_scale(comp))
    torch.cuda.synchronize()
    assert torch.equal(wm, sm) and torch.equal(ww, sw)


@pytest.mark.cuda
def test_row_bytes_against_the_card():
    """``row_bytes`` is what the library reports for the row; the limit
    is an H100's where the card is one; the spill route's CTAs fill the
    card."""
    _need_cuda()
    lim = cluster_merge.max_dyn_bytes()
    if "H100" in torch.cuda.get_device_name(0):
        assert lim == cluster_merge.H100_MAX_DYN
    for cap, k in ((616, 512), (1824, 512), (616, 19 * 616),
                   (616, 24 * 616), (C2500, 512)):
        occ = cluster_merge.occupancy(cap, k)
        assert occ["smem_bytes"] == cluster_merge.row_bytes(cap, k)
        assert occ["threads"] == 128 and occ["rows_per_sm"] >= 1
        assert cluster_merge.fits(cap, k) == (
            cluster_merge.row_bytes(cap, k) <= lim)


_MESH24 = {"interval": "600s", "hostname": "mesh24",
           "tpu_mesh_shards": 24, "tpu_histo_rows": 96,
           "tpu_set_rows": 24, "tpu_counter_rows": 96,
           "tpu_gauge_rows": 96, "percentiles": [0.5, 0.9, 0.99],
           "tpu_overload": False}


def _drive_mesh(srv) -> dict:
    rng = np.random.default_rng(2424)
    try:
        for s in range(48):
            lines = [f"m24.lat.{s}:{v:.4f}|ms".encode()
                     for v in rng.gamma(2.0, 30.0, 400)]
            for i in range(0, len(lines), 100):  # under metric_max_length
                srv.handle_packet(b"\n".join(lines[i:i + 100]))
        srv.handle_packet(b"\n".join(
            f"m24.hits.{i}:{i}|c\nm24.temp.{i}:{i}|g\nm24.u:u{i}|s".encode()
            for i in range(40)))
        return {(m.name, m.tags): m.value for m in srv.flush_once().metrics
                if m.name.startswith("m24.")}
    finally:
        srv.shutdown()


@pytest.mark.cuda
def test_24_shard_mesh_server_on_the_card():
    """A mesh global of 24 shards on 24 places of one card flushes (its
    flush merge spilled; before the spill route it raised) what the same
    server on 24 CPU places flushes."""
    _need_cuda()
    before = observe.REGISTRY.launches().get("cluster_merge.spill", 0)
    got = _drive_mesh(Server(read_config(data=_MESH24), device="cuda",
                             places=["cuda:0"] * 24))
    assert observe.REGISTRY.launches()["cluster_merge.spill"] > before
    want = _drive_mesh(Server(read_config(data=_MESH24), device="cpu",
                              places=["cpu"] * 24))
    assert got.keys() == want.keys() and len(got) > 48 * 4
    for key, v in want.items():
        if key[0].endswith("percentile"):
            np.testing.assert_allclose(got[key], v, err_msg=str(key), **QTOL)
        else:
            assert got[key] == pytest.approx(v, rel=1e-6), key
