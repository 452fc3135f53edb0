"""The port's CUDA kernels against their plain PyTorch versions.

This file imports JAX in one test only, which skips where JAX is not
installed, so the file also runs where only PyTorch is installed.  The
``cuda``-marked cases need an NVIDIA GPU (a CUDA kernel has no CPU
mode) and skip without one; run them on the card from the repo root
with

    python -m pytest --noconftest -q tests/test_torch_kernels.py

(``--noconftest``: the suite's conftest imports JAX).  The CPU cases
hold the plain version to the merge contract on the same edge shapes.

Tolerances: weight mass rtol 1e-6 (f32 sums in another order);
quantiles rtol 2e-3 / atol 1e-3, the reference's merge tolerance
(tests/test_pallas_merge.py), because the f32 cumulative weight may
move a boundary-straddling centroid into the neighbouring cluster.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from veneur_tpu_torch import observe
from veneur_tpu_torch.ops import cluster_merge, segment, tdigest

QS = torch.tensor([0.01, 0.1, 0.5, 0.9, 0.99], dtype=torch.float32)


def _scale(compression: float) -> dict:
    return dict(delta=tdigest._SCALE_MULT * compression,
                tail_coeff=tdigest._TAIL_MULT * compression,
                tail_q0=tdigest._TAIL_Q0, tail_qmin=tdigest._TAIL_QMIN)


def _case(name: str):
    """(means, weights, new_means, new_weights, compression)."""
    rng = np.random.default_rng(len(name))

    def state(rows, cap, fill):
        occ = rng.integers(0, max(1, int(cap * fill)), rows)
        live = np.arange(cap)[None, :] < occ[:, None]
        m = np.sort(np.where(live, rng.gamma(2.0, 30.0, (rows, cap)),
                             np.inf), axis=1)
        return (np.where(live, m, 0).astype(np.float32),
                np.where(live, rng.integers(1, 40, (rows, cap)),
                         0).astype(np.float32))

    def batch(rows, k, live_p=0.8):
        w = (rng.random((rows, k)) < live_p).astype(np.float32)
        v = np.where(w > 0, rng.gamma(2.0, 30.0, (rows, k)), 0)
        return v.astype(np.float32), w

    def wire(rows, k):
        """One forwarded wire's centroids per row: a mean-sorted prefix
        of weighted centroids, padding after."""
        n = rng.integers(0, k + 1, rows)
        live = np.arange(k)[None, :] < n[:, None]
        v = np.sort(np.where(live, rng.gamma(2.0, 30.0, (rows, k)),
                             np.inf), axis=1)
        w = np.where(live, rng.integers(1, 60, (rows, k)), 0)
        return (np.where(live, v, 0).astype(np.float32),
                w.astype(np.float32))

    if name == "ingest_full_width":      # n = 2048, the deep path
        return (*state(64, 616, 0.5), *batch(64, 512), 100.0)
    if name == "union_616":              # digest-vs-digest, n = 2048
        m, w = state(32, 616, 0.9)
        return (m, w, *state(32, 616, 0.9), 100.0)
    if name == "shallow_256":            # superbatch arm, n = 1024
        return (*state(48, 616, 0.3), *batch(48, 256), 100.0)
    if name == "small_width":            # n = 64, one warp
        return (*state(9, 40, 0.5), *batch(9, 24), 5.0)
    if name == "empty_batch":            # K = 0
        m, w = state(7, 40, 0.8)
        z = np.zeros((7, 0), np.float32)
        return m, w, z, z, 5.0
    if name == "empty_rows":             # nothing anywhere in most rows
        m = np.zeros((12, 616), np.float32)
        w = np.zeros((12, 616), np.float32)
        v, bw = batch(12, 128, live_p=0.0)
        v[3, :5], bw[3, :5] = [5.0, 1.0, 9.0, 9.0, 2.0], 1.0
        return m, w, v, bw, 100.0
    if name == "ties":                   # one repeated value, heavy weights
        m, w = state(16, 616, 0.2)
        m[m > 0] = 42.0
        v, bw = batch(16, 512)
        v[bw > 0] = 42.0
        bw *= rng.integers(1, 1000, bw.shape).astype(np.float32)
        return m, w, v, bw, 100.0
    if name == "unsorted_state":         # in-kernel sort of the state
        m, w = state(40, 616, 0.6)
        perm = np.argsort(rng.random((40, 616)), axis=1)
        m = np.take_along_axis(m, perm, 1)  # empties interleaved
        w = np.take_along_axis(w, perm, 1)
        return (m, w, *batch(40, 512), 100.0)
    if name == "sorted_union":           # packed, sorted batch: no sort
        m, w = state(24, 616, 0.5)
        return (m, w, *state(24, 616, 1.0), 100.0)
    if name == "all_empty_rows":         # every row takes the early exit
        z = np.zeros((10, 616), np.float32)
        zb = np.zeros((10, 512), np.float32)
        return z, z, zb, zb, 100.0
    if name == "unaligned_batch":        # slice at column 3: scalar loads
        v, bw = batch(20, 1024)
        return (*state(20, 616, 0.5), v[:, 3:515], bw[:, 3:515], 100.0)
    # the global tier's per-wire folds: narrow weighted batches against
    # a full-size state (n = pow2(616 + K) = 1024), the composite sort
    if name == "wire_k8":
        return (*state(64, 616, 0.7), *wire(64, 8), 100.0)
    if name == "wire_k32":
        return (*state(64, 616, 0.7), *wire(64, 32), 100.0)
    if name == "subnormal":              # f32 subnormals flush to 0
        m, w = state(32, 616, 0.5)
        v, bw = batch(32, 256)
        tiny = np.float32(1e-40)
        m[::3, :4] = [tiny, -tiny, 2 * tiny, 1.0]
        v[::2, :3] = [tiny, -tiny, 3 * tiny]
        w[1::4, 1] = tiny                    # a subnormal weight: empty
        bw[::5, 4:9] = tiny
        m[7], w[7] = 0.0, 0.0                # a row whose only weights
        bw[7] = np.where(bw[7] > 0, tiny, 0.0)  # are subnormal
        return m, w, v, bw, 100.0
    if name == "wire_k64_unsorted":      # weighted, arrival order
        v, w = wire(64, 64)
        perm = np.argsort(rng.random((64, 64)), axis=1)
        return (*state(64, 616, 0.9), np.take_along_axis(v, perm, 1),
                np.take_along_axis(w, perm, 1), 100.0)
    # past the reference's 2048-lane bound: the kernel's wide route
    if name == "wide_c300":              # compression 300, C = 1824
        return (*state(32, 1824, 0.9), *batch(32, 512), 300.0)
    if name == "wide_long_unsorted":     # C = 3032: shared-memory sort
        m, w = state(16, 3032, 0.95)
        perm = np.argsort(rng.random((16, 3032)), axis=1)
        return (np.take_along_axis(m, perm, 1),
                np.take_along_axis(w, perm, 1), *batch(16, 512), 500.0)
    if name == "wide_long_unit_batch":   # K = 2600 unit samples
        return (*state(16, 616, 0.5), *batch(16, 2600, live_p=0.95),
                100.0)
    raise KeyError(name)


CASES = ["ingest_full_width", "union_616", "shallow_256", "small_width",
         "empty_batch", "empty_rows", "ties", "unsorted_state",
         "sorted_union", "all_empty_rows", "unaligned_batch", "wire_k8",
         "wire_k32", "wire_k64_unsorted", "subnormal", "wide_c300",
         "wide_long_unsorted", "wide_long_unit_batch"]


def _tensor(a: np.ndarray, device: str) -> torch.Tensor:
    """``a`` on ``device``; a column slice stays a view into its whole
    plane there, at the same offset and row stride."""
    if a.flags.c_contiguous:
        return torch.from_numpy(a).to(device)
    whole = a.base
    off = (a.__array_interface__["data"][0] -
           whole.__array_interface__["data"][0]) // a.itemsize
    return torch.from_numpy(whole).to(device).as_strided(
        a.shape, (a.strides[0] // a.itemsize, 1), off)


def _mass(w, bw):
    """The input weight mass, f32 subnormal weights flushed to zero as
    the merge flushes them."""
    return segment.ftz(w).double().sum(1) + segment.ftz(bw).double().sum(1)


def _check_contract(m, w, total):
    """Mass conserved; occupied slots contiguous from 0, mean-sorted,
    zeros after; no f32 subnormal left."""
    tiny = torch.finfo(torch.float32).tiny
    assert not bool(((m.abs() < tiny) & (m != 0)).any())
    assert not bool(((w.abs() < tiny) & (w != 0)).any())
    torch.testing.assert_close(w.double().sum(1), total, rtol=1e-6,
                               atol=0)
    occ = w > 0
    n = occ.sum(dim=1, keepdim=True)
    slot = torch.arange(w.shape[1], device=w.device)[None, :]
    assert torch.equal(slot < n, occ)
    assert bool((m[~occ] == 0).all())
    key = torch.where(occ, m, torch.full_like(m, float("inf")))
    assert bool((key[:, 1:] >= key[:, :-1]).all())


@pytest.mark.parametrize("name", CASES)
def test_plain_merge_contract(name):
    *arrays, comp = _case(name)
    m, w, bm, bw = (_tensor(a, "cpu") for a in arrays)
    om, ow = cluster_merge.cluster_merge(m, w, bm, bw, **_scale(comp))
    assert om.shape == m.shape
    _check_contract(om, ow, _mass(w, bw))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU "
                    "mode")
    *arrays, comp = _case(name)
    args = [_tensor(a, "cuda") for a in arrays]
    route = cluster_merge.LAUNCH_NAMES[cluster_merge.route(
        args[0].shape[1], args[2].shape[1])]
    before = observe.REGISTRY.launches().get(route, 0)
    total = cluster_merge.launch_count()
    km, kw = cluster_merge.cluster_merge(*args, **_scale(comp))
    pm, pw = cluster_merge.cluster_merge_plain(*args, **_scale(comp))
    torch.cuda.synchronize()
    assert observe.REGISTRY.launches()[route] == before + 1
    assert cluster_merge.launch_count() == total + 1
    _check_contract(km, kw, _mass(args[1], args[3]))
    qs = QS.cuda()
    qk = tdigest.quantile(km, kw, qs)
    qp = tdigest.quantile(pm, pw, qs)
    torch.testing.assert_close(qk, qp, rtol=2e-3, atol=1e-3,
                               equal_nan=True)


@pytest.mark.cuda
def test_kernel_strided_batch_and_bound():
    """Column slices of a wider plane go in without a copy; widths past
    the reference's 2048-lane bound launch the kernel on its wide route
    (F2), counted as ``cluster_merge.wide``, and a row past one CTA's
    shared memory raises by name."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU "
                    "mode")
    m, w, bm, bw, comp = _case("ingest_full_width")
    m, w = torch.from_numpy(m).cuda(), torch.from_numpy(w).cuda()
    plane_v = torch.from_numpy(np.concatenate([bm, bm], 1)).cuda()
    plane_w = torch.from_numpy(np.concatenate([bw, bw], 1)).cuda()
    sl = slice(512, 1024)
    km, kw = cluster_merge.cluster_merge(m, w, plane_v[:, sl],
                                         plane_w[:, sl], **_scale(comp))
    cm, cw = cluster_merge.cluster_merge(
        m, w, plane_v[:, sl].contiguous(), plane_w[:, sl].contiguous(),
        **_scale(comp))
    assert torch.equal(km, cm) and torch.equal(kw, cw)
    wide = torch.zeros((4, 1500), device="cuda")
    launches = observe.REGISTRY.launches()
    om, ow = cluster_merge.cluster_merge(wide, wide, wide, wide,
                                         **_scale(comp))
    pm, pw = cluster_merge.cluster_merge_plain(wide, wide, wide, wide,
                                               **_scale(comp))
    assert om.device.type == "cuda"
    assert torch.equal(om, pm) and torch.equal(ow, pw)
    after = observe.REGISTRY.launches()
    assert after.get("cluster_merge", 0) == launches.get("cluster_merge", 0)
    assert after["cluster_merge.wide"] == \
        launches.get("cluster_merge.wide", 0) + 1
    huge = torch.zeros((1, 40000), device="cuda")
    assert not cluster_merge.fits(40000, 40000)
    with pytest.raises(ValueError, match="shared memory"):
        cluster_merge.cluster_merge(huge, huge, huge, huge, **_scale(comp))


def test_plain_merge_flushes_subnormals_as_jax_pallas():
    """F1 in the merge: ``cluster_merge_plain`` against the reference's
    Pallas kernel (``merge_planes``, in interpret mode, as the JAX
    package's tests run it on the CPU) on subnormal means and weights.
    Both read a subnormal weight as no weight and a subnormal mean as a
    zero of its sign: the same rows come out empty, no subnormal comes
    out, mass agrees to rtol 1e-6 and quantiles to rtol 2e-3 / atol
    1e-3.  Imports JAX only here (skipped where it is not installed)."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    pallas_merge = pytest.importorskip("veneur_tpu.ops.pallas_merge")
    rng = np.random.default_rng(13)
    rows, cap, k, comp = 8, 40, 24, 5.0
    tiny = np.float32(1e-40)
    m = np.sort(rng.gamma(2.0, 30.0, (rows, cap)), 1).astype(np.float32)
    w = (np.arange(cap)[None, :] < rng.integers(0, cap // 2, rows)[:, None]
         ).astype(np.float32)
    m = np.where(w > 0, m, 0).astype(np.float32)
    m[:, 0] = np.where(w[:, 0] > 0, tiny, 0)
    bv = rng.gamma(2.0, 30.0, (rows, k)).astype(np.float32)
    bw = np.ones((rows, k), np.float32)
    bv[::2, :5] = [tiny, -tiny, 2 * tiny, 0.5, tiny]
    bw[1::2, 3:7] = tiny
    w[5], bw[5] = 0.0, tiny                  # only subnormal weights
    kw = _scale(comp)
    pm, pw = (x.numpy() for x in cluster_merge.cluster_merge_plain(
        *(torch.from_numpy(a) for a in (m, w, bv, bw)), **kw))
    # on JAX's CPU backend, where the JAX package's tests run it: with a
    # GPU visible JAX defaults to it, where this comparison did not hold
    with jax.default_device(jax.devices("cpu")[0]):
        jm, jw = (np.array(x) for x in pallas_merge.merge_planes(
            *(jnp.asarray(a) for a in (m, w, bv, bw)), **kw,
            interpret=True))
    for a in (pm, pw, jm, jw):
        assert not ((np.abs(a) < np.finfo(np.float32).tiny) &
                    (a != 0)).any()
    np.testing.assert_array_equal(pw.sum(1) == 0, jw.sum(1) == 0)
    assert not pw[5].any() and not pm[5].any()
    np.testing.assert_allclose(pw.sum(1), jw.sum(1), rtol=1e-6)
    qs = torch.tensor([0.05, 0.5, 0.99], dtype=torch.float32)
    qp = tdigest.quantile(torch.from_numpy(pm), torch.from_numpy(pw), qs)
    qj = tdigest.quantile(torch.from_numpy(jm), torch.from_numpy(jw), qs)
    torch.testing.assert_close(qp, qj, rtol=2e-3, atol=1e-3,
                               equal_nan=True)


def test_ab_tool_variants_derive_from_the_kernel_source():
    """``tools/cluster_merge_ab.py`` builds its variants by anchored
    edits of the kernel's source; every anchor must still match once."""
    from veneur_tpu_torch.tools import cluster_merge_ab as ab
    base = ab.variant_source("kernel")
    assert base == cluster_merge.SOURCE.read_text()
    for name in ["persistent", *ab._EDITS, *ab._STOPS]:
        assert ab.variant_source(name) != base, name
