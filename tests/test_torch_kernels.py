"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs where only PyTorch is
installed.  The ``cuda``-marked cases need an NVIDIA GPU (a CUDA
kernel has no CPU mode) and skip without one; run them on the card
from the repo root with

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

from veneur_tpu_torch.ops import cluster_merge, tdigest

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
    raise KeyError(name)


CASES = ["ingest_full_width", "union_616", "shallow_256", "small_width",
         "empty_batch", "empty_rows", "ties"]


def _check_contract(m, w, total):
    """Mass conserved; occupied slots contiguous from 0, mean-sorted,
    zeros after."""
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
    m, w, bm, bw, comp = (torch.from_numpy(np.ascontiguousarray(a))
                          if isinstance(a, np.ndarray) else a
                          for a in _case(name))
    om, ow = cluster_merge.cluster_merge(m, w, bm, bw, **_scale(comp))
    assert om.shape == m.shape
    _check_contract(om, ow, w.double().sum(1) + bw.double().sum(1))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU "
                    "mode")
    m, w, bm, bw, comp = _case(name)
    args = [torch.from_numpy(a).cuda() for a in (m, w, bm, bw)]
    before = cluster_merge.launches
    km, kw = cluster_merge.cluster_merge(*args, **_scale(comp))
    pm, pw = cluster_merge.cluster_merge_plain(*args, **_scale(comp))
    torch.cuda.synchronize()
    assert cluster_merge.launches == before + 1
    _check_contract(km, kw, args[1].double().sum(1) +
                    args[3].double().sum(1))
    qs = QS.cuda()
    qk = tdigest.quantile(km, kw, qs)
    qp = tdigest.quantile(pm, pw, qs)
    torch.testing.assert_close(qk, qp, rtol=2e-3, atol=1e-3,
                               equal_nan=True)


@pytest.mark.cuda
def test_kernel_strided_batch_and_bound():
    """Column slices of a wider plane go in without a copy; widths past
    the 2048 bound raise instead of falling back."""
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
    with pytest.raises(ValueError, match="2048"):
        cluster_merge.cluster_merge(wide, wide, wide, wide,
                                    **_scale(comp))
