"""Batched t-digests: fixed-shape centroid planes on the device.

Port of ``veneur_tpu/ops/tdigest.py``.  State is a pair of planes
``means f32[R, C]`` / ``weights f32[R, C]`` (weight 0 = empty slot) and
a merge concatenates incoming centroids onto the state, sorts by mean,
assigns k-scale cluster ids ``floor(k(q) - k(0))`` and reduces each
cluster to its weighted mean — for all rows at once.  The merge itself
is ``ops/cluster_merge.py``: the CUDA kernel on the card, its plain
version on the CPU.

The port behaves as the reference does under its defaults on a TPU:
the tail refinement is on and every merge goes through the fused
kernel.  JAX's ``lax.scan`` over merge chunks is a Python loop of
merges here.  Functions return new tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from veneur_tpu_torch.ops import cluster_merge as _cm
from veneur_tpu_torch.ops import segment

DEFAULT_COMPRESSION = 100.0

_EPS = 1e-30

# Internal k-scale multiplier and upper-tail refinement constants (see
# the reference module for their derivation); the defaults there.
_SCALE_MULT = 6.0
_TAIL_MULT = 0.4
_TAIL_Q0 = 0.2
_TAIL_QMIN = 1e-4


def capacity_for(compression: float) -> int:
    """Slot capacity: asin body + clamped tail log-term (+ slack),
    rounded up to a multiple of 8."""
    clusters = (int(math.ceil(_SCALE_MULT * compression / 2.0)) +
                int(math.ceil(_TAIL_MULT * compression *
                              math.log(_TAIL_Q0 / _TAIL_QMIN))) + 8)
    return ((clusters + 7) // 8) * 8


DEFAULT_CAPACITY = capacity_for(DEFAULT_COMPRESSION)


def empty_state(num_rows: int, capacity: int = DEFAULT_CAPACITY,
                device: "str | torch.device" = "cpu"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    means = torch.zeros((num_rows, capacity), dtype=torch.float32,
                        device=device)
    return means, torch.zeros_like(means)


def _k_scale(q: torch.Tensor, delta: float,
             compression: float) -> torch.Tensor:
    """Monotone cluster scale: asin body + clamped upper-tail log term;
    floor(k) is the cluster id."""
    return _cm._k_scale(q, delta, _TAIL_MULT * compression, _TAIL_Q0,
                        _TAIL_QMIN)


def k_scale_np(q, compression: float):
    """Numpy mirror of _k_scale (same constants, f64) for host-side
    pre-clustering (core/table._host_precluster)."""
    delta = _SCALE_MULT * compression
    body = (delta / (2.0 * np.pi)) * np.arcsin(
        np.clip(2.0 * q - 1.0, -1.0, 1.0))
    tail = (_TAIL_MULT * compression) * np.log(
        _TAIL_Q0 / np.clip(1.0 - q, _TAIL_QMIN, None))
    return body + np.maximum(tail, 0.0)


def _merge_impl(means: torch.Tensor, weights: torch.Tensor,
                new_means: torch.Tensor, new_weights: torch.Tensor,
                compression: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge incoming centroids/samples into every row's digest.

    means, weights: f32[R, C]; new_means, new_weights: f32[R, K]
    (weight 0 = padding).  Returns f32[R, C] planes sorted by mean with
    empty slots at the end."""
    cap = means.shape[1]
    needed = capacity_for(compression)
    if cap < needed:
        raise ValueError(
            f"digest capacity {cap} < {needed} required for "
            f"compression={compression}")
    return _cm.cluster_merge(
        means, weights, new_means, new_weights,
        delta=_SCALE_MULT * compression,
        tail_coeff=_TAIL_MULT * compression,
        tail_q0=_TAIL_Q0, tail_qmin=_TAIL_QMIN)


def densify(row_ids: torch.Tensor, values: torch.Tensor,
            weights: torch.Tensor, num_rows: int,
            slots: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack a flat sample batch into per-row dense planes f32[R, K]:
    each sample lands at its occurrence rank within its row (stable
    arrival order).  Samples beyond ``slots`` per row and pad entries
    (``row_id == num_rows``) are dropped."""
    n = row_ids.shape[0]
    dev = values.device
    sid, order = torch.sort(row_ids.long(), stable=True)
    sval = values[order]
    swt = weights[order]
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    if n > 1:
        is_start[1:] = sid[1:] != sid[:-1]
    start = torch.cummax(torch.where(is_start, pos,
                                     torch.zeros_like(pos)), dim=0)[0]
    rank = pos - start
    return _scatter_dense(sid, rank, sval, swt, num_rows, slots)


def _scatter_dense(row_ids: torch.Tensor, ranks: torch.Tensor,
                   values: torch.Tensor, weights: torch.Tensor | None,
                   num_rows: int, slots: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``zeros.at[row_ids, ranks].set(values, mode="drop")`` for the
    value and weight planes (weights None = unit weights)."""
    dev = values.device
    dense_v = torch.zeros((num_rows, slots), dtype=torch.float32,
                          device=dev)
    dense_w = torch.zeros_like(dense_v)
    live = ((row_ids >= 0) & (row_ids < num_rows) &
            (ranks >= 0) & (ranks < slots))
    r = row_ids[live].long()
    k = ranks[live].long()
    dense_v[r, k] = values[live]
    dense_w[r, k] = (weights[live] if weights is not None
                     else torch.ones_like(values[live]))
    return dense_v, dense_w


def _take_rows(plane: torch.Tensor, row_idx: torch.Tensor) -> torch.Tensor:
    """Gather rows; out-of-range ids (padding) read as zeros."""
    live = (row_idx >= 0) & (row_idx < plane.shape[0])
    out = plane[row_idx.long().clamp(0, max(plane.shape[0] - 1, 0))]
    return torch.where(live.view(-1, *([1] * (plane.dim() - 1))), out,
                       torch.zeros_like(out))


def _put_rows(plane: torch.Tensor, row_idx: torch.Tensor,
              sub: torch.Tensor) -> torch.Tensor:
    """``plane.at[row_idx].set(sub, mode="drop")``."""
    live = (row_idx >= 0) & (row_idx < plane.shape[0])
    out = plane.clone()
    out[row_idx[live].long()] = sub[live]
    return out


def add_samples_ranked(means, weights, row_ids, ranks, values,
                       sample_weights, slots: int = 256,
                       compression: float = DEFAULT_COMPRESSION):
    """Ranked flat-sample ingest: host-computed within-row ranks, two
    scatters into dense planes, one cluster merge.  Padding entries use
    row_id == num_rows."""
    dv, dw = _scatter_dense(row_ids, ranks, values, sample_weights,
                            means.shape[0], slots)
    return _merge_impl(means, weights, dv, dw, compression)


def add_samples_ranked_unit(means, weights, row_ids, ranks, values,
                            slots: int = 256,
                            compression: float = DEFAULT_COMPRESSION):
    """add_samples_ranked with unit sample weights."""
    dv, dw = _scatter_dense(row_ids, ranks, values, None,
                            means.shape[0], slots)
    return _merge_impl(means, weights, dv, dw, compression)


def _stats_from_dense(stats: torch.Tensor, dense_v: torch.Tensor,
                      dense_w: torch.Tensor) -> torch.Tensor:
    """Fold a dense sample plane into the per-row (weight, min, max,
    sum, rsum) aggregates as row reductions."""
    occ = dense_w > 0
    fmax = segment._F32_MAX
    w = stats[:, segment.STAT_WEIGHT] + dense_w.sum(dim=1)
    mn = torch.minimum(
        stats[:, segment.STAT_MIN],
        torch.where(occ, dense_v, torch.full_like(dense_v, fmax)).amin(1))
    mx = torch.maximum(
        stats[:, segment.STAT_MAX],
        torch.where(occ, dense_v,
                    torch.full_like(dense_v, -fmax)).amax(1))
    sm = stats[:, segment.STAT_SUM] + (dense_v * dense_w).sum(dim=1)
    rs = stats[:, segment.STAT_RSUM] + torch.where(
        occ & (dense_v != 0), dense_w / dense_v,
        torch.zeros_like(dense_v)).sum(dim=1)
    return torch.stack([w, mn, mx, sm, rs], dim=1)


def _combine_row_stats(stats: torch.Tensor,
                       batch_stats: torch.Tensor) -> torch.Tensor:
    """Elementwise fold of per-row batch aggregates into the stats
    plane (untouched rows carry identity values)."""
    return torch.stack([
        stats[:, 0] + batch_stats[:, 0],
        torch.minimum(stats[:, 1], batch_stats[:, 1]),
        torch.maximum(stats[:, 2], batch_stats[:, 2]),
        stats[:, 3] + batch_stats[:, 3],
        stats[:, 4] + batch_stats[:, 4],
    ], dim=1)


def ingest_ranked(means, weights, stats, row_ids, ranks, values,
                  sample_weights, slots: int = 256,
                  compression: float = DEFAULT_COMPRESSION):
    """Scatter the ranked batch into dense planes, fold the local
    aggregates, cluster into the digests."""
    dv, dw = _scatter_dense(row_ids, ranks, values, sample_weights,
                            means.shape[0], slots)
    stats = _stats_from_dense(stats, dv, dw)
    m, w = _merge_impl(means, weights, dv, dw, compression)
    return m, w, stats


def ingest_ranked_unit(means, weights, stats, row_ids, ranks, values,
                       slots: int = 256,
                       compression: float = DEFAULT_COMPRESSION):
    """ingest_ranked with unit sample weights."""
    dv, dw = _scatter_dense(row_ids, ranks, values, None,
                            means.shape[0], slots)
    stats = _stats_from_dense(stats, dv, dw)
    m, w = _merge_impl(means, weights, dv, dw, compression)
    return m, w, stats


# ---- touched-row-subset variants -----------------------------------
# ``row_idx`` is the padded array of ABSOLUTE row ids (pad entries are
# out of range: gathers read zeros, the scatter-back drops them);
# ``row_ids`` are batch sample ids in the subset's local space (pad
# samples use row_idx.shape[0]).

def add_samples_ranked_rows(means, weights, row_idx, row_ids, ranks,
                            values, sample_weights, slots: int = 256,
                            compression: float = DEFAULT_COMPRESSION):
    sub_m, sub_w = add_samples_ranked(
        _take_rows(means, row_idx), _take_rows(weights, row_idx),
        row_ids, ranks, values, sample_weights, slots, compression)
    return (_put_rows(means, row_idx, sub_m),
            _put_rows(weights, row_idx, sub_w))


def add_samples_ranked_unit_rows(means, weights, row_idx, row_ids, ranks,
                                 values, slots: int = 256,
                                 compression: float =
                                 DEFAULT_COMPRESSION):
    sub_m, sub_w = add_samples_ranked_unit(
        _take_rows(means, row_idx), _take_rows(weights, row_idx),
        row_ids, ranks, values, slots, compression)
    return (_put_rows(means, row_idx, sub_m),
            _put_rows(weights, row_idx, sub_w))


def ingest_ranked_rows(means, weights, stats, row_idx, row_ids, ranks,
                       values, sample_weights, slots: int = 256,
                       compression: float = DEFAULT_COMPRESSION):
    sub_m, sub_w, sub_s = ingest_ranked(
        _take_rows(means, row_idx), _take_rows(weights, row_idx),
        _take_rows(stats, row_idx), row_ids, ranks, values,
        sample_weights, slots, compression)
    return (_put_rows(means, row_idx, sub_m),
            _put_rows(weights, row_idx, sub_w),
            _put_rows(stats, row_idx, sub_s))


def ingest_ranked_unit_rows(means, weights, stats, row_idx, row_ids,
                            ranks, values, slots: int = 256,
                            compression: float = DEFAULT_COMPRESSION):
    sub_m, sub_w, sub_s = ingest_ranked_unit(
        _take_rows(means, row_idx), _take_rows(weights, row_idx),
        _take_rows(stats, row_idx), row_ids, ranks, values, slots,
        compression)
    return (_put_rows(means, row_idx, sub_m),
            _put_rows(weights, row_idx, sub_w),
            _put_rows(stats, row_idx, sub_s))


# ---- deep batches: one slots-wide merge per chunk ------------------

def add_samples_ranked_scan(means, weights, row_ids, ranks, values,
                            sample_weights, slots: int, n_chunks: int,
                            compression: float = DEFAULT_COMPRESSION):
    """Deep-batch ingest: ranks may exceed ``slots`` (up to slots *
    n_chunks); each step densifies and merges one slots-wide chunk."""
    m, w = means, weights
    for ci in range(n_chunks):
        rk = ranks - ci * slots
        live = (rk >= 0) & (rk < slots)
        rid = torch.where(live, row_ids,
                          torch.full_like(row_ids, means.shape[0]))
        dv, dw = _scatter_dense(rid, rk.clamp(0, slots - 1), values,
                                sample_weights, means.shape[0], slots)
        m, w = _merge_impl(m, w, dv, dw, compression)
    return m, w


def add_samples_ranked_scan_rows(means, weights, row_idx, row_ids, ranks,
                                 values, sample_weights, slots: int,
                                 n_chunks: int,
                                 compression: float =
                                 DEFAULT_COMPRESSION):
    """add_samples_ranked_scan over a gathered row subset."""
    sub_m, sub_w = add_samples_ranked_scan(
        _take_rows(means, row_idx), _take_rows(weights, row_idx),
        row_ids, ranks, values, sample_weights, slots, n_chunks,
        compression)
    return (_put_rows(means, row_idx, sub_m),
            _put_rows(weights, row_idx, sub_w))


def merge_dense_scan(means, weights, plane_v, plane_w, slots: int,
                     n_chunks: int,
                     compression: float = DEFAULT_COMPRESSION):
    """Deep-batch merge from a host-densified plane f32[R, n_chunks *
    slots]: one merge per slots-wide slice (the slices are strided
    views; the kernel reads them in place)."""
    m, w = means, weights
    for ci in range(n_chunks):
        sl = slice(ci * slots, (ci + 1) * slots)
        m, w = _merge_impl(m, w, plane_v[:, sl], plane_w[:, sl],
                           compression)
    return m, w


def merge_dense_scan_rows(means, weights, row_idx, plane_v, plane_w,
                          slots: int, n_chunks: int,
                          compression: float = DEFAULT_COMPRESSION):
    """merge_dense_scan over a gathered row subset (plane rows are the
    subset's rows; padding row_idx == num_rows drops)."""
    sub_m, sub_w = merge_dense_scan(
        _take_rows(means, row_idx), _take_rows(weights, row_idx),
        plane_v, plane_w, slots, n_chunks, compression)
    return (_put_rows(means, row_idx, sub_m),
            _put_rows(weights, row_idx, sub_w))


# ---- readout --------------------------------------------------------

def _sorted_planes(means, weights):
    key = torch.where(weights > 0, means,
                      torch.full_like(means, math.inf))
    _, order = torch.sort(key, dim=1, stable=True)
    return means.gather(1, order), weights.gather(1, order)


def _anchors(m, w, mins, maxs):
    cum = w.cumsum(dim=1)
    total = cum[:, -1:]
    nvalid = (w > 0).sum(dim=1)
    last = (nvalid - 1).clamp(min=0)[:, None]
    first_m = m[:, :1]
    last_m = m.gather(1, last)
    lo = torch.where(torch.isnan(mins)[:, None], first_m, mins[:, None])
    hi = torch.where(torch.isnan(maxs)[:, None], last_m, maxs[:, None])
    return cum, total, nvalid, last, lo, hi


def _bounds(m, w, mins, maxs):
    """Sorted centroids + per-centroid value-space (lb, ub) per the
    reference's centroidUpperBound; returns (m, w, cum, lb, ub, nvalid,
    total)."""
    m, w = _sorted_planes(m, w)
    cum, total, nvalid, last, lo, hi = _anchors(m, w, mins, maxs)
    slot = torch.arange(m.shape[1], device=m.device)[None, :]
    m_next = torch.cat([m[:, 1:], m[:, -1:]], dim=1)
    ub = torch.where(slot >= last, hi, 0.5 * (m + m_next))
    lb = torch.cat([lo, ub[:, :-1]], dim=1)
    return m, w, cum, lb, ub, nvalid, total


def _quantile(means, weights, qs, mins, maxs):
    """The reference's uniform-bounds quantile walk."""
    m, w, cum, lb, ub, nvalid, total = _bounds(means, weights, mins,
                                               maxs)
    last = (nvalid - 1).clamp(min=0)[:, None]
    t = qs[None, :] * total
    cum_masked = torch.where(w > 0, cum, torch.full_like(cum, math.inf))
    idx = (cum_masked[:, None, :] < t[:, :, None]).sum(dim=-1)
    idx = torch.minimum(idx.clamp(min=0), last)
    w_i = w.gather(1, idx)
    cum_before = (cum - w).gather(1, idx)
    lb_i = lb.gather(1, idx)
    ub_i = ub.gather(1, idx)
    prop = ((t - cum_before) / w_i.clamp(min=_EPS)).clamp(0.0, 1.0)
    est = lb_i + prop * (ub_i - lb_i)
    ok = (nvalid[:, None] > 0) & (total > 0)
    return torch.where(ok, est, torch.full_like(est, math.nan))


def _quantile_interp(means, weights, qs, mins, maxs):
    """Rank-space centroid-mean interpolation (the flush readout).
    Knots: (-0.5, min), (pos_i, mean_i)..., (total-0.5, max) with
    pos_i = cum_i - (w_i+1)/2; target rank h = q*(total-1)."""
    m, w = _sorted_planes(means, weights)
    cum, total, nvalid, last, lo_anchor, hi_anchor = _anchors(
        m, w, mins, maxs)
    pos = cum - (w + 1.0) * 0.5
    h = qs[None, :] * (total - 1.0).clamp(min=0.0)
    pos_masked = torch.where(w > 0, pos, torch.full_like(pos, math.inf))
    idx = (pos_masked[:, None, :] < h[:, :, None]).sum(dim=-1)
    below = idx == 0
    above = idx > last
    idx_hi = torch.minimum(idx, last)
    idx_lo = torch.minimum((idx - 1).clamp(min=0), last)
    p_lo = torch.where(below, torch.full_like(h, -0.5),
                       pos.gather(1, idx_lo))
    v_lo = torch.where(below, lo_anchor.expand_as(h), m.gather(1, idx_lo))
    p_hi = torch.where(above, (total - 0.5).expand_as(h),
                       pos.gather(1, idx_hi))
    v_hi = torch.where(above, hi_anchor.expand_as(h), m.gather(1, idx_hi))
    frac = ((h - p_lo) / (p_hi - p_lo).clamp(min=_EPS)).clamp(0.0, 1.0)
    est = v_lo + frac * (v_hi - v_lo)
    est = torch.minimum(torch.maximum(est, lo_anchor), hi_anchor)
    ok = (nvalid[:, None] > 0) & (total > 0)
    return torch.where(ok, est, torch.full_like(est, math.nan))


def quantile(means: torch.Tensor, weights: torch.Tensor,
             qs: torch.Tensor, mins: torch.Tensor | None = None,
             maxs: torch.Tensor | None = None,
             method: str = "interp") -> torch.Tensor:
    """Estimate quantiles for every row -> f32[R, Q] ("interp": the
    flush readout; "reference": the Go digest's walk).  Empty rows ->
    NaN."""
    nan = torch.full((means.shape[0],), math.nan, dtype=torch.float32,
                     device=means.device)
    mins = nan if mins is None else mins
    maxs = nan if maxs is None else maxs
    qs = torch.as_tensor(qs, dtype=torch.float32, device=means.device)
    if method == "reference":
        return _quantile(means, weights, qs, mins, maxs)
    return _quantile_interp(means, weights, qs, mins, maxs)
