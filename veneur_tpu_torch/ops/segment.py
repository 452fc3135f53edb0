"""Batched segment updates for counter / gauge / histogram-stat planes.

Port of ``veneur_tpu/ops/segment.py``.  A whole ingest batch is a set
of flat columns ``(row_ids, values, weights)`` and the update is one
scatter/segment reduction over the device-resident state planes.

Conventions (as in the reference package):

* ``row_ids`` index a fixed-capacity table of ``num_rows`` rows.
  Padding entries use ``row_id == num_rows``.  JAX drops out-of-range
  scatter updates; torch's ``index_add_`` / ``scatter_reduce_`` raise
  on them, so every scatter here masks the pad rows out first.
* ``weights`` carry the DogStatsD sample-rate correction ``1/rate``.
* All state is float32.

Functions are pure: they return new tensors and leave their inputs
untouched, like their JAX counterparts.
"""

from __future__ import annotations

import torch

HISTO_STAT_COLS = 5
STAT_WEIGHT, STAT_MIN, STAT_MAX, STAT_SUM, STAT_RSUM = range(HISTO_STAT_COLS)

_F32_MAX = float(torch.finfo(torch.float32).max)

# Untouched-row sentinels for the min/max columns (the reference's
# +/-Inf initialisation, kept inf-free).
STAT_MIN_EMPTY = _F32_MAX
STAT_MAX_EMPTY = -_F32_MAX


def _live(row_ids: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Mask of in-range row ids (the JAX ``mode="drop"`` contract)."""
    return (row_ids >= 0) & (row_ids < num_rows)


def counter_update(state: torch.Tensor, row_ids: torch.Tensor,
                   values: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """Add rate-corrected sample values into counter rows.
    state: f32[R]; row_ids: i32[N]; values, weights: f32[N].

    The f32 addends are summed in f64 and rounded once: that sum is
    exact for any realistic batch, so the result does not depend on
    the order a device's scatter-add runs in (the CPU and the card
    agree bit for bit) and is at least as close to the exact total as
    the reference's f32 scatter-add."""
    live = _live(row_ids, state.shape[0])
    return state.double().index_add(
        0, row_ids[live].long(),
        (values * weights)[live].double()).to(torch.float32)


def gauge_update(state: torch.Tensor, row_ids: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """Last-write-wins gauge update: for each row the latest sample in
    the batch (highest arrival index) wins — a segment-max over arrival
    indices, as the reference does, so duplicate rows resolve
    deterministically."""
    n = row_ids.shape[0]
    if n == 0:
        return state
    num_rows = state.shape[0]
    live = _live(row_ids, num_rows)
    arrival = torch.arange(n, dtype=torch.int64, device=state.device)
    winner = torch.full((num_rows,), -1, dtype=torch.int64,
                        device=state.device)
    winner.scatter_reduce_(0, row_ids[live].long(), arrival[live],
                           "amax", include_self=True)
    has_sample = winner >= 0
    return torch.where(has_sample, values[winner.clamp(0, n - 1)], state)


def merge_histo_stats(stats: torch.Tensor, row_ids: torch.Tensor,
                      incoming: torch.Tensor) -> torch.Tensor:
    """Merge (weight, min, max, sum, rsum) rows into the table."""
    live = _live(row_ids, stats.shape[0])
    rows = row_ids[live].long()
    inc = incoming[live]
    out = stats.clone()
    for col in (STAT_WEIGHT, STAT_SUM, STAT_RSUM):
        out[:, col] = stats[:, col].index_add(0, rows, inc[:, col])
    out[:, STAT_MIN] = stats[:, STAT_MIN].scatter_reduce(
        0, rows, inc[:, STAT_MIN], "amin", include_self=True)
    out[:, STAT_MAX] = stats[:, STAT_MAX].scatter_reduce(
        0, rows, inc[:, STAT_MAX], "amax", include_self=True)
    return out


def histo_stats_update(stats: torch.Tensor, row_ids: torch.Tensor,
                       values: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """Update per-row local histogram aggregates: a raw sample of value
    v / weight w contributes the stat row (w, v, v, v*w, w/v)."""
    incoming = torch.stack([
        weights, values, values, values * weights,
        torch.where(values != 0, weights / values,
                    torch.zeros_like(values))], dim=1)
    return merge_histo_stats(stats, row_ids, incoming)


def histo_stats_update_unit(stats: torch.Tensor, row_ids: torch.Tensor,
                            values: torch.Tensor) -> torch.Tensor:
    """histo_stats_update with unit sample weights."""
    ones = torch.ones_like(values)
    incoming = torch.stack([
        ones, values, values, values,
        torch.where(values != 0, 1.0 / values,
                    torch.zeros_like(values))], dim=1)
    return merge_histo_stats(stats, row_ids, incoming)


def counter_dense_update(state: torch.Tensor,
                         dense: torch.Tensor) -> torch.Tensor:
    """Add a host-precombined per-row total vector (f32[R])."""
    return state + dense


def gauge_dense_update(state: torch.Tensor, dense: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Apply host-precombined last-write values where ``mask`` is set."""
    return torch.where(mask, dense, state)


def empty_counter_state(num_rows: int,
                        device: "str | torch.device" = "cpu"
                        ) -> torch.Tensor:
    return torch.zeros((num_rows,), dtype=torch.float32, device=device)


def empty_gauge_state(num_rows: int,
                      device: "str | torch.device" = "cpu"
                      ) -> torch.Tensor:
    return torch.zeros((num_rows,), dtype=torch.float32, device=device)


def empty_histo_stats(num_rows: int,
                      device: "str | torch.device" = "cpu"
                      ) -> torch.Tensor:
    """min column +f32max, max column -f32max; weight 0 = empty row."""
    stats = torch.zeros((num_rows, HISTO_STAT_COLS), dtype=torch.float32,
                        device=device)
    stats[:, STAT_MIN] = _F32_MAX
    stats[:, STAT_MAX] = -_F32_MAX
    return stats
