"""HyperLogLog register-plane updates (p=14, LogLog-Beta estimator).

Port of ``veneur_tpu/ops/hll.py``.  Every set series is one dense row
of a ``u8[num_rows, 16384]`` register plane on the device:

- insert   = scatter-max of (register index, rank) pairs
- union    = elementwise maximum of planes
- estimate = LogLog-Beta over register histograms, all rows at once

Member hashing to (index, rank) happens on the host
(``veneur_tpu_torch.utils.hashing.hash_members``).  Registers are
integers and max is order-free, so planes match the reference bit for
bit.  Pad rows (``row_id == R``) are masked out before each scatter.
"""

from __future__ import annotations

import numpy as np
import torch

from veneur_tpu_torch.utils.hashing import HLL_P

P = HLL_P
M = 1 << P  # 16384 registers, ~0.81% standard error

# LogLog-Beta bias-correction polynomial for p=14 (arXiv:1612.02284),
# the same constants as the reference package.
_BETA14 = (-0.370393911, 0.070471823, 0.17393686, 0.16339839,
           -0.09237745, 0.03738027, -0.005384159, 0.00042419)

_ALPHA = 0.7213 / (1.0 + 1.079 / M)

# ranks are <= 51 for p=14; 64 covers the 6-bit packed field
_RANKS = 64


def empty_state(num_rows: int,
                device: "str | torch.device") -> torch.Tensor:
    return torch.zeros((num_rows, M), dtype=torch.uint8, device=device)


def _scatter_max(regs: torch.Tensor, row_ids: torch.Tensor,
                 reg_idx: torch.Tensor,
                 ranks: torch.Tensor) -> torch.Tensor:
    live = (row_ids >= 0) & (row_ids < regs.shape[0])
    flat = row_ids[live].long() * M + reg_idx[live].long()
    out = regs.clone()
    out.view(-1).scatter_reduce_(0, flat, ranks[live].to(torch.uint8),
                                 "amax", include_self=True)
    return out


def insert(regs: torch.Tensor, row_ids: torch.Tensor,
           reg_idx: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """Scatter-max a batch of hashed members into their rows.
    regs: u8[R, M]; row_ids, reg_idx, ranks: i32[N]."""
    return _scatter_max(regs, row_ids, reg_idx, ranks)


def insert_packed(regs: torch.Tensor, row_ids: torch.Tensor,
                  packed: torch.Tensor) -> torch.Tensor:
    """Scatter-max with ``packed = (reg_idx << 6) | rank`` per member."""
    return _scatter_max(regs, row_ids, packed >> 6, packed & 0x3F)


def pack_positions(reg_idx, ranks) -> np.ndarray:
    """Host-side packing matching insert_packed's layout."""
    return ((np.asarray(reg_idx, np.int32) << 6) |
            np.asarray(ranks, np.int32))


def union(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """HLL union is register-wise maximum (same-shape planes)."""
    return torch.maximum(a, b)


def merge_rows(regs: torch.Tensor, row_ids: torch.Tensor,
               incoming: torch.Tensor) -> torch.Tensor:
    """Merge register rows u8[K, M] into table rows by max."""
    live = (row_ids >= 0) & (row_ids < regs.shape[0])
    rows = row_ids[live].long()
    out = regs.clone()
    idx = rows[:, None].expand(-1, M)
    out.scatter_reduce_(0, idx, incoming[live], "amax", include_self=True)
    return out


def estimate_np(plane) -> np.ndarray:
    """LogLog-Beta estimate over a HOST register plane (u8[R, M]) — the
    same formula as ``estimate``, evaluated with numpy (the host-folded
    set path, see MetricTable._hll_host_fold)."""
    ez = (plane == 0).sum(axis=-1).astype(np.float64)
    lut = np.exp2(-np.arange(64, dtype=np.float64))
    inv_sum = np.empty(plane.shape[0], np.float64)
    step = max(1, (8 << 20) // (M * 8))
    for i in range(0, plane.shape[0], step):
        inv_sum[i:i + step] = lut[plane[i:i + step]].sum(axis=-1)
    return estimate_from_stats(ez, inv_sum)


def estimate_from_stats(ez, inv_sum) -> np.ndarray:
    """LogLog-Beta estimate from per-row sufficient statistics
    (ez = zero-register count, inv_sum = sum_j 2^-reg_j)."""
    ez = np.asarray(ez, np.float64)
    inv_sum = np.asarray(inv_sum, np.float64)
    zl = np.log(ez + 1.0)
    beta = _BETA14[0] * ez
    zp = zl.copy()
    for c in _BETA14[1:]:
        beta = beta + c * zp
        zp = zp * zl
    return (_ALPHA * M * (M - ez) / (inv_sum + beta)).astype(
        np.float32)


def estimate(regs: torch.Tensor) -> torch.Tensor:
    """LogLog-Beta cardinality estimate per row -> f32[R].

    est = alpha * m * (m - ez) / (sum_j 2^-reg_j + beta(ez)).

    The sum of 2^-reg is taken from a per-row histogram of register
    values (integer counts, then a fixed-order 64-term sum), so it does
    not depend on a device's reduction order: the CPU and the card give
    the same bits.  Against the reference's f32 tree sum it differs by
    f32 rounding only."""
    num_rows = regs.shape[0]
    dev = regs.device
    flat = (torch.arange(num_rows, device=dev, dtype=torch.int64)[:, None]
            * _RANKS + regs.long()).view(-1)
    counts = torch.bincount(flat, minlength=num_rows * _RANKS).view(
        num_rows, _RANKS).to(torch.float32)
    ez = counts[:, 0]
    inv_sum = torch.zeros(num_rows, dtype=torch.float32, device=dev)
    for r in range(_RANKS):
        inv_sum = inv_sum + counts[:, r] * float(2.0 ** -r)
    zl = torch.log(ez + 1.0)
    beta = _BETA14[0] * ez
    zp = zl
    for c in _BETA14[1:]:
        beta = beta + c * zp
        zp = zp * zl
    m = float(M)
    return _ALPHA * m * (m - ez) / (inv_sum + beta)
