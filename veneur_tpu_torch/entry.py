"""The single-device aggregation step in one function.

``entry(device)`` mirrors the reference's ``__graft_entry__.entry()``
step for step, with the same shapes and the same seeded example
arguments: counter add, histogram stats fold, densify + cluster merge
into the t-digest planes, packed HLL scatter-max, then the quantile and
cardinality readouts.  Returns ``(step, args)`` with ``args`` on
``device``; ``step(*args)`` runs it.
"""

from __future__ import annotations

import numpy as np
import torch

from veneur_tpu_torch import resolve_device
from veneur_tpu_torch.ops import hll, segment, tdigest


def entry(device: "str | torch.device" = "cuda"):
    """(fn, example_args): the single-device aggregation step."""
    dev = resolve_device(device)
    rows, cap, slots, n = 256, tdigest.capacity_for(100.0), 64, 1024

    def step(counters, histo_stats, means, weights, regs,
             c_rows, c_vals, c_wts, h_rows, h_vals, h_wts,
             s_rows, s_pk, qs):
        counters = segment.counter_update(counters, c_rows, c_vals, c_wts)
        histo_stats = segment.histo_stats_update(histo_stats, h_rows,
                                                 h_vals, h_wts)
        dv, dw = tdigest.densify(h_rows, h_vals, h_wts, rows, slots)
        means, weights = tdigest._merge_impl(means, weights, dv, dw,
                                             compression=100.0)
        regs = hll.insert_packed(regs, s_rows, s_pk)
        quant = tdigest.quantile(means, weights, qs,
                                 histo_stats[:, segment.STAT_MIN],
                                 histo_stats[:, segment.STAT_MAX])
        est = hll.estimate(regs)
        return counters, histo_stats, means, weights, regs, quant, est

    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    args = (
        torch.zeros((rows,), dtype=torch.float32, device=dev),
        segment.empty_histo_stats(rows, dev),
        torch.zeros((rows, cap), dtype=torch.float32, device=dev),
        torch.zeros((rows, cap), dtype=torch.float32, device=dev),
        torch.zeros((rows, hll.M), dtype=torch.uint8, device=dev),
        t(rng.integers(0, rows, n, dtype=np.int32)),
        t(rng.normal(10, 2, n).astype(np.float32)),
        torch.ones((n,), dtype=torch.float32, device=dev),
        t(rng.integers(0, rows, n, dtype=np.int32)),
        t(rng.normal(5, 1, n).astype(np.float32)),
        torch.ones((n,), dtype=torch.float32, device=dev),
        t(rng.integers(0, rows, n, dtype=np.int32)),
        t(hll.pack_positions(
            rng.integers(0, hll.M, n, dtype=np.int32),
            rng.integers(1, 20, n, dtype=np.int32))),
        t(np.asarray([0.5, 0.9, 0.99], np.float32)),
    )
    return step, args
