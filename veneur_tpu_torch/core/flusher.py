"""Flush: table snapshot -> InterMetrics.

Port of ``veneur_tpu/core/flusher.py`` for the global (non-forwarding)
role: every touched row is emitted here.  The device work is a handful
of readouts over whole planes — counter/gauge vectors, the combined
histo stats plus the quantile readout over the touched digest rows,
the HLL estimate over the register plane — followed by one readback
and host-side assembly of InterMetrics from row metadata (the
reference's per-row emit path).

Histo aggregate emission matches the reference: .min .max .sum .avg
.count .median .hmean (count is a counter) plus ``.<p>percentile``
gauges, with its sparse-emission guards.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from veneur_tpu_torch import resolve_device
from veneur_tpu_torch.core import metrics as im
from veneur_tpu_torch.core.table import RowMeta, Snapshot
from veneur_tpu_torch.ops import hll, segment, tdigest
from veneur_tpu_torch.protocol import dogstatsd as dsd

DEFAULT_AGGREGATES = ("min", "max", "count")
DEFAULT_PERCENTILES = (0.5, 0.75, 0.99)


def _combine_stats_fn(stats: torch.Tensor,
                      imp: torch.Tensor) -> torch.Tensor:
    """Combine the local-sample and imported stat planes (weight/sum/
    rsum add, min min, max max)."""
    return torch.stack([
        stats[:, segment.STAT_WEIGHT] + imp[:, segment.STAT_WEIGHT],
        torch.minimum(stats[:, segment.STAT_MIN],
                      imp[:, segment.STAT_MIN]),
        torch.maximum(stats[:, segment.STAT_MAX],
                      imp[:, segment.STAT_MAX]),
        stats[:, segment.STAT_SUM] + imp[:, segment.STAT_SUM],
        stats[:, segment.STAT_RSUM] + imp[:, segment.STAT_RSUM],
    ], dim=1)


def _histo_readout(stats, imp, means, weights, qs):
    """Combined stats plus the per-row quantile readout (the
    reference's default "interp" interpolation)."""
    comb = _combine_stats_fn(stats, imp)
    qvals = tdigest._quantile_interp(means, weights, qs,
                                     comb[:, segment.STAT_MIN],
                                     comb[:, segment.STAT_MAX])
    return comb, qvals


def _histo_readout_rows(stats, imp, means, weights, qs, idx):
    """_histo_readout restricted to the touched rows ``idx``: both the
    readback and the quantile readout's sort scale with the touched
    row count instead of the table capacity."""
    st = stats[idx]
    comb, qvals = _histo_readout(st, imp[idx], means[idx], weights[idx],
                                 qs)
    return st, comb, qvals


def _gather_rows(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Compact selected rows on the device before readback."""
    return plane[idx]


def _percentile_suffix(p: float) -> str:
    """``.50percentile`` for 0.5; sub-percent quantiles keep their
    digits (``.999percentile``) — the reference's default "precise"
    naming."""
    scaled = p * 100
    if abs(scaled - round(scaled)) < 1e-9:
        return f"{int(round(scaled))}percentile"
    return f"{str(scaled).replace('.', '')}percentile"


@dataclass
class FlushResult:
    metrics: list[im.InterMetric] = field(default_factory=list)
    tally: dict[str, int] = field(default_factory=dict)


class Flusher:
    """Global-role flusher: emits every touched row.  Its readouts run
    on ``device`` (default ``"cuda"``; raises without CUDA unless the
    caller passes ``"cpu"``); snapshot planes elsewhere are moved
    there first."""

    def __init__(self,
                 percentiles: tuple[float, ...] = DEFAULT_PERCENTILES,
                 aggregates: tuple[str, ...] = DEFAULT_AGGREGATES,
                 hostname: str = "",
                 device: "str | torch.device" = "cuda"):
        self.device = resolve_device(device)
        self.percentiles = tuple(percentiles)
        self.aggregates = tuple(aggregates)
        self.hostname = hostname

    def flush(self, snap: Snapshot, now: int | None = None) -> FlushResult:
        ts = int(now if now is not None else time.time())
        res = FlushResult()
        pre = self._prefetch(snap)
        self._flush_counters(snap, ts, res, pre)
        self._flush_gauges(snap, ts, res, pre)
        self._flush_histos(snap, ts, res, pre)
        self._flush_sets(snap, ts, res, pre)
        res.tally["overflow"] = sum(snap.overflow.values())
        return res

    # ------------------------------------------------------------------

    def _prefetch(self, snap: Snapshot) -> dict:
        """Launch every device readout the flush needs, then read all
        results back to the host at once (re-scattering gathered rows
        into full-size host arrays)."""
        devs, pre, expand = self._dispatch(snap)
        for k, v in devs.items():
            pre[k] = v.cpu().numpy()
        for dev_key, out_key, rows, shape in expand:
            out = pre.pop(dev_key)
            full = np.zeros(shape, out.dtype)
            full[rows] = out[:len(rows)]
            pre[out_key] = full
        return pre

    def _dispatch(self, snap: Snapshot) -> tuple[dict, dict, list]:
        devs: dict = {}
        pre: dict = {}
        expand: list = []
        dev = self.device

        def _plane_readback(key, plane, touched, meta_len):
            plane = plane.to(dev)
            rows = np.nonzero(touched[:meta_len])[0]
            if len(rows) * 2 >= plane.shape[0]:
                devs[key] = plane
                return
            idx = torch.as_tensor(rows, device=plane.device)
            devs[key + "_g"] = _gather_rows(plane, idx)
            expand.append((key + "_g", key, rows, tuple(plane.shape)))

        if snap.counter_meta and snap.counter_touched.any():
            _plane_readback("counters", snap.counters,
                            snap.counter_touched, len(snap.counter_meta))
        if snap.gauge_meta and snap.gauge_touched.any():
            _plane_readback("gauges", snap.gauges, snap.gauge_touched,
                            len(snap.gauge_meta))

        histo_rows = np.nonzero(
            snap.histo_touched[:len(snap.histo_meta)])[0]
        pre["histo_rows"] = histo_rows
        if len(histo_rows):
            all_pcts = tuple(self.percentiles) + (
                (0.5,) if "median" in self.aggregates else ())
            pre["all_pcts"] = all_pcts
            qs = torch.tensor(all_pcts, dtype=torch.float32, device=dev)
            stats, imp, means, weights = (
                t.to(dev) for t in (snap.histo_stats,
                                    snap.histo_import_stats,
                                    snap.histo_means, snap.histo_weights))
            R = stats.shape[0]
            if all_pcts and len(histo_rows) * 2 < R:
                idx = torch.as_tensor(histo_rows, device=dev)
                st_g, comb_g, qvals_g = _histo_readout_rows(
                    stats, imp, means, weights, qs, idx)
                devs["qvals_g"] = qvals_g
                devs["stats_g"] = st_g
                devs["comb_g"] = comb_g
                shape5 = (R, segment.HISTO_STAT_COLS)
                expand.append(("qvals_g", "qvals", histo_rows,
                               (R, len(all_pcts))))
                expand.append(("stats_g", "stats", histo_rows, shape5))
                expand.append(("comb_g", "comb", histo_rows, shape5))
            elif all_pcts:
                comb, qvals = _histo_readout(stats, imp, means, weights,
                                             qs)
                devs["qvals"] = qvals
                devs["stats"] = stats
                devs["comb"] = comb
            else:
                devs["stats"] = stats
                devs["comb"] = _combine_stats_fn(stats, imp)

        set_rows = np.nonzero(snap.set_touched[:len(snap.set_meta)])[0]
        pre["set_rows"] = set_rows
        if len(set_rows):
            if snap.host_only_sets:
                pre["ests"] = snap.host_set_estimates()
            else:
                regs = snap.hll_regs.to(dev)
                if snap.hll_host_plane is not None:
                    regs = hll.union(regs, torch.from_numpy(
                        snap.hll_host_plane).to(dev))
                devs["ests"] = hll.estimate(regs)
        return devs, pre, expand

    # ------------------------------------------------------------------

    def _mk(self, name: str, ts: int, value: float, meta: RowMeta,
            mtype: str) -> im.InterMetric:
        return im.InterMetric(name=name, timestamp=ts, value=value,
                              tags=meta.tags,
                              type=mtype, hostname=self.hostname)

    def _flush_counters(self, snap, ts, res, pre) -> None:
        vals = pre.get("counters")
        if vals is None:
            return
        for row in np.nonzero(
                snap.counter_touched[:len(snap.counter_meta)])[0]:
            meta = snap.counter_meta[row]
            res.metrics.append(self._mk(meta.name, ts, float(vals[row]),
                                        meta, im.COUNTER))
        res.tally["counters"] = int(
            snap.counter_touched[:len(snap.counter_meta)].sum())

    def _flush_gauges(self, snap, ts, res, pre) -> None:
        vals = pre.get("gauges")
        if vals is None:
            return
        for row in np.nonzero(
                snap.gauge_touched[:len(snap.gauge_meta)])[0]:
            meta = snap.gauge_meta[row]
            res.metrics.append(self._mk(meta.name, ts, float(vals[row]),
                                        meta, im.GAUGE))
        res.tally["gauges"] = int(
            snap.gauge_touched[:len(snap.gauge_meta)].sum())

    def _flush_histos(self, snap, ts, res, pre) -> None:
        """Aggregates for mixed-scope rows come from the local-sample
        plane; global-scope rows use the combined plane (the
        reference's ``global`` flush mode)."""
        rows = pre["histo_rows"]
        if not len(rows):
            return
        stats = pre["stats"]
        comb = pre["comb"]
        qvals = pre.get("qvals")
        all_pcts = pre["all_pcts"]
        for row in rows:
            meta = snap.histo_meta[row]
            global_mode = meta.scope == dsd.SCOPE_GLOBAL
            self._emit_histo_row(res, meta, ts,
                                 comb[row] if global_mode else stats[row],
                                 qvals, row, all_pcts, global_mode)
        res.tally["histograms"] = int(
            snap.histo_touched[:len(snap.histo_meta)].sum())

    def _emit_histo_row(self, res, meta, ts, st, qvals, row, all_pcts,
                        global_mode=False):
        agg = set(self.aggregates)
        out = res.metrics
        weight = float(st[segment.STAT_WEIGHT])
        st_min = float(st[segment.STAT_MIN])
        st_max = float(st[segment.STAT_MAX])
        st_sum = float(st[segment.STAT_SUM])
        st_rsum = float(st[segment.STAT_RSUM])
        sampled = weight != 0
        if "max" in agg and (global_mode or
                             st_max != float(segment.STAT_MAX_EMPTY)):
            out.append(self._mk(f"{meta.name}.max", ts, st_max, meta,
                                im.GAUGE))
        if "min" in agg and (global_mode or
                             st_min != float(segment.STAT_MIN_EMPTY)):
            out.append(self._mk(f"{meta.name}.min", ts, st_min, meta,
                                im.GAUGE))
        if "sum" in agg and (global_mode or sampled):
            out.append(self._mk(f"{meta.name}.sum", ts, st_sum, meta,
                                im.GAUGE))
        if "avg" in agg and weight != 0:
            out.append(self._mk(f"{meta.name}.avg", ts, st_sum / weight,
                                meta, im.GAUGE))
        if "count" in agg and (global_mode or sampled):
            out.append(self._mk(f"{meta.name}.count", ts, weight, meta,
                                im.COUNTER))
        if "hmean" in agg and weight != 0 and st_rsum != 0:
            out.append(self._mk(f"{meta.name}.hmean", ts,
                                weight / st_rsum, meta, im.GAUGE))
        if "median" in agg and qvals is not None:
            out.append(self._mk(f"{meta.name}.median", ts,
                                float(qvals[row, len(all_pcts) - 1]),
                                meta, im.GAUGE))
        if qvals is not None:
            for pi, p in enumerate(self.percentiles):
                out.append(self._mk(
                    f"{meta.name}.{_percentile_suffix(p)}",
                    ts, float(qvals[row, pi]), meta, im.GAUGE))

    def _flush_sets(self, snap, ts, res, pre) -> None:
        rows = pre["set_rows"]
        if not len(rows):
            return
        ests = pre["ests"]
        for row in rows:
            meta = snap.set_meta[row]
            res.metrics.append(self._mk(meta.name, ts,
                                        float(round(ests[row])), meta,
                                        im.GAUGE))
        res.tally["sets"] = int(snap.set_touched[:len(snap.set_meta)].sum())
