"""Flush: table snapshot -> InterMetrics and forwarded state.

Port of ``veneur_tpu/core/flusher.py``.  The device work is a handful
of readouts over whole planes — counter/gauge vectors, the combined
histo stats plus the quantile readout over the touched digest rows, the
HLL estimate over the register plane, and on a local the digest and
register rows it forwards — followed by one readback and host-side
assembly from row metadata: by default columnar, one ``MetricFrame``
block per aggregate kind over many rows (``columnar=True``), else the
per-row emit, one ``InterMetric`` at a time, kept as the parity
oracle.

Two roles, as in the reference: a **global** (``is_local=False``)
emits every touched row, percentiles included; a **local**
(``is_local=True``, a node with a forward address) emits local
aggregates without percentiles and hands mergeable state to the
forward path as ``ForwardRow``s: global-scope counters and gauges,
every non-local-scope digest (whose local aggregates it still emits)
and every non-local-scope set.

Histo aggregate emission matches the reference: .min .max .sum .avg
.count .median .hmean (count is a counter) plus ``.<p>percentile``
gauges, with its sparse-emission guards.

A tiered snapshot (``Snapshot.tiers``) keeps its stat planes row-space
but its centroid planes are a wide-slot pool and its compact rows live
on the host: quantiles split by tier (``_dispatch_histos_tiered``), and
set estimates and forwarded registers go through the tier view.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from veneur_tpu_torch import observe, resolve_device
from veneur_tpu_torch.core import metrics as im
from veneur_tpu_torch.core.frame import (MetricFrame, TYPE_COUNTER,
                                         TYPE_GAUGE)
from veneur_tpu_torch.core.table import RowMeta, Snapshot
from veneur_tpu_torch.ops import hll, segment, tdigest
from veneur_tpu_torch.protocol import dogstatsd as dsd

DEFAULT_AGGREGATES = ("min", "max", "count")
DEFAULT_PERCENTILES = (0.5, 0.75, 0.99)

_SCOPE_CODE = {dsd.SCOPE_DEFAULT: 0, dsd.SCOPE_LOCAL: 1,
               dsd.SCOPE_GLOBAL: 2}
_SCOPE_LOCAL, _SCOPE_GLOBAL = 1, 2


def _scope_codes(metas: list, rows: np.ndarray) -> np.ndarray:
    """uint8 scope code per selected row: the columnar emit's one
    O(touched rows) Python pass over the metadata."""
    code = _SCOPE_CODE
    return np.fromiter((code[metas[r].scope] for r in rows),
                       np.uint8, len(rows))


def _combine_stats_fn(stats: torch.Tensor,
                      imp: torch.Tensor) -> torch.Tensor:
    """Combine the local-sample and imported stat planes (weight/sum/
    rsum add, min min, max max); subnormals flush to zero, as in the
    reference's jitted readout."""
    return segment.ftz(torch.stack([
        stats[:, segment.STAT_WEIGHT] + imp[:, segment.STAT_WEIGHT],
        torch.minimum(stats[:, segment.STAT_MIN],
                      imp[:, segment.STAT_MIN]),
        torch.maximum(stats[:, segment.STAT_MAX],
                      imp[:, segment.STAT_MAX]),
        stats[:, segment.STAT_SUM] + imp[:, segment.STAT_SUM],
        stats[:, segment.STAT_RSUM] + imp[:, segment.STAT_RSUM],
    ], dim=1))


def _histo_readout_fn(stats, imp, means, weights, qs):
    """Combined stats plus the per-row quantile readout (the
    reference's default "interp" interpolation)."""
    comb = _combine_stats_fn(stats, imp)
    qvals = tdigest._quantile_interp(means, weights, qs,
                                     comb[:, segment.STAT_MIN],
                                     comb[:, segment.STAT_MAX])
    return comb, qvals


def _histo_readout_rows_fn(stats, imp, means, weights, qs, idx):
    """_histo_readout restricted to the touched rows ``idx``: both the
    readback and the quantile readout's sort scale with the touched
    row count instead of the table capacity."""
    st = stats[idx]
    comb, qvals = _histo_readout_fn(st, imp[idx], means[idx],
                                    weights[idx], qs)
    return st, comb, qvals


def _histo_quantiles_slots_fn(stats, imp, means, weights, qs, row_idx,
                              slot_idx):
    """The quantile readout of a tiered table's wide rows: min/max from
    the row-indexed stat planes at ``row_idx``, centroids from the
    wide-slot pool at ``slot_idx`` (position-aligned)."""
    comb = _combine_stats_fn(stats[row_idx], imp[row_idx])
    return tdigest._quantile_interp(means[slot_idx], weights[slot_idx],
                                    qs, comb[:, segment.STAT_MIN],
                                    comb[:, segment.STAT_MAX])


def _gather_rows_fn(plane: torch.Tensor,
                    idx: torch.Tensor) -> torch.Tensor:
    """Compact selected rows on the device before readback."""
    return plane[idx]


# the readout steps, registered with the device-cost registry under the
# reference's names (/debug/vars, veneur.device.dispatches_total)
_combine_stats = observe.instrument("flusher.combine_stats",
                                    _combine_stats_fn)
_histo_readout = observe.instrument("flusher.histo_readout",
                                    _histo_readout_fn)
_histo_readout_rows = observe.instrument("flusher.histo_readout_rows",
                                         _histo_readout_rows_fn)
_histo_quantiles_slots = observe.instrument(
    "flusher.histo_quantiles_slots", _histo_quantiles_slots_fn)
_gather_rows = observe.instrument("flusher.gather_rows", _gather_rows_fn)
# the host set plane's union into the device registers (a bulk h2d
# copy each interval)
_union_host_plane = observe.instrument("flusher.hll_union_host_plane",
                                       hll.union)


def _percentile_suffix(p: float) -> str:
    """``.50percentile`` for 0.5; sub-percent quantiles keep their
    digits (``.999percentile``) — the reference's default "precise"
    naming."""
    scaled = p * 100
    if abs(scaled - round(scaled)) < 1e-9:
        return f"{int(round(scaled))}percentile"
    return f"{str(scaled).replace('.', '')}percentile"


@dataclass
class ForwardRow:
    """One row of mergeable state bound for the global tier."""
    meta: RowMeta
    kind: str  # counter | gauge | histo | set
    value: float = 0.0
    stats: np.ndarray | None = None  # f32[5]
    means: np.ndarray | None = None  # f32[C]
    weights: np.ndarray | None = None  # f32[C]
    regs: np.ndarray | None = None  # u8[M]


@dataclass
class FlushResult:
    metrics: list[im.InterMetric] = field(default_factory=list)
    forward: list[ForwardRow] = field(default_factory=list)
    tally: dict[str, int] = field(default_factory=dict)
    # columnar emit: when the flush ran with ``retain_frame=True`` the
    # emitted aggregates stay in ``frame`` and ``metrics`` holds only
    # what is appended afterwards (status checks); otherwise the frame
    # is materialized into ``metrics`` and this is None
    frame: MetricFrame | None = None
    # row-granularity routing counts for the conservation ledger: every
    # touched row is emitted, forwarded, both (overlap: default-scope
    # histos on a local), or retained (neither).  Counted from the
    # routing decisions, not derived as a residual, so the ledger's
    # ``staged == emitted + forwarded - overlap + retained`` is a real
    # check on the routing paths
    row_accounting: dict = field(default_factory=lambda: {
        "staged_rows": 0, "emitted_rows": 0, "forwarded_rows": 0,
        "overlap_rows": 0, "retained_rows": 0})

    def account_rows(self, staged: int = 0, emitted: int = 0,
                     forwarded: int = 0, overlap: int = 0,
                     retained: int = 0) -> None:
        acct = self.row_accounting
        acct["staged_rows"] += int(staged)
        acct["emitted_rows"] += int(emitted)
        acct["forwarded_rows"] += int(forwarded)
        acct["overlap_rows"] += int(overlap)
        acct["retained_rows"] += int(retained)

    def metric_count(self) -> int:
        return len(self.metrics) + (len(self.frame)
                                    if self.frame is not None else 0)

    def all_metrics(self) -> list[im.InterMetric]:
        """Every emitted InterMetric: the frame materialized, then the
        riders."""
        if self.frame is None:
            return self.metrics
        return self.frame.materialize() + self.metrics


class Flusher:
    """Emits a snapshot's touched rows and, when ``is_local``, collects
    the rows it forwards.  Its readouts run on ``device`` (default
    ``"cuda"``; raises without CUDA unless the caller passes
    ``"cpu"``); snapshot planes elsewhere are moved there first.
    ``columnar`` (default) assembles a MetricFrame; False runs the
    per-row emit."""

    def __init__(self, is_local: bool = False,
                 percentiles: tuple[float, ...] = DEFAULT_PERCENTILES,
                 aggregates: tuple[str, ...] = DEFAULT_AGGREGATES,
                 hostname: str = "",
                 device: "str | torch.device" = "cuda",
                 columnar: bool = True):
        self.device = resolve_device(device)
        self.is_local = is_local
        self.percentiles = tuple(percentiles)
        self.aggregates = tuple(aggregates)
        self.hostname = hostname
        self.columnar = columnar
        # scale-out arc handoff: a ``(meta) -> bool`` installed for one
        # flush (``Server.arc_handoff``).  True forwards the row even on
        # a global, and only forwards it: its keyspace arc now belongs
        # to another member.  None otherwise.
        self.handoff = None

    def flush(self, snap: Snapshot, now: int | None = None,
              cycle=None, retain_frame: bool = False) -> FlushResult:
        """Read the snapshot out and emit it.  ``cycle`` is an
        observe.FlushCycle (or the NULL_CYCLE default): stage spans and
        readback accounting for the three phases this method owns —
        dispatch, device wait, host emit.  ``retain_frame=True`` (the
        server's path) keeps the columnar emit's frame in ``res.frame``
        for per-sink routing; otherwise the frame is materialized into
        ``res.metrics``, the per-row emit's shape."""
        if cycle is None:
            cycle = observe.NULL_CYCLE
        ts = int(now if now is not None else time.time())
        res = FlushResult()
        pre = self._prefetch(snap, cycle)
        with cycle.stage("host_emit"):
            if self.columnar:
                frame = MetricFrame(ts, self.hostname)
                self._frame_counters(snap, res, pre, frame)
                self._frame_gauges(snap, res, pre, frame)
                self._frame_histos(snap, res, pre, frame)
                self._frame_sets(snap, res, pre, frame)
                if retain_frame:
                    res.frame = frame
                else:
                    res.metrics.extend(frame.materialize())
            else:
                self._flush_counters(snap, ts, res, pre)
                self._flush_gauges(snap, ts, res, pre)
                self._flush_histos(snap, ts, res, pre)
                self._flush_sets(snap, ts, res, pre)
        res.tally["overflow"] = sum(snap.overflow.values())
        return res

    # ------------------------------------------------------------------

    def _prefetch(self, snap: Snapshot, cycle=observe.NULL_CYCLE) -> dict:
        """Launch every device readout the flush needs, then read all
        results back to the host at once (re-scattering gathered rows
        into full-size host arrays).  Two traced stages: ``dispatch``
        covers the launches (asynchronous on a card), ``device_wait``
        the readback copies and the host re-scatter; the reference's
        older names ``device_dispatch`` / ``readback_sync`` record the
        same times."""
        with cycle.stage("dispatch", alias="device_dispatch") as sp:
            devs, pre, expand = self._dispatch(snap)
            sp.add_tag("device_arrays", str(len(devs)))
        with cycle.stage("device_wait", alias="readback_sync") as sp:
            for k, v in devs.items():
                pre[k] = v.cpu().numpy()
            nbytes = int(sum(pre[k].nbytes for k in devs))
            cycle.add_readback(nbytes)
            sp.add_tag("readback_bytes", str(nbytes))
            for dev_key, out_key, rows, shape in expand:
                out = pre.pop(dev_key)
                full = np.zeros(shape, out.dtype)
                full[rows] = out[:len(rows)]
                pre[out_key] = full
            # a tiered snapshot's host-side assembly (compact-row
            # quantiles, mixed-tier forward rows) needs the full
            # row-space readback
            for fn in pre.pop("_tier_post", []):
                fn(pre)
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
            # a local emits no percentiles, so it reads quantiles only
            # for a median or a local-only series
            need_q = bool(all_pcts) and (
                not self.is_local or "median" in self.aggregates or
                any(snap.histo_meta[r].scope == dsd.SCOPE_LOCAL
                    for r in histo_rows))
            qs = torch.tensor(all_pcts, dtype=torch.float32, device=dev)
            stats, imp, means, weights = (
                t.to(dev) for t in (snap.histo_stats,
                                    snap.histo_import_stats,
                                    snap.histo_means, snap.histo_weights))
            R = stats.shape[0]
            shape5 = (R, segment.HISTO_STAT_COLS)
            if snap.tiers is not None:
                self._dispatch_histos_tiered(
                    snap, histo_rows, all_pcts, need_q, qs,
                    (stats, imp, means, weights), devs, pre, expand)
            elif len(histo_rows) * 2 < R:
                idx = torch.as_tensor(histo_rows, device=dev)
                if need_q:
                    st_g, comb_g, qvals_g = _histo_readout_rows(
                        stats, imp, means, weights, qs, idx)
                    devs["qvals_g"] = qvals_g
                    expand.append(("qvals_g", "qvals", histo_rows,
                                   (R, len(all_pcts))))
                else:
                    st_g = _gather_rows(stats, idx)
                    comb_g = _combine_stats(st_g,
                                            _gather_rows(imp, idx))
                devs["stats_g"] = st_g
                devs["comb_g"] = comb_g
                expand.append(("stats_g", "stats", histo_rows, shape5))
                expand.append(("comb_g", "comb", histo_rows, shape5))
            else:
                if need_q:
                    comb, devs["qvals"] = _histo_readout(
                        stats, imp, means, weights, qs)
                else:
                    comb = _combine_stats(stats, imp)
                devs["stats"] = stats
                devs["comb"] = comb
            if snap.tiers is None:
                fwd = [int(r) for r in histo_rows
                       if self._forwardable(snap.histo_meta[r],
                                            always=True)]
                pre["histo_fwd"] = fwd
                if fwd:
                    idx = torch.as_tensor(fwd, device=dev)
                    devs["fwd_means"] = _gather_rows(means, idx)
                    devs["fwd_weights"] = _gather_rows(weights, idx)

        set_rows = np.nonzero(snap.set_touched[:len(snap.set_meta)])[0]
        pre["set_rows"] = set_rows
        if len(set_rows):
            fwd = [int(r) for r in set_rows
                   if self._forwardable(snap.set_meta[r], always=True)]
            pre["set_fwd"] = fwd
            fwd_set = set(fwd)
            need_est = any(int(r) not in fwd_set and
                           self._emit_local(snap.set_meta[r])
                           for r in set_rows)
            if snap.tiers is not None:
                # a tiered interval: the host plane is slot-indexed and
                # compact rows are sparse, so estimates and forwarded
                # registers go through the tier view (compact rows
                # materialize as dense u8[M] for the wire)
                if fwd:
                    pre["fwd_regs"] = [snap.tiers.set_row_regs(snap, r)
                                       for r in fwd]
                if need_est:
                    pre["ests"] = snap.tiers.set_estimates(snap,
                                                           set_rows)
            elif snap.host_only_sets:
                # the interval's sets live on the host: no device work
                if fwd:
                    pre["fwd_regs"] = snap.hll_host_plane[
                        np.asarray(fwd, np.int64)]
                if need_est:
                    pre["ests"] = snap.host_set_estimates()
            else:
                regs = snap.hll_regs.to(dev)
                if snap.hll_host_plane is not None:
                    observe.REGISTRY.note_h2d(snap.hll_host_plane.nbytes)
                    regs = _union_host_plane(regs, torch.from_numpy(
                        snap.hll_host_plane).to(dev))
                if fwd:
                    devs["fwd_regs"] = _gather_rows(
                        regs, torch.as_tensor(fwd, device=dev))
                if need_est:
                    devs["ests"] = hll.estimate(regs)
        return devs, pre, expand

    # ------------------------------------------------------------------
    # tiered dispatch: wide rows read quantiles at their pool slots on
    # the device; compact rows run the same _quantile_interp over
    # host-built singleton planes once the combined stats (their true
    # min/max) are back — one math path for both tiers, so a compact row
    # in its singleton regime reads as the untiered digest would

    def _dispatch_histos_tiered(self, snap: Snapshot, histo_rows,
                                all_pcts, need_q, qs, planes,
                                devs: dict, pre: dict,
                                expand: list) -> None:
        ti = snap.tiers
        dev = self.device
        stats, imp, means, weights = planes
        R = stats.shape[0]
        shape5 = (R, segment.HISTO_STAT_COLS)
        if len(histo_rows) * 2 < R:
            idx = torch.as_tensor(histo_rows, device=dev)
            st_g = _gather_rows(stats, idx)
            devs["stats_g"] = st_g
            devs["comb_g"] = _combine_stats(st_g, _gather_rows(imp, idx))
            expand.append(("stats_g", "stats", histo_rows, shape5))
            expand.append(("comb_g", "comb", histo_rows, shape5))
        else:
            devs["stats"] = stats
            devs["comb"] = _combine_stats(stats, imp)
        wide = ti.histo_tier[histo_rows].astype(bool)
        wrows = histo_rows[wide]
        crows = histo_rows[~wide]
        if need_q:
            if len(wrows):
                devs["qvals_w"] = _histo_quantiles_slots(
                    stats, imp, means, weights, qs,
                    torch.as_tensor(wrows, device=dev),
                    torch.as_tensor(ti.histo_slot[wrows].astype(np.int64),
                                    device=dev))
                expand.append(("qvals_w", "qvals", wrows,
                               (R, len(all_pcts))))

            def _compact_quantiles(pre, crows=crows,
                                   store=ti.histo_compact,
                                   npcts=len(all_pcts), R=R):
                qv = pre.get("qvals")
                if qv is None:
                    qv = pre["qvals"] = np.zeros((R, npcts), np.float32)
                if len(crows):
                    qv[crows] = self._compact_quantiles(
                        crows, store, pre["comb"], qs)

            pre.setdefault("_tier_post", []).append(_compact_quantiles)
        fwd = [int(r) for r in histo_rows
               if self._forwardable(snap.histo_meta[r], always=True)]
        pre["histo_fwd"] = fwd
        if not fwd:
            return
        fwide = ti.histo_tier[np.asarray(fwd, np.int64)] != 0
        wf = np.asarray(fwd, np.int64)[fwide]
        if len(wf):
            sidx = torch.as_tensor(ti.histo_slot[wf].astype(np.int64),
                                   device=dev)
            devs["fwd_means_w"] = _gather_rows(means, sidx)
            devs["fwd_weights_w"] = _gather_rows(weights, sidx)

        def _assemble_fwd(pre, fwd=fwd, fwide=fwide,
                          store=ti.histo_compact):
            mw = pre.pop("fwd_means_w", None)
            ww = pre.pop("fwd_weights_w", None)
            out_m, out_w = [], []
            j = 0
            for i, r in enumerate(fwd):
                if fwide[i]:
                    out_m.append(mw[j])
                    out_w.append(ww[j])
                    j += 1
                    continue
                v, w = (store.samples(r) if store is not None
                        else (np.empty(0, np.float32),) * 2)
                # mean-sorted like a digest plane, so the wire's
                # live-centroid list reads the same either tier
                o = np.argsort(v, kind="stable")
                out_m.append(np.ascontiguousarray(v[o]))
                out_w.append(np.ascontiguousarray(w[o]))
            pre["fwd_means"] = out_m
            pre["fwd_weights"] = out_w

        pre.setdefault("_tier_post", []).append(_assemble_fwd)

    def _compact_quantiles(self, crows, store, comb, qs) -> np.ndarray:
        """Quantiles of compact rows from their retained samples: the
        flush's ``_quantile_interp`` over singleton planes built on the
        host, read out on the flusher's device.  Rows are bucketed by
        sample count in powers of two (>= 64 columns, >= 8 rows), so one
        hot pre-promotion row never pads the whole batch to its
        depth."""
        dev = self.device
        npcts = int(qs.shape[0])
        planes = [store.samples(int(r)) if store is not None
                  else (np.empty(0, np.float32),) * 2 for r in crows]
        counts = np.array([len(v) for v, _ in planes], np.int64)
        order = np.argsort(counts, kind="stable")
        out = np.zeros((len(crows), npcts), np.float32)
        lo = 0
        while lo < len(order):
            c = int(max(counts[order[lo]], 1))
            cap = 1 << max(6, (c - 1).bit_length())
            hi = lo
            while hi < len(order) and counts[order[hi]] <= cap:
                hi += 1
            sel = order[lo:hi]
            n = 1 << max(3, int(len(sel) - 1).bit_length())
            cm = np.zeros((n, cap), np.float32)
            cw = np.zeros((n, cap), np.float32)
            for k, i in enumerate(sel):
                v, w = planes[i]
                cm[k, :len(v)] = v
                cw[k, :len(v)] = w
            rr = crows[sel]
            mn = np.zeros(n, np.float32)
            mx = np.zeros(n, np.float32)
            mn[:len(sel)] = comb[rr, segment.STAT_MIN]
            mx[:len(sel)] = comb[rr, segment.STAT_MAX]
            cq = tdigest._quantile_interp(
                *(torch.from_numpy(a).to(dev) for a in (cm, cw)), qs,
                *(torch.from_numpy(a).to(dev) for a in (mn, mx)))
            out[sel] = cq.cpu().numpy()[:len(sel)]
            lo = hi
        return out

    # ------------------------------------------------------------------

    def _emit_local(self, meta: RowMeta) -> bool:
        return meta.scope != dsd.SCOPE_GLOBAL or not self.is_local

    def _forwardable(self, meta: RowMeta, always: bool) -> bool:
        """Whether a local forwards the row: never local-scope rows;
        digests and sets always, counters and gauges when global-scope
        (``always`` False); on either tier, every row the handoff gate
        names."""
        if self.handoff is not None and self.handoff(meta):
            return True
        if not self.is_local or meta.scope == dsd.SCOPE_LOCAL:
            return False
        return always or meta.scope == dsd.SCOPE_GLOBAL

    def _mk(self, name: str, ts: int, value: float, meta: RowMeta,
            mtype: str) -> im.InterMetric:
        return im.InterMetric(name=name, timestamp=ts, value=value,
                              tags=meta.tags,
                              type=mtype, hostname=self.hostname)

    def _flush_scalars(self, snap, ts, res, pre, key, kind, mtype
                       ) -> None:
        """Counters or gauges: forward global-scope rows on a local,
        emit the rest."""
        vals = pre.get(key + "s")
        if vals is None:
            return
        meta_all = getattr(snap, key + "_meta")
        touched = getattr(snap, key + "_touched")[:len(meta_all)]
        n_fwd = n_emit = n_ret = 0
        for row in np.nonzero(touched)[0]:
            meta = meta_all[row]
            v = float(vals[row])
            if self._forwardable(meta, always=False):
                res.forward.append(ForwardRow(meta, kind, value=v))
                n_fwd += 1
            elif self._emit_local(meta):
                res.metrics.append(self._mk(meta.name, ts, v, meta, mtype))
                n_emit += 1
            else:
                n_ret += 1
        res.account_rows(staged=n_fwd + n_emit + n_ret, emitted=n_emit,
                         forwarded=n_fwd, retained=n_ret)
        res.tally[key + "s"] = int(touched.sum())

    def _flush_counters(self, snap, ts, res, pre) -> None:
        self._flush_scalars(snap, ts, res, pre, "counter", "counter",
                            im.COUNTER)

    def _flush_gauges(self, snap, ts, res, pre) -> None:
        self._flush_scalars(snap, ts, res, pre, "gauge", "gauge",
                            im.GAUGE)

    def _flush_histos(self, snap, ts, res, pre) -> None:
        """Aggregates for mixed-scope rows come from the local-sample
        plane (emitting them from merged state would double-count
        against the local tier's own emission); global-scope rows on a
        global use the combined plane (the reference's ``global``
        flush mode).  A local forwards every non-local-scope digest,
        still emits a mixed-scope row's local aggregates, and emits
        percentiles only for local-scope rows."""
        rows = pre["histo_rows"]
        if not len(rows):
            return
        stats = pre["stats"]
        comb = pre["comb"]
        qvals = pre.get("qvals")
        all_pcts = pre["all_pcts"]
        fwd_pos = {r: i for i, r in enumerate(pre["histo_fwd"])}
        n_fwd = n_emit = n_both = n_ret = 0
        for row in rows:
            meta = snap.histo_meta[row]
            st = stats[row]
            pos = fwd_pos.get(int(row))
            if pos is not None:
                res.forward.append(ForwardRow(
                    meta, "histo", stats=st.copy(),
                    means=pre["fwd_means"][pos].copy(),
                    weights=pre["fwd_weights"][pos].copy()))
                n_fwd += 1
                # a handed-off arc forwards only: its new owner emits it
                if self.handoff is not None and self.handoff(meta):
                    continue
            if meta.scope == dsd.SCOPE_GLOBAL and self.is_local:
                if pos is None:
                    n_ret += 1
                continue
            n_emit += 1
            if pos is not None:
                n_both += 1
            global_mode = (meta.scope == dsd.SCOPE_GLOBAL and
                           not self.is_local)
            self._emit_histo_row(
                res, meta, ts, comb[row] if global_mode else st, qvals,
                row, all_pcts,
                with_percentiles=(not self.is_local or
                                  meta.scope == dsd.SCOPE_LOCAL),
                global_mode=global_mode)
        res.account_rows(staged=len(rows), emitted=n_emit,
                         forwarded=n_fwd, overlap=n_both,
                         retained=n_ret)
        res.tally["histograms"] = int(
            snap.histo_touched[:len(snap.histo_meta)].sum())

    def _emit_histo_row(self, res, meta, ts, st, qvals, row, all_pcts,
                        with_percentiles=True, global_mode=False):
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
        if with_percentiles and qvals is not None:
            for pi, p in enumerate(self.percentiles):
                out.append(self._mk(
                    f"{meta.name}.{_percentile_suffix(p)}",
                    ts, float(qvals[row, pi]), meta, im.GAUGE))

    def _flush_sets(self, snap, ts, res, pre) -> None:
        rows = pre["set_rows"]
        if not len(rows):
            return
        ests = pre.get("ests")
        fwd_pos = {r: i for i, r in enumerate(pre.get("set_fwd", ()))}
        n_fwd = n_emit = n_ret = 0
        for row in rows:
            meta = snap.set_meta[row]
            pos = fwd_pos.get(int(row))
            if pos is not None:
                res.forward.append(ForwardRow(
                    meta, "set", regs=pre["fwd_regs"][pos].copy()))
                n_fwd += 1
            elif self._emit_local(meta):
                res.metrics.append(self._mk(meta.name, ts,
                                            float(round(ests[row])), meta,
                                            im.GAUGE))
                n_emit += 1
            else:
                n_ret += 1
        res.account_rows(staged=len(rows), emitted=n_emit,
                         forwarded=n_fwd, retained=n_ret)
        res.tally["sets"] = int(snap.set_touched[:len(snap.set_meta)].sum())

    # ------------------------------------------------------------------
    # columnar emit: the routing and gating of the per-row emit above,
    # evaluated as boolean arrays over the touched rows; one frame
    # block per aggregate kind, percentile suffixes built once a flush

    def _frame_scalar_class(self, metas, touched, vals, kind,
                            type_code, res, frame) -> None:
        """Counters and gauges: forward global-scope rows on a local,
        emit the rest."""
        rows = np.nonzero(touched[:len(metas)])[0]
        if not len(rows):
            return
        v64 = np.asarray(vals)[rows].astype(np.float64)
        fwd = self._handoff_mask(metas, rows)
        if self.is_local:
            fwd |= _scope_codes(metas, rows) == _SCOPE_GLOBAL
        for r, v in zip(rows[fwd], v64[fwd]):
            res.forward.append(ForwardRow(metas[r], kind,
                                          value=float(v)))
        emit = ~fwd
        frame.add_block(metas, rows[emit], v64[emit], type_code=type_code)
        res.account_rows(staged=len(rows), emitted=int(emit.sum()),
                         forwarded=int(fwd.sum()))

    def _handoff_mask(self, metas, rows) -> np.ndarray:
        """The handoff gate over ``rows`` (all False without one)."""
        if self.handoff is None:
            return np.zeros(len(rows), dtype=bool)
        return np.fromiter((bool(self.handoff(metas[int(r)]))
                            for r in rows), dtype=bool, count=len(rows))

    def _frame_counters(self, snap: Snapshot, res: FlushResult,
                        pre: dict, frame: MetricFrame) -> None:
        vals = pre.get("counters")
        if vals is None:
            return
        self._frame_scalar_class(snap.counter_meta, snap.counter_touched,
                                 vals, "counter", TYPE_COUNTER, res, frame)
        res.tally["counters"] = int(
            snap.counter_touched[:len(snap.counter_meta)].sum())

    def _frame_gauges(self, snap: Snapshot, res: FlushResult,
                      pre: dict, frame: MetricFrame) -> None:
        vals = pre.get("gauges")
        if vals is None:
            return
        self._frame_scalar_class(snap.gauge_meta, snap.gauge_touched,
                                 vals, "gauge", TYPE_GAUGE, res, frame)
        res.tally["gauges"] = int(
            snap.gauge_touched[:len(snap.gauge_meta)].sum())

    def _frame_histos(self, snap: Snapshot, res: FlushResult,
                      pre: dict, frame: MetricFrame) -> None:
        rows = pre["histo_rows"]
        if not len(rows):
            return
        metas = snap.histo_meta
        stats = pre["stats"]
        comb = pre["comb"]
        qvals = pre.get("qvals")
        all_pcts = pre["all_pcts"]
        tally = int(snap.histo_touched[:len(metas)].sum())
        # forward rows first, in row order, as the per-row emit does
        for pos, r in enumerate(pre["histo_fwd"]):
            res.forward.append(ForwardRow(
                metas[r], "histo", stats=stats[r].copy(),
                means=pre["fwd_means"][pos].copy(),
                weights=pre["fwd_weights"][pos].copy()))
        sc = _scope_codes(metas, rows)
        # routing counts mirror the per-row emit: on a local every
        # non-local-scope row forwards and every non-global-scope row
        # emits (default scope does both: its local aggregates emit
        # while its digest forwards); a global emits all.  A handed-off
        # row forwards only, on either tier
        ho = self._handoff_mask(metas, rows)
        if self.is_local:
            fwd_mask = ho | (sc != _SCOPE_LOCAL)
            emit_mask = ~ho & (sc != _SCOPE_GLOBAL)
            gm = np.zeros(int(emit_mask.sum()), dtype=bool)
            with_pcts = sc[emit_mask] == _SCOPE_LOCAL
        else:
            fwd_mask = ho
            emit_mask = ~ho
            gm = sc[emit_mask] == _SCOPE_GLOBAL
            with_pcts = np.ones(int(emit_mask.sum()), dtype=bool)
        res.account_rows(
            staged=len(rows), emitted=int(emit_mask.sum()),
            forwarded=len(pre["histo_fwd"]),
            overlap=int((emit_mask & fwd_mask).sum()),
            retained=int((~emit_mask & ~fwd_mask).sum()))
        erows = rows[emit_mask]
        if not len(erows):
            res.tally["histograms"] = tally
            return
        # global-scope rows on a global read the combined plane, every
        # other row the local-sample plane (see _flush_histos)
        st = np.where(gm[:, None], comb[erows], stats[erows]) \
            .astype(np.float64)
        weight = st[:, segment.STAT_WEIGHT]
        st_min = st[:, segment.STAT_MIN]
        st_max = st[:, segment.STAT_MAX]
        st_sum = st[:, segment.STAT_SUM]
        st_rsum = st[:, segment.STAT_RSUM]
        sampled = weight != 0
        agg = set(self.aggregates)

        def block(mask, vals, suffix, type_code=TYPE_GAUGE):
            frame.add_block(metas, erows[mask], vals, suffix, type_code)

        # the per-row emit's sparse-emission gates
        if "max" in agg:
            m = gm | (st_max != float(segment.STAT_MAX_EMPTY))
            block(m, st_max[m], ".max")
        if "min" in agg:
            m = gm | (st_min != float(segment.STAT_MIN_EMPTY))
            block(m, st_min[m], ".min")
        if "sum" in agg:
            m = gm | sampled
            block(m, st_sum[m], ".sum")
        if "avg" in agg:
            m = weight != 0
            block(m, st_sum[m] / weight[m], ".avg")
        if "count" in agg:
            m = gm | sampled
            block(m, weight[m], ".count", TYPE_COUNTER)
        if "hmean" in agg:
            m = (weight != 0) & (st_rsum != 0)
            block(m, weight[m] / st_rsum[m], ".hmean")
        if qvals is not None:
            q64 = qvals[erows].astype(np.float64)
            if "median" in agg:
                m = np.ones(len(erows), dtype=bool)
                block(m, q64[:, len(all_pcts) - 1], ".median")
            for pi, p in enumerate(self.percentiles):
                block(with_pcts, q64[with_pcts, pi],
                      "." + _percentile_suffix(p))
        res.tally["histograms"] = tally

    def _frame_sets(self, snap: Snapshot, res: FlushResult,
                    pre: dict, frame: MetricFrame) -> None:
        rows = pre["set_rows"]
        if not len(rows):
            return
        metas = snap.set_meta
        ests = pre.get("ests")
        fwd = pre.get("set_fwd", ())
        for pos, r in enumerate(fwd):
            res.forward.append(ForwardRow(
                metas[r], "set", regs=pre["fwd_regs"][pos].copy()))
        in_fwd = np.zeros(len(rows), dtype=bool)
        if fwd:
            in_fwd = np.isin(rows, np.asarray(fwd))
        sc = _scope_codes(metas, rows)
        emit = ~in_fwd & ~((sc == _SCOPE_GLOBAL) & self.is_local)
        res.account_rows(staged=len(rows), emitted=int(emit.sum()),
                         forwarded=len(fwd),
                         retained=int((~emit & ~in_fwd).sum()))
        erows = rows[emit]
        if len(erows) and ests is not None:
            vals = np.round(np.asarray(ests)[erows]).astype(np.float64)
            frame.add_block(metas, erows, vals)
        res.tally["sets"] = int(snap.set_touched[:len(metas)].sum())
