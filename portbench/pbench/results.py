"""A run's result object: the reference's check, the cell's metrics,
the device, and (traced) the breakdown."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

from pbench import roofline
from pbench.spec import PORTBENCH, Cell, driver, metric_reader


@dataclass
class MetricContext:
    """What a per-layer metric reader may read."""
    intervals: list         # the window's harness.Interval records
    window_s: float
    flush_records: list     # the window's FlushRecords (observe/flushring)
    trace: object           # pbench.trace.TraceSummary, or None
    latencies: list         # fleet: seconds from due to acknowledged
    merge_floor_bytes: float  # least HBM bytes an interval's merges move


def limits_for(cell: Cell) -> dict:
    with open(os.path.join(PORTBENCH, "limits", cell.name + ".json")) as f:
        return json.load(f)["limits"]


def check(cell: Cell, out, seed: int, scale: int
          ) -> tuple[bool, dict, dict]:
    """Hold the kept flushes against the plain reference.  Returns
    (correct, {number: [value, limit]}, exact_off by part)."""
    from reference import compare
    ex = driver(cell.traffic["kind"]).expected(cell, out, seed, scale)
    r = compare.Readings()
    for n in sorted(out.kept):
        compare.compare_interval(compare.flush_values(out.kept[n]), ex, n,
                                 True, r)
    # every window interval's ledger record, kept or not
    r.exact["ledger"] += sum(not iv.ledger_ok for iv in out.intervals)
    return (*compare.judge(r.numbers(), limits_for(cell)), dict(r.exact))


def end_to_end(cell: Cell, out) -> dict:
    ivs = out.intervals
    vals = {"setup_s": out.setup_s,
            "flush_ms": 1e3 * sum(iv.flush_s for iv in ivs) / len(ivs),
            driver(cell.traffic["kind"]).WORK_METRIC:
                sum(iv.acked for iv in ivs) / out.window_s}
    return {m["name"]: {"value": vals[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if m["name"] in vals}


def per_layer(cell: Cell, out, scale: int) -> dict:
    ctx = MetricContext(out.intervals, out.window_s,
                        out.flush_records, out.trace, out.latencies,
                        roofline.merge_floor_bytes(cell.config, cell.traffic,
                                                   scale))
    got = {}
    for m in cell.per_layer:
        v = metric_reader(m["name"])(ctx)
        if v is not None:
            got[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return got


def device_info(device: str, out) -> dict:
    import torch
    if device.startswith("cuda"):
        d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
             "count": 1}
    else:
        d = {"platform": "cpu", "kind": "cpu", "count": 1}
    d["memory_peak_bytes"] = out.memory_peak_bytes
    if out.trace is not None:
        d["busy_s"] = out.trace.busy_s
        d["window_s"] = out.trace.window_s
    return d


def result(cell: Cell, out, seed: int, scale: int, device: str) -> dict:
    correct, checks, parts = check(cell, out, seed, scale)
    traced = out.trace is not None
    res = {"correct": correct,
           "attempted": sum(iv.sends for iv in out.intervals),
           "failed": sum(iv.failed for iv in out.intervals),
           "metrics": (per_layer(cell, out, scale) if traced
                       else end_to_end(cell, out)),
           "device": device_info(device, out),
           "window": {"intervals": len(out.intervals),
                      "seconds": out.window_s,
                      "compared": sorted(out.kept),
                      "ingest_s": [iv.ingest_s for iv in out.intervals],
                      "flush_s": [iv.flush_s for iv in out.intervals],
                      "gc_flush_s": [iv.gc_flush_s for iv in out.intervals],
                      **out.info},
           "exact_off_parts": parts}
    if traced:
        res["breakdown"] = {
            "device_ops": [[n, s] for n, s in out.trace.top_ops(10)],
            "idle_gaps": [[n, s] for n, s in out.trace.gaps[:10]]}
    res["checks"] = checks
    return res
