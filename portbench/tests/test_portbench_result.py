"""The last line's shape, for an untraced and a traced run."""

import json
import time

import run
from conftest import SMALL_TABLES, find_cell


def small_run(trace):
    cell = find_cell("local.mixed")
    cell.config["server"].update(SMALL_TABLES)
    return cell, run.run_cell(cell, 99, 0.3, trace, "cpu", scale=400,
                              build_dir=None, t_start=time.monotonic())


def test_untraced_line():
    cell, res = small_run(False)
    json.loads(json.dumps(res))
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for v in res["checks"].values():
        assert len(v) == 2
    # one feeder a reader shard of the configuration
    assert res["window"]["feeders"] == cell.config["server"]["num_readers"]


def test_traced_line():
    cell, res = small_run(True)
    assert set(res["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert "ingest_ms_per_interval.local" in res["metrics"]
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(res["breakdown"]["idle_gaps"]) <= 10
    assert list(res)[-1] == "checks"
