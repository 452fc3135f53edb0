"""The frame sink keeps a flush's columns and packs them as the legacy
list of metrics reads; drivers and metric readers are found by name."""

import os

import numpy as np
import pytest

from pbench import framesink, spec
from reference import compare


def test_pack_reads_as_the_materialized_list():
    from veneur_tpu_torch.core.frame import TYPE_COUNTER, MetricFrame
    from veneur_tpu_torch.core.metrics import InterMetric
    from veneur_tpu_torch.core.table import RowMeta
    metas = [RowMeta("a", ("z:1", "b:2"), "mixed", "histogram"),
             RowMeta("c", (), "mixed", "counter"),
             RowMeta("d", ("k:v",), "mixed", "histogram")]
    frame = MetricFrame(7, "h", common_tags=("env:t",))
    frame.add_block(metas, np.array([0, 2]), np.array([1.5, 2.5]), ".max")
    frame.add_block(metas, np.array([1]), np.array([3.0]),
                    type_code=TYPE_COUNTER)
    frame.extra.append(InterMetric(name="x", timestamp=7, value=4.0,
                                   tags=("q:1",)))
    sink = framesink.make_sink()
    sink.flush_frame(frame)
    got = compare.flush_values(framesink.pack(sink.take()))
    want = {(m.name, tuple(sorted(m.tags))): m.value
            for m in frame.materialize()}
    assert got == want and len(got) == 4
    assert sink.take() == []


def test_drivers_are_found_by_kind():
    for kind in ("dogstatsd", "fleet"):
        d = spec.driver(kind)
        assert callable(d.run) and callable(d.expected)
        assert callable(d.control_pair)
        assert d.WORK_METRIC in {"samples_per_s", "import_items_per_s"}
    with pytest.raises(FileNotFoundError):
        spec.driver("no-such-kind")


def test_metric_reader_falls_back_to_the_name_without_its_scope():
    assert spec.metric_reader("device_idle.local") is not None
    idle = spec.metric_reader("device_idle.global")
    assert idle.__module__ == spec.metric_reader("device_idle").__module__
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_metric.local")


def test_every_metric_and_kind_in_the_benchmark_has_its_file():
    import json
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["per_layer"]:
        spec.metric_reader(m["name"])
    for w in bench["workloads"]:
        spec.driver(spec.load_cell(w["name"]).traffic["kind"])


def test_every_held_cell_has_its_files():
    import glob
    import json
    from conftest import find_cell
    held = glob.glob(os.path.join(spec.PORTBENCH, "held", "*.json"))
    assert held
    for path in held:
        with open(path) as f:
            entries = json.load(f)
        for m in entries["per_layer"]:
            spec.metric_reader(m["name"])
        for w in entries["workloads"]:
            c = find_cell(w["name"])
            spec.driver(c.traffic["kind"])
            assert c.end_to_end and c.per_layer
