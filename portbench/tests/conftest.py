"""The benchmark's own tests: ``python -m pytest portbench/tests``.

The card-marked tests (``-m cuda``) run each cell on the card and skip
without one."""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(PORTBENCH)
for p in (PORTBENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

# table sizes for runs on the CPU at a test's scale
SMALL_TABLES = {"tpu_counter_rows": 512, "tpu_gauge_rows": 512,
                "tpu_histo_rows": 256, "tpu_set_rows": 64}


def bench_cells() -> list[str]:
    """The cells ``BENCHMARK.json`` names."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


def find_cell(name: str):
    """The cell ``name`` of ``BENCHMARK.json``, or, where it names no
    such cell, the one held back in ``portbench/held/<name>.json``."""
    from pbench.spec import load_cell
    if name in bench_cells():
        return load_cell(name)
    return load_cell(name, os.path.join(PORTBENCH, "held", name + ".json"))
