"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration (``configs`` entry,
whose ``file`` holds the server's settings) and a traffic mix
(``portbench/traffic/<traffic>.json``), which the driver of its
``kind`` (``portbench/drivers/<kind>.py``) runs.  A per-layer metric
``<name>`` is read by ``portbench/metrics/<name>.py``, or, where there is
no such file, by the reader of its name without the last dotted part
(``device_idle.local`` by ``device_idle.py``).  Adding a cell, a mix, a
driver or a metric adds files and entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PORTBENCH)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict           # the configuration file, as written
    traffic: dict
    traffic_path: str
    end_to_end: list[dict]  # the metrics this cell reports with --trace 0
    per_layer: list[dict]   # ... and with --trace 1


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: str | None = None) -> Cell:
    bench_path = bench_path or os.path.join(ROOT, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(wl)}")
    w = wl[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(ROOT, cfg_entry["file"])) as f:
        config = json.load(f)
    tpath = os.path.join(PORTBENCH, "traffic", w["traffic"] + ".json")
    with open(tpath) as f:
        traffic = json.load(f)
    return Cell(name, int(w["chips"]), config, traffic, tpath,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def _load(folder: str, name: str):
    path = os.path.join(PORTBENCH, folder, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    """The module ``portbench/drivers/<kind>.py``: its ``run``,
    ``expected``, ``control_pair``, ``PROTOCOL`` and ``WORK_METRIC``."""
    return _load("drivers", kind)


def metric_reader(name: str):
    """The ``read(ctx)`` of ``portbench/metrics/<name>.py``, or of the
    file named without the last dotted part."""
    base = name
    while not os.path.exists(os.path.join(PORTBENCH, "metrics",
                                          base + ".py")):
        if "." not in base:
            raise FileNotFoundError(f"no reader for metric {name!r}")
        base = base.rsplit(".", 1)[0]
    return _load("metrics", base).read
