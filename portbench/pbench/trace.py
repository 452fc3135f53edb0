"""The traced run's reduction: a ``torch.profiler`` trace of the window
to device busy time, time by device operation, the cluster-merge
kernels' time, and the longest idle gaps named by what the host was
doing (the benchmark's own ``record_function`` spans).

The window is the span named ``WINDOW``; device work is every kernel,
copy and set on the card inside it.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from dataclasses import dataclass, field

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    by_op: dict = field(default_factory=dict)       # name -> seconds
    kernel_s: dict = field(default_factory=dict)    # full name -> seconds
    gaps: list = field(default_factory=list)        # [(name, seconds)]

    def kernel_seconds(self, pattern: str) -> float:
        """Seconds of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(s for n, s in self.kernel_s.items() if rx.search(n))

    def top_ops(self, n: int = 10) -> list:
        return sorted(self.by_op.items(), key=lambda kv: -kv[1])[:n]


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters: ``void at::native::foo<...>(...)`` -> ``at::native::foo``."""
    s = name
    if s.startswith("void "):
        s = s[5:]
    depth = 0
    out = []
    for ch in s:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    s = "".join(out).strip()
    return s or name


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: list) -> TraceSummary:
    """Reduce chrome-trace events (``ts``/``dur`` in microseconds)."""
    win = [e for e in events if e.get("name") == WINDOW and "dur" in e]
    if not win:
        raise ValueError("the trace holds no window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = []
    by_op: dict = {}
    kernel_s: dict = {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        dev.append((a, b))
        sec = (b - a) / 1e6
        nm = (short_name(e.get("name", "?")) if e["cat"] == "kernel"
              else e.get("name", "?"))
        by_op[nm] = by_op.get(nm, 0.0) + sec
        if e["cat"] == "kernel":
            kernel_s[e.get("name", "?")] = (
                kernel_s.get(e.get("name", "?"), 0.0) + sec)
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) / 1e6
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in events if e.get("cat") == "user_annotation"
             and "dur" in e and e.get("name") != WINDOW]
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = []
    for i in range(0, len(edges), 2):
        a, b = edges[i], edges[i + 1]
        if b > a:
            mid = (a + b) / 2
            names = sorted({n for s0, s1, n in spans if s0 <= mid <= s1})
            gaps.append(("+".join(names) or "none", (b - a) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    return TraceSummary((w1 - w0) / 1e6, busy_s, by_op, kernel_s, gaps[:10])


def summarize_profile(prof) -> TraceSummary:
    """Export a finished ``torch.profiler.profile`` as a chrome trace
    into the temporary directory, reduce it and delete the file."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return summarize(events)
