"""What every cell driver shares: the server, set-up, the measured
window.

A driver (``portbench/drivers/<kind>.py``, found by the traffic's
``kind``) runs the port's ``Server`` in this process with the
benchmark's frame sink (``pbench.framesink``) and no ticker, and hands
``window`` a function that takes one interval's traffic; the window
then calls the server's own ``flush_once()``, so every flush closes
exactly one interval.

Set-up takes two whole intervals and their flushes (the table
double-buffers its interval state), so the window compiles, builds and
first-touches nothing.  The window runs whole intervals until
``seconds`` have passed; its rates are the work of those intervals over
their time.  Intervals are kept for the check by a reservoir drawn from
the seed; their frames are packed for the reference after the window.
"""

from __future__ import annotations

import gc
import os
import time
from contextlib import nullcontext
from dataclasses import dataclass, field

from pbench import framesink, plan as planmod
from pbench.spec import PORTBENCH, Cell

KEEP_INTERVALS = 4
BUILD_DIR = os.path.join(PORTBENCH, "_cache", "build")


@dataclass
class Interval:
    n: int
    ingest_s: float
    flush_s: float
    end: float
    acked: int          # samples (DogStatsD) or items (fleet) acknowledged
    sends: int
    failed: int
    ledger_ok: bool
    gc_flush_s: float = 0.0   # the collector's seconds inside the flush


@dataclass
class RunOutput:
    setup_s: float
    window_s: float
    intervals: list[Interval]
    kept: dict                      # interval number -> packed flush
    flush_records: list
    latencies: list = field(default_factory=list)
    trace: object = None
    memory_peak_bytes: int = 0
    plan: object = None
    info: dict = field(default_factory=dict)


def make_server(cell: Cell, device: str, build_dir: str | None):
    """The port's server at the cell's configuration, the frame sink,
    no listener and no ticker."""
    from veneur_tpu_torch.core.config import read_config
    from veneur_tpu_torch.core.server import Server
    data = dict(cell.config["server"])
    if build_dir:
        os.makedirs(build_dir, exist_ok=True)
        data["compile_cache_dir"] = build_dir
    cfg = read_config(data=data, env={})
    sink = framesink.make_sink()
    return Server(cfg, device=device, extra_sinks=[sink]), sink


def _profiler(trace: bool):
    if not trace:
        return nullcontext(None)
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def span(trace: bool, name: str):
    if not trace:
        return nullcontext()
    import torch
    return torch.profiler.record_function(name)


class GcClock:
    """Seconds the interpreter's cyclic collector ran, and how many of
    its runs were full (generation 2) collections."""

    def __init__(self):
        self.seconds = 0.0
        self.full = 0
        self._t0 = 0.0
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._t0
            self.full += info.get("generation") == 2

    def close(self):
        gc.callbacks.remove(self._cb)


class Reservoir:
    """A sample of ``k`` intervals, uniform over however many come,
    drawn from the seed."""

    def __init__(self, seed: int, k: int = KEEP_INTERVALS):
        self.rng = planmod.rng_for(seed, 9)
        self.k = k
        self.seen = 0
        self.kept: dict = {}

    def offer(self, n: int, make) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept[n] = make()
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            del self.kept[sorted(self.kept)[j]]
            self.kept[n] = make()


def window(srv, sink, interval, protocol: str, seed: int, seconds: float,
           trace: bool, t_setup0: float) -> RunOutput:
    """Set-up's two intervals, then whole intervals for ``seconds``.
    ``interval(n)`` takes interval ``n``'s traffic and returns its
    ``Interval`` and whether every part was acknowledged."""
    from reference.compare import ledger_ok
    import torch

    gcc = GcClock()

    def one(n: int, res: Reservoir | None) -> Interval:
        iv, acked_ok = interval(n)
        g0 = gcc.seconds
        t0 = time.monotonic()
        with span(trace, "flush_once"):
            srv.flush_once()
        t1 = time.monotonic()
        iv.gc_flush_s = gcc.seconds - g0
        frames = sink.take()
        rec = srv.ledger.last()
        iv.flush_s, iv.end = t1 - t0, t1
        iv.ledger_ok = acked_ok and ledger_ok(rec, protocol, iv.acked)
        if res is not None:
            res.offer(n, lambda: frames)
        return iv

    # set-up: two whole intervals, so both of the table's interval
    # states (it double-buffers them) have taken the cell's shapes
    warm = [one(-2, None), one(-1, None)]
    n_rec0 = len(srv.flush_ring.records())
    gc0 = (gcc.seconds, gcc.full)
    res = Reservoir(seed)
    ivs = []
    setup_s = time.monotonic() - t_setup0
    with _profiler(trace) as prof:
        with span(trace, "portbench.window"):
            t0 = time.monotonic()
            n = 1
            while True:
                ivs.append(one(n, res))
                n += 1
                if ivs[-1].end - t0 >= seconds:
                    break
    window_s = ivs[-1].end - t0
    gc_win = (gcc.seconds - gc0[0], gcc.full - gc0[1])
    gcc.close()
    summary = None
    if trace:
        from pbench.trace import summarize_profile
        summary = summarize_profile(prof)
    peak = (int(torch.cuda.max_memory_allocated())
            if torch.cuda.is_available() else 0)
    recs = srv.flush_ring.records()[n_rec0:]
    stages: dict = {}
    for r in recs:
        for k, v in r.stages.items():
            stages[k] = stages.get(k, 0.0) + v / 1e6 / len(recs)
    kept = {n: framesink.pack(f) for n, f in res.kept.items()}
    return RunOutput(setup_s, window_s, ivs, kept, recs, trace=summary,
                     memory_peak_bytes=peak,
                     info={"setup_intervals": [[iv.ingest_s, iv.flush_s]
                                               for iv in warm],
                           "gc_window_s": gc_win[0], "gc_full": gc_win[1],
                           "flush_stage_ms": stages})
