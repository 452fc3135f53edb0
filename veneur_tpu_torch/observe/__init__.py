"""Self-observation: the server watching its own hot path.

The port's counterpart of ``veneur_tpu/observe/``.  The reference
veneur traces its own flushes (flusher.go:29
``trace.StartSpanFromContext``) and exposes ``/debug/pprof``
(http.go:52-57); this package is the device-aware extension of both:

``devicecost`` — a launch registry of the hot path's device steps:
    calls, host dispatch time, device time from CUDA event pairs,
    host-to-device and estimated accessed bytes, readback bytes, and
    the builds of the port's native and CUDA libraries.
``flushring``  — per-flush-cycle records (stage durations, readback
    bytes, tallies) in a bounded ring, served at ``/debug/flushes``.
``tracer``     — the flush cycle's nested SSF span tree (snapshot ->
    dispatch -> device wait -> host emit -> sink flush -> forward),
    emitted through the server's own loopback trace client.
``profiler``   — on-demand ``torch.profiler`` captures for
    ``/debug/pprof/device?seconds=N``.
``ledger``     — per-interval sample-conservation ledger: every hot
    path credits received/staged/dropped/emitted/forwarded counts and
    the interval closes with balance checks, served at
    ``/debug/ledger`` (strict mode: ``VENEUR_TPU_LEDGER_STRICT``).
``traceindex`` — bounded per-process index of recent internal spans
    keyed by trace id, served at ``/debug/trace/<trace_id>`` so one
    interval's cross-tier span tree is queryable on every node.
``signals``    — fixed-schema columnar ring of per-flush signal rows
    (EWMA rate + delta computed at append), served at
    ``/debug/signals?window=<sec>``.
``recorder``   — anomaly flight recorder: trigger predicates over the
    signal rows dump CRC-framed incident bundles, listed at
    ``/debug/flight``.
"""

from veneur_tpu_torch.observe.devicecost import (DeviceCostRegistry,
                                                 REGISTRY, instrument)
from veneur_tpu_torch.observe.flushring import FlushRecord, FlushRing
from veneur_tpu_torch.observe.ledger import (ClassDropTally, Ledger,
                                             LedgerRecord, ProxyLedger,
                                             SpoolLedger,
                                             SpoolLedgerRecord)
from veneur_tpu_torch.observe.tracer import (FlushCycle, FlushTracer,
                                             NULL_CYCLE, NullCycle)
from veneur_tpu_torch.observe.traceindex import TraceIndex, span_to_dict
from veneur_tpu_torch.observe.profiler import capture_device_profile
from veneur_tpu_torch.observe.recorder import (FlightRecorder,
                                               read_bundle,
                                               TRIGGER_NAMES)
from veneur_tpu_torch.observe.signals import SignalHistory

__all__ = ["DeviceCostRegistry", "REGISTRY", "instrument",
           "FlushRecord", "FlushRing", "FlushCycle", "FlushTracer",
           "NullCycle", "NULL_CYCLE", "capture_device_profile",
           "ClassDropTally", "Ledger", "LedgerRecord", "ProxyLedger",
           "SpoolLedger", "SpoolLedgerRecord",
           "TraceIndex", "span_to_dict",
           "SignalHistory", "FlightRecorder", "read_bundle",
           "TRIGGER_NAMES"]
