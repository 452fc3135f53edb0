"""The port's observability records against the reference's modules:
the same calls on ``veneur_tpu_torch.observe`` / ``trace`` and on
``veneur_tpu.observe`` / ``trace`` give the same records (``to_dict``,
``to_json``, ``summary``), leaving out wall-clock fields.  Also the
port's own device-cost registry (a launch registry with CUDA event
pairs; on the CPU its device time stays null), its library build
counters and its ``torch.profiler`` capture.  Card-only cases carry the
``cuda`` marker; the file imports the JAX package only where it is
installed, so they also run on a host with only PyTorch.

Ports the unit halves of ``tests/test_observe.py``, ``tests/test_trace.py``,
``tests/test_signals.py`` and ``tests/test_flight.py``.  Exact equality
throughout: these records are integer and string bookkeeping.
"""

from __future__ import annotations

import json
import threading

import pytest
import torch

try:
    from veneur_tpu import observe as jobs
    from veneur_tpu import trace as jtrace
    from veneur_tpu.observe import recorder as jrecorder
    from veneur_tpu.observe import tracer as jtracer
except ImportError:  # a host with only PyTorch: the cuda cases run
    jobs = jtrace = jrecorder = jtracer = None
from veneur_tpu_torch import native, observe
from veneur_tpu_torch import trace as ttrace
from veneur_tpu_torch.observe import devicecost, recorder, tracer
from veneur_tpu_torch.ops import cluster_merge, tdigest
from veneur_tpu_torch.protocol import wire
from veneur_tpu_torch.protocol.gen import ssf_pb2

PKGS = {"jax": (jobs, jtrace, jrecorder, jtracer),
        "torch": (observe, ttrace, recorder, tracer)}


def _both(fn):
    """Run ``fn(observe, trace, recorder, tracer)`` on each package."""
    return {k: fn(*mods) for k, mods in PKGS.items()}


def _no_clock(d):
    """Drop wall-clock fields from a record dict (recursively)."""
    if isinstance(d, dict):
        return {k: _no_clock(v) for k, v in d.items()
                if k not in ("start_unix", "unix", "duration_ns",
                             "start_ns", "end_ns")}
    if isinstance(d, list):
        return [_no_clock(v) for v in d]
    return d


# ---- protocol + span API ---------------------------------------------------

def test_ssf_module_is_the_reference_copy():
    """Byte-identical generated module: both packages share one set of
    message classes in one interpreter."""
    from pathlib import Path
    import veneur_tpu.protocol.gen.ssf_pb2 as jssf
    assert (Path(ssf_pb2.__file__).read_bytes()
            == Path(jssf.__file__).read_bytes())
    assert ssf_pb2.SSFSpan is jssf.SSFSpan
    assert (Path(wire.__file__).parent / "ssf.proto").read_bytes() == \
        (Path(jssf.__file__).parent.parent / "ssf.proto").read_bytes()


@pytest.mark.parametrize("name,tags", [
    ("one", {}), ("", {"name": "adopted", "k": "v"}), ("x", {"a": "b"})])
def test_wire_frames_and_normalizes_as_reference(name, tags):
    from veneur_tpu.protocol import wire as jwire
    import io
    span = ssf_pb2.SSFSpan(id=3, trace_id=5, name=name, tags=tags,
                           start_timestamp=1, end_timestamp=2,
                           metrics=[ssf_pb2.SSFSample(name="m")])
    bufs = []
    for w in (wire, jwire):
        b = io.BytesIO()
        n = w.write_ssf(b, span)
        bufs.append(b.getvalue())
        assert n == len(b.getvalue())
    assert bufs[0] == bufs[1]
    got = [w.read_ssf(io.BytesIO(bufs[0])) for w in (wire, jwire)]
    assert got[0] == got[1]
    assert got[0].metrics[0].sample_rate == 1.0
    assert wire.valid_trace(got[0]) == jwire.valid_trace(got[1])
    assert wire.parse_ssf(span.SerializeToString()) == \
        jwire.parse_ssf(span.SerializeToString())


def test_span_tree_and_client_as_reference():
    """The same span calls build the same SSFSpan tree (ids aside), and
    a channel-backed client delivers each recorded span."""
    def run(obs, trace, rec, trc):
        got = []
        client = trace.Client(trace.ChannelBackend(got.append),
                              capacity=8)
        root = trace.Span("flush", service="veneur",
                          tags={"veneur.internal": "true"})
        child = root.child("flush.snapshot")
        child.add_tag("stage", "snapshot")
        child.set_error(ValueError("boom"))
        child.finish(client)
        with trace.start_span(client, "inner", parent=root) as sp:
            sp.add_tag("k", "v")
        root.finish(client)
        client.flush()
        client.close()
        assert child.proto.parent_id == root.span_id
        assert child.trace_id == root.trace_id
        return [(s.name, s.service, dict(s.tags), s.error,
                 s.parent_id == root.span_id, s.trace_id == root.trace_id)
                for s in got], client.sent, client.dropped
    out = _both(run)
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == 3


def test_client_backpressure_drops_not_blocks():
    """A full queue drops and counts, never blocks the caller (the
    reference's test, on both clients)."""
    def run(obs, trace, rec, trc):
        gate = threading.Event()
        client = trace.Client(trace.ChannelBackend(
            lambda s: gate.wait(5)), capacity=2)
        ok = [client.record(ssf_pb2.SSFSpan(id=i + 1)) for i in range(6)]
        gate.set()
        client.close()
        return sum(ok) + client.dropped
    out = _both(run)
    assert out["torch"] == out["jax"] == 6


# ---- flush ring, trace index, tracer ----------------------------------------

def test_flush_ring_as_reference():
    def run(obs, trace, rec, trc):
        ring = obs.FlushRing(capacity=3)
        for i in range(5):
            r = obs.FlushRecord(seq=ring.next_seq(), start_unix=float(i),
                                duration_ns=10 * i,
                                stages={"snapshot": i, "dispatch": 2 * i},
                                readback_bytes=100 * i, trace_id=7 + i)
            ring.append(r)
        return (json.loads(ring.to_json()), json.loads(ring.to_json(2)),
                ring.stage_summary())
    out = _both(run)
    assert out["torch"] == out["jax"]
    assert [r["seq"] for r in out["torch"][0]] == [3, 4, 5]


def test_trace_index_as_reference():
    spans = [ssf_pb2.SSFSpan(id=i + 1, trace_id=1 + i % 3, name=f"s{i}",
                             start_timestamp=100 - i, end_timestamp=200,
                             tags={"i": str(i)}) for i in range(12)]
    spans.append(ssf_pb2.SSFSpan(id=99, trace_id=0, name="untraced"))

    def run(obs, trace, rec, trc):
        idx = obs.TraceIndex(capacity=2, max_spans=3)
        for s in spans:
            idx.add(s)
        return (idx.trace_ids(), [json.loads(idx.to_json(t))
                                  for t in (1, 2, 3)])
    out = _both(run)
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == [2, 3]


def test_flush_tracer_cycle_as_reference():
    """The same stage calls make the same span tree (root + one child
    per stage, aliases recorded), the same record, and an indexed
    trace."""
    def run(obs, trace, rec, trc):
        got = []
        client = trace.Client(trace.ChannelBackend(got.append))
        ring = obs.FlushRing()
        index = obs.TraceIndex()
        reg = obs.DeviceCostRegistry()
        tr = obs.FlushTracer(client, ring, registry=reg, index=index)
        with tr.cycle() as cyc:
            with cyc.stage("snapshot"):
                pass
            with cyc.stage("dispatch", alias="device_dispatch") as sp:
                sp.add_tag("device_arrays", "3")
            cyc.add_readback(512)
            with pytest.raises(RuntimeError):
                with cyc.stage("forward"):
                    raise RuntimeError("wire down")
            tid, sid = cyc.wire_context()
            assert (tid, sid) == (cyc.root.trace_id, cyc.root.span_id)
        client.flush()
        client.close()
        r = ring.records()[-1]
        names = sorted(s["name"] for s in index.get(r.trace_id))
        return (sorted(r.stages), r.readback_bytes, r.seq, names,
                sorted((s.name, s.error, dict(s.tags).get("stage"))
                       for s in got), reg.totals()["readback_bytes_total"])
    out = _both(run)
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == ["device_dispatch", "dispatch", "forward",
                               "snapshot"]


def test_null_cycle_readback_still_counts():
    before = observe.REGISTRY.totals()["readback_bytes_total"]
    with observe.NULL_CYCLE.stage("dispatch") as sp:
        sp.add_tag("k", "v")
    observe.NULL_CYCLE.add_readback(4096)
    assert observe.NULL_CYCLE.wire_context() == (0, 0)
    assert observe.REGISTRY.totals()["readback_bytes_total"] == \
        before + 4096


# ---- signal history ----------------------------------------------------------

_ROWS = [{"a": 1, "b": 0.5, "c": 7}, {"a": 3, "b": float("nan"), "c": 7},
         {"a": 6, "b": 2.25, "zz": 1}, {"a": 10, "b": 2.5, "c": 9},
         {"a": 10, "b": 1e20, "c": -1}]


@pytest.mark.parametrize("capacity", [2, 3, 16])
def test_signal_history_as_reference(capacity):
    def run(obs, trace, rec, trc):
        h = obs.SignalHistory(("a", "b", "c"), capacity=capacity,
                              node="n", role="global")
        for i, row in enumerate(_ROWS):
            h.append(row, t=1000.0 + 2 * i, seq=i + 1)
        return (h.window(), h.window(limit=2), h.summary(), h.latest(),
                h.rows(), json.loads(h.to_json()))
    out = _both(run)
    assert out["torch"] == out["jax"]


def test_signal_history_empty_summary_and_schema():
    def run(obs, trace, rec, trc):
        h = obs.SignalHistory(("x",))
        with pytest.raises(ValueError):
            obs.SignalHistory(())
        return h.summary(), h.latest(), h.window()
    out = _both(run)
    assert out["torch"] == out["jax"]


# ---- flight recorder -----------------------------------------------------------

_FLIGHT_ROWS = [{"ledger.imbalanced_total": 0, "pressure.level": 0},
                {"ledger.imbalanced_total": 1, "pressure.level": 0},
                {"ledger.imbalanced_total": 1, "pressure.level": 2},
                {"ledger.imbalanced_total": 2, "pressure.level": 2,
                 "reshard.epoch": 1},
                {"ledger.imbalanced_total": 2, "pressure.level": 2,
                 "flush.overruns": 0}]


def _flight(obs, rec_mod, tmp, cooldown):
    h = obs.SignalHistory(("ledger.imbalanced_total", "pressure.level"),
                          capacity=8, node="n")
    fr = obs.FlightRecorder(h, context_fn=lambda trig, row: {"t": trig},
                            directory=tmp, cooldown=cooldown, node="n",
                            max_bundles=3)
    fired = []
    for i, row in enumerate(_FLIGHT_ROWS):
        h.append(row, t=50.0 + i, seq=i)
        fired.append(fr.observe(row, t=50.0 + i, seq=i))
    fr.drain()
    fr.stop()
    return fr, fired


@pytest.mark.parametrize("on_disk", [False, True])
@pytest.mark.parametrize("cooldown", [0.0, 3600.0])
def test_flight_recorder_as_reference(tmp_path, on_disk, cooldown):
    """Same rows, same triggers, same bundles; every bundle either
    package writes is read back equal by both packages' ``read_bundle``
    (the CRC framing is one format)."""
    out = {}
    for k, (obs, trace, rec_mod, trc) in PKGS.items():
        tmp = str(tmp_path / k) if on_disk else ""
        fr, fired = _flight(obs, rec_mod, tmp, cooldown)
        blobs = [fr.get(b["name"]) for b in fr.list_bundles()]
        stats = {k2: v for k2, v in fr.stats().items() if k2 != "directory"}
        out[k] = (fired, [_no_clock(b) for b in fr.list_bundles()],
                  stats, fr.by_trigger(), blobs)
    assert out["torch"][:4] == out["jax"][:4]
    assert out["torch"][0][1] == ["ledger_imbalance"]
    for blob_t, blob_j in zip(out["torch"][4], out["jax"][4]):
        for blob in (blob_t, blob_j):
            a, b = recorder.read_bundle(blob), jrecorder.read_bundle(blob)
            assert a is not None and a == b
        (ht, bt), (hj, bj) = (recorder.read_bundle(blob_t),
                              jrecorder.read_bundle(blob_j))
        assert _no_clock(bt) == _no_clock(bj)
        assert {k: v for k, v in ht.items() if k != "crc32"} == \
            {k: v for k, v in hj.items() if k != "crc32"}


def test_read_bundle_rejects_torn_and_corrupt():
    blob = recorder.frame_bundle({"trigger": "reshard"}, b'{"k": 1}')
    assert recorder.read_bundle(blob) == jrecorder.read_bundle(blob)
    for bad in (blob[:-1], blob.replace(b'"k"', b'"j"'), b"junk", b""):
        assert recorder.read_bundle(bad) is None
        assert jrecorder.read_bundle(bad) is None
    assert recorder.TRIGGER_NAMES == jrecorder.TRIGGER_NAMES


# ---- the launch registry ---------------------------------------------------------

class _FakeEvent:
    """A CPU stand-in for a recorded CUDA event pair's end event."""

    def __init__(self, done: bool, ms: float = 0.0):
        self.done = done
        self.ms = ms

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.ms


def test_registry_cpu_step_counts_calls_bytes_no_device_time():
    """On CPU tensors: calls, dispatch time, h2d bytes claimed from the
    copies noted before the launch, operand+result bytes as the
    estimate; no event pair, so device time stays None (never 0)."""
    reg = devicecost.DeviceCostRegistry()
    step = reg.instrument("table.counter_dense",
                          lambda a, b: a + b)
    a = torch.zeros(16)
    reg.note_h2d(64)
    step(a, torch.ones(16))
    step(a, torch.ones(16))
    snap = reg.snapshot()
    e = snap["kernels"]["table.counter_dense"]
    assert e["calls"] == 2 and e["h2d_bytes"] == 64
    assert e["est_bytes_accessed_per_call"] == 3 * 16 * 4
    assert e["device_duration_ns"] is None and e["device_calls"] == 0
    assert snap["device_duration_ns"] is None
    assert snap["events_pending"] == 0
    assert reg.totals()["dispatch_total"] == 2


def test_registry_counts_exactly_under_contention():
    """Eight threads (more than this host's cores) launching through one
    registry with a 10 µs switch interval: no call and no claimed host
    byte is lost."""
    import sys
    reg = devicecost.DeviceCostRegistry()
    step = reg.instrument("table.gauge_dense", lambda a: a)
    x = torch.zeros(4)
    n_threads, per = 8, 400

    def worker():
        for _ in range(per):
            reg.note_h2d(3)
            step(x)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    e = reg.snapshot()["kernels"]["table.gauge_dense"]
    assert e["calls"] == n_threads * per
    assert e["h2d_bytes"] == 3 * n_threads * per


def test_registry_merge_step_reports_merge_bytes():
    """A step that ran the cluster merge reports the merge's bytes
    (the kernel's bound formula), not its operands'."""
    reg = devicecost.DeviceCostRegistry()
    cap = tdigest.capacity_for(100.0)
    m = torch.zeros((4, cap))
    step = reg.instrument("table.td_add_samples_ranked_unit",
                          tdigest.add_samples_ranked_unit)
    step(m, m.clone(), torch.tensor([0, 1], dtype=torch.int32),
         torch.tensor([0, 0], dtype=torch.int32), torch.tensor([1.0, 2.0]),
         slots=8, compression=100.0)
    got = reg.snapshot()["kernels"]["table.td_add_samples_ranked_unit"]
    assert got["est_bytes_accessed_per_call"] == \
        cluster_merge.merge_bytes(4, cap, 8)


def test_registry_resolves_only_completed_pairs_and_bounds_pending():
    """Pairs resolve once their end event has completed (never
    waiting); past the bound the oldest pair is dropped and counted."""
    reg = devicecost.DeviceCostRegistry(max_pending=3)
    reg.instrument("s", lambda: None)
    pairs = [(_FakeEvent(True), _FakeEvent(True, 0.5)),
             (_FakeEvent(True), _FakeEvent(False, 9.0)),
             (_FakeEvent(True), _FakeEvent(True, 0.25))]
    for p in pairs:
        reg._record("s", 10, 0, 0, p)
    snap = reg.snapshot()
    e = snap["kernels"]["s"]
    assert e["device_duration_ns"] == 750_000 and e["device_calls"] == 2
    assert snap["events_pending"] == 1
    pairs[1][1].done = True
    for _ in range(4):  # past the bound: the oldest pending pairs drop
        reg._record("s", 10, 0, 0, (_FakeEvent(False),
                                    _FakeEvent(False)))
    assert reg.events_dropped == 2
    reg.add_readback(8)  # the readback resolves what completed
    assert reg.snapshot()["kernels"]["s"]["device_calls"] == 2


def test_registry_counts_library_builds_and_loads(tmp_path, monkeypatch):
    """``compile_*`` count builds of the port's libraries; a library
    already in ``_build/`` counts a cache hit."""
    native.load()  # built before the count starts
    before = observe.REGISTRY.totals()
    native.build()
    after = observe.REGISTRY.totals()
    assert after["compile_cache_hits"] == before["compile_cache_hits"] + 1
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    native.build()
    built = observe.REGISTRY.totals()
    assert built["compile_total"] == after["compile_total"] + 1
    assert built["compile_cache_misses"] == \
        after["compile_cache_misses"] + 1
    assert built["compile_duration_ns"] > after["compile_duration_ns"]


def test_reader_batches_as_reference():
    def run(obs, trace, rec, trc):
        reg = obs.DeviceCostRegistry()
        reg.add_reader_batch("udp-reader-0", 3, 10, 5, fused=True)
        reg.add_reader_batch("udp-reader-0", 1, 2, 5)
        reg.add_reader_batch("udp-reader-1", 4, 4, 1, fused=True)
        return reg.snapshot()["readers"]
    out = _both(run)
    assert out["torch"] == out["jax"]


def test_device_profile_capture_cpu(tmp_path):
    """Without a card the capture records CPU activity and writes one
    Chrome trace."""
    out = observe.capture_device_profile(0.05, base_dir=str(tmp_path))
    assert out["dir"].startswith(str(tmp_path))
    assert [f["name"] for f in out["files"]] == ["trace.json"]
    if not torch.cuda.is_available():
        assert out["activities"] == ["CPU"]
    with open(f"{out['dir']}/trace.json") as f:
        assert "traceEvents" in json.load(f)


# ---- card only ------------------------------------------------------------------

@pytest.mark.cuda
def test_registry_event_device_time_on_card():
    """A step on CUDA tensors records an event pair on the current
    stream; once the card has finished it resolves to a positive device
    time (never before: snapshot does not synchronize)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    reg = devicecost.DeviceCostRegistry()
    step = reg.instrument("flusher.gather_rows", lambda p, i: p[i])
    plane = torch.rand((1 << 16, 64), device="cuda")
    idx = torch.arange(0, 1 << 16, 2, device="cuda")
    for _ in range(4):
        step(plane, idx)
    torch.cuda.synchronize()
    e = reg.snapshot()["kernels"]["flusher.gather_rows"]
    assert e["calls"] == 4 and e["device_calls"] == 4
    assert e["device_duration_ns"] > 0


@pytest.mark.cuda
def test_device_profile_names_the_merge_kernel(tmp_path):
    """The capture traces the card through CUPTI: a merge launched
    through ctypes appears as ``cluster_merge_kernel``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cap = tdigest.capacity_for(100.0)
    m = torch.zeros((1024, cap), device="cuda")
    w = torch.zeros((1024, cap), device="cuda")
    nm = torch.rand((1024, 64), device="cuda")
    nw = torch.ones((1024, 64), device="cuda")
    kw = dict(delta=tdigest._SCALE_MULT * 100.0,
              tail_coeff=tdigest._TAIL_MULT * 100.0,
              tail_q0=tdigest._TAIL_Q0, tail_qmin=tdigest._TAIL_QMIN)
    cluster_merge.cluster_merge(m, w, nm, nw, **kw)
    torch.cuda.synchronize()
    done = threading.Event()

    def burst():
        while not done.is_set():
            cluster_merge.cluster_merge(m, w, nm, nw, **kw)
            torch.cuda.synchronize()
    th = threading.Thread(target=burst)
    th.start()
    try:
        out = observe.capture_device_profile(0.5, base_dir=str(tmp_path))
    finally:
        done.set()
        th.join()
    with open(f"{out['dir']}/trace.json") as f:
        names = {ev.get("name", "") for ev in json.load(f)["traceEvents"]
                 if ev.get("cat") == "kernel"}
    assert any("cluster_merge_kernel" in n for n in names), sorted(names)
