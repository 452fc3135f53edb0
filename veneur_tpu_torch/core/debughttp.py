"""Shared /debug/* introspection HTTP handlers.

The port's copy of ``veneur_tpu/core/debughttp.py``.  The reference
wires the same net/http/pprof surface onto BOTH the server's and the
proxy's HTTP listeners (server: server.go Handler(); proxy:
proxy.go:533-538), and so does the port:

- ``/debug/pprof`` | ``.../goroutine`` | ``.../threads``: thread
  stack dump (the goroutine profile's role)
- ``/debug/pprof/heap``: tracemalloc top allocations
  (``?start=1``/``?stop=1`` toggle tracing — per-allocation overhead
  must be opt-in and revocable on a long-running process)
- ``/debug/pprof/profile[?seconds=N]``: cProfile sample
- ``/debug/pprof/device[?seconds=N]``: on-demand torch.profiler
  capture of CPU and CUDA activity (the device-side profile
  net/http/pprof never had); the response lists the Chrome trace
  files it wrote
- ``/debug/vars``: expvar-style JSON dump (stats dict + device-cost
  registry), via ``vars_dump``
- ``/debug/ledger``: the sample-conservation ledger ring (last 128
  intervals, imbalances listed up front), via ``ledger_dump``;
  ``?n=`` bounds the dump to the newest N records
- ``/debug/trace/<trace_id>``: this process's fragment of a
  distributed flush trace, via ``trace_dump``
- ``/debug/signals``: the columnar signal-history ring
  (observe/signals.py) — ``?window=<sec>`` bounds it in time,
  ``?summary=1`` serves the one-row fleet-scrape shape, via
  ``signals_dump``
- ``/debug/flight``: flight-recorder bundle listing + fetch
  (``/debug/flight/<name>``), via ``flight_dump``
- ``/debug/overload``: overload control on its own (pressure, tenant
  buckets, shed attribution, the coalesce state); the server routes it

``SERVER_DEBUG_ENDPOINTS`` and ``PROXY_DEBUG_ENDPOINTS`` are the
authoritative inventories of every /debug/* path the port's server and
proxy serve; the tests hold each against a scan of its do_GET
routing.

Handlers are BaseHTTPRequestHandler methods; callers pass the request
handler plus a per-process lock serializing the profiler (only one
can be enabled per interpreter — cProfile, torch.profiler and
``enable_profiling`` all contend for it).
"""

from __future__ import annotations

import io
import json
import threading
import time

# every /debug/* path the port server's do_GET routes (core/server.py)
SERVER_DEBUG_ENDPOINTS = (
    "/debug/pprof",
    "/debug/flushes",
    "/debug/ledger",
    "/debug/trace",
    "/debug/overload",
    "/debug/signals",
    "/debug/flight",
    "/debug/cluster",
    "/debug/vars",
)

# every /debug/* path the port proxy's do_GET routes (core/proxy.py)
PROXY_DEBUG_ENDPOINTS = (
    "/debug/pprof",
    "/debug/trace",
    "/debug/ledger",
    "/debug/signals",
    "/debug/vars",
)


def respond_ok(handler, body: bytes = b"ok",
               ctype: str = "text/plain") -> None:
    handler.send_response(200)
    handler.send_header("Content-Type", ctype)
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def vars_dump(handler, sources: dict) -> None:
    """expvar's role (/debug/vars): one JSON object of live process
    state.  ``sources`` maps section name -> already-snapshotted
    plain data."""
    respond_ok(handler,
               json.dumps(sources, indent=1, default=str).encode(),
               "application/json")


def query_params(path: str) -> dict[str, str]:
    """The request's query string as a flat dict (last wins)."""
    _, _, query = path.partition("?")
    out: dict[str, str] = {}
    for part in query.split("&"):
        if part:
            k, _, v = part.partition("=")
            out[k] = v
    return out


def query_int(path: str, name: str, default: int = 0) -> int:
    try:
        return int(query_params(path).get(name, default))
    except (TypeError, ValueError):
        return default


def query_float(path: str, name: str, default: float = 0.0) -> float:
    try:
        return float(query_params(path).get(name, default))
    except (TypeError, ValueError):
        return default


def ledger_dump(handler, ledger, limit: int | None = None) -> None:
    """Serve the conservation-ledger ring as JSON (last 128 sealed
    intervals; ``imbalanced`` lists the seqs an operator should look
    at first).  ``limit`` (the ``?n=`` query param) bounds the dump
    to the newest N records."""
    if ledger is None:
        handler.send_error(404, "no ledger on this node")
        return
    respond_ok(handler, ledger.to_json(limit=limit),
               "application/json")


def signals_dump(handler, history, path: str) -> None:
    """Serve the signal-history ring: ``?window=<sec>`` bounds it in
    time (default: all retained rows), ``?summary=1`` serves the
    one-row shape vtop / /debug/cluster scrape."""
    if history is None:
        handler.send_error(404, "no signal history on this node")
        return
    if query_int(path, "summary", 0):
        body = json.dumps(history.summary(),
                          separators=(",", ":")).encode()
    else:
        body = history.to_json(query_float(path, "window", 0.0))
    respond_ok(handler, body, "application/json")


def flight_dump(handler, recorder, path: str) -> None:
    """Serve the flight recorder: ``/debug/flight`` lists bundle
    metadata + counters; ``/debug/flight/<name>`` serves one raw
    CRC-framed bundle for offline replay."""
    if recorder is None:
        handler.send_error(404, "no flight recorder on this node")
        return
    clean, _, _ = path.partition("?")
    tail = clean.partition("/debug/flight")[2].strip("/")
    if not tail:
        respond_ok(handler, json.dumps(
            {"bundles": recorder.list_bundles(),
             "stats": recorder.stats()}, indent=1).encode(),
            "application/json")
        return
    blob = recorder.get(tail)
    if blob is None:
        handler.send_error(404, f"no bundle {tail!r}")
        return
    respond_ok(handler, blob, "application/octet-stream")


def trace_dump(handler, index, path: str) -> None:
    """Serve one trace's local span fragment:
    ``/debug/trace/<trace_id>``.  With no id, lists the retained
    trace ids (oldest -> newest)."""
    if index is None:
        handler.send_error(404, "no trace index on this node")
        return
    tail = path.partition("/debug/trace")[2].strip("/")
    if not tail:
        respond_ok(handler, json.dumps(
            {"trace_ids": [str(t) for t in index.trace_ids()]},
            indent=1).encode(), "application/json")
        return
    try:
        tid = int(tail)
    except ValueError:
        handler.send_error(400, f"bad trace id {tail!r}")
        return
    respond_ok(handler, index.to_json(tid), "application/json")


def _query_seconds(query: str, default: float) -> float:
    if "seconds=" in query:
        try:
            return float(query.split("seconds=")[1].split("&")[0])
        except ValueError:
            pass
    return default


def pprof(handler, lock: threading.Lock) -> None:
    """Serve one /debug/pprof/* GET on ``handler``."""
    path, _, query = handler.path.partition("?")
    part = path.rsplit("/", 1)[-1]
    if part in ("pprof", "goroutine", "threads"):
        import sys
        import traceback
        names = {t.ident: t.name for t in threading.enumerate()}
        buf = io.StringIO()
        for tid, frame in sys._current_frames().items():
            buf.write(f"Thread {names.get(tid, tid)}:\n")
            buf.writelines(traceback.format_stack(frame))
            buf.write("\n")
        respond_ok(handler, buf.getvalue().encode())
    elif part == "heap":
        import tracemalloc
        if "start=1" in query:
            tracemalloc.start()
            respond_ok(handler, b"tracing started")
        elif "stop=1" in query:
            # tracing has per-allocation overhead: always stoppable
            # so one debug query can't degrade a long-running server
            # until restart
            tracemalloc.stop()
            respond_ok(handler, b"tracing stopped")
        elif not tracemalloc.is_tracing():
            respond_ok(handler, b"tracemalloc not tracing; GET "
                                b"/debug/pprof/heap?start=1 first")
        else:
            snap = tracemalloc.take_snapshot()
            top = snap.statistics("lineno")[:50]
            respond_ok(handler,
                       "\n".join(str(s) for s in top).encode())
    elif part == "device":
        # on-demand torch.profiler capture (observe/profiler.py); same
        # serialization as /profile — one profiling tool per process
        from veneur_tpu_torch.observe import capture_device_profile
        seconds = _query_seconds(query, 2.0)
        if not lock.acquire(blocking=False):
            handler.send_error(503, "profiling already in progress")
            return
        try:
            result = capture_device_profile(seconds)
        except Exception as e:
            handler.send_error(500, f"device profile failed: {e}")
            return
        finally:
            lock.release()
        respond_ok(handler, json.dumps(result, indent=1).encode(),
                   "application/json")
    elif part == "profile":
        import cProfile
        import pstats
        seconds = _query_seconds(query, 2.0)
        # only one profiler can be active per process (concurrent
        # requests or enable_profiling would raise): serialize, and
        # 503 on any other active profiling tool
        if not lock.acquire(blocking=False):
            handler.send_error(503, "profiling already in progress")
            return
        try:
            prof = cProfile.Profile()
            try:
                prof.enable()
            except ValueError as e:
                handler.send_error(503, str(e))
                return
            time.sleep(min(seconds, 30.0))
            prof.disable()
        finally:
            lock.release()
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats(
            "cumulative").print_stats(60)
        respond_ok(handler, buf.getvalue().encode())
    else:
        handler.send_error(404)
