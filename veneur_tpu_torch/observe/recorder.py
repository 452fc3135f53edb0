"""Anomaly flight recorder: capture state *around* an anomaly.

The port's copy of ``veneur_tpu/observe/recorder.py``.

When a ledger interval goes imbalanced at 03:00, the snapshot
endpoints show the state NOW — the interesting state was thirty
seconds ago.  The flight recorder watches every row the signal
history appends (:mod:`veneur_tpu_torch.observe.signals`) and, on a small
set of trigger predicates — ledger imbalance, breaker open
transition, pressure engage/level change, flush overrun/coalesce,
recovery replay, reshard/handoff — dumps one *bundle*: the last K
signal rows, the sealed ledger record(s) for the triggering interval,
the flush-ring entry and trace tree for that interval, and
breaker/spool/overload snapshots.  A bundle is the whole incident in
one file, readable offline with :func:`read_bundle`.

Framing follows ops/checkpoint.py's segment format so torn or
truncated dumps are detected, never trusted: ``MAGIC`` + one JSON
header line (trigger, unix, seq, node, ``body_bytes``, ``crc32``)
+ the JSON body the crc32 covers.

Triggers are rate-limited per trigger name (``cooldown`` seconds,
``VENEUR_TPU_FLIGHT_COOLDOWN``) so a flapping breaker writes one
bundle per cooldown, not one per flush.  Storage is bounded by count
AND bytes with evict-oldest (``VENEUR_TPU_FLIGHT_MAX_BUNDLES`` /
``VENEUR_TPU_FLIGHT_MAX_BYTES``); with ``VENEUR_TPU_FLIGHT_DIR``
unset, bundles live in a bounded in-memory store with the same
framing, so ``/debug/flight`` works without any disk configuration.

Snapshot capture happens synchronously in :meth:`FlightRecorder.observe`
(cheap dict copies, on the flush thread); serialization + CRC + disk
write happen on a dedicated ``flight-dump-*`` writer thread so a slow
disk never extends a flush interval.

Counted in ``veneur.flight.bundles_total`` (tag ``trigger:<name>``)
and ``veneur.flight.suppressed_total``; the history plane itself
reports ``veneur.signals.rows_total``.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import zlib
from collections import OrderedDict

MAGIC = b"VTPUFLT1\n"
BUNDLE_SUFFIX = ".bundle"
DEFAULT_MAX_BUNDLES = 64
DEFAULT_MAX_BYTES = 64 * 1024 * 1024
DEFAULT_COOLDOWN = 30.0
DEFAULT_LAST_K = 32


def _inc(prev: dict, cur: dict, name: str) -> bool:
    """True when counter ``name`` grew between rows (missing -> 0)."""
    return (cur.get(name) or 0) > (prev.get(name) or 0)


def _chg(prev: dict, cur: dict, name: str) -> bool:
    return (cur.get(name) or 0) != (prev.get(name) or 0)


# trigger name -> predicate(prev_row, cur_row); evaluated on every
# appended signal row, AFTER the first (no baseline -> no verdict).
# Names match the fault classes the chaos/overload soaks inject, so
# bench gates can assert "fault X produced bundle with trigger X".
TRIGGERS: tuple[tuple[str, object], ...] = (
    ("ledger_imbalance",
     lambda p, c: _inc(p, c, "ledger.imbalanced_total")),
    ("breaker_open",
     lambda p, c: _inc(p, c, "breaker.opens_total")
     or _inc(p, c, "breaker.open")),
    ("pressure_change",
     lambda p, c: _chg(p, c, "pressure.level")
     or _chg(p, c, "pressure.engaged")),
    ("flush_overrun",
     lambda p, c: _inc(p, c, "flush.overruns")
     or _inc(p, c, "flush.coalesced")),
    ("recovery_replay",
     lambda p, c: _inc(p, c, "spool.replayed_items")
     or _inc(p, c, "recover.recovered_items")
     or _inc(p, c, "recover.replay_wires")),
    ("reshard",
     lambda p, c: _chg(p, c, "reshard.epoch")
     or _inc(p, c, "reshard.moved_rows")
     or _inc(p, c, "reshard.received_items")),
    ("handoff",
     lambda p, c: _inc(p, c, "handoff.shipped_items")
     or _inc(p, c, "handoff.received_items")),
)

TRIGGER_NAMES = tuple(name for name, _ in TRIGGERS)


def frame_bundle(header: dict, body: bytes) -> bytes:
    header = dict(header)
    header["body_bytes"] = len(body)
    header["crc32"] = zlib.crc32(body) & 0xFFFFFFFF
    return MAGIC + json.dumps(header).encode() + b"\n" + body


def read_bundle(blob_or_path) -> tuple[dict, dict] | None:
    """Parse + CRC-verify one bundle (bytes or a file path); the
    offline replay entrypoint.  None for torn/foreign/corrupt input —
    a bad bundle must never masquerade as evidence."""
    if isinstance(blob_or_path, (str, os.PathLike)):
        try:
            with open(blob_or_path, "rb") as f:
                blob = f.read()
        except OSError:
            return None
    else:
        blob = bytes(blob_or_path)
    if not blob.startswith(MAGIC):
        return None
    try:
        rest = blob[len(MAGIC):]
        line, _, body = rest.partition(b"\n")
        header = json.loads(line.decode())
        body = body[:int(header["body_bytes"])]
        if len(body) != int(header["body_bytes"]):
            return None
        if (zlib.crc32(body) & 0xFFFFFFFF) != int(header["crc32"]):
            return None
        return header, json.loads(body.decode())
    except (ValueError, KeyError, json.JSONDecodeError):
        return None


class FlightRecorder:
    """Evaluate trigger predicates per signal row; dump CRC-framed
    incident bundles, rate-limited per trigger, bounded by
    count+bytes with evict-oldest."""

    def __init__(self, history, context_fn=None, directory: str = "",
                 max_bundles: int = DEFAULT_MAX_BUNDLES,
                 max_bytes: int = DEFAULT_MAX_BYTES,
                 cooldown: float = DEFAULT_COOLDOWN,
                 last_k: int = DEFAULT_LAST_K,
                 node: str = "", triggers=TRIGGERS):
        self.history = history
        # context_fn(trigger, row) -> dict of incident context (sealed
        # ledger records, flush record, trace tree, snapshots); must
        # be cheap — it runs on the flush thread at trigger time
        self.context_fn = context_fn
        self.directory = directory
        self.max_bundles = max(1, int(max_bundles))
        self.max_bytes = max(4096, int(max_bytes))
        self.cooldown = max(0.0, float(cooldown))
        self.last_k = max(1, int(last_k))
        self.node = node
        self.triggers = tuple(triggers)
        self._prev: dict | None = None
        self._last_fire: dict[str, float] = {}
        self._lock = threading.Lock()
        # in-memory store (also the listing index in disk mode):
        # name -> (meta dict, blob | None when on disk)
        self._bundles: OrderedDict[str, tuple[dict, bytes | None]] = (
            OrderedDict())
        self._bytes = 0
        self.bundles_total = 0
        self.suppressed_total = 0
        self.errors_total = 0
        self._by_trigger: dict[str, int] = {}
        self._q: queue.Queue = queue.Queue(maxsize=64)
        self._writer: threading.Thread | None = None
        self._stopped = False
        if self.directory:
            os.makedirs(self.directory, exist_ok=True)
            self._adopt_existing()

    # -- trigger path --------------------------------------------------

    def observe(self, row: dict, t: float | None = None,
                seq: int = 0) -> list[str]:
        """Evaluate triggers for one appended row; returns the trigger
        names that fired (post-cooldown).  First row only seeds the
        baseline."""
        t = time.time() if t is None else float(t)
        prev, self._prev = self._prev, dict(row)
        if prev is None or self._stopped:
            return []
        fired = []
        for name, pred in self.triggers:
            try:
                hit = bool(pred(prev, row))
            except Exception:
                hit = False
            if not hit:
                continue
            now = time.monotonic()
            last = self._last_fire.get(name)
            if last is not None and (now - last) < self.cooldown:
                self.suppressed_total += 1
                continue
            self._last_fire[name] = now
            fired.append(name)
            self._fire(name, row, t, seq)
        return fired

    def _fire(self, trigger: str, row: dict, t: float,
              seq: int) -> None:
        payload = {
            "trigger": trigger,
            "node": self.node,
            "unix": t,
            "seq": seq,
            "row": dict(row),
            "history": self.history.window(limit=self.last_k)
            if self.history is not None else None,
        }
        if self.context_fn is not None:
            try:
                payload["context"] = self.context_fn(trigger, row)
            except Exception as e:
                payload["context"] = {
                    "error": f"{type(e).__name__}: {e}"}
        name = (f"flt-{int(t * 1000):013d}-{int(seq):06d}-"
                f"{trigger}{BUNDLE_SUFFIX}")
        header = {"trigger": trigger, "unix": t, "seq": int(seq),
                  "node": self.node, "version": 1}
        self._ensure_writer()
        try:
            self._q.put_nowait((name, header, payload))
        except queue.Full:
            # a wedged disk must not grow an unbounded backlog
            self.errors_total += 1

    # -- writer thread -------------------------------------------------

    def _ensure_writer(self) -> None:
        with self._lock:
            if self._writer is None or not self._writer.is_alive():
                self._writer = threading.Thread(
                    target=self._writer_loop,
                    name=f"flight-dump-{self.node or 'node'}",
                    daemon=True)
                self._writer.start()

    def _writer_loop(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                return
            name, header, payload = job
            try:
                body = json.dumps(payload, separators=(",", ":"),
                                  default=str).encode()
                blob = frame_bundle(header, body)
                self._store(name, header, blob)
            except Exception:
                self.errors_total += 1

    def _store(self, name: str, header: dict, blob: bytes) -> None:
        meta = {"name": name, "trigger": header.get("trigger", ""),
                "unix": header.get("unix", 0.0),
                "seq": header.get("seq", 0), "bytes": len(blob)}
        on_disk = bool(self.directory)
        if on_disk:
            path = os.path.join(self.directory, name)
            tmp = os.path.join(self.directory, f".tmp-{name}")
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        with self._lock:
            self._bundles[name] = (meta, None if on_disk else blob)
            self._bytes += len(blob)
            self.bundles_total += 1
            trig = meta["trigger"]
            self._by_trigger[trig] = self._by_trigger.get(trig, 0) + 1
            self._evict_locked()

    def _evict_locked(self) -> None:
        while self._bundles and (
                len(self._bundles) > self.max_bundles
                or self._bytes > self.max_bytes):
            name, (meta, _) = self._bundles.popitem(last=False)
            self._bytes -= meta["bytes"]
            if self.directory:
                try:
                    os.unlink(os.path.join(self.directory, name))
                except OSError:
                    pass

    def _adopt_existing(self) -> None:
        """Index bundles a previous incarnation left in the flight
        dir (oldest first, so eviction order survives restart)."""
        try:
            names = sorted(n for n in os.listdir(self.directory)
                           if n.startswith("flt-")
                           and n.endswith(BUNDLE_SUFFIX))
        except OSError:
            return
        for name in names:
            path = os.path.join(self.directory, name)
            parsed = read_bundle(path)
            if parsed is None:
                continue
            header, _ = parsed
            try:
                nbytes = os.path.getsize(path)
            except OSError:
                continue
            meta = {"name": name,
                    "trigger": header.get("trigger", ""),
                    "unix": header.get("unix", 0.0),
                    "seq": header.get("seq", 0), "bytes": nbytes}
            self._bundles[name] = (meta, None)
            self._bytes += nbytes
        with self._lock:
            self._evict_locked()

    # -- read ----------------------------------------------------------

    def list_bundles(self) -> list[dict]:
        """Newest-last bundle metadata (the /debug/flight listing)."""
        with self._lock:
            return [dict(meta) for meta, _ in self._bundles.values()]

    def get(self, name: str) -> bytes | None:
        """One framed bundle blob by name (CRC framing included, so
        the fetcher can verify end to end)."""
        if ("/" in name or "\\" in name or ".." in name):
            return None
        with self._lock:
            entry = self._bundles.get(name)
        if entry is None:
            return None
        meta, blob = entry
        if blob is not None:
            return blob
        try:
            with open(os.path.join(self.directory, name), "rb") as f:
                return f.read()
        except OSError:
            return None

    def by_trigger(self) -> dict[str, int]:
        with self._lock:
            return dict(self._by_trigger)

    def stats(self) -> dict:
        with self._lock:
            return {"bundles_total": self.bundles_total,
                    "by_trigger": dict(self._by_trigger),
                    "suppressed_total": self.suppressed_total,
                    "errors_total": self.errors_total,
                    "retained": len(self._bundles),
                    "retained_bytes": self._bytes,
                    "directory": self.directory,
                    "cooldown": self.cooldown}

    def drain(self, timeout: float = 5.0) -> None:
        """Block until queued dumps have been written (bench/test
        barrier before reading stats)."""
        deadline = time.monotonic() + timeout
        while not self._q.empty() and time.monotonic() < deadline:
            time.sleep(0.01)

    def stop(self, timeout: float = 5.0) -> None:
        """Flush the dump queue and join the writer thread."""
        self._stopped = True
        with self._lock:
            writer = self._writer
        if writer is None or not writer.is_alive():
            return
        try:
            self._q.put(None, timeout=timeout)
        except queue.Full:
            pass
        writer.join(timeout=timeout)
