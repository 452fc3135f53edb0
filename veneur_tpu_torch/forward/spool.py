"""Bounded per-destination wire spool: absorb an outage, replay on
recovery.

Port of ``veneur_tpu/forward/spool.py``.

The reference's stance is drop-don't-buffer (flusher.go retry
semantics): a forward wire that exhausts its retries is counted and
gone.  The conservation ledger makes that loss *attributed*; this
spool makes it *recoverable*.  When a destination's circuit breaker is
open (or a send burned its whole retry budget), the serialized
MetricList body parks here instead of dropping; when the breaker's half-open probe
succeeds, spooled wires replay to the recovered peer flagged
``veneur-replay`` so the global books them under a dedicated ledger
protocol past its interval cutoff.

Bounds — a spool that can grow without limit is an OOM, not a
robustness feature:

- ``max_bytes``  — total body bytes across all destinations; adding
  a wire past the cap evicts the OLDEST spooled wires first (ring
  semantics — the newest data is the most valuable to a recovered
  aggregator), credited ``expired`` reason ``cap``
- ``max_age``    — wires older than this are expired (reason
  ``age``) at sweep/put/take time; a destination that never
  recovers can hold spool bytes for at most ``max_age`` seconds
- a single body larger than ``max_bytes`` is rejected outright
  (``put`` returns False; the caller attributes the drop)

Optional disk segments (``dir=...``, modeled on ``sinks/s3.py``'s
spool layout ``<dir>/<dest>/<incarnation>-<seq>-<items>.wire``):
bodies are written through to one file per wire and dropped from
memory, so an outage-sized backlog costs disk instead of RSS.
Segments are unlinked on replay/expiry.  At startup a spool with a
directory ADOPTS a dead predecessor's surviving segments (crash
recovery): each orphan re-enters the conservation story at
``spooled`` — crediting the lifetime totals alongside the queue — so
the new process's spool ledger seals balanced from its first
interval; orphans already past ``max_age`` (by file mtime) are
expired on the spot under reason ``orphan_age``, a named write-off
rather than a silent one.  The incarnation stamp in the filename
(the checkpoint subsystem's monotonic id) tells a reader whose crash
a segment survived.

Every wire is accounted from birth to death so the cross-interval
spool ledger (observe/ledger.py:SpoolLedger) can seal

    spooled == replayed + expired + still_queued + replay_inflight

at any instant; ``check_balance`` is the same identity self-checked.
"""

from __future__ import annotations

import logging
import os
import re
import threading
import time

log = logging.getLogger("veneur_tpu_torch.spool")

EXPIRE_REASONS = ("age", "cap", "retired", "orphan_age")

# segment filenames: new form <incarnation>-<seq>-<items>.wire; the
# pre-adoption form <seq>.wire still parses (incarnation/items
# unknown -> 0) so an upgrade adopts its predecessor's segments too
_SEG_RE = re.compile(r"^(?:(\d{8})-)?(\d{12})(?:-(\d+))?\.wire$")
# per-destination marker holding the REAL destination string (the
# directory name is sanitized, so replay could never match it)
_DEST_MARKER = "dest"


class Spooled(Exception):
    """Marker 'error' handed to a send's ``on_result`` when the failed
    wire was absorbed into the spool instead of dropped.  ``cause``
    is the send failure that triggered the spool."""

    def __init__(self, cause: BaseException | None = None):
        super().__init__(f"wire spooled for replay ({cause!r})")
        self.cause = cause


class _Entry:
    __slots__ = ("dest", "body", "n_items", "nbytes", "spooled_at",
                 "path")

    def __init__(self, dest: str, body: bytes | None, n_items: int,
                 nbytes: int, spooled_at: float,
                 path: str | None = None):
        self.dest = dest
        self.body = body
        self.n_items = n_items
        self.nbytes = nbytes
        self.spooled_at = spooled_at
        self.path = path

    def read(self) -> bytes | None:
        if self.body is not None:
            return self.body
        try:
            with open(self.path, "rb") as f:
                return f.read()
        except OSError:
            return None


def _safe_dest(dest: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", dest)


class WireSpool:
    """Byte- and age-capped per-destination ring of serialized wires."""

    def __init__(self, max_bytes: int = 32 << 20,
                 max_age: float = 300.0, dir: str | None = None,
                 clock=time.monotonic, incarnation: int = 0,
                 adopt_orphans: bool = True):
        self.max_bytes = int(max_bytes)
        self.max_age = float(max_age)
        self.dir = dir or None
        self._clock = clock
        self._lock = threading.Lock()
        self._queues: dict[str, list[_Entry]] = {}
        self._seq = 0
        self.incarnation = int(incarnation)
        self.adopted_wires = 0
        self.adopted_items = 0
        # -- lifetime totals (the spool ledger's inputs) ---------------
        self.spooled_wires = 0
        self.spooled_items = 0
        self.spooled_bytes = 0
        self.replayed_wires = 0
        self.replayed_items = 0
        self.replayed_bytes = 0
        self.expired_wires = 0
        self.expired_items = 0
        self.expired_bytes = 0
        self.expired_by_reason = {r: 0 for r in EXPIRE_REASONS}
        self.rejected_wires = 0      # single body over max_bytes
        self.rejected_items = 0
        # -- current state ---------------------------------------------
        self.queued_bytes = 0
        self.inflight_items = 0      # popped for replay, not resolved
        self.inflight_wires = 0
        if self.dir is not None and adopt_orphans:
            self._adopt_orphans()

    # -- orphan adoption -----------------------------------------------

    def _adopt_orphans(self) -> None:
        """Adopt a dead predecessor's on-disk segments at startup.

        Each orphan credits the ``spooled`` lifetime totals AND the
        queue (or an immediate ``orphan_age`` expiry when its mtime is
        past ``max_age``), so ``check_balance`` holds from the first
        wire.  Destinations come from the per-directory marker file;
        a directory without one (pre-marker layout) falls back to its
        sanitized name, which no live destination matches — those
        wires sit until the age cap writes them off, attributed."""
        now = self._clock()
        wall = time.time()
        try:
            dests = sorted(os.listdir(self.dir))
        except OSError:
            return
        with self._lock:
            for dname in dests:
                ddir = os.path.join(self.dir, dname)
                if not os.path.isdir(ddir):
                    continue
                dest = dname
                try:
                    with open(os.path.join(ddir, _DEST_MARKER)) as f:
                        dest = f.read().strip() or dname
                except OSError:
                    pass
                try:
                    names = sorted(os.listdir(ddir))
                except OSError:
                    continue
                for name in names:
                    m = _SEG_RE.match(name)
                    if m is None:
                        continue
                    path = os.path.join(ddir, name)
                    try:
                        st = os.stat(path)
                    except OSError:
                        continue
                    n_items = int(m.group(3) or 0)
                    nbytes = int(st.st_size)
                    age = max(0.0, wall - st.st_mtime)
                    entry = _Entry(dest, None, n_items, nbytes,
                                   now - age, path=path)
                    self.spooled_wires += 1
                    self.spooled_items += n_items
                    self.spooled_bytes += nbytes
                    self.adopted_wires += 1
                    self.adopted_items += n_items
                    self.queued_bytes += nbytes
                    if self.max_age > 0 and age > self.max_age:
                        # too stale to replay into a live aggregator:
                        # a named write-off, not a silent unlink
                        self._expire_entry_locked(entry,
                                                  "orphan_age")
                        continue
                    self._queues.setdefault(dest, []).append(entry)
            # adopted backlog must respect the byte cap like any
            # other intake: evict oldest-first, credited ``cap``
            while self.queued_bytes > self.max_bytes:
                if not self._evict_oldest_locked("cap"):
                    break
        if self.adopted_wires:
            log.info("adopted %d orphaned spool wires (%d items; "
                     "%d expired as orphan_age)", self.adopted_wires,
                     self.adopted_items,
                     self.expired_by_reason.get("orphan_age", 0))

    # -- intake --------------------------------------------------------

    def put(self, dest: str, body: bytes, n_items: int) -> bool:
        """Spool one wire for ``dest``.  Returns False only when the
        body alone exceeds ``max_bytes`` (the caller attributes the
        drop); otherwise the oldest spooled wires are evicted to make
        room (credited ``expired`` reason ``cap``)."""
        nbytes = len(body)
        with self._lock:
            if nbytes > self.max_bytes:
                self.rejected_wires += 1
                self.rejected_items += int(n_items)
                return False
            now = self._clock()
            self._expire_locked(now)
            while self.queued_bytes + nbytes > self.max_bytes:
                if not self._evict_oldest_locked("cap"):
                    break
            entry = _Entry(dest, body, int(n_items), nbytes, now)
            if self.dir is not None:
                path = self._write_segment(dest, body, int(n_items))
                if path is not None:
                    entry.path = path
                    entry.body = None
            self._queues.setdefault(dest, []).append(entry)
            self.spooled_wires += 1
            self.spooled_items += int(n_items)
            self.spooled_bytes += nbytes
            self.queued_bytes += nbytes
            return True

    def _write_segment(self, dest: str, body: bytes,
                       n_items: int) -> str | None:
        self._seq += 1
        ddir = os.path.join(self.dir, _safe_dest(dest))
        path = os.path.join(
            ddir, f"{self.incarnation:08d}-{self._seq:012d}-"
            f"{n_items}.wire")
        try:
            if not os.path.isdir(ddir):
                os.makedirs(ddir, exist_ok=True)
                # real destination string for an adopting successor
                # (the directory name is sanitized, so it alone can't
                # route a replay)
                with open(os.path.join(ddir, _DEST_MARKER),
                          "w") as f:
                    f.write(dest)
            with open(path, "wb") as f:
                f.write(body)
            return path
        except OSError as e:
            log.warning("spool segment write failed (%s); keeping "
                        "wire in memory", e)
            return None

    # -- replay --------------------------------------------------------

    def take(self, dest: str) -> _Entry | None:
        """Pop the oldest fresh wire for ``dest`` (expiring stale ones
        on the way) and mark it replay-inflight.  The caller MUST
        resolve it with :meth:`mark_replayed` or :meth:`requeue`."""
        with self._lock:
            self._expire_locked(self._clock(), dest)
            q = self._queues.get(dest)
            if not q:
                return None
            entry = q.pop(0)
            self.queued_bytes -= entry.nbytes
            self.inflight_items += entry.n_items
            self.inflight_wires += 1
            return entry

    def mark_replayed(self, entry: _Entry) -> None:
        with self._lock:
            self.inflight_items -= entry.n_items
            self.inflight_wires -= 1
            self.replayed_wires += 1
            self.replayed_items += entry.n_items
            self.replayed_bytes += entry.nbytes
        self._unlink(entry)

    def discard(self, entry: _Entry, reason: str = "age") -> None:
        """Resolve a replay-inflight entry as expired (e.g. its disk
        segment vanished) — attributed under ``reason``, never lost
        silently."""
        with self._lock:
            self.inflight_items -= entry.n_items
            self.inflight_wires -= 1
            self.queued_bytes += entry.nbytes   # undo take's debit...
            self._expire_entry_locked(entry, reason)  # ...re-debited

    def requeue(self, entry: _Entry) -> None:
        """Put a failed replay back at the FRONT of its queue (order
        preserved, original timestamp kept so the age cap still
        applies) without re-counting it as spooled."""
        with self._lock:
            self.inflight_items -= entry.n_items
            self.inflight_wires -= 1
            self._queues.setdefault(entry.dest, []).insert(0, entry)
            self.queued_bytes += entry.nbytes

    # -- expiry / eviction ---------------------------------------------

    def sweep(self) -> int:
        """Expire over-age wires across every destination; returns the
        number of ITEMS expired by this call."""
        with self._lock:
            before = self.expired_items
            self._expire_locked(self._clock())
            return self.expired_items - before

    def drop_dest(self, dest: str) -> tuple[int, int]:
        """Expire every queued wire for a destination that left the
        ring (reason ``retired``); returns (wires, items)."""
        with self._lock:
            q = self._queues.pop(dest, None)
            if not q:
                return (0, 0)
            wires = items = 0
            for entry in q:
                self._expire_entry_locked(entry, "retired")
                wires += 1
                items += entry.n_items
            return (wires, items)

    def _expire_locked(self, now: float, dest: str | None = None) -> None:
        if self.max_age <= 0:
            return
        queues = ([self._queues.get(dest)] if dest is not None
                  else list(self._queues.values()))
        for q in queues:
            if not q:
                continue
            while q and now - q[0].spooled_at > self.max_age:
                self._expire_entry_locked(q.pop(0), "age")

    def _evict_oldest_locked(self, reason: str) -> bool:
        oldest_q = None
        for q in self._queues.values():
            if q and (oldest_q is None
                      or q[0].spooled_at < oldest_q[0].spooled_at):
                oldest_q = q
        if oldest_q is None:
            return False
        self._expire_entry_locked(oldest_q.pop(0), reason)
        return True

    def _expire_entry_locked(self, entry: _Entry, reason: str) -> None:
        self.queued_bytes -= entry.nbytes
        self.expired_wires += 1
        self.expired_items += entry.n_items
        self.expired_bytes += entry.nbytes
        self.expired_by_reason[reason] = (
            self.expired_by_reason.get(reason, 0) + entry.n_items)
        self._unlink(entry)

    def _unlink(self, entry: _Entry) -> None:
        if entry.path is not None:
            try:
                os.unlink(entry.path)
            except OSError:
                pass

    # -- introspection -------------------------------------------------

    def queued(self, dest: str | None = None) -> int:
        """Queued WIRES for one destination (or all)."""
        with self._lock:
            if dest is not None:
                return len(self._queues.get(dest) or ())
            return sum(len(q) for q in self._queues.values())

    def queued_items(self) -> int:
        with self._lock:
            return sum(e.n_items for q in self._queues.values()
                       for e in q)

    def stats(self) -> dict:
        with self._lock:
            queued_wires = sum(len(q) for q in self._queues.values())
            queued_items = sum(e.n_items
                               for q in self._queues.values()
                               for e in q)
            return {
                "spooled_wires": self.spooled_wires,
                "spooled_items": self.spooled_items,
                "spooled_bytes": self.spooled_bytes,
                "replayed_wires": self.replayed_wires,
                "replayed_items": self.replayed_items,
                "replayed_bytes": self.replayed_bytes,
                "expired_wires": self.expired_wires,
                "expired_items": self.expired_items,
                "expired_bytes": self.expired_bytes,
                "expired_by_reason": dict(self.expired_by_reason),
                "rejected_wires": self.rejected_wires,
                "rejected_items": self.rejected_items,
                "queued_wires": queued_wires,
                "queued_items": queued_items,
                "queued_bytes": self.queued_bytes,
                "inflight_wires": self.inflight_wires,
                "inflight_items": self.inflight_items,
                "adopted_wires": self.adopted_wires,
                "adopted_items": self.adopted_items,
                "incarnation": self.incarnation,
                "max_bytes": self.max_bytes,
                "max_age_s": self.max_age,
                "disk": self.dir is not None,
                "per_dest_queued": {
                    d: len(q) for d, q in self._queues.items() if q},
            }

    def check_balance(self) -> int:
        """The conservation identity, self-checked: returns owed items
        (0 when balanced) — ``spooled - (replayed + expired + queued +
        inflight)``."""
        with self._lock:
            queued_items = sum(e.n_items
                               for q in self._queues.values()
                               for e in q)
            return self.spooled_items - (
                self.replayed_items + self.expired_items
                + queued_items + self.inflight_items)
