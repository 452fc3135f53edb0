"""Collective forward transport: mesh-peer destinations leave the
gRPC wire and ride the plane exchange.

Port of ``veneur_tpu/forward/collective.py``.

:class:`CollectiveTransport` is the piece `Server._forward_sharded`
plugs in behind ``tpu_collective_forward``: it knows which ring
destinations are processes of this job's mesh (the operator's
``tpu_collective_peers`` map, ``addr=process_index``), packs each
peer's routed rows into the fixed-schema block
(:mod:`veneur_tpu_torch.parallel.collective_forward`) and runs the ONE
collective of the cycle on a dedicated worker thread with a deadline.

The fallback contract — the reason the wire never goes away:

- Rows that do not fit the fixed schema (class capacity, oversize
  identity, centroid overflow) are returned to the caller and ship on
  the wire.  Rejected, never truncated.
- ANY exchange failure (error, deadline, a torn-down mesh) raises
  :class:`CollectiveExchangeError`; the caller re-routes the whole
  cycle's peer rows onto the wire and counts the fall-open
  (``collective_forward_fallbacks``).  Nothing here retries.
- Breakers, the spool, drain/replay/recovery/handoff wires: all
  wire-only.  A mesh peer that stops answering collectives is a
  fallen-open transport, not an outage to absorb — the wire's
  machinery owns outages.

Deadline semantics on a rendezvous primitive: all_to_all completes
everywhere or nowhere, so a deadline miss usually means a wedged
mesh and the collective never lands.  When it DOES land late, the
delivery contract is at-least-once, never lost: the caller's rows
already fell open to the wire (the peer may fold them twice — both
sketches and counters re-merge idempotently per interval record,
and the double is named by the fallback counter), and the planes
peers addressed to US are handed to ``on_late`` instead of being
discarded.  Exactly one side owns each result — a per-job lock
decides whether the caller consumes it or the worker hands it off.

The exchange callable is injectable (tests wire a loopback hub or a
failure injector); by default a
:class:`~veneur_tpu_torch.parallel.collective_forward.PlaneExchange`
is built lazily on first use, so merely constructing the transport
never touches the process group.
"""

from __future__ import annotations

import logging
import queue
import threading
import time

import numpy as np

from veneur_tpu_torch.parallel import collective_forward as cplanes

log = logging.getLogger("veneur_tpu_torch.forward.collective")


class CollectiveExchangeError(RuntimeError):
    """The cycle's collective failed (exchange error or deadline);
    the caller must re-route onto the wire."""


def parse_peers(spec: str) -> dict[str, int]:
    """``tpu_collective_peers`` syntax: comma-separated
    ``dest_addr=process_index`` entries, e.g.
    ``10.0.0.2:8128=1,10.0.0.3:8128=2``.  Raises ValueError on
    malformed entries or duplicate addresses."""
    peers: dict[str, int] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        addr, sep, idx = part.rpartition("=")
        if not sep or not addr:
            raise ValueError(
                f"bad tpu_collective_peers entry {part!r} "
                "(want addr=process_index)")
        if addr in peers:
            raise ValueError(
                f"duplicate tpu_collective_peers address {addr!r}")
        try:
            peers[addr] = int(idx)
        except ValueError:
            raise ValueError(
                f"bad tpu_collective_peers index {idx!r} for "
                f"{addr!r}") from None
    return peers


class CollectiveTransport:
    """Pack-and-exchange for one forward cycle's mesh-peer rows.

    ``peers`` maps ring destination address -> mesh process index
    (empty for a receive-only global: nothing is a peer, the
    transport only rendezvouses and lands planes).  ``exchange`` is
    ``fn(u8[n_slots, block]) -> u8[n_slots, block]`` (row d out =
    block destined to process d; row s in = block process s addressed
    to us); None builds a :class:`PlaneExchange` over the job's
    forward mesh on first use.  ``deadline`` bounds each sending
    cycle's collective; ``on_late`` receives the landed array when a
    deadline-missed exchange completes anyway (see the module
    docstring — never silently discarded)."""

    def __init__(self, schema: cplanes.PlaneSchema,
                 peers: dict[str, int] | None = None, exchange=None,
                 n_slots: int | None = None,
                 deadline: float = 5.0, on_late=None):
        self.schema = schema
        self.peers = dict(peers or {})
        self.deadline = float(deadline)
        if n_slots is None and self.peers:
            n_slots = max(self.peers.values()) + 1
        self.n_slots = None if n_slots is None else int(n_slots)
        if self.n_slots is not None and any(
                not (0 <= i < self.n_slots)
                for i in self.peers.values()):
            raise ValueError("peer process index out of range")
        self.on_late = on_late
        self._exchange = exchange
        self._lock = threading.Lock()
        self._jobs: queue.Queue = queue.Queue()
        self._worker: threading.Thread | None = None
        self._busy = False
        self._stopped = False
        self.stats_lock = threading.Lock()
        self.counters = {
            "cycles": 0, "sent_rows": 0, "rejected_rows": 0,
            "fallback_cycles": 0, "landed_blocks": 0,
            "late_landed": 0, "pack_ns": 0, "exchange_ns": 0,
        }

    # -- lazy pieces ---------------------------------------------------

    def _ensure_exchange(self):
        if self._exchange is None:
            ex = cplanes.PlaneExchange()
            if self.n_slots is not None and ex.n_proc != self.n_slots:
                raise CollectiveExchangeError(
                    f"forward mesh spans {ex.n_proc} processes but "
                    f"the peer map implies {self.n_slots}")
            self._exchange = ex
        return self._exchange

    def _slots(self) -> int:
        if self.n_slots is None:
            # receive-only transport with no explicit size: the mesh
            # itself says how many processes rendezvous
            ex = self._ensure_exchange()
            self.n_slots = int(getattr(ex, "n_proc", 1))
        return self.n_slots

    def _ensure_worker(self):
        with self._lock:
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._run, name="collective-exchange-0",
                    daemon=True)
                self._worker.start()

    def _run(self):
        while True:
            job = self._jobs.get()
            if job is None:
                return
            local, box, job_lock, done = job
            out, err = None, None
            try:
                out = self._ensure_exchange()(local)
            except Exception as e:  # surfaced as a fall-open
                err = e
            with job_lock:
                if box.get("orphaned"):
                    # the caller already fell open to the wire; the
                    # planes peers addressed to us still land
                    if out is not None:
                        with self.stats_lock:
                            self.counters["late_landed"] += 1
                        if self.on_late is not None:
                            try:
                                self.on_late(out)
                            except Exception:
                                log.exception(
                                    "late collective land failed")
                elif err is not None:
                    box["err"] = err
                else:
                    box["out"] = out
            with self._lock:
                self._busy = False
            done.set()

    # -- API -----------------------------------------------------------

    def is_peer(self, dest: str) -> bool:
        return dest in self.peers

    def send_cycle(self, groups: dict[str, list]
                   ) -> tuple[dict[str, int], list, np.ndarray]:
        """Pack ``groups`` (dest -> ForwardRows; every dest must be a
        peer) and run the cycle's collective.  Returns
        ``(sent, rejected, landed)``: per-destination packed row
        counts, the rows the fixed schema rejected (ship them on the
        wire) and the landed blocks ``u8[n_slots, block]`` (fold the
        non-empty ones into the local table).  Raises
        :class:`CollectiveExchangeError` on any exchange failure —
        the caller then owns re-routing EVERYTHING onto the wire."""
        if self._stopped:
            raise CollectiveExchangeError("transport stopped")
        t0 = time.monotonic_ns()
        local = np.zeros((self._slots(), self.schema.block_size),
                         np.uint8)
        sent: dict[str, int] = {}
        rejected: list = []
        for dest, rows in groups.items():
            idx = self.peers[dest]
            block, n, rej = cplanes.pack_block(rows, self.schema)
            local[idx] = block
            if n:
                sent[dest] = n
            rejected.extend(rej)
        pack_ns = time.monotonic_ns() - t0
        landed = self._exchange_deadline(local, self.deadline)
        with self.stats_lock:
            c = self.counters
            c["cycles"] += 1
            c["sent_rows"] += sum(sent.values())
            c["rejected_rows"] += len(rejected)
            c["pack_ns"] += pack_ns
            c["exchange_ns"] += time.monotonic_ns() - t0 - pack_ns
        return sent, rejected, landed

    def exchange_empty(self, timeout: float | None = None
                       ) -> np.ndarray:
        """Participate in a cycle with nothing to send — collectives
        rendezvous, so every mesh process must show up.  A receiving
        global drives this in a loop; ``timeout=None`` blocks until
        the senders' next cycle arrives (the receive side has no
        wire to fall open to, so an unbounded wait is correct)."""
        local = np.zeros((self._slots(), self.schema.block_size),
                         np.uint8)
        return self._exchange_deadline(local, timeout)

    def _exchange_deadline(self, local: np.ndarray,
                           timeout: float | None) -> np.ndarray:
        self._ensure_worker()
        with self._lock:
            if self._busy:
                # the previous cycle's collective is still in flight
                # (deadline missed, mesh wedged): don't stack jobs —
                # this cycle goes straight to the wire
                with self.stats_lock:
                    self.counters["fallback_cycles"] += 1
                raise CollectiveExchangeError(
                    "previous plane exchange still in flight")
            self._busy = True
        box: dict = {}
        job_lock = threading.Lock()
        done = threading.Event()
        self._jobs.put((local, box, job_lock, done))
        done.wait(timeout)
        with job_lock:
            if "out" in box:
                return box["out"]
            if "err" in box:
                with self.stats_lock:
                    self.counters["fallback_cycles"] += 1
                raise CollectiveExchangeError(
                    f"plane exchange failed: {box['err']}"
                ) from box["err"]
            # not finished: disown the job — if it lands late the
            # worker hands the planes to on_late (module docstring)
            box["orphaned"] = True
        with self.stats_lock:
            self.counters["fallback_cycles"] += 1
        raise CollectiveExchangeError(
            f"plane exchange missed {timeout}s deadline")

    def note_landed(self, blocks: int) -> None:
        with self.stats_lock:
            self.counters["landed_blocks"] += int(blocks)

    def stats(self) -> dict:
        with self.stats_lock:
            out = dict(self.counters)
        out["peers"] = dict(self.peers)
        out["block_bytes"] = self.schema.block_size
        out["max_rows"] = self.schema.max_rows
        out["key_bytes"] = self.schema.key_bytes
        return out

    def stop(self) -> None:
        self._stopped = True
        with self._lock:
            w = self._worker
            self._worker = None
        if w is not None and w.is_alive():
            self._jobs.put(None)
            w.join(timeout=2.0)
