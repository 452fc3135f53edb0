"""Wire-level fault injection riding ``ShardedForwarder.fault_hook``.

The forwarder's destination workers call ``fault_hook(dest, body)``
immediately before each send attempt (including retries), so one
injector instance can drop, delay, or stall traffic per destination
without monkeypatching gRPC internals.  Faults are intentionally
coarse — the soak's interesting machinery is on the ACCOUNTING side
(ledger attribution, trace stitching), not in the fault realism.

Fault kinds:

- ``drop_wires(dest, n)``   — next ``n`` send attempts to ``dest``
  raise :class:`InjectedWireDrop`; the worker's normal retry/error
  path attributes them (retries burn additional drops, so ``n`` >
  retries+1 forces an attributed wire error).
- ``delay_wires(dest, s)``  — every send to ``dest`` sleeps ``s``
  first until cleared; models a slow peer eating the deadline budget.
- ``stall_once(dest, s)``   — the NEXT send to ``dest`` sleeps ``s``;
  models a single long GC/compaction pause pinning a worker so the
  bounded queue behind it takes busy-drops.

``flap_member`` flaps discovery membership (remove then re-add) via
``ShardedForwarder.set_members`` — two reshard epochs whose moved-arc
traffic must be credited, not lost.
"""

from __future__ import annotations

import threading
import time


class InjectedWireDrop(Exception):
    """Raised by the injector in place of a wire send."""


class WireFaultInjector:
    def __init__(self):
        self._lock = threading.Lock()
        self._drops: dict[str, int] = {}
        self._delays: dict[str, float] = {}
        self._stalls: dict[str, float] = {}
        self.injected_drops = 0
        self.injected_delays = 0
        self.injected_stalls = 0

    def install(self, fwd) -> "WireFaultInjector":
        """Attach to a ShardedForwarder; returns self for chaining."""
        fwd.fault_hook = self
        return self

    def drop_wires(self, dest: str, n: int = 1) -> None:
        with self._lock:
            self._drops[dest] = self._drops.get(dest, 0) + int(n)

    def delay_wires(self, dest: str, seconds: float) -> None:
        with self._lock:
            self._delays[dest] = float(seconds)

    def stall_once(self, dest: str, seconds: float) -> None:
        with self._lock:
            self._stalls[dest] = float(seconds)

    def clear(self, dest: str | None = None) -> None:
        with self._lock:
            if dest is None:
                self._drops.clear()
                self._delays.clear()
                self._stalls.clear()
            else:
                self._drops.pop(dest, None)
                self._delays.pop(dest, None)
                self._stalls.pop(dest, None)

    def __call__(self, dest: str, body: bytes) -> None:
        with self._lock:
            stall = self._stalls.pop(dest, None)
            delay = self._delays.get(dest)
            drop = self._drops.get(dest, 0)
            if drop > 0:
                self._drops[dest] = drop - 1
        if stall is not None:
            self.injected_stalls += 1
            time.sleep(stall)
        if delay is not None:
            self.injected_delays += 1
            time.sleep(delay)
        if drop > 0:
            self.injected_drops += 1
            raise InjectedWireDrop(f"chaos: dropped wire to {dest}")

    def stats(self) -> dict:
        with self._lock:
            return {
                "injected_drops": self.injected_drops,
                "injected_delays": self.injected_delays,
                "injected_stalls": self.injected_stalls,
                "armed_drops": dict(self._drops),
                "armed_delays": dict(self._delays),
                "armed_stalls": dict(self._stalls),
            }


def flap_member(fwd, member: str, down_for: float = 0.0) -> tuple[int, int]:
    """Remove ``member`` from the forwarder's live ring, optionally
    dwell, then re-add it.  Returns the (down_epoch, up_epoch) pair of
    reshard epochs the flap produced; callers assert both epochs'
    moved traffic was ledger-credited."""
    before = list(fwd.addresses)
    if member not in before:
        raise ValueError(f"{member} not in live membership {before}")
    down = [m for m in before if m != member]
    if not down:
        raise ValueError("cannot flap the only member")
    fwd.set_members(down)
    down_epoch = fwd.discovery_stats()["epoch"]
    if down_for > 0:
        time.sleep(down_for)
    fwd.set_members(before)
    up_epoch = fwd.discovery_stats()["epoch"]
    return down_epoch, up_epoch
