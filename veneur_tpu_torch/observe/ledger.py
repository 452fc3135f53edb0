"""Per-interval sample-conservation ledger.

The port's copy of ``veneur_tpu/observe/ledger.py``.

Every hot path credits the ledger at the points where it already
bumps server stats — received samples per protocol, accepted
(staged) samples, overflow drops, invalid drops, parse errors,
service-check STATUS samples — and the flush side credits what left
the process: emitted rows, forwarded rows + wire bytes, per-sink
metric counts, fanout busy-drops/retries.  At ``begin_swap`` the
interval closes (``Ledger.close_interval``) and at the end of the
flush it seals (``Ledger.seal``) with the conservation checks:

    received == staged + status + shed + overflow + invalid  (ingest)
    shed == sum(shed_by[tenant, reason])                     (shed)
    staged_rows == emitted + forwarded - overlap + retained  (rows)

plus two *independent* cross-checks against the table's own interval
counters — ``staged`` vs the table's staged-sample count and
``overflow`` vs the table's per-class drop tallies — so a fast path
that forgets to credit one side shows up as a drift, not silence.

Locking discipline mirrors the reader shards: ``parse`` runs with NO
ledger interaction; all credits happen at ``commit``/apply time,
already under the server's ingest lock, as a handful of integer adds
(the ledger's own lock only matters for out-of-band readers like
``/debug/ledger``).  Sealed records live in a bounded ring (last 128
intervals) served at ``/debug/ledger``; ``summary()`` is what
bench.py stamps into soak/chain artifacts.

``strict=True`` (``VENEUR_TPU_LEDGER_STRICT=1``) turns any imbalance
into a logged error + an ``on_imbalance`` callback (the server bumps
``ledger_imbalance`` / ``veneur.ledger.imbalance_total``).

``ClassDropTally`` is the centralized drop counter the table's
per-class indexes use for overflow accounting (previously ad-hoc
``idx.overflow += n`` at every fast-path call site) — one mutation
API, so /debug/vars, snapshots, and the ledger all read one number.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field

log = logging.getLogger("veneur_tpu_torch.ledger")

DEFAULT_CAPACITY = 128


class ClassDropTally:
    """Centralized per-class overflow-drop counter (counts SAMPLES,
    not keys).  All fast-path drop sites go through ``add`` so the
    count can't silently diverge from what snapshots and the ledger
    read via ``count``/``take``."""

    __slots__ = ("count",)

    def __init__(self) -> None:
        self.count = 0

    def add(self, n: int = 1) -> None:
        self.count += int(n)

    def take(self) -> int:
        """Read-and-reset (interval close; caller holds the ingest
        lock, same as the bump sites)."""
        n = self.count
        self.count = 0
        return n


@dataclass
class LedgerRecord:
    """One interval's conservation account."""

    seq: int = 0
    start_unix: float = 0.0
    trace_id: int = 0
    # -- ingest side (credited per protocol at the stats-bump sites) --
    received: dict[str, int] = field(default_factory=dict)
    staged: int = 0          # accepted samples (site-credited)
    status: int = 0          # service-check STATUS samples (never stage)
    overflow: int = 0        # row-table overflow drops (site-credited)
    invalid: int = 0         # malformed/non-finite drops at import sites
    parse_errors: int = 0    # line/packet-level errors (pre-sample)
    # -- overload shedding (admission control / pressure tiers): every
    #    shed sample carries a (tenant, reason) attribution, and seal
    #    checks the breakdown sums back to the total — an anonymous
    #    shed is an imbalance, not a smaller number
    shed: int = 0
    shed_by: dict[tuple[str, str], int] = field(default_factory=dict)
    # flush ticks this interval absorbed beyond its own (the overrun
    # watchdog coalesced N skipped swaps into this one record)
    coalesced: int = 0
    # kernel-level UDP receive drops observed (/proc or SO_RXQ_OVFL)
    # during the interval: loss BEFORE the process saw the packet, so
    # it is reported as observed-unattributed — named, but never a
    # balance input (the samples were never ``received``)
    kernel_drops: int = 0
    # -- independent table-side counters captured at begin_swap --------
    table_staged: int | None = None
    table_overflow: dict[str, int] = field(default_factory=dict)
    # -- flush side (row granularity, from the flusher's routing) ------
    staged_rows: int = 0
    emitted_rows: int = 0
    forwarded_rows: int = 0
    overlap_rows: int = 0    # rows that both emit locally AND forward
    retained_rows: int = 0   # rows that did neither (scope-gated out)
    emitted_per_sink: dict[str, int] = field(default_factory=dict)
    # -- sharded-forward split (synchronous at route time): every
    #    forwarded row lands in exactly one destination's count or in
    #    ``forward_split_dropped`` (busy-drop/no-owner), so a dropped
    #    SHARD — not just a dropped interval — breaks the seal check
    #    ``forwarded == sum(dests) + dropped`` below
    forward_split: dict[str, int] = field(default_factory=dict)
    forward_split_dropped: int = 0
    # rows that shipped to a mesh-peer destination over the collective
    # plane-exchange INSTEAD of its wire (synchronous at pack time,
    # like the wire split) — the seal treats both transports as one
    # conservation: ``forwarded == Σ wire split + Σ collective split
    # + spooled + dropped``.  A collective fall-open re-credits the
    # cycle's rows to the wire split, never here.
    forward_collective: dict[str, int] = field(default_factory=dict)
    # rows whose wire went to the outage spool INSTEAD of a worker
    # (breaker open at route time) — synchronous like the split, so
    # the seal extends to ``forwarded == sum(dests) + spooled +
    # dropped``: an absorbed outage balances, it doesn't owe
    forward_spooled: int = 0
    # -- membership change (live reshard): a discovery swap moved
    #    these arcs, so a per-destination skew vs the previous interval
    #    is a REBALANCE (attributed here), not a loss
    reshard_epoch: int = 0
    reshard_added: list[str] = field(default_factory=list)
    reshard_removed: list[str] = field(default_factory=list)
    reshard_moved_rows: int = 0
    # -- wire outcomes (async; informational, not balance inputs) ------
    forward_wire_rows: int = 0
    forward_wire_bytes: int = 0
    forward_errors: int = 0
    # rows spooled AFTER their wire failed on the worker (retry budget
    # exhausted / deadline missed / breaker tripped mid-queue): their
    # rows were already credited to forward_split at route time, so
    # this is a wire OUTCOME, not a second balance input — the
    # cross-interval SpoolLedger owns their conservation from here
    forward_spooled_async: int = 0
    # rows replayed out of the spool this interval (theirs was an
    # EARLIER interval's balance; informational by construction)
    forward_replayed: int = 0
    # per-destination rows dropped because the send missed the
    # interval deadline (async like forward_errors — the attempt
    # resolves on the worker after route time)
    forward_timeout_dropped: dict[str, int] = field(
        default_factory=dict)
    fanout_busy_drops: int = 0
    fanout_retries: int = 0
    fanout_timeouts: int = 0
    # -- crash recovery: staged mass replayed from a prior
    #    incarnation's checkpoint (re-ingested locally, or accepted on
    #    the wire under the ``veneur-recovery`` flag).  The mass ALSO
    #    credits the main ingest balance through a normal ``ingest``
    #    call — this arm names how much of the interval's intake was
    #    recovery and from which incarnation, and seal checks the
    #    breakdown sums back to the total, so a recovered sample can
    #    never shed its provenance
    recovered: int = 0
    recovered_by: dict[str, int] = field(default_factory=dict)
    # -- scale-out arc handoff, receiving side (the receiver twin of
    #    credit_reshard): items accepted under the handoff flag from
    #    an incumbent global shipping arcs this node now owns
    reshard_received_items: int = 0
    # -- adaptive sketch tiers (core/tiers.py): series that moved
    #    between the compact and wide plane pools this interval.  A
    #    promotion/demotion is a NAMED movement of a row's precision,
    #    never of its mass — these are informational attribution, not
    #    balance inputs (the row's samples stay staged/emitted/
    #    forwarded exactly as before).  ``tier_promote_refused``
    #    counts escalations the full wide pool turned down; the row's
    #    data stays exact in the compact store, so a refusal is
    #    pressure, not loss.
    tier_promotions: int = 0
    tier_demotions: int = 0
    tier_escalations: int = 0
    tier_promote_refused: int = 0
    # -- verdict (filled by seal) --------------------------------------
    sealed: bool = False
    balanced: bool = True
    owed: int = 0            # ingest samples unaccounted for
    staged_drift: int = 0    # site-credited staged - table staged
    overflow_drift: int = 0  # site-credited overflow - table overflow
    rows_owed: int = 0       # staged rows unaccounted for at flush
    split_owed: int = 0      # forwarded rows no destination accounts for
    shed_owed: int = 0       # shed samples missing tenant+reason
    recovered_owed: int = 0  # recovered samples missing an incarnation

    def received_total(self) -> int:
        return sum(self.received.values())

    def dropped_total(self) -> int:
        return self.overflow + self.invalid

    def shed_nested(self) -> dict:
        """``shed_by`` as ``{tenant: {reason: n}}`` for JSON."""
        out: dict[str, dict[str, int]] = {}
        for (tenant, reason), n in self.shed_by.items():
            out.setdefault(tenant, {})[reason] = n
        return out

    def to_dict(self) -> dict:
        return {
            "seq": self.seq,
            "start_unix": self.start_unix,
            "trace_id": str(self.trace_id),
            "received": dict(self.received),
            "received_total": self.received_total(),
            "staged": self.staged,
            "status": self.status,
            "dropped": {"overflow": self.overflow,
                        "invalid": self.invalid,
                        "total": self.dropped_total()},
            "shed": {"total": self.shed,
                     "by": self.shed_nested(),
                     "owed": self.shed_owed},
            "coalesced": self.coalesced,
            "observed_unattributed": {
                "kernel_drops": self.kernel_drops},
            "parse_errors": self.parse_errors,
            "table": {"staged": self.table_staged,
                      "overflow": dict(self.table_overflow)},
            "rows": {"staged": self.staged_rows,
                     "emitted": self.emitted_rows,
                     "forwarded": self.forwarded_rows,
                     "overlap": self.overlap_rows,
                     "retained": self.retained_rows},
            "emitted_per_sink": dict(self.emitted_per_sink),
            "forward_split": {"per_dest": dict(self.forward_split),
                              "collective_per_dest": dict(
                                  self.forward_collective),
                              "dropped": self.forward_split_dropped,
                              "spooled": self.forward_spooled,
                              "owed": self.split_owed},
            "spool": {"spooled_async": self.forward_spooled_async,
                      "replayed": self.forward_replayed},
            "reshard": {"epoch": self.reshard_epoch,
                        "added": list(self.reshard_added),
                        "removed": list(self.reshard_removed),
                        "moved_rows": self.reshard_moved_rows,
                        "received_items": self.reshard_received_items},
            "recovered": {"total": self.recovered,
                          "by": dict(self.recovered_by),
                          "owed": self.recovered_owed},
            "forward_wire": {"rows": self.forward_wire_rows,
                             "bytes": self.forward_wire_bytes,
                             "errors": self.forward_errors,
                             "timeout_dropped": dict(
                                 self.forward_timeout_dropped)},
            "fanout": {"busy_drops": self.fanout_busy_drops,
                       "retries": self.fanout_retries,
                       "timeouts": self.fanout_timeouts},
            "tiers": {"promotions": self.tier_promotions,
                      "demotions": self.tier_demotions,
                      "escalations": self.tier_escalations,
                      "promote_refused": self.tier_promote_refused},
            "balanced": self.balanced,
            "owed": self.owed,
            "staged_drift": self.staged_drift,
            "overflow_drift": self.overflow_drift,
            "rows_owed": self.rows_owed,
        }


class Ledger:
    """Interval accumulator + bounded ring of sealed records.

    Credit methods are a few integer adds under a lock; the server
    calls them at the same points (and under the same ingest lock) as
    its existing stats bumps, so per-sample cost is zero — crediting
    is per *batch*, with counts the call sites already computed.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 strict: bool = False, node: str = "veneur",
                 on_imbalance=None):
        self.strict = strict
        self.node = node
        self.on_imbalance = on_imbalance
        self._lock = threading.Lock()
        self._ring: deque[LedgerRecord] = deque(maxlen=capacity)
        self._cur = LedgerRecord(start_unix=time.time())
        self.imbalanced_total = 0

    # -- ingest-side crediting (call under the server's ingest lock) ---
    def ingest(self, protocol: str, processed: int = 0, staged: int = 0,
               overflow: int = 0, invalid: int = 0,
               parse_errors: int = 0, status: int = 0,
               shed: int = 0) -> None:
        """Credit one batch: ``processed`` samples presented on
        ``protocol``, of which ``staged`` were accepted, ``overflow``
        dropped on row-table overflow, ``invalid`` dropped for
        malformed/non-finite values, ``status`` were service-check
        STATUS samples (accepted but never staged), and ``shed`` were
        rejected by overload control (attribute them via
        ``credit_shed`` in the same critical section — seal checks
        the breakdown sums back to this total)."""
        with self._lock:
            cur = self._cur
            if processed:
                cur.received[protocol] = (
                    cur.received.get(protocol, 0) + int(processed))
            cur.staged += int(staged)
            cur.overflow += int(overflow)
            cur.invalid += int(invalid)
            cur.parse_errors += int(parse_errors)
            cur.status += int(status)
            cur.shed += int(shed)

    def credit_shed(self, breakdown: dict) -> None:
        """Attribute shed samples: ``{(tenant, reason): n}``.  The
        totals must sum to what the paired ``ingest(..., shed=n)``
        credited — seal fails the interval otherwise, so a shed
        sample can never lose its name."""
        with self._lock:
            cur = self._cur
            for key, n in breakdown.items():
                if n:
                    cur.shed_by[key] = cur.shed_by.get(key, 0) + int(n)

    def recover(self, source: str, items: int) -> None:
        """Name ``items`` of the open interval's intake as crash
        recovery from ``source`` (``incarnation:<id>``).  Pair with a
        normal ``ingest`` credit in the same critical section — the
        samples enter the main balance as received+staged mass like
        any protocol's, and this arm records their provenance (seal
        checks the breakdown sums back to the total)."""
        with self._lock:
            cur = self._cur
            if items:
                cur.recovered += int(items)
                cur.recovered_by[source] = (
                    cur.recovered_by.get(source, 0) + int(items))

    def credit_reshard_received(self, items: int) -> None:
        """Receiving side of a scale-out arc handoff: ``items``
        accepted on the import wire under the handoff flag (they also
        credit ``ingest`` normally — this names them as a rebalance
        arrival, the twin of the sender's ``credit_reshard``)."""
        with self._lock:
            self._cur.reshard_received_items += int(items)

    def open_to_dict(self) -> dict:
        """Snapshot of the OPEN interval's record — what the
        checkpointer stamps into a segment header so recovery can see
        how much the dying interval had received."""
        with self._lock:
            return self._cur.to_dict()

    def note_coalesced(self) -> None:
        """The overrun watchdog skipped a flush tick: the open
        interval absorbs the skipped one (one swap will cover both),
        and the record that eventually closes names the coalesce."""
        with self._lock:
            self._cur.coalesced += 1

    # -- interval close (under the ingest lock, same critical section
    #    as the table's begin_swap so credits and table counters agree)
    def close_interval(self, seq: int = 0, trace_id: int = 0,
                       table_staged: int | None = None,
                       table_overflow: dict[str, int] | None = None,
                       kernel_drops: int = 0) -> LedgerRecord:
        with self._lock:
            rec = self._cur
            self._cur = LedgerRecord(start_unix=time.time())
            rec.seq = int(seq)
            rec.trace_id = int(trace_id)
            rec.table_staged = table_staged
            if table_overflow:
                rec.table_overflow = dict(table_overflow)
            rec.kernel_drops += int(kernel_drops)
            return rec

    # -- flush-side crediting (synchronous inputs to the row balance) --
    def credit_rows(self, rec: LedgerRecord, accounting: dict) -> None:
        with self._lock:
            rec.staged_rows += int(accounting.get("staged_rows", 0))
            rec.emitted_rows += int(accounting.get("emitted_rows", 0))
            rec.forwarded_rows += int(
                accounting.get("forwarded_rows", 0))
            rec.overlap_rows += int(accounting.get("overlap_rows", 0))
            rec.retained_rows += int(
                accounting.get("retained_rows", 0))

    def credit_forward_split(self, rec: LedgerRecord,
                             dest: str | None = None, rows: int = 0,
                             dropped: int = 0) -> None:
        """Credit the sharded forward's routing decision for one
        destination: ``rows`` assigned to ``dest`` (or ``dropped``
        rows no worker accepted).  Synchronous at route time — a
        balance input, unlike the async wire outcomes — so seal can
        hold ``forwarded == sum(dests) + dropped`` per interval."""
        with self._lock:
            if dest is not None and rows:
                rec.forward_split[dest] = (
                    rec.forward_split.get(dest, 0) + int(rows))
            rec.forward_split_dropped += int(dropped)

    def credit_forward_collective(self, rec: LedgerRecord, dest: str,
                                  rows: int) -> None:
        """Credit rows shipped to a mesh peer over the collective
        plane-exchange — synchronous at pack time, the collective twin
        of :meth:`credit_forward_split`.  Seal conserves the two
        transports together: ``forwarded == Σ wire split +
        Σ collective split + spooled + dropped``."""
        with self._lock:
            if rows:
                rec.forward_collective[dest] = (
                    rec.forward_collective.get(dest, 0) + int(rows))

    def credit_forward_spooled(self, rec: LedgerRecord,
                               rows: int = 0) -> None:
        """Credit rows routed INTO the outage spool at route time
        (destination breaker open — no worker ever saw them).  A
        synchronous balance input alongside the per-destination split:
        the interval's forwarded rows are conserved as sent + spooled
        + attributed drops.  The spool's own cross-interval ledger
        (:class:`SpoolLedger`) takes over from here."""
        with self._lock:
            rec.forward_spooled += int(rows)

    def credit_spool_outcome(self, rec: LedgerRecord,
                             spooled_async: int = 0,
                             replayed: int = 0) -> None:
        """Async spool traffic: rows absorbed after their send failed
        on a worker (already split-credited at route time) and rows
        replayed out of the spool this interval.  Informational wire
        outcomes, not balance inputs."""
        with self._lock:
            rec.forward_spooled_async += int(spooled_async)
            rec.forward_replayed += int(replayed)

    def credit_reshard(self, rec: LedgerRecord, epoch: int,
                       added, removed, moved_rows: int) -> None:
        """Attribute a live membership change to this interval: the
        ring swapped to ``epoch`` (gaining ``added``, losing
        ``removed``) and ``moved_rows`` of this flush's routed rows
        landed on a different owner than the pre-swap ring would have
        chosen — a rebalance the record names, so a reader comparing
        per-destination splits across intervals sees a reshard, not a
        loss."""
        with self._lock:
            rec.reshard_epoch = int(epoch)
            rec.reshard_added = sorted(
                set(rec.reshard_added) | set(added))
            rec.reshard_removed = sorted(
                set(rec.reshard_removed) | set(removed))
            rec.reshard_moved_rows += int(moved_rows)

    def credit_sink(self, rec: LedgerRecord, name: str,
                    metrics: int) -> None:
        with self._lock:
            rec.emitted_per_sink[name] = (
                rec.emitted_per_sink.get(name, 0) + int(metrics))

    # -- wire outcomes (may land after seal; informational) ------------
    def credit_forward_wire(self, rec: LedgerRecord, rows: int = 0,
                            nbytes: int = 0, errors: int = 0) -> None:
        with self._lock:
            rec.forward_wire_rows += int(rows)
            rec.forward_wire_bytes += int(nbytes)
            rec.forward_errors += int(errors)

    def credit_forward_timeout(self, rec: LedgerRecord, dest: str,
                               rows: int) -> None:
        """Attribute rows whose forward send missed the interval
        deadline to ``dest`` — async like the other wire outcomes, but
        per-destination so a deadline-dropping shard is named."""
        with self._lock:
            rec.forward_timeout_dropped[dest] = (
                rec.forward_timeout_dropped.get(dest, 0) + int(rows))

    def credit_fanout(self, rec: LedgerRecord, busy_drops: int = 0,
                      retries: int = 0, timeouts: int = 0) -> None:
        with self._lock:
            rec.fanout_busy_drops += int(busy_drops)
            rec.fanout_retries += int(retries)
            rec.fanout_timeouts += int(timeouts)

    def credit_tiers(self, rec: LedgerRecord, movements: dict) -> None:
        """Attribute the interval's tier-boundary movements (see
        core/tiers.py take_delta): ``movements`` is the per-class
        {promotions, demotions, escalations, promote_refused} delta
        dict from the tier snapshot.  Named movements, never balance
        inputs — a promoted row's mass already balances through the
        normal staged/emitted arms."""
        with self._lock:
            for cls in movements.values():
                rec.tier_promotions += int(cls.get("promotions", 0))
                rec.tier_demotions += int(cls.get("demotions", 0))
                rec.tier_escalations += int(cls.get("escalations", 0))
                rec.tier_promote_refused += int(
                    cls.get("promote_refused", 0))

    # -- seal ----------------------------------------------------------
    def seal(self, rec: LedgerRecord) -> LedgerRecord:
        """Run the balance checks, append to the ring, and (strict
        mode) escalate any imbalance to an error + counter."""
        with self._lock:
            rec.owed = rec.received_total() - (
                rec.staged + rec.status + rec.shed + rec.overflow
                + rec.invalid)
            rec.shed_owed = rec.shed - sum(rec.shed_by.values())
            if rec.table_staged is not None:
                rec.staged_drift = rec.staged - rec.table_staged
            if rec.table_overflow:
                rec.overflow_drift = rec.overflow - sum(
                    rec.table_overflow.values())
            rec.rows_owed = rec.staged_rows - (
                rec.emitted_rows + rec.forwarded_rows
                - rec.overlap_rows + rec.retained_rows)
            # sharded-forward conservation: only checked when the
            # router credited a split this interval (the legacy
            # single-destination path never does), so a forward that
            # overran the interval budget can't fake an imbalance.
            # Spooled rows are a full-fledged split outcome: an
            # outage the spool absorbed balances instead of owing.
            if (rec.forward_split or rec.forward_collective
                    or rec.forward_split_dropped
                    or rec.forward_spooled):
                rec.split_owed = rec.forwarded_rows - (
                    sum(rec.forward_split.values())
                    + sum(rec.forward_collective.values())
                    + rec.forward_spooled
                    + rec.forward_split_dropped)
            rec.recovered_owed = rec.recovered - sum(
                rec.recovered_by.values())
            rec.balanced = (rec.owed == 0 and rec.staged_drift == 0
                            and rec.overflow_drift == 0
                            and rec.rows_owed == 0
                            and rec.split_owed == 0
                            and rec.shed_owed == 0
                            and rec.recovered_owed == 0)
            rec.sealed = True
            self._ring.append(rec)
            if not rec.balanced:
                self.imbalanced_total += 1
        if not rec.balanced:
            msg = ("ledger imbalance node=%s seq=%d: owed=%d samples "
                   "(received=%d staged=%d status=%d shed=%d "
                   "overflow=%d invalid=%d) staged_drift=%d "
                   "overflow_drift=%d rows_owed=%d split_owed=%d "
                   "shed_owed=%d recovered_owed=%d")
            args = (self.node, rec.seq, rec.owed, rec.received_total(),
                    rec.staged, rec.status, rec.shed, rec.overflow,
                    rec.invalid, rec.staged_drift, rec.overflow_drift,
                    rec.rows_owed, rec.split_owed, rec.shed_owed,
                    rec.recovered_owed)
            if self.strict:
                log.error(msg, *args)
            else:
                log.warning(msg, *args)
            if self.on_imbalance is not None:
                self.on_imbalance(rec)
        return rec

    # -- readers -------------------------------------------------------
    def records(self) -> list[LedgerRecord]:
        """Sealed records, oldest -> newest."""
        with self._lock:
            return list(self._ring)

    def last(self) -> LedgerRecord | None:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def to_json(self, limit: int | None = None) -> bytes:
        """``limit`` bounds the dump to the newest N records (fleet
        scrapers pass ``?n=``); imbalanced seqs still cover the whole
        ring so a truncated poll can't hide an old imbalance."""
        recs = self.records()
        tail = recs[-limit:] if limit and limit > 0 else recs
        out = {
            "node": self.node,
            "strict": self.strict,
            "intervals": len(recs),
            "returned": len(tail),
            "imbalanced": [r.seq for r in recs if not r.balanced],
            "records": [r.to_dict() for r in tail],
        }
        return json.dumps(out, indent=1).encode()

    def summary(self) -> dict:
        """Aggregate over the retained ring — what bench.py stamps
        into soak/chain artifacts as the conservation proof."""
        recs = self.records()
        out = {
            "intervals": len(recs),
            "balanced": sum(1 for r in recs if r.balanced),
            "imbalanced": sum(1 for r in recs if not r.balanced),
            "owed_total": sum(abs(r.owed) for r in recs),
            "received_total": sum(r.received_total() for r in recs),
            "staged_total": sum(r.staged for r in recs),
            "dropped_total": sum(r.dropped_total() for r in recs),
            "emitted_rows_total": sum(r.emitted_rows for r in recs),
            "forwarded_rows_total": sum(
                r.forwarded_rows for r in recs),
            "retained_rows_total": sum(
                r.retained_rows for r in recs),
        }
        if any(r.forward_split or r.forward_split_dropped
               for r in recs):
            per_dest: dict[str, int] = {}
            for r in recs:
                for dest, n in r.forward_split.items():
                    per_dest[dest] = per_dest.get(dest, 0) + n
            out["forward_split_per_dest"] = per_dest
            out["forward_split_total"] = sum(per_dest.values())
            out["forward_split_dropped_total"] = sum(
                r.forward_split_dropped for r in recs)
        if any(r.forward_collective for r in recs):
            per_dest = {}
            for r in recs:
                for dest, n in r.forward_collective.items():
                    per_dest[dest] = per_dest.get(dest, 0) + n
            out["forward_collective_per_dest"] = per_dest
            out["forward_collective_total"] = sum(per_dest.values())
        spooled = sum(r.forward_spooled for r in recs)
        spooled_async = sum(r.forward_spooled_async for r in recs)
        replayed = sum(r.forward_replayed for r in recs)
        if spooled or spooled_async or replayed:
            out["forward_spooled_total"] = spooled
            out["forward_spooled_async_total"] = spooled_async
            out["forward_replayed_total"] = replayed
        timeouts = sum(
            sum(r.forward_timeout_dropped.values()) for r in recs)
        if timeouts:
            out["forward_timeout_dropped_total"] = timeouts
        if any(r.reshard_epoch for r in recs):
            out["reshards_total"] = sum(
                1 for r in recs if r.reshard_epoch)
            out["reshard_moved_rows_total"] = sum(
                r.reshard_moved_rows for r in recs)
        reshard_recv = sum(r.reshard_received_items for r in recs)
        if reshard_recv:
            out["reshard_received_items_total"] = reshard_recv
        recovered = sum(r.recovered for r in recs)
        if recovered or any(r.recovered_owed for r in recs):
            by: dict[str, int] = {}
            for r in recs:
                for src, n in r.recovered_by.items():
                    by[src] = by.get(src, 0) + n
            out["recovered_total"] = recovered
            out["recovered_by"] = by
            out["recovered_owed_total"] = sum(
                abs(r.recovered_owed) for r in recs)
        shed = sum(r.shed for r in recs)
        if shed or any(r.shed_owed for r in recs):
            by: dict[str, dict[str, int]] = {}
            for r in recs:
                for (tenant, reason), n in r.shed_by.items():
                    t = by.setdefault(tenant, {})
                    t[reason] = t.get(reason, 0) + n
            out["shed_total"] = shed
            out["shed_by"] = by
            out["shed_owed_total"] = sum(
                abs(r.shed_owed) for r in recs)
        coalesced = sum(r.coalesced for r in recs)
        if coalesced:
            out["coalesced_total"] = coalesced
        kdrops = sum(r.kernel_drops for r in recs)
        if kdrops:
            out["kernel_drops_observed_total"] = kdrops
        return out


@dataclass
class SpoolLedgerRecord:
    """One sealed snapshot of the outage spool's lifetime account.

    The spool's counters are CUMULATIVE (a wire spooled in interval N
    may replay in interval N+40), so conservation is checked on the
    running totals, not per-interval deltas:

        spooled == replayed + expired + still_queued + inflight

    ``expired_by_reason`` names every expiry (age cap, byte cap,
    destination retired) — an expired wire is an attributed loss,
    never an unaccounted one.
    """

    seq: int = 0
    start_unix: float = 0.0
    spooled_items: int = 0
    replayed_items: int = 0
    expired_items: int = 0
    queued_items: int = 0
    inflight_items: int = 0
    queued_bytes: int = 0
    expired_by_reason: dict[str, int] = field(default_factory=dict)
    sealed: bool = False
    balanced: bool = True
    owed: int = 0

    def to_dict(self) -> dict:
        return {
            "seq": self.seq,
            "start_unix": self.start_unix,
            "spooled_items": self.spooled_items,
            "replayed_items": self.replayed_items,
            "expired_items": self.expired_items,
            "queued_items": self.queued_items,
            "inflight_items": self.inflight_items,
            "queued_bytes": self.queued_bytes,
            "expired_by_reason": dict(self.expired_by_reason),
            "balanced": self.balanced,
            "owed": self.owed,
        }


class SpoolLedger:
    """Cross-interval conservation ledger for the outage spool.

    The server seals one snapshot per flush interval from the
    ``WireSpool``'s stats (``seal_snapshot``); any instant where
    ``spooled != replayed + expired + queued + inflight`` is an
    imbalance — strict mode escalates it exactly like the interval
    ledger (error log + ``on_imbalance``), because a spool that
    leaks items silently would turn the zero-loss story back into a
    detector.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 node: str = "veneur", strict: bool = False,
                 on_imbalance=None):
        self.node = node
        self.strict = strict
        self.on_imbalance = on_imbalance
        self._lock = threading.Lock()
        self._ring: deque[SpoolLedgerRecord] = deque(maxlen=capacity)
        self._seq = 0
        self.imbalanced_total = 0

    def seal_snapshot(self, stats: dict,
                      seq: int = 0) -> SpoolLedgerRecord:
        """Seal one conservation snapshot from ``WireSpool.stats()``
        output (cumulative counters + current queue state)."""
        rec = SpoolLedgerRecord(
            start_unix=time.time(),
            spooled_items=int(stats.get("spooled_items", 0)),
            replayed_items=int(stats.get("replayed_items", 0)),
            expired_items=int(stats.get("expired_items", 0)),
            queued_items=int(stats.get("queued_items", 0)),
            inflight_items=int(stats.get("inflight_items", 0)),
            queued_bytes=int(stats.get("queued_bytes", 0)),
            expired_by_reason=dict(
                stats.get("expired_by_reason", {})),
        )
        rec.owed = rec.spooled_items - (
            rec.replayed_items + rec.expired_items
            + rec.queued_items + rec.inflight_items)
        rec.balanced = rec.owed == 0
        rec.sealed = True
        with self._lock:
            self._seq += 1
            rec.seq = int(seq) or self._seq
            self._ring.append(rec)
            if not rec.balanced:
                self.imbalanced_total += 1
        if not rec.balanced:
            msg = ("spool ledger imbalance node=%s seq=%d: owed=%d "
                   "items (spooled=%d replayed=%d expired=%d "
                   "queued=%d inflight=%d)")
            args = (self.node, rec.seq, rec.owed, rec.spooled_items,
                    rec.replayed_items, rec.expired_items,
                    rec.queued_items, rec.inflight_items)
            if self.strict:
                log.error(msg, *args)
            else:
                log.warning(msg, *args)
            if self.on_imbalance is not None:
                self.on_imbalance(rec)
        return rec

    def records(self) -> list[SpoolLedgerRecord]:
        with self._lock:
            return list(self._ring)

    def to_json(self) -> bytes:
        recs = self.records()
        out = {
            "node": self.node,
            "strict": self.strict,
            "snapshots": len(recs),
            "imbalanced": [r.seq for r in recs if not r.balanced],
            "records": [r.to_dict() for r in recs],
        }
        return json.dumps(out, indent=1).encode()

    def summary(self) -> dict:
        """The cumulative counters are monotone, so the LAST snapshot
        is the lifetime account (summing across snapshots would
        double-count); balanced/imbalanced tally every snapshot."""
        recs = self.records()
        last = recs[-1] if recs else SpoolLedgerRecord()
        return {
            "snapshots": len(recs),
            "balanced": sum(1 for r in recs if r.balanced),
            "imbalanced": sum(1 for r in recs if not r.balanced),
            "owed_total": sum(abs(r.owed) for r in recs),
            "spooled_items": last.spooled_items,
            "replayed_items": last.replayed_items,
            "expired_items": last.expired_items,
            "queued_items": last.queued_items,
            "inflight_items": last.inflight_items,
            "expired_by_reason": dict(last.expired_by_reason),
        }


@dataclass
class ProxyLedgerRecord:
    """One proxy routing interval's conservation account.

    Balance (checked at seal): every item presented to the router is
    either ``routed`` (assigned a destination) or ``dropped`` (no
    destination — empty ring), and every routed item was either
    ``enqueued`` on its destination worker or ``busy_dropped`` when
    that worker's bounded queue was full:

        routed == enqueued + busy_dropped

    ``sent_items``/``error_items``/``retries`` are the destination
    workers' ASYNC wire outcomes — they may land after the interval
    that enqueued them seals, so (like the server ledger's
    forward_wire block) they're informational, not balance inputs.
    """

    seq: int = 0
    start_unix: float = 0.0
    routed: int = 0
    dropped: int = 0
    enqueued: int = 0
    busy_dropped: int = 0
    # per-destination routed split (same role as the server ledger's
    # forward_split: a shard silently losing its wires shows up as a
    # skewed/missing destination, not just a shrunken total)
    routed_per_dest: dict[str, int] = field(default_factory=dict)
    sent_items: int = 0
    error_items: int = 0
    retries: int = 0
    fallbacks: int = 0       # columnar->legacy fail-open takes
    sealed: bool = False
    balanced: bool = True
    owed: int = 0

    def to_dict(self) -> dict:
        return {
            "seq": self.seq,
            "start_unix": self.start_unix,
            "routed": self.routed,
            "dropped": self.dropped,
            "enqueued": self.enqueued,
            "busy_dropped": self.busy_dropped,
            "routed_per_dest": dict(self.routed_per_dest),
            "wire": {"sent_items": self.sent_items,
                     "error_items": self.error_items,
                     "retries": self.retries},
            "fallbacks": self.fallbacks,
            "balanced": self.balanced,
            "owed": self.owed,
        }


class ProxyLedger:
    """Item-conservation ledger for the proxy hop.

    Both route paths credit it: the columnar router and the legacy
    per-item oracle make ONE ``credit_route`` call per batch with all
    four synchronous counts, so an interval roll can never split a
    batch's credits across records.  ``roll()`` closes + seals the
    current interval in one step (the proxy has no flush cycle to
    separate the two); the refresh loop drives it once per discovery
    interval and bench drives it per pass.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 node: str = "veneur-proxy", strict: bool = False,
                 on_imbalance=None):
        self.node = node
        self.strict = strict
        self.on_imbalance = on_imbalance
        self._lock = threading.Lock()
        self._ring: deque[ProxyLedgerRecord] = deque(maxlen=capacity)
        self._cur = ProxyLedgerRecord(start_unix=time.time())
        self._seq = 0
        self.imbalanced_total = 0

    def credit_route(self, routed: int = 0, dropped: int = 0,
                     enqueued: int = 0, busy_dropped: int = 0,
                     fallbacks: int = 0,
                     per_dest: dict | None = None) -> None:
        with self._lock:
            cur = self._cur
            cur.routed += int(routed)
            cur.dropped += int(dropped)
            cur.enqueued += int(enqueued)
            cur.busy_dropped += int(busy_dropped)
            cur.fallbacks += int(fallbacks)
            if per_dest:
                for dest, n in per_dest.items():
                    cur.routed_per_dest[dest] = (
                        cur.routed_per_dest.get(dest, 0) + int(n))

    def credit_send(self, sent_items: int = 0, error_items: int = 0,
                    retries: int = 0) -> None:
        with self._lock:
            cur = self._cur
            cur.sent_items += int(sent_items)
            cur.error_items += int(error_items)
            cur.retries += int(retries)

    def roll(self) -> ProxyLedgerRecord:
        """Close + seal the current interval; returns the sealed
        record."""
        with self._lock:
            rec = self._cur
            self._seq += 1
            self._cur = ProxyLedgerRecord(start_unix=time.time())
            rec.seq = self._seq
            rec.owed = rec.routed - (rec.enqueued + rec.busy_dropped)
            rec.balanced = rec.owed == 0
            rec.sealed = True
            self._ring.append(rec)
            if not rec.balanced:
                self.imbalanced_total += 1
        if not rec.balanced:
            msg = ("proxy ledger imbalance node=%s seq=%d: owed=%d "
                   "(routed=%d enqueued=%d busy_dropped=%d dropped=%d)")
            args = (self.node, rec.seq, rec.owed, rec.routed,
                    rec.enqueued, rec.busy_dropped, rec.dropped)
            if self.strict:
                log.error(msg, *args)
            else:
                log.warning(msg, *args)
            if self.on_imbalance is not None:
                self.on_imbalance(rec)
        return rec

    def records(self) -> list[ProxyLedgerRecord]:
        with self._lock:
            return list(self._ring)

    def to_json(self, limit: int | None = None) -> bytes:
        recs = self.records()
        tail = recs[-limit:] if limit and limit > 0 else recs
        out = {
            "node": self.node,
            "strict": self.strict,
            "intervals": len(recs),
            "returned": len(tail),
            "imbalanced": [r.seq for r in recs if not r.balanced],
            "records": [r.to_dict() for r in tail],
        }
        return json.dumps(out, indent=1).encode()

    def summary(self) -> dict:
        """Aggregate over the retained ring — the shape the proxy
        bench stamps into its artifact (same gate keys as
        ``Ledger.summary``: intervals/balanced/imbalanced/
        owed_total)."""
        recs = self.records()
        per_dest: dict[str, int] = {}
        for r in recs:
            for dest, n in r.routed_per_dest.items():
                per_dest[dest] = per_dest.get(dest, 0) + n
        return {
            "intervals": len(recs),
            "balanced": sum(1 for r in recs if r.balanced),
            "imbalanced": sum(1 for r in recs if not r.balanced),
            "owed_total": sum(abs(r.owed) for r in recs),
            "routed_total": sum(r.routed for r in recs),
            "dropped_total": sum(r.dropped for r in recs),
            "enqueued_total": sum(r.enqueued for r in recs),
            "busy_dropped_total": sum(r.busy_dropped for r in recs),
            "sent_items_total": sum(r.sent_items for r in recs),
            "error_items_total": sum(r.error_items for r in recs),
            "fallbacks_total": sum(r.fallbacks for r in recs),
            "routed_per_dest": per_dest,
        }
