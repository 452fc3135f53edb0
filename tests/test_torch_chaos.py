"""The port's fault injection and outage riding against the
reference's.

Port counterparts of every test in ``tests/test_chaos_smoke.py``.  The
injector tests drive the port's ``WireFaultInjector`` and the JAX
package's with the same calls and hold their stats equal.  The two
soaks run the same scenario through the port's ``ShardedForwarder``,
``WireSpool`` and ledgers and through the JAX package's, against model
globals (``bench.py``'s ``_ModelGlobal``: a real ``SendMetrics``
listener that counts items) and on the same pooled wires: the routed
item totals are equal between the packages (each run's ring has other
ports, so which rows move differs; the split itself is held to the
reference in ``tests/test_torch_shard.py``), and each package passes
the reference's accounting identities: every
routed item landed or is a named wire-error drop (the kill), nothing
lost at all (kill, spool, restart, replay).  Wire outcomes under a
dead destination are timing-dependent, so those counts are held per
package, not across them.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import threading
import time

import pytest

from veneur_tpu import chaos as jchaos
from veneur_tpu.forward.shard import ShardedForwarder as JForwarder
from veneur_tpu.forward.spool import Spooled as JSpooled
from veneur_tpu.forward.spool import WireSpool as JWireSpool
from veneur_tpu.observe import ledger as jledger
from veneur_tpu_torch import chaos
from veneur_tpu_torch.forward.shard import ShardedForwarder
from veneur_tpu_torch.forward.spool import Spooled, WireSpool
from veneur_tpu_torch.observe import ledger
from tests.torch_fixtures import unsampled_span_uniqueness  # noqa: F401


PKGS = {"torch": (chaos, ShardedForwarder, WireSpool, Spooled, ledger),
        "jax": (jchaos, JForwarder, JWireSpool, JSpooled, jledger)}


def _bench():
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "bench.py")
    spec = importlib.util.spec_from_file_location("_bench_chaos_t", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["_bench_chaos_t"] = mod
    spec.loader.exec_module(mod)
    return mod


# ----------------------------------------------------------------------
# injector mechanics


def test_injector_drop_is_counted_and_exhausts():
    stats = []
    for mod in (chaos, jchaos):
        inj = mod.WireFaultInjector()
        inj.drop_wires("d:1", 2)
        for _ in range(2):
            with pytest.raises(mod.InjectedWireDrop):
                inj("d:1", b"")
        inj("d:1", b"")
        inj("other:1", b"")
        stats.append(inj.stats())
    assert stats[0] == stats[1]
    assert stats[0]["injected_drops"] == 2
    assert stats[0]["armed_drops"] == {"d:1": 0}


def test_injector_stall_is_one_shot_and_delay_persists():
    stats = []
    for mod in (chaos, jchaos):
        inj = mod.WireFaultInjector()
        inj.stall_once("d:1", 0.05)
        t0 = time.perf_counter()
        inj("d:1", b"")
        assert time.perf_counter() - t0 >= 0.04
        t0 = time.perf_counter()
        inj("d:1", b"")
        assert time.perf_counter() - t0 < 0.04
        inj.delay_wires("d:1", 0.03)
        for _ in range(2):
            t0 = time.perf_counter()
            inj("d:1", b"")
            assert time.perf_counter() - t0 >= 0.02
        inj.clear()
        t0 = time.perf_counter()
        inj("d:1", b"")
        assert time.perf_counter() - t0 < 0.02
        stats.append(inj.stats())
    assert stats[0] == stats[1]
    assert stats[0]["injected_delays"] == 2
    assert stats[0]["injected_stalls"] == 1


def test_injector_installs_on_forwarder_fault_hook():
    """The seam sits where the reference's does: before every send
    attempt in the destination worker.  Drops past the retries reach
    the result callback as the injector's error."""
    m = _bench()
    g = m._ModelGlobal(0.0)
    fwd = ShardedForwarder((f"127.0.0.1:{g.port}",), retries=1,
                           backoff=0.01)
    try:
        inj = chaos.WireFaultInjector().install(fwd)
        assert fwd.fault_hook is inj
        dest = fwd.addresses[0]
        body = m._cluster_wire_pool("hook", 1, 20)[0]
        inj.drop_wires(dest, 2)
        out = []
        done = threading.Event()

        def _res(dest, n_items, err, retries):
            out.append((n_items, err, retries))
            done.set()
        assert fwd.send(dest, body, 20, on_result=_res)
        assert done.wait(20.0)
        assert isinstance(out[0][1], chaos.InjectedWireDrop)
        assert inj.stats()["injected_drops"] == 2
        assert g.accepted == 0
        done.clear()
        assert fwd.send(dest, body, 20, on_result=_res)
        assert done.wait(20.0)
        assert out[1][1] is None and g.accepted == 20
    finally:
        fwd.stop()
        g.stop()


# ----------------------------------------------------------------------
# single-fault smoke: shard kill + reshard, exact attribution


def _shard_kill(m, pkg: str, wires) -> dict:
    _chaos, Fwd, _Spool, _Spooled, led_mod = PKGS[pkg]
    globals_ = [m._ModelGlobal(0.0) for _ in range(2)]
    fwd = None
    try:
        dests = [f"127.0.0.1:{g.port}" for g in globals_]
        fwd = Fwd(dests, queue_size=4, retries=1, backoff=0.01)
        led = led_mod.Ledger(node="smoke")
        lock = threading.Lock()
        out = {"error_items": 0, "routed_total": 0, "reshards": 0,
               "moved_total": 0}
        for it in range(8):
            if it == 3:
                globals_[1].stop()
            if it == 5:
                fwd.set_members(dests[:1])
            data = wires[it % len(wires)]
            rec = led.close_interval(seq=it + 1)
            routed = fwd.route(data)
            assert routed is not None
            resh = fwd.take_reshard()
            if resh is not None:
                epoch, added, removed, prev = resh
                prev_routed = fwd.route(data, ring=prev)
                new = {routed.members[d]: n for d, _b, n in routed.batches}
                old = {prev_routed.members[d]: n
                       for d, _b, n in prev_routed.batches}
                moved = sum(max(0, new.get(x, 0) - old.get(x, 0))
                            for x in set(new) | set(old))
                led.credit_reshard(rec, epoch, added, removed, moved)
                out["reshards"] += 1
                out["moved_total"] += moved
            led.credit_rows(rec, {"staged_rows": routed.routed,
                                  "forwarded_rows": routed.routed})
            out["routed_total"] += routed.routed
            landed = []
            for d, body, n in routed.batches:
                dest = routed.members[d]
                ev = threading.Event()

                def _res(dest, n_items, err, retries, ev=ev):
                    if err is not None:
                        with lock:
                            out["error_items"] += n_items
                    ev.set()
                assert fwd.send(dest, body, n, on_result=_res)
                led.credit_forward_split(rec, dest, n)
                landed.append(ev)
            for ev in landed:
                assert ev.wait(20.0)
            rec = led.seal(rec)
            assert rec.balanced, rec.to_dict()
        out["accepted"] = sum(g.accepted for g in globals_)
        out["summary"] = led.summary()
        out["addresses"] = fwd.addresses
        out["dests"] = dests
        return out
    finally:
        if fwd is not None:
            fwd.stop()
        for g in globals_:
            g.stop()


def test_shard_kill_single_fault_smoke():
    m = _bench()
    wires = m._cluster_wire_pool("smoke", 2, 300)
    runs = {pkg: _shard_kill(m, pkg, wires) for pkg in ("torch", "jax")}
    for out in runs.values():
        assert out["routed_total"] == out["accepted"] + out["error_items"]
        assert out["error_items"] > 0
        assert out["reshards"] == 1 and out["moved_total"] > 0
        summ = out["summary"]
        assert summ["imbalanced"] == 0
        assert summ["reshards_total"] == 1
        assert summ["reshard_moved_rows_total"] == out["moved_total"]
        assert out["addresses"] == (out["dests"][0],)
    assert runs["torch"]["routed_total"] == runs["jax"]["routed_total"]


# ----------------------------------------------------------------------
# outage-riding recovery smoke: kill, spool, restart, replay, zero loss


def _outage(m, pkg: str, wires, n_iters=10, kill_iter=2, restart_iter=5,
            iter_sleep=0.05, cooldown=0.3) -> dict:
    """``bench.py``'s ``_chaos_recovery`` driven through one package's
    forwarder, spool and ledgers (no signal plane)."""
    _chaos, Fwd, Spool, SpooledErr, led_mod = PKGS[pkg]
    globals_ = [m._ModelGlobal(0.0) for _ in range(2)]
    dead_port = globals_[1].port
    spool = Spool(max_bytes=8 * 1024 * 1024, max_age=120.0)
    fwd = Fwd([f"127.0.0.1:{g.port}" for g in globals_], queue_size=8,
              retries=1, backoff=0.02, breaker_threshold=2,
              breaker_cooldown=cooldown, spool=spool)
    led = led_mod.Ledger(node="recovery")
    spool_led = led_mod.SpoolLedger(node="recovery")
    lock = threading.Lock()
    r = {"routed_total": 0, "error_items": 0, "busy_dropped": 0,
         "spooled_route_items": 0, "replay_credited": 0}

    def one_iter(seq: int) -> None:
        data = wires[seq % len(wires)]
        rec = led.close_interval(seq=seq + 1)
        routed = fwd.route(data)
        led.credit_rows(rec, {"staged_rows": routed.routed,
                              "forwarded_rows": routed.routed})
        r["routed_total"] += routed.routed
        landed = []
        for d, body, n in routed.batches:
            dest = routed.members[d]
            if fwd.should_spool(dest):
                assert spool.put(dest, body, n)
                led.credit_forward_spooled(rec, n)
                r["spooled_route_items"] += n
                continue
            ev = threading.Event()

            def _res(dest_, n_items, err, tries, ev=ev, nbytes=len(body)):
                if err is None:
                    led.credit_forward_wire(rec, rows=n_items,
                                            nbytes=nbytes)
                elif isinstance(err, SpooledErr):
                    led.credit_spool_outcome(rec, spooled_async=n_items)
                    led.credit_forward_wire(rec, errors=1)
                else:
                    with lock:
                        r["error_items"] += n_items
                    led.credit_forward_wire(rec, errors=1)
                ev.set()
            if fwd.send(dest, body, n, on_result=_res):
                led.credit_forward_split(rec, dest, n)
                landed.append(ev)
            else:
                r["busy_dropped"] += n
                led.credit_forward_split(rec, dropped=n)
        for ev in landed:
            assert ev.wait(20.0)
        delta = fwd.replayed_items - r["replay_credited"]
        if delta:
            led.credit_spool_outcome(rec, replayed=delta)
            r["replay_credited"] += delta
        spool_led.seal_snapshot(spool.stats(), seq=seq + 1)
        led.seal(rec)

    restarted = None
    try:
        for it in range(n_iters):
            if it == kill_iter:
                globals_[1].stop()
            elif it == restart_iter:
                restarted = m._ModelGlobal(0.0, port=dead_port)
            one_iter(it)
            time.sleep(iter_sleep)
        seq = n_iters
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            st = spool.stats()
            if st["queued_items"] + st["inflight_items"] == 0:
                break
            one_iter(seq)
            seq += 1
            time.sleep(iter_sleep)
        rec = led.close_interval(seq=seq + 1)
        delta = fwd.replayed_items - r["replay_credited"]
        if delta:
            led.credit_spool_outcome(rec, replayed=delta)
        spool_led.seal_snapshot(spool.stats(), seq=seq + 1)
        led.seal(rec)
        r["breaker_opens"] = fwd.totals()["breaker_opens"]
        r["spool"] = spool.stats()
        r["spool_balance_owed"] = spool.check_balance()
    finally:
        fwd.stop()
        for g in globals_:
            g.stop()
        if restarted is not None:
            restarted.stop()
    every = globals_ + ([restarted] if restarted is not None else [])
    r["accepted"] = sum(g.accepted for g in every)
    r["replay_wires_received"] = sum(g.replay_wires for g in every)
    r["ledger"] = led.summary()
    r["spool_ledger"] = spool_led.summary()
    return r


def test_outage_recovery_zero_loss_smoke():
    m = _bench()
    wires = m._cluster_wire_pool("rcvy", 2, 150)
    for pkg in ("torch", "jax"):
        out = _outage(m, pkg, wires)
        assert out["breaker_opens"] >= 1, pkg
        assert out["spool"]["spooled_items"] > 0
        assert out["spooled_route_items"] > 0
        assert out["replay_wires_received"] >= 1
        assert out["spool"]["queued_items"] == 0
        assert out["spool"]["inflight_items"] == 0
        assert out["spool"]["expired_items"] == 0
        assert out["spool"]["replayed_items"] == \
            out["spool"]["spooled_items"]
        # zero loss (a retried wire may land twice: at least once)
        assert out["accepted"] >= out["routed_total"], pkg
        assert out["error_items"] == 0 and out["busy_dropped"] == 0
        assert out["spool_balance_owed"] == 0
        assert out["ledger"]["imbalanced"] == 0
        assert out["spool_ledger"]["imbalanced"] == 0
