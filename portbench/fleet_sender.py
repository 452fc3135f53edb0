"""The fleet's load generator: processes apart from the server.

Every local's forward wire is built from the traffic file and the seed
(``pbench.plan``, ``pbench.wire``: numpy and the wire schema, nothing of
the program) and sent by gRPC ``SendMetrics`` over loopback, one channel
a local.  The locals are split over ``SENDERS`` child processes, each
building and sending its own share, so no wire crosses a pipe.  This
process takes commands on standard input, one a line, hands them to the
children and answers on standard output:

- ``port <n>``: the global's listener; every channel connects.
- ``go <interval> <due>``: send every local's wire for that interval,
  all due at ``due`` (``time.monotonic()``, the clock every process
  shares); each channel sends once its last wire was acknowledged.
  Answers ``done <interval> <acked> <failed> <items acked>`` once every
  wire is answered.  Local 0's wire carries one extra counter,
  ``portbench.interval``, worth the interval's number plus one.
- ``stop``: answers ``latencies <json>``, every send's seconds from its
  due time to its acknowledgement with its interval, and exits.

Run: ``python3 portbench/fleet_sender.py <traffic.json> <seed> [scale]``.
It prints ``ready <items> <centroids> <bytes> <seconds> <slowest
build's seconds>`` once every wire is built.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

METHOD = "/forwardrpc.Forward/SendMetrics"
SENDERS = 4


def marker_item(interval: int) -> bytes:
    from pbench import wire
    return wire.counter_item("portbench.interval", (), interval + 1,
                             "global")


class Sender:
    """One child's locals: their wires and channels."""

    def __init__(self, locals_: range, wires: list[bytes], items: list[int]):
        self.locals = locals_
        self.wires = wires
        self.items = items
        self.channels = []
        self.calls = []
        self.latencies: list[tuple[int, float]] = []

    def connect(self, port: int) -> None:
        import grpc
        for _ in self.wires:
            ch = grpc.insecure_channel(f"127.0.0.1:{port}")
            self.channels.append(ch)
            self.calls.append(ch.unary_unary(
                METHOD, request_serializer=lambda b: b,
                response_deserializer=lambda b: b))
        for ch in self.channels:
            grpc.channel_ready_future(ch).result(timeout=60)

    def interval(self, n: int, due: float) -> tuple[int, int, int]:
        """Send interval ``n``; returns (wires acknowledged, wires
        failed, items acknowledged)."""
        done = threading.Event()
        lock = threading.Lock()
        state = {"left": len(self.wires), "ok": 0, "failed": 0, "items": 0}

        def on_done(fut, items):
            t = time.monotonic()
            err = fut.exception()
            with lock:
                self.latencies.append((n, t - due))
                if err is None:
                    state["ok"] += 1
                    state["items"] += items
                else:
                    state["failed"] += 1
                    print(f"wire failed: {err}", file=sys.stderr)
                state["left"] -= 1
                if not state["left"]:
                    done.set()
        for local, call, w, items in zip(self.locals, self.calls,
                                         self.wires, self.items):
            if local == 0:
                w, items = w + marker_item(n), items + 1
            f = call.future(w, timeout=300)
            f.add_done_callback(lambda fut, k=items: on_done(fut, k))
        done.wait()
        return state["ok"], state["failed"], state["items"]

    def close(self) -> None:
        for ch in self.channels:
            ch.close()


def child(conn, traffic: dict, seed: int, locals_: range,
          scale: int) -> None:
    """A child process: build its locals' wires, then serve the parent's
    commands over ``conn``."""
    t0 = time.monotonic()
    from pbench import plan, wire
    enc = wire.FleetEncoder(float(traffic["compression"]))
    built = [enc.wire(plan.fleet_local(traffic, seed, i, scale))
             for i in locals_]
    sender = Sender(locals_, [w for w, _, _ in built],
                    [i for _, i, _ in built])
    conn.send(("ready", sum(i for _, i, _ in built),
               sum(c for _, _, c in built), sum(len(w) for w, _, _ in built),
               time.monotonic() - t0))
    try:
        while True:
            cmd = conn.recv()
            if cmd[0] == "port":
                sender.connect(cmd[1])
                conn.send(("connected",))
            elif cmd[0] == "go":
                conn.send(("done",) + sender.interval(cmd[1], cmd[2]))
            elif cmd[0] == "stop":
                conn.send(("latencies", sender.latencies))
                return
    except EOFError:
        return  # the parent went away
    finally:
        sender.close()
        conn.close()


def main(argv: list[str]) -> int:
    import multiprocessing
    traffic = json.load(open(argv[1]))
    seed = int(argv[2])
    scale = int(argv[3]) if len(argv) > 3 else 1
    t0 = time.monotonic()
    n = int(traffic["locals"])
    step = -(-n // SENDERS)
    ctx = multiprocessing.get_context("spawn")
    kids = []
    for lo in range(0, n, step):
        parent, kid = ctx.Pipe()
        p = ctx.Process(target=child, args=(kid, traffic, seed,
                                            range(lo, min(lo + step, n)),
                                            scale))
        p.start()
        kid.close()
        kids.append((p, parent))

    def ask(cmd):
        for _, c in kids:
            c.send(cmd)
        return [c.recv() for _, c in kids]
    try:
        got = [c.recv() for _, c in kids]
        print("ready", sum(g[1] for g in got), sum(g[2] for g in got),
              sum(g[3] for g in got), time.monotonic() - t0,
              max(g[4] for g in got), flush=True)
        for line in sys.stdin:
            cmd = line.split()
            if not cmd:
                continue
            if cmd[0] == "port":
                ask(("port", int(cmd[1])))
                print("connected", flush=True)
            elif cmd[0] == "go":
                got = ask(("go", int(cmd[1]), float(cmd[2])))
                print("done", cmd[1], *(sum(g[k] for g in got)
                                        for k in (1, 2, 3)), flush=True)
            elif cmd[0] == "stop":
                got = ask(("stop",))
                print("latencies", json.dumps(
                    [x for g in got for x in g[1]]), flush=True)
                break
    finally:
        for _, c in kids:
            c.close()
        for p, _ in kids:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
