"""Driver of DogStatsD cells (traffic ``kind: dogstatsd``): a node's
reader shards fed pre-built sweeps.

One feeder thread a reader shard (the configuration's ``num_readers``),
each with its ``ReaderShard``, calls ``handle_packet_batch`` with
pre-built sweeps of ``reader_batch_packets`` less one datagrams (the
call a UDP reader makes after one recvmmsg sweep under load) until the
interval's sweeps are taken, dealt round robin; then the flush.
"""

from __future__ import annotations

import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from pbench import dsd, harness, plan as planmod

PROTOCOL = "dogstatsd"          # the ledger's name for what was taken
WORK_METRIC = "samples_per_s"   # the end-to-end rate of the window


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_setup0: float, scale: int = 1, build_dir: str | None = None,
        hooks=None) -> harness.RunOutput:
    tr = cell.traffic
    box: dict = {}

    def generate():
        p = planmod.dogstatsd_plan(tr, cell.config["server"], seed, scale)
        box["plan"] = p
        box["sweeps"], box["lines"] = dsd.interval_sweeps(p)
    gen = threading.Thread(target=generate, name="portbench-gen")
    gen.start()
    srv, sink = harness.make_server(cell, device, build_dir)
    gen.join()
    if hooks:
        hooks(srv, sink)
    sweeps, lines, F = box["sweeps"], box["lines"], box["plan"].feeders
    per_dgram = int(tr["lines_per_datagram"])
    dgrams = [-(-int(n) // per_dgram) for n in lines]
    shards = [srv.table.make_reader_shard() for _ in range(F)]
    mine = [list(range(f, len(sweeps), F)) for f in range(F)]
    pool = ThreadPoolExecutor(F, thread_name_prefix="portbench-feeder")

    def feed(f: int):
        sh = shards[f]
        got = failed = 0
        t0 = time.monotonic()
        for k in mine[f]:
            try:
                got += srv.handle_packet_batch(
                    [], drained=sweeps[k], drained_pkts=dgrams[k], shard=sh)
            except Exception as e:  # counted; the check then fails
                print(f"feeder {f}: {type(e).__name__}: {e}",
                      file=sys.stderr)
                failed += 1
        return t0, time.monotonic(), got, len(mine[f]), failed

    def interval(n: int):
        with harness.span(trace, "ingest"):
            got = srv.handle_packet_batch([b"%s:%d|c" % (
                b"portbench.interval", n + 1)])
            outs = [f.result() for f in [pool.submit(feed, f)
                                         for f in range(F)]]
        acked = got + sum(o[2] for o in outs)
        iv = harness.Interval(
            n, max(o[1] for o in outs) - min(o[0] for o in outs), 0.0, 0.0,
            acked, 1 + sum(o[3] for o in outs), sum(o[4] for o in outs),
            False)
        return iv, iv.failed == 0

    try:
        out = harness.window(srv, sink, interval, PROTOCOL, seed, seconds,
                             trace, t_setup0)
    finally:
        pool.shutdown(wait=True)
        srv.shutdown()
    out.plan = box["plan"]
    out.info.update(sweeps=len(sweeps), lines=int(lines.sum()), feeders=F)
    return out


def expected(cell, out, seed: int, scale: int):
    """The reference's interval for the plan the run drew."""
    from reference import expected as ref
    srv = cell.config["server"]
    return ref.dogstatsd_expected(out.plan, srv["percentiles"],
                                  srv["aggregates"])


def halved(p: planmod.DsdPlan, seed: int) -> planmod.DsdPlan:
    """``p`` with a random half of its samples, drawn from the seed."""
    rng = planmod.rng_for(seed, 77)
    classes = []
    for c in p.classes:
        keep = rng.random(len(c.series)) < 0.5
        v = c.values
        classes.append(planmod.DsdClass(
            c.type, c.names, c.series[keep],
            planmod.Values(v.text[keep], v.decimals, v.value[keep]),
            c.pos[keep]))
    return planmod.DsdPlan(classes, p.n_lines, p.lines_per_sweep, p.feeders)


def control_pair(cell, seed: int, scale: int):
    """(what the reference expects, what the control flushes): the
    control's node holds a random half of each interval's samples."""
    from reference import expected as ref
    srv = cell.config["server"]
    ps, aggs = srv["percentiles"], srv["aggregates"]
    p = planmod.dogstatsd_plan(cell.traffic, srv, seed, scale)
    return (ref.dogstatsd_expected(p, ps, aggs),
            ref.dogstatsd_expected(halved(p, seed), ps, aggs))
