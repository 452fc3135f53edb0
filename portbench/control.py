"""The control: the plain reference put in the program's place with one
of the configuration's guarantees broken, held to the same comparison
as a run.  It must come out not correct.

The configurations state no precision of their own; they state that
every acknowledged sample or item is in its interval's flush.  The
control breaks that: it flushes what the reference works out from a
random half of each interval's samples (DogStatsD) or of each local's
samples (fleet), after acknowledging all of them (the ``control_pair``
of the cell's driver).

    python3 portbench/control.py --workload <name> --seeds 1,2,3 [--scale n]

prints one JSON line a seed with the numbers compared and their limits.
The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

from pbench.spec import driver, load_cell  # noqa: E402
from reference import compare, expected  # noqa: E402


def reference_flush(ex: expected.Expected, interval: int) -> dict:
    """The flush a node would give that holds exactly ``ex``: every
    value as the reference works it out (of a gauge's last writes, the
    largest)."""
    out = dict(ex.counters)
    out.update({k: max(v) for k, v in ex.gauges.items()})
    out.update({k: float(v) for k, v in ex.sets.items()})
    out[expected.key(expected.MARKER, ())] = float(interval + 1)
    sufs = [expected.percentile_suffix(p) for p in ex.percentiles]
    for t in ex.timers:
        for j, (n, tags) in enumerate(t.names):
            if t.aggregates:
                for agg, arr in (("count", t.count), ("min", t.vmin),
                                 ("max", t.vmax)):
                    if agg in ex.aggregates:
                        out[(n + "." + agg, tags)] = float(arr[j])
            for pi, s in enumerate(sufs):
                out[(n + s, tags)] = float(t.quantiles[j, pi])
    return out


def control_numbers(cell, seed: int, scale: int = 1) -> dict:
    """The comparison's numbers for the control on one seed."""
    want, got = driver(cell.traffic["kind"]).control_pair(cell, seed, scale)
    r = compare.Readings()
    compare.compare_interval(reference_flush(got, 1), want, 1, True, r)
    return r.numbers()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--scale", type=int, default=1)
    a = ap.parse_args(argv)
    cell = load_cell(a.workload)
    from pbench.results import limits_for
    limits = limits_for(cell)
    for s in a.seeds.split(","):
        t0 = time.monotonic()
        nums = control_numbers(cell, int(s), a.scale)
        ok, checks = compare.judge(nums, limits)
        print(json.dumps({"workload": a.workload, "seed": int(s),
                          "correct": ok, "seconds": time.monotonic() - t0,
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
