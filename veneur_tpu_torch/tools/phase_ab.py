"""Phases 9 and 10 of ``chip_smoke.py`` from several checkouts, in one
call: the same-call comparison of two trees on one card.

    python3 -m veneur_tpu_torch.tools.phase_ab [--out DIR] PARENT . . PARENT

Each argument is a checkout (a directory holding ``chip_smoke.py`` and
its package); they run in the order given, each in a fresh process
from its own directory, so each builds and loads its own libraries.  A
run builds the kernels, runs phase 4 at full size without its CPU
reference (phase 9 takes its text), phase 9 (1, 2 and 4 readers) and
phase 10 without its CPU server.  Prints one JSON line per run (phase
9's samples/s and locked share per reader count, phase 10's
samples/s per interval and over the steady intervals, the run's wall
seconds), then the card's ``nvidia-smi`` name and power limit.  Each
run's whole output is kept in ``--out`` (default ``.smoke-phase-ab/``,
which git ignores).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

CODE = """
import chip_smoke as cs
cs.phase_build()
t = cs.phase_table("cuda", cpu_reference=False)
cs.phase_readers(t)
del t
cs.phase_tiers("cuda", cpu_reference=False)
"""


def run(tree: str, index: int, out_dir: str) -> dict:
    tree = os.path.abspath(tree)
    env = dict(os.environ, PYTHONPATH=tree)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CODE], cwd=tree, env=env,
                          capture_output=True, text=True)
    wall = time.perf_counter() - t0
    label = f"{index}-{os.path.basename(tree) or 'tree'}"
    with open(os.path.join(out_dir, f"{label}.log"), "w") as f:
        f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    res = {"run": index, "tree": tree, "rc": proc.returncode,
           "wall_s": wall}
    for line in proc.stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if obj.get("phase") == "multi_reader":
            res["readers"] = {
                n: {"samples_per_s": r["samples_per_s"],
                    "ingest_wall_s": r["ingest_wall_s"],
                    "locked_share": r["locked_share_of_ingest_wall"],
                    "ledger_balanced": r.get("ledger", {}).get(
                        "balanced")}
                for n, r in obj["runs"].items()}
        elif obj.get("phase") == "tiers_soak":
            res["soak"] = {
                "steady_samples_per_s": obj["steady_samples_per_s"],
                "intervals_samples_per_s": [
                    iv["samples_per_s"] for iv in obj["intervals"]],
                "gates_failed": [k for k, v in obj["gates"].items()
                                 if not v]}
        elif obj.get("phase") == "table_interval":
            res["table_samples_per_s"] = obj["samples_per_s"]
    if proc.returncode:
        res["stderr_tail"] = proc.stderr[-2000:]
    return res


def main(argv: list[str]) -> int:
    out_dir = ".smoke-phase-ab"
    if argv[:1] == ["--out"] and len(argv) > 1:
        out_dir, argv = argv[1], argv[2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    os.makedirs(out_dir, exist_ok=True)
    rc = 0
    for i, tree in enumerate(argv):
        res = run(tree, i, out_dir)
        rc = rc or res["rc"]
        print(json.dumps(res), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
