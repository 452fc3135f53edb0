"""Run one cell of the benchmark of ``veneur_tpu_torch`` once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up makes the cell's inputs from the seed, starts the port's server
on ``cuda:0`` (its nvcc and g++ builds in ``portbench/_cache/build``)
and takes two whole intervals and their flushes.  The window then runs
whole intervals for ``--seconds``; with ``--trace 1`` under
``torch.profiler``.  After it, the plain reference (``reference/``)
checks the flushes kept from the window.  The last line of standard
output is the result, one JSON object; the numbers compared go last,
each beside its limit, there and on standard error.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "veneur_tpu")


def forbidden_modules(modules) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is
    the JAX stack's or the JAX package's."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def cache_env() -> None:
    """Every build and kernel cache inside the checkout, at fixed
    paths, so only a checkout's first run builds."""
    cache = os.path.join(HERE, "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             build_dir: str | None, scale: int = 1, hooks=None,
             t_start: float | None = None) -> dict:
    """One run of ``cell``; returns the result object.  ``build_dir``
    holds the program's builds (None: the package's own); ``scale`` and
    ``hooks`` serve the benchmark's own tests."""
    from pbench import results
    from pbench.spec import driver
    out = driver(cell.traffic["kind"]).run(
        cell, seed, seconds, trace, device,
        T_START if t_start is None else t_start, scale=scale,
        build_dir=build_dir, hooks=hooks)
    return results.result(cell, out, seed, scale, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cache_env()
    from pbench.spec import load_cell
    cell = load_cell(a.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell asks for {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    from pbench.harness import BUILD_DIR
    res = run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda:0",
                   BUILD_DIR)
    bad = forbidden_modules(list(sys.modules))
    if bad:
        print("portbench: the run loaded " + ", ".join(bad),
              file=sys.stderr)
        return 3
    for name, (v, lim) in res["checks"].items():
        print(f"check {name}: {v} (limit {lim})", file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
