"""Count the slots whose t-digest cluster id differs from the XLA
merge's, for the port's k and for the Pallas kernel's, over the
generators ``chip_smoke.py`` phase 2 runs (its five cases from
``default_rng(7)``, in order), four weighted (forwarded-wire) cases
and compression 2500's (C = 15,112) unit batch, where the reference
has no Pallas kernel (its count is null) and the XLA k's own flips
against the same k in float64 stand beside the port's.

    JAX_PLATFORMS=cpu python tests/ulp_flip_counts.py

Runs on the CPU; prints one JSON line a case:
``{"case", "rows", "k", "live_slots", "port_vs_xla", "pallas_vs_xla",
"port_vs_f64", "xla_vs_f64"}``.
The ids are ``floor(k)`` of each live slot of the sorted union under one
shared order and q (``test_torch_kernels._flip_counts``); the test
``test_port_flips_no_more_clusters_than_the_pallas_kernel`` holds the
ids to the clusters each merge writes.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import chip_smoke  # noqa: E402
from test_torch_kernels import _flip_counts  # noqa: E402
from veneur_tpu_torch.ops import tdigest  # noqa: E402


def main() -> None:
    cap = tdigest.capacity_for(100.0)
    cases = []
    rng = np.random.default_rng(7)
    for label, rows, k, sorted_state, weighted in chip_smoke.KERNEL_CASES:
        case = list(chip_smoke.random_case(rng, rows, cap, k, weighted))
        if not sorted_state:
            perm = np.argsort(rng.random((rows, cap)), axis=1)
            case[0] = np.take_along_axis(case[0], perm, 1)
            case[1] = np.take_along_axis(case[1], perm, 1)
        if label.endswith("_subnormal"):
            case = chip_smoke.with_subnormals(case)
        cases.append((label, rows, k, case, 100.0))
    for seed, rows, k in ((2, 6144, 48), (0, 6144, 48), (0, 16384, 512),
                          (0, 4096, 8)):
        cases.append((f"weighted_rng{seed}", rows, k, chip_smoke.random_case(
            np.random.default_rng(seed), rows, cap, k, weighted=True), 100.0))
    c2500 = tdigest.capacity_for(2500.0)
    cases.append(("c2500_unit_rng7", 1024, 512, chip_smoke.random_case(
        np.random.default_rng(7), 1024, c2500, 512), 2500.0))
    for label, rows, k, case, comp in cases:
        ww, (it, ix, ip, ie), _ = _flip_counts(case, comp)
        live = ww > 0
        print(json.dumps({
            "case": label, "rows": rows, "k": k,
            "live_slots": int(live.sum()),
            "port_vs_xla": int(((it != ix) & live).sum()),
            "pallas_vs_xla": (None if ip is None else
                              int(((ip != ix) & live).sum())),
            "port_vs_f64": int(((it != ie) & live).sum()),
            "xla_vs_f64": int(((ix != ie) & live).sum())}), flush=True)


if __name__ == "__main__":
    main()
