"""Each cell of ``BENCHMARK.json`` run on the card, a short window: it
must come out correct.
Run on a machine with a card: ``python -m pytest portbench/tests -m cuda``."""

import json
import os
import subprocess
import sys

import pytest

from conftest import bench_cells

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", bench_cells())
def test_cell_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, os.path.join(PB, "run.py"),
                        "--workload", name, "--seed", "31337",
                        "--seconds", "5", "--trace", "0"],
                       capture_output=True, text=True, timeout=1200,
                       cwd=os.path.dirname(PB))
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
