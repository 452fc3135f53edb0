"""The port's collectives across two processes, over gloo on the CPU.

Twins of ``tests/test_distributed_fold.py`` and the two-process test of
``tests/test_collective_forward.py``.  Each test spawns two port
processes that join one ``torch.distributed`` job through
``init_process_mesh`` (``VENEUR_TPU_DIST_*``, gloo for the CPU), two
CPU places each:

- the collective import fold's union over the process group,
  bit-equal to the serial per-wire oracle in the spread regime;
- the plane exchange (``all_to_all_single``): the receiving process
  folds what lands, bit-equal to the gRPC wire oracle;
- the mesh global's flush merge with its partials split over the two
  processes, bit-equal to the same partials merged in one process.

Each pair runs under its own hard timeout.  NCCL refuses two ranks on
one card, so this is where multi-rank parity is shown.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import pytest
import torch.distributed as dist

TIMEOUT_S = 120

_COMMON = r"""
import os, sys
import numpy as np
import torch
pid = int(sys.argv[1])
os.environ["VENEUR_TPU_DIST_COORDINATOR"] = f"127.0.0.1:{sys.argv[2]}"
os.environ["VENEUR_TPU_DIST_NUM_PROCS"] = "2"
os.environ["VENEUR_TPU_DIST_PROCESS_ID"] = str(pid)
from veneur_tpu_torch.parallel import sharded
assert sharded.init_process_mesh(device="cpu", timeout=60)
import torch.distributed as dist
assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
"""

_FOLD = _COMMON + r"""
from veneur_tpu_torch.ops import tdigest
mesh = sharded.make_import_mesh(["cpu", "cpu"])
assert sharded.mesh_process_count(mesh) == 2
fold = sharded.CollectiveWireFold(mesh)
assert fold.n_shard == 4 and fold.n_proc == 2
# spread-regime wires: every process builds the whole global stack
# (for the oracle) and passes only its process-major slice
R = 6
C = tdigest.capacity_for(fold.compression)
W_LOCAL = fold.pad_wires(3)
W = W_LOCAL * 2
stack_m = np.zeros((W, R, C), np.float32)
stack_w = np.zeros((W, R, C), np.float32)
live = np.ones(W, bool)
live[W_LOCAL - 1] = False  # a dead wire in process 0's slice
for w in range(W):
    for r in range(R):
        stack_m[w, r, :3] = (1e4 * (w * R + r) + np.array(
            [11.0, 23.0, 37.0], np.float32) + 3e3 * np.arange(3))
        stack_w[w, r, :3] = 1.0
means = np.zeros((R + 2, C), np.float32)
weights = np.zeros((R + 2, C), np.float32)
means[:R, :2] = -1e7 + 1e5 * np.arange(R)[:, None] + np.array(
    [0.0, 5e4], np.float32)
weights[:R, :2] = 1.0
row_idx = torch.arange(R)
lo = pid * W_LOCAL
out_m, out_w = fold(torch.from_numpy(means), torch.from_numpy(weights),
                    row_idx, stack_m[lo:lo + W_LOCAL],
                    stack_w[lo:lo + W_LOCAL], live[lo:lo + W_LOCAL])
# the serial oracle: every live global wire in order, one merge each
om, ow = torch.from_numpy(means[:R]), torch.from_numpy(weights[:R])
for w in range(W):
    if live[w]:
        om, ow = tdigest._merge_impl(om, ow, torch.from_numpy(stack_m[w]),
                                     torch.from_numpy(stack_w[w]),
                                     fold.compression)
assert torch.equal(out_m[:R], om), "means diverged from the serial scan"
assert torch.equal(out_w[:R], ow), "weights diverged"
assert torch.equal(out_m[R:], torch.from_numpy(means[R:]))
assert float(out_w.sum()) == float(weights.sum() +
                                   stack_w[live].sum())
dist.destroy_process_group()
print(f"PARITY-OK {pid}", flush=True)
"""

_EXCHANGE = _COMMON + r"""
sys.path.insert(0, sys.argv[3])
from test_torch_collective_forward import mixed_rows, _staged
from veneur_tpu_torch.core.table import MetricTable, TableConfig
from veneur_tpu_torch.forward.collective import CollectiveTransport
from veneur_tpu_torch.forward.grpc_forward import (
    apply_metric_list_bytes, rows_to_metric_list)
from veneur_tpu_torch.parallel import collective_forward as cplanes
schema = cplanes.PlaneSchema(compression=100.0, max_rows=64,
                             key_bytes=128)
rows = mixed_rows()
if pid == 0:
    # the local: pack and exchange to process 1
    tr = CollectiveTransport(schema, peers={"g:1": 1}, deadline=60.0)
    sent, rejected, landed = tr.send_cycle({"g:1": rows})
    assert sent == {"g:1": len(rows)} and not rejected
    assert not landed.any()  # nothing addressed back
    assert tr._exchange.n_proc == 2  # the group's all_to_all_single
    tr.stop()
else:
    # the global: rendezvous empty, fold what lands, hold it to the
    # gRPC wire oracle on the same rows
    tr = CollectiveTransport(schema, n_slots=2, deadline=60.0)
    landed = tr.exchange_empty(timeout=60.0)
    assert cplanes.block_counts(landed[0]) == (24, 12, 8, 4)
    assert not landed[1].any()
    t1 = MetricTable(TableConfig(), device="cpu")
    assert cplanes.fold_block(t1, landed[0], schema) == (len(rows), 0)
    t2 = MetricTable(TableConfig(), device="cpu")
    data = rows_to_metric_list(rows, 100.0).SerializeToString()
    assert apply_metric_list_bytes(t2, data) == (len(rows), 0)
    a, b = _staged(t1), _staged(t2)
    assert np.array_equal(a["counter"], b["counter"])
    assert np.array_equal(a["gauge"], b["gauge"])
    assert np.array_equal(a["set"], b["set"])
    for x, y in zip(a["stats"], b["stats"]):
        assert np.array_equal(x, y)
    assert len(a["digest"]) == len(b["digest"])
    for x, y in zip(a["digest"], b["digest"]):
        for ax, ay in zip(x, y):
            assert np.array_equal(ax, ay)
    tr.stop()
dist.destroy_process_group()
print(f"PARITY-OK {pid}", flush=True)
"""

_MERGE = _COMMON + r"""
from veneur_tpu_torch.utils import hashing
cfg = sharded.ShardedConfig(rows=16, set_rows=4, slots=16, batch=64)
two = sharded.ShardedAggregator(sharded.make_mesh(["cpu"] * 4), cfg)
assert two.mesh.shape == {"shard": 4, "series": 2}
assert two.mesh.n_local_shard == 2
# the in-process oracle: the same 4 x 2 grid in this process alone
one = sharded.ShardedAggregator(sharded.Mesh(["cpu"] * 8, 4, 2), cfg)
rng = np.random.default_rng(5)
for shard in range(4):
    rows = rng.integers(0, 16, 40, dtype=np.int32)
    vals = rng.gamma(2.0, 3.0, 40).astype(np.float32)
    idx, rank = hashing.hash_members([f"m{shard}-{i}".encode()
                                      for i in range(30)])
    cols = dict(counter_rows=rows, counter_vals=vals,
                counter_wts=np.ones(40, np.float32), histo_rows=rows,
                histo_vals=vals, histo_wts=np.ones(40, np.float32),
                set_rows=rows[:30] % 4, set_idx=idx.astype(np.int32),
                set_rank=rank.astype(np.int32))
    gcols = dict(gauge_rows=rows[:6], gauge_vals=vals[:6],
                 gauge_ticket=np.arange(6, dtype=np.int32) + 6 * shard)
    one.stage(shard, **cols)
    one.stage(shard, **gcols)
    if shard // 2 == pid:  # this process holds shards 2*pid, 2*pid+1
        two.stage(shard % 2, **cols)
        two.stage(shard % 2, **gcols)
one.step()
two.step()
a, b = two.flush(), one.flush()
for k in ("counters", "gauges", "histo_stats", "histo_means",
          "histo_weights", "hll", "quantiles"):
    assert torch.equal(a[k].nan_to_num(), b[k].nan_to_num()), k
dist.destroy_process_group()
print(f"PARITY-OK {pid}", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_pair(script: str) -> None:
    if not dist.is_gloo_available():
        pytest.skip("torch.distributed has no gloo backend")
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    env = dict(os.environ, PYTHONPATH=root)
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(i), port, here],
        env=env, cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i}:\n{out[-4000:]}"
        assert f"PARITY-OK {i}" in out


def test_two_process_fold_bit_parity_vs_serial_scan():
    _run_pair(_FOLD)


def test_two_process_plane_exchange_vs_wire_oracle():
    _run_pair(_EXCHANGE)


def test_two_process_mesh_merge_equals_one_process():
    _run_pair(_MERGE)


def test_init_process_mesh_reads_the_env_and_refuses_bad_values(
        monkeypatch):
    """No coordinator: single-process mode (False), as the reference;
    a coordinator without a process count or with an id out of range
    raises before any socket opens."""
    from veneur_tpu_torch.parallel import sharded
    for key in ("VENEUR_TPU_DIST_COORDINATOR", "VENEUR_TPU_DIST_NUM_PROCS",
                "VENEUR_TPU_DIST_PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    assert sharded.init_process_mesh(device="cpu") is False
    assert sharded.process_device() is None
    monkeypatch.setenv("VENEUR_TPU_DIST_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(ValueError, match="process count"):
        sharded.init_process_mesh(device="cpu")
    monkeypatch.setenv("VENEUR_TPU_DIST_NUM_PROCS", "2")
    monkeypatch.setenv("VENEUR_TPU_DIST_PROCESS_ID", "2")
    with pytest.raises(ValueError, match="process count"):
        sharded.init_process_mesh(device="cpu")
    assert not dist.is_initialized()
