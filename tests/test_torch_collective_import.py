"""The port's collective import fold against the reference's.

Twins of ``tests/test_collective_import.py``.  The fold
(``parallel.sharded.CollectiveWireFold``) splits a cycle's wire stack
over the import mesh's places, folds per-place partials and unions
them with one slot gather + a single k-scale re-cluster into the table
rows.  In the SPREAD regime (every centroid more than one k-width from
its neighbours, totals under capacity) no topology clusters anything,
so the port's fold must be bit-equal to its serial scan AND to the JAX
``CollectiveWireFold`` on conftest's 8-device mesh, at every place
count; on dense digests mass is conserved exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from veneur_tpu.core.table import MetricTable as JTable
from veneur_tpu.core.table import TableConfig as JTableConfig
from veneur_tpu.core.table import _collective_import_mode as jmode
from veneur_tpu.parallel import sharded as jsharded
from veneur_tpu_torch.core.table import (MetricTable, TableConfig,
                                         _collective_import_mode)
from veneur_tpu_torch.ops import hll
from veneur_tpu_torch.parallel import sharded


def test_gate_env_matrix(monkeypatch):
    cases = {"": "auto", "auto": "auto", "1": "on", "on": "on",
             "true": "on", "yes": "on", "0": "off", "off": "off",
             "false": "off", "no": "off", "other": "auto"}
    for raw, want in cases.items():
        monkeypatch.setenv("VENEUR_TPU_COLLECTIVE_IMPORT", raw)
        assert _collective_import_mode() == jmode() == want, raw


def test_gate_defers_to_config_when_env_unset(monkeypatch):
    monkeypatch.delenv("VENEUR_TPU_COLLECTIVE_IMPORT", raising=False)
    for cfg in ("off", "on", "auto"):
        assert _collective_import_mode(cfg) == jmode(cfg) == cfg
    monkeypatch.setenv("VENEUR_TPU_COLLECTIVE_IMPORT", "off")
    assert _collective_import_mode("on") == "off"  # env wins


def test_auto_engages_iff_more_than_one_place(monkeypatch):
    monkeypatch.delenv("VENEUR_TPU_COLLECTIVE_IMPORT", raising=False)
    t = MetricTable(TableConfig(), device="cpu", places=["cpu"] * 8)
    assert t.collective_import_mode == "auto"
    fold = t._collective_wire_fold()
    assert fold is not None and fold.n_shard == 8
    assert t._collective_wire_fold() is fold  # resolved once
    # the CPU's visible devices are one place: auto keeps the scan
    assert MetricTable(TableConfig(),
                       device="cpu")._collective_wire_fold() is None
    assert MetricTable(TableConfig(), device="cpu",
                       places=["cpu"])._collective_wire_fold() is None


def test_off_and_on_force(monkeypatch):
    monkeypatch.setenv("VENEUR_TPU_COLLECTIVE_IMPORT", "off")
    assert MetricTable(TableConfig(), device="cpu", places=["cpu"] * 8
                       )._collective_wire_fold() is None
    monkeypatch.setenv("VENEUR_TPU_COLLECTIVE_IMPORT", "on")
    fold = MetricTable(TableConfig(), device="cpu")._collective_wire_fold()
    assert fold is not None and fold.n_shard == 1


def test_pad_wires_multiple_of_places():
    for n_places in (1, 3, 8):
        fold = sharded.CollectiveWireFold(
            sharded.make_import_mesh(["cpu"] * n_places))
        s = fold.n_shard
        assert fold.n_proc == 1
        for n in (0, 1, s - 1, s, s + 1, 3 * s):
            p = fold.pad_wires(n)
            assert p >= max(n, 1) and p % s == 0 and p - max(n, 1) < s
    jfold = jsharded.CollectiveWireFold(jsharded.make_import_mesh())
    fold = sharded.CollectiveWireFold(sharded.make_import_mesh(["cpu"] * 8))
    for n in range(0, 20):
        assert fold.pad_wires(n) == jfold.pad_wires(n)


def _spread_wires(n_wires=6, n_series=5, per_wire=3):
    """Wire parts whose centroids stay >1 k-width apart and far under
    capacity, so no merge topology clusters."""
    wires = []
    for w in range(n_wires):
        rows, means, wts = [], [], []
        for s in range(n_series):
            for j in range(per_wire):
                rows.append(s)
                means.append(1e4 * (w * n_series * per_wire
                                    + s * per_wire + j) + 17.0)
                wts.append(1.0)
        wires.append((np.asarray(rows, np.int32),
                      np.asarray(means, np.float32),
                      np.asarray(wts, np.float32)))
    return wires


def _dense_wires(seed=11):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 5, 160).astype(np.int32),
             rng.gamma(3.0, 10.0, 160).astype(np.float32),
             rng.integers(1, 9, 160).astype(np.float32))
            for _ in range(6)]


def _stage(t, wires, seed=3):
    """The same import cycle into either package's table; the
    non-histo classes ride along and must be left as the scan leaves
    them."""
    rng = np.random.default_rng(seed)
    srows = np.arange(max(int(r.max()) + 1 for r, _, _ in wires),
                      dtype=np.int32)
    names = np.asarray([t.import_histo_row(f"lat{s}", "timer", ())
                        for s in srows], np.int32)
    for rows, means, wts in wires:
        stats = np.tile(np.asarray([1.0, 2.0, 3.0, 0.0, 3.0],
                                   np.float32), (len(srows), 1))
        t.import_histo_batch(names, stats, names[rows], means, wts)
        t.import_counter_batch(
            np.asarray([t.import_counter_row("hits", ())], np.int32),
            np.asarray([2.0]))
        t.import_gauge_batch(
            np.asarray([t.import_gauge_row("temp", ())], np.int32),
            np.asarray([41.5]))
        t.import_set_at(t.import_set_row("users", ()),
                        rng.integers(0, 32, hll.M).astype(np.uint8))
    t.device_step(final=True)
    return t


def _port(collective, wires, places):
    t = MetricTable(TableConfig(), device="cpu", places=places)
    t.fused_import_mode = "stack"
    t.collective_import_mode = collective
    return _stage(t, wires)


def _jax(collective, wires):
    t = JTable(JTableConfig())
    t.fused_import_mode = "stack"
    t.collective_import_mode = collective
    return _stage(t, wires)


def _planes(t) -> dict:
    st = t._state
    out = {k: getattr(st, k).numpy() for k in (
        "histo_means", "histo_weights", "counters", "gauges")}
    out["hll"] = (st.hll_regs.numpy() if st.hll_regs is not None
                  else None)
    return out


@pytest.mark.parametrize("n_places", [1, 2, 4, 8])
def test_spread_regime_bit_equal_to_serial_and_jax(n_places):
    """Parity across place counts: in the spread regime the port's fold
    at 1, 2, 4 and 8 places equals its serial scan and the reference's
    8-device fold bit for bit; the other classes are untouched."""
    wires = _spread_wires()
    coll = _port("on", wires, ["cpu"] * n_places)
    serial = _port("off", wires, ["cpu"] * n_places)
    assert coll._collective_fold.n_shard == n_places
    assert coll.routes.get("wire_collective") == 1
    assert "wire_collective" not in serial.routes
    jcoll = _jax("on", wires)
    assert jcoll._collective_fold.n_shard == 8
    a, b = _planes(coll), _planes(serial)
    for k in a:
        assert (a[k] is None and b[k] is None) or np.array_equal(
            a[k], b[k]), k
    for k in ("histo_means", "histo_weights", "counters", "gauges"):
        assert np.array_equal(a[k], np.asarray(getattr(jcoll, k))), k


def test_mass_conserved_on_dense_digests():
    """Dense digests DO cluster, so bits may differ between topologies;
    integer-weight mass is conserved exactly and the centroid span
    agrees, in the port and against the reference's fold."""
    wires = _dense_wires()
    coll = _planes(_port("on", wires, ["cpu"] * 8))
    serial = _planes(_port("off", wires, ["cpu"] * 8))
    jcoll = _jax("on", wires)
    jw = np.asarray(jcoll.histo_weights)
    assert float(coll["histo_weights"].sum()) == float(
        serial["histo_weights"].sum()) == float(jw.sum()) > 0
    for row in range(5):
        c_live = coll["histo_weights"][row] > 0
        s_live = serial["histo_weights"][row] > 0
        assert coll["histo_means"][row][c_live].min() == \
            serial["histo_means"][row][s_live].min()
        assert coll["histo_means"][row][c_live].max() == \
            serial["histo_means"][row][s_live].max()


def test_dead_wire_steps_keep_their_partials():
    """A wire step where some places' wires are padding (dead) merges
    only the live places' rows: 5 live wires over 4 places pad to 8,
    and the result still equals the serial scan bit for bit."""
    wires = _spread_wires(n_wires=5)
    coll = _port("on", wires, ["cpu"] * 4)
    serial = _port("off", wires, ["cpu"] * 4)
    for k in ("histo_means", "histo_weights"):
        assert np.array_equal(getattr(coll._state, k).numpy(),
                              getattr(serial._state, k).numpy())


def test_fold_refuses_a_stack_that_does_not_split():
    fold = sharded.CollectiveWireFold(sharded.make_import_mesh(["cpu"] * 4))
    z = torch.zeros((2, 616))
    with pytest.raises(ValueError, match="pad_wires"):
        fold(z, z, torch.arange(2), np.zeros((3, 2, 8), np.float32),
             np.zeros((3, 2, 8), np.float32), np.ones(3, bool))
