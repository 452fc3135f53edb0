"""Whole runs on the CPU at a small size: a sound run comes out
correct, and a run whose timed path is broken underneath comes out not
correct, for each fault a cell can have on one chip (a step that leaves
its state unchanged, half of each batch left out, an answer altered
where it is produced).  The runs skip the harness's look for a card."""

import time

import pytest

import run
from conftest import SMALL_TABLES, find_cell

SCALE = {"local.mixed": 400, "global.grpc64": 128}
SEED = 2 ** 31 + 4242


def small_cell(name, **server):
    cell = find_cell(name)
    cell.config["server"].update(SMALL_TABLES)
    cell.config["server"].update(server)
    return cell


def run_small(name, hooks=None, trace=False, **server):
    return run.run_cell(small_cell(name, **server), SEED, 0.3, trace, "cpu",
                        scale=SCALE[name], build_dir=None, hooks=hooks,
                        t_start=time.monotonic())


def unchanged_state(srv, sink):
    """The device step applies nothing: the table's planes keep their
    state."""
    srv.table._apply_work = lambda work: None


def half_batch(srv, sink):
    """Every other line of a DogStatsD batch, or every other import
    wire, is dropped; the rest is taken as usual and all acknowledged."""
    if srv.grpc_servers:
        from veneur_tpu_torch.forward import grpc_forward
        orig = grpc_forward.apply_decoded
        calls = [0]

        def apply(table, data, cols):
            calls[0] += 1
            if calls[0] % 2:
                return orig(table, data, cols)
            return int(cols["n"]), 0
        grpc_forward.apply_decoded = apply
        srv._portbench_restore = lambda: setattr(grpc_forward,
                                                 "apply_decoded", orig)
        return
    orig = srv.handle_packet_batch

    def handle(packets, drained=None, **kw):
        if drained is not None:
            lines = drained.split(b"\n")
            orig([], drained=b"\n".join(lines[::2]), **kw)
            return len(lines)
        return orig(packets, drained=drained, **kw)
    srv.handle_packet_batch = handle


def altered_answer(srv, sink):
    """The first value of every flush the sink receives is off by a
    quarter."""
    orig = sink.flush_frame

    def flush_frame(frame):
        b = frame.blocks[0]
        b.values[0] = b.values[0] * 1.25 + 1
        return orig(frame)
    sink.flush_frame = flush_frame


@pytest.mark.parametrize("name", sorted(SCALE))
def test_sound_run_is_correct(name):
    res = run_small(name)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("name", sorted(SCALE))
@pytest.mark.parametrize("fault", [unchanged_state, half_batch,
                                   altered_answer])
def test_broken_path_is_not_correct(name, fault):
    box = {}

    def hooks(srv, sink):
        box["srv"] = srv
        fault(srv, sink)
    try:
        # a small staging bound, so the device step runs mid-interval
        res = run_small(name, hooks=hooks, tpu_stage_flush_samples=1)
    finally:
        restore = getattr(box.get("srv"), "_portbench_restore", None)
        if restore:
            restore()
    assert not res["correct"], res["checks"]
