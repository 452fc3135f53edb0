"""Multi-reader fused ingest in the port (``ReaderShard``) against the
JAX package's and against the port's own single-reader and split paths.

Ports ``tests/test_multireader.py``: exact totals under real thread
concurrency, agreement of every ingest path on the same bytes, the
epoch fall-back when compaction renumbers rows, and lock-free probes
of the native index while it grows.  At a fixed commit order (shard i
takes buffer j when j % n == i, committed in buffer order) the port's
shard stages the same bits as the JAX table's ``ReaderShard``, the
port's ``ingest_buffer`` and its split parse + ``ingest_columns``.

Tolerances: none; every comparison is exact (integer counter values
keep float addition exact in any order).
"""

from __future__ import annotations

import ctypes
import sys
import threading

import numpy as np
import pytest

from veneur_tpu.core.table import MetricTable as JTable
from veneur_tpu.core.table import TableConfig as JConfig
from veneur_tpu_torch import native
from veneur_tpu_torch.core.table import MetricTable, TableConfig
from veneur_tpu_torch.protocol import columnar


def _chunk_lines(lines, per=512):
    return ["\n".join(lines[j:j + per]).encode()
            for j in range(0, len(lines), per)]


def _table(**kw):
    return MetricTable(TableConfig(**kw), device="cpu")


def _run_readers(table, streams):
    """One ReaderShard per stream on real threads against one shared
    lock: the server's locking discipline."""
    lock = threading.Lock()
    barrier = threading.Barrier(len(streams))
    errs = []
    totals = [0] * len(streams)

    def reader(idx, bufs):
        try:
            shard = table.make_reader_shard()
            barrier.wait()
            for buf in bufs:
                shard.parse(buf)
                with lock:
                    p, d, _others = shard.commit()
                shard.reset()
                totals[idx] += p - d
        except Exception as e:  # pragma: no cover - failure detail
            errs.append(e)

    threads = [threading.Thread(target=reader, args=(i, s))
               for i, s in enumerate(streams)]
    # a short switch interval interleaves the readers' Python often
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    return totals


def test_concurrent_counters_exact_totals():
    """8 reader threads, a short switch interval, a 20k-series counter
    stream: the index grows many times under lock-free probes, and the
    dense staging carries every increment exactly."""
    n_readers, per, card = 8, 15_000, 20_000
    kw = dict(counter_rows=1 << 16, histo_merge_samples=1 << 30)
    table = _table(**kw)
    streams = [_chunk_lines([f"mr.c.{(r * per + i) % card}:2|c"
                             for i in range(per)])
               for r in range(n_readers)]
    assert sum(_run_readers(table, streams)) == n_readers * per
    dense = table._counter_dense
    assert np.count_nonzero(dense) == card
    assert dense.sum() == 2 * n_readers * per
    assert np.all(dense[dense != 0] == 2 * (n_readers * per // card))
    serial = _table(**kw)
    for bufs in streams:
        for buf in bufs:
            serial.ingest_buffer(buf)
    np.testing.assert_array_equal(
        np.sort(dense[dense != 0]),
        np.sort(serial._counter_dense[serial._counter_dense != 0]))
    # every lock-free pass left the index
    assert native.load().vtpu_index_readers(table.key_index.handle) == 0


def test_concurrent_mixed_types_no_loss():
    """Histogram and set appends and gauge writes from 4 concurrent
    shards: exact staged counts, every gauge row one of the values sent
    for it."""
    n_readers, per = 4, 8_000
    table = _table(histo_merge_samples=1 << 30)
    streams = []
    for r in range(n_readers):
        lines = []
        for i in range(per):
            k = i % 4
            if k == 0:
                lines.append(f"mx.c.{i % 97}:1|c")
            elif k == 1:
                lines.append(f"mx.g.{i % 31}:{r + 1}|g")
            elif k == 2:
                lines.append(f"mx.t.{i % 53}:{(i % 700) / 7:.2f}|ms")
            else:
                lines.append(f"mx.u.{i % 7}:m{(r * per + i) % 900}|s")
        streams.append(_chunk_lines(lines))
    assert sum(_run_readers(table, streams)) == n_readers * per
    each = n_readers * (per // 4)
    assert table._counter_dense.sum() == each
    assert len(table._histo_stage) == each
    assert sum(len(r) for r in table._set_pos_rows) == each
    assert int(table._gauge_mask.sum()) == 31
    assert np.all(np.isin(table._gauge_dense[table._gauge_mask == 1],
                          np.arange(1, n_readers + 1)))
    assert table.staged() == n_readers * per


def _staged_state(table):
    """The table's staging as plain arrays (histogram and set columns
    in arrival order: every path appends in the same order here)."""
    histo = table._histo_stage.take()
    sets = ((np.concatenate(table._set_pos_rows),
             np.concatenate(table._set_pos))
            if table._set_pos_rows else (np.empty(0), np.empty(0)))
    return {
        "counter": np.asarray(table._counter_dense).copy(),
        "gauge": np.asarray(table._gauge_dense).copy(),
        "gauge_mask": np.asarray(table._gauge_mask).copy(),
        "histo": tuple(np.asarray(x) for x in histo),
        "sets": sets,
        "touched": [np.asarray(getattr(table, f"{c}_idx").touched).copy()
                    for c in ("counter", "gauge", "histo", "set")],
        "overflow": {c: getattr(table, f"{c}_idx").overflow
                     for c in ("counter", "gauge", "histo", "set")},
        "staged": table.staged(),
    }


def _agreement_lines(n=12_000, seed=77):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        k = i % 7
        if k == 0:
            lines.append(f"agr.c.{i % 211}:{1 + i % 7}|c")
        elif k == 1:
            lines.append(f"agr.g.{i % 19}:{i % 50}|g")
        elif k == 2:
            lines.append(
                f"agr.t.{i % 83}:{rng.uniform(1, 900):.2f}|ms|@0.5")
        elif k == 3:
            lines.append(f"agr.u.{i % 5}:m{i % 600}|s")
        elif k == 4:
            lines.append(f"agr.tc.{i % 37}:2|c|#env:prod,z:z{i % 3}")
        elif k == 5:
            lines.append(f"agr.h.{i % 29}:{i % 100}|h")
        else:  # events and service checks: the caller's per-line work
            lines.append("_sc|agr.up|0" if i % 2 else "_e{3,2}:abc|de")
    return lines


def _drive(kind, bufs, sizes, n_shards=4):
    """The same buffers through one ingest path of one package:
    ``port``/``jax`` shards (commits in buffer order, shard j % n),
    ``single`` (``ingest_buffer``) or ``split`` (columns, then
    ``ingest_columns``).  Returns (table, per-buffer results)."""
    out = []
    if kind in ("port", "single", "split"):
        t = _table(**sizes)
    else:
        t = JTable(JConfig(**sizes))
        assert t._lib is not None
    if kind in ("port", "jax"):
        shards = [t.make_reader_shard() for _ in range(n_shards)]
        for j, buf in enumerate(bufs):
            sh = shards[j % n_shards]
            sh.parse(buf)
            out.append(sh.commit())
            sh.reset()
    elif kind == "single":
        out = [t.ingest_buffer(buf) for buf in bufs]
    else:
        parser = columnar.ColumnarParser()
        out = [t.ingest_columns(parser.parse(buf, copy=False))
               for buf in bufs]
    return t, out


def test_shard_matches_jax_shard_ingest_buffer_and_split():
    """At a fixed commit order the port's shard stages the same bits
    as the JAX shard (with the same slow-line spans), the port's
    ``ingest_buffer`` and its split path: dense counters and gauges,
    histogram and set columns, touched rows, overflow, staged count.
    The counter pool is cut so that some series overflow."""
    bufs = _chunk_lines(_agreement_lines(), per=500)
    sizes = dict(counter_rows=200, histo_merge_samples=1 << 30)
    port, port_out = _drive("port", bufs, sizes)
    jax_t, jax_out = _drive("jax", bufs, sizes)
    assert port_out == jax_out
    single, single_out = _drive("single", bufs, sizes)
    assert port_out == single_out
    split, split_out = _drive("split", bufs, sizes)
    # the split path's counts leave out the caller's per-line kinds
    assert [o[:2] for o in port_out] == split_out
    a = _staged_state(port)
    assert sum(a["overflow"].values()) > 0
    for other in (jax_t, single, split):
        b = _staged_state(other)
        for k in ("counter", "gauge", "gauge_mask"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for x, y in zip(a["histo"], b["histo"]):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(a["sets"], b["sets"]):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(a["touched"], b["touched"]):
            np.testing.assert_array_equal(x, y)
        assert a["overflow"] == b["overflow"]
        assert a["staged"] == b["staged"]


def test_flush_agreement_across_paths():
    """The same stream through the port's shards, ``ingest_buffer``
    and split path and through the JAX shards, compared at the flush:
    counters, gauges and set estimates (swap + host estimates)."""
    lines = []
    for i in range(6_000):
        k = i % 3
        if k == 0:
            lines.append(f"fl.c.{i % 101}:3|c")
        elif k == 1:
            lines.append(f"fl.g.{i % 13}:{i % 40}|g")
        else:
            lines.append(f"fl.u.{i % 3}:m{i % 500}|s")
    bufs = _chunk_lines(lines, per=400)
    sizes = dict(histo_merge_samples=1 << 30)
    views = []
    for kind in ("port", "single", "split", "jax"):
        t, _ = _drive(kind, bufs, sizes, n_shards=3)
        snap = t.swap()
        counters = {m.name: float(np.asarray(snap.counters)[r])
                    for r, m in enumerate(snap.counter_meta)
                    if snap.counter_touched[r]}
        gauges = {m.name: float(np.asarray(snap.gauges)[r])
                  for r, m in enumerate(snap.gauge_meta)
                  if snap.gauge_touched[r]}
        ests = snap.host_set_estimates()
        sets = {m.name: float(ests[r])
                for r, m in enumerate(snap.set_meta)
                if snap.set_touched[r]}
        views.append((counters, gauges, sets))
    assert views[0] == views[1] == views[2] == views[3]


def test_epoch_fallback_exact():
    """A compaction between parse and commit renumbers rows: commit
    sees the epoch bump, discards the scratch and re-ingests the raw
    buffer, exactly once."""
    table = _table(histo_merge_samples=1 << 30)
    shard = table.make_reader_shard()
    buf = "\n".join(f"ep.c.{i % 50}:1|c" for i in range(1000)).encode()
    shard.parse(buf)
    table._reindex_epoch += 1  # as begin_swap's compaction does
    assert shard.commit() == (1000, 0, [])
    shard.reset()
    assert table._counter_dense.sum() == 1000
    # the scratch was discarded, not merged: a normal round balances
    shard.parse(buf)
    p, d, _ = shard.commit()
    shard.reset()
    assert (p, d) == (1000, 0)
    assert table._counter_dense.sum() == 2000


def test_compaction_under_live_readers_exact():
    """Readers parse without the lock while the main thread swaps
    intervals, each round on a fresh keyspace, so that begin_swap
    compacts: the native index is cleared and refilled under live
    probes, and the counter totals summed over every interval are
    exact.  A round ends once every reader has committed a buffer of
    that round's keyspace, so an interval holds at most two keyspaces
    (300 of the 512 counter rows) however late a reader runs: a wall
    clock pace let a reader descheduled across two swaps carry a third
    keyspace into one interval, and the next round overflowed the
    class."""
    n_readers, rounds, per, card = 3, 12, 400, 150
    table = _table(counter_rows=512, histo_merge_samples=1 << 30)
    lock = threading.Lock()
    stop = threading.Event()
    phase = [0]
    # the round of the last buffer each reader committed
    done = [-1] * n_readers
    progress = threading.Condition()
    sent = [0] * n_readers
    errs = []

    def reader(idx):
        try:
            shard = table.make_reader_shard()
            while not stop.is_set():
                ph = phase[0]
                buf = "\n".join(f"cmp.{ph * card + (idx * 7 + i) % card}:1|c"
                                for i in range(per)).encode()
                shard.parse(buf)
                with lock:
                    p, d, _ = shard.commit()
                shard.reset()
                assert d == 0
                sent[idx] += p
                with progress:
                    done[idx] = ph
                    progress.notify_all()
        except Exception as e:  # pragma: no cover - failure detail
            errs.append(e)
            with progress:
                progress.notify_all()

    def flushed_total():
        with lock:
            snap = table.swap()
        return float(np.asarray(snap.counters)[snap.counter_touched].sum())

    threads = [threading.Thread(target=reader, args=(i,))
               for i in range(n_readers)]
    for t in threads:
        t.start()
    flushed = 0.0
    try:
        for r in range(rounds):
            phase[0] = r
            with progress:
                assert progress.wait_for(
                    lambda: errs or min(done) >= r, timeout=60)
            assert not errs, errs
            flushed += flushed_total()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    flushed += flushed_total()
    assert table._reindex_epoch >= 3  # compactions happened
    assert flushed == sum(sent)
    assert native.load().vtpu_index_readers(table.key_index.handle) == 0


def test_index_probe_during_growth_stress():
    """The port's native index: one writer inserting (growing it
    several times over) while probe threads read without a lock.
    Probes never see a wrong row for a settled key, and the retired
    inner tables drain."""
    lib = native.load()
    h = lib.vtpu_index_new(1024)
    n_keys = 60_000
    keys = np.arange(1, n_keys + 1, dtype=np.uint64) * 2654435761
    stop = threading.Event()
    errs = []

    def prober():
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        out = np.empty(n_keys, np.int32)
        try:
            while not stop.is_set():
                lib.vtpu_index_lookup(h, keys.ctypes.data_as(u64p),
                                      n_keys, out.ctypes.data_as(i32p))
                hit = out >= 0
                rows = np.nonzero(hit)[0]
                if len(rows) and not np.array_equal(
                        out[hit], rows.astype(np.int32) % (1 << 20)):
                    errs.append(out[hit][:5])
                    return
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=prober) for _ in range(4)]
    for t in threads:
        t.start()
    for i, k in enumerate(keys.tolist()):
        lib.vtpu_index_insert(h, k, i % (1 << 20))
    stop.set()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs[:3]
    assert lib.vtpu_index_count(h) == n_keys
    assert lib.vtpu_index_readers(h) == 0
    # quiescent: one more serialized mutation sweeps the retirees
    lib.vtpu_index_insert(h, np.uint64(2**63 + 11), 7)
    lib.vtpu_index_free(h)


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_shard_slow_lines_index_the_parsed_buffer(kind):
    """Event, service-check and malformed lines come back from commit
    as spans of the buffer given to parse, in both packages."""
    buf = b"a:1|c\n_sc|up|0\nnot a metric\n_e{1,1}:a|b\nb:2|g"
    t, out = _drive(kind, [buf], dict(histo_merge_samples=1 << 30), 1)
    (p, d, others), = out
    assert (p, d) == (2, 0)
    assert [buf[o:o + n] for o, n, _k in others] == [
        b"_sc|up|0", b"not a metric", b"_e{1,1}:a|b"]
