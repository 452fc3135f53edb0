#!/usr/bin/env python3
"""Drive the PyTorch port (``veneur_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, one JSON line each:

0. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
1. build: the cluster merge kernel from ``veneur_tpu_torch/csrc``;
2. kernel vs plain: ``cluster_merge`` against ``cluster_merge_plain``
   at R = 16384, C = 616, K = 512 (ingest) and K = 616 (union):
   mass, packing contract, quantiles; times with CUDA events;
3. ``entry("cuda")`` against ``entry("cpu")`` on the same arrays;
4. the main path: a ``MetricTable`` at the server's default sizes
   (16384 counter / gauge / histo rows, 1024 set rows) takes two
   intervals of 16k counter series, 16k gauge series, 10k timer series
   carrying 10M samples and 1024 set series x 1000 members through
   ``ingest_columns``, ``device_step`` and ``swap`` + ``Flusher.flush``;
   the flush is held against a CPU table's on the same batches, the
   percentiles against exact ones, and the kernel launch count is read;
   a third interval runs under torch.profiler for the device's busy
   share and its kernel times;
5. the server: ``python -m veneur_tpu_torch.cli.main`` on the card,
   fed over loopback UDP, its flush file checked;
6. the kernels line, then the last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero before the last
line.  Without CUDA, or without the package beside it, it exits 2 and
prints no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, f32 non-tensor rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

QS = (0.1, 0.5, 0.9, 0.99)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median ms of ``fn`` over ``runs`` CUDA-event-timed calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


# ---- phase 2: kernel vs plain -------------------------------------------

def random_case(rng, rows, cap, slots):
    """The reference's tests/test_pallas_merge.py generator: mean-sorted
    state rows up to half full, a batch with 80% live slots."""
    occ = rng.integers(0, cap // 2, size=rows)
    live = np.arange(cap)[None, :] < occ[:, None]
    means = np.sort(np.where(live, rng.normal(200.0, 40.0, (rows, cap)),
                             np.inf), axis=1)
    means = np.where(live, means, 0.0).astype(np.float32)
    weights = np.where(live, rng.integers(1, 50, (rows, cap)),
                       0).astype(np.float32)
    bm = rng.normal(200.0, 40.0, (rows, slots)).astype(np.float32)
    bw = (rng.random((rows, slots)) < 0.8).astype(np.float32)
    bm = np.where(bw > 0, bm, 0.0).astype(np.float32)
    return means, weights, bm, bw


def packing_ok(m, w) -> bool:
    import torch
    occ = w > 0
    n = occ.sum(dim=1, keepdim=True)
    slot = torch.arange(w.shape[1], device=w.device)[None, :]
    contiguous = bool(((slot < n) == occ).all())
    zeros = bool((m[~occ] == 0).all())
    big = torch.where(occ, m, torch.full_like(m, math.inf))
    sorted_ = bool((big[:, 1:] >= big[:, :-1]).all())
    return contiguous and zeros and sorted_


def merge_bound_ms(rows: int, cap: int, k: int) -> tuple[float, str]:
    """Least time for one merge: read 2 R (C+K) f32, write 2 R C f32;
    operations: a comparison sort of n = pow2(C+K) keys per row
    (n log2 n) plus ~30 f32 operations per slot for the k-scale and
    the cluster sums."""
    nbytes = 2 * rows * (cap + k) * 4 + 2 * rows * cap * 4
    n = 1 << (cap + k - 1).bit_length()
    ops = rows * (n * math.log2(n) + 30 * (cap + k))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def phase_kernel(dev: str = "cuda", rows: int = 16384) -> dict:
    import torch
    from veneur_tpu_torch.ops import cluster_merge as cm
    from veneur_tpu_torch.ops import tdigest
    cap = tdigest.DEFAULT_CAPACITY
    kw = dict(delta=tdigest._SCALE_MULT * 100.0,
              tail_coeff=tdigest._TAIL_MULT * 100.0,
              tail_q0=tdigest._TAIL_Q0, tail_qmin=tdigest._TAIL_QMIN)
    rng = np.random.default_rng(7)
    qs = torch.tensor(QS, dtype=torch.float32, device=dev)
    out = {}
    for k in (512, 616):
        a = [torch.from_numpy(x).to(dev)
             for x in random_case(rng, rows, cap, k)]
        km, kwt = cm.cluster_merge(*a, **kw)
        pm, pwt = cm.cluster_merge_plain(*a, **kw)
        torch.cuda.synchronize()
        total = (a[1].double().sum(1) + a[3].double().sum(1))
        mass_k = float(((kwt.double().sum(1) - total).abs() /
                        total.clamp(min=1e-30)).max())
        mass_p = float(((pwt.double().sum(1) - total).abs() /
                        total.clamp(min=1e-30)).max())
        check(mass_k <= 1e-6, f"K={k}: kernel mass rel err {mass_k}")
        check(mass_p <= 1e-6, f"K={k}: plain mass rel err {mass_p}")
        check(packing_ok(km, kwt), f"K={k}: kernel packing contract")
        check(packing_ok(pm, pwt), f"K={k}: plain packing contract")
        qk = tdigest.quantile(km, kwt, qs)
        qp = tdigest.quantile(pm, pwt, qs)
        viol = float(((qk - qp).abs() - (1e-3 + 2e-3 * qp.abs())).max())
        check(viol <= 0, f"K={k}: quantiles outside rtol 2e-3/atol "
                         f"1e-3 (excess {viol})")
        max_abs = float((qk - qp).abs().max())
        ms = cuda_ms(lambda: cm.cluster_merge(*a, **kw))
        plain_ms = cuda_ms(lambda: cm.cluster_merge_plain(*a, **kw))
        n = 1 << (cap + k - 1).bit_length()
        keys = torch.where(a[1] > 0, a[0], torch.full_like(a[0], math.inf))
        keys = torch.cat([keys, torch.full((rows, n - cap), math.inf,
                                           device=dev)], dim=1)
        sort_ms = cuda_ms(lambda: torch.sort(keys, dim=1))
        bound, by = merge_bound_ms(rows, cap, k)
        res = {"phase": "kernel_vs_plain", "rows": rows, "cap": cap,
               "k": k, "n": n, "mass_rel_err_kernel": mass_k,
               "mass_rel_err_plain": mass_p,
               "quantile_max_abs_err": max_abs, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
               "torch_sort_ms": sort_ms, "library_ms": None,
               "library_note": "no single PyTorch call computes the "
                               "whole merge; torch_sort_ms is the sort "
                               "of the same (R, n) keys, for context"}
        emit(res)
        out[k] = res
        del a, km, kwt, pm, pwt, keys
    return out


# ---- phase 3: entry() ----------------------------------------------------

def phase_entry(dev: str = "cuda") -> dict:
    import torch
    from veneur_tpu_torch.entry import entry
    cs, ca = entry(dev)
    hs, ha = entry("cpu")
    for x, y in zip(ca, ha):
        check(torch.equal(x.cpu(), y), "entry args differ")
    c = [x.cpu() for x in cs(*ca)]
    h = hs(*ha)
    counters, stats, means, weights, regs, quant, est = range(7)
    check(torch.equal(c[counters], h[counters]), "counters not bit-equal")
    check(torch.equal(c[regs], h[regs]), "HLL registers not bit-equal")
    check(torch.equal(c[stats][:, 1:3], h[stats][:, 1:3]),
          "stats min/max not bit-equal")
    mass = float(((c[weights].sum(1) - h[weights].sum(1)).abs() /
                  h[weights].sum(1).clamp(min=1e-30)).max())
    check(mass <= 1e-6, f"digest mass rel err {mass}")
    qc, qh = c[quant], h[quant]
    both = ~torch.isnan(qh)
    check(torch.equal(torch.isnan(qc), torch.isnan(qh)), "NaN rows differ")
    qerr = float(((qc - qh).abs() - (1e-3 + 2e-3 * qh.abs()))[both].max())
    check(qerr <= 0, f"quantiles outside tolerance (excess {qerr})")
    ediff = (c[est] - h[est]).abs()
    check(bool((ediff <= 1e-6 * h[est].abs()).all()),
          f"estimates outside rtol 1e-6: {float(ediff.max())}")
    eerr = float((ediff / h[est].abs().clamp(min=1.0)).max())
    res = {"phase": "entry", "counters_equal": True, "regs_equal": True,
           "mass_rel_err": mass,
           "quantile_max_abs_err": float((qc - qh).abs()[both].max()),
           "estimate_rel_err": eerr}
    emit(res)
    return res


# ---- phase 4: the table interval -----------------------------------------

N_COUNTER, N_GAUGE, N_TIMER, N_SET = 16000, 16000, 10000, 1024
COUNTER_SAMPLES = 1_000_000
GAUGE_SAMPLES = 1_000_000
TIMER_SAMPLES = 10_000_000
SET_MEMBERS = 1000
CHUNK = 1 << 20


def build_traffic(seed: int = 0, scale: int = 1):
    """One interval's traffic as ParsedBatch columns (numpy, seeded):
    counters, gauges, timers (10k series x 10M gamma(2, 30) samples,
    uniform over series) and sets (1000 distinct members per series),
    shuffled together."""
    from veneur_tpu_torch.protocol import columnar
    from veneur_tpu_torch.utils import hashing
    rng = np.random.default_rng(seed)
    classes = [
        ("c", N_COUNTER // scale, COUNTER_SAMPLES // scale,
         columnar.CODE_COUNTER, "c"),
        ("g", N_GAUGE // scale, GAUGE_SAMPLES // scale,
         columnar.CODE_GAUGE, "g"),
        ("t", N_TIMER // scale, TIMER_SAMPLES // scale,
         columnar.CODE_TIMER, "ms"),
        ("s", N_SET // scale, (N_SET // scale) * SET_MEMBERS,
         columnar.CODE_SET, "s"),
    ]
    lines, keys, parts = [], [], []
    base = 0
    for prefix, n_series, n, code, tok in classes:
        for i in range(n_series):
            lines.append(f"{prefix}{i}:1|{tok}|#env:smoke".encode())
            keys.append(hashing.key_hash64(f"{prefix}{i}", code,
                                           ("env:smoke",), 0))
        if code == columnar.CODE_SET:
            series = np.repeat(np.arange(n_series), SET_MEMBERS)
            vals = np.zeros(n)
            member = rng.integers(0, 2 ** 63, n, dtype=np.uint64)
        else:
            series = rng.integers(0, n_series, n)
            member = np.zeros(n, np.uint64)
            if code == columnar.CODE_TIMER:
                vals = rng.gamma(2.0, 30.0, n).astype(np.float32)
            else:
                vals = rng.normal(10.0, 3.0, n).astype(np.float32)
        parts.append((series + base, np.full(n, code, np.uint8),
                      vals.astype(np.float64), member))
        base += n_series
    line_id = np.concatenate([p[0] for p in parts])
    order = rng.permutation(len(line_id))
    line_id = line_id[order]
    offs = np.cumsum([0] + [len(x) + 1 for x in lines[:-1]])
    lens = np.array([len(x) for x in lines], np.int32)
    keys = np.array(keys, np.uint64)
    return dict(
        buf=b"\n".join(lines),
        key_hash=keys[line_id],
        type_code=np.concatenate([p[1] for p in parts])[order],
        value=np.concatenate([p[2] for p in parts])[order],
        member_hash=np.concatenate([p[3] for p in parts])[order],
        line_off=offs.astype(np.int64)[line_id],
        line_len=lens[line_id])


def chunks(traffic):
    from veneur_tpu_torch.protocol import columnar
    n = len(traffic["key_hash"])
    for lo in range(0, n, CHUNK):
        sl = slice(lo, lo + CHUNK)
        m = len(traffic["key_hash"][sl])
        yield columnar.ParsedBatch(
            buf=traffic["buf"], n=m, key_hash=traffic["key_hash"][sl],
            type_code=traffic["type_code"][sl],
            value=traffic["value"][sl],
            member_hash=traffic["member_hash"][sl],
            weight=np.ones(m, np.float32), scope=np.zeros(m, np.uint8),
            line_off=traffic["line_off"][sl],
            line_len=traffic["line_len"][sl])


def run_interval(table, flusher, batches, sync):
    """Ingest every chunk (with the mid-interval device steps), swap,
    flush.  Returns (FlushResult, seconds by stage)."""
    t0 = time.perf_counter()
    n = 0
    for pb in batches:
        n += table.ingest_columns(pb)[0]
        table.device_step()
    t1 = time.perf_counter()
    snap = table.swap()
    sync()
    t2 = time.perf_counter()
    res = flusher.flush(snap, now=1)
    t3 = time.perf_counter()
    return res, n, {"ingest_s": t1 - t0, "swap_s": t2 - t1,
                    "flush_s": t3 - t2, "total_s": t3 - t0}


def profile_interval(table, flusher, batches, sync) -> dict:
    """One more interval under torch.profiler: device kernel time by
    name and the device's busy share of the interval's wall time.
    Kernel times are None where the profiler saw no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        run_interval(table, flusher, batches, sync)
    wall = time.perf_counter() - t0
    by_name = []
    for e in prof.key_averages():
        # device-side events only (kernels, memcpy, memset): an aten
        # op's device time is its kernels' time counted a second time
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            by_name.append((e.key, us / 1e3, e.count))
    by_name.sort(key=lambda x: -x[1])
    busy_ms = sum(ms for _, ms, _ in by_name)
    if not by_name:
        return {"wall_s": wall, "device_busy_s": None,
                "device_idle_share": None, "top_kernels": []}
    return {"wall_s": wall, "device_busy_s": busy_ms / 1e3,
            "device_idle_share": 1.0 - busy_ms / 1e3 / wall,
            "top_kernels": [{"name": n[:80], "ms": ms, "count": c}
                            for n, ms, c in by_name[:8]]}


def exact_quantiles(traffic, p: float):
    """Exact per-series timer quantiles (numpy's linear rule)."""
    from veneur_tpu_torch.protocol import columnar
    sel = traffic["type_code"] == columnar.CODE_TIMER
    rows = traffic["line_off"][sel]
    vals = traffic["value"][sel].astype(np.float32).astype(np.float64)
    uniq, inv = np.unique(rows, return_inverse=True)
    order = np.lexsort((vals, inv))
    sv = vals[order]
    counts = np.bincount(inv)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    h = (counts - 1) * p
    lo = np.floor(h).astype(np.int64)
    hi = np.minimum(lo + 1, counts - 1)
    return uniq, sv[start + lo] + (h - lo) * (sv[start + hi] -
                                              sv[start + lo])


def compare_flush(dev_metrics, cpu_metrics) -> dict:
    d = {(m.name, m.tags): m.value for m in dev_metrics}
    c = {(m.name, m.tags): m.value for m in cpu_metrics}
    check(d.keys() == c.keys(), "cuda and cpu flushes emit different "
                                "metric names")
    worst = {"sum": 0.0, "pct": 0.0}
    for key, cv in c.items():
        dv = d[key]
        name = key[0]
        if name.endswith("percentile"):
            excess = abs(dv - cv) - (1e-3 + 2e-3 * abs(cv))
            check(excess <= 0, f"{key}: {dv} vs {cv}")
            worst["pct"] = max(worst["pct"], abs(dv - cv))
        elif name.endswith(".sum"):
            rel = abs(dv - cv) / max(abs(cv), 1e-30)
            check(rel <= 1e-6, f"{key}: {dv} vs {cv}")
            worst["sum"] = max(worst["sum"], rel)
        else:
            check(dv == cv, f"{key}: {dv} vs {cv} not bit-equal")
    return {"metrics": len(c), "sum_max_rel_err": worst["sum"],
            "percentile_max_abs_err": worst["pct"]}


def phase_table(dev: str = "cuda", scale: int = 1,
                cpu_reference: bool = True) -> dict:
    import torch
    from veneur_tpu_torch.core.flusher import Flusher
    from veneur_tpu_torch.core.table import MetricTable, TableConfig
    from veneur_tpu_torch.ops import cluster_merge
    t0 = time.perf_counter()
    traffic = build_traffic(0, scale)
    gen_s = time.perf_counter() - t0
    n_total = len(traffic["key_hash"])
    cfg = dict(counter_rows=16384 // scale, gauge_rows=16384 // scale,
               histo_rows=16384 // scale, set_rows=1024 // scale,
               host_set_plane_max_bytes=0,
               histo_merge_samples=(8 << 20) // scale)
    kw = dict(percentiles=(0.5, 0.9, 0.99),
              aggregates=("min", "max", "count", "sum"))
    flusher = Flusher(**kw, device=dev)

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    table = MetricTable(TableConfig(**cfg), device=dev)
    cluster_merge.launches = 0
    applies0 = table.superbatch_applies
    _, n1, st1 = run_interval(table, flusher, chunks(traffic), sync)
    res, n2, st2 = run_interval(table, flusher, chunks(traffic), sync)
    launches = cluster_merge.launches
    check(n1 == n2 == n_total, f"processed {n1}/{n2} of {n_total}")
    applies = table.superbatch_applies - applies0
    prof = profile_interval(table, flusher, chunks(traffic), sync)
    if dev == "cuda":
        check(launches > 0, "the main path launched no cluster merge "
                            "kernel")
    out = {"phase": "table_interval", "device": dev,
           "samples": n_total, "timer_samples": TIMER_SAMPLES // scale,
           "gen_s": gen_s, "interval1": st1, "interval2": st2,
           "samples_per_s": n_total / st2["total_s"],
           "cluster_merge_launches": launches,
           "launches_per_interval": launches / 2,
           "superbatch_applies": applies,
           "profiled_interval": prof}
    if cpu_reference:
        ctable = MetricTable(TableConfig(**cfg), device="cpu")
        cres, _, cst = run_interval(ctable, Flusher(**kw, device="cpu"),
                                    chunks(traffic),
                                    lambda: None)
        out["cpu_interval"] = cst
        out["vs_cpu"] = compare_flush(res.metrics, cres.metrics)
    uniq, exact = exact_quantiles(traffic, 0.99)
    est = {}
    for m in res.metrics:
        if m.name.endswith(".99percentile") and m.name.startswith("t"):
            est[m.name[:-len(".99percentile")]] = m.value
    names = [traffic["buf"][int(o):].split(b":", 1)[0].decode()
             for o in uniq]
    rel = np.array([abs(est[nm] - ex) / abs(ex)
                    for nm, ex in zip(names, exact)])
    check(len(est) == len(uniq), "missing timer series in the flush")
    out["p99_rel_err_median"] = float(np.median(rel))
    out["p99_rel_err_max"] = float(rel.max())
    check(out["p99_rel_err_median"] < 0.01, "median p99 error >= 1%")
    emit(out)
    return out


# ---- phase 5: the server ----------------------------------------------------

def free_udp_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def wait_for(pred, timeout: float, what: str, proc=None) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"server exited ({proc.returncode}) "
                                 f"while waiting for {what}")
        check(time.monotonic() < deadline, f"timed out waiting for {what}")
        time.sleep(0.05)


def phase_server(dev: str = "cuda") -> dict:
    port = free_udp_port()
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke-") as tmp:
        flush = os.path.join(tmp, "flush.tsv")
        cfg = os.path.join(tmp, "server.yaml")
        with open(cfg, "w") as f:
            # JSON is YAML: no YAML library needed to write it
            json.dump({"interval": "2s", "hostname": "smoke",
                       "statsd_listen_addresses":
                           [f"udp://127.0.0.1:{port}"],
                       "flush_file": flush,
                       "percentiles": [0.5, 0.99]}, f)
        log = open(os.path.join(tmp, "server.log"), "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "veneur_tpu_torch.cli.main", "-f",
             cfg, "--device", dev], cwd=HERE, stdout=log,
            stderr=subprocess.STDOUT)
        try:
            t0 = time.perf_counter()
            # the first (empty) flush creates the file: sending right
            # after it leaves a whole interval before the next one
            wait_for(lambda: os.path.exists(flush), 60, "first flush",
                     proc)
            startup = time.perf_counter() - t0
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            msgs = [b"hits:1|c"] * 3 + [b"temp:42|g"]
            msgs += [f"lat:{v}|ms".encode() for v in range(200)]
            msgs += [f"uniq:u{i}|s".encode() for i in range(300)]
            for m in msgs:
                s.sendto(m, ("127.0.0.1", port))
                time.sleep(0.0005)  # stay inside the receive buffer
            s.close()

            def flushed():
                with open(flush) as f:
                    return "lat.count" in f.read()
            wait_for(flushed, 30, "the flush of the sent metrics", proc)
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            log.close()
        with open(flush) as f:
            rows = [r.split("\t") for r in f.read().splitlines()]
        with open(os.path.join(tmp, "server.log")) as f:
            server_log = f.read()
    check(proc.returncode == 0, f"server exit code {proc.returncode}: "
                                f"{server_log[-2000:]}")
    vals = {r[0]: float(r[5]) for r in rows}
    check(vals.get("hits") == 3.0, f"hits = {vals.get('hits')}")
    check(vals.get("temp") == 42.0, f"temp = {vals.get('temp')}")
    check(vals.get("lat.count") == 200.0,
          f"lat.count = {vals.get('lat.count')}")
    check(repr(vals.get("lat.99percentile")) == "197.00999450683594",
          f"lat.99percentile = {vals.get('lat.99percentile')!r}")
    check(abs(vals.get("uniq", 0) - 300) <= 15,
          f"uniq = {vals.get('uniq')}")
    res = {"phase": "server", "startup_s": startup,
           "hits": vals["hits"], "lat.count": vals["lat.count"],
           "lat.99percentile": vals["lat.99percentile"],
           "uniq": vals["uniq"]}
    emit(res)
    return res


# ---- main --------------------------------------------------------------------

def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "veneur_tpu_torch")):
        print("chip_smoke: veneur_tpu_torch/ not found beside this "
              "script; run it from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device_count": torch.cuda.device_count()})

    from veneur_tpu_torch.ops import cluster_merge
    t0 = time.perf_counter()
    lib = cluster_merge.build(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(lib, HERE)})

    kern = phase_kernel()
    phase_entry()
    table = phase_table()
    phase_server()

    k = kern[512]
    emit({"kernels": [{
        "name": "cluster_merge", "route": "cuda",
        "source": "veneur_tpu_torch/csrc/cluster_merge.cu",
        "replaces": "veneur_tpu/ops/pallas_merge.py:192",
        "launches": table["cluster_merge_launches"],
        "max_abs_err": k["quantile_max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None}]})
    check("jax" not in sys.modules, "something imported jax")
    check(not any(m.startswith("veneur_tpu.") for m in sys.modules),
          "something imported the JAX package")
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
