#!/usr/bin/env python3
"""Drive the PyTorch port (``veneur_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, one JSON line each:

0. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
   env: the ``grpc`` and ``google.protobuf`` versions on this host (the
   port's generated modules and gRPC tier must import);
1. build: the cluster merge kernel from ``veneur_tpu_torch/csrc``
   (nvcc) and the native host library from ``veneur_tpu_torch/native``
   (g++), both compilers started together;
2. kernel vs plain: ``cluster_merge`` against ``cluster_merge_plain``
   at R = 16384, C = 616, K = 512 (the deep plane), K = 256, K = 616
   (union), K = 512 with unsorted state rows and K = 512 with f32
   subnormal keys and weights: mass, packing contract, no subnormal
   written, quantiles; times with CUDA events.  F2: merges past the
   reference's 2048 lanes (compression 300: C = 1824 + K = 512;
   compression 500: C = 3032 with unsorted state rows) take the
   kernel's wide route, counted as ``cluster_merge.wide``, with the
   same checks and times.  After
   phases 4, 6, 8, 9, 10, 12, 13, 14 and 15 the same check runs at
   every other (R, K) they merged at (the global folds with weighted
   centroids) and at the warm-up's (256, 256); every case reports the
   row and quantile of its largest kernel-vs-plain gap with both
   values;
3. ``entry("cuda")`` against ``entry("cpu")`` on the same arrays, then
   F1: f32 subnormal samples on every histogram path, a subnormal
   counter and a subnormal gauge through the table on the card and on
   the CPU, bit-equal, the subnormals flushed to zero (the gauge
   kept);
4. the main path: a ``MetricTable`` at the server's default sizes
   (16384 counter / gauge / histo rows, 1024 set rows) takes two
   intervals of DogStatsD text (16k counter series, 16k gauge series,
   10k timer series carrying 10M samples and 1024 set series x 1000
   members, in buffers of 1Mi lines) through ``ingest_buffer`` (native
   parse, probe and combine), ``device_step`` (the f16 value plane and
   the cluster merge) and ``swap`` + ``Flusher.flush``; the flush is
   held against a CPU table's on the same text, the percentiles
   against exact ones over the parsed values, and the stage times, the
   route each batch took, the bytes copied to the device, the kernel
   launch count and the (rows, K) of every merge are read; the second
   interval flushes through the columnar frame and, on the same
   snapshot, through the per-row emit (bit-equal lists, both times
   reported); a third interval runs under torch.profiler for the
   device's busy share and its kernel times;
9. multi-reader ingest (run right after phase 4): phase 4's text cut
   into 65,536-line batches through a port server's
   ``handle_packet_batch`` from 1 reader (``ingest_buffer``) and from 2
   and 4 reader threads (a ReaderShard each), with the pipelined
   device step at 65,536 staged samples, then swap and flush: samples/s,
   lock-free parse and locked commit time, apply, swap and flush time,
   the merges by (rows, K); every flush held to the 1-reader flush
   (gauges: one of the values sent) and to the exact p99s; the ledger
   closes and seals around the swap as ``flush_once`` does, and each
   reader count must seal balanced with every line received;
5. the server: ``python -m veneur_tpu_torch.cli.main`` on the card with
   ``num_readers: 4``, fed over loopback UDP from eight source sockets
   (single-line, multi-line, an event, a service check and an
   oversize datagram), its flush file checked; then its ``/debug/*``
   surface: CUDA-event device time for every device step that ran,
   readback bytes, the flush stages, the sealed and balanced ledger
   (received = the samples sent), the last flush's trace tree, the
   signal history and flight recorder, the TSV's
   ``veneur.worker.metrics_processed_total`` equal to the samples sent,
   and a ``/debug/pprof/device`` capture during a timer burst whose CUDA
   kernels include ``cluster_merge_kernel``;
6. the global tier at BASELINE config 5's size: 64 locals' wires (each
   the local-role flush of a table on the card that took a 1/64 share
   of phase 4's timer and set traffic, plus global-only counters,
   gauges and timers; 16 of them in the reference's gob schema) built
   once, then decoded and merged into a global table per interval
   (``decode_body`` + ``apply_import``, ``device_step`` at the staging
   bound, ``swap`` + flush): 10,000 timer series (the flat fold) over
   one interval plus one profiled, and 4,096 series (the stacked fold,
   one kernel launch per wire); each held against a CPU global on the
   same bodies and against the exact p99 of every local's samples;
8. the global tier over gRPC (run right after phase 6): the flat
   shape's 64 locals' rows also serialized as MetricLists, each wire
   through ``decode_metric_list`` (the lock-free native decode) and
   ``apply_decoded`` (row and wire-plan caches, vectorized staging),
   ``device_step`` at the staging bound, ``swap`` + flush; two
   intervals (the second must resolve every wire from the wire-plan
   cache) plus one profiled; held against a CPU global on the same
   bytes, against phase 6's HTTP global and against the exact p99;
10. adaptive sketch tiers (run right after phase 8): the reference's
   cardinality soak (``bench.py --cardinality``, full size) through a
   tiered port ``Server``: 65,536 timer rows and 16,384 set rows with
   pools of an eighth, 3 steady intervals of Zipf(1.15) traffic
   (300,000 timer samples over 40,000 series, 120,000 set members over
   12,000 series, plus tracked hot and cold series) and 3 idle ones,
   through ``handle_packet_batch`` in 8,192-line chunks and
   ``flush_once``; all of the soak's gates (device bytes per series 4x
   under the all-wide baseline and flat, the accuracy pins, promotions
   and demotions in both classes, the ledger naming every movement,
   nothing unattributed, every interval sealed balanced), every
   timer series' flushed count equal to what was sent, the flush held
   to a CPU port server's on the same lines, and the card's peak
   device memory against an untiered port table at the same sizes;
12. the routing tiers (run right after phase 8, on its wires): (a) the
   proxy hop at ``bench.py --proxy-chain``'s size (120,000 series in
   10,000-item MetricLists, 8 destinations, sends stubbed): routed
   items/s on the columnar route and on the per-item oracle, the
   columnar phase split, every item's destination held to the
   oracle's, 0 fallbacks and a balanced ProxyLedger each pass; (b) phase
   8's 64 wires over gRPC into a port ``ProxyServer`` in front of two
   port globals on the card, a warm interval with the globals' own
   fold and a timed one with phase 8's (flat): every series on one
   global, the union's order-free values bit-equal to phase 8's flush,
   its percentiles measured against it, each global's timed flush
   bit-equal to its own wires folded again, the exact p99, every
   ledger balanced; (c) a sharded port local forwarding to the two
   globals through four intervals — B stopped (its wire spools, the
   breaker opens), B restarted on its port (the spool replays, booked
   as replay), a drain on ``shutdown()`` (booked as drain at both) —
   its union held to the same intervals into one global with no
   outage, the spool ledger and every ledger balanced;
13. crash riding (run right after phase 10), the reference's overload
   and chaos soaks at their non-QUICK sizes, each leg a line of its
   gates: (a) ``bench.py --overload`` through a port ``Server`` (40,000
   offered non-counter lines and 10,000 counters from 20 Zipf(1.5)
   tenants against rate = burst = 50 buckets, then the pressure tiers at
   level 3 and a flush overrun with its coalesced tick: every gate of
   the reference, counters conserved exactly, every ledger balanced);
   (b) the histogram width ladder at full width: 10,000 timer series
   (300 gamma(2, 30) samples each) through a table at the server's
   default sizes at pressure levels 0-3, each level's flush held to a
   CPU table's at the same level (order-free values and sums bit for
   bit, percentiles within rtol 2e-3 / atol 1e-3), merges at K = 256,
   128 and 64 recorded, the p99 and p50 errors against exact reported;
   (c) ``_chaos_crash(3000)``: port locals on the card as child
   processes adopting a UDP socket this script binds and cloaks, the
   first SIGKILLed after a fresh checkpoint segment, the second
   recovering it over gRPC flagged recovery to a port global here (the
   seven ``crash_*`` gates), then a global's staged timers checkpointed
   and recovered through the import fold on the card, held to the CPU;
   (d) ``_chaos_scale_out(1200, 48, 256)``: a port global hands its
   departing arcs to a second (the four ``scaleout_*`` gates), their
   union held to one global's flush;
14. the server core and the span plane (run right after phase 13):
   port servers from the repo's ``example.yaml`` as child processes on
   the card, every address on a free loopback port or a temporary unix
   socket (an SSF unix listener added), the build directory
   (``compile_cache_dir``) a temporary one seeded with this checkout's
   libraries.  Child A as written with ``tpu_warmup`` (its warm-up's
   one merge launch and seconds read before traffic), child B with
   ``percentile_naming`` and ``quantile_interpolation`` at
   ``reference``: each takes one interval of SSF spans (10,000 timer
   series of 100 gamma(2, 30) samples, one span each, plus a successful
   and a failed indicator span for each of 1,000 services) over UDP,
   a unix stream and gRPC ``SendSpan``, then DogStatsD over UDP and
   TCP, paced so no socket buffer or span queue overflows; each flush
   file is held to a CPU port server fed the same spans through
   ``handle_ssf`` in the same order (percentiles within rtol 2e-3 /
   atol 1e-3, the rest bit for bit, the delivery-sampled
   ``ssf.names_unique`` aside), A's p99 median error against exact under
   1%, every receive counter, the sealed ledger record, ``/version``,
   ``/builddate`` and ``/quitquitquit`` (exit 0); child C, whose flush
   file is a FIFO nobody reads, exits 2 by its flush watchdog.  READY
   times with and without warm-up;
15. the ingest edge (run right after phase 14): its provenance first
   (the kernel release, the ring probe's errno, the io_uring sysctl,
   the effective SO_RCVBUF, ``openssl`` on the PATH), then ten port
   servers as child processes on the card: (a) phase 4's series at
   full width, cut to 100 samples a timer series and set (1,294,400
   lines in 25-line datagrams from eight source sockets, a series on
   one socket), paced on each child's received counter into a
   ``tpu_ingest_backend: uring`` and a ``recvmmsg`` server with one
   reader (their flushes bit-equal), a ``uring`` server with four
   (bit-equal to one: each series on one socket, one device step at
   the swap), each held to a CPU port server on the same datagrams,
   every ledger record balanced, 0 ENOBUFS and kernel drops; (b)
   ``bench.py --sockets``' two packet shapes unpaced for 4 s into each
   tier at 1 and 4 readers: packets/s, samples/s, delivery, ENOBUFS,
   drops, fallbacks, the device steps' CUDA-event seconds and the
   card's idle share, uring held to >= 0.9x of recvmmsg with delivery
   within 2 points where the kernel grants the ring; (c) TLS: ECDSA
   P-256 and RSA 2048 handshakes for 2 s each, a client without a
   certificate refused by an mTLS server and counted, a local
   forwarding (a)'s interval over gRPC with ``forward_grpc_tls_ca`` and
   a client pair to an mTLS global whose flush equals the plaintext
   chain's bit for bit; (d) a child on ``http_address: einhorn@0`` (a
   listening socket this script bound, its ack read here, /healthcheck
   and /version through it);
7. the chain: a global (HTTP and gRPC listeners) and three locals (one
   per /import schema, one forwarding over gRPC) as server processes on
   the card: the global flushes the JAX chain's ``lat.99percentile``
   from each; Health/Check, a multi-line SendPacket and the frozen
   Go-side MetricList fixture through SendMetrics; a garbage /import is
   answered 400 and a garbage SendMetrics INVALID_ARGUMENT, both
   counted; the global's ``/debug/trace/<local's trace id>`` holds an
   ``import`` span under each local's ``flush.forward`` span (HTTP in
   both schemas, gRPC);
11. the kernels line (launches by path, phase 12's as
    ``routing_tiers``, phase 13's as ``crash_riding``, phase 14's as
    ``span_plane``, phase 15's as ``ingest_edge``; F2's wide shapes as
    ``wide``), then the last line
    ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero before the last
line.  Without CUDA, or without the package beside it, it exits 2 and
prints no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import io
import json
import math
import os
import signal
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


T_START = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        # the script's wall clock at the end of each phase
        obj = dict(obj, script_elapsed_s=time.perf_counter() - T_START)
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, runs: int = 10, reps: int = 10, warmup: int = 3) -> float:
    """Median ms of one call of ``fn``: each of ``runs`` samples times
    ``reps`` back-to-back calls between two CUDA events, so the host's
    launch overhead overlaps the device's work instead of adding to
    it."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return float(np.median(times))


# ---- phase 2: kernel vs plain -------------------------------------------

def with_subnormals(case: list) -> list:
    """F1's merge case: f32 subnormal keys (of both signs) in every
    third state row and every other batch row, and subnormal weights
    (which the merge reads as empty slots) in the batch of every fifth
    row."""
    m, w, bm, bw = (x.copy() for x in case)
    tiny = np.float32(1e-40)
    m[::3, 0] = np.where(w[::3, 0] > 0, tiny, 0.0)
    bm[::2, :3] = np.where(bw[::2, :3] > 0,
                           np.array([tiny, -tiny, 3 * tiny], np.float32),
                           0.0)
    bw[::5, 8:16] = np.where(bw[::5, 8:16] > 0, tiny, 0.0)
    return [m, w, bm, bw]


def random_case(rng, rows, cap, slots, weighted=False):
    """The reference's tests/test_pallas_merge.py generator: mean-sorted
    state rows up to half full, a batch with 80% live slots (unit
    samples; ``weighted``: a forwarded wire's centroids, a mean-sorted
    prefix of weights 1-59 per row)."""
    occ = rng.integers(0, cap // 2, size=rows)
    live = np.arange(cap)[None, :] < occ[:, None]
    means = np.sort(np.where(live, rng.normal(200.0, 40.0, (rows, cap)),
                             np.inf), axis=1)
    means = np.where(live, means, 0.0).astype(np.float32)
    weights = np.where(live, rng.integers(1, 50, (rows, cap)),
                       0).astype(np.float32)
    if weighted:
        n = rng.integers(0, slots + 1, size=rows)
        blive = np.arange(slots)[None, :] < n[:, None]
        bm = np.sort(np.where(blive, rng.normal(200.0, 40.0,
                                                (rows, slots)), np.inf),
                     axis=1)
        bm = np.where(blive, bm, 0.0).astype(np.float32)
        bw = np.where(blive, rng.integers(1, 60, (rows, slots)),
                      0).astype(np.float32)
        return means, weights, bm, bw
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


def merge_bound_ms(rows: int, cap: int, k: int,
                   sorted_state: bool = True) -> tuple[float, str]:
    """Least time for one merge: read 2 R (C+K) f32, write 2 R C f32;
    operations: a comparison sort of what arrives unsorted (the batch,
    and the state when it is not already sorted: n log2 n for n =
    pow2 of its width), a binary search per slot to merge the two
    sorted runs, and ~30 f32 operations per slot for the k-scale and
    the cluster sums."""
    nbytes = 2 * rows * (cap + k) * 4 + 2 * rows * cap * 4
    ops = 30 * (cap + k) + (cap + k) * math.log2(max(cap, k, 2))
    for width in ((k,) if sorted_state else (k, cap)):
        n = 1 << max(width - 1, 1).bit_length()
        ops += n * math.log2(n)
    ops *= rows
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


# (label, state rows R, batch width K, state rows sorted, weighted
# batch): K = 512 is the deep plane's width and chunk, K = 256 a
# shallow merge, K = 616 a digest union; the unsorted case permutes
# every state row so the kernel sorts it too; the subnormal case
# carries f32 subnormal keys and weights (``with_subnormals``).  After
# phases 4, 6, 8 and 9, phase 2 also holds the kernel at every other
# (R, K) those paths merged at (``recorded_cases``), with weighted
# batches for the globals'.
KERNEL_CASES = (("k512", 16384, 512, True, False),
                ("k256", 16384, 256, True, False),
                ("k616", 16384, 616, True, False),
                ("k512_unsorted_state", 16384, 512, False, False),
                ("k512_subnormal", 16384, 512, True, False))


# the start-up warm-up's one merge (``tpu_warmup``: the scratch table's
# two histogram rows in a 256-row bucket at K = 256; MergeRecorder
# around a CPU server's warm-up reads the same)
WARMUP_SHAPES = ({"rows": 256, "k": 256, "calls": 1},)


def recorded_cases(merge_shapes, weighted=False, timed=()) -> tuple:
    """Merge shapes of a path that KERNEL_CASES and ``timed`` (labels
    already run) do not time."""
    done = {(r, k, w) for _, r, k, _, w in KERNEL_CASES}
    done |= {(r, k, w) for _, r, k, _, w in timed}
    tag = "_weighted" if weighted else ""
    return tuple((f"r{m['rows']}_k{m['k']}{tag}", m["rows"], m["k"], True,
                  weighted)
                 for m in merge_shapes
                 if (m["rows"], m["k"], weighted) not in done)


class MergeRecorder:
    """Counts every cluster merge by (rows, batch width K) while it is
    entered, and the kernel launches made meanwhile (the registry's
    launch counts, set to 0 on entry)."""

    def __enter__(self):
        from veneur_tpu_torch.observe import REGISTRY
        from veneur_tpu_torch.ops import cluster_merge
        self._cm = cluster_merge
        self._merge = cluster_merge.cluster_merge
        self.shapes: dict = {}

        def recording_merge(means, weights, new_means, new_weights, **kw):
            key = (int(means.shape[0]), int(new_means.shape[1]))
            self.shapes[key] = self.shapes.get(key, 0) + 1
            return self._merge(means, weights, new_means, new_weights,
                               **kw)
        cluster_merge.cluster_merge = recording_merge
        REGISTRY.reset_launches()
        return self

    def __exit__(self, *exc):
        self.launches = self._cm.launch_count()
        self._cm.cluster_merge = self._merge
        return False

    def table(self) -> list:
        return [{"rows": r, "k": k, "calls": c}
                for (r, k), c in sorted(self.shapes.items())]


def phase_kernel(dev: str = "cuda", cases=KERNEL_CASES,
                 compression: float = 100.0) -> dict:
    import torch
    from veneur_tpu_torch.ops import cluster_merge as cm
    from veneur_tpu_torch.ops import segment, tdigest
    cap = tdigest.capacity_for(compression)
    tiny = torch.finfo(torch.float32).tiny
    kw = dict(delta=tdigest._SCALE_MULT * compression,
              tail_coeff=tdigest._TAIL_MULT * compression,
              tail_q0=tdigest._TAIL_Q0, tail_qmin=tdigest._TAIL_QMIN)
    rng = np.random.default_rng(7)
    qs = torch.tensor(QS, dtype=torch.float32, device=dev)
    out = {}
    for label, rows, k, sorted_state, weighted in cases:
        case = list(random_case(rng, rows, cap, k, weighted))
        if not sorted_state:
            perm = np.argsort(rng.random((rows, cap)), axis=1)
            case[0] = np.take_along_axis(case[0], perm, 1)
            case[1] = np.take_along_axis(case[1], perm, 1)
        if label.endswith("_subnormal"):
            case = with_subnormals(case)
        a = [torch.from_numpy(x).to(dev) for x in case]
        km, kwt = cm.cluster_merge(*a, **kw)
        pm, pwt = cm.cluster_merge_plain(*a, **kw)
        torch.cuda.synchronize()
        # the mass the merge keeps: subnormal weights read as empty
        total = (segment.ftz(a[1]).double().sum(1) +
                 segment.ftz(a[3]).double().sum(1))
        for name, t in (("means", km), ("weights", kwt)):
            check(not bool(((t.abs() < tiny) & (t != 0)).any()),
                  f"{label}: the kernel wrote a subnormal {name} slot")
        mass_k = float(((kwt.double().sum(1) - total).abs() /
                        total.clamp(min=1e-30)).max())
        mass_p = float(((pwt.double().sum(1) - total).abs() /
                        total.clamp(min=1e-30)).max())
        check(mass_k <= 1e-6, f"{label}: kernel mass rel err {mass_k}")
        check(mass_p <= 1e-6, f"{label}: plain mass rel err {mass_p}")
        check(packing_ok(km, kwt), f"{label}: kernel packing contract")
        check(packing_ok(pm, pwt), f"{label}: plain packing contract")
        qk = tdigest.quantile(km, kwt, qs)
        qp = tdigest.quantile(pm, pwt, qs)
        # rows with no weight at all read NaN in both
        both = ~torch.isnan(qp)
        check(torch.equal(torch.isnan(qk), ~both),
              f"{label}: kernel and plain differ in empty rows")
        viol = float(((qk - qp).abs() - (1e-3 + 2e-3 * qp.abs()))[both]
                     .max())
        check(viol <= 0, f"{label}: quantiles outside rtol 2e-3/atol "
                         f"1e-3 (excess {viol})")
        max_abs = float((qk - qp).abs()[both].max())
        # the row and quantile of the largest gap, with both values
        gap = torch.where(both, (qk - qp).abs(), torch.zeros_like(qk))
        row, qi = divmod(int(gap.argmax()), len(QS))
        ms = cuda_ms(lambda: cm.cluster_merge(*a, **kw))
        plain_ms = cuda_ms(lambda: cm.cluster_merge_plain(*a, **kw))
        n = 1 << (cap + k - 1).bit_length()
        keys = torch.where(a[1] > 0, a[0], torch.full_like(a[0], math.inf))
        keys = torch.cat([keys, torch.full((rows, n - cap), math.inf,
                                           device=dev)], dim=1)
        sort_ms = cuda_ms(lambda: torch.sort(keys, dim=1))
        bound, by = merge_bound_ms(rows, cap, k, sorted_state)
        res = {"phase": "kernel_vs_plain", "case": label, "rows": rows,
               "cap": cap, "k": k, "route": cm.route(cap, k),
               "sorted_state": sorted_state,
               "weighted_batch": weighted,
               "mass_rel_err_kernel": mass_k,
               "mass_rel_err_plain": mass_p,
               "quantile_max_abs_err": max_abs,
               "largest_gap": {"row": row, "q": QS[qi],
                               "kernel": float(qk[row, qi]),
                               "plain": float(qp[row, qi])}, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
               "bound_share": bound / ms,
               "torch_sort_ms": sort_ms, "sort_n": n, "library_ms": None,
               "launch": cm.occupancy(cap, k),
               "library_note": "no single PyTorch call computes the "
                               "whole merge; torch_sort_ms is the sort "
                               "of the same (R, sort_n) keys, for "
                               "context"}
        emit(res)
        out[label] = res
        del a, km, kwt, pm, pwt, keys
    return out


# F2's shapes, past the reference's 2048-lane bound: compression 300
# (C = 1824) at the deep plane's K = 512, and compression 500 (C =
# 3032) with unsorted state rows, past the register sort
WIDE_CASES = ((300.0, ("wide_c300_k512", 16384, 512, True, False)),
              (500.0, ("wide_c500_k512_unsorted_state", 2048, 512, False,
                       False)))


def phase_wide_merge(dev: str = "cuda") -> dict:
    """F2 in phase 2: merges wider than the reference's Pallas bound go
    through ``cluster_merge``'s dispatch to the kernel's wide route,
    counted as ``cluster_merge.wide`` and never on the narrow route, and
    are held to ``cluster_merge_plain`` on the same inputs as every
    phase 2 case is."""
    from veneur_tpu_torch.observe import REGISTRY
    from veneur_tpu_torch.ops import cluster_merge as cm
    from veneur_tpu_torch.ops import tdigest
    out = {}
    for c, case in WIDE_CASES:
        cap = tdigest.capacity_for(c)
        check(cm.route(cap, case[2]) == "wide", f"route({cap}, {case[2]})")
        before = REGISTRY.launches()
        out.update(phase_kernel(dev, cases=(case,), compression=c))
        after = REGISTRY.launches()
        check(after.get("cluster_merge", 0) ==
              before.get("cluster_merge", 0) and
              after.get("cluster_merge.wide", 0) >
              before.get("cluster_merge.wide", 0),
              f"{case[0]}: the merge did not take the wide route")
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
CHUNK = 1 << 20  # lines per ingest_buffer call
TAGS = b"|#env:smoke"


def build_traffic(seed: int = 0, scale: int = 1) -> list[bytes]:
    """One interval's traffic as DogStatsD text (seeded): counters,
    gauges, timers (10k series x 10M gamma(2, 30) samples, uniform over
    series) and sets (1000 distinct members per series), shuffled
    together and cut into buffers of CHUNK lines."""
    rng = np.random.default_rng(seed)
    lines: list[bytes] = []
    for prefix, n_series, n, tok in (
            (b"c", N_COUNTER // scale, COUNTER_SAMPLES // scale, b"c"),
            (b"g", N_GAUGE // scale, GAUGE_SAMPLES // scale, b"g"),
            (b"t", N_TIMER // scale, TIMER_SAMPLES // scale, b"ms")):
        names = [b"%s%d:" % (prefix, i) for i in range(n_series)]
        tail = b"|" + tok + TAGS
        series = rng.integers(0, n_series, n).tolist()
        if tok == b"ms":
            vals = rng.gamma(2.0, 30.0, n).tolist()
        else:
            vals = rng.normal(10.0, 3.0, n).tolist()
        lines += [b"%s%.3f%s" % (names[i], v, tail)
                  for i, v in zip(series, vals)]
    n_set = N_SET // scale
    members = rng.integers(0, 2 ** 62, n_set * SET_MEMBERS).tolist()
    lines += [b"s%d:m%d|s%s" % (i // SET_MEMBERS, m, TAGS)
              for i, m in enumerate(members)]
    order = rng.permutation(len(lines)).tolist()
    return [b"\n".join(lines[j] for j in order[lo:lo + CHUNK])
            for lo in range(0, len(order), CHUNK)]


def metric_keys(metrics) -> list:
    return sorted((m.name, m.timestamp, m.value, m.tags, m.type,
                   m.hostname) for m in metrics)


def run_interval(table, flusher, bufs, sync, oracle=None):
    """Feed every buffer through ``ingest_buffer`` with the
    mid-interval device steps, swap, flush through the frame
    (``retain_frame``, as the server flushes; ``materialize_s`` is the
    list built from it).  With ``oracle`` (a per-row Flusher) the same
    snapshot also goes through the per-row emit, and the two lists must
    be bit-equal.  Returns (FlushResult with the frame materialized,
    processed, seconds by stage, what the interval did)."""
    routes0, h2d0 = dict(table.routes), table.h2d_bytes
    t_ingest = t_step = 0.0
    n = 0
    for buf in bufs:
        t0 = time.perf_counter()
        processed, dropped, others = table.ingest_buffer(buf)
        t1 = time.perf_counter()
        table.device_step()
        t_step += time.perf_counter() - t1
        t_ingest += t1 - t0
        check(dropped == 0 and not others,
              f"ingest_buffer dropped {dropped}, {len(others)} others")
        n += processed
    t1 = time.perf_counter()
    snap = table.swap()
    sync()
    t2 = time.perf_counter()
    res = flusher.flush(snap, now=1, retain_frame=True)
    t3 = time.perf_counter()
    res.metrics = res.all_metrics()
    t4 = time.perf_counter()
    res.frame = None
    routes = {k: v - routes0.get(k, 0) for k, v in table.routes.items()
              if v - routes0.get(k, 0)}
    total = t_ingest + t_step + (t3 - t1)
    out = {"parse_ingest_s": t_ingest, "device_step_s": t_step,
           "swap_s": t2 - t1, "flush_s": t3 - t2,
           "materialize_s": t4 - t3, "total_s": total, "routes": routes,
           "h2d_bytes": table.h2d_bytes - h2d0}
    if oracle is not None:
        t5 = time.perf_counter()
        per_row = oracle.flush(snap, now=1)
        out["per_row_flush_s"] = time.perf_counter() - t5
        check(metric_keys(per_row.metrics) == metric_keys(res.metrics),
              "the frame's list and the per-row emit differ")
        out["frame_equals_per_row"] = True
        out["metrics"] = len(res.metrics)
    return res, n, out


def profile_device(fn) -> dict:
    """Run ``fn`` (one more interval) under torch.profiler: device
    kernel time by name and the device's busy share of the wall time.
    Kernel times are None where the profiler saw no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        fn()
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


def exact_quantiles(bufs, p: float) -> dict:
    """Exact per-series quantiles (numpy's linear rule) of the timer
    series whose names start with ``t``, over the values as parsed from
    the text: the native parser's f64, rounded to the f32 the table
    stores.  Keyed by identity hash."""
    from veneur_tpu_torch.protocol import columnar
    parser = columnar.ColumnarParser()
    keys, vals = [], []
    for buf in bufs:
        pb = parser.parse(buf, copy=False)
        first = np.frombuffer(buf, np.uint8)[pb.line_off[:pb.n]]
        sel = ((pb.type_code[:pb.n] == columnar.CODE_TIMER) &
               (first == ord("t")))
        keys.append(pb.key_hash[:pb.n][sel].copy())
        vals.append(pb.value[:pb.n][sel].astype(np.float32)
                    .astype(np.float64))
    keys, vals = np.concatenate(keys), np.concatenate(vals)
    uniq, inv = np.unique(keys, return_inverse=True)
    order = np.lexsort((vals, inv))
    sv = vals[order]
    counts = np.bincount(inv)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    h = (counts - 1) * p
    lo = np.floor(h).astype(np.int64)
    hi = np.minimum(lo + 1, counts - 1)
    q = sv[start + lo] + (h - lo) * (sv[start + hi] - sv[start + lo])
    return dict(zip(uniq.tolist(), q.tolist()))


def p99_errors(metrics, bufs, exact=None, pct: int = 99) -> np.ndarray:
    """Relative error of every flushed p99 (``pct``) of a ``t<i>`` timer
    series (tagged ``env:smoke``) against the exact quantile of the
    text's values (``exact``, when the caller has it already)."""
    from veneur_tpu_torch.protocol import columnar
    from veneur_tpu_torch.utils import hashing
    if exact is None:
        exact = exact_quantiles(bufs, pct / 100)
    est = {}
    suffix = f".{pct}percentile"
    for m in metrics:
        if m.name.startswith("t") and m.name.endswith(suffix):
            name = m.name[:-len(suffix)]
            est[hashing.key_hash64(name, columnar.CODE_TIMER,
                                   ("env:smoke",), 0)] = m.value
    check(est.keys() == exact.keys(), "timer series differ between the "
                                      "flush and the parsed text")
    return np.array([abs(est[k] - ex) / abs(ex) for k, ex in exact.items()])


def compare_flush(dev_metrics, cpu_metrics,
                  hold_percentiles: bool = True,
                  sums_exact: bool = False) -> dict:
    """Hold a flush to another: order-free values bit for bit, sums to
    rtol 1e-6 (``sums_exact``: bit for bit), percentiles to rtol 2e-3 /
    atol 1e-3 (with ``hold_percentiles`` false they are only measured:
    how many fall outside that tolerance, and the largest relative
    gap)."""
    d = {(m.name, m.tags): m.value for m in dev_metrics}
    c = {(m.name, m.tags): m.value for m in cpu_metrics}
    check(d.keys() == c.keys(), "cuda and cpu flushes emit different "
                                "metric names")
    worst = {"sum": 0.0, "pct": 0.0, "pct_rel": 0.0}
    outside = 0
    for key, cv in c.items():
        dv = d[key]
        name = key[0]
        if name.endswith("percentile"):
            excess = abs(dv - cv) - (1e-3 + 2e-3 * abs(cv))
            outside += excess > 0
            check(excess <= 0 or not hold_percentiles,
                  f"{key}: {dv} vs {cv}")
            worst["pct"] = max(worst["pct"], abs(dv - cv))
            worst["pct_rel"] = max(worst["pct_rel"],
                                   abs(dv - cv) / max(abs(cv), 1e-30))
        elif name.endswith(".sum"):
            rel = abs(dv - cv) / max(abs(cv), 1e-30)
            check(rel == 0 if sums_exact else rel <= 1e-6,
                  f"{key}: {dv} vs {cv}")
            worst["sum"] = max(worst["sum"], rel)
        else:
            check(dv == cv, f"{key}: {dv} vs {cv} not bit-equal")
    out = {"metrics": len(c), "sum_max_rel_err": worst["sum"],
           "percentile_max_abs_err": worst["pct"]}
    if not hold_percentiles:
        out.update(percentile_max_rel_err=worst["pct_rel"],
                   percentiles_outside_tolerance=int(outside))
    return out


def phase_table(dev: str = "cuda", scale: int = 1,
                cpu_reference: bool = True) -> dict:
    import torch
    from veneur_tpu_torch.core.flusher import Flusher
    from veneur_tpu_torch.core.table import MetricTable, TableConfig
    t0 = time.perf_counter()
    bufs = build_traffic(0, scale)
    gen_s = time.perf_counter() - t0
    n_total = sum(b.count(b"\n") + 1 for b in bufs)
    cfg = dict(counter_rows=16384 // scale, gauge_rows=16384 // scale,
               histo_rows=16384 // scale, set_rows=1024 // scale,
               host_set_plane_max_bytes=0,
               histo_merge_samples=(8 << 20) // scale)
    kw = dict(percentiles=(0.5, 0.9, 0.99),
              aggregates=("min", "max", "count", "sum"))
    flusher = Flusher(**kw, device=dev)
    oracle = Flusher(**kw, device=dev, columnar=False)

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    table = MetricTable(TableConfig(**cfg), device=dev)
    # every merge of the two intervals, by (rows, batch width K)
    with MergeRecorder() as rec:
        applies0 = table.superbatch_applies
        _, n1, st1 = run_interval(table, flusher, bufs, sync)
        res, n2, st2 = run_interval(table, flusher, bufs, sync,
                                    oracle=oracle)
    launches = rec.launches
    check(n1 == n2 == n_total, f"processed {n1}/{n2} of {n_total}")
    for i, st in enumerate((st1, st2)):
        check(st["routes"].get("plane_f16", 0) >= 1,
              f"interval {i + 1} took no f16 plane: {st['routes']}")
    applies = table.superbatch_applies - applies0
    prof = profile_device(lambda: run_interval(table, flusher, bufs, sync))
    if dev == "cuda":
        check(launches > 0, "the main path launched no cluster merge "
                            "kernel")
    out = {"phase": "table_interval", "device": dev,
           "samples": n_total, "timer_samples": TIMER_SAMPLES // scale,
           "buffers": len(bufs), "gen_s": gen_s,
           "interval1": st1, "interval2": st2,
           "samples_per_s": n_total / st2["total_s"],
           "cluster_merge_launches": launches,
           "launches_per_interval": launches / 2,
           "merge_shapes": rec.table(),
           "superbatch_applies": applies,
           "profiled_interval": prof,
           "cut": "two intervals plus one profiled; sets forced onto the "
                  "device (host_set_plane_max_bytes = 0)"}
    if cpu_reference:
        ctable = MetricTable(TableConfig(**cfg), device="cpu")
        cres, _, cst = run_interval(ctable, Flusher(**kw, device="cpu"),
                                    bufs, lambda: None)
        out["cpu_interval"] = cst
        out["vs_cpu"] = compare_flush(res.metrics, cres.metrics)
    exact = exact_quantiles(bufs, 0.99)
    rel = p99_errors(res.metrics, bufs, exact)
    out["p99_rel_err_median"] = float(np.median(rel))
    out["p99_rel_err_max"] = float(rel.max())
    check(out["p99_rel_err_median"] < 0.01, "median p99 error >= 1%")
    emit(out)
    # phase 9 takes the same text, its exact p99s and this flush
    out.update(bufs=bufs, exact_p99=exact, metrics=res.metrics, cfg=cfg)
    return out


# ---- F1 on the card ------------------------------------------------------

def f1_cases() -> list:
    """ROADMAP Queue 3's F1 inputs, f32 subnormal samples on each path
    (a counter, the superbatch's ranked merge, a min beside a normal
    sample, weighted samples, a dense f32 plane row), and a 1e-40
    gauge, a select that keeps it, as the control."""
    rng = np.random.default_rng(1)
    plane = [b"p%d:%.3f|ms" % (i, v) for i in range(40)
             for v in rng.gamma(2.0, 30.0, 60)] + [b"p0:1e-40|ms"]
    return [("counter", [b"tc:1e-40|c"]), ("gauge", [b"tg:1e-40|g"]),
            ("ranked", [b"tiny:1e-40|ms"] * 2),
            ("min_hmean", [b"mm:1e-40|ms", b"mm:5|ms"]),
            ("weighted", [b"tw:1e-40|ms|@0.5", b"tw:2e-40|ms|@0.5"]),
            ("dense_plane", plane)]


def phase_f1(dev: str = "cuda") -> dict:
    """The F1 inputs through the port's table on ``dev`` and on the CPU:
    every flushed value bit-equal (the dense plane's percentiles, built
    from normal samples by the kernel on one side and its plain version
    on the other, to the merge tolerance), the subnormal samples
    flushed to zero and the gauge kept."""
    from veneur_tpu_torch.core.flusher import Flusher
    from veneur_tpu_torch.core.table import MetricTable, TableConfig
    sizes = dict(counter_rows=32, gauge_rows=32, histo_rows=64,
                 set_rows=8)
    kw = dict(percentiles=(0.5, 0.9, 0.99), hostname="h",
              aggregates=("min", "max", "count", "sum", "avg", "median",
                          "hmean"))
    out = {"phase": "f1_subnormals", "device": dev, "cases": {}}
    for case, lines in f1_cases():
        got = {}
        for d in (dev, "cpu"):
            t = MetricTable(TableConfig(**sizes), device=d)
            t.ingest_buffer(b"\n".join(lines))
            got[d] = {(m.name, m.tags): m.value for m in Flusher(
                **kw, device=d).flush(t.swap(), now=1).metrics}
        check(got[dev].keys() == got["cpu"].keys(),
              f"F1 {case}: card and CPU flush different metrics")
        for key, cv in got["cpu"].items():
            dv = got[dev][key]
            if case == "dense_plane" and key[0].endswith(
                    ("percentile", ".median")):
                check(abs(dv - cv) <= 1e-3 + 2e-3 * abs(cv),
                      f"F1 {key}: {dv} vs {cv}")
            else:
                check(np.float64(dv).tobytes() == np.float64(cv).tobytes(),
                      f"F1 {key}: {dv!r} vs {cv!r} not bit-equal")
        out["cases"][case] = {k[0]: v for k, v in sorted(got[dev].items())
                              if not k[0].startswith("p") or
                              k[0].startswith("p0.")}
    c = out["cases"]
    check(c["counter"]["tc"] == 0.0, "tc:1e-40|c did not flush to 0")
    check(c["gauge"]["tg"] == float(np.float32(1e-40)),
          "the 1e-40 gauge did not keep its value")
    check(c["ranked"]["tiny.max"] == 0.0 and
          "tiny.hmean" not in c["ranked"], f"tiny: {c['ranked']}")
    check(c["min_hmean"]["mm.min"] == 0.0 and
          "mm.hmean" in c["min_hmean"], f"mm: {c['min_hmean']}")
    check(c["weighted"]["tw.max"] == 0.0, f"tw: {c['weighted']}")
    check(c["dense_plane"]["p0.min"] == 0.0, "p0.min did not flush to 0")
    emit(out)
    return out


# ---- phase 9: multi-reader ingest ---------------------------------------

READER_BATCH_LINES = 65536  # ~ one 512-datagram sweep of 4 KiB datagrams
STAGE_FLUSH_SAMPLES = 65536


def recut(bufs, per: int = READER_BATCH_LINES) -> list[bytes]:
    """Phase 4's buffers cut into batches of ``per`` lines."""
    out = []
    for buf in bufs:
        nl = np.flatnonzero(np.frombuffer(buf, np.uint8) == 10)
        ends = nl[per - 1::per].tolist() + [len(buf)]
        start = 0
        for e in ends:
            out.append(buf[start:e])
            start = e + 1
    return out


class TimedShard:
    """A ReaderShard whose lock-free ``parse`` and locked ``commit``
    are timed, and whose commits append their batch's index to
    ``order`` (under the server's lock: the commit order)."""

    def __init__(self, shard, index_of: dict, order: list):
        self.shard = shard
        self.parse_s = self.commit_s = 0.0
        self._index_of = index_of
        self._order = order
        self._batch = -1

    def parse(self, buf):
        self._batch = self._index_of[id(buf)]
        t0 = time.perf_counter()
        self.shard.parse(buf)
        self.parse_s += time.perf_counter() - t0

    def commit(self):
        t0 = time.perf_counter()
        out = self.shard.commit()
        self.commit_s += time.perf_counter() - t0
        self._order.append(self._batch)
        return out

    def reset(self):
        self.shard.reset()


def run_readers(dev: str, n_readers: int, batches, table_cfg: dict,
                sync) -> tuple:
    """One interval of ``batches`` through a port server's own
    ``handle_packet_batch`` from ``n_readers`` threads (one: the
    single-reader ``ingest_buffer`` under the lock, in list order;
    more: a ReaderShard each, batch j to reader j % n), with the
    pipelined device step at ``STAGE_FLUSH_SAMPLES``; then swap and
    flush through the frame.  Returns (the flush's metrics, seconds
    and counts, the order the batches committed in)."""
    import threading
    from veneur_tpu_torch.core.config import read_config
    from veneur_tpu_torch.core.server import Server
    cfg = read_config(data={
        "num_readers": n_readers, "tpu_pipeline": True,
        "tpu_stage_flush_samples": STAGE_FLUSH_SAMPLES,
        "tpu_reader_pin_cores": "auto",
        "percentiles": list(FLUSH_KW["percentiles"]),
        "aggregates": list(FLUSH_KW["aggregates"]), "hostname": "h",
        **{f"tpu_{k}": table_cfg[k] for k in (
            "counter_rows", "gauge_rows", "histo_rows", "set_rows")}},
        env={})
    srv = Server(cfg, device=dev)
    table = srv.table
    # phase 4's table: sets on the device, the deep batch at 8 Mi
    table.config.host_set_plane_max_bytes = table_cfg[
        "host_set_plane_max_bytes"]
    table.config.histo_merge_samples = table_cfg["histo_merge_samples"]
    t = {"locked_s": 0.0, "apply_s": 0.0, "applies": 0}
    apply = table.apply_staged

    def timed_apply(w):
        t0 = time.perf_counter()
        apply(w)
        t["apply_s"] += time.perf_counter() - t0
        t["applies"] += 1
    table.apply_staged = timed_apply
    ingest = table.ingest_buffer

    def timed_ingest(buf):
        t0 = time.perf_counter()
        out = ingest(buf)
        t["locked_s"] += time.perf_counter() - t0
        return out
    table.ingest_buffer = timed_ingest
    index_of = {id(b): j for j, b in enumerate(batches)}
    order: list = []
    shards = [TimedShard(srv._reader_shard(), index_of, order)
              if n_readers > 1 else None for _ in range(n_readers)]
    pinned = [False] * n_readers
    errs = []

    def reader(i):
        try:
            pinned[i] = srv._pin_reader_core(i)
            for b in batches[i::n_readers]:
                srv.handle_packet_batch([], drained=b, drained_pkts=512,
                                        shard=shards[i])
        except Exception as e:  # reported below
            errs.append(repr(e))

    threads = [threading.Thread(target=reader, args=(i,))
               for i in range(n_readers)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    t1 = time.perf_counter()
    check(not errs, f"{n_readers} readers: {errs}")
    # the interval closes in the swap's lock round and seals after the
    # flush, as flush_once does
    with srv.lock:
        pend = table.begin_swap()
        led = srv.ledger.close_interval(
            seq=1, table_staged=pend.ingested,
            table_overflow=pend.overflow)
    snap = table.complete_swap(pend)
    sync()
    t2 = time.perf_counter()
    res = srv.flusher.flush(snap, retain_frame=True)
    metrics = res.all_metrics()
    t3 = time.perf_counter()
    srv.ledger.credit_rows(led, res.row_accounting)
    srv.ledger.seal(led)
    n = sum(b.count(b"\n") + 1 for b in batches)
    check(srv.stats["metrics_processed"] == n and
          srv.stats["metrics_dropped"] == 0,
          f"{n_readers} readers processed {srv.stats}")
    check(led.balanced and led.received == {"dogstatsd": n},
          f"{n_readers} readers sealed {led.to_dict()}")
    t["ledger"] = {k: led.to_dict()[k] for k in (
        "received", "staged", "rows", "balanced", "owed",
        "staged_drift", "rows_owed")}
    if n_readers > 1:
        t["parse_s"] = sum(sh.parse_s for sh in shards)
        t["locked_s"] = sum(sh.commit_s for sh in shards)
    else:
        t["parse_s"] = 0.0
    t.update({"readers": n_readers, "pinned": pinned,
              "ingest_wall_s": t1 - t0, "swap_s": t2 - t1,
              "flush_s": t3 - t2, "total_s": t3 - t0,
              "samples": n, "samples_per_s": n / (t3 - t0),
              "locked_share_of_ingest_wall": t["locked_s"] / (t1 - t0)})
    srv.shutdown()
    return metrics, t, order or list(range(len(batches)))


def gauge_values(bufs) -> dict:
    """Every value sent for each gauge series of the text, as the f32 a
    gauge stores, keyed by identity hash."""
    from veneur_tpu_torch.protocol import columnar
    parser = columnar.ColumnarParser()
    out: dict = {}
    for buf in bufs:
        pb = parser.parse(buf, copy=False)
        sel = pb.type_code[:pb.n] == columnar.CODE_GAUGE
        for k, v in zip(pb.key_hash[:pb.n][sel].tolist(),
                        pb.value[:pb.n][sel].astype(np.float32).tolist()):
            out.setdefault(k, set()).add(v)
    return out


def compare_readers(metrics, one, gauges, same_order: bool) -> dict:
    """A multi-reader flush against a 1-reader flush: counters, set
    values and histogram count/min/max bit-equal, sums to rtol 1e-6.
    ``same_order`` (the 1-reader run took the batches in the
    multi-reader run's commit order): gauges bit-equal and percentiles
    within rtol 2e-3 / atol 1e-3.  Otherwise every gauge must be one of
    the values sent for its series, and the percentiles, whose digests
    were built from the samples in another order, are only measured:
    the share within that tolerance and the largest relative
    difference."""
    from veneur_tpu_torch.protocol import columnar
    from veneur_tpu_torch.utils import hashing
    d = {(m.name, m.tags): m for m in metrics}
    o = {(m.name, m.tags): m for m in one}
    check(d.keys() == o.keys(), "the flushes emit different metrics")
    worst = {"sum": 0.0, "pct": 0.0, "pct_rel": 0.0}
    n_gauges = n_pct = pct_in_tol = 0
    for key, om in o.items():
        dv, ov = d[key].value, om.value
        name = key[0]
        if name.endswith("percentile"):
            ok = abs(dv - ov) <= 1e-3 + 2e-3 * abs(ov)
            check(ok or not same_order, f"{key}: {dv} vs {ov}")
            n_pct += 1
            pct_in_tol += ok
            worst["pct"] = max(worst["pct"], abs(dv - ov))
            worst["pct_rel"] = max(worst["pct_rel"],
                                   abs(dv - ov) / max(abs(ov), 1e-30))
        elif same_order and name.startswith("g") and om.type == "gauge":
            check(dv == ov, f"gauge {key}: {dv} vs {ov} not bit-equal")
            n_gauges += 1
        elif name.endswith(".sum"):
            rel = abs(dv - ov) / max(abs(ov), 1e-30)
            check(rel <= 1e-6, f"{key}: {dv} vs {ov}")
            worst["sum"] = max(worst["sum"], rel)
        elif om.type == "gauge" and name.startswith("g"):
            sent = gauges[hashing.key_hash64(name, columnar.CODE_GAUGE,
                                             key[1], 0)]
            check(dv in sent and ov in sent,
                  f"gauge {key}: {dv} / {ov} was never sent")
            n_gauges += 1
        else:
            check(dv == ov, f"{key}: {dv} vs {ov} not bit-equal")
    return {"metrics": len(o), "gauges_checked": n_gauges,
            "same_commit_order": same_order,
            "sum_max_rel_err": worst["sum"],
            "percentile_max_abs_diff": worst["pct"],
            "percentile_max_rel_diff": worst["pct_rel"],
            "percentiles_within_merge_tolerance": pct_in_tol / max(n_pct, 1)}


def phase_readers(table_out: dict, dev: str = "cuda",
                  counts=(1, 2, 4)) -> dict:
    """Phase 4's text, re-cut into 65,536-line batches, through 1, 2
    and 4 readers, each one interval of a fresh server table at phase
    4's configuration.  Every multi-reader flush is held to the
    1-reader flush (``compare_readers``) and, bit for bit, to a 1-reader
    replay of its own commit order; each run's p99s to the exact
    ones."""
    import torch

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    bufs, exact = table_out["bufs"], table_out["exact_p99"]
    t0 = time.perf_counter()
    batches = recut(bufs)
    gauges = gauge_values(bufs)
    prep_s = time.perf_counter() - t0
    out = {"phase": "multi_reader", "device": dev,
           "batches": len(batches), "batch_lines": READER_BATCH_LINES,
           "stage_flush_samples": STAGE_FLUSH_SAMPLES,
           "usable_cores": len(os.sched_getaffinity(0)),
           "prep_s": prep_s, "runs": {}}
    one = None
    for n in counts:
        with MergeRecorder() as rec:
            metrics, st, order = run_readers(dev, n, batches,
                                             table_out["cfg"], sync)
        st["cluster_merge_launches"] = rec.launches
        st["merge_shapes"] = rec.table()
        if dev == "cuda":
            check(rec.launches > 0, f"{n} readers launched no merge")
        rel = p99_errors(metrics, bufs, exact)
        st["p99_rel_err_median"] = float(np.median(rel))
        st["p99_rel_err_max"] = float(rel.max())
        check(st["p99_rel_err_median"] < 0.01,
              f"{n} readers: median p99 error >= 1%")
        if one is None:
            # against itself: only its gauges' membership can fail
            compare_readers(metrics, metrics, gauges, same_order=False)
            one = metrics
        else:
            st["vs_one_reader"] = compare_readers(metrics, one, gauges,
                                                  same_order=False)
            replay, _, _ = run_readers(dev, 1, [batches[j] for j in order],
                                       table_out["cfg"], sync)
            st["vs_one_reader_in_commit_order"] = compare_readers(
                metrics, replay, gauges, same_order=True)
        out["runs"][str(n)] = st
    out["cut"] = ("one interval per reader count (plus a 1-reader replay "
                  "of each multi-reader commit order, untimed); the text "
                  "is phase 4's, made once; no sockets (phase 5 drives "
                  "SO_REUSEPORT readers at small size)")
    emit(out)
    return out


# ---- phase 10: adaptive sketch tiers (the cardinality soak) ---------------

# bench.py's --cardinality soak, non-QUICK (bench.py:4352-4437): its
# series, table rows, traffic per interval and tier thresholds
SOAK_HISTO_SERIES, SOAK_SET_SERIES = 40_000, 12_000
SOAK_HISTO_ROWS, SOAK_SET_ROWS = 65_536, 16_384
SOAK_SAMPLES, SOAK_ITEMS = 300_000, 120_000
SOAK_STEADY, SOAK_IDLE = 3, 3
SOAK_CHUNK = 8192  # lines per handle_packet_batch(drained=...) call
SOAK_ENV = {"VENEUR_TPU_PLANE_TIERS": "2",
            "VENEUR_TPU_PROMOTE_HISTO_SAMPLES": "64",
            "VENEUR_TPU_PROMOTE_SET_ENTRIES": "512",
            "VENEUR_TPU_DEMOTE_IDLE_INTERVALS": "2"}


def soak_traffic(seed: int = 20260808) -> dict:
    """The soak's intervals as line lists, made once (seeded): the
    first also touches every series once, each steady interval carries
    the tracked series (hot timer 3,000 samples, cold timer 24, hot set
    5,000 members, cold set 60) and Zipf(1.15) traffic (300,000 timer
    samples over 40,000 series, 120,000 fresh set members over 12,000
    series); each idle interval 500 new one-sample timers.  Also the
    samples sent to every timer series each interval, and the tracked
    values of the last steady interval."""
    rng = np.random.default_rng(seed)
    intervals, sent = [], []
    uid = 0
    hot_vals = cold_vals = None
    for it in range(SOAK_STEADY):
        lines = []
        counts = np.zeros(SOAK_HISTO_SERIES, np.int64)
        if it == 0:
            lines += [b"card.h.%d:1|ms" % i
                      for i in range(SOAK_HISTO_SERIES)]
            lines += [b"card.s.%d:seed|s" % i
                      for i in range(SOAK_SET_SERIES)]
            counts += 1
        hot_vals = np.round(rng.uniform(0.0, 1000.0, 3_000), 4)
        cold_vals = np.round(rng.uniform(0.0, 1000.0, 24), 4)
        lines += [b"card.h.hot:%.4f|ms" % v for v in hot_vals]
        lines += [b"card.h.cold:%.4f|ms" % v for v in cold_vals]
        lines += [b"card.s.hot:mh%d|s" % i for i in range(5_000)]
        lines += [b"card.s.cold:mc%d|s" % i for i in range(60)]
        hz = np.minimum(rng.zipf(1.15, SOAK_SAMPLES),
                        SOAK_HISTO_SERIES) - 1
        vals = rng.uniform(0.0, 1000.0, SOAK_SAMPLES)
        lines += [b"card.h.%d:%.4f|ms" % (i, v)
                  for i, v in zip(hz.tolist(), vals.tolist())]
        counts += np.bincount(hz, minlength=SOAK_HISTO_SERIES)
        sz = np.minimum(rng.zipf(1.15, SOAK_ITEMS), SOAK_SET_SERIES) - 1
        lines += [b"card.s.%d:m%d|s" % (i, uid + j)
                  for j, i in enumerate(sz.tolist())]
        uid += SOAK_ITEMS
        intervals.append(lines)
        c = {f"card.h.{i}": int(n) for i, n in enumerate(counts) if n}
        c.update({"card.h.hot": 3_000, "card.h.cold": 24})
        sent.append(c)
    for j in range(SOAK_IDLE):
        names = [f"card.h.tail{j * 500 + i}" for i in range(500)]
        intervals.append([b"%s:1|ms" % n.encode() for n in names])
        sent.append({n: 1 for n in names})
    return {"intervals": intervals, "sent": sent, "hot_vals": hot_vals,
            "cold_vals": cold_vals}


def run_soak(dev: str, traffic: dict, sync) -> dict:
    """The soak through a port ``Server`` on ``dev``: every interval's
    lines through ``handle_packet_batch(drained=...)`` in SOAK_CHUNK
    chunks, then ``flush_once``.  Per interval: the time split (ingest;
    the final apply; the tier boundary; the flusher; the rest of
    ``flush_once``), ``plane_bytes()`` and the index occupancy after
    it, the snapshot's tier view and its metrics."""
    import torch
    from veneur_tpu_torch.core.config import read_config
    from veneur_tpu_torch.core.server import Server
    saved = {k: os.environ.get(k) for k in SOAK_ENV}
    os.environ.update(SOAK_ENV)
    try:
        srv = Server(read_config(data={
            "interval": "10s", "hostname": "bench-cardinality",
            "percentiles": [0.5, 0.99], "aggregates": ["max", "count"],
            "tpu_histo_rows": SOAK_HISTO_ROWS,
            "tpu_set_rows": SOAK_SET_ROWS}, env={}), device=dev)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    table = srv.table
    check(table.tiers is not None, "the soak's table is not tiered")
    t = {}
    views = []
    complete, boundary, flush = (table.complete_swap,
                                 table._tier_boundary, srv.flusher.flush)

    def timed(key, fn):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            t[key] = t.get(key, 0.0) + time.perf_counter() - t0
            return out
        return wrapped

    def complete_spy(pend):
        snap = timed("complete_swap_s", complete)(pend)
        views.append((snap.tiers, [m.name for m in snap.histo_meta],
                      [m.name for m in snap.set_meta]))
        return snap
    table.complete_swap = complete_spy
    table._tier_boundary = timed("boundary_s", boundary)
    srv.flusher.flush = timed("flush_s", flush)
    out = []
    for lines in traffic["intervals"]:
        t.clear()
        t0 = time.perf_counter()
        for i in range(0, len(lines), SOAK_CHUNK):
            srv.handle_packet_batch(
                [], drained=b"\n".join(lines[i:i + SOAK_CHUNK]),
                drained_pkts=1)
        sync()
        t1 = time.perf_counter()
        res = srv.flush_once()
        t2 = time.perf_counter()
        ti, hnames, snames = views[-1]
        pb = table.plane_bytes()
        out.append({
            "samples": len(lines), "ingest_s": t1 - t0,
            "apply_s": t["complete_swap_s"] - t["boundary_s"],
            "boundary_s": t["boundary_s"], "flush_s": t["flush_s"],
            # begin_swap, and the frame's materialization for the sinks
            "other_s": (t2 - t1 - t["complete_swap_s"] - t["flush_s"]),
            "total_s": t2 - t0,
            "occ_histo": table.histo_idx.occupancy(),
            "occ_set": table.set_idx.occupancy(),
            "samples_per_s": len(lines) / (t2 - t0),
            "plane_bytes": pb, "tiers": ti, "histo_names": hnames,
            "set_names": snames, "metrics": res.metrics,
            "overflow": res.tally.get("overflow", 0)})
    dirs = {c: (getattr(table.tiers, c).tier.copy(),
                getattr(table.tiers, c).slot.copy())
            for c in ("histo", "set")}
    ledger = (srv.ledger.records(), srv.ledger.summary())
    srv.shutdown()
    del srv, table
    return {"intervals": out, "directory": dirs, "ledger": ledger}


def soak_accuracy(last, traffic) -> tuple[dict, dict]:
    """The soak's accuracy pins on the last steady flush, against the
    exact per-interval values (bench.py:4509-4585)."""
    hot, cold = traffic["hot_vals"], traffic["cold_vals"]
    em = {m.name: m.value for m in last["metrics"]}
    acc = {"hot_p99": em.get("card.h.hot.99percentile"),
           "hot_p99_true": float(np.quantile(hot, 0.99)),
           "cold_p99": em.get("card.h.cold.99percentile"),
           "cold_p99_true": float(np.quantile(cold, 0.99)),
           "hot_count": em.get("card.h.hot.count"),
           "hot_max": em.get("card.h.hot.max"),
           "hot_max_true": float(np.float32(hot.max())),
           "set_hot_est": em.get("card.s.hot"), "set_hot_true": 5_000,
           "set_cold_est": em.get("card.s.cold"), "set_cold_true": 60}

    def rel(got, want):
        return (float("inf") if got is None
                else abs(float(got) - want) / max(abs(want), 1e-9))
    gates = {
        "histo_hot_p99_pinned": rel(acc["hot_p99"],
                                    acc["hot_p99_true"]) <= 0.02,
        "histo_cold_p99_pinned": rel(acc["cold_p99"],
                                     acc["cold_p99_true"]) <= 0.05,
        "histo_hot_count_exact": acc["hot_count"] == 3_000,
        "histo_hot_max_exact": acc["hot_max"] == acc["hot_max_true"],
        "set_hot_est_pinned": rel(acc["set_hot_est"], 5_000.0) <= 0.04,
        "set_cold_est_pinned": rel(acc["set_cold_est"], 60.0) <= 0.02}
    return acc, gates


# the server's own count rows that come from its stats deltas and its
# ledger: held by value card against CPU; every other veneur.* row
# (timings, gc, memory, the device-cost registry) by name only
SELF_COUNTS = ("veneur.worker.", "veneur.packet.", "veneur.listen.",
               "veneur.ledger.", "veneur.tier.", "veneur.signals.",
               "veneur.flight.", "veneur.import.request_error_total",
               "veneur.flush.error_total",
               "veneur.forward.post_metrics_total",
               "veneur.forward.error_total")


def compare_tiered_flush(dev_iv, cpu_iv) -> dict:
    """The card's flush against the CPU table's for one interval: the
    same frozen tier view; counters, counts, max, set estimates and
    compact-row percentiles bit-equal; wide-row percentiles within rtol
    2e-3 / atol 1e-3 (the soak emits no sums); the server's own
    ``veneur.*`` rows by name, its stats-delta counts by value."""
    dt, ct = dev_iv["tiers"], cpu_iv["tiers"]
    for a in ("histo_tier", "histo_slot", "set_tier", "set_slot"):
        check(np.array_equal(getattr(dt, a), getattr(ct, a)),
              f"card and CPU tier views differ in {a}")
    check(dt.movements == ct.movements, "card and CPU movements differ")
    wide = {n for n, w in zip(cpu_iv["histo_names"],
                              ct.histo_tier[:len(cpu_iv["histo_names"])])
            if w}
    d = {(m.name, m.tags): m.value for m in dev_iv["metrics"]}
    c = {(m.name, m.tags): m.value for m in cpu_iv["metrics"]}
    check(d.keys() == c.keys(), "card and CPU flush different metrics")
    types = {(m.name, m.tags): m.type for m in cpu_iv["metrics"]}
    n_wide = n_compact = n_self = 0
    worst = 0.0
    for key, cv in c.items():
        dv = d[key]
        name = key[0]
        if name.startswith("veneur."):
            if name.startswith(SELF_COUNTS) and types[key] == "counter":
                check(dv == cv, f"{key}: {dv} vs {cv}")
            n_self += 1
            continue
        if name.endswith("percentile") and name.rsplit(".", 1)[0] in wide:
            check(abs(dv - cv) <= 1e-3 + 2e-3 * abs(cv),
                  f"{key}: {dv} vs {cv}")
            worst = max(worst, abs(dv - cv))
            n_wide += 1
            continue
        check(dv == cv, f"{key}: {dv} vs {cv} not bit-equal")
        n_compact += name.endswith("percentile")
    return {"metrics": len(c), "self_telemetry_rows": n_self,
            "wide_percentiles": n_wide,
            "compact_percentiles_bit_equal": n_compact,
            "wide_percentile_max_abs_diff": worst}


def phase_tiers(dev: str = "cuda", cpu_reference: bool = True) -> dict:
    """Phase 10: the reference's cardinality soak through a tiered port
    server on the card (and the same lines through a CPU one), with all
    of the soak's gates (its three ledger gates included), mass
    conservation, and the card's device memory against an untiered port
    table of the same sizes."""
    import torch
    from veneur_tpu_torch.core.table import MetricTable, TableConfig

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    traffic = soak_traffic()
    gen_s = time.perf_counter() - t0
    if dev == "cuda":
        sync()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    with MergeRecorder() as rec:
        run = run_soak(dev, traffic, sync)
    ivs = run["intervals"]
    out = {"phase": "tiers_soak", "device": dev, "gen_s": gen_s,
           "histo_series": SOAK_HISTO_SERIES,
           "set_series": SOAK_SET_SERIES, "histo_rows": SOAK_HISTO_ROWS,
           "set_rows": SOAK_SET_ROWS, "env": SOAK_ENV,
           "cluster_merge_launches": rec.launches,
           "merge_shapes": rec.table()}
    if dev == "cuda":
        out["peak_device_bytes_tiered"] = (torch.cuda.max_memory_allocated()
                                           - base)
        check(rec.launches > 0, "the soak launched no cluster merge")
        # an untiered port table at the same sizes, built and freed
        sync()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        saved = os.environ.get("VENEUR_TPU_PLANE_TIERS")
        os.environ["VENEUR_TPU_PLANE_TIERS"] = "1"
        try:
            wide = MetricTable(TableConfig(
                counter_rows=16384, gauge_rows=16384,
                histo_rows=SOAK_HISTO_ROWS, set_rows=SOAK_SET_ROWS),
                device=dev)
            check(wide.tiers is None, "the untiered table is tiered")
            sync()
            out["peak_device_bytes_untiered"] = (
                torch.cuda.max_memory_allocated() - base)
            del wide
        finally:
            if saved is None:
                os.environ.pop("VENEUR_TPU_PLANE_TIERS", None)
            else:
                os.environ["VENEUR_TPU_PLANE_TIERS"] = saved
        sync()
        torch.cuda.empty_cache()
    # device bytes per series against the analytic all-wide baseline,
    # as the soak computes them after the last steady flush: the same
    # occupancy, every occupied histo and set row a full-width sketch
    last = ivs[SOAK_STEADY - 1]
    pb = last["plane_bytes"]
    ti = pb["tiers"]["occupancy"]
    h_slot_b = pb["histo"]["wide"] / max(1, ti["histo"]["wide_slots"])
    s_slot_b = pb["set"]["wide"] / max(1, ti["set"]["wide_slots"])
    baseline = (pb["counter"]["wide"] + pb["gauge"]["wide"] +
                pb["histo"]["stats"] + last["occ_histo"] * h_slot_b +
                last["occ_set"] * s_slot_b)
    base_dbps = baseline / max(1, pb["occupancy"])
    dbps = pb["device_bytes_per_series"]
    acc, gates = soak_accuracy(last, traffic)
    steadies = [iv["plane_bytes"]["total"] for iv in ivs[:SOAK_STEADY]]
    mv = ivs[-1]["plane_bytes"]["tiers"]["movements"]
    # the reference's ledger gates (bench.py:4541-4580): the ledger
    # names every movement, nothing is lost unattributed, every
    # interval sealed balanced
    recs, ledsum = run["ledger"]
    unattributed = (ledsum["imbalanced"] + ledsum["owed_total"]
                    + ledsum.get("shed_owed_total", 0))
    gates.update({
        "dbps_bounded_4x": base_dbps / dbps >= 4.0,
        "dbps_flat_steady": max(steadies) <= 1.10 * min(steadies),
        "promotions_fired": all(mv[c]["promotions"] > 0
                                for c in ("histo", "set")),
        "demotions_fired": all(mv[c]["demotions"] > 0
                               for c in ("histo", "set")),
        "ledger_names_movements": (
            sum(r.tier_promotions for r in recs)
            == sum(c["promotions"] for c in mv.values())
            and sum(r.tier_demotions for r in recs)
            == sum(c["demotions"] for c in mv.values())),
        "unattributed_zero": unattributed == 0,
        "ledgers_balanced": ledsum["imbalanced"] == 0})
    out["ledger"] = ledsum
    out["unattributed_lost"] = int(unattributed)
    # mass: every timer series' flushed count is what was sent to it
    for k, (iv, sent) in enumerate(zip(ivs, traffic["sent"])):
        got = {m.name[:-len(".count")]: m.value for m in iv["metrics"]
               if m.name.startswith("card.h.") and m.name.endswith(".count")}
        check(got == {n: float(c) for n, c in sent.items()},
              f"interval {k + 1}: flushed timer counts differ from the "
              f"samples sent")
        check(iv["overflow"] == 0, f"interval {k + 1} dropped samples")
    gates["mass_conserved"] = True
    out.update({
        "intervals": [{k: v for k, v in iv.items()
                       if k not in ("tiers", "metrics", "histo_names",
                                    "set_names", "plane_bytes",
                                    "occ_histo", "occ_set")} |
                      {"total_bytes": iv["plane_bytes"]["total"],
                       "device_bytes_per_series":
                           iv["plane_bytes"]["device_bytes_per_series"],
                       "occupancy": iv["plane_bytes"]["occupancy"],
                       "wide_rows": {c: iv["plane_bytes"]["tiers"][
                           "occupancy"][c]["wide"]
                           for c in ("histo", "set")},
                       "movements": iv["tiers"].movements}
                      for iv in ivs],
        "plane_bytes_last_steady": {k: v for k, v in pb.items()
                                    if k != "tiers"},
        "device_bytes_per_series": dbps,
        "baseline_all_wide_bytes": baseline,
        "baseline_device_bytes_per_series": base_dbps,
        "dbps_reduction_x": base_dbps / dbps,
        "movements": mv, "accuracy": acc,
        "steady_samples_per_s": (
            sum(iv["samples"] for iv in ivs[:SOAK_STEADY]) /
            sum(iv["total_s"] for iv in ivs[:SOAK_STEADY]))})
    if cpu_reference:
        crun = run_soak("cpu", traffic, lambda: None)
        check(all(np.array_equal(crun["directory"][c][i],
                                 run["directory"][c][i])
                  for c in ("histo", "set") for i in (0, 1)),
              "card and CPU directories differ after the soak")
        out["vs_cpu"] = [compare_tiered_flush(d, c) for d, c in
                         zip(ivs, crun["intervals"])]
        out["cpu_steady_samples_per_s"] = (
            sum(iv["samples"] for iv in crun["intervals"][:SOAK_STEADY]) /
            sum(iv["total_s"] for iv in crun["intervals"][:SOAK_STEADY]))
    gates = {k: bool(v) for k, v in gates.items()}
    out["gates"] = gates
    out["cut"] = "none: the soak's sizes, traffic, thresholds and gates"
    emit(out)
    bad = [k for k, v in gates.items() if not v]
    check(not bad, f"soak gates failed: {bad}")
    return out


# ---- phase 6: the global tier -------------------------------------------------

# BASELINE config 5: 64 locals forwarding to one global.  Every fourth
# wire speaks the reference's gob schema, the rest the native one.
N_WIRES, REF_EVERY = 64, 4
N_GLOBAL_TIMER = 256   # #veneurglobalonly timers: counted at the global
N_FWD_SCALAR = 1024    # #veneurglobalonly counter and gauge series
FWD_SCALAR_SAMPLES = 16_000  # of each, per local
GTAGS = b"|#env:smoke,veneurglobalonly"


def local_traffic(i: int, n_timer: int, n_global_timer: int, seed: int,
                  scale: int = 1) -> bytes:
    """Local ``i``'s interval as one DogStatsD buffer: a seeded 1/64
    share of phase 4's timer traffic (gamma(2, 30)) over ``n_timer``
    series and of its set traffic over 1024 series, plus global-only
    timers (``n_global_timer`` series), counters and gauges."""
    rng = np.random.default_rng([seed, i])
    lines: list[bytes] = []
    n = TIMER_SAMPLES // N_WIRES // scale
    for prefix, n_series, n_samp, tail in (
            (b"t", n_timer, n, b"|ms" + TAGS),
            (b"gt", n_global_timer, n // 40, b"|ms" + GTAGS)):
        if not n_series:
            continue
        names = [b"%s%d:" % (prefix, j) for j in range(n_series)]
        series = rng.integers(0, n_series, n_samp).tolist()
        vals = rng.gamma(2.0, 30.0, n_samp).tolist()
        lines += [b"%s%.3f%s" % (names[s], v, tail)
                  for s, v in zip(series, vals)]
    n_fwd = N_FWD_SCALAR // scale
    m = FWD_SCALAR_SAMPLES // scale
    lines += [b"gc%d:%d|c%s" % (s, v, GTAGS) for s, v in zip(
        rng.integers(0, n_fwd, m).tolist(), rng.integers(1, 10, m).tolist())]
    lines += [b"gg%d:%.3f|g%s" % (s, v, GTAGS) for s, v in zip(
        rng.integers(0, n_fwd, m).tolist(),
        rng.normal(10.0, 3.0, m).tolist())]
    n_set = N_SET // scale
    members = rng.integers(0, 2 ** 62, n_set * SET_MEMBERS // N_WIRES)
    lines += [b"s%d:m%d|s%s" % (j % n_set, mem, TAGS)
              for j, mem in enumerate(members.tolist())]
    order = rng.permutation(len(lines)).tolist()
    return b"\n".join(lines[j] for j in order)


def table_sizes(scale: int = 1) -> dict:
    """The server's default table sizes."""
    return dict(counter_rows=16384 // scale, gauge_rows=16384 // scale,
                histo_rows=16384 // scale, set_rows=1024 // scale)


FLUSH_KW = dict(percentiles=(0.5, 0.9, 0.99),
                aggregates=("min", "max", "count", "sum"))


def build_wires(dev: str, n_timer: int, n_global_timer: int, seed: int,
                scale: int = 1, n_wires: int = N_WIRES,
                with_grpc: bool = False) -> tuple[list, list, dict]:
    """``n_wires`` distinct /import bodies, each the local-role flush of
    a port table on ``dev`` that took one local's traffic, encoded in
    the native schema or (every REF_EVERY-th) the reference's; with
    ``with_grpc`` the same rows also as a serialized MetricList
    (``"grpc"``).  Returns (wires, the locals' texts, timings)."""
    from veneur_tpu_torch.core.flusher import Flusher
    from veneur_tpu_torch.core.table import MetricTable, TableConfig
    from veneur_tpu_torch.forward import grpc_forward, http_import
    table = MetricTable(TableConfig(**table_sizes(scale)), device=dev)
    flusher = Flusher(is_local=True, **FLUSH_KW, device=dev)
    wires, texts = [], []
    t = {"gen_s": 0.0, "local_s": 0.0, "encode_s": 0.0,
         "grpc_encode_s": 0.0}
    for i in range(n_wires):
        t0 = time.perf_counter()
        text = local_traffic(i, n_timer, n_global_timer, seed, scale)
        t1 = time.perf_counter()
        processed, dropped, others = table.ingest_buffer(text)
        check(dropped == 0 and not others, f"local {i} dropped {dropped}")
        res = flusher.flush(table.swap(), now=1)
        t2 = time.perf_counter()
        schema = ("reference" if i % REF_EVERY == REF_EVERY - 1
                  else "native")
        if schema == "reference":
            body, hdr = http_import.encode_rows_reference(res.forward)
        else:
            body, hdr = http_import.encode_rows(res.forward)
        t3 = time.perf_counter()
        cents = sum(int((r.weights > 0).sum()) for r in res.forward
                    if r.kind == "histo")
        wires.append({"schema": schema, "body": body,
                      "encoding": hdr.get("Content-Encoding", ""),
                      "items": len(res.forward), "centroids": cents})
        if with_grpc:
            wires[-1]["grpc"] = grpc_forward.rows_to_metric_list(
                res.forward).SerializeToString()
        t4 = time.perf_counter()
        texts.append(text)
        t["gen_s"] += t1 - t0
        t["local_s"] += t2 - t1
        t["encode_s"] += t3 - t2
        t["grpc_encode_s"] += t4 - t3
    t["body_bytes"] = sum(len(w["body"]) for w in wires)
    if with_grpc:
        t["grpc_bytes"] = sum(len(w["grpc"]) for w in wires)
    return wires, texts, t


def run_global_interval(table, flusher, wires, sync):
    """One global interval: every wire's body through ``decode_body`` +
    ``apply_import`` (a ``device_step`` whenever staging passes the
    server's bound), then swap and flush.  Returns (FlushResult, seconds
    by stage and what the interval did)."""
    from veneur_tpu_torch.forward import http_import
    routes0, h2d0 = dict(table.routes), table.h2d_bytes
    t = {"decode_s": 0.0, "apply_s": 0.0, "device_step_s": 0.0}
    by_schema = {s: {"wires": 0, "decode_s": 0.0, "apply_s": 0.0}
                 for s in ("native", "reference")}
    acc = dropped = 0
    steps = 0
    for w in wires:
        t0 = time.perf_counter()
        items = http_import.decode_body(w["body"], w["encoding"])
        t1 = time.perf_counter()
        a, d = http_import.apply_import(table, items)
        t2 = time.perf_counter()
        acc += a
        dropped += d
        if table.staged() >= table.config.histo_merge_samples:
            table.device_step()
            sync()
            steps += 1
        t3 = time.perf_counter()
        t["decode_s"] += t1 - t0
        t["apply_s"] += t2 - t1
        t["device_step_s"] += t3 - t2
        s = by_schema[w["schema"]]
        s["wires"] += 1
        s["decode_s"] += t1 - t0
        s["apply_s"] += t2 - t1
    n_items = sum(w["items"] for w in wires)
    check(acc == n_items and dropped == 0,
          f"global accepted {acc} of {n_items} items, dropped {dropped}")
    t0 = time.perf_counter()
    snap = table.swap()
    sync()
    t1 = time.perf_counter()
    res = flusher.flush(snap, now=1)
    t2 = time.perf_counter()
    t["swap_s"], t["flush_s"] = t1 - t0, t2 - t1
    t["total_s"] = sum(t.values())
    cents = sum(w["centroids"] for w in wires)
    t.update({"items": n_items, "centroids": cents,
              "items_per_s": n_items / t["total_s"],
              "centroids_per_s": cents / t["total_s"],
              "mid_interval_device_steps": steps,
              "by_schema": by_schema,
              "routes": {k: v - routes0.get(k, 0)
                         for k, v in table.routes.items()
                         if v - routes0.get(k, 0)},
              "h2d_bytes": table.h2d_bytes - h2d0})
    return res, t


def phase_global(dev: str = "cuda", scale: int = 1, n_wires: int = N_WIRES,
                 intervals: int = 2, profiled: bool = True,
                 cpu_reference: bool = True, with_grpc: bool = True,
                 stack_wires: int | None = None) -> dict:
    """The global tier at BASELINE config 5's size: ``n_wires`` wires of
    10,000 timer series (the union-row bucket is past half the plane,
    so the fold takes the flat path) timed over ``intervals`` intervals
    plus one profiled, held against a CPU global on the same bodies and
    against the exact p99 of every local's samples; then the first
    ``stack_wires`` (default ``n_wires``) wires of 4,096 timer series
    (each wire the same whatever the count), whose fold takes the
    stacked path: one kernel launch per wire at (4096, K).  With ``with_grpc`` the flat shape's locals are
    also encoded as MetricLists, kept with their texts and the HTTP
    global's flush under ``"grpc_input"`` for phase 8."""
    import torch
    from veneur_tpu_torch.core.flusher import Flusher
    from veneur_tpu_torch.core.table import MetricTable, TableConfig

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    stack_wires = stack_wires or n_wires
    out = {"phase": "global_tier", "device": dev, "wires": n_wires,
           "reference_schema_wires": n_wires // REF_EVERY}
    shapes = {}
    # the stacked shape has no global-only timers: a reference-schema
    # wire carries no scope, so their rows would double in the union
    for label, n_timer, n_gt, seed, route, n_int, n_w in (
            ("flat", N_TIMER // scale, N_GLOBAL_TIMER // scale, 1,
             "wire_flat", intervals, n_wires),
            ("stack", 4096 // scale, 0, 2, "wire_stack", 1, stack_wires)):
        with MergeRecorder() as lrec:
            wires, texts, wt = build_wires(
                dev, n_timer, n_gt, seed, scale, n_w,
                with_grpc=with_grpc and label == "flat")
        table = MetricTable(TableConfig(**table_sizes(scale)), device=dev)
        flusher = Flusher(**FLUSH_KW, device=dev)
        with MergeRecorder() as rec:
            runs = [run_global_interval(table, flusher, wires, sync)
                    for _ in range(n_int)]
        res = runs[-1][0]
        for _, st in runs:
            check(st["routes"].get(route, 0) >= 1,
                  f"{label}: the fold took no {route}: {st['routes']}")
        if dev == "cuda":
            check(rec.launches > 0, f"{label}: the global launched no "
                                    "cluster merge kernel")
        r = {"timer_series": n_timer, "wires": n_w, "wire_build": wt,
             "local_cluster_merge_launches": lrec.launches,
             "local_merge_shapes": lrec.table(),
             "intervals": [st for _, st in runs],
             "cluster_merge_launches": rec.launches,
             "merge_shapes": rec.table()}
        if label == "stack":
            mb = 4096 // scale
            per_wire = sum(c for (rr, _k), c in rec.shapes.items()
                           if rr == mb)
            check(per_wire == n_w, f"stack: {per_wire} merges at "
                                   f"{mb} rows for {n_w} wires")
        if profiled and label == "flat":
            r["profiled_interval"] = profile_device(
                lambda: run_global_interval(table, flusher, wires, sync))
        if cpu_reference:
            ctable = MetricTable(TableConfig(**table_sizes(scale)),
                                 device="cpu")
            # the CPU global runs the card's fold (auto resolves to the
            # flat path on the CPU)
            ctable.fused_import_mode = table.import_mode()
            cres, cst = run_global_interval(
                ctable, Flusher(**FLUSH_KW, device="cpu"), wires,
                lambda: None)
            r["cpu_interval"] = cst
            r["vs_cpu"] = compare_flush(res.metrics, cres.metrics)
        rel = p99_errors(res.metrics, texts)
        r["p99_rel_err_median"] = float(np.median(rel))
        r["p99_rel_err_max"] = float(rel.max())
        check(r["p99_rel_err_median"] <= 0.01,
              f"{label}: median p99 error > 1%")
        out[label] = r
        shapes[label] = (lrec.table(), rec.table())
        if with_grpc and label == "flat":
            grpc_input = {"wires": [{"body": w["grpc"], "items": w["items"],
                                     "centroids": w["centroids"]}
                                    for w in wires],
                          "texts": texts, "http_metrics": res.metrics,
                          "encode_s": wt["grpc_encode_s"],
                          "bytes": wt["grpc_bytes"]}
        del wires, texts, table, res, runs
    out["cut"] = (f"the flat shape {intervals} timed interval(s) plus "
                  f"one profiled, the stacked shape one of {stack_wires} "
                  "wires; the wires are built once, outside the timed "
                  "window")
    emit(out)
    out["shapes"] = shapes
    if with_grpc:
        out["grpc_input"] = grpc_input
    return out


# ---- phase 8: the global tier over gRPC ----------------------------------

def run_grpc_interval(table, flusher, wires, sync):
    """One global interval over gRPC wires: each wire's bytes through
    ``decode_metric_list`` (the half a handler runs outside the server's
    lock) and ``apply_decoded`` (the locked half), a ``device_step``
    whenever staging passes the server's bound, then swap and flush.
    Returns (FlushResult, seconds by stage and what the interval did)."""
    from veneur_tpu_torch.forward import grpc_forward
    routes0, h2d0 = dict(table.routes), table.h2d_bytes
    hits0, misses0 = table.wire_plan_hits, table.wire_plan_misses
    t = {"decode_s": 0.0, "apply_s": 0.0, "device_step_s": 0.0}
    acc = dropped = steps = 0
    for w in wires:
        t0 = time.perf_counter()
        cols = grpc_forward.decode_metric_list(w["body"])
        t1 = time.perf_counter()
        check(cols is not None, "the native walker refused a wire")
        a, d = grpc_forward.apply_decoded(table, w["body"], cols)
        t2 = time.perf_counter()
        acc += a
        dropped += d
        if table.staged() >= table.config.histo_merge_samples:
            table.device_step()
            sync()
            steps += 1
        t3 = time.perf_counter()
        t["decode_s"] += t1 - t0
        t["apply_s"] += t2 - t1
        t["device_step_s"] += t3 - t2
    n_items = sum(w["items"] for w in wires)
    check(acc == n_items and dropped == 0,
          f"gRPC global accepted {acc} of {n_items} items, dropped "
          f"{dropped}")
    check(table.overflow_total() == 0, "the gRPC global overflowed")
    t0 = time.perf_counter()
    snap = table.swap()
    sync()
    t1 = time.perf_counter()
    res = flusher.flush(snap, now=1)
    t2 = time.perf_counter()
    t["swap_s"], t["flush_s"] = t1 - t0, t2 - t1
    t["total_s"] = sum(t.values())
    cents = sum(w["centroids"] for w in wires)
    t.update({"items": n_items, "centroids": cents,
              "items_per_s": n_items / t["total_s"],
              "centroids_per_s": cents / t["total_s"],
              "mid_interval_device_steps": steps,
              "wire_plan_hits": table.wire_plan_hits - hits0,
              "wire_plan_misses": table.wire_plan_misses - misses0,
              "routes": {k: v - routes0.get(k, 0)
                         for k, v in table.routes.items()
                         if v - routes0.get(k, 0)},
              "h2d_bytes": table.h2d_bytes - h2d0})
    return res, t


def hll_decode_seconds(wires) -> tuple[float, int]:
    """Seconds that ``hll_codec.decode`` alone takes over every set item
    of ``wires`` (the per-item part of ``apply_decoded``), and the item
    count."""
    from veneur_tpu_torch.forward import grpc_forward, hll_codec
    spans = []
    for w in wires:
        cols = grpc_forward.decode_metric_list(w["body"])
        sel = np.nonzero(cols["kind"][:cols["n"]] == 4)[0]
        spans.append((w["body"], cols["hll_off"][sel].tolist(),
                      cols["hll_len"][sel].tolist()))
    t0 = time.perf_counter()
    n = 0
    for body, offs, lens in spans:
        for o, ln in zip(offs, lens):
            hll_codec.decode(body[o:o + ln])
            n += 1
    return time.perf_counter() - t0, n


def without_gt(metrics) -> list:
    """The flush minus the global-only timers (``gt<i>``): a
    reference-schema /import wire carries no scope, so phase 6's HTTP
    global keeps those series on two rows where the gRPC wire's scope
    keeps one."""
    return [m for m in metrics if not m.name.startswith("gt")]


def phase_global_grpc(grpc_input: dict, dev: str = "cuda", scale: int = 1,
                      intervals: int = 2, profiled: bool = True,
                      cpu_reference: bool = True) -> dict:
    """Phase 6's flat shape (64 locals, 10,000 timer series) over gRPC:
    the same locals' rows as serialized MetricLists, decoded and merged
    by a fresh global table for ``intervals`` intervals plus one
    profiled; the second interval resends the same wires and must
    resolve every wire from the wire-plan cache.  Held against a CPU
    global on the same bytes, against phase 6's HTTP global and against
    the exact p99 of every local's samples."""
    import torch
    from veneur_tpu_torch.core.flusher import Flusher
    from veneur_tpu_torch.core.table import MetricTable, TableConfig

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    wires, texts = grpc_input["wires"], grpc_input["texts"]
    table = MetricTable(TableConfig(**table_sizes(scale)), device=dev)
    flusher = Flusher(**FLUSH_KW, device=dev)
    with MergeRecorder() as rec:
        runs = [run_grpc_interval(table, flusher, wires, sync)
                for _ in range(intervals)]
    res = runs[-1][0]
    for _, st in runs:
        check(st["routes"].get("wire_flat", 0) >= 1,
              f"the gRPC fold took no wire_flat: {st['routes']}")
    last = runs[-1][1]
    check(last["wire_plan_hits"] == len(wires) and
          last["wire_plan_misses"] == 0,
          f"interval {intervals} missed the wire-plan cache: "
          f"{last['wire_plan_hits']} hits, {last['wire_plan_misses']} misses")
    if dev == "cuda":
        check(rec.launches > 0, "the gRPC global launched no cluster merge "
                                "kernel")
    out = {"phase": "global_tier_grpc", "device": dev, "wires": len(wires),
           "timer_series": N_TIMER // scale,
           "wire_bytes": grpc_input["bytes"],
           "grpc_encode_s": grpc_input["encode_s"],
           "intervals": [st for _, st in runs],
           "cluster_merge_launches": rec.launches,
           "merge_shapes": rec.table()}
    out["hll_decode_s"], out["hll_items"] = hll_decode_seconds(wires)
    if profiled:
        out["profiled_interval"] = profile_device(
            lambda: run_grpc_interval(table, flusher, wires, sync))
    if cpu_reference:
        ctable = MetricTable(TableConfig(**table_sizes(scale)),
                             device="cpu")
        ctable.fused_import_mode = table.import_mode()
        cres, cst = run_grpc_interval(
            ctable, Flusher(**FLUSH_KW, device="cpu"), wires, lambda: None)
        out["cpu_interval"] = cst
        out["vs_cpu"] = compare_flush(res.metrics, cres.metrics)
    out["vs_http"] = compare_flush(without_gt(res.metrics),
                                   without_gt(grpc_input["http_metrics"]))
    check(any(m.name.startswith("gt") for m in res.metrics),
          "the gRPC global flushed no global-only timer")
    rel = p99_errors(res.metrics, texts)
    out["p99_rel_err_median"] = float(np.median(rel))
    out["p99_rel_err_max"] = float(rel.max())
    check(out["p99_rel_err_median"] <= 0.01, "gRPC: median p99 error > 1%")
    out["cut"] = ("two intervals plus one profiled; the MetricLists are "
                  "encoded once from phase 6's locals, outside the timed "
                  "window")
    emit(out)
    out["metrics"] = res.metrics  # phase 12 holds two globals to it
    return out


# ---- phase 12: the routing tiers ---------------------------------------------

PROXY_SERIES, PROXY_WIRE_ITEMS, PROXY_DESTS = 120_000, 10_000, 8
PROXY_PASSES, PROXY_ORACLE_PASSES = 3, 2   # the first of each warms up
OUTAGE_COOLDOWN_S = 2.0
# the wire fold phase 8's single global takes (its union of 10,000 rows
# is past half the plane: every interval routes ``wire_flat``), forced
# where phase 12 holds globals to it
FLAT_FOLD = "legacy"


def proxy_bench_wires(n_series: int = PROXY_SERIES) -> list[bytes]:
    """``bench.py --proxy-chain``'s wires: ``n_series`` series of every
    type enum, two tags each, in MetricLists of 10,000 items."""
    from veneur_tpu_torch.forward.gen import forward_pb2
    wires, ml = [], forward_pb2.MetricList()
    for i in range(n_series):
        m = ml.metrics.add()
        m.name = f"chain.m.{i}"
        m.type = i % 5
        m.tags.append(f"host:h{i % 64}")
        m.tags.append(f"az:z{i % 4}")
        if i % 5 == 0:
            m.counter.value = i
        if len(ml.metrics) == PROXY_WIRE_ITEMS:
            wires.append(ml.SerializeToString())
            ml = forward_pb2.MetricList()
    if len(ml.metrics):
        wires.append(ml.SerializeToString())
    return wires


def proxy_hop(n_series: int = PROXY_SERIES) -> dict:
    """(a) The proxy hop alone, sends stubbed: routed items/s on the
    columnar route and on the per-item oracle, the columnar phase split,
    and every item's destination held to the oracle's."""
    from veneur_tpu_torch.core.config import ProxyConfig
    from veneur_tpu_torch.core.proxy import ProxyServer
    from veneur_tpu_torch.forward import grpc_forward, ring as ringmod
    from veneur_tpu_torch.forward import route as routemod
    from veneur_tpu_torch.forward.gen import forward_pb2
    wires = proxy_bench_wires(n_series)
    dests = [f"10.255.0.{i}:8128" for i in range(PROXY_DESTS)]

    def make(columnar):
        px = ProxyServer(ProxyConfig(grpc_forward_address=",".join(dests),
                                     tpu_columnar_proxy=columnar,
                                     tpu_proxy_dest_queue=64))
        px._send_grpc_wire = lambda dest, body, metadata=None: None
        px._send_grpc = lambda dest, batch, trace_ctx=None: None
        return px

    out = {"series": n_series, "destinations": PROXY_DESTS,
           "wire_items": PROXY_WIRE_ITEMS, "wires": len(wires)}
    px = make(True)
    times, records = [], []
    try:
        for _ in range(PROXY_PASSES):
            t0 = time.perf_counter()
            for w in wires:
                px.route_pb_wire(w)
            times.append(time.perf_counter() - t0)
            want = px.ledger._cur.enqueued + px.ledger.summary()[
                "enqueued_total"]
            wait_for(lambda: px.destpool.totals()["sent_items"] >= want,
                     60, "the proxy's destination workers")
            rec = px.ledger.roll()
            check(rec.balanced and rec.routed == n_series and
                  rec.dropped == 0 and rec.busy_dropped == 0,
                  f"proxy ledger pass: {rec.to_dict()}")
            check(px.stats.get("columnar_fallbacks", 0) == 0,
                  "the columnar route fell back")
            records.append(rec.to_dict())
    finally:
        px.shutdown()
    px = make(False)
    oracle_times = []
    try:
        for _ in range(PROXY_ORACLE_PASSES):
            t0 = time.perf_counter()
            for w in wires:
                px.route_pb_wire(w)
            oracle_times.append(time.perf_counter() - t0)
        px._pool.shutdown(wait=True)
    finally:
        px.shutdown()
    ring = ringmod.ConsistentRing(dests)
    phases = {"decode_s": 0.0, "keyhash_s": 0.0, "assign_s": 0.0,
              "group_encode_s": 0.0}
    names = {0: "counter", 1: "gauge", 2: "histogram", 3: "set",
             4: "timer"}
    for w in wires:
        t0 = time.perf_counter()
        cols = grpc_forward.decode_metric_list(w)
        t1 = time.perf_counter()
        hashes = routemod.proxy_key_hashes(w, cols)
        t2 = time.perf_counter()
        ring.assign(hashes)
        t3 = time.perf_counter()
        routed = routemod.route_metric_list(w, ring)
        t4 = time.perf_counter()
        phases["decode_s"] += t1 - t0
        phases["keyhash_s"] += t2 - t1
        phases["assign_s"] += t3 - t2
        # route_metric_list redoes decode, hash and assign: the group
        # and re-encode share by subtraction, as bench.py takes it
        phases["group_encode_s"] += max(0.0, (t4 - t3) - (t3 - t0))
        # every item's destination: the routed bodies against the
        # oracle's per-item key walk
        got = [(routed.members[d], m.SerializeToString())
               for d, body, _n in routed.batches
               for m in forward_pb2.MetricList.FromString(body).metrics]
        want = sorted(
            (ring.get(f"{m.name}|{names.get(int(m.type), str(m.type))}|"
                      f"{','.join(m.tags)}"), m.SerializeToString())
            for m in forward_pb2.MetricList.FromString(w).metrics)
        check(sorted(got) == want, "a routed item left for another "
                                   "destination than the oracle's")
    col_s = float(np.median(times[1:]))
    oracle_s = float(np.median(oracle_times[1:]))
    out.update({"pass_s": times, "oracle_pass_s": oracle_times,
                "routed_items_per_s": n_series / col_s,
                "oracle_items_per_s": n_series / oracle_s,
                "speedup_vs_oracle": oracle_s / col_s,
                "phases": phases, "columnar_fallbacks": 0,
                "ledger_records": records, "destination_map": "oracle"})
    return out


class ImportTimer:
    """Seconds each in-process global spends in its gRPC handlers'
    decode (``decode_metric_list``, outside the lock) and apply
    (``apply_decoded``, under it), keyed by the global's table: a
    handler thread's decode is booked to the table its next apply
    names.  The wires each table applied are kept, in order."""

    def __enter__(self):
        import threading
        from veneur_tpu_torch.forward import grpc_forward as gf
        self._gf = gf
        self._orig = (gf.decode_metric_list, gf.apply_decoded)
        self.acc: dict = {}
        self.bodies: dict = {}
        tl = threading.local()
        bodies = self.bodies
        decode, apply = self._orig
        acc = self.acc

        def timed_decode(data):
            t0 = time.perf_counter()
            try:
                return decode(data)
            finally:
                tl.pending = getattr(tl, "pending", 0.0) + (
                    time.perf_counter() - t0)

        def timed_apply(table, data, cols):
            t0 = time.perf_counter()
            try:
                return apply(table, data, cols)
            finally:
                slot = acc.setdefault(id(table), {"decode_s": 0.0,
                                                  "apply_s": 0.0,
                                                  "wires": 0})
                slot["apply_s"] += time.perf_counter() - t0
                slot["decode_s"] += getattr(tl, "pending", 0.0)
                slot["wires"] += 1
                tl.pending = 0.0
                bodies.setdefault(id(table), []).append(data)
        gf.decode_metric_list = timed_decode
        gf.apply_decoded = timed_apply
        return self

    def __exit__(self, *exc):
        self._gf.decode_metric_list, self._gf.apply_decoded = self._orig
        return False

    def of(self, server) -> dict:
        return dict(self.acc.get(id(server.table), {}))

    def wires_of(self, server) -> list:
        return self.bodies.get(id(server.table), [])


def replay_global(dev: str, sizes: dict, fold: str, bodies: list) -> list:
    """A port global (no listener) fed ``bodies`` in order as a gRPC
    handler feeds them (decode, locked apply, the staging step), then
    flushed: a live global's interval folded again from what it
    received."""
    from veneur_tpu_torch.core.config import read_config
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.forward import grpc_forward as gf
    from veneur_tpu_torch.sinks.simple import CaptureSink
    cap = CaptureSink()
    srv = Server(read_config(data=dict(ROUTING_CFG, **sizes), env={}),
                 device=dev, extra_sinks=[cap])
    srv.table.fused_import_mode = fold
    try:
        for body in bodies:
            cols = gf.decode_metric_list(body)
            with srv.lock:
                gf.apply_decoded(srv.table, body, cols)
                work = srv._maybe_device_step_locked()
            srv._apply_staged(work)
        srv.flush_once()
    finally:
        srv.shutdown()
    return user_metrics(cap.metrics)


def start_global(dev: str, port: int = 0, sizes=None, fold=None):
    """A port global on ``dev`` with one gRPC listener on ``port`` (0:
    any; a port just released gets a bounded number of tries), its wire
    fold set to ``fold`` when given (``table.fused_import_mode``)."""
    from veneur_tpu_torch.core.config import read_config
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.sinks.simple import CaptureSink
    cap = CaptureSink()
    deadline = time.monotonic() + 30
    while True:
        try:
            g = Server(read_config(data=dict(
                ROUTING_CFG, **(sizes or {}),
                grpc_listen_addresses=[f"tcp://127.0.0.1:{port}"]),
                env={}), device=dev, extra_sinks=[cap])
            if fold is not None:
                g.table.fused_import_mode = fold
            g.start()
            return g, cap
        except RuntimeError as e:
            check(time.monotonic() < deadline, f"bind :{port}: {e}")
            time.sleep(0.2)


# the globals' and locals' flush settings: phase 8's (FLUSH_KW)
ROUTING_CFG = {"interval": "600s", "percentiles": [0.5, 0.9, 0.99],
               "aggregates": ["min", "max", "count", "sum"]}


def user_metrics(metrics) -> list:
    """A flush without the servers' own ``veneur.*`` telemetry and the
    span uniqueness sketch (``ssf.names_unique``: 1% of a global's
    ``import`` spans, sampled at random by the reference's design)."""
    return [m for m in metrics
            if not m.name.startswith(("veneur.", "ssf.names_unique"))]


def union_flush(caps_from) -> list:
    """The globals' flushes as one list; fails if a series flushed on
    two globals."""
    out = [m for ms in caps_from for m in user_metrics(ms)]
    keys = {(m.name, m.tags) for m in out}
    check(len(keys) == len(out), "a series flushed on two globals")
    return out


def compare_exact(got, want) -> None:
    """Two flushes with the same series and every value bit-equal."""
    g = {(m.name, m.tags): m.value for m in got}
    w = {(m.name, m.tags): m.value for m in want}
    check(g.keys() == w.keys(), "the flushes emit different series")
    diff = [k for k, v in w.items() if g[k] != v]
    check(not diff, f"{len(diff)} values differ, e.g. {diff[:1]}: "
                    f"{[(g[k], w[k]) for k in diff[:1]]}")


def pct_bit_equal(got, want) -> tuple[int, int]:
    """Percentile values bit-equal between two flushes, and how many."""
    w = {(m.name, m.tags): m.value for m in want
         if m.name.endswith("percentile")}
    g = {(m.name, m.tags): m.value for m in got
         if m.name.endswith("percentile")}
    return sum(1 for k, v in w.items() if g.get(k) == v), len(w)


def phase_routing(grpc_input: dict, single_metrics: list,
                  dev: str = "cuda", scale: int = 1,
                  proxy_series: int = PROXY_SERIES) -> dict:
    """Phase 12, the routing tiers: (a) the proxy hop at the reference's
    size; (b) phase 8's 64 wires through a port proxy over gRPC into two
    port globals on ``dev``: a warm interval with each global's own
    wire fold (on the card a global holding under half the plane takes
    the stacked fold, one merge per wire; phase 8's global took the
    flat one), then a timed interval with the globals folding flat, as
    phase 8's did.  Each union is held to phase 8's single global on
    the order-free values (bit for bit), sums and the exact p99; its
    percentiles are measured against phase 8's (a global merges its
    staged digests at 4Mi centroids, so its merges fall at other
    points than the single global's) and, in the timed interval, held
    bit for bit to each global's own wires folded again;
    (c) a sharded port local on ``dev`` forwarding to those globals
    through an outage of one (spool, breaker, replay on its restart)
    and a drain on shutdown, held to the same intervals forwarded to
    one global with no outage (every global folding flat, so the two
    runs fold alike)."""
    import grpc
    import torch
    from veneur_tpu_torch.core.config import ProxyConfig, read_config
    from veneur_tpu_torch.core.proxy import ProxyServer
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.forward import grpc_forward

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    sizes = {k: v for k, v in (
        ("tpu_counter_rows", 16384 // scale),
        ("tpu_gauge_rows", 16384 // scale),
        ("tpu_histo_rows", 16384 // scale),
        ("tpu_set_rows", 1024 // scale)) if scale > 1}
    out = {"phase": "routing_tiers", "device": dev}
    out["proxy_hop"] = proxy_hop(proxy_series)

    # -- (b) fleet -> proxy -> two globals --------------------------------
    wires = grpc_input["wires"]
    n_items = sum(w["items"] for w in wires)
    (ga, cap_a), (gb, cap_b) = start_global(dev, 0, sizes), \
        start_global(dev, 0, sizes)
    globals_ = (ga, gb)
    ports = [g.grpc_ports[0] for g in globals_]
    px = ProxyServer(ProxyConfig(
        grpc_address="127.0.0.1:0",
        grpc_forward_address=",".join(f"127.0.0.1:{p}" for p in ports),
        # every wire of an interval may queue for its destination
        tpu_proxy_dest_queue=len(wires)))
    px.start()
    client = grpc_forward.ForwardClient(f"127.0.0.1:{px.grpc_port}",
                                        timeout=60.0)
    fleet = {"wires": len(wires), "items": n_items,
             "centroids": sum(w["centroids"] for w in wires)}
    try:
        runs = []
        for label in ("warm", "timed"):
            if label == "timed":
                for g in globals_:
                    g.table.fused_import_mode = FLAT_FOLD
            base = [g.stats.get("imports_received", 0) for g in globals_]
            routes0 = [dict(g.table.routes) for g in globals_]
            n0 = [len(cap_a.metrics), len(cap_b.metrics)]
            with ImportTimer() as it, MergeRecorder() as rec:
                t0 = time.perf_counter()
                for w in wires:
                    client.send_wire(w["body"])
                t1 = time.perf_counter()
                wait_for(lambda: sum(g.stats.get("imports_received", 0)
                                     for g in globals_) - sum(base)
                         == n_items, 300, "the globals' imports")
                t2 = time.perf_counter()
                flush_s = []
                for g in globals_:
                    f0 = time.perf_counter()
                    g.flush_once()
                    sync()
                    flush_s.append(time.perf_counter() - f0)
            got = [g.stats.get("imports_received", 0) - b
                   for g, b in zip(globals_, base)]
            run = {"fold": [g.table.import_mode() for g in globals_],
                   "routes": [{k: v - r0.get(k, 0)
                               for k, v in g.table.routes.items()
                               if v - r0.get(k, 0)}
                              for g, r0 in zip(globals_, routes0)],
                   "send_s": t1 - t0, "routed_s": t2 - t0,
                   "proxy_items_per_s": n_items / (t2 - t0),
                   "items_by_global": got,
                   "globals": [dict(it.of(g), flush_s=f)
                               for g, f in zip(globals_, flush_s)],
                   "cluster_merge_launches": rec.launches,
                   "merge_shapes": rec.table()}
            check(all(n > 0 for n in got), f"a global got nothing: {got}")
            for g in globals_:
                led = g.ledger.last()
                check(led is not None and led.balanced and led.owed == 0,
                      f"a global's ledger: {led and led.to_dict()}")
            if dev == "cuda":
                check(rec.launches > 0, "the globals launched no merge")
            flushed = [cap_a.metrics[n0[0]:], cap_b.metrics[n0[1]:]]
            union = union_flush(flushed)
            run["vs_single_global"] = compare_flush(
                union, single_metrics, hold_percentiles=False)
            if label == "timed":
                # each global's flush, percentiles too, bit for bit
                # against its own wires folded again at its staging
                # points
                for g, ms in zip(globals_, flushed):
                    compare_exact(user_metrics(ms), replay_global(
                        dev, sizes, FLAT_FOLD, it.wires_of(g)))
                run["vs_replay"] = "bit-equal"
            run["percentiles_bit_equal"] = pct_bit_equal(union,
                                                         single_metrics)
            rel = p99_errors(union, grpc_input["texts"])
            run["p99_rel_err_median"] = float(np.median(rel))
            run["p99_rel_err_max"] = float(rel.max())
            check(run["p99_rel_err_median"] <= 0.01,
                  "median p99 error > 1%")
            runs.append(run)
        fleet["intervals"] = runs
        px._refresh_once()
        summ = px.ledger.summary()
        check(summ["imbalanced"] == 0 and summ["dropped_total"] == 0 and
              summ["busy_dropped_total"] == 0 and
              summ["routed_total"] == 2 * n_items and
              px.stats.get("columnar_fallbacks", 0) == 0,
              f"the proxy's ledger: {summ} {dict(px.stats)}")
        fleet["proxy_ledger"] = summ
    finally:
        client.close()
        px.shutdown()
    out["fleet"] = fleet

    # -- (c) a sharded local: an outage of B, its restart, a drain ---------
    texts = grpc_input["texts"]

    def feed(srv, text):
        lines = text.split(b"\n")
        for i in range(0, len(lines), SOAK_CHUNK):
            srv.handle_packet_batch(
                [], drained=b"\n".join(lines[i:i + SOAK_CHUNK]),
                drained_pkts=1)

    def settle(local, received, what):
        """Wait until ``received()`` counts every row ``local``
        forwarded."""
        wait_for(lambda: received() == local.stats["forward_post_metrics"],
                 120, what)

    addrs = [f"127.0.0.1:{p}" for p in ports]
    ride = {"cooldown_s": OUTAGE_COOLDOWN_S, "breaker_threshold": 1}
    with MergeRecorder() as rec:
        base = {id(g): g.stats.get("imports_received", 0)
                for g in globals_}
        n0 = [len(cap_a.metrics), len(cap_b.metrics)]
        local = Server(read_config(data=dict(
            ROUTING_CFG, **sizes, forward_use_grpc=True,
            tpu_sharded_global=True, forward_address=",".join(addrs),
            tpu_breaker_threshold=1,
            tpu_breaker_cooldown=f"{OUTAGE_COOLDOWN_S}s"), env={}),
            device=dev)
        t0 = time.perf_counter()
        feed(local, texts[0])
        local.flush_once()
        for g in globals_:
            g.flush_once()
        epoch1 = union_flush([cap_a.metrics[n0[0]:], cap_b.metrics[n0[1]:]])
        b_recv = gb.stats.get("imports_received", 0) - base[id(gb)]
        gb.shutdown()
        feed(local, texts[1])
        local.flush_once()
        fwd = local._sharded_fwd
        ride["breaker_after_outage"] = fwd.breaker_states()[addrs[1]]
        sp = fwd.spool_stats()
        ride["spool_after_outage"] = {k: sp[k] for k in (
            "spooled_wires", "spooled_items", "queued_wires")}
        check(ride["breaker_after_outage"]["state"] == "open" and
              sp["spooled_wires"] > 0 and
              local.stats.get("forward_spooled_async_items", 0) > 0,
              f"B's slice did not spool: {ride}")
        gb, cap_b2 = start_global(dev, ports[1], sizes, FLAT_FOLD)
        time.sleep(OUTAGE_COOLDOWN_S)
        grpc.channel_ready_future(
            fwd.client(addrs[1])._channel).result(60)
        feed(local, texts[2])
        local.flush_once()
        wait_for(lambda: fwd.spool_stats()["queued_wires"] == 0 and
                 gb.stats.get("replay_wires_received", 0) ==
                 sp["spooled_wires"], 60, "the spool's replay")
        feed(local, texts[3])
        local.shutdown()
        settle(local, lambda: (
            ga.stats.get("imports_received", 0) - base[id(ga)] + b_recv +
            gb.stats.get("imports_received", 0)), "the drain")
        n_a = len(cap_a.metrics)
        for g in (ga, gb):
            g.flush_once()
        epoch2 = union_flush([cap_a.metrics[n_a:], cap_b2.metrics])
        ride["seconds"] = time.perf_counter() - t0
        lkeys = ("forward_shard_wires", "forward_spooled_wires",
                 "forward_spooled_async_items", "replay_wires_sent",
                 "replay_items_sent", "drain_wires_sent",
                 "drain_items_sent", "drain_flushes", "metrics_dropped",
                 "forward_post_metrics")
        ride["local"] = {k: local.stats.get(k, 0) for k in lkeys}
        gkeys = ("imports_received", "drain_wires_received",
                 "replay_wires_received", "replay_items_received")
        ride["global_a"] = {k: ga.stats.get(k, 0) for k in gkeys}
        ride["global_b_restarted"] = {k: gb.stats.get(k, 0) for k in gkeys}
        protos = {}
        for g in (ga, gb):
            for r in g.ledger.records():
                for k, v in r.received.items():
                    if k.startswith("grpc-import"):
                        protos[k] = protos.get(k, 0) + v
        ride["global_ledger_protocols"] = protos
        check(ride["global_a"]["drain_wires_received"] == 1 and
              ride["global_b_restarted"]["drain_wires_received"] == 1,
              f"the drain did not reach both globals: {ride}")
        check(protos.get("grpc-import-replay", 0) > 0 and
              protos.get("grpc-import-drain", 0) > 0,
              f"replay and drain not booked as such: {protos}")
        sl = local._spool_ledger.summary()
        ride["spool_ledger"] = sl
        check(sl["queued_items"] == 0 and sl["inflight_items"] == 0 and
              sl["replayed_items"] + sl["expired_items"] ==
              sl["spooled_items"] and sl["imbalanced"] == 0,
              f"spool ledger: {sl}")
        for srv in (local, ga, gb):
            for r in srv.ledger.records():
                check(r.sealed and r.balanced and r.owed == 0,
                      f"a ledger record: {r.to_dict()}")
        check(local.stats.get("metrics_dropped", 0) == 0,
              "the local dropped rows")
    ride["cluster_merge_launches"] = rec.launches
    ride["merge_shapes"] = rec.table()
    ga.shutdown()
    gb.shutdown()
    # the same four intervals into one global, with no outage
    gc, cap_c = start_global(dev, 0, sizes, FLAT_FOLD)
    try:
        local = Server(read_config(data=dict(
            ROUTING_CFG, **sizes, forward_use_grpc=True,
            forward_address=f"127.0.0.1:{gc.grpc_ports[0]}"), env={}),
            device=dev)
        for i in range(4):
            feed(local, texts[i])
            if i < 3:
                local.flush_once()
            if i == 0:
                gc.flush_once()
                n1 = len(cap_c.metrics)
        local.shutdown()
        settle(local, lambda: gc.stats.get("imports_received", 0),
               "the baseline's drain")
        gc.flush_once()
        base1 = user_metrics(cap_c.metrics[:n1])
        base2 = user_metrics(cap_c.metrics[n1:])
    finally:
        gc.shutdown()
    ride["vs_no_outage"] = [compare_flush(epoch1, base1),
                            compare_flush(epoch2, base2)]
    ride["percentiles_bit_equal"] = [pct_bit_equal(epoch1, base1),
                                     pct_bit_equal(epoch2, base2)]
    out["outage"] = ride
    out["cluster_merge_launches"] = (sum(
        r["cluster_merge_launches"] for r in fleet["intervals"])
        + ride["cluster_merge_launches"])
    out["cut"] = ("(a) 3 columnar passes and 2 oracle passes (bench.py: "
                  "5 and 3), the first of each a warm-up; (b) one warm and "
                  "one timed interval; (c) four intervals of four of "
                  "phase 6's local shares and their no-outage baseline")
    emit(out)
    shapes = [m for r in fleet["intervals"] for m in r["merge_shapes"]]
    out["merge_shapes"] = merge_tables(shapes + ride["merge_shapes"])
    return out


def merge_tables(tables) -> list:
    """Sum (rows, k, calls) tables."""
    acc: dict = {}
    for m in tables:
        acc[(m["rows"], m["k"])] = acc.get((m["rows"], m["k"]), 0) + \
            m["calls"]
    return [{"rows": r, "k": k, "calls": c}
            for (r, k), c in sorted(acc.items())]


# ---- phase 13: crash riding -------------------------------------------------

# (a) bench.py --overload, non-QUICK: offered non-counter lines, counters,
# Zipf(1.5) tenants
OVL_OFFERED, OVL_COUNTERS, OVL_TENANTS = 40_000, 10_000, 20
# (b) phase 4's 10,000 timer series, gamma(2, 30); samples per series cut
# from phase 4's 1,000 to 300 (every row still deeper than the widest
# ladder width, 256)
LADDER_SERIES, LADDER_SAMPLES = 10_000, 300
# (c) bench.py _chaos_crash(3000); the card's recovery fold: a crashed
# global's staged timers
CRASH_PACKETS, CRASH_CKPT_S = 3000, 0.3
RECOVERY_SERIES, RECOVERY_SAMPLES = 2000, 64
# (d) bench.py _chaos_scale_out(1200, 48, 256)
SO_COUNTERS, SO_HISTO, SO_SET_SAMPLES = 1200, 48, 256


def flight_summary(flight) -> dict:
    """``bench.py``'s ``_flight_summary`` on the port's recorder: settle
    the writer, then read every retained bundle back through its CRC
    framing and count those carrying a ledger record and a trace."""
    from veneur_tpu_torch.observe.recorder import read_bundle
    if flight is None:
        return {"bundles_total": 0, "by_trigger": {}, "retained": 0,
                "crc_verified": 0, "with_ledger_record": 0,
                "with_trace": 0, "errors_total": 0}
    flight.drain()
    deadline = time.monotonic() + 5.0
    st, stable = flight.stats(), None
    while time.monotonic() < deadline:
        snap = (st["bundles_total"], st["retained"], st["errors_total"])
        if snap == stable and flight._q.empty():
            break
        stable = snap
        time.sleep(0.05)
        st = flight.stats()
    crc = led = trace = 0
    for meta in flight.list_bundles():
        blob = flight.get(meta["name"])
        parsed = read_bundle(blob) if blob is not None else None
        if parsed is None:
            continue
        crc += 1
        ctx = parsed[1].get("context") or {}
        led += bool(ctx.get("ledger_records"))
        trace += bool(ctx.get("trace"))
    return {"bundles_total": st["bundles_total"],
            "by_trigger": st["by_trigger"],
            "errors_total": st["errors_total"], "retained": st["retained"],
            "crc_verified": crc, "with_ledger_record": led,
            "with_trace": trace}


def flight_ok(f: dict, trigger: str, context: bool = True) -> bool:
    """A leg's recorder dumped a CRC-clean bundle naming ``trigger``
    (and, from a server, every bundle carries its ledger record and at
    least one its trace)."""
    ok = (f["by_trigger"].get(trigger, 0) >= 1 and f["retained"] >= 1
          and f["crc_verified"] == f["retained"] and f["errors_total"] == 0)
    if context:
        ok = ok and (f["with_ledger_record"] == f["retained"]
                     and f["with_trace"] >= 1)
    return ok


def overload_soak(dev: str) -> dict:
    """(a) ``bench.py --overload`` at its non-QUICK size through a port
    ``Server`` on ``dev``: phase A, Zipf tenants against their token
    buckets; phase B, the pressure tiers the phase A flush engaged
    (new-series freeze, class sampling, the width ladder at level 3);
    phase C, a flush slowed past its budget, then the coalesced tick
    and the one swap that covers both intervals.  The reference's gates
    and its flight-recorder gates."""
    from veneur_tpu_torch.core.config import read_config
    from veneur_tpu_torch.core.server import Server
    srv = Server(read_config(data={
        "interval": "1s", "hostname": "bench-overload",
        "tpu_overload_tenant_rate": 50.0,
        "tpu_overload_tenant_burst": 50.0,
        "tpu_overload_max_tenants": 64,
        "tpu_overload_occupancy_hi": 0.05,
        "tpu_gauge_rows": 4096, "tpu_flight_cooldown": "0s"}, env={}),
        device=dev)
    rng = np.random.default_rng(20260806)
    counted = [0.0]

    def feed(lines):
        for i in range(0, len(lines), 128):
            srv.handle_packet_batch([b"\n".join(lines[i:i + 128])])

    def flush():
        res = srv.flush_once()
        counted[0] += sum(m.value for m in res.metrics
                          if m.name.startswith("ovl.count."))
        return srv.ledger.last()

    out = {"offered_noncounter": OVL_OFFERED, "tenants": OVL_TENANTS,
           "offered_counters": 0}
    rec = MergeRecorder().__enter__()
    try:
        flush()  # the idle baseline row the pressure transition needs
        z = np.minimum(rng.zipf(1.5, size=OVL_OFFERED), OVL_TENANTS)
        lines = []
        for i, t in enumerate(z):
            c = i % 3
            if c == 0:
                lines.append(b"ovl.timer.%d:%d|ms|#tenant:t%d"
                             % (i % 50, i % 997, t))
            elif c == 1:
                lines.append(b"ovl.gauge.%d:%d|g|#tenant:t%d"
                             % (i % 50, i, t))
            else:
                lines.append(b"ovl.set.%d:m%d|s|#tenant:t%d"
                             % (i % 20, i, t))
        counters_a = [b"ovl.count.%d:1|c|#tenant:t%d"
                      % (i % 16, (i % OVL_TENANTS) + 1)
                      for i in range(OVL_COUNTERS)]
        out["offered_counters"] += OVL_COUNTERS
        t0 = time.perf_counter()
        feed(lines)
        feed(counters_a)
        out["ingest_seconds_a"] = time.perf_counter() - t0
        rec_a = flush()
        out["phase_a"] = {"shed": rec_a.shed,
                          "admitted_noncounter": OVL_OFFERED - rec_a.shed,
                          "balanced": rec_a.balanced}
        engaged_a = srv.overload.pressure.engaged

        width_base = srv.table._eff_histo_slots_base
        lines_b = [b"ovl.fresh.%d:1|g|#tenant:t%d"
                   % (i, (i % OVL_TENANTS) + 1)
                   for i in range(OVL_OFFERED // 8)]
        lines_b += [b"ovl.timer.%d:%d|ms|#tenant:t%d"
                    % (i % 50, i, (i % OVL_TENANTS) + 1)
                    for i in range(OVL_OFFERED // 8)]
        counters_b = [b"ovl.count.%d:1|c|#tenant:t%d"
                      % (i % 16, (i % OVL_TENANTS) + 1)
                      for i in range(OVL_COUNTERS // 4)]
        out["offered_counters"] += OVL_COUNTERS // 4
        feed(lines_b)
        feed(counters_b)
        rec_b = flush()
        out["phase_b"] = {"shed": rec_b.shed, "balanced": rec_b.balanced,
                          "pressure_engaged_entering": engaged_a,
                          "pressure": srv.overload.pressure.to_dict(),
                          "histo_width_base": int(width_base),
                          "histo_width_now":
                              int(srv.table._eff_histo_slots)}

        # the synchronous pipeline (not a sink) overruns the budget
        orig = srv.flusher.flush

        def slow_flush(*a, **kw):
            time.sleep(max(1.0 * 0.9, 1.0) + 0.6)
            return orig(*a, **kw)
        srv.flusher.flush = slow_flush
        flush()
        srv.flusher.flush = orig
        counters_c = [b"ovl.count.%d:1|c|#tenant:t1" % (i % 16,)
                      for i in range(OVL_COUNTERS // 4)]
        out["offered_counters"] += OVL_COUNTERS // 4
        feed(counters_c)
        flush()  # coalesced: no swap
        skipped = srv.stats.get("flush_coalesced", 0)
        rec_cover = flush()
        out["phase_c"] = {"flush_overruns": srv.overload.flush_overruns,
                          "coalesced_ticks": skipped,
                          "cover_coalesced": rec_cover.coalesced,
                          "cover_balanced": rec_cover.balanced}
        ledsum = srv.ledger.summary()
        out["overload"] = srv.overload.snapshot()
        out["flight"] = flight_summary(srv.flight)
    finally:
        rec.__exit__(None, None, None)
        srv.shutdown()
    out["cluster_merge_launches"] = rec.launches
    out["merge_shapes"] = rec.table()
    shed_by = ledsum.get("shed_by", {})
    reasons = {r for t in shed_by.values() for r in t}
    admitted = OVL_OFFERED - rec_a.shed
    unattributed = (ledsum["imbalanced"] + ledsum["owed_total"]
                    + ledsum.get("shed_owed_total", 0))
    out.update(shed_total=ledsum.get("shed_total", 0), shed_by=shed_by,
               flushed_counter_sum=counted[0],
               unattributed_lost=int(unattributed))
    gates = {
        "unattributed_zero": unattributed == 0,
        "ledgers_balanced": ledsum["imbalanced"] == 0,
        "overloaded_2x": OVL_OFFERED >= 2 * max(admitted, 1),
        "shed_nonempty": ledsum.get("shed_total", 0) > 0,
        "shed_fully_attributed": (
            ledsum.get("shed_owed_total", 1) == 0
            and all(t and r for t in shed_by for r in shed_by[t])),
        "counters_never_shed": not any(
            "count" in r for t in shed_by.values() for r in t),
        "counters_conserved_exactly":
            counted[0] == float(out["offered_counters"]),
        "pressure_engaged": engaged_a,
        "series_freeze_fired": "series_freeze" in reasons,
        "pressure_class_shed_fired": any(r.startswith("pressure:")
                                         for r in reasons),
        "width_ladder_engaged":
            out["phase_b"]["histo_width_now"] < width_base,
        "flush_overrun_observed": out["phase_c"]["flush_overruns"] >= 1,
        "coalesce_named_in_ledger": rec_cover.coalesced >= 1,
        "coalesced_tick_counted": skipped >= 1,
        "flight_pressure_change": flight_ok(out["flight"],
                                            "pressure_change", False),
        "flight_flush_overrun": flight_ok(out["flight"], "flush_overrun",
                                          False),
    }
    out["gates"] = gates
    return out


def ladder_text(seed: int = 13) -> list[bytes]:
    """Phase 4's timer series (``t<i>``, tagged ``env:smoke``, gamma(2,
    30)) at LADDER_SAMPLES each, shuffled, in CHUNK-line buffers."""
    rng = np.random.default_rng(seed)
    n = LADDER_SERIES * LADDER_SAMPLES
    series = rng.integers(0, LADDER_SERIES, n).tolist()
    vals = rng.gamma(2.0, 30.0, n).tolist()
    names = [b"t%d:" % i for i in range(LADDER_SERIES)]
    tail = b"|ms" + TAGS
    lines = [b"%s%.3f%s" % (names[i], v, tail) for i, v in zip(series, vals)]
    return [b"\n".join(lines[lo:lo + CHUNK]) for lo in range(0, n, CHUNK)]


def width_ladder(dev: str, sync) -> dict:
    """(b) A table at the server's default sizes (16384 histo rows,
    616-slot digests, the deep batch at ``histo_merge_samples``) flushed
    once at each pressure level 0-3 on the card and on the CPU, on the
    same text: order-free values bit for bit (sums too), percentiles
    within rtol 2e-3 / atol 1e-3; each level's median and maximum p99
    error against the exact p99 (reported, not gated: the ladder trades
    precision by design; the p50 beside it) and the (rows, K) of every
    card merge."""
    from veneur_tpu_torch.core.flusher import Flusher
    from veneur_tpu_torch.core.table import MetricTable, TableConfig
    t0 = time.perf_counter()
    bufs = ladder_text()
    exact = exact_quantiles(bufs, 0.99)
    exact50 = exact_quantiles(bufs, 0.5)
    out = {"series": LADDER_SERIES, "samples_per_series": LADDER_SAMPLES,
           "gen_s": time.perf_counter() - t0, "levels": {}}
    cfg = dict(counter_rows=16384, gauge_rows=16384, histo_rows=16384,
               set_rows=1024)
    launches, shapes = 0, []
    for level in (0, 1, 2, 3):
        table = MetricTable(TableConfig(**cfg), device=dev)
        table.set_pressure_level(level)
        with MergeRecorder() as rec:
            res, n, st = run_interval(table, Flusher(device=dev), bufs, sync)
        ctable = MetricTable(TableConfig(**cfg), device="cpu")
        ctable.set_pressure_level(level)
        cres, _, _ = run_interval(ctable, Flusher(device="cpu"), bufs,
                                  lambda: None)
        check(table._eff_histo_slots == ctable._eff_histo_slots,
              "ladder widths differ between the card and the CPU")
        rel = p99_errors(res.metrics, bufs, exact)
        rel50 = p99_errors(res.metrics, bufs, exact50, pct=50)
        out["levels"][level] = {
            "eff_histo_slots": table._eff_histo_slots, "samples": n,
            "parse_ingest_s": st["parse_ingest_s"],
            "device_step_s": st["device_step_s"],
            "flush_s": st["flush_s"], "routes": st["routes"],
            "vs_cpu": compare_flush(res.metrics, cres.metrics,
                                    sums_exact=True),
            "p99_rel_err_median": float(np.median(rel)),
            "p99_rel_err_max": float(rel.max()),
            "p50_rel_err_median": float(np.median(rel50)),
            "p50_rel_err_max": float(rel50.max()),
            "cluster_merge_launches": rec.launches,
            "merge_shapes": rec.table()}
        launches += rec.launches
        shapes += rec.table()
        del table, ctable, res, cres
    ks = {m["k"] for lv in out["levels"].values() for m in lv["merge_shapes"]}
    check({256, 128, 64} <= ks, f"the ladder merged at K = {sorted(ks)}")
    out["cluster_merge_launches"] = launches
    out["merge_shapes"] = shapes
    return out


_CRASH_CHILD = r"""
import json, signal, sys, time
from veneur_tpu_torch.core.config import read_config
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.ops import cluster_merge
ckdir, fwd, dev = sys.argv[1:4]
s = Server(read_config(data={
    "statsd_listen_addresses": ["udp://127.0.0.1:0"],
    "grpc_listen_addresses": [],
    "interval": "500ms", "hostname": "crash-local",
    "forward_address": fwd, "forward_use_grpc": True,
    "tpu_checkpoint_dir": ckdir,
    "tpu_checkpoint_interval": "300ms"}), device=dev)
if dev == "cuda":
    # the built kernel loads (from the checkout's _build/) before READY
    cluster_merge.occupancy(s.table.capacity, 512)
s.start()
print("READY", s.statsd_ports[0], s.incarnation, s.restarts_adopted,
      flush=True)
stop = []
signal.signal(signal.SIGTERM, lambda *_a: stop.append(1))
while not stop:
    time.sleep(0.05)
s.shutdown()
ov = s.overload.snapshot()
print(json.dumps({"flush_overruns": ov["flush_overruns"],
                  "coalesced_total": ov["coalesced_total"],
                  "flushes": s.stats.get("flushes", 0),
                  "compile_total":
                      s.device_costs.totals()["compile_total"]}),
      flush=True)
"""


def crash_leg(dev: str) -> dict:
    """(c) ``bench.py``'s ``_chaos_crash(3000)`` on the card.  This
    process plays the master: it binds the UDP socket once and cloaks
    it into each child (``VENEUR_TPU_SOCK_CLOAKED`` + ``pass_fds``);
    each child is a port local on ``dev`` (500 ms interval, 300 ms
    checkpoints) forwarding over gRPC to a port global here.  The first
    child is SIGKILLed once a fresh segment covers recent ingest,
    datagrams go into the dead window (the kernel queue holds them),
    the second child adopts the socket, recovers the segment over the
    wire flagged recovery, and drains on SIGTERM.  The reference's seven
    ``crash_*`` gates and its flight gate."""
    import shutil
    from veneur_tpu_torch.core import overload as ovl
    from veneur_tpu_torch.core.config import read_config
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.ops import checkpoint as ckpt
    from veneur_tpu_torch.ops import fdpass
    from veneur_tpu_torch.sinks.simple import CaptureSink
    out: dict = {"n_packets": CRASH_PACKETS,
                 "checkpoint_interval": CRASH_CKPT_S}
    cap = CaptureSink()
    g = Server(read_config(data={
        "grpc_listen_addresses": ["tcp://127.0.0.1:0"],
        "statsd_listen_addresses": [], "interval": "30s",
        "hostname": "crash-g", "tpu_flight_cooldown": "0s"}, env={}),
        device=dev, extra_sinks=[cap])
    g.start()
    g.flush_once()  # the baseline signal row
    fwd_addr = f"127.0.0.1:{g.grpc_ports[0]}"
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    rcvbuf = sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)
    dead_budget = max(50, rcvbuf // 1024)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    ckdir = tempfile.mkdtemp(prefix=".smoke-crash-", dir=HERE)
    env = dict(os.environ)
    env[fdpass.ENV_VAR] = fdpass.socket_cloak({"statsd.udp.0.0": sock})
    env["VENEUR_TPU_CHECKPOINT_INTERVAL"] = f"{CRASH_CKPT_S}s"
    errlog = open(os.path.join(ckdir, "children.log"), "ab")
    sent = []

    def spawn():
        t0 = time.perf_counter()
        p = subprocess.Popen(
            [sys.executable, "-c", _CRASH_CHILD, ckdir, fwd_addr, dev],
            stdout=subprocess.PIPE, stderr=errlog, env=env,
            pass_fds=[sock.fileno()], cwd=HERE)
        line = p.stdout.readline().split()
        check(line and line[0] == b"READY", f"child said {line}")
        return p, int(line[1]), int(line[2]), int(line[3]), \
            time.perf_counter() - t0

    def blast(n, names=32, batch=20, gap=0.004):
        i = 0
        while i < n:
            k = min(batch, n - i)
            for j in range(k):
                tx.sendto(b"crash.%d:1|c|#veneurglobalonly"
                          % ((i + j) % names), ("127.0.0.1", port))
            sent.append((time.time(), k))
            i += k
            time.sleep(gap)

    procs = []
    rec = MergeRecorder().__enter__()
    try:
        p1, p1_port, p1_inc, p1_adopted, p1_s = spawn()
        procs.append(p1)
        check(p1_port == port, f"first child bound {p1_port}, not {port}")
        out["first_child"] = {"incarnation": p1_inc,
                              "fds_adopted": p1_adopted, "ready_s": p1_s}
        blast(int(0.55 * CRASH_PACKETS))
        deadline = time.time() + 15
        while time.time() < deadline:
            segs = [s for s in ckpt.scan_recoverable(ckdir, 0, max_age=60)
                    if s.header.get("incarnation") == p1_inc
                    and int(s.header.get("items", 0)) > 0]
            if segs and time.time() - segs[-1].header["wall"] < 1.0:
                break
            blast(10)
            time.sleep(0.02)
        os.kill(p1.pid, signal.SIGKILL)
        kill_wall = time.time()
        p1.wait(10)
        segs = [s for s in ckpt.scan_recoverable(ckdir, 0, max_age=60)
                if s.header.get("incarnation") == p1_inc]
        last_ckpt_wall = max((float(s.header["wall"]) for s in segs),
                             default=0.0)
        out["surviving_segments"] = len(segs)
        out["surviving_items"] = sum(int(s.header.get("items", 0))
                                     for s in segs)
        t_dead = time.perf_counter()
        blast(min(int(0.15 * CRASH_PACKETS), dead_budget))
        p2, p2_port, p2_inc, p2_adopted, p2_s = spawn()
        procs.append(p2)
        out["dead_window_s"] = time.perf_counter() - t_dead
        check(p2_port == port, f"second child bound {p2_port}")
        out["second_child"] = {"incarnation": p2_inc,
                               "fds_adopted": p2_adopted, "ready_s": p2_s}
        blast(CRASH_PACKETS - sum(n for _w, n in sent))
        time.sleep(2 * CRASH_CKPT_S)
        p2.send_signal(signal.SIGTERM)
        p2.wait(60)
        tail = p2.stdout.read().decode().strip().splitlines()
        out["second_child"]["overload"] = json.loads(tail[-1])
        deadline = time.time() + 10
        landed = prev = -1
        while time.time() < deadline:
            g.flush_once()
            landed = int(sum(m.value for m in cap.metrics
                             if m.name.startswith("crash.")
                             and m.type == "counter"))
            if landed == prev:
                break
            prev = landed
            time.sleep(0.3)
        offered = sum(n for _w, n in sent)
        out.update(offered_items=offered, landed_items=landed,
                   unattributed_lost=offered - landed,
                   loss_bound_items=sum(
                       n for w, n in sent
                       if last_ckpt_wall - 0.1 <= w <= kill_wall),
                   kernel_drops=sum(ovl.read_kernel_drops([sock])
                                    .values()))
        for k in ("recovery_wires_received", "recovery_items_received",
                  "recovery_wires_deduped", "drain_wires_received"):
            out[k] = g.stats.get(k, 0)
        led = g.ledger.summary()
        out["global_ledger"] = {k: led.get(k) for k in (
            "imbalanced", "recovered_total", "intervals")}
        out["recovered_total"] = led.get("recovered_total", 0)
        out["flight"] = flight_summary(g.flight)
    finally:
        rec.__exit__(None, None, None)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
            p.stdout.close()
        errlog.close()
        tx.close()
        sock.close()
        g.shutdown()
        shutil.rmtree(ckdir, ignore_errors=True)
    out["cluster_merge_launches"] = rec.launches
    out["merge_shapes"] = rec.table()
    out["gates"] = {
        "crash_kernel_drops_zero": out["kernel_drops"] == 0,
        "crash_fd_adopted": out["second_child"]["fds_adopted"] >= 1,
        "crash_recovery_flagged": out["recovery_wires_received"] >= 1,
        "crash_no_double_delivery": out["unattributed_lost"] >= 0,
        "crash_unattributed_bounded":
            out["unattributed_lost"] <= out["loss_bound_items"],
        "crash_recovered_credited": out["recovered_total"] > 0,
        "crash_ledger_balanced": out["global_ledger"]["imbalanced"] == 0,
        "flight_crash_recovery_replay":
            flight_ok(out["flight"], "recovery_replay"),
    }
    return out


def recovery_fold(dev: str) -> dict:
    """(c) continued: the recovery fold on the card.  A global's staged
    timers (RECOVERY_SERIES x RECOVERY_SAMPLES) checkpointed, the
    server shut down (the crash), and a new incarnation on ``dev``
    recovering the segment through its import fold; held against a CPU
    server recovering a copy of the same directory (order-free values
    bit for bit, percentiles within rtol 2e-3 / atol 1e-3)."""
    import shutil
    from veneur_tpu_torch.core.config import read_config
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.sinks.simple import CaptureSink
    rng = np.random.default_rng(17)
    n = RECOVERY_SERIES * RECOVERY_SAMPLES
    series = rng.integers(0, RECOVERY_SERIES, n).tolist()
    vals = rng.gamma(2.0, 30.0, n).tolist()
    text = b"\n".join(b"rc%d:%.3f|ms" % (i, v) for i, v in zip(series, vals))
    base = tempfile.mkdtemp(prefix=".smoke-recovery-", dir=HERE)
    data = {"statsd_listen_addresses": [], "grpc_listen_addresses": [],
            "interval": "600s", "hostname": "rc",
            "percentiles": [0.5, 0.9, 0.99],
            "tpu_checkpoint_interval": "600s"}
    out = {"series": RECOVERY_SERIES, "samples": n}
    try:
        d = os.path.join(base, "card")
        s1 = Server(read_config(data=dict(data, tpu_checkpoint_dir=d),
                                env={}), device=dev)
        s1.start()
        s1.handle_packet_batch([], drained=text, drained_pkts=1)
        check(s1._checkpointer.run_once() is not None, "no segment")
        out["segment_bytes"] = s1._checkpointer.stats["bytes"]
        s1.shutdown()
        shutil.copytree(d, os.path.join(base, "cpu"))
        flushes = {}
        for label, where in (("card", dev), ("cpu", "cpu")):
            cap = CaptureSink()
            s2 = Server(read_config(data=dict(
                data, tpu_checkpoint_dir=os.path.join(base, label)),
                env={}), device=where, extra_sinks=[cap])
            if label == "card":
                with MergeRecorder() as rec:
                    s2.start()
                    s2.flush_once()
                out["cluster_merge_launches"] = rec.launches
                out["merge_shapes"] = rec.table()
            else:
                s2.start()
                s2.flush_once()
            check(s2.stats.get("recovery_items_replayed") == n,
                  f"{label}: replayed {s2.stats}")
            rec2 = s2.ledger.last()
            check(rec2.balanced and rec2.recovered > 0,
                  f"{label}: {rec2.to_dict()}")
            s2.shutdown()
            flushes[label] = user_metrics(cap.metrics)
        out["vs_cpu"] = compare_flush(flushes["card"], flushes["cpu"])
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return out


def scale_out_leg(dev: str) -> dict:
    """(d) ``bench.py``'s ``_chaos_scale_out(1200, 48, 256)``: an
    incumbent port global on ``dev`` holding the keyspace hands the
    arcs of a second port global (``arc_handoff``) over the import wire
    flagged handoff; the four ``scaleout_*`` gates and the flight gate,
    and the union of the two flushes held to one global's flush of the
    same datagrams: every order-free value bit for bit, percentiles
    measured (a handed-off digest is merged once more on its new
    owner)."""
    from veneur_tpu_torch.core.config import read_config
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.sinks.simple import CaptureSink

    def mk(cap, name):
        g = Server(read_config(data={
            "grpc_listen_addresses": ["tcp://127.0.0.1:0"],
            "statsd_listen_addresses": [], "interval": "30s",
            "hostname": name, "tpu_flight_cooldown": "0s"}, env={}),
            device=dev, extra_sinks=[cap])
        g.start()
        return g

    def feed(g):
        for i in range(SO_COUNTERS):
            g.handle_packet(b"scale.c.%d:%d|c" % (i, i))
        for i in range(SO_HISTO * 16):
            g.handle_packet(b"scale.h.%d:%d|h" % (i % SO_HISTO, i % 97))
        for i in range(SO_SET_SAMPLES):
            g.handle_packet(b"scale.s.%d:u%d|s" % (i % 8, i))

    out: dict = {"n_counters": SO_COUNTERS, "n_histo": SO_HISTO,
                 "n_set_samples": SO_SET_SAMPLES}
    caps = [CaptureSink(), CaptureSink()]
    g0, g1 = mk(caps[0], "scale-g0"), mk(caps[1], "scale-g1")
    try:
        addrs = [f"127.0.0.1:{g.grpc_ports[0]}" for g in (g0, g1)]
        with MergeRecorder() as rec:
            feed(g0)
            g1.flush_once()  # the receiver's baseline signal row
            ho = g0.arc_handoff(addrs, addrs[0])
            g1.flush_once()
        out["handoff"] = ho
        out["cluster_merge_launches"] = rec.launches
        out["merge_shapes"] = rec.table()
        names, double = {}, 0
        for cap in caps:
            for m in cap.metrics:
                if not m.name.startswith("scale."):
                    continue
                key = (m.name, m.type)
                double += key in names
                names[key] = names.get(key, 0.0) + m.value
        rec0, rec1 = g0.ledger.last(), g1.ledger.last()
        out.update(
            counter_mass=sum(v for (k, t), v in names.items()
                             if k.startswith("scale.c.")
                             and t == "counter"),
            counter_mass_expected=sum(range(SO_COUNTERS)),
            double_emitted_series=double,
            histo_medians_seen=sum(1 for (k, _t) in names
                                   if k.startswith("scale.h.")
                                   and k.endswith("50percentile")),
            sender_ledger_balanced=bool(rec0 and rec0.balanced),
            receiver_ledger_balanced=bool(rec1 and rec1.balanced),
            handoff_wires_received=g1.stats.get("handoff_wires_received",
                                                0),
            reshard_received_items=rec1.reshard_received_items,
            flight=flight_summary(g1.flight))
        union = union_flush([c.metrics for c in caps])
    finally:
        g0.shutdown()
        g1.shutdown()
    one = CaptureSink()
    g = mk(one, "scale-one")
    try:
        feed(g)
        g.flush_once()
    finally:
        g.shutdown()
    single = {(m.name, m.tags): m for m in user_metrics(one.metrics)}
    u = {(m.name, m.tags): m for m in union}
    check(set(u) <= set(single), "the union emits a series one global "
                                 "does not")
    # a handed-off histogram is imported state on its new owner: it
    # emits percentiles, not the local-sample aggregates
    missing = set(single) - set(u)
    check(all(k[0].startswith("scale.h.") and "percentile" not in k[0]
              for k in missing), f"the union lost {sorted(missing)[:3]}")
    out["vs_single"] = compare_flush(
        union, [single[k] for k in u], hold_percentiles=False,
        sums_exact=True)
    out["mass_conserved"] = bool(
        out["counter_mass"] == out["counter_mass_expected"]
        and double == 0 and out["histo_medians_seen"] == SO_HISTO
        and ho.get("errors", 1) == 0 and ho.get("dropped_items", 1) == 0)
    out["gates"] = {
        "scaleout_mass_conserved": out["mass_conserved"],
        "scaleout_handoff_flagged": out["handoff_wires_received"] >= 1,
        "scaleout_arrival_credited": (
            out["reshard_received_items"] == ho.get("items", -1)
            and out["reshard_received_items"] > 0),
        "scaleout_ledgers_balanced": (out["sender_ledger_balanced"]
                                      and out["receiver_ledger_balanced"]),
        "flight_scaleout_handoff": flight_ok(out["flight"], "handoff"),
    }
    return out


def phase_crash_riding(dev: str = "cuda") -> dict:
    """Phase 13: the reference's overload and chaos soaks at their
    non-QUICK sizes on the card, one line of gates a leg; every gate
    must hold.  Each leg reads its own cluster-merge launches (set to 0
    as it starts): the sample merges of legs (a) and (b), the import
    folds of (c) and (d)."""
    import torch

    def sync():
        torch.cuda.synchronize()
    out = {"phase": "crash_riding", "device": dev, "legs": {}}
    legs = (("overload", lambda: overload_soak(dev), False),
            ("width_ladder", lambda: width_ladder(dev, sync), False),
            ("crash", lambda: crash_leg(dev), True),
            ("recovery_fold", lambda: recovery_fold(dev), True),
            ("scale_out", lambda: scale_out_leg(dev), True))
    launches, unit, weighted = 0, [], []
    for name, fn, fold in legs:
        t0 = time.perf_counter()
        res = fn()
        res["seconds"] = time.perf_counter() - t0
        launches += res["cluster_merge_launches"]
        (weighted if fold else unit).extend(res["merge_shapes"])
        emit({"phase": "crash_riding_leg", "leg": name, **res})
        failed = [g for g, ok in res.get("gates", {}).items() if not ok]
        check(not failed, f"crash_riding {name}: gates failed {failed}")
        out["legs"][name] = {"seconds": res["seconds"],
                             "launches": res["cluster_merge_launches"]}
    out["cluster_merge_launches"] = launches
    emit(out)

    def merged(shapes):
        calls: dict = {}
        for m in shapes:
            key = (m["rows"], m["k"])
            calls[key] = calls.get(key, 0) + m["calls"]
        return [{"rows": r, "k": k, "calls": c}
                for (r, k), c in sorted(calls.items())]
    out["unit_shapes"] = merged(unit)
    out["weighted_shapes"] = merged(weighted)
    return out


# ---- phase 5: the server ----------------------------------------------------

def free_udp_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def free_tcp_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
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


SERVER_READERS = 4  # the reference's example.yaml num_readers


def server_sent(msgs) -> int:
    """Samples a server processes from ``msgs``: every line of a
    datagram within ``metric_max_length``, events aside."""
    return sum(1 for m in msgs if len(m) <= 4096
               for ln in m.split(b"\n") if not ln.startswith(b"_e{"))


def check_debug_surface(hport: int, tsv_rows: list, sent: int) -> dict:
    """The server's /debug/* records after its traffic was flushed and
    the next interval carried the first telemetry tick: the launch
    registry (CUDA-event device time for every step that ran, readback
    bytes), the flush ring's stages, the sealed ledger, the last
    flush's trace tree, the signal history, the flight recorder,
    overload control (``/debug/overload``: its overruns on the card),
    and the TSV's ``veneur.*`` rows."""
    dv = json.loads(http_get(hport, "/debug/vars"))
    dc = dv["devicecost"]
    ran = {n: e for n, e in dc["kernels"].items() if e["calls"]}
    check(ran, "no device step ran")
    for name, e in ran.items():
        check(e["device_calls"] > 0 and e["device_duration_ns"] and
              e["device_duration_ns"] > 0,
              f"{name}: no CUDA-event device time: {e}")
    check(any(n.startswith("table.") for n in ran) and
          any(n.startswith("flusher.") for n in ran),
          f"steps that ran: {sorted(ran)}")
    check(dc["readback_bytes_total"] > 0 and dc["events_dropped"] == 0,
          f"readback / dropped events: {dc}")
    flushes = json.loads(http_get(hport, "/debug/flushes"))
    stages = set().union(*(r["stages_ns"] for r in flushes))
    want = {"snapshot", "swap_apply", "dispatch", "device_wait",
            "host_emit", "sink_flush"}
    check(want <= stages, f"flush stages {sorted(stages)}")
    led = json.loads(http_get(hport, "/debug/ledger"))
    recs = led["records"]
    received = sum(r["received"].get("dogstatsd", 0) for r in recs)
    check(led["imbalanced"] == [] and all(r["balanced"] for r in recs),
          f"ledger imbalanced: {led['imbalanced']}")
    check(received == sent, f"ledger received {received} of {sent}")
    tid = flushes[-1]["trace_id"]
    spans = json.loads(http_get(hport, f"/debug/trace/{tid}"))["spans"]
    root = [s for s in spans if s["name"] == "flush"]
    check(len(root) == 1, f"trace {tid}: {len(root)} roots")
    kids = {s["name"] for s in spans
            if s["parent_id"] == root[0]["span_id"]}
    check({f"flush.{s}" for s in want} <= kids, f"trace children {kids}")
    sig = json.loads(http_get(hport, "/debug/signals"))
    check(sig["rows"] >= 2 and len(sig["signals"]) >= 30,
          f"signals: {sig['rows']} rows, {len(sig['signals'])} signals")
    flight = json.loads(http_get(hport, "/debug/flight"))
    check("bundles" in flight and "stats" in flight, "flight listing")
    processed = sum(float(r[5]) for r in tsv_rows
                    if r[0] == "veneur.worker.metrics_processed_total")
    check(processed == sent,
          f"veneur.worker.metrics_processed_total {processed} of {sent}")
    veneur = sorted({r[0] for r in tsv_rows if r[0].startswith("veneur.")})
    # overload control runs by default: whether this server's flushes
    # on the card (its first included) overran the interval budget
    ov = json.loads(http_get(hport, "/debug/overload"))
    check(dv["overload"] is not None and "pressure" in ov,
          f"overload control: {ov}")
    return {"overload": {k: ov[k] for k in ("flush_overruns",
                                            "coalesced_total")},
            "pressure": ov["pressure"],
            "steps_ran": {n: {"calls": e["calls"],
                              "device_ns": e["device_duration_ns"],
                              "dispatch_ns": e["dispatch_duration_ns"],
                              "est_bytes": e["est_bytes_accessed_per_call"]}
                          for n, e in ran.items()},
            "readback_bytes": dc["readback_bytes_total"],
            "h2d_bytes": dc["h2d_bytes_total"],
            "compile_total": dc["compile_total"],
            "compile_cache_hits": dc["compile_cache_hits"],
            "flush_stages": sorted(stages),
            "ledger_intervals": led["intervals"],
            "ledger_received": received, "trace_children": sorted(kids),
            "signal_rows": sig["rows"], "signals": len(sig["signals"]),
            "flight": flight["stats"], "veneur_rows": len(veneur),
            "metrics_processed_total": processed}


def profile_burst(hport: int, port: int, flush: str) -> dict:
    """``/debug/pprof/device?seconds=1`` while timers arrive from a
    burst thread, timed to span the server's next flush (its merges run
    at the swap): the Chrome trace's CUDA kernels must include
    ``cluster_merge_kernel``.  A short capture first pays the
    profiler's one-time start-up (~10 s on the H100, which would
    otherwise eat the window); the window is placed 1.4 s after a flush
    file write at the 2 s interval; if it still misses a swap, one
    2.5 s capture follows, and the result says which took it."""
    import shutil
    import threading
    t_req = time.perf_counter()
    warm = json.loads(http_get(hport, "/debug/pprof/device?seconds=0.05",
                               timeout=180))
    shutil.rmtree(warm["dir"], ignore_errors=True)
    warmup_s = time.perf_counter() - t_req
    done = threading.Event()

    def burst():
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        v = 0
        while not done.is_set():
            s.sendto(b"\n".join(b"burst.lat:%d|ms" % (v + i)
                                 for i in range(50)), ("127.0.0.1", port))
            v += 50
            time.sleep(0.002)
        s.close()
    th = threading.Thread(target=burst)
    th.start()
    tries = []
    try:
        for seconds in (1, 2.5):
            size = os.path.getsize(flush)
            wait_for(lambda: os.path.getsize(flush) != size, 10,
                     "a flush before the capture")
            time.sleep(1.4)
            # the capture, then the trace's export, answer the request
            t_req = time.perf_counter()
            out = json.loads(http_get(
                hport, f"/debug/pprof/device?seconds={seconds}",
                timeout=180))
            request_s = time.perf_counter() - t_req
            with open(os.path.join(out["dir"], "trace.json")) as f:
                events = json.load(f)["traceEvents"]
            shutil.rmtree(out["dir"], ignore_errors=True)
            kernels = sorted({e.get("name", "") for e in events
                              if e.get("cat") == "kernel"})
            merge = [k for k in kernels if "cluster_merge_kernel" in k]
            tries.append({"seconds": seconds, "kernels": len(kernels),
                          "cluster_merge": merge[:1],
                          "activities": out["activities"],
                          "events": len(events), "request_s": request_s,
                          "trace_bytes": out["files"][0]["bytes"]})
            if merge:
                break
    finally:
        done.set()
        th.join()
    check(tries[-1]["cluster_merge"],
          f"no cluster_merge_kernel in the device profile: {tries}")
    return {"warmup_request_s": warmup_s, "captures": tries}


def phase_server(dev: str = "cuda") -> dict:
    port = free_udp_port()
    hport = free_tcp_port()
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke-") as tmp:
        flush = os.path.join(tmp, "flush.tsv")
        cfg = os.path.join(tmp, "server.yaml")
        with open(cfg, "w") as f:
            # JSON is YAML: no YAML library needed to write it
            json.dump({"interval": "2s", "hostname": "smoke",
                       "statsd_listen_addresses":
                           [f"udp://127.0.0.1:{port}"],
                       "http_address": f"127.0.0.1:{hport}",
                       "num_readers": SERVER_READERS,
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
            # several source sockets: SO_REUSEPORT hashes each one's
            # 4-tuple to one of the readers
            socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                     for _ in range(2 * SERVER_READERS)]
            msgs = [b"hits:1|c"] * 3 + [b"temp:42|g"]
            msgs += [f"lat:{v}|ms".encode() for v in range(200)]
            msgs += [f"uniq:u{i}|s".encode() for i in range(300)]
            # one multi-line datagram, an event, a service check, and a
            # datagram over metric_max_length (rejected whole)
            msgs += [b"multi.a:1|c\nmulti.b:2|c\nmulti.g:3|g",
                     b"_e{5,4}:title|text|#a:b",
                     b"_sc|smoke.check|1|#chk:yes|m:hello",
                     b"evil:1|c\n" + b"x" * 5000]
            for i, m in enumerate(msgs):
                socks[i % len(socks)].sendto(m, ("127.0.0.1", port))
                time.sleep(0.0005)  # stay inside the receive buffer
            for sk in socks:
                sk.close()
            sent = server_sent(msgs)

            def rows():
                with open(flush) as f:
                    return [r.split("\t") for r in f.read().splitlines()]

            wait_for(lambda: any(r[0] == "lat.count" for r in rows()), 30,
                     "the flush of the sent metrics", proc)
            # the first telemetry tick after the traffic reaches the
            # TSV with the next flush
            wait_for(lambda: sum(
                float(r[5]) for r in rows()
                if r[0] == "veneur.worker.metrics_processed_total")
                >= sent, 30, "the telemetry of the sent metrics", proc)
            tsv = rows()
            debug = check_debug_surface(hport, tsv, sent)
            debug["device_profile"] = profile_burst(hport, port, flush)
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            log.close()
        with open(os.path.join(tmp, "server.log")) as f:
            server_log = f.read()
    rows = [r for r in tsv if not r[0].startswith("veneur.")]
    check(proc.returncode == 0, f"server exit code {proc.returncode}: "
                                f"{server_log[-2000:]}")
    check(f"with {SERVER_READERS} reader(s) each (fused shards)"
          in server_log, "the server did not start its reader shards")
    vals = {r[0]: float(r[5]) for r in rows}
    check(vals.get("hits") == 3.0, f"hits = {vals.get('hits')}")
    check(vals.get("temp") == 42.0, f"temp = {vals.get('temp')}")
    check(vals.get("lat.count") == 200.0,
          f"lat.count = {vals.get('lat.count')}")
    check(repr(vals.get("lat.99percentile")) == "197.00999450683594",
          f"lat.99percentile = {vals.get('lat.99percentile')!r}")
    check(abs(vals.get("uniq", 0) - 300) <= 15,
          f"uniq = {vals.get('uniq')}")
    multi = {k: vals.get(k) for k in ("multi.a", "multi.b", "multi.g")}
    check(multi == {"multi.a": 1.0, "multi.b": 2.0, "multi.g": 3.0},
          f"multi-line datagram flushed {multi}")
    check(not any(k.startswith("evil") for k in vals),
          "a series of the oversize datagram flushed")
    check(vals.get("smoke.check") == 1.0 and any(
        r[0] == "smoke.check" and r[2] == "status" for r in rows),
        f"service check = {vals.get('smoke.check')}")
    res = {"phase": "server", "num_readers": SERVER_READERS,
           "source_sockets": 2 * SERVER_READERS, "startup_s": startup,
           "hits": vals["hits"], "lat.count": vals["lat.count"],
           "lat.99percentile": vals["lat.99percentile"],
           "uniq": vals["uniq"], "multi_line": multi,
           "service_check": vals["smoke.check"],
           "oversize_rejected": True, "samples_sent": sent,
           "debug": debug}
    emit(res)
    return res


# ---- phase 7: local -> global over UDP and HTTP --------------------------

def http_get(port: int, path: str, timeout: float = 10) -> bytes:
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as r:
        return r.read()


def http_post_status(port: int, path: str, body: bytes) -> int:
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def flushed_values(path: str) -> dict:
    """name -> value of the last row of each name in a flush file."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return {r[0]: float(r[5]) for r in
                (ln.split("\t") for ln in f.read().splitlines())}


def drive_grpc(port: int) -> dict:
    """Against the global's gRPC listener: Health/Check for "" and
    "veneur", one multi-line SendPacket, a garbage SendMetrics (must
    fail with INVALID_ARGUMENT), then the frozen Go-side wire
    ``tests/testdata/forward_fixture.b64`` through the port's client."""
    import base64

    import grpc
    from veneur_tpu_torch.forward import grpc_forward
    from veneur_tpu_torch.protocol.gen import dogstatsd_grpc_pb2, health_pb2
    chan = grpc.insecure_channel(f"127.0.0.1:{port}")
    client = grpc_forward.ForwardClient(f"127.0.0.1:{port}", timeout=30)
    try:
        check_call = chan.unary_unary(
            "/grpc.health.v1.Health/Check",
            request_serializer=health_pb2.HealthCheckRequest
            .SerializeToString,
            response_deserializer=health_pb2.HealthCheckResponse.FromString)
        health = {}
        for svc in ("", "veneur"):
            resp = check_call(health_pb2.HealthCheckRequest(service=svc),
                              timeout=30, wait_for_ready=True)
            health[svc] = health_pb2.HealthCheckResponse.ServingStatus.Name(
                resp.status)
        check(health == {"": "SERVING", "veneur": "SERVING"},
              f"health {health}")
        chan.unary_unary(
            "/dogstatsd.DogstatsdGRPC/SendPacket",
            request_serializer=dogstatsd_grpc_pb2.DogstatsdPacket
            .SerializeToString,
            response_deserializer=dogstatsd_grpc_pb2.Empty.FromString)(
                dogstatsd_grpc_pb2.DogstatsdPacket(
                    packetBytes=b"pkt.a:1|c\npkt.b:2|c\npkt.g:3|g"),
                timeout=30)
        try:
            client.send_wire(b"\xff\xff\xff\x01garbage")
            garbage = "OK"
        except grpc.RpcError as e:
            garbage = e.code().name
        check(garbage == "INVALID_ARGUMENT",
              f"garbage SendMetrics answered {garbage}")
        path = os.path.join(HERE, "tests", "testdata", "forward_fixture.b64")
        with open(path, "rb") as f:
            client.send_wire(base64.b64decode(f.read()))
    finally:
        client.close()
        chan.close()
    return {"health": health, "garbage_send_metrics": garbage}


def stitched_trace(local_port: int, global_port: int) -> dict:
    """The local's forwarding flush (the last ring record that shipped
    rows), its ``flush.forward`` span, and the global's fragment of the
    same trace: one ``import`` span parented under that span."""
    flushes = json.loads(http_get(local_port, "/debug/flushes"))
    fwd_recs = [r for r in flushes if r["forward_rows"]]
    check(fwd_recs, "the local forwarded no rows")
    tid = fwd_recs[-1]["trace_id"]
    spans = json.loads(http_get(local_port, f"/debug/trace/{tid}"))["spans"]
    fwd = [s for s in spans if s["name"] == "flush.forward"]
    check(len(fwd) == 1, f"local trace {tid}: {[s['name'] for s in spans]}")
    gspans = json.loads(http_get(global_port,
                                 f"/debug/trace/{tid}"))["spans"]
    imp = [s for s in gspans if s["name"] == "import"]
    check(len(imp) == 1 and imp[0]["parent_id"] == fwd[0]["span_id"]
          and imp[0]["trace_id"] == tid,
          f"global fragment of {tid}: {gspans}")
    return {"trace_id": tid, "forward_span": fwd[0]["span_id"],
            "import_protocol": imp[0]["tags"]["protocol"],
            "import_accepted": int(imp[0]["tags"]["accepted"])}


def phase_chain(dev: str = "cuda") -> dict:
    """Four server processes on the card: a global (``http_address`` and
    a gRPC listener) and three locals forwarding to it, one in each
    /import schema and one with ``forward_use_grpc``.
    ``lat:{0..199}|ms`` into the native-schema local,
    ``latref:{0..199}|ms`` into the reference-schema one and
    ``latgrpc:{0..199}|ms`` into the gRPC one must each flush the JAX
    chain's p99 at the global.  The gRPC listener answers Health/Check
    SERVING, a SendPacket's lines flush, the frozen Go-side wire flushes
    what tests/test_grpc_forward.py asserts of it; a garbage /import
    body is answered 400, a garbage SendMetrics INVALID_ARGUMENT, both
    are counted, and the metrics sent after them still flush.  Each
    local's forward carries its flush cycle's trace context: the
    global's ``/debug/trace/<local's trace id>`` must hold an ``import``
    span parented under the local's ``flush.forward`` span, over HTTP
    (both schemas) and over gRPC."""
    gport, grpc_port = free_tcp_port(), free_tcp_port()
    lports = [free_udp_port(), free_udp_port(), free_udp_port()]
    hports = {n: free_tcp_port() for n in ("local", "localref",
                                           "localgrpc")}
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke-") as tmp:
        base = {"interval": "2s", "percentiles": [0.5, 0.99]}
        cfgs = {"global": dict(
            base, hostname="global", http_address=f"127.0.0.1:{gport}",
            grpc_listen_addresses=[f"tcp://127.0.0.1:{grpc_port}"])}
        for name, port, schema in (("local", lports[0], "native"),
                                   ("localref", lports[1], "reference")):
            cfgs[name] = dict(
                base, hostname=name,
                statsd_listen_addresses=[f"udp://127.0.0.1:{port}"],
                http_address=f"127.0.0.1:{hports[name]}",
                forward_address=f"http://127.0.0.1:{gport}",
                forward_json_schema=schema)
        cfgs["localgrpc"] = dict(
            base, hostname="localgrpc",
            statsd_listen_addresses=[f"udp://127.0.0.1:{lports[2]}"],
            http_address=f"127.0.0.1:{hports['localgrpc']}",
            forward_address=f"127.0.0.1:{grpc_port}",
            forward_use_grpc=True)
        procs, logs, flush = {}, {}, {}
        try:
            for name, cfg in cfgs.items():
                flush[name] = os.path.join(tmp, f"{name}.tsv")
                path = os.path.join(tmp, f"{name}.yaml")
                with open(path, "w") as f:
                    json.dump(dict(cfg, flush_file=flush[name]), f)
                logs[name] = open(os.path.join(tmp, f"{name}.log"), "w")
                procs[name] = subprocess.Popen(
                    [sys.executable, "-m", "veneur_tpu_torch.cli.main",
                     "-f", path, "--device", dev], cwd=HERE,
                    stdout=logs[name], stderr=subprocess.STDOUT)
            t0 = time.perf_counter()
            for name in cfgs:
                wait_for(lambda n=name: os.path.exists(flush[n]), 60,
                         f"{name}'s first flush", procs[name])
            startup = time.perf_counter() - t0
            check(http_get(gport, "/healthcheck") == b"ok", "healthcheck")
            garbage = http_post_status(gport, "/import", b"\x00garbage")
            check(garbage == 400, f"garbage /import answered {garbage}")
            grpc_res = drive_grpc(grpc_port)
            # one multi-line datagram per local: it cannot straddle the
            # local's flush, so each stream reaches the global as one wire
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            for port, name in zip(lports, ("lat", "latref", "latgrpc")):
                msgs = [f"{name}:{v}|ms".encode() for v in range(200)]
                msgs.append(f"{name}.hits:2|c|#veneurglobalonly".encode())
                s.sendto(b"\n".join(msgs), ("127.0.0.1", port))
            s.close()
            t1 = time.perf_counter()

            def arrived():
                v = flushed_values(flush["global"])
                return all(f"{n}.99percentile" in v
                           for n in ("lat", "latref", "latgrpc"))
            wait_for(arrived, 30, "the global's percentiles",
                     procs["global"])
            latency = time.perf_counter() - t1
            stats = json.loads(http_get(gport, "/debug/vars"))["stats"]
            stitched = {n: stitched_trace(hports[n], gport)
                        for n in hports}
        finally:
            for p in procs.values():
                p.terminate()
            for p in procs.values():
                try:
                    p.wait(timeout=20)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            for f in logs.values():
                f.close()
        vals = {n: flushed_values(flush[n]) for n in cfgs}
        server_logs = {}
        for name in cfgs:
            with open(os.path.join(tmp, f"{name}.log")) as f:
                server_logs[name] = f.read()
    for name, p in procs.items():
        check(p.returncode == 0, f"{name} exit code {p.returncode}: "
                                 f"{server_logs[name][-2000:]}")
    g = vals["global"]
    for name in ("lat", "latref", "latgrpc"):
        check(repr(g.get(f"{name}.99percentile")) == "197.00999450683594",
              f"global {name}.99percentile = "
              f"{g.get(f'{name}.99percentile')!r}")
        check(g.get(f"{name}.hits") == 2.0,
              f"global {name}.hits = {g.get(f'{name}.hits')}")
    for name, metric in (("local", "lat"), ("localref", "latref"),
                         ("localgrpc", "latgrpc")):
        lv = vals[name]
        check(lv.get(f"{metric}.count") == 200.0 and
              f"{metric}.99percentile" not in lv,
              f"{name} flushed {sorted(lv)}")
    pkt = {k: g.get(k) for k in ("pkt.a", "pkt.b", "pkt.g")}
    check(pkt == {"pkt.a": 1.0, "pkt.b": 2.0, "pkt.g": 3.0},
          f"SendPacket flushed {pkt}")
    # tests/test_grpc_forward.py's assertions on the frozen wire
    check(g.get("fix.total") == 7.0 and g.get("fix.depth") == 3.5 and
          "fix.lat.count" not in g and
          abs(g.get("fix.lat.50percentile", 0) - 52.87) <= 0.05 * 52.87 and
          abs(g.get("fix.users", 0) - 250) <= 0.05 * 250,
          f"fixture flushed {({k: v for k, v in g.items() if k.startswith('fix')})}")
    check(stats["import_errors"] == 2, f"import_errors {stats}")
    check(stats["imports_received"] >= 10, f"imports_received {stats}")
    check(stats["received_grpc"] >= 6, f"received_grpc {stats}")
    check(stats["received_dogstatsd-grpc"] == 1, f"SendPacket {stats}")
    for name, want in (("local", "http"), ("localref", "http"),
                       ("localgrpc", "grpc")):
        check(stitched[name]["import_protocol"] == want,
              f"{name}'s import span: {stitched[name]}")
    res = {"phase": "chain", "startup_s": startup,
           "send_to_global_flush_s": latency,
           "lat.99percentile": g["lat.99percentile"],
           "latref.99percentile": g["latref.99percentile"],
           "latgrpc.99percentile": g["latgrpc.99percentile"],
           "garbage_import_status": garbage, **grpc_res,
           "fixture": {k: v for k, v in g.items() if k.startswith("fix")},
           "global_stats": stats, "stitched_traces": stitched}
    emit(res)
    return res


# ---- phase 14: the server core and the span plane -------------------------

SPAN_SERIES = 10_000        # span-borne timer series (phase 4's count)
SPAN_SAMPLES = 100          # samples a series (the cut: phase 4 has 1,000)
SPAN_SERVICES = 1_000       # services sending indicator spans
SPAN_INTERVAL_S = 100       # the children's interval: all traffic in one
SPAN_WINDOW = 64            # spans in flight to a child before a wait
SPAN_QUEUE_SLACK = 512      # span-queue depth a feed may leave pending


def read_example_yaml(path: str) -> dict:
    """The subset of YAML the repo's example configs use (``key:
    scalar``, ``key: [inline list]``, ``key:`` followed by ``- item``
    lines, comments), parsed without PyYAML, which the card's machine
    lacks.  Scalars are read as JSON where they are JSON (quoted
    strings, numbers, booleans, lists), else kept as text."""
    def scalar(text: str):
        try:
            return json.loads(text)
        except ValueError:
            return text

    def strip_comment(line: str) -> str:
        quoted = False
        for i, ch in enumerate(line):
            if ch == '"':
                quoted = not quoted
            elif ch == "#" and not quoted:
                return line[:i]
        return line

    out: dict = {}
    key = None
    with open(path) as f:
        for raw in f:
            line = strip_comment(raw).rstrip()
            if not line.strip():
                continue
            if line.lstrip().startswith("- "):
                out[key].append(scalar(line.lstrip()[2:].strip()))
                continue
            key, _, value = line.partition(":")
            key = key.strip()
            value = value.strip()
            out[key] = scalar(value) if value else []
    return out


def span_traffic(n_series: int = SPAN_SERIES,
                 n_services: int = SPAN_SERVICES, seed: int = 14) -> dict:
    """Phase 14's spans: ``SPAN_SERIES`` timer series of ``SPAN_SAMPLES``
    gamma(2, 30) samples, one span each (every 500th span also carries
    an invalid sample), then one successful and one failed indicator
    span for each of ``SPAN_SERVICES`` services; split over the three
    SSF transports in a fixed order.  The DogStatsD lines: counters,
    gauges, timers and a set, each series inside one datagram (UDP) or
    one connection (TCP)."""
    from veneur_tpu_torch.protocol.gen import ssf_pb2
    S = ssf_pb2.SSFSample
    rng = np.random.default_rng(seed)
    vals = rng.gamma(2.0, 30.0, (n_series, SPAN_SAMPLES)).astype(
        np.float32)
    timers = []
    for i in range(n_series):
        sp = ssf_pb2.SSFSpan(id=i + 1, trace_id=i + 1,
                             start_timestamp=1_000_000,
                             end_timestamp=2_000_000, name="op")
        name, shard = f"span.lat{i % 100}", str(i // 100)
        for v in vals[i]:
            s = sp.metrics.add(metric=S.HISTOGRAM, name=name,
                               value=float(v), sample_rate=1.0, unit="ms")
            s.tags["shard"] = shard
        if i % 500 == 0:
            sp.metrics.add(metric=9, name="span.bad", value=1.0)
        timers.append(sp.SerializeToString())
    dur = rng.integers(10_000, 50_000_000, 2 * n_services)
    indicators = []
    for j in range(2 * n_services):
        sp = ssf_pb2.SSFSpan(
            id=n_series + j + 1, trace_id=n_series + j + 1,
            start_timestamp=1_000_000,
            end_timestamp=1_000_000 + int(dur[j]),
            service=f"svc{j // 2}", name=f"op{j % 7}", indicator=True,
            error=bool(j % 2))
        indicators.append(sp.SerializeToString())
    # 40% over UDP, 30% over the unix stream, 30% over gRPC
    cut = (0, n_series * 4 // 10, n_series * 7 // 10, n_series)
    icut = (0, n_services * 7 // 10, n_services * 14 // 10,
            2 * n_services)
    by = {t: timers[cut[k]:cut[k + 1]] + indicators[icut[k]:icut[k + 1]]
          for k, t in enumerate(("udp", "unix", "grpc"))}
    udp = []
    for c in range(200):
        udp.append(b"\n".join(b"dsd.hits%d:%d|c|#src:udp" % (c, k + 1)
                              for k in range(5)))
    for g in range(100):
        udp.append(b"dsd.depth%d:%d|g" % (g, g * 3))
    tvals = rng.gamma(2.0, 30.0, (100, 20)).astype(np.float32)
    for t in range(100):
        udp.append(b"\n".join(b"dsd.lat%d:%r|ms" % (t, float(v))
                              for v in tvals[t]))
    for m in range(0, 300, 50):
        udp.append(b"\n".join(b"dsd.users:u%d|s" % k
                              for k in range(m, m + 50)))
    tcp = [b"dsd.tcp.hits%d:%d|c" % (k % 50, k) for k in range(1000)]
    tcp += [b"dsd.tcp.depth%d:%d|g" % (k % 20, k) for k in range(200)]
    tcp += [b"dsd.tcp.lat:%r|ms" % float(v) for v in tvals[0]]
    return {"ssf": by, "udp": udp, "tcp": tcp, "values": vals,
            "n_spans": sum(len(v) for v in by.values())}


def span_child_config(base: dict, tmp: str, name: str, **over) -> tuple:
    """``base`` (the repo's example.yaml) with every address on a free
    loopback port or a temporary unix socket, an SSF unix listener
    added, ``http_quit`` and a flush file; the rest as written but
    ``over``.  Returns (config path, ports, flush file)."""
    ports = {"udp": free_udp_port(), "tcp": free_tcp_port(),
             "ssf": free_udp_port(), "grpc": free_tcp_port(),
             "http": free_tcp_port()}
    cfg = dict(base)
    cfg["statsd_listen_addresses"] = [
        f"{a.split('://')[0]}://127.0.0.1:"
        f"{ports['udp' if a.startswith('udp') else 'tcp']}"
        for a in base["statsd_listen_addresses"]]
    cfg["ssf_listen_addresses"] = [f"udp://127.0.0.1:{ports['ssf']}",
                                   f"unix://{tmp}/{name}-ssf.sock"]
    cfg["grpc_listen_addresses"] = [f"tcp://127.0.0.1:{ports['grpc']}"]
    cfg["http_address"] = f"127.0.0.1:{ports['http']}"
    cfg["http_quit"] = True
    flush = os.path.join(tmp, f"{name}.tsv")
    cfg["flush_file"] = flush
    cfg.update(over)
    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    ports["unix"] = f"{tmp}/{name}-ssf.sock"
    return path, ports, flush


def child_stats(port: int) -> dict:
    return json.loads(http_get(port, "/debug/vars"))


def tsv_metrics(path: str) -> dict:
    """(name, tags) -> sorted values of a flush file's rows."""
    out: dict = {}
    with open(path) as f:
        for ln in f.read().splitlines():
            r = ln.split("\t")
            out.setdefault((r[0], r[1]), []).append(float(r[5]))
    return {k: sorted(v) for k, v in out.items()}


def compare_span_flush(got: dict, want: dict) -> dict:
    """A child's flush against the CPU server's: every series but the
    delivery-sampled ``ssf.names_unique`` (a 1% random roll per span, by
    the reference's design) on both sides; percentiles within rtol 2e-3
    / atol 1e-3, everything else bit for bit."""
    def user(d):
        return {k: v for k, v in d.items()
                if not k[0].startswith(("veneur.", "ssf.names_unique"))}
    g, w = user(got), user(want)
    check(g.keys() == w.keys(),
          f"series differ: {sorted(set(g) - set(w))[:5]} "
          f"{sorted(set(w) - set(g))[:5]}")
    n_pct = n_exact = 0
    max_pct = 0.0
    for key, wv in w.items():
        gv = g[key]
        check(len(gv) == len(wv), f"{key}: {gv} vs {wv}")
        if key[0].endswith("percentile"):
            a, b = np.asarray(gv), np.asarray(wv)
            excess = float((np.abs(a - b) - (1e-3 + 2e-3 * np.abs(b)))
                           .max())
            check(excess <= 0, f"{key}: {gv} vs {wv}")
            max_pct = max(max_pct, float(np.abs(a - b).max()))
            n_pct += len(gv)
        else:
            check(gv == wv, f"{key}: {gv} vs {wv}")
            n_exact += len(gv)
    uniq = {k: v for k, v in got.items() if k[0] == "ssf.names_unique"}
    # one span name per service and error flag
    check(all(x <= 2 for v in uniq.values() for x in v),
          f"ssf.names_unique {uniq}")
    return {"series": len(w), "percentiles": n_pct, "exact": n_exact,
            "percentile_max_abs_diff": max_pct,
            "names_unique_series": len(uniq)}


def span_p99_errors(metrics: dict, vals: np.ndarray, suffix: str) -> dict:
    """Relative p99 error of every span timer series against exact
    ``np.quantile`` over its samples."""
    errs = []
    for i in range(len(vals)):
        key = (f"span.lat{i % 100}.{suffix}", f"shard:{i // 100},"
               "veneurglobalonly")
        got = metrics[key][-1]
        want = float(np.quantile(vals[i].astype(np.float64), 0.99))
        errs.append(abs(got - want) / abs(want))
    e = np.asarray(errs)
    return {"median": float(np.median(e)), "max": float(e.max())}


def feed_children(children: list, items: list, send, key: str,
                  processed: bool = True) -> None:
    """Send ``items`` to every child in windows of ``SPAN_WINDOW``
    through ``send(child, chunk)``; before the next window each child's
    ``stats[key]`` must have taken the chunk and (``processed``) its span
    workers must be within ``SPAN_QUEUE_SLACK`` spans of it, so neither
    a socket buffer nor the span queue can overflow."""
    base = {id(c): child_stats(c["ports"]["http"])["stats"]
            for c in children}
    for lo in range(0, len(items), SPAN_WINDOW):
        chunk = items[lo:lo + SPAN_WINDOW]
        for c in children:
            send(c, chunk)
        n = lo + len(chunk)
        for c in children:
            b = base[id(c)]

            def caught_up(c=c, b=b):
                st = child_stats(c["ports"]["http"])["stats"]
                ok = st.get(key, 0) - b.get(key, 0) >= n
                if processed:
                    done = (st.get("spans_processed", 0)
                            - b.get("spans_processed", 0))
                    ok = ok and done >= n - SPAN_QUEUE_SLACK
                return ok
            # a poll builds the child's whole /debug/vars page under
            # its GIL: poll at 5 Hz, not wait_for's 20
            deadline = time.monotonic() + 60
            while not caught_up():
                check(c["proc"].poll() is None,
                      f"child {c['name']} exited during the feed")
                check(time.monotonic() < deadline,
                      f"timed out feeding {c['name']}'s {key}")
                time.sleep(0.2)


def phase_span_plane(dev: str = "cuda", scale: int = 1) -> dict:
    """Phase 14: port servers from the repo's example.yaml as child
    processes on the card, fed one interval over every listener (SSF
    over UDP, a unix stream and gRPC ``SendSpan``; DogStatsD over UDP
    and TCP), each flush held to a CPU port server's on the same
    spans in the same order: child A as written (with ``tpu_warmup``),
    child B with ``percentile_naming`` and ``quantile_interpolation``
    at ``reference``; then the ledger, ``/version``, ``/builddate``,
    ``/quitquitquit`` (exit 0) and, in child C whose flush file is a
    FIFO nobody reads, the flush watchdog (exit 2).  ``scale`` > 1
    (a CPU rehearsal) divides the series, the services and the table
    rows."""
    import grpc
    from veneur_tpu_torch import native
    from veneur_tpu_torch.core.config import read_config
    from veneur_tpu_torch.core.flusher import Flusher
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.ops import cluster_merge
    from veneur_tpu_torch.protocol import wire
    from veneur_tpu_torch.protocol.gen import ssf_pb2

    t_phase = time.perf_counter()
    base = read_example_yaml(os.path.join(HERE, "example.yaml"))
    if scale > 1:
        for key in ("tpu_counter_rows", "tpu_gauge_rows",
                    "tpu_histo_rows", "tpu_set_rows"):
            base[key] = max(1024, base[key] // scale)
    n_series, n_services = SPAN_SERIES // scale, SPAN_SERVICES // scale
    ref = {"percentile_naming": "reference",
           "quantile_interpolation": "reference"}
    out = {"phase": "span_plane", "device": dev}
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke-") as tmp:
        # the children build into (and load from) a temporary directory:
        # seeded with this checkout's libraries, so none rebuilds
        cache = os.path.join(tmp, "build")
        os.makedirs(cache)
        libs = [native.build()]
        if dev == "cuda":
            libs.append(cluster_merge.build())
        for lib in libs:
            with open(lib, "rb") as src, \
                    open(os.path.join(cache, os.path.basename(lib)),
                         "wb") as dst:
                dst.write(src.read())
        common = {"compile_cache_dir": cache,
                  "interval": f"{SPAN_INTERVAL_S}s"}
        fifo = os.path.join(tmp, "held.tsv")
        os.mkfifo(fifo)
        specs = (("A", dict(common, tpu_warmup=True)),
                 ("B", dict(common, tpu_warmup=False, **ref)),
                 ("C", dict(common, tpu_warmup=False, interval="1s")))
        children = []
        try:
            for name, over in specs:
                path, ports, flush = span_child_config(base, tmp, name,
                                                       **over)
                if name == "C":
                    with open(path) as f:
                        cfg = json.load(f)
                    cfg["flush_file"] = flush = fifo
                    with open(path, "w") as f:
                        json.dump(cfg, f)
                log = open(os.path.join(tmp, f"{name}.log"), "w")
                proc = subprocess.Popen(
                    [sys.executable, "-m", "veneur_tpu_torch.cli.main",
                     "-f", path, "--device", dev], cwd=HERE, stdout=log,
                    stderr=subprocess.STDOUT)
                children.append({"name": name, "proc": proc, "log": log,
                                 "ports": ports, "flush": flush,
                                 "t0": time.perf_counter()})
            traffic = span_traffic(n_series, n_services)
            a, b, c = children

            def all_ready():
                for ch in children:
                    if ("ready_s" not in ch
                            and _healthy(ch["ports"]["http"])):
                        ch["ready_s"] = time.perf_counter() - ch["t0"]
                    # the watchdog child may be gone again by now
                    check("ready_s" in ch or ch["proc"].poll() is None,
                          f"child {ch['name']} exited before READY")
                return all("ready_s" in ch for ch in children)
            wait_for(all_ready, 120, "the children READY")
            t_ready = time.perf_counter()
            warm = child_stats(a["ports"]["http"])
            fed = (a, b)
            n_spans = traffic["n_spans"]

            def cpu_reference():
                """The CPU server: the same spans through handle_ssf in
                the same order, then the same DogStatsD, one swap, and
                the snapshot through A's and B's flush keys."""
                cpu = Server(read_config(data=dict(
                    {k: v for k, v in base.items()
                     if not k.endswith(("_addresses", "_address"))},
                    compile_cache_dir="", tpu_warmup=False,
                    interval="3600s")), device="cpu")
                cpu.start()
                t_cpu = time.perf_counter()
                try:
                    with MergeRecorder() as rec:
                        for t in ("udp", "unix", "grpc"):
                            for raw in traffic["ssf"][t]:
                                while cpu.span_worker.queue.qsize() > \
                                        SPAN_QUEUE_SLACK:
                                    time.sleep(0.001)
                                cpu.handle_ssf(wire.parse_ssf(raw))
                        wait_for(lambda: cpu.stats.get(
                            "spans_processed", 0) >= n_spans, 300,
                            "the CPU server's spans")
                        for d in traffic["udp"]:
                            cpu.handle_packet(d)
                        cpu.handle_packet_batch(traffic["tcp"])
                        snap = cpu.table.swap()
                    cpu_s = time.perf_counter() - t_cpu
                    kw = dict(is_local=False,
                              percentiles=tuple(base["percentiles"]),
                              aggregates=tuple(base["aggregates"]),
                              hostname=socket.gethostname(),
                              tags=tuple(base["tags"]), device="cpu")
                    return (Flusher(**kw).flush(snap).metrics,
                            Flusher(**kw, **ref).flush(snap).metrics,
                            rec.table(), cpu_s)
                finally:
                    cpu.shutdown()
            # the CPU server runs beside the children's feed
            from concurrent.futures import ThreadPoolExecutor
            pool = ThreadPoolExecutor(1)
            cpu_ref = pool.submit(cpu_reference)
            # SSF over UDP, then the unix stream, then gRPC SendSpan
            udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            feed_children(fed, traffic["ssf"]["udp"], lambda ch, chunk: [
                udp.sendto(raw, ("127.0.0.1", ch["ports"]["ssf"]))
                for raw in chunk], "received_ssf-udp")
            marks = {"ssf_udp": time.perf_counter()}
            streams = {}
            for ch in fed:
                s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                s.connect(ch["ports"]["unix"])
                streams[ch["name"]] = s

            def send_unix(ch, chunk):
                buf = io.BytesIO()
                for raw in chunk:
                    wire.write_ssf(buf, ssf_pb2.SSFSpan.FromString(raw))
                streams[ch["name"]].sendall(buf.getvalue())
            feed_children(fed, traffic["ssf"]["unix"], send_unix,
                          "received_ssf-unix")
            marks["ssf_unix"] = time.perf_counter()
            for s in streams.values():
                s.close()
            chans = {ch["name"]: grpc.insecure_channel(
                f"127.0.0.1:{ch['ports']['grpc']}") for ch in fed}
            calls = {n: ch.unary_unary("/ssf.SSFGRPC/SendSpan",
                                       request_serializer=lambda x: x,
                                       response_deserializer=lambda x: x)
                     for n, ch in chans.items()}
            feed_children(fed, traffic["ssf"]["grpc"], lambda ch, chunk: [
                calls[ch["name"]](raw, timeout=30) for raw in chunk],
                "received_ssf-grpc")
            for ch in chans.values():
                ch.close()
            for ch in fed:
                wait_for(lambda ch=ch: child_stats(ch["ports"]["http"])[
                    "stats"].get("spans_processed", 0) >= n_spans, 120,
                    f"child {ch['name']}'s span workers", ch["proc"])
            marks["ssf_grpc"] = time.perf_counter()
            # DogStatsD last, each series inside one datagram or stream
            feed_children(fed, traffic["udp"], lambda ch, chunk: [
                udp.sendto(d, ("127.0.0.1", ch["ports"]["udp"]))
                for d in chunk], "received_dogstatsd-udp",
                processed=False)
            udp.close()
            for ch in fed:
                with socket.create_connection(
                        ("127.0.0.1", ch["ports"]["tcp"])) as conn:
                    conn.sendall(b"\n".join(traffic["tcp"]) + b"\n")
            for ch in fed:
                wait_for(lambda ch=ch: child_stats(ch["ports"]["http"])[
                    "stats"].get("received_dogstatsd-tcp", 0) == len(
                    traffic["tcp"]), 60, "the TCP lines", ch["proc"])
            marks["dogstatsd"] = fed_end = time.perf_counter()
            fed_s = fed_end - t_ready
            prev, feed_s = t_ready, {}
            for key, t in marks.items():
                feed_s[key], prev = t - prev, t
            for ch in fed:
                check(not os.path.exists(ch["flush"]),
                      f"child {ch['name']} flushed before its traffic "
                      f"was in ({fed_s:.1f} s after READY)")
            want_a, want_b, shapes, cpu_s = cpu_ref.result()
            pool.shutdown()
            for ch in fed:
                wait_for(lambda ch=ch: os.path.exists(ch["flush"]), 120,
                         f"child {ch['name']}'s flush", ch["proc"])
            for ch in fed:
                def sealed(ch=ch):
                    return json.loads(http_get(
                        ch["ports"]["http"], "/debug/ledger"))["records"]
                wait_for(sealed, 60, "the sealed ledger record",
                         ch["proc"])
                ch["ledger"] = sealed()
                ch["vars"] = child_stats(ch["ports"]["http"])
            version = http_get(a["ports"]["http"], "/version").decode()
            builddate = http_get(a["ports"]["http"], "/builddate").decode()
            for ch in fed:
                check(http_get(ch["ports"]["http"], "/quitquitquit")
                      == b"terminating", "/quitquitquit")
            for ch in children:
                try:
                    ch["proc"].wait(timeout=60)
                except subprocess.TimeoutExpired:
                    pass
        finally:
            for ch in children:
                if ch["proc"].poll() is None:
                    ch["proc"].kill()
                    ch["proc"].wait()
                ch["log"].close()
        logs = {}
        for ch in children:
            with open(os.path.join(tmp, f"{ch['name']}.log")) as f:
                logs[ch["name"]] = f.read()
        got = {ch["name"]: tsv_metrics(ch["flush"]) for ch in fed}
    for ch in fed:
        check(ch["proc"].returncode == 0,
              f"child {ch['name']} exit {ch['proc'].returncode} after "
              f"/quitquitquit: {logs[ch['name']][-2000:]}")
    check(c["proc"].returncode == 2 and "flush watchdog" in logs["C"],
          f"watchdog child exit {c['proc'].returncode}: "
          f"{logs['C'][-2000:]}")
    check(version and builddate == "dev", f"/version {version!r}, "
                                          f"/builddate {builddate!r}")

    def as_tsv(metrics):
        d: dict = {}
        for m in metrics:
            d.setdefault((m.name, ",".join(m.tags)), []).append(m.value)
        return {k: sorted(v) for k, v in d.items()}
    flushes = {"A": compare_span_flush(got["A"], as_tsv(want_a)),
               "B": compare_span_flush(got["B"], as_tsv(want_b))}
    p99 = {"A": span_p99_errors(got["A"], traffic["values"],
                                "99percentile"),
           "B": span_p99_errors(got["B"], traffic["values"],
                                "99percentile")}
    check(p99["A"]["median"] < 0.01, f"p99 median error {p99['A']}")
    w = warm["warmup"]
    check(w is not None and w["merge_launches"] == (dev == "cuda"),
          f"child A's warm-up: {w}")
    calls = sum(m["calls"] for m in shapes)
    launches = {}
    for ch in fed:
        st = ch["vars"]["stats"]
        for key, want in (("received_ssf-udp", len(traffic["ssf"]["udp"])),
                          ("received_ssf-unix",
                           len(traffic["ssf"]["unix"])),
                          ("received_ssf-grpc",
                           len(traffic["ssf"]["grpc"])),
                          ("received_dogstatsd-udp", len(traffic["udp"])),
                          ("received_dogstatsd-tcp", len(traffic["tcp"]))):
            check(st.get(key) == want, f"{ch['name']} {key} "
                                       f"{st.get(key)} != {want}")
        check(st.get("ssf_invalid_samples") == -(-n_series // 500),
              f"invalid samples {st.get('ssf_invalid_samples')}")
        rec0 = ch["ledger"][0]
        check(rec0["balanced"] and rec0["received"].get("dogstatsd", 0)
              > n_series * SPAN_SAMPLES,
              f"{ch['name']}'s ledger record {rec0}")
        n = ch["vars"]["devicecost"]["launches"]
        launches[ch["name"]] = n.get("cluster_merge", 0)
        check(launches[ch["name"]] > 0 or dev != "cuda",
              f"child {ch['name']} launched no cluster merge")
        check(n.get("cluster_merge.wide", 0) == 0,
              f"child {ch['name']} merged wide: {n}")
    out.update({
        "ready_s": {ch["name"]: ch["ready_s"] for ch in children},
        "warmup": w, "fed_s": fed_s, "feed_s": feed_s,
        "cpu_reference_s": cpu_s,
        "child_device_steps": {ch["name"]: _device_steps(
            ch["vars"]["devicecost"]) for ch in fed},
        "spans": n_spans,
        "series": n_series, "services": n_services,
        "samples": n_series * SPAN_SAMPLES + 4 * n_services,
        "flush_vs_cpu": flushes, "p99_rel_err": p99,
        "version": version, "builddate": builddate,
        "watchdog_exit": c["proc"].returncode,
        "quit_exit": {ch["name"]: ch["proc"].returncode for ch in fed},
        "ledger_received": {ch["name"]: ch["ledger"][0]["received"]
                            for ch in fed},
        "kernel_drops": {ch["name"]: ch["vars"]["sockets"][
            "kernel_drops_total"] for ch in fed},
        "cluster_merge_launches": sum(launches.values()),
        "launches_by_child": launches, "cpu_merges": calls,
        "launches_match_cpu_merges": all(v == calls
                                         for v in launches.values()),
        "merge_shapes": shapes,
        "phase_s": time.perf_counter() - t_phase})
    emit(out)
    return out


# ---- phase 15: the ingest edge ----------------------------------------------

EDGE_SHORT = 6            # samples a counter or gauge series (phase 4: ~62)
EDGE_SAMPLES = 100        # samples a timer series, members a set (cut: 1,000)
EDGE_LINES = 25           # lines a datagram (bench.py --sockets' batch shape)
EDGE_SENDERS = 8          # source sockets; series i rides socket i % 8
EDGE_WINDOW = 1024        # datagrams in flight to a child before a wait
EDGE_INTERVAL_S = 30      # the UDP children's and the locals' interval
EDGE_GLOBAL_S = 50        # the globals': one forward lands before it ends
EDGE_STAGE = 4_000_000    # staging bound past the interval's samples
RATE_WINDOW_S = 4.0       # an unpaced send (bench.py --sockets: 12 s)
TLS_WINDOW_S = 2.0        # sequential handshakes (bench.py --tls: 8 s)

# the unpaced sender of (b): bench.py --sockets' loadgen in a process of
# its own (4,096 prebuilt counter datagrams over 1,000 names, round
# robin over its sockets); prints datagrams offered and seconds
RATE_SENDER = r"""
import socket, sys, time
port, lpp, n_socks, secs = (int(sys.argv[1]), int(sys.argv[2]),
                            int(sys.argv[3]), float(sys.argv[4]))
pkts = [b"\n".join(b"svc.req.count.%d:%d|c" % ((i * lpp + j) % 1000,
                                               1 + j % 9)
                   for j in range(lpp)) for i in range(4096)]
socks = []
for _ in range(n_socks):
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.connect(("127.0.0.1", port))
    socks.append(s)
mask, n, t0 = n_socks - 1, 0, time.perf_counter()
end = t0 + secs
while time.perf_counter() < end:
    for k, p in enumerate(pkts):
        try:
            socks[k & mask].send(p)
        except OSError:
            pass
        n += 1
print(n, time.perf_counter() - t0)
"""


def edge_traffic(seed: int = 15, scale: int = 1) -> dict:
    """Phase 15's interval: phase 4's series at full width (16,000
    counters and 16,000 gauges of ``EDGE_SHORT`` samples, 10,000 timers
    of ``EDGE_SAMPLES`` gamma(2, 30) samples, 1,024 sets of
    ``EDGE_SAMPLES`` members; integer counter increments), each series
    on one of ``EDGE_SENDERS`` source sockets, shuffled within its
    socket and cut into ``EDGE_LINES``-line datagrams.  ``order`` is the
    send order (the sockets in turn), the same for every child."""
    rng = np.random.default_rng(seed)
    per = [[] for _ in range(EDGE_SENDERS)]
    nc, ng, nt, ns = (N_COUNTER // scale, N_GAUGE // scale,
                      N_TIMER // scale, N_SET // scale)
    cv = rng.integers(1, 10, (nc, EDGE_SHORT)).tolist()
    gv = rng.normal(10.0, 3.0, (ng, EDGE_SHORT)).tolist()
    tv = rng.gamma(2.0, 30.0, (nt, EDGE_SAMPLES))
    sv = rng.integers(0, 2 ** 62, (ns, EDGE_SAMPLES)).tolist()
    for i in range(nc):
        per[i % EDGE_SENDERS] += [b"c%d:%d|c%s" % (i, v, TAGS)
                                  for v in cv[i]]
    for i in range(ng):
        per[i % EDGE_SENDERS] += [b"g%d:%.3f|g%s" % (i, v, TAGS)
                                  for v in gv[i]]
    for i in range(nt):
        per[i % EDGE_SENDERS] += [b"t%d:%.3f|ms%s" % (i, v, TAGS)
                                  for v in tv[i].tolist()]
    for i in range(ns):
        per[i % EDGE_SENDERS] += [b"s%d:m%d|s%s" % (i, m, TAGS)
                                  for m in sv[i]]
    dgrams = []
    for lines in per:
        order = rng.permutation(len(lines)).tolist()
        dgrams.append([b"\n".join(lines[j] for j in order[lo:lo +
                                                           EDGE_LINES])
                       for lo in range(0, len(order), EDGE_LINES)])
    send = []
    for k in range(max(len(d) for d in dgrams)):
        send += [(s, d[k]) for s, d in enumerate(dgrams) if k < len(d)]
    # the exact p99 of every timer series, as the flush names it
    exact = {b"t%d" % i: float(np.quantile(
        np.array([float(b"%.3f" % v) for v in tv[i].tolist()]), 0.99))
        for i in range(nt)}
    return {"order": send, "lines": sum(len(p) for p in per),
            "series": {"counter": nc, "gauge": ng, "timer": nt,
                       "set": ns}, "exact_p99": exact}


def udp_drops(port: int) -> int:
    """Kernel receive drops over every UDP socket bound to ``port``
    (``/proc/net/udp{,6}``' drops column)."""
    total = 0
    for name in ("/proc/net/udp", "/proc/net/udp6"):
        try:
            with open(name) as f:
                rows = f.read().splitlines()[1:]
        except OSError:
            continue
        for r in rows:
            col = r.split()
            if int(col[1].rsplit(":", 1)[1], 16) == port:
                total += int(col[-1])
    return total


def edge_provenance() -> dict:
    """(0): the kernel release, the ring probe's errno from the port's
    library, the io_uring sysctl, the effective SO_RCVBUF of a socket
    asked for the readers' 2 MiB, and whether ``openssl`` is on the
    PATH."""
    import shutil
    from veneur_tpu_torch import native
    from veneur_tpu_torch.native import uring
    err = uring.probe(native.load())
    disabled = None
    try:
        with open("/proc/sys/kernel/io_uring_disabled") as f:
            disabled = int(f.read().strip())
    except OSError:
        pass
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 2 * 1048576)
    rcvbuf = s.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)
    s.close()
    res = {"phase": "ingest_edge_env", "kernel_release": os.uname().release,
           "uring_probe_errno": -err,
           "uring_refusal": (None if err == 0 else
                             uring.probe_reason(err) + ": " +
                             os.strerror(-err)),
           "io_uring_disabled": disabled, "effective_rcvbuf": rcvbuf,
           "openssl": shutil.which("openssl")}
    emit(res)
    return res


def edge_certs(d: str) -> dict:
    """Certificates made with ``openssl`` (as tests/test_tls.py makes
    them): a CA and a server and a client pair it signed, with the
    loopback SAN gRPC verifies; a self-signed ECDSA P-256 and RSA 2048
    pair for the handshake rates (bench.py --tls's key types)."""
    def run(*args):
        subprocess.run(["openssl", *args], check=True, capture_output=True,
                       timeout=60)
    out = {"ca": os.path.join(d, "ca.crt")}
    run("req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout",
        os.path.join(d, "ca.key"), "-out", out["ca"], "-days", "1",
        "-subj", "/CN=edge-ca")
    ext = os.path.join(d, "san.ext")
    with open(ext, "w") as f:
        f.write("subjectAltName=IP:127.0.0.1,DNS:localhost\n")
    for name in ("server", "client"):
        key, csr, crt = (os.path.join(d, f"{name}.{x}")
                         for x in ("key", "csr", "crt"))
        run("req", "-newkey", "rsa:2048", "-nodes", "-keyout", key,
            "-out", csr, "-subj", "/CN=127.0.0.1")
        run("x509", "-req", "-in", csr, "-CA", out["ca"], "-CAkey",
            os.path.join(d, "ca.key"), "-CAcreateserial", "-out", crt,
            "-days", "1", "-extfile", ext)
        out[f"{name}_key"], out[f"{name}_crt"] = key, crt
    for label, spec in (("ecdsa_p256", ["-newkey", "ec", "-pkeyopt",
                                        "ec_paramgen_curve:prime256v1"]),
                        ("rsa_2048", ["-newkey", "rsa:2048"])):
        key, crt = (os.path.join(d, f"{label}.{x}") for x in ("key", "crt"))
        run("req", "-x509", *spec, "-nodes", "-keyout", key, "-out", crt,
            "-days", "1", "-subj", "/CN=127.0.0.1", "-addext",
            "subjectAltName=IP:127.0.0.1")
        out[f"{label}_key"], out[f"{label}_crt"] = key, crt
    return out


def first_flush(path: str) -> dict:
    """(name, tags) -> value of a flush file's first flush (the rows of
    its earliest timestamp), self-telemetry aside."""
    rows = []
    with open(path) as f:
        for ln in f.read().splitlines():
            r = ln.split("\t")
            rows.append((int(r[4]), r[0], r[1], float(r[5])))
    t0 = min(r[0] for r in rows)
    out = {}
    for t, name, tags, v in rows:
        if t == t0 and not name.startswith("veneur."):
            check((name, tags) not in out, f"{name} twice in a flush")
            out[(name, tags)] = v
    return out


def order_free(key) -> bool:
    """A flushed value of phase 4's series (gauges are ``g<i>``) that
    does not depend on the order samples came in: counters, set
    cardinalities, counts, min, max, sums (a gauge's last write and a
    percentile do)."""
    name = key[0]
    if name.endswith(("percentile", ".median")):
        return False
    return not name.startswith("g")


def hold_to(got: dict, want: dict, what: str, exact_all: bool,
            gate_pct: bool = True) -> dict:
    """``got`` against ``want``: the same series; order-free values and
    gauges bit for bit; percentiles bit for bit (``exact_all``) or
    within rtol 2e-3 / atol 1e-3 (outside it: a failure, or with
    ``gate_pct`` off a count)."""
    check(got.keys() == want.keys(),
          f"{what}: series differ: {sorted(set(got) - set(want))[:4]} "
          f"{sorted(set(want) - set(got))[:4]}")
    n_free = n_dep = n_pct_bits = n_outside = 0
    max_pct = 0.0
    for key, w in want.items():
        g = got[key]
        pct = key[0].endswith(("percentile", ".median"))
        n_free += order_free(key)
        n_dep += not order_free(key)
        if not pct or exact_all:
            check(g == w, f"{what}: {key} {g!r} != {w!r}")
            n_pct_bits += pct
            continue
        n_pct_bits += g == w
        max_pct = max(max_pct, abs(g - w))
        if abs(g - w) > 1e-3 + 2e-3 * abs(w):
            check(not gate_pct, f"{what}: {key} {g} vs {w}")
            n_outside += 1
    return {"series": len(want), "order_free": n_free,
            "order_dependent": n_dep, "percentiles_bit_equal": n_pct_bits,
            "percentiles_outside_tolerance": n_outside,
            "percentile_max_abs_diff": max_pct}


def edge_rate(child: dict, lpp: int, n_socks: int) -> dict:
    """One unpaced ``RATE_WINDOW_S`` send from ``RATE_SENDER`` into a
    child: what it received and processed, its ENOBUFS, kernel drops
    and fallbacks, its device steps' CUDA-event seconds, and the card's
    idle share over the window by them."""
    port = child["ports"]["udp"]

    def snap():
        v = child_stats(child["ports"]["http"])
        st = v["stats"]
        return {"pkts": st.get("received_dogstatsd-udp", 0),
                "samples": st.get("metrics_processed", 0),
                "enobufs": st.get("socket_uring_enobufs", 0),
                "fallbacks": st.get("socket_backend_fallback", 0),
                "device_ns": v["devicecost"]["device_duration_ns"] or 0,
                "drops": udp_drops(port)}
    before = snap()
    run = subprocess.run(
        [sys.executable, "-c", RATE_SENDER, str(port), str(lpp),
         str(n_socks), str(RATE_WINDOW_S)], capture_output=True,
        text=True, timeout=RATE_WINDOW_S + 30)
    check(run.returncode == 0, f"rate sender: {run.stderr[-500:]}")
    offered, secs = run.stdout.split()
    offered, secs = int(offered), float(secs)
    time.sleep(0.5)  # the readers' last batches
    after = snap()
    d = {k: after[k] - before[k] for k in before}
    device_s = d["device_ns"] / 1e9
    return {"backend": child["backend"], "readers": child["readers"],
            "lines_per_packet": lpp, "sockets": n_socks, "seconds": secs,
            "offered_packets": offered, "received_packets": d["pkts"],
            "received_pct": 100.0 * d["pkts"] / max(offered, 1),
            "packets_per_s": d["pkts"] / secs,
            "samples_per_s": d["samples"] / secs,
            "enobufs": d["enobufs"], "kernel_drops": d["drops"],
            "fallbacks": d["fallbacks"], "device_steps_s": device_s,
            "card_idle_share": 1.0 - device_s / secs}


def tls_rate(port: int) -> dict:
    """Sequential full handshakes against a TLS TCP statsd listener for
    ``TLS_WINDOW_S`` (connect, handshake, one line, close; the client
    verifies no chain, as bench.py --tls)."""
    import ssl
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    conns = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < TLS_WINDOW_S:
        raw = socket.create_connection(("127.0.0.1", port), timeout=5)
        with ctx.wrap_socket(raw) as tls:
            tls.sendall(b"tls.bench:1|c\n")
        conns += 1
    dt = time.perf_counter() - t0
    return {"conns": conns, "seconds": dt, "conns_per_s": conns / dt}


def phase_ingest_edge(dev: str = "cuda", scale: int = 1) -> dict:
    """Phase 15: the ingest edge, port servers as child processes.
    (a) phase 4's series over loopback UDP, paced on each child's
    received counter, into a ``uring`` server and a ``recvmmsg`` server
    with one reader each (their flushes bit-equal) and a ``uring``
    server with four (bit-equal too: each series rides one source
    socket, so one reader, and the interval's one device step runs at
    the swap), each held to a CPU port server on the same datagrams;
    (b) unpaced rates, both packet shapes, both tiers, 1 and 4 readers;
    (c) TLS handshake rates for ECDSA and RSA keys, a client without a
    certificate refused by an mTLS server, and a local forwarding (a)'s
    interval over gRPC with ``forward_grpc_tls_ca`` and a client pair
    to an mTLS global, whose flush equals the plaintext chain's; (d) a
    child on ``http_address: einhorn@0``.  ``scale`` > 1 (a CPU
    rehearsal) divides the series and the table rows."""
    from concurrent.futures import ThreadPoolExecutor
    from veneur_tpu_torch import native
    from veneur_tpu_torch.core.config import read_config
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.ops import cluster_merge

    t_phase = time.perf_counter()
    env = edge_provenance()
    granted = env["uring_probe_errno"] == 0
    check(env["openssl"] is not None, "openssl is not on the PATH")
    traffic = edge_traffic(scale=scale)
    # rows past the series (phase 4's fill 16,000 of 16,384 counter and
    # gauge rows and all 1,024 set rows): at the default sizes the
    # occupancy input (0.95) would engage overload pressure after the
    # first flush, and the readers would take the admission path
    rows = {"tpu_counter_rows": 32768 // scale, "tpu_gauge_rows":
            32768 // scale, "tpu_histo_rows": 16384 // scale,
            "tpu_set_rows": 2048 // scale}
    out = {"phase": "ingest_edge", "device": dev,
           "lines": traffic["lines"], "datagrams": len(traffic["order"]),
           "series": traffic["series"]}
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke-") as tmp:
        certs = edge_certs(tmp)
        cache = os.path.join(tmp, "build")
        os.makedirs(cache)
        libs = [native.build()]
        if dev == "cuda":
            libs.append(cluster_merge.build())
        for lib in libs:
            with open(lib, "rb") as src, \
                    open(os.path.join(cache, os.path.basename(lib)),
                         "wb") as dst:
                dst.write(src.read())
        base = {"hostname": "edge", "interval": f"{EDGE_INTERVAL_S}s",
                "http_quit": True, "percentiles": [0.5, 0.75, 0.99],
                "tpu_stage_flush_samples": EDGE_STAGE,
                "compile_cache_dir": cache, **rows}
        g_ports = {n: free_tcp_port() for n in ("tls", "plain")}
        specs = {
            "uring1": {"tpu_ingest_backend": "uring", "num_readers": 1},
            "recvmmsg1": {"tpu_ingest_backend": "recvmmsg",
                          "num_readers": 1},
            "uring4": {"tpu_ingest_backend": "uring", "num_readers": 4},
            "recvmmsg4": {"tpu_ingest_backend": "recvmmsg",
                          "num_readers": 4},
            "local_tls": {"forward_use_grpc": True,
                          "forward_address": f"127.0.0.1:{g_ports['tls']}",
                          "forward_grpc_tls_ca": certs["ca"],
                          "tls_key": certs["client_key"],
                          "tls_certificate": certs["client_crt"]},
            "local_plain": {"forward_use_grpc": True, "forward_address":
                            f"127.0.0.1:{g_ports['plain']}"},
            "global_tls": {"interval": f"{EDGE_GLOBAL_S}s",
                           "grpc_listen_addresses": [
                               f"tcp://127.0.0.1:{g_ports['tls']}"],
                           "tls_key": certs["server_key"],
                           "tls_certificate": certs["server_crt"],
                           "tls_authority_certificate": certs["ca"]},
            "global_plain": {"interval": f"{EDGE_GLOBAL_S}s",
                             "grpc_listen_addresses": [
                                 f"tcp://127.0.0.1:{g_ports['plain']}"]},
            "tls_ecdsa": {"tls_key": certs["ecdsa_p256_key"],
                          "tls_certificate": certs["ecdsa_p256_crt"],
                          "http_address": "einhorn@0"},
            "tls_rsa": {"tls_key": certs["rsa_2048_key"],
                        "tls_certificate": certs["rsa_2048_crt"]}}
        fed = ("uring1", "recvmmsg1", "uring4", "local_tls", "local_plain")
        # einhorn's master: a listening socket handed down as fd 0 of
        # the worker's set, and a control socket for its ack
        ein = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ein.bind(("127.0.0.1", 0))
        ein.listen(64)
        ctrl_path = os.path.join(tmp, "einhorn.sock")
        ctrl = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        ctrl.bind(ctrl_path)
        ctrl.listen(1)
        ctrl.setblocking(False)
        children = {}
        try:
            for name, over in specs.items():
                ports = {"http": (ein.getsockname()[1]
                                  if name == "tls_ecdsa"
                                  else free_tcp_port())}
                cfg = dict(base, **over)
                if name.startswith(("uring", "recvmmsg", "local")):
                    ports["udp"] = free_udp_port()
                    cfg["statsd_listen_addresses"] = [
                        f"udp://127.0.0.1:{ports['udp']}"]
                if name.startswith("tls") or name == "global_tls":
                    ports["tcp"] = free_tcp_port()
                    cfg["statsd_listen_addresses"] = [
                        f"tcp://127.0.0.1:{ports['tcp']}"]
                cfg.setdefault("http_address",
                               f"127.0.0.1:{ports['http']}")
                cfg["flush_file"] = os.path.join(tmp, f"{name}.tsv")
                path = os.path.join(tmp, f"{name}.json")
                with open(path, "w") as f:
                    json.dump(cfg, f)
                kw = {}
                if name == "tls_ecdsa":
                    kw = {"pass_fds": [ein.fileno()], "env": dict(
                        os.environ, EINHORN_FD_0=str(ein.fileno()),
                        EINHORN_SOCK_PATH=ctrl_path)}
                log = open(os.path.join(tmp, f"{name}.log"), "w")
                proc = subprocess.Popen(
                    [sys.executable, "-m", "veneur_tpu_torch.cli.main",
                     "-f", path, "--device", dev], cwd=HERE, stdout=log,
                    stderr=subprocess.STDOUT, **kw)
                children[name] = {
                    "name": name, "proc": proc, "log": log,
                    "ports": ports, "flush": cfg["flush_file"],
                    "t0": time.perf_counter(),
                    "backend": over.get("tpu_ingest_backend", "auto"),
                    "readers": over.get("num_readers", 1)}
            ack = []

            def all_ready():
                if not ack:
                    try:
                        conn, _ = ctrl.accept()
                        conn.settimeout(10)
                        with conn:
                            ack.append(json.loads(conn.recv(4096)))
                    except BlockingIOError:
                        pass
                for ch in children.values():
                    check(ch["proc"].poll() is None,
                          f"child {ch['name']} exited before READY")
                    if ("ready_s" not in ch
                            and _healthy(ch["ports"]["http"])):
                        ch["ready_s"] = time.perf_counter() - ch["t0"]
                return all("ready_s" in ch for ch in children.values())
            wait_for(all_ready, 180, "the edge children READY")
            wait_for(lambda: all_ready() and ack, 30, "the einhorn ack")
            t_ready = time.perf_counter()
            einhorn = {"ack": ack[0],
                       "child_pid": children["tls_ecdsa"]["proc"].pid,
                       "healthcheck": http_get(ein.getsockname()[1],
                                               "/healthcheck").decode(),
                       "version": http_get(ein.getsockname()[1],
                                           "/version").decode()}
            check(einhorn["ack"] == {"command": "worker:ack",
                                     "pid": einhorn["child_pid"]},
                  f"einhorn ack {einhorn}")
            check(einhorn["healthcheck"] == "ok" and einhorn["version"],
                  f"einhorn endpoints {einhorn}")
            for ch in children.values():
                ch["vars0"] = child_stats(ch["ports"]["http"])
            backends = {n: children[n]["vars0"]["sockets"]["backend"]
                        for n in ("uring1", "recvmmsg1", "uring4",
                                  "recvmmsg4")}
            if granted:
                check(backends["uring1"] == backends["uring4"] == "uring",
                      f"the probe grants io_uring, yet {backends}")
            else:
                reason = env["uring_refusal"].split(":")[0]
                for n in ("uring1", "uring4"):
                    st = children[n]["vars0"]["stats"]
                    check(backends[n] == "recvmmsg" and st.get(
                        f"socket_backend_fallback_{reason}") == 1,
                          f"{n} on a refusing kernel: {backends[n]} "
                          f"{st}")
            check(backends["recvmmsg1"] == backends["recvmmsg4"] ==
                  "recvmmsg", f"backends {backends}")
            out.update({"ready_s": {n: ch["ready_s"]
                                    for n, ch in children.items()},
                        "backends": backends, "einhorn": einhorn})

            # (a) the interval, paced, to the fed children
            def cpu_reference():
                """A CPU global and a CPU local -> CPU global chain on
                the same datagrams (batches of 512, the sweep's bound),
                each flushed once, then once more: the flushes and the
                merges by shape the children's run (unit: the swaps of
                the UDP children and the locals, and the next
                interval's self-telemetry timers; weighted: the
                globals' import folds)."""
                t_cpu = time.perf_counter()
                order = traffic["order"]
                cfg = {k: v for k, v in base.items()
                       if k not in ("compile_cache_dir", "http_quit")}
                cfg["interval"] = "3600s"
                g = Server(read_config(data=dict(
                    cfg, grpc_listen_addresses=["tcp://127.0.0.1:0"]),
                    env={}), device="cpu")
                g.start()
                srvs = [Server(read_config(data=cfg, env={}),
                               device="cpu"),
                        Server(read_config(data=dict(
                            cfg, forward_use_grpc=True,
                            forward_address=f"127.0.0.1:{g.grpc_ports[0]}"),
                            env={}), device="cpu")]
                try:
                    for lo in range(0, len(order), 512):
                        batch = [d for _s, d in order[lo:lo + 512]]
                        for s in srvs:
                            s.handle_packet_batch(batch)
                    with MergeRecorder() as unit:
                        flushes = [s.flush_once().metrics for s in srvs]
                    wait_for(lambda: g.stats.get("imports_received", 0)
                             >= 1, 120, "the CPU global's import")
                    with MergeRecorder() as weighted:
                        glob = g.flush_once().metrics
                    # the next interval: the self-telemetry's timers
                    with MergeRecorder() as tele:
                        for s in srvs + [g]:
                            s.flush_once()
                    shapes: dict = {}
                    for m in unit.table() + tele.table():
                        key = (m["rows"], m["k"])
                        shapes[key] = shapes.get(key, 0) + m["calls"]
                    return (flushes[0], glob,
                            [{"rows": r, "k": k, "calls": c}
                             for (r, k), c in sorted(shapes.items())],
                            weighted.table(), time.perf_counter() - t_cpu)
                finally:
                    for s in srvs + [g]:
                        s.shutdown()
            socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                     for _ in range(EDGE_SENDERS)]
            t_feed = time.perf_counter()
            order = traffic["order"]
            for lo in range(0, len(order), EDGE_WINDOW):
                chunk = order[lo:lo + EDGE_WINDOW]
                for n in fed:
                    addr = ("127.0.0.1", children[n]["ports"]["udp"])
                    for s, d in chunk:
                        socks[s].sendto(d, addr)
                want = lo + len(chunk)
                for n in fed:
                    ch = children[n]
                    wait_for(lambda ch=ch: child_stats(ch["ports"][
                        "http"])["stats"].get("received_dogstatsd-udp", 0)
                        >= want, 60, f"{n}'s read of the window",
                        ch["proc"])
            for s in socks:
                s.close()
            fed_s = time.perf_counter() - t_feed
            pool = ThreadPoolExecutor(1)
            cpu_ref = pool.submit(cpu_reference)
            fed_vars = {}
            for n in fed:
                v = child_stats(children[n]["ports"]["http"])
                st = v["stats"]
                check(st.get("flushes", 0) == 0,
                      f"{n} flushed before its traffic was in "
                      f"({fed_s:.1f} s of feed)")
                check(st.get("received_dogstatsd-udp") == len(order),
                      f"{n} received {st.get('received_dogstatsd-udp')}")
                check(st.get("socket_uring_enobufs", 0) == 0,
                      f"{n}: ENOBUFS {st.get('socket_uring_enobufs')}")
                check(udp_drops(children[n]["ports"]["udp"]) == 0,
                      f"{n}: kernel drops")
                fed_vars[n] = v
            want_one, want_glob, unit_shapes, w_shapes, cpu_s = \
                cpu_ref.result()
            pool.shutdown()

            def sealed(ch):
                return json.loads(http_get(ch["ports"]["http"],
                                           "/debug/ledger"))["records"]
            for n in ("uring1", "recvmmsg1", "uring4"):
                ch = children[n]
                wait_for(lambda ch=ch: sealed(ch), 120,
                         f"{n}'s first flush", ch["proc"])
                ch["ledger"] = sealed(ch)[0]
            flushes = {n: first_flush(children[n]["flush"])
                       for n in ("uring1", "recvmmsg1", "uring4")}
            parity = {
                "uring1_vs_recvmmsg1": hold_to(
                    flushes["uring1"], flushes["recvmmsg1"],
                    "uring1 vs recvmmsg1", exact_all=True),
                "uring4_vs_uring1": hold_to(
                    flushes["uring4"], flushes["uring1"],
                    "uring4 vs uring1", exact_all=True)}

            def as_flush(metrics):
                return {(m.name, ",".join(m.tags)): m.value for m in metrics
                        if not m.name.startswith("veneur.")}
            parity["uring1_vs_cpu"] = hold_to(
                flushes["uring1"], as_flush(want_one), "uring1 vs the CPU",
                exact_all=False)
            ledgers = {}
            for n in ("uring1", "recvmmsg1", "uring4"):
                rec = children[n]["ledger"]
                check(rec["balanced"] and rec["received"].get(
                    "dogstatsd") == traffic["lines"],
                      f"{n}'s ledger record {rec}")
                ledgers[n] = {k: rec[k] for k in ("balanced", "received")}
            errs = []
            for name, exact in traffic["exact_p99"].items():
                key = (name.decode() + ".99percentile", "env:smoke")
                errs.append(abs(flushes["uring1"][key] - exact) / exact)
            p99 = {"median": float(np.median(errs)),
                   "max": float(np.max(errs))}
            check(p99["median"] < 0.01, f"p99 median error {p99}")
            out.update({"feed_s": fed_s, "cpu_reference_s": cpu_s,
                        "parity": parity, "ledgers": ledgers,
                        "p99_rel_err": p99,
                        "merge_shapes": unit_shapes,
                        "weighted_shapes": w_shapes})

            # (b) unpaced rates: both shapes, both tiers, 1 and 4 readers
            rates = {}
            for lpp, label in ((1, "single_line"), (25, "batch_25")):
                for readers, socks_n in ((1, 1), (4, 8)):
                    for tier in ("uring", "recvmmsg"):
                        key = f"{label}_{tier}{readers}"
                        rates[key] = edge_rate(
                            children[f"{tier}{readers}"], lpp, socks_n)
                        emit({"phase": "ingest_edge_rate", "run": key,
                              **rates[key]})
            ratios = {}
            for lpp, label in ((1, "single_line"), (25, "batch_25")):
                for readers in (1, 4):
                    u = rates[f"{label}_uring{readers}"]
                    r = rates[f"{label}_recvmmsg{readers}"]
                    ratios[f"{label}_{readers}"] = {
                        "pps_ratio": u["packets_per_s"] /
                        max(r["packets_per_s"], 1.0),
                        "delivery_points": u["received_pct"] -
                        r["received_pct"]}
            if granted:
                for key, rt in ratios.items():
                    check(rt["pps_ratio"] >= 0.9 and
                          rt["delivery_points"] >= -2.0,
                          f"uring under recvmmsg at {key}: {rt}")
            out.update({"rates": rates, "uring_over_recvmmsg": ratios})

            # (c) TLS: handshake rates, the mTLS refusal, the chain
            import ssl
            tls = {"ecdsa_p256": tls_rate(children["tls_ecdsa"]["ports"]
                                          ["tcp"]),
                   "rsa_2048": tls_rate(children["tls_rsa"]["ports"]
                                        ["tcp"])}
            for label, n in (("ecdsa_p256", "tls_ecdsa"),
                             ("rsa_2048", "tls_rsa")):
                ch = children[n]
                wait_for(lambda ch=ch, label=label: child_stats(
                    ch["ports"]["http"])["stats"].get(
                    "received_dogstatsd-tcp", 0) == tls[label]["conns"],
                    30, f"{n}'s lines", ch["proc"])
            gtls = children["global_tls"]
            ctx = ssl.create_default_context(cafile=certs["ca"])
            ctx.check_hostname = False
            raw = socket.create_connection(
                ("127.0.0.1", gtls["ports"]["tcp"]), timeout=10)
            try:
                with ctx.wrap_socket(raw) as s:
                    s.sendall(b"edge.nocert:1|c\n")
                    # TLS 1.3: the server's alert comes after the
                    # client's handshake; an end of stream is a refusal
                    refused = s.recv(1) == b""
            except (ssl.SSLError, ConnectionResetError):
                refused = True
            wait_for(lambda: child_stats(gtls["ports"]["http"])["stats"].get(
                "tls_handshake_errors", 0) == 1, 30,
                "the refused handshake counted", gtls["proc"])
            check(refused, "an mTLS server took a client without a "
                           "certificate")
            for n in ("global_tls", "global_plain"):
                ch = children[n]
                wait_for(lambda ch=ch: sealed(ch), EDGE_GLOBAL_S + 60,
                         f"{n}'s first flush", ch["proc"])
                ch["vars"] = child_stats(ch["ports"]["http"])
                check(ch["vars"]["stats"].get("imports_received", 0) >= 1,
                      f"{n} imported nothing")
            for n in ("local_tls", "local_plain"):
                st = child_stats(children[n]["ports"]["http"])["stats"]
                check(st.get("forward_errors", 0) == 0 and
                      st.get("forwarded_rows", 0) > 0,
                      f"{n}'s forward: {st}")
            chain = {"tls_vs_plain": hold_to(
                first_flush(gtls["flush"]),
                first_flush(children["global_plain"]["flush"]),
                "the TLS chain vs the plaintext chain", exact_all=True),
                "tls_vs_cpu": hold_to(
                first_flush(gtls["flush"]), as_flush(want_glob),
                "the TLS chain vs the CPU chain", exact_all=False,
                gate_pct=False)}
            out.update({"tls_handshakes": tls,
                        "mtls_refused": {"client_refused": refused,
                                         "tls_handshake_errors": 1},
                        "chain": chain})

            # the launches of the phase: every child's, from a zero start
            launches = {}
            for n, ch in children.items():
                v = child_stats(ch["ports"]["http"])
                ch["vars"] = v
                lc = v["devicecost"]["launches"]
                check(lc.get("cluster_merge.wide", 0) == 0,
                      f"{n} merged wide: {lc}")
                launches[n] = lc.get("cluster_merge", 0)
            if dev == "cuda":
                for n in ("uring1", "recvmmsg1", "uring4", "local_tls",
                          "local_plain", "global_tls", "global_plain"):
                    check(launches[n] > 0, f"{n} launched no merge")
            out.update({
                "cluster_merge_launches": sum(launches.values()),
                "launches_by_child": launches,
                "child_device_steps": {
                    n: _device_steps(ch["vars"]["devicecost"])
                    for n, ch in children.items()},
                "rings": {n: children[n]["vars"]["sockets"]["uring"]
                          for n in ("uring1", "uring4")}})
            for ch in children.values():
                check(http_get(ch["ports"]["http"], "/quitquitquit")
                      == b"terminating", f"{ch['name']} /quitquitquit")
            for ch in children.values():
                try:
                    ch["proc"].wait(timeout=60)
                except subprocess.TimeoutExpired:
                    pass
        finally:
            for ch in children.values():
                if ch["proc"].poll() is None:
                    ch["proc"].kill()
                    ch["proc"].wait()
                ch["log"].close()
            ein.close()
            ctrl.close()
        logs = {}
        for n in children:
            with open(os.path.join(tmp, f"{n}.log")) as f:
                logs[n] = f.read()
    for n, ch in children.items():
        check(ch["proc"].returncode == 0,
              f"child {n} exit {ch['proc'].returncode}: {logs[n][-2000:]}")
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


def _device_steps(dc: dict) -> dict:
    """A child's launch registry in brief: device steps run, the host
    seconds spent enqueueing them and their CUDA-event seconds."""
    ks = dc["kernels"].values()
    dev_ns = dc["device_duration_ns"]
    return {"calls": sum(k["calls"] for k in ks),
            "dispatch_s": sum(k["dispatch_duration_ns"] for k in ks) / 1e9,
            "device_s": dev_ns / 1e9 if dev_ns is not None else None}


def _healthy(port: int) -> bool:
    try:
        return http_get(port, "/healthcheck", timeout=2) == b"ok"
    except OSError:
        return False


def phase_env() -> dict:
    """The gRPC transport's package versions on this host; importing the
    port's generated protobuf modules (they need protobuf >= 3.20) and
    its gRPC tier must succeed."""
    import google.protobuf
    import grpc
    from veneur_tpu_torch.forward import grpc_forward
    from veneur_tpu_torch.forward.gen import forward_pb2
    check(grpc_forward.forward_pb2 is forward_pb2, "generated modules")
    res = {"phase": "env", "grpc": grpc.__version__,
           "protobuf": google.protobuf.__version__}
    emit(res)
    return res


# ---- main --------------------------------------------------------------------

def phase_build() -> dict:
    """Build the CUDA kernel (nvcc) and the native host library (g++)
    at once, one compiler process each."""
    from concurrent.futures import ThreadPoolExecutor
    from veneur_tpu_torch import native
    from veneur_tpu_torch.ops import cluster_merge

    def timed(fn):
        t0 = time.perf_counter()
        path = fn()
        return os.path.relpath(path, HERE), time.perf_counter() - t0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        kern = pool.submit(timed, lambda: cluster_merge.build(verbose=True))
        host = pool.submit(timed, native.build)
        (kern_lib, kern_s), (host_lib, host_s) = kern.result(), host.result()
    native.load()
    res = {"phase": "build", "seconds": time.perf_counter() - t0,
           "kernel_library": kern_lib, "kernel_seconds": kern_s,
           "native_library": host_lib, "native_seconds": host_s}
    emit(res)
    return res


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

    phase_env()
    phase_build()
    kern = phase_kernel()
    wide = phase_wide_merge()
    phase_entry()
    phase_f1()
    table = phase_table()
    readers = phase_readers(table)
    del table["bufs"], table["exact_p99"], table["metrics"]
    # one timed flat interval (and the profiled one) and a quarter of
    # the stacked shape's wires keep the whole script, phases 13-15
    # included, well inside 1,200 s
    glob = phase_global(intervals=1, stack_wires=N_WIRES // 4)
    grpc_in = glob.pop("grpc_input")
    grpc_glob = phase_global_grpc(grpc_in)
    routing = phase_routing(grpc_in, grpc_glob.pop("metrics"))
    del grpc_in
    tiers = phase_tiers()
    crash = phase_crash_riding()
    span = phase_span_plane()
    edge = phase_ingest_edge()
    # phase 2 again, at every other shape phases 4, 6, 8, 9, 10, 12 and
    # 13 merged at: the locals' sample batches unit-weight, the globals'
    # wires weighted (phase 12's local and globals merge together: their
    # shapes are re-checked weighted; phase 13's import folds too)
    cases = recorded_cases(table["merge_shapes"])
    for run in readers["runs"].values():
        cases += recorded_cases(run["merge_shapes"], timed=cases)
    for label in ("flat", "stack"):
        local_shapes, global_shapes = glob["shapes"][label]
        cases += recorded_cases(local_shapes, timed=cases)
        cases += recorded_cases(global_shapes, weighted=True,
                                timed=cases)
    cases += recorded_cases(grpc_glob["merge_shapes"], weighted=True,
                            timed=cases)
    cases += recorded_cases(routing["merge_shapes"], weighted=True,
                            timed=cases)
    cases += recorded_cases(tiers["merge_shapes"], timed=cases)
    cases += recorded_cases(crash["unit_shapes"], timed=cases)
    cases += recorded_cases(crash["weighted_shapes"], weighted=True,
                            timed=cases)
    cases += recorded_cases(span["merge_shapes"], timed=cases)
    cases += recorded_cases(WARMUP_SHAPES, timed=cases)
    cases += recorded_cases(edge["merge_shapes"], timed=cases)
    cases += recorded_cases(edge["weighted_shapes"], weighted=True,
                            timed=cases)
    kern.update(phase_kernel(cases=cases))
    phase_server()
    phase_chain()

    # the kernel line reports the shape the main path launched most
    top = max(table["merge_shapes"], key=lambda m: m["calls"])
    k = next(r for r in kern.values()
             if (r["rows"], r["k"]) == (top["rows"], top["k"]))
    by_path = {"table_interval": table["cluster_merge_launches"],
               "global_tier": sum(glob[s]["cluster_merge_launches"]
                                  for s in ("flat", "stack")),
               "global_tier_grpc": grpc_glob["cluster_merge_launches"],
               "multi_reader": {n: r["cluster_merge_launches"]
                                for n, r in readers["runs"].items()},
               "tiers": tiers["cluster_merge_launches"],
               "routing_tiers": routing["cluster_merge_launches"],
               "crash_riding": crash["cluster_merge_launches"],
               "span_plane": span["cluster_merge_launches"],
               "ingest_edge": edge["cluster_merge_launches"]}
    shapes_by_path = {"multi_reader": {n: r["merge_shapes"] for n, r in
                                       readers["runs"].items()},
                      "tiers": tiers["merge_shapes"],
                      "routing_tiers": routing["merge_shapes"],
                      "crash_riding": {"unit": crash["unit_shapes"],
                                       "weighted":
                                           crash["weighted_shapes"]},
                      "span_plane": span["merge_shapes"],
                      "ingest_edge": {"unit": edge["merge_shapes"],
                                      "weighted":
                                          edge["weighted_shapes"]}}
    emit({"kernels": [{
        "name": "cluster_merge", "route": "cuda",
        "source": "veneur_tpu_torch/csrc/cluster_merge.cu",
        "replaces": "veneur_tpu/ops/pallas_merge.py:192",
        "launches": sum(v if isinstance(v, int) else sum(v.values())
                        for v in by_path.values()),
        "launches_by_path": by_path,
        "merge_shapes_by_path": shapes_by_path,
        "max_abs_err": k["quantile_max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None,
        "rows": k["rows"], "k": k["k"],
        "wide": {label: {key: r[key] for key in
                         ("rows", "cap", "k", "ms", "plain_ms", "bound_ms",
                          "quantile_max_abs_err")}
                 for label, r in wide.items()}}]})
    check("jax" not in sys.modules, "something imported jax")
    check(not any(m.startswith("veneur_tpu.") for m in sys.modules),
          "something imported the JAX package")
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
