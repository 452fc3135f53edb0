"""Sharded aggregation: the global tier over a grid of places.

Port of ``veneur_tpu/parallel/sharded.py``.  The reference runs the
global tier as one SPMD program over a 2D device mesh; here the mesh is
a grid of **places**.  A place is a ``torch.device`` and may repeat:
eight places on ``cuda:0`` hold eight partial states on one card, as
eight virtual CPU devices do for the reference's tests.

  axis ``shard``   — ingest parallelism.  Each place along this axis
                     accumulates PARTIAL state for every series from its
                     own slice of the sample stream; merging partials is
                     the CRDT merge the reference does at import time,
                     done once per flush.
  axis ``series``  — table-row parallelism.  The row dimension of every
                     state plane is partitioned into ``series`` blocks.

State planes (one partial per place, block-local rows):

  counters      f32[Rc/N]      merge: sum over shards
  gauges        f32[Rg/N]      merge: value at the max arrival ticket
  gauge_ticket  i32[Rg/N]
  histo_stats   f32[R/N, 5]    merge: sum / min / max per column
  histo_means   f32[R/N, C]    merge: gather the shards' slots + one
  histo_weights f32[R/N, C]           k-scale re-cluster (ops.tdigest)
  hll           u8[Rs/N, M]    merge: register max over shards

The places of one device keep their partials stacked along the row
axis, so an update step is one launch per device (the merge is
row-parallel) and the flush merge of a one-device mesh is one launch
over every series block at width ``S * C``.  Places of one process
reduce in a fixed shard order; places of other processes (after
``init_process_mesh``) reduce over a ``torch.distributed`` process
group: sums as ``all_reduce(SUM)`` in f64, max and min as
``all_reduce(MAX/MIN)``, the slot gather as ``all_gather_into_tensor``,
process-major.  A failed process group, a mesh that does not divide
or a kernel failure raises.
"""

from __future__ import annotations

import datetime
import os
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from veneur_tpu_torch import native, observe, resolve_device
from veneur_tpu_torch.ops import hll as hll_ops
from veneur_tpu_torch.ops import segment, tdigest
from veneur_tpu_torch.ops.segment import (HISTO_STAT_COLS, STAT_MAX,
                                          STAT_MAX_EMPTY, STAT_MIN,
                                          STAT_MIN_EMPTY, STAT_RSUM,
                                          STAT_SUM, STAT_WEIGHT)

SHARD = "shard"
SERIES = "series"

# the process group's default timeout (init_process_mesh): a peer that
# never joins fails the job instead of blocking it
DIST_TIMEOUT_S = 120.0


def _dist():
    import torch.distributed as dist
    return dist


def _world_group():
    """The default process group when one is initialized, else None."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def _norm(dev) -> torch.device:
    d = torch.device(dev)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def default_places(device: "str | torch.device" = "cuda"
                   ) -> list[torch.device]:
    """The visible devices of ``device``'s type: every card for
    ``cuda``, one place for ``cpu``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


class Mesh:
    """A (shard, series) grid of places.  ``places`` are THIS
    process's places in row-major order; with a process group the
    grid spans every process, process-major, and each process holds
    whole shard rows.  ``groups`` lists each device with the local
    places (shard, series) it holds, in row-major order."""

    def __init__(self, places, n_shard_local: int, n_series: int,
                 group=None):
        self.group = group
        dist = _dist()
        self.n_proc = dist.get_world_size(group) if group is not None \
            else 1
        self.rank = dist.get_rank(group) if group is not None else 0
        grid = np.empty((n_shard_local, n_series), object)
        for k, p in enumerate(places):
            grid[k // n_series, k % n_series] = _norm(p)
        self.places = grid
        self.n_local_shard = n_shard_local
        self.shape = {SHARD: n_shard_local * self.n_proc,
                      SERIES: n_series}
        groups: dict = {}
        for i in range(n_shard_local):
            for j in range(n_series):
                groups.setdefault(grid[i, j], []).append((i, j))
        self.groups = list(groups.items())
        self.home = grid[0, 0]

    @property
    def size(self) -> int:
        return self.shape[SHARD] * self.shape[SERIES]


def make_mesh(places=None, n_shard: int | None = None,
              group=None) -> Mesh:
    """Build the 2D (shard, series) mesh over ``places`` (default: the
    visible cards).  With a process group (default: the initialized
    world group) the mesh spans every process's places.

    Default split: series axis gets 2 when the place count is even and
    >2, else 1."""
    places = list(places) if places is not None else default_places()
    group = group if group is not None else _world_group()
    n_proc = _dist().get_world_size(group) if group is not None else 1
    n = len(places) * n_proc
    if n_shard is None:
        n_series = 2 if n % 2 == 0 and n > 2 else 1
        n_shard = n // n_series
    else:
        if n_shard <= 0 or n % n_shard:
            raise ValueError(f"{n} places not divisible by {n_shard}")
        n_series = n // n_shard
    if len(places) % n_series:
        raise ValueError(
            f"each process must hold whole shard rows: {len(places)} "
            f"places per process, {n_series} series")
    return Mesh(places, len(places) // n_series, n_series, group)


@dataclass(frozen=True)
class ShardedConfig:
    rows: int = 1024          # histo/timer table rows (global)
    set_rows: int = 64
    # counter/gauge cardinality can far exceed histo cardinality; 0
    # inherits ``rows``
    counter_rows: int = 0
    gauge_rows: int = 0
    compression: float = 100.0
    slots: int = 64           # densify slots per update call
    batch: int = 1024         # per-shard samples per update call

    def capacity(self) -> int:
        return tdigest.capacity_for(self.compression)

    def c_rows(self) -> int:
        return self.counter_rows or self.rows

    def g_rows(self) -> int:
        return self.gauge_rows or self.rows


def _local_rows(mesh: Mesh, cfg: ShardedConfig) -> dict[str, int]:
    n = mesh.shape[SERIES]
    if (cfg.rows % n or cfg.set_rows % n or cfg.c_rows() % n or
            cfg.g_rows() % n):
        raise ValueError("rows must divide by the series axis size")
    return {"counters": cfg.c_rows() // n, "gauges": cfg.g_rows() // n,
            "gauge_ticket": cfg.g_rows() // n,
            "histo_stats": cfg.rows // n, "histo_means": cfg.rows // n,
            "histo_weights": cfg.rows // n, "hll": cfg.set_rows // n}


_PLANES = ("counters", "gauges", "gauge_ticket", "histo_stats",
           "histo_means", "histo_weights", "hll")


def empty_state(mesh: Mesh, cfg: ShardedConfig) -> list[dict]:
    """The mesh's partial state: one dict of planes per device group,
    each plane the group's places stacked along the row axis."""
    rl = _local_rows(mesh, cfg)
    cap = cfg.capacity()
    out = []
    for dev, plist in mesh.groups:
        k = len(plist)
        stats = segment.empty_histo_stats(k * rl["histo_stats"], dev)
        out.append({
            "counters": torch.zeros(k * rl["counters"],
                                    dtype=torch.float32, device=dev),
            "gauges": torch.zeros(k * rl["gauges"], dtype=torch.float32,
                                  device=dev),
            "gauge_ticket": torch.full((k * rl["gauge_ticket"],), -1,
                                       dtype=torch.int32, device=dev),
            "histo_stats": stats,
            "histo_means": torch.zeros((k * rl["histo_means"], cap),
                                       dtype=torch.float32, device=dev),
            "histo_weights": torch.zeros((k * rl["histo_weights"], cap),
                                         dtype=torch.float32,
                                         device=dev),
            "hll": hll_ops.empty_state(k * rl["hll"], dev),
        })
    return out


BATCH_KEYS = ("counter_rows", "counter_vals", "counter_wts",
              "gauge_rows", "gauge_vals", "gauge_ticket",
              "histo_rows", "histo_vals", "histo_wts",
              "rsum_rows", "rsum_vals",
              "set_rows", "set_idx", "set_rank")


def _localize(rows: np.ndarray, n_local: int, block: int,
              offset: int) -> tuple[np.ndarray, int]:
    """Global row ids -> (the mask of rows inside series block
    ``block``, the shift that makes them flat ids ``local + offset``).
    The reference maps out-of-block rows to the drop sentinel
    ``n_local``; torch's scatters raise on such an index, so they are
    left out here."""
    lo = block * n_local
    return (rows >= lo) & (rows < lo + n_local), offset - lo


def _ticket_gauge(g, gt, rows, tickets, vals):
    """Gauge last-write-wins with a global arrival ticket: scatter max
    of the ticket, then adopt the batch value wherever its ticket won.
    As in the reference, the winning value is scatter-maxed into a
    ZERO plane, so a negative winner lands as 0."""
    new_t = gt.scatter_reduce(0, rows, tickets, "amax", include_self=True)
    cand = torch.where(tickets == new_t[rows], vals,
                       torch.full_like(vals, -torch.inf))
    won = torch.zeros_like(g).scatter_reduce(0, rows, cand, "amax",
                                             include_self=True)
    return torch.where(new_t > gt, won, g), new_t


def make_update_step(mesh: Mesh, cfg: ShardedConfig):
    """The ingest step: ``step(state, batch) -> state`` with ``batch``
    host arrays ``[S_local, n]`` per key (shard-split; every series
    block of a shard sees the shard's whole batch and keeps its own
    rows).  Per-place work only, no communication; one launch per
    device for all the places it holds."""
    rl = _local_rows(mesh, cfg)
    r_local, rc, rg, rs = (rl["histo_stats"], rl["counters"],
                           rl["gauges"], rl["hll"])

    def place_batch(batch, plist):
        """Each key's entries for the group's places, concatenated
        place by place in arrival order, rows made group-flat."""
        out = {k: [] for k in BATCH_KEYS}
        for p, (i, j) in enumerate(plist):
            for grp, n_local, keys in (
                    ("counter_rows", rc, ("counter_vals",
                                          "counter_wts")),
                    ("gauge_rows", rg, ("gauge_vals", "gauge_ticket")),
                    ("histo_rows", r_local, ("histo_vals",
                                             "histo_wts")),
                    ("rsum_rows", r_local, ("rsum_vals",)),
                    ("set_rows", rs, ("set_idx", "set_rank"))):
                rows = batch[grp][i]
                sel, shift = _localize(rows, n_local, j, p * n_local)
                out[grp].append(rows[sel] + shift)
                for k in keys:
                    out[k].append(batch[k][i][sel])
        return {k: np.concatenate(v) for k, v in out.items()}

    def group_step(st: dict, b: dict, dev, k: int) -> dict:
        def t(key, dtype):
            return torch.from_numpy(np.ascontiguousarray(
                b[key], dtype)).to(dev)

        cnt = segment.counter_update(
            st["counters"], t("counter_rows", np.int64),
            t("counter_vals", np.float32), t("counter_wts", np.float32))

        g, gt = _ticket_gauge(st["gauges"], st["gauge_ticket"],
                              t("gauge_rows", np.int64),
                              t("gauge_ticket", np.int32),
                              t("gauge_vals", np.float32))

        hrow = t("histo_rows", np.int64)
        hv = segment.ftz(t("histo_vals", np.float32))
        hwt = segment.ftz(t("histo_wts", np.float32))
        zero = torch.zeros_like(hv)
        incoming = torch.stack([
            hwt, torch.where(hwt > 0, hv, zero + STAT_MIN_EMPTY),
            torch.where(hwt > 0, hv, zero + STAT_MAX_EMPTY), hv * hwt,
            torch.where(hv != 0, hwt / hv, zero)], dim=1)
        hs = segment.merge_histo_stats(st["histo_stats"], hrow,
                                       incoming)
        # forwarded-digest reciprocal-sum corrections land directly in
        # the RSUM column (the import path stages the exact delta)
        rrow = t("rsum_rows", np.int64)
        if len(rrow):
            hs = hs.clone()
            hs[:, STAT_RSUM] = segment.ftz(
                hs[:, STAT_RSUM].double().index_add(
                    0, rrow, segment.ftz(t("rsum_vals", np.float32))
                    .double()).to(torch.float32))

        dense_v, dense_w = tdigest.densify(hrow, hv, hwt, k * r_local,
                                           cfg.slots)
        hm, hw = tdigest._merge_impl(st["histo_means"],
                                     st["histo_weights"], dense_v,
                                     dense_w, cfg.compression)

        regs = hll_ops.insert(st["hll"], t("set_rows", np.int64),
                              t("set_idx", np.int64),
                              t("set_rank", np.int64))
        return {"counters": cnt, "gauges": g, "gauge_ticket": gt,
                "histo_stats": hs, "histo_means": hm,
                "histo_weights": hw, "hll": regs}

    def step(state: list[dict], batch: dict) -> list[dict]:
        return [group_step(st, place_batch(batch, plist), dev,
                           len(plist))
                for st, (dev, plist) in zip(state, mesh.groups)]

    return step


def _grid(mesh: Mesh, state: list[dict], name: str,
          n_local: int) -> torch.Tensor:
    """One plane as ``[S_local, N, n_local, ...]`` on the mesh's home
    place: a view when one device holds every place, else the blocks
    copied there."""
    s_l, n = mesh.n_local_shard, mesh.shape[SERIES]
    if len(mesh.groups) == 1:
        t = state[0][name]
        return t.view(s_l, n, n_local, *t.shape[1:])
    blocks = [[None] * n for _ in range(s_l)]
    for st, (_dev, plist) in zip(state, mesh.groups):
        t = st[name]
        for p, (i, j) in enumerate(plist):
            blocks[i][j] = t[p * n_local:(p + 1) * n_local].to(mesh.home)
    return torch.stack([torch.stack(row) for row in blocks])


def reduce_shards(t: torch.Tensor, op: str, group=None) -> torch.Tensor:
    """Reduce ``t[S_local, ...]`` over the shard axis: in this process
    in a fixed shard order, then over ``group`` (sums accumulate and
    cross processes in f64)."""
    dist = _dist()
    if op == "sum":
        out = t[0].double()
        for k in range(1, t.shape[0]):
            out = out + t[k].double()
        rop = "SUM"
    elif op in ("max", "min"):
        out = t[0].clone()
        f = torch.maximum if op == "max" else torch.minimum
        for k in range(1, t.shape[0]):
            out = f(out, t[k])
        rop = op.upper()
    else:
        raise ValueError(f"unknown reduction {op!r}")
    if group is not None:
        dist.all_reduce(out, op=getattr(dist.ReduceOp, rop), group=group)
    return out


def gather_slots(parts: list[torch.Tensor], group=None) -> torch.Tensor:
    """The shards' ``[U, C]`` planes side by side along the slot axis
    (shard order; process-major across ``group``): the reference's
    ``all_gather(..., axis=1, tiled=True)``."""
    local = torch.cat(parts, dim=1).contiguous()
    if group is None:
        return local
    dist = _dist()
    n_proc = dist.get_world_size(group)
    out = torch.empty((n_proc * local.shape[0], local.shape[1]),
                      dtype=local.dtype, device=local.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, local, group=group)
    return (out.view(n_proc, local.shape[0], local.shape[1])
            .permute(1, 0, 2).reshape(local.shape[0], -1))


def make_merge_step(mesh: Mesh, cfg: ShardedConfig):
    """The flush merge: partial per-shard state -> one merged table on
    the mesh's home place (global row order): counter sum, gauge
    ticket-max, stat sum/min/max, t-digest slot gather + one
    re-cluster, HLL register max (the reference's samplers.go:208
    Counter.Merge, :423 Set.Merge, :726 Histo.Merge)."""
    rl = _local_rows(mesh, cfg)
    group = mesh.group
    ftz = segment.ftz

    def merge(state: list[dict]) -> dict:
        cnt = ftz(reduce_shards(
            ftz(_grid(mesh, state, "counters", rl["counters"])), "sum",
            group).to(torch.float32)).reshape(-1)

        ticket = _grid(mesh, state, "gauge_ticket", rl["gauges"])
        gv_all = _grid(mesh, state, "gauges", rl["gauges"])
        best = reduce_shards(ticket, "max", group)
        cand = torch.where((ticket == best) & (best >= 0), gv_all,
                           torch.full_like(gv_all, -torch.inf))
        gv = reduce_shards(cand, "max", group)
        gauges = torch.where(best >= 0, gv,
                             torch.zeros_like(gv)).reshape(-1)

        hs = ftz(_grid(mesh, state, "histo_stats", rl["histo_stats"]))
        cols = []
        for c, op in ((STAT_WEIGHT, "sum"), (STAT_MIN, "min"),
                      (STAT_MAX, "max"), (STAT_SUM, "sum"),
                      (STAT_RSUM, "sum")):
            cols.append(reduce_shards(hs[..., c], op, group)
                        .to(torch.float32))
        stats = ftz(torch.stack(cols, dim=-1)).reshape(-1,
                                                       HISTO_STAT_COLS)

        # digest union: every shard's centroid slots side by side, then
        # one batched re-cluster into fresh planes (all series blocks
        # of the home place in one launch)
        n = mesh.shape[SERIES]
        gm_grid = _grid(mesh, state, "histo_means", rl["histo_means"])
        gw_grid = _grid(mesh, state, "histo_weights",
                        rl["histo_weights"])
        rows = n * rl["histo_means"]
        gm = gather_slots([gm_grid[i].reshape(rows, -1)
                           for i in range(gm_grid.shape[0])], group)
        gw = gather_slots([gw_grid[i].reshape(rows, -1)
                           for i in range(gw_grid.shape[0])], group)
        zm = torch.zeros((rows, cfg.capacity()), dtype=torch.float32,
                         device=gm.device)
        mm, mw = tdigest._merge_impl(zm, torch.zeros_like(zm), gm, gw,
                                     cfg.compression)

        regs = reduce_shards(_grid(mesh, state, "hll", rl["hll"]), "max",
                             group).reshape(-1, hll_ops.M)
        return {"counters": cnt, "gauges": gauges, "histo_stats": stats,
                "histo_means": mm, "histo_weights": mw, "hll": regs}

    return merge


def readout(merged: dict, qs) -> dict:
    """Flush readout over the merged table: per-row quantiles and HLL
    estimates."""
    quant = tdigest.quantile(
        merged["histo_means"], merged["histo_weights"],
        torch.as_tensor(np.asarray(qs, np.float32)),
        merged["histo_stats"][:, STAT_MIN],
        merged["histo_stats"][:, STAT_MAX])
    return {"quantiles": quant,
            "hll_estimate": hll_ops.estimate(merged["hll"])}


# ---------------------------------------------------------------------
# the process mesh and the collective import fold


def init_process_mesh(coordinator_address: str | None = None,
                      num_processes: int | None = None,
                      process_id: int | None = None,
                      device: "str | torch.device" = "cuda",
                      timeout: float = DIST_TIMEOUT_S) -> bool:
    """Join a multi-process ``torch.distributed`` job so one global
    node can span processes and hosts.

    Arguments default from ``VENEUR_TPU_DIST_COORDINATOR`` (host:port
    of process 0), ``VENEUR_TPU_DIST_NUM_PROCS`` and
    ``VENEUR_TPU_DIST_PROCESS_ID``.  Returns False (single-process
    mode) when no coordinator is configured.  The group runs ``nccl``
    for a CUDA ``device`` and ``gloo`` for the CPU, with a finite
    ``timeout``; a failed join raises."""
    coord = coordinator_address or os.environ.get(
        "VENEUR_TPU_DIST_COORDINATOR", "")
    if not coord:
        return False
    nproc = num_processes if num_processes is not None else int(
        os.environ.get("VENEUR_TPU_DIST_NUM_PROCS", "0"))
    pid = process_id if process_id is not None else int(
        os.environ.get("VENEUR_TPU_DIST_PROCESS_ID", "-1"))
    if nproc <= 0 or not (0 <= pid < nproc):
        raise ValueError(
            f"distributed mesh needs a process count and an id in "
            f"range (got {nproc}, {pid})")
    dev = _norm(resolve_device(device))
    dist = _dist()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coord}", world_size=nproc, rank=pid,
        timeout=datetime.timedelta(seconds=float(timeout)))
    return True


def close_process_mesh() -> None:
    """Leave the job ``init_process_mesh`` joined (a no-op without
    one)."""
    if _world_group() is not None:
        _dist().destroy_process_group()


def process_device() -> torch.device | None:
    """This process's place in a distributed job (the current card for
    an NCCL group, the CPU for gloo), or None outside one."""
    group = _world_group()
    if group is None:
        return None
    if _dist().get_backend(group) == "nccl":
        return _norm("cuda")
    return torch.device("cpu")


def make_import_mesh(places=None, group=None) -> Mesh:
    """1D all-``shard`` mesh for the collective import fold: every
    place folds wires; the series axis stays size 1 because the import
    table's planes are replicated (one host-side table).  After
    ``init_process_mesh`` it spans every process of the job (default
    places: the process's own device there, else the visible cards)."""
    if places is None:
        dev = process_device()
        places = [dev] if dev is not None else default_places()
    group = group if group is not None else _world_group()
    places = list(places)
    return Mesh(places, len(places), 1, group)


def mesh_process_count(mesh: Mesh) -> int:
    """Number of processes owning the mesh's places."""
    return mesh.n_proc


class CollectiveWireFold:
    """Mesh-sharded fold of one import cycle's wire stack.

    The serial path (table._wire_digest_step ->
    tdigest.merge_wire_stack_rows) merges a cycle's W wire planes one
    after another.  Here the wire axis is partitioned over the mesh's
    places: each place folds its W/S slice, wire by wire and skipping
    dead wires, into ZERO-initialized partial planes; the partials are
    then unioned with one slot gather and a single k-scale re-cluster
    into the table rows.  The places of one device fold their slices
    together, one launch per wire step (rows stacked, a dead wire's
    rows keeping their partial).

    Within a place the merge order is wire arrival order, and the
    union is one re-cluster over (table content ++ every partial).
    Where centroid spacing keeps the cluster pass from combining
    anything (under-capacity digests with >1 k-width between
    centroids) the result is bit-identical to the serial scan; in
    general it is an equally valid t-digest union of the same mass.

    Across processes (``init_process_mesh``) each process passes its
    own equal-length wire slice (``pad_wires`` per process) and the
    gather runs process-major over the group."""

    def __init__(self, mesh: Mesh,
                 compression: float = tdigest.DEFAULT_COMPRESSION):
        self.mesh = mesh
        self.n_shard = int(mesh.shape[SHARD])
        self.n_proc = mesh_process_count(mesh)
        self.compression = compression

    def pad_wires(self, n: int) -> int:
        """Wire-axis length the stack must pad to: a multiple of the
        places per process, so every place scans an equal slice (on a
        multi-process mesh ``n`` and the result are per process)."""
        s = self.n_shard // self.n_proc
        return ((max(n, 1) + s - 1) // s) * s

    def scatter_wires(self, stack_m, stack_w, live):
        """This process's wire slice of the mesh-global stack, split
        evenly over its places: the whole stack on one process; on
        several, each passes its own slice (the global wire order is
        process-major, the gather's).  Returns (stack_m, stack_w, live
        as bool, wires a place)."""
        live = np.asarray(live, bool)
        s_l = self.mesh.n_local_shard
        if len(live) % s_l or len(stack_m) != len(live):
            raise ValueError(f"{len(live)} wires do not split over "
                             f"{s_l} places (pad with pad_wires)")
        return stack_m, stack_w, live, len(live) // s_l

    def __call__(self, means, weights, row_idx, stack_m, stack_w, live):
        stack_m, stack_w, live, per = self.scatter_wires(stack_m, stack_w,
                                                         live)
        sub_m = tdigest._take_rows(means, row_idx)
        sub_w = tdigest._take_rows(weights, row_idx)
        u, cap = sub_m.shape
        parts_m: list = [None] * self.mesh.n_local_shard
        parts_w: list = [None] * self.mesh.n_local_shard
        for dev, plist in self.mesh.groups:
            k = len(plist)
            sm = torch.as_tensor(stack_m).to(dev)
            sw = torch.as_tensor(stack_w).to(dev)
            pm = torch.zeros((k * u, cap), dtype=torch.float32,
                             device=dev)
            pw = torch.zeros_like(pm)
            for step in range(per):
                wires = [i * per + step for i, _ in plist]
                alive = live[wires]
                if not alive.any():
                    continue
                nm, nw = tdigest._merge_impl(
                    pm, pw, sm[wires].reshape(k * u, -1),
                    sw[wires].reshape(k * u, -1), self.compression)
                if alive.all():
                    pm, pw = nm, nw
                else:
                    keep = torch.as_tensor(np.repeat(alive, u),
                                           device=dev)[:, None]
                    pm = torch.where(keep, nm, pm)
                    pw = torch.where(keep, nw, pw)
            for p, (i, _) in enumerate(plist):
                parts_m[i] = pm[p * u:(p + 1) * u].to(sub_m.device)
                parts_w[i] = pw[p * u:(p + 1) * u].to(sub_m.device)
        gm = gather_slots(parts_m, self.mesh.group)
        gw = gather_slots(parts_w, self.mesh.group)
        out_m, out_w = tdigest._merge_impl(sub_m, sub_w, gm, gw,
                                           self.compression)
        return (tdigest._put_rows(means, row_idx, out_m),
                tdigest._put_rows(weights, row_idx, out_w))


# ---------------------------------------------------------------------
# the host wrapper and the table facade

_update_step = observe.instrument(
    "sharded.update", lambda fn, state, batch: fn(state, batch))
_merge_step = observe.instrument(
    "sharded.merge", lambda fn, state: fn(state))


class ShardedAggregator:
    """Host-side wrapper: per-shard columnar staging + one mesh step.

    The host routes each sample to a shard (round-robin or by packet
    origin — any assignment is correct, the merge is a CRDT union) and
    row ids are global.  On a multi-process mesh each process stages
    its own shards (``shard`` modulo the shards it holds)."""

    def __init__(self, mesh: Mesh, cfg: ShardedConfig | None = None):
        self.mesh = mesh
        self.cfg = cfg or ShardedConfig()
        self.n_shard = mesh.shape[SHARD]
        self.n_local = mesh.n_local_shard
        self.state = empty_state(mesh, self.cfg)
        self._update = make_update_step(mesh, self.cfg)
        self._merge = make_merge_step(mesh, self.cfg)
        self._ticket = 0
        self._stage = [self._empty_stage() for _ in range(self.n_local)]
        # update calls made (each one merge launch per device)
        self.update_calls = 0

    @staticmethod
    def _empty_stage():
        return {k: [] for k in BATCH_KEYS}

    def next_ticket(self, n: int = 1) -> np.ndarray:
        t = np.arange(self._ticket, self._ticket + n, dtype=np.int32)
        self._ticket += n
        return t

    def stage(self, shard: int, **cols) -> None:
        st = self._stage[shard % self.n_local]
        for k, v in cols.items():
            st[k].append(np.asarray(v))

    _DTYPES = {"counter_rows": np.int32, "counter_vals": np.float32,
               "counter_wts": np.float32, "gauge_rows": np.int32,
               "gauge_vals": np.float32, "gauge_ticket": np.int32,
               "histo_rows": np.int32, "histo_vals": np.float32,
               "histo_wts": np.float32,
               "rsum_rows": np.int32, "rsum_vals": np.float32,
               "set_rows": np.int32,
               "set_idx": np.int32, "set_rank": np.int32}

    def step(self) -> None:
        """Push staged samples through mesh updates.

        Host pre-combine first: counters collapse to one (row, total)
        pair per touched row per shard, so the shipped batch is
        O(rows) whatever the sample volume.  Oversized residual
        batches CHUNK across several update calls.  Histo samples
        chunk by within-row rank as well, so no row exceeds
        ``cfg.slots`` samples a call (``densify`` drops past the slot
        width)."""
        n = self.cfg.batch
        cols = {}
        for key, dt in self._DTYPES.items():
            planes = []
            for st in self._stage:
                col = (np.concatenate([np.asarray(a, dt).ravel()
                                       for a in st[key]])
                       if st[key] else np.zeros(0, dt))
                planes.append(col)
            cols[key] = planes
        self._stage = [self._empty_stage() for _ in range(self.n_local)]

        # counter pre-combine per shard: bincount over touched rows
        for si in range(self.n_local):
            rows = cols["counter_rows"][si]
            if len(rows) <= 1:
                continue
            totals = np.bincount(
                rows, weights=cols["counter_vals"][si] *
                cols["counter_wts"][si], minlength=0)
            touched = np.nonzero(totals)[0]
            cols["counter_rows"][si] = touched.astype(np.int32)
            cols["counter_vals"][si] = totals[touched].astype(
                np.float32)
            cols["counter_wts"][si] = np.ones(len(touched), np.float32)

        # per-shard selection lists, one entry per update call: histo
        # selections group by within-row rank (rank // slots) THEN
        # split to <= batch; the other classes split positionally
        def _pos_sels(length: int) -> list[np.ndarray]:
            return [np.arange(off, min(off + n, length))
                    for off in range(0, length, n)] or []

        def _histo_sels(rows: np.ndarray) -> list[np.ndarray]:
            if len(rows) == 0:
                return []
            order = np.argsort(rows, kind="stable")
            srows = rows[order]
            first = np.ones(len(rows), bool)
            first[1:] = srows[1:] != srows[:-1]
            start = np.maximum.accumulate(
                np.where(first, np.arange(len(rows)), 0))
            rank = np.empty(len(rows), np.int64)
            rank[order] = np.arange(len(rows)) - start
            primary = rank // self.cfg.slots
            sels = []
            for ci in range(int(primary.max()) + 1):
                idx = np.nonzero(primary == ci)[0]
                for off in range(0, len(idx), n):
                    sels.append(idx[off:off + n])
            return sels

        group_of = {"counter_rows": "counter", "counter_vals": "counter",
                    "counter_wts": "counter", "gauge_rows": "gauge",
                    "gauge_vals": "gauge", "gauge_ticket": "gauge",
                    "histo_rows": "histo", "histo_vals": "histo",
                    "histo_wts": "histo",
                    "rsum_rows": "rsum", "rsum_vals": "rsum",
                    "set_rows": "set",
                    "set_idx": "set", "set_rank": "set"}
        sels: dict[tuple[str, int], list[np.ndarray]] = {}
        n_calls = 0
        for si in range(self.n_local):
            sels[("histo", si)] = _histo_sels(cols["histo_rows"][si])
            for grp, key in (("counter", "counter_rows"),
                             ("gauge", "gauge_rows"),
                             ("rsum", "rsum_rows"),
                             ("set", "set_rows")):
                sels[(grp, si)] = _pos_sels(len(cols[key][si]))
            n_calls = max(n_calls, *(len(sels[(g, si)]) for g in
                                     ("histo", "counter", "gauge",
                                      "rsum", "set")), 0)

        for ci in range(n_calls):
            batch = {}
            for key, dt in self._DTYPES.items():
                planes = []
                for si in range(self.n_local):
                    grp_sels = sels[(group_of[key], si)]
                    col = (cols[key][si][grp_sels[ci]]
                           if ci < len(grp_sels) else
                           cols[key][si][:0])
                    planes.append(col.astype(dt, copy=False))
                batch[key] = planes
            self.state = _update_step(self._update, self.state, batch)
            self.update_calls += 1

    def flush(self, qs=(0.5, 0.9, 0.99)) -> dict:
        """Merge the partial shards and read out."""
        merged = _merge_step(self._merge, self.state)
        merged.update(readout(merged, np.asarray(qs, np.float32)))
        return merged

    def swap(self) -> dict:
        """Interval boundary: push any staged work, merge, and reset
        the partial state for the next interval (the double-buffer
        swap the single-card table does at flush, worker.go:498)."""
        self.step()
        merged = _merge_step(self._merge, self.state)
        self.state = empty_state(self.mesh, self.cfg)
        return merged


class ShardedTable:
    """MetricTable-compatible facade over a place mesh: the surface
    ``core.Server``/``Flusher`` drive (ingest / import_* / device_step
    / swap -> Snapshot), backed by the sharded planes.  A multi-place
    global node runs through the ordinary Server path with this table
    (config ``tpu_mesh_shards``); imports land in host staging as on
    the single-card table, and the shard merge runs at the flush.

    Replaces the reference's importsrv worker fan-in + proxy tier for
    nodes that share a host (importsrv/server.go:102)."""

    def __init__(self, mesh: Mesh, cfg: ShardedConfig | None = None):
        from veneur_tpu_torch.core import table as core_table
        self.mesh = mesh
        self.cfg = cfg or ShardedConfig()
        self.device = mesh.home
        self.agg = ShardedAggregator(mesh, self.cfg)
        self.gen = 0
        self.counter_idx = core_table._ClassIndex(self.cfg.c_rows())
        self.gauge_idx = core_table._ClassIndex(self.cfg.g_rows())
        self.histo_idx = core_table._ClassIndex(self.cfg.rows)
        self.set_idx = core_table._ClassIndex(self.cfg.set_rows)
        self.status: dict = {}
        # the gRPC import's identity-hash -> row cache and wire plans
        # (forward/grpc_forward): the facade never compacts, so the
        # epoch stays 0 and no invalidation hook is needed; the size
        # bound guards churning identities
        self.import_row_cache: dict[int, int] = {}
        self.import_row_cache_limit = 4 * (
            2 * self.cfg.c_rows() + self.cfg.rows +
            self.cfg.set_rows) + 1024
        self._reindex_epoch = 0
        self._wire_plan_cache: dict = {}
        self._http_plan_cache: dict = {}
        self.wire_plan_hits = 0
        self.wire_plan_misses = 0
        self._staged_n = 0
        # interval conservation count at ITEM granularity, as the
        # single-card table's
        self._interval_ingested = 0
        self._rr = 0  # round-robin shard cursor

    # -- ingest (the per-sample surface the Server uses) --------------

    def _next_shard(self) -> int:
        self._rr = (self._rr + 1) % self.agg.n_local
        return self._rr

    def ingest(self, s) -> bool:
        from veneur_tpu_torch.protocol import dogstatsd as dsd
        from veneur_tpu_torch.utils import hashing
        key = (s.name, s.type, s.tags, s.scope)
        weight = 1.0 / s.sample_rate
        sh = self._next_shard()
        if s.type == dsd.COUNTER:
            row = self.counter_idx.lookup(key, s.name, s.tags,
                                          s.scope, s.type, self.gen)
            if row is None:
                return False
            self.agg.stage(sh, counter_rows=[row],
                           counter_vals=[s.value],
                           counter_wts=[weight])
        elif s.type == dsd.GAUGE:
            row = self.gauge_idx.lookup(key, s.name, s.tags, s.scope,
                                        s.type, self.gen)
            if row is None:
                return False
            self.agg.stage(sh, gauge_rows=[row],
                           gauge_vals=[s.value],
                           gauge_ticket=self.agg.next_ticket())
        elif s.type in (dsd.TIMER, dsd.HISTOGRAM):
            row = self.histo_idx.lookup(key, s.name, s.tags, s.scope,
                                        s.type, self.gen)
            if row is None:
                return False
            self.agg.stage(sh, histo_rows=[row], histo_vals=[s.value],
                           histo_wts=[weight])
        elif s.type == dsd.SET:
            row = self.set_idx.lookup(key, s.name, s.tags, s.scope,
                                      s.type, self.gen)
            if row is None:
                return False
            member = (s.value if isinstance(s.value, bytes)
                      else str(s.value).encode())
            idx, rank = hashing.hash_members([member])
            self.agg.stage(sh, set_rows=[row], set_idx=idx,
                           set_rank=rank)
        elif s.type == dsd.STATUS:
            self.status[key] = (float(s.value), s.message, s.tags)
            return True
        else:
            raise ValueError(f"unknown metric type {s.type}")
        self._staged_n += 1
        self._interval_ingested += 1
        return True

    def ingest_many(self, samples) -> int:
        dropped = 0
        for s in samples:
            if not self.ingest(s):
                dropped += 1
        return dropped

    def ingest_columns(self, pb) -> tuple[int, int]:
        """Columnar parse batches sweep through the per-sample path: a
        mesh global node's hot ingest is the gRPC import plane, not raw
        DogStatsD volume.  Lines the caller handles (events, checks,
        errors, type codes past CODE_SET) are left to its slow
        sweep."""
        from veneur_tpu_torch.protocol import columnar
        from veneur_tpu_torch.protocol import dogstatsd as dsd
        processed = dropped = 0
        fast = np.nonzero(pb.type_code[:pb.n] <= columnar.CODE_SET)[0]
        for i in fast:
            try:
                parsed = dsd.parse_line(pb.line(int(i)))
            except dsd.ParseError:
                dropped += 1
                continue
            if self.ingest(parsed):
                processed += 1
            else:
                dropped += 1
        return processed, dropped

    # -- global-tier imports ------------------------------------------

    def import_counter_row(self, name, tags):
        from veneur_tpu_torch.protocol import dogstatsd as dsd
        return self.counter_idx.lookup(
            (name, dsd.COUNTER, tags, dsd.SCOPE_GLOBAL), name, tags,
            dsd.SCOPE_GLOBAL, dsd.COUNTER, self.gen)

    def import_gauge_row(self, name, tags):
        from veneur_tpu_torch.protocol import dogstatsd as dsd
        return self.gauge_idx.lookup(
            (name, dsd.GAUGE, tags, dsd.SCOPE_GLOBAL), name, tags,
            dsd.SCOPE_GLOBAL, dsd.GAUGE, self.gen)

    def import_set_row(self, name, tags, scope=None):
        from veneur_tpu_torch.protocol import dogstatsd as dsd
        scope = scope or dsd.SCOPE_DEFAULT
        return self.set_idx.lookup((name, dsd.SET, tags, scope), name,
                                   tags, scope, dsd.SET, self.gen)

    def import_counter_batch(self, rows, values) -> None:
        rows = np.ascontiguousarray(rows, np.int64)
        self.agg.stage(self._next_shard(),
                       counter_rows=rows.astype(np.int32),
                       counter_vals=np.asarray(values, np.float32),
                       counter_wts=np.ones(len(rows), np.float32))
        self.counter_idx.touch_rows(rows, self.gen)
        self._staged_n += len(rows)
        self._interval_ingested += len(rows)

    def import_gauge_batch(self, rows, values) -> None:
        # one ticket per write keeps last-write-wins in wire order
        # across the whole mesh
        rows = np.ascontiguousarray(rows, np.int64)
        values = np.asarray(values, np.float64)
        for r, v in zip(rows, values):
            self.agg.stage(self._next_shard(), gauge_rows=[int(r)],
                           gauge_vals=[float(v)],
                           gauge_ticket=self.agg.next_ticket())
        self.gauge_idx.touch_rows(rows, self.gen)
        self._staged_n += len(rows)
        self._interval_ingested += len(rows)

    def import_set_at(self, row, regs) -> None:
        regs = np.asarray(regs, np.uint8)
        if regs.shape != (hll_ops.M,):
            raise ValueError(f"bad register plane shape {regs.shape}")
        nz = np.nonzero(regs)[0]
        if len(nz):
            self.agg.stage(self._next_shard(),
                           set_rows=np.full(len(nz), int(row), np.int32),
                           set_idx=nz.astype(np.int32),
                           set_rank=regs[nz].astype(np.int32))
        self.set_idx.touched[row] = True
        self.set_idx.last_gen[row] = self.gen
        self._staged_n += max(1, len(nz))
        self._interval_ingested += 1

    def import_set_sketches(self, buf, sk, items, rows) -> int:
        """The wire's classified sketches decoded natively, 64 to a
        scratch plane, then staged row by row as ``import_set_at``
        stages them (each row's nonzero registers on the next shard)."""
        step = 64
        regs = np.empty((min(len(items), step), hll_ops.M), np.uint8)
        n = 0
        for s in range(0, len(items), step):
            its, rs = items[s:s + step], rows[s:s + step]
            part = regs[:len(its)]
            part.fill(0)
            n += native.hll_fold(buf, sk, its, np.arange(len(its)), part)
            for row, r in zip(rs.tolist(), part):
                self.import_set_at(row, r)
        return n

    def import_counter(self, name, tags, value) -> bool:
        row = self.import_counter_row(name, tags)
        if row is None:
            return False
        self.agg.stage(self._next_shard(), counter_rows=[row],
                       counter_vals=[value], counter_wts=[1.0])
        self._staged_n += 1
        self._interval_ingested += 1
        return True

    def import_gauge(self, name, tags, value) -> bool:
        row = self.import_gauge_row(name, tags)
        if row is None:
            return False
        self.agg.stage(self._next_shard(), gauge_rows=[row],
                       gauge_vals=[value],
                       gauge_ticket=self.agg.next_ticket())
        self._staged_n += 1
        self._interval_ingested += 1
        return True

    def import_histo_row(self, name, mtype, tags, scope=None):
        from veneur_tpu_torch.protocol import dogstatsd as dsd
        scope = scope or dsd.SCOPE_DEFAULT
        return self.histo_idx.lookup((name, mtype, tags, scope), name,
                                     tags, scope, mtype, self.gen)

    def import_histo(self, name, mtype, tags, stats, means, weights,
                     scope=None) -> bool:
        """Forwarded digest: centroids re-enter as weighted samples;
        min/max ride as two weight-epsilon anchor samples so the merged
        stats keep the true extremes, and the reciprocal-sum delta
        lands as a direct RSUM correction."""
        # shapes are checked BEFORE anything stages
        stats = np.asarray(stats, np.float32)
        means = np.asarray(means, np.float32)
        weights = np.asarray(weights, np.float32)
        if stats.shape != (HISTO_STAT_COLS,):
            raise ValueError(f"bad stats shape {stats.shape}")
        if means.shape != weights.shape or means.ndim != 1:
            raise ValueError(
                f"centroid shape mismatch {means.shape}/"
                f"{weights.shape}")
        row = self.import_histo_row(name, mtype, tags, scope)
        if row is None:
            return False
        live = weights > 0
        n_live = int(live.sum())
        sh = self._next_shard()
        eps = np.float32(1e-6)
        rsum_from_samples = 0.0
        if n_live:
            self.agg.stage(sh, histo_rows=np.full(n_live, row, np.int32),
                           histo_vals=means[live],
                           histo_wts=weights[live])
            nz = live & (means != 0)
            rsum_from_samples = float((weights[nz] / means[nz]).sum())
        w = float(stats[STAT_WEIGHT])
        if w > 0:
            mn = float(stats[STAT_MIN])
            mx = float(stats[STAT_MAX])
            self.agg.stage(sh, histo_rows=[row, row],
                           histo_vals=[mn, mx], histo_wts=[eps, eps])
            if mn != 0:
                rsum_from_samples += float(eps) / mn
            if mx != 0:
                rsum_from_samples += float(eps) / mx
        # exact forwarded rsum minus what the staged samples will add
        corr = float(stats[STAT_RSUM]) - rsum_from_samples
        if corr:
            self.agg.stage(sh, rsum_rows=[row], rsum_vals=[corr])
        self._staged_n += (n_live + (2 if w > 0 else 0) +
                           (1 if corr else 0))
        self._interval_ingested += 1
        return True

    def import_histo_batch(self, rows, stats, cent_rows, cent_means,
                           cent_weights) -> None:
        """Columnar sibling of import_histo with the same fidelity:
        min/max eps anchors and an exact per-row RSUM correction."""
        rows = np.ascontiguousarray(rows, np.int64)
        sh = self._next_shard()
        n_staged = 0
        nrows = self.cfg.rows
        rsum_samples = np.zeros(nrows, np.float64)
        if len(cent_rows):
            self.agg.stage(sh, histo_rows=cent_rows,
                           histo_vals=cent_means,
                           histo_wts=cent_weights)
            n_staged += len(cent_rows)
            cr = np.ascontiguousarray(cent_rows, np.int64)
            nz = cent_means != 0
            rsum_samples += np.bincount(
                cr[nz], weights=cent_weights[nz] / cent_means[nz],
                minlength=nrows)[:nrows]
        live = stats[:, STAT_WEIGHT] > 0
        if live.any():
            eps = np.float32(1e-6)
            r = rows[live]
            mns = stats[live, STAT_MIN]
            mxs = stats[live, STAT_MAX]
            self.agg.stage(
                sh, histo_rows=np.concatenate([r, r]).astype(np.int32),
                histo_vals=np.concatenate([mns, mxs]),
                histo_wts=np.full(2 * len(r), eps, np.float32))
            n_staged += 2 * len(r)
            for vals in (mns, mxs):
                vnz = vals != 0
                rsum_samples += np.bincount(
                    r[vnz], weights=float(eps) / vals[vnz],
                    minlength=nrows)[:nrows]
        rsum_true = np.bincount(
            rows, weights=stats[:, STAT_RSUM].astype(np.float64),
            minlength=nrows)[:nrows]
        corr = rsum_true - rsum_samples
        crows = np.nonzero(corr)[0]
        if len(crows):
            self.agg.stage(sh, rsum_rows=crows.astype(np.int32),
                           rsum_vals=corr[crows].astype(np.float32))
            n_staged += len(crows)
        # rows may arrive cache-resolved (no lookup ran): touch them
        self.histo_idx.touch_rows(rows, self.gen)
        self._staged_n += n_staged
        self._interval_ingested += len(rows)

    def import_set(self, name, tags, regs, scope=None) -> bool:
        """Forwarded HLL plane: registers convert to (idx, rank)
        positions (a register IS the max rank seen at that index)."""
        from veneur_tpu_torch.protocol import dogstatsd as dsd
        regs = np.asarray(regs, np.uint8)
        if regs.shape != (hll_ops.M,):
            raise ValueError(f"bad register plane shape {regs.shape}")
        scope = scope or dsd.SCOPE_DEFAULT
        row = self.set_idx.lookup((name, dsd.SET, tags, scope), name,
                                  tags, scope, dsd.SET, self.gen)
        if row is None:
            return False
        nz = np.nonzero(regs)[0]
        if len(nz):
            self.agg.stage(self._next_shard(),
                           set_rows=np.full(len(nz), row, np.int32),
                           set_idx=nz.astype(np.int32),
                           set_rank=regs[nz].astype(np.int32))
        self._staged_n += max(1, len(nz))
        self._interval_ingested += 1
        return True

    # -- lifecycle -----------------------------------------------------

    def staged(self) -> int:
        return self._staged_n

    def overflow_total(self) -> int:
        """Interval overflow drops summed over classes (the import
        sites delta this to split drops into overflow and invalid)."""
        return (self.counter_idx.overflow + self.gauge_idx.overflow +
                self.histo_idx.overflow + self.set_idx.overflow)

    def device_step(self, final: bool = False) -> None:
        if final or self._staged_n >= self.cfg.batch:
            self.agg.step()
            self._staged_n = 0

    def take_status(self):
        out = self.status
        self.status = {}
        return out

    def plane_bytes(self) -> dict:
        """The mesh's device bytes by class (every place's partial)."""
        b = {k: 0 for k in _PLANES}
        for st in self.agg.state:
            for k in _PLANES:
                b[k] += int(st[k].nbytes)
        occ = (self.counter_idx.occupancy() +
               self.gauge_idx.occupancy() +
               self.histo_idx.occupancy() + self.set_idx.occupancy())
        total = sum(b.values())
        return {
            "counter": {"wide": b["counters"], "compact": 0},
            "gauge": {"wide": b["gauges"] + b["gauge_ticket"],
                      "compact": 0},
            "histo": {"wide": b["histo_means"] + b["histo_weights"],
                      "stats": b["histo_stats"], "compact": 0},
            "set": {"wide": b["hll"], "compact": 0},
            "directory": 0, "total": total, "occupancy": occ,
            "device_bytes_per_series": total / max(1, occ),
            "tiers": None,
        }

    def swap(self):
        """Interval boundary -> a core-table Snapshot the Flusher
        consumes unchanged: the merged planes land in the fields the
        single-card table fills, the merged stat plane serving as the
        local-stats plane beside an identity import plane."""
        from veneur_tpu_torch.core import table as core_table
        self.device_step(final=True)
        merged = self.agg.swap()
        imp = segment.empty_histo_stats(self.cfg.rows,
                                        merged["histo_stats"].device)
        snap = core_table.Snapshot(
            gen=self.gen,
            counters=merged["counters"],
            counter_meta=list(self.counter_idx.meta),
            counter_touched=self.counter_idx.touched.copy(),
            gauges=merged["gauges"],
            gauge_meta=list(self.gauge_idx.meta),
            gauge_touched=self.gauge_idx.touched.copy(),
            histo_stats=merged["histo_stats"],
            histo_import_stats=imp,
            histo_means=merged["histo_means"],
            histo_weights=merged["histo_weights"],
            histo_meta=list(self.histo_idx.meta),
            histo_touched=self.histo_idx.touched.copy(),
            hll_regs=merged["hll"],
            set_meta=list(self.set_idx.meta),
            set_touched=self.set_idx.touched.copy(),
            hll_host_plane=None,
            hll_device_touched=True,
            overflow={
                "counter": self.counter_idx.overflow,
                "gauge": self.gauge_idx.overflow,
                "histo": self.histo_idx.overflow,
                "set": self.set_idx.overflow,
            },
            ingested=self._interval_ingested)
        self._interval_ingested = 0
        self.gen += 1
        for idx in (self.counter_idx, self.gauge_idx, self.histo_idx,
                    self.set_idx):
            idx.reset_interval()
        return snap
