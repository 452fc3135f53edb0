"""Carry table state across: the reference's plane arrays <-> the port's.

A JAX ``MetricTable`` snapshot holds its state as device arrays plus
row metadata; as numpy arrays (``np.asarray`` of each plane) they load
into the port unchanged, since the planes keep the reference's layouts:
f32[R] counters and gauges, f32[R,5] stats, f32[R,C] means and weights,
u8[R,16384] registers.  ``snapshot_from_numpy`` rebuilds a port
``Snapshot`` so the port's ``Flusher`` can flush a reference interval.

A reference ``ShardedAggregator``'s partial state, as numpy ``[S, R,
...]`` arrays (shard-major, global rows), loads into a port mesh with
``sharded_state_from_numpy`` and comes back out with
``sharded_state_to_numpy``, so both packages can start from the same
partial state.
"""

from __future__ import annotations

import numpy as np
import torch

from veneur_tpu_torch import resolve_device
from veneur_tpu_torch.core.table import RowMeta, Snapshot

PLANES = {
    "counters": np.float32,
    "gauges": np.float32,
    "histo_stats": np.float32,
    "histo_import_stats": np.float32,
    "histo_means": np.float32,
    "histo_weights": np.float32,
    "hll_regs": np.uint8,
}

_META = ("counter_meta", "gauge_meta", "histo_meta", "set_meta")
_TOUCHED = ("counter_touched", "gauge_touched", "histo_touched",
            "set_touched")


def planes_from_numpy(arrays: dict, device: "str | torch.device" = "cuda"
                      ) -> dict[str, torch.Tensor]:
    """Plane arrays (any of ``PLANES``) -> tensors on ``device``."""
    dev = resolve_device(device)
    out = {}
    for name, arr in arrays.items():
        if name not in PLANES:
            raise KeyError(f"not a state plane: {name}")
        a = np.array(arr, dtype=PLANES[name], copy=True, order="C")
        out[name] = torch.from_numpy(a).to(dev)
    return out


def planes_to_numpy(planes: dict) -> dict[str, np.ndarray]:
    """Tensors (or anything array-like) -> host numpy arrays."""
    out = {}
    for name, t in planes.items():
        if name not in PLANES:
            raise KeyError(f"not a state plane: {name}")
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu().numpy()
        out[name] = np.ascontiguousarray(np.asarray(t), PLANES[name])
    return out


def meta_from(rows) -> list[RowMeta]:
    """Row metadata from any objects with name/tags/scope/type."""
    return [RowMeta(m.name, tuple(m.tags), m.scope, m.type,
                    int(getattr(m, "key_hash", 0))) for m in rows]


def snapshot_from_numpy(state: dict,
                        device: "str | torch.device" = "cuda"
                        ) -> Snapshot:
    """A port Snapshot from the reference's planes + row metadata.

    ``state`` holds every name of ``PLANES`` as arrays, the four
    ``*_meta`` row-metadata lists, the four ``*_touched`` masks and
    optionally ``hll_host_plane`` (host-folded set registers)."""
    planes = planes_from_numpy({k: state[k] for k in PLANES}, device)
    host_plane = state.get("hll_host_plane")
    return Snapshot(
        gen=int(state.get("gen", 0)),
        **planes,
        **{k: meta_from(state[k]) for k in _META},
        **{k: np.asarray(state[k], bool).copy() for k in _TOUCHED},
        hll_host_plane=(None if host_plane is None
                        else np.asarray(host_plane, np.uint8)),
        hll_device_touched=bool(state.get("hll_device_touched", False)),
        overflow=dict(state.get("overflow", {})),
    )


SHARDED_PLANES = {
    "counters": np.float32,
    "gauges": np.float32,
    "gauge_ticket": np.int32,
    "histo_stats": np.float32,
    "histo_means": np.float32,
    "histo_weights": np.float32,
    "hll": np.uint8,
}


def sharded_state_from_numpy(mesh, cfg, arrays: dict) -> list[dict]:
    """A reference ShardedAggregator's state (``SHARDED_PLANES`` as
    ``[S, R, ...]`` arrays) -> the port mesh's partial state (one dict
    of row-stacked planes per device group, ``parallel.sharded``).  On
    a multi-process mesh each process loads its own shards."""
    from veneur_tpu_torch.parallel import sharded
    rl = sharded._local_rows(mesh, cfg)
    s_l = mesh.n_local_shard
    base = mesh.rank * s_l
    out = []
    for dev, plist in mesh.groups:
        group = {}
        for name, dtype in SHARDED_PLANES.items():
            arr = np.asarray(arrays[name], dtype)
            if arr.shape[0] != mesh.shape[sharded.SHARD]:
                raise ValueError(
                    f"{name}: {arr.shape[0]} shards, mesh has "
                    f"{mesh.shape[sharded.SHARD]}")
            n = rl[name]
            blocks = [arr[base + i, j * n:(j + 1) * n] for i, j in plist]
            group[name] = torch.from_numpy(
                np.ascontiguousarray(np.concatenate(blocks))).to(dev)
        out.append(group)
    return out


def sharded_state_to_numpy(mesh, cfg, state: list[dict]) -> dict:
    """The port mesh's partial state -> the reference's ``[S, R, ...]``
    arrays (this process's shards on a multi-process mesh)."""
    from veneur_tpu_torch.parallel import sharded
    rl = sharded._local_rows(mesh, cfg)
    s_l, n_series = mesh.n_local_shard, mesh.shape[sharded.SERIES]
    out = {}
    for name, dtype in SHARDED_PLANES.items():
        n = rl[name]
        rows = []
        for i in range(s_l):
            blocks = [None] * n_series
            for st, (_dev, plist) in zip(state, mesh.groups):
                for p, (pi, j) in enumerate(plist):
                    if pi == i:
                        blocks[j] = st[name][p * n:(p + 1) * n].cpu()
            rows.append(torch.cat(blocks).numpy())
        out[name] = np.ascontiguousarray(np.stack(rows), dtype)
    return out
