"""Carry table state across: the reference's plane arrays <-> the port's.

A JAX ``MetricTable`` snapshot holds its state as device arrays plus
row metadata; as numpy arrays (``np.asarray`` of each plane) they load
into the port unchanged, since the planes keep the reference's layouts:
f32[R] counters and gauges, f32[R,5] stats, f32[R,C] means and weights,
u8[R,16384] registers.  ``snapshot_from_numpy`` rebuilds a port
``Snapshot`` so the port's ``Flusher`` can flush a reference interval.
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
