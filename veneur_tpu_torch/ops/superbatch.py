"""Superbatch apply: one host-to-device copy + one fused step per cycle.

Port of ``veneur_tpu/ops/superbatch.py``.  The whole cycle's detached
staging packs into ONE fixed-schema buffer of int32 words:

  header (8 words: magic, total, per-class word offsets)
  counter   f32[counter_rows]            dense deltas (bitcast)
  gauge     f32[gauge_rows] + i32 mask   last-writes + touched mask
  histo     i32 rows + i32 rank + f32 vals (+ f32 wts) (+ i32 idx)
  set POS   i32 rows + i32 packed        (index << 6 | rank) positions
  set PLANE i32 idx + u8[T,16384]        compact touched-row registers

The layout is byte-for-byte the reference's (``layout``,
``fill_header``).  On the card the buffer lives in pinned host memory
and crosses with one ``non_blocking`` copy; the fused step slices it at
static offsets and reinterprets the f32 / u8 segments with
``Tensor.view`` (the same bits as JAX's bitcast), then runs every class
update.  The histo arm calls the same ``tdigest.ingest_ranked*``
functions as the per-class path, so its merges go through the cluster
merge kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from veneur_tpu_torch.ops import hll, segment, tdigest

_MAGIC = 0x53425631  # "SBV1"
HEADER_WORDS = 8


class SBSpec(NamedTuple):
    """Superbatch schema: segment lengths and the histo merge variant.
    A zero length means the class is absent this cycle."""

    counter_rows: int = 0
    gauge_rows: int = 0
    histo_n: int = 0       # bucketed sample count
    histo_slots: int = 0   # merge chunk width for this batch
    histo_sub: int = 0     # bucketed touched-row count; 0 = global rows
    histo_unit: bool = False
    histo_stats: bool = False
    compression: float = 0.0
    pos_n: int = 0         # bucketed member count (packed-scatter arm)
    plane_rows: int = 0    # plane segment rows (plane arm)
    plane_full: bool = False  # plane covers the whole pool: union


def layout(spec: SBSpec) -> dict[str, int]:
    """Word offset of every segment (and "total")."""
    o = HEADER_WORDS
    out = {}
    out["counter"] = o
    o += spec.counter_rows
    out["gauge_dense"] = o
    o += spec.gauge_rows
    out["gauge_mask"] = o
    o += spec.gauge_rows
    out["histo_rows"] = o
    o += spec.histo_n
    out["histo_rank"] = o
    o += spec.histo_n
    out["histo_vals"] = o
    o += spec.histo_n
    out["histo_wts"] = o
    o += 0 if spec.histo_unit else spec.histo_n
    out["histo_idx"] = o
    o += spec.histo_sub
    out["pos_rows"] = o
    o += spec.pos_n
    out["pos_pk"] = o
    o += spec.pos_n
    out["plane_idx"] = o
    o += 0 if spec.plane_full else spec.plane_rows
    out["plane_regs"] = o
    o += spec.plane_rows * (hll.M // 4)
    out["total"] = o
    return out


def fill_header(buf: np.ndarray, spec: SBSpec,
                off: dict[str, int]) -> None:
    """Self-describing header for host-side dump tooling (the step
    slices by static offsets and never reads it)."""
    buf[0] = _MAGIC
    buf[1] = off["total"]
    buf[2] = off["counter"]
    buf[3] = off["gauge_dense"]
    buf[4] = off["histo_rows"]
    buf[5] = off["pos_rows"]
    buf[6] = off["plane_idx"]
    buf[7] = 0


class DoubleBuffer:
    """Two alternating grow-only host staging buffers: take() hands
    back the slot the device is NOT (possibly still) copying from.
    With ``pin=True`` the slots are pinned host memory, and take()
    first waits for the copy recorded on the slot it returns
    (``record``), so a slot is never rewritten while a non_blocking
    copy may still read it."""

    def __init__(self, pin: bool = False):
        self._pin = pin
        self._slots: list[torch.Tensor | None] = [None, None]
        self._events: list = [None, None]
        self._i = 0
        self._last = 0

    def take_tensor(self, words: int) -> torch.Tensor:
        i = self._i
        self._i ^= 1
        self._last = i
        ev = self._events[i]
        if ev is not None:
            ev.synchronize()
            self._events[i] = None
        buf = self._slots[i]
        if buf is None or buf.numel() < words:
            cap = max(1024, 1 << (max(words, 1) - 1).bit_length())
            buf = torch.empty(cap, dtype=torch.int32, pin_memory=self._pin)
            self._slots[i] = buf
        return buf[:words]

    def take(self, words: int) -> np.ndarray:
        return self.take_tensor(words).numpy()

    def record(self, event) -> None:
        """Tie an event recorded after the copy to the slot last taken."""
        self._events[self._last] = event


def to_device(buf: torch.Tensor, device: torch.device,
              bufs: DoubleBuffer | None = None) -> torch.Tensor:
    """The cycle's one host-to-device copy."""
    if device.type == "cpu":
        return buf
    out = buf.to(device, non_blocking=True)
    if bufs is not None:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        bufs.record(ev)
    return out


def step(spec: SBSpec, counters, gauges, means, weights, stats, regs,
         buf: torch.Tensor):
    """The one fused step over a device-resident int32 buffer.  All
    offsets are static; f32/u8 segments are reinterpreting views.
    Absent classes pass their planes through untouched."""
    off = layout(spec)

    def seg(name: str, n: int):
        o = off[name]
        return buf[o:o + n]

    def f32(name: str, n: int):
        return seg(name, n).view(torch.float32)

    if spec.counter_rows:
        counters = segment.counter_dense_update(
            counters, f32("counter", spec.counter_rows))
    if spec.gauge_rows:
        gauges = segment.gauge_dense_update(
            gauges, f32("gauge_dense", spec.gauge_rows),
            seg("gauge_mask", spec.gauge_rows) != 0)
    if spec.histo_n:
        rows = seg("histo_rows", spec.histo_n)
        rank = seg("histo_rank", spec.histo_n)
        vals = f32("histo_vals", spec.histo_n)
        sub = spec.histo_sub > 0
        pre = (seg("histo_idx", spec.histo_sub),) if sub else ()
        kw = dict(slots=spec.histo_slots, compression=spec.compression)
        if spec.histo_stats:
            if spec.histo_unit:
                fn = (tdigest.ingest_ranked_unit_rows if sub
                      else tdigest.ingest_ranked_unit)
                means, weights, stats = fn(
                    means, weights, stats, *pre, rows, rank, vals, **kw)
            else:
                fn = (tdigest.ingest_ranked_rows if sub
                      else tdigest.ingest_ranked)
                means, weights, stats = fn(
                    means, weights, stats, *pre, rows, rank, vals,
                    f32("histo_wts", spec.histo_n), **kw)
        elif spec.histo_unit:
            fn = (tdigest.add_samples_ranked_unit_rows if sub
                  else tdigest.add_samples_ranked_unit)
            means, weights = fn(means, weights, *pre, rows, rank, vals,
                                **kw)
        else:
            fn = (tdigest.add_samples_ranked_rows if sub
                  else tdigest.add_samples_ranked)
            means, weights = fn(means, weights, *pre, rows, rank, vals,
                                f32("histo_wts", spec.histo_n), **kw)
    if spec.pos_n:
        regs = hll.insert_packed(regs, seg("pos_rows", spec.pos_n),
                                 seg("pos_pk", spec.pos_n))
    if spec.plane_rows:
        words = spec.plane_rows * (hll.M // 4)
        plane = seg("plane_regs", words).view(torch.uint8).view(
            spec.plane_rows, hll.M)
        if spec.plane_full:
            regs = hll.union(regs, plane)
        else:
            regs = hll.merge_rows(regs, seg("plane_idx", spec.plane_rows),
                                  plane)
    return counters, gauges, means, weights, stats, regs
