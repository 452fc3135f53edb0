"""The yardstick's peaks and the work a kernel must do, from shapes.

``merge_floor_bytes`` is the least traffic to HBM that one interval's
t-digest merges need, whatever launches the program makes: every
touched digest row's state (``digest_slots`` slots of a float32 mean
and a float32 weight) read once and written once, and every sample
read once (a float32 value when samples are unit weight, a mean and a
weight when they are centroids).  The kernel's roofline share is the
time that traffic takes at the card's published bandwidth over the
time the profiler gives the ``cluster_merge`` kernels.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet (700 W): HBM3 bandwidth, bytes/s
H100_HBM_BYTES_PER_S = 3.35e12

SLOT_BYTES = 8      # float32 mean + float32 weight
UNIT_SAMPLE_BYTES = 4
CENTROID_BYTES = 8


def merge_floor_bytes(config: dict, traffic: dict, scale: int = 1) -> float:
    """Least HBM bytes one interval's digest merges move."""
    slots = int(config["digest_slots"])
    total = 0.0
    for cls in traffic["classes"]:
        if cls["type"] not in ("timer", "histogram"):
            continue
        rows = max(1, int(cls["series"]) // scale)
        if traffic["kind"] == "fleet":
            n = max(1, int(cls["samples_per_local"]) // scale) \
                * int(traffic["locals"])
            per_sample = CENTROID_BYTES
        else:
            n = max(1, int(cls["samples"]) // scale)
            per_sample = UNIT_SAMPLE_BYTES
        total += 2.0 * rows * slots * SLOT_BYTES + n * per_sample
    return total


def floor_seconds(nbytes: float) -> float:
    return nbytes / H100_HBM_BYTES_PER_S
