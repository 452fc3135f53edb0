"""The merge roofline's byte count, from the traffic's shapes."""

import json
import os

from pbench import roofline

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(kind, name):
    with open(os.path.join(PB, kind, name + ".json")) as f:
        return json.load(f)


def test_mixed_interval_floor():
    b = roofline.merge_floor_bytes(load("configs", "local-default"),
                                   load("traffic", "mixed"))
    # 10,000 rows x 616 slots x 8 bytes read and written, 10M f32 samples
    assert b == 2 * 10_000 * 616 * 8 + 10_000_000 * 4 == 138_560_000


def test_grpc64_interval_floor():
    b = roofline.merge_floor_bytes(load("configs", "global-64"),
                                   load("traffic", "grpc64"))
    timers = 2 * 10_000 * 616 * 8 + 156_250 * 64 * 8
    global_timers = 2 * 256 * 616 * 8 + 3_906 * 64 * 8
    assert b == timers + global_timers == 183_083_008


def test_counters_move_no_merge_bytes():
    assert roofline.merge_floor_bytes(load("configs", "local-default"),
                                      load("traffic", "counters")) == 0


def test_floor_seconds_at_the_published_bandwidth():
    assert roofline.floor_seconds(3.35e12) == 1.0
