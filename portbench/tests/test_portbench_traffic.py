"""The traffic generators: deterministic per seed, different across
seeds, the same sizes for every seed, and wires the schema decodes."""

import json
import os

import numpy as np
import pytest

from pbench import dsd, plan, wire
from wire_pb import forward_pb2, metric_pb2

TRAFFIC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "traffic")


def traffic(name):
    with open(os.path.join(TRAFFIC, name + ".json")) as f:
        return json.load(f)


with open(os.path.join(os.path.dirname(TRAFFIC), "configs",
                       "local-default.json")) as f:
    NODE = json.load(f)["server"]


BIG_SEED = 2 ** 31 + 987_654_321


@pytest.mark.parametrize("name,scale", [("mixed", 400), ("counters", 1000)])
def test_dogstatsd_text_is_deterministic_per_seed(name, scale):
    a, na = dsd.interval_sweeps(plan.dogstatsd_plan(traffic(name), NODE,
                                                    BIG_SEED, scale))
    b, nb = dsd.interval_sweeps(plan.dogstatsd_plan(traffic(name), NODE,
                                                    BIG_SEED, scale))
    c, nc = dsd.interval_sweeps(plan.dogstatsd_plan(traffic(name), NODE,
                                                    BIG_SEED + 1, scale))
    assert a == b
    assert a != c
    assert list(na) == list(nc)  # the same sizes for every seed


def test_dogstatsd_lines_read_back_as_the_plan():
    p = plan.dogstatsd_plan(traffic("mixed"), NODE, 7, 500)
    sweeps, counts = dsd.interval_sweeps(p)
    lines = b"\n".join(sweeps).split(b"\n")
    assert len(lines) == p.n_lines == int(counts.sum())
    assert all(n <= p.lines_per_sweep for n in counts)
    for c in p.classes:
        for i in (0, len(c.series) // 2, len(c.series) - 1):
            name, rest = lines[c.pos[i]].split(b":", 1)
            val, typ, tags = rest.split(b"|")
            j = int(c.series[i])
            assert name.decode() == c.names.name(j)
            assert typ == plan.TYPE_CODE[c.type]
            assert tags == b"#" + ",".join(c.names.tags(j)).encode()
            if c.type == "set":
                assert val == b"m%d" % c.values.text[i]
            else:
                whole, _, frac = val.partition(b".")
                assert len(frac) == c.values.decimals
                assert int(whole + frac) == c.values.text[i]
                assert plan.parse_decimal(np.array([int(whole + frac)]),
                                          len(frac))[0] == c.values.value[i]


def test_decimal_parse_is_digits_over_the_power_of_ten():
    m = np.array([0, 1, 1234, -10849, 999999], np.int64)
    got = plan.parse_decimal(m, 3)
    want = [0.0, 0 + 1 / 1000, 1 + 234 / 1000, -(10 + 849 / 1000),
            999 + 999 / 1000]
    assert got.tolist() == want


def test_text_formats_signs_and_zeros():
    v = plan.Values(np.array([-10849, 5, 120000], np.int64), 3,
                    np.zeros(3))
    rows = dsd.value_text(v)
    text = [bytes(r[r != 0]) for r in rows]
    assert text == [b"-10.849", b"0.005", b"120.000"]


def test_counters_mix_is_baseline_config_one():
    t = traffic("counters")
    p = plan.dogstatsd_plan(t, NODE, 3, 1000)
    c = p.classes[0]
    assert c.names.tag_values == 16
    assert {c.names.name(j) for j in range(c.names.n_series)} == {
        f"req.count.{k}" for k in range(c.names.n_series // 16)}
    assert int(t["classes"][0]["samples"]) // int(
        t["lines_per_datagram"]) == 1_000_000


def test_fleet_wires_deterministic_and_decoded_by_the_schema():
    t = traffic("grpc64")
    enc = wire.FleetEncoder(t["compression"])
    w1, items, cents = enc.wire(plan.fleet_local(t, BIG_SEED, 3, 64))
    w2, _, _ = wire.FleetEncoder(t["compression"]).wire(
        plan.fleet_local(t, BIG_SEED, 3, 64))
    w3, items3, cents3 = enc.wire(plan.fleet_local(t, BIG_SEED, 4, 64))
    assert w1 == w2 and w1 != w3
    assert (items, cents) == (items3, cents3)
    ml = forward_pb2.MetricList.FromString(w1)
    assert len(ml.metrics) == items
    classes = plan.fleet_local(t, BIG_SEED, 3, 64)
    by_name = {m.name: m for m in ml.metrics}
    timers = classes[0]
    j = 5
    d = by_name[timers.names.name(j)].histogram.t_digest
    vals = np.sort(timers.values.value[timers.series == j].astype(
        np.float32).astype(np.float64))
    assert [c.mean for c in d.main_centroids] == vals.tolist()
    assert all(c.weight == 1.0 for c in d.main_centroids)
    assert (d.min, d.max, d.compression) == (vals[0], vals[-1], 100.0)
    assert d.reciprocalSum == pytest.approx((1 / vals).sum(), rel=1e-12)
    assert by_name[timers.names.name(j)].scope == metric_pb2.Mixed
    assert by_name[timers.names.name(j)].type == metric_pb2.Timer
    gt = by_name[classes[1].names.name(0)]
    assert gt.scope == metric_pb2.Global
    cnt = classes[2]
    assert by_name[cnt.names.name(2)].counter.value == int(
        cnt.values.text[cnt.series == 2].sum())
    g = classes[3]
    assert by_name[g.names.name(1)].gauge.value == g.values.value[
        np.nonzero(g.series == 1)[0][-1]]
    sets = classes[4]
    s = by_name[sets.names.name(3)].set.hyper_log_log
    assert s[:4] == bytes([1, 14, 0, 0]) and len(s) == 8 + 8192
    idx, rank = wire.hll_positions(sets.values.text[sets.series == 3])
    regs = np.zeros(wire.HLL_M, np.uint8)
    np.maximum.at(regs, idx, rank)
    packed = np.frombuffer(s[8:], np.uint8)
    nib = np.empty(wire.HLL_M, np.uint8)
    nib[0::2], nib[1::2] = packed >> 4, packed & 15
    assert (nib == np.minimum(regs, 15)).all() and nib.any()
    assert sum(c.names.n_series for c in classes) == items


def test_fleet_sizes_match_baseline_config_five():
    t = traffic("grpc64")
    items = sum(c["series"] for c in t["classes"]) * t["locals"]
    cents = sum(c["samples_per_local"] for c in t["classes"]
                if c["type"] == "timer") * t["locals"]
    assert (items, cents) == (852_992, 10_249_984)


def test_marker_item_decodes():
    ml = forward_pb2.MetricList.FromString(
        wire.counter_item("portbench.interval", (), 12, "global"))
    (m,) = ml.metrics
    assert (m.name, m.counter.value, m.scope) == (
        "portbench.interval", 12, metric_pb2.Global)


def test_plain_digest_keeps_small_digests_as_their_samples():
    v = np.random.default_rng(1).gamma(2.0, 30.0, 120)
    m, w = wire.plain_digest(v, 100.0)
    assert m.tolist() == np.sort(v).tolist() and (w == 1).all()
    assert wire.singleton_bound(100.0) == 127
    big = np.random.default_rng(2).gamma(2.0, 30.0, 20_000)
    m, w = wire.plain_digest(big, 100.0)
    assert w.sum() == 20_000 and len(m) < 200
    assert np.all(np.diff(m) >= 0)


def test_hll_registers_from_members():
    members = np.arange(5000, dtype=np.int64)
    idx, rank = wire.hll_positions(members)
    assert idx.min() >= 0 and idx.max() < wire.HLL_M
    assert rank.min() >= 1 and rank.max() <= 51
    # ranks follow the leading zeros: about half the members rank 1
    assert 0.4 < (rank == 1).mean() < 0.6
