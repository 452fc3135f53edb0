"""The plain reference against hand-worked cases, and the comparison
against each kind of fault it must catch."""

from types import SimpleNamespace

import numpy as np
import pytest

from pbench import plan
from reference import compare, expected


def hand_plan():
    """Two feeders, two lines a sweep; lines in position order:
    0 c0:2  1 g0:1.500  | 2 t0:3.000  3 g0:2.250 | 4 t0:1.000  5 s0:m7
    6 c0:5  7 s0:m7     | 8 t0:2.000  9 g0:4.000
    Sweeps 0, 2, 4 go to feeder 0; 1, 3 to feeder 1."""
    names = lambda p: plan.SeriesNames(p, 1, 1, "shard", ("env:t",))
    V = plan.Values
    c = plan.DsdClass("counter", names("c"), np.array([0, 0]),
                      V(np.array([2, 5]), 0, np.array([2.0, 5.0])),
                      np.array([0, 6]))
    g = plan.DsdClass("gauge", names("g"), np.array([0, 0, 0]),
                      V(np.array([1500, 2250, 4000]), 3,
                        np.array([1.5, 2.25, 4.0])), np.array([1, 3, 9]))
    t = plan.DsdClass("timer", names("t"), np.array([0, 0, 0]),
                      V(np.array([3000, 1000, 2000]), 3,
                        np.array([3.0, 1.0, 2.0])), np.array([2, 4, 8]))
    s = plan.DsdClass("set", names("s"), np.array([0, 0]),
                      V(np.array([7, 7]), 0, np.full(2, np.nan)),
                      np.array([5, 7]))
    return plan.DsdPlan([c, g, t, s], 10, 2, 2)


def test_hand_worked_interval():
    ex = expected.dogstatsd_expected(hand_plan(), (0.5, 0.75, 0.99),
                                     ("min", "max", "count"))
    k = ("c0", ("env:t",))
    assert ex.counters == {k: 7.0}
    # feeder 0 wrote g0 last at line 9 (4.0), feeder 1 at line 3 (2.25)
    assert ex.gauges == {("g0", ("env:t",)): frozenset({4.0, 2.25})}
    (t,) = ex.timers
    assert (t.count[0], t.vmin[0], t.vmax[0]) == (3.0, 1.0, 3.0)
    # linear between order statistics of 1, 2, 3
    assert t.quantiles[0].tolist() == pytest.approx([2.0, 2.5, 2.98])
    assert ex.sets == {("s0", ("env:t",)): 1}


def test_percentile_names():
    assert expected.percentile_suffix(0.5) == ".50percentile"
    assert expected.percentile_suffix(0.75) == ".75percentile"
    assert expected.percentile_suffix(0.999) == ".999percentile"


def flush_of(ex, interval=1):
    from control import reference_flush
    return reference_flush(ex, interval)


def numbers(got, ex, interval=1, ledger_ok=True):
    r = compare.Readings()
    compare.compare_interval(got, ex, interval, ledger_ok, r)
    return r.numbers(), r.exact


EX = expected.dogstatsd_expected(hand_plan(), (0.5, 0.75, 0.99),
                                 ("min", "max", "count"))


def test_the_reference_flush_passes():
    n, parts = numbers(flush_of(EX), EX)
    assert n["exact_off"] == 0 and n["pct_err_max"] == 0
    assert n["set_err_max"] == 0


@pytest.mark.parametrize("fault,part", [
    (lambda f: f.__setitem__(("c0", ("env:t",)), 8.0), "counter"),
    (lambda f: f.__setitem__(("g0", ("env:t",)), 1.5), "gauge"),
    (lambda f: f.__setitem__(("t0.count", ("env:t",)), 2.0), "aggregate"),
    (lambda f: f.__setitem__(("t0.min", ("env:t",)), 2.0), "aggregate"),
    (lambda f: f.pop(("s0", ("env:t",))), "missing"),
    (lambda f: f.__setitem__(("x", ()), 1.0), "extra"),
    (lambda f: f.__setitem__((expected.MARKER, ()), 1.0), "marker"),
])
def test_each_exact_fault_is_counted(fault, part):
    f = flush_of(EX)
    fault(f)
    n, parts = numbers(f, EX)
    assert parts[part] == 1 and n["exact_off"] == 1


def test_self_telemetry_is_not_extra():
    f = flush_of(EX)
    f[("veneur.flush.total", ())] = 3.0
    assert numbers(f, EX)[0]["exact_off"] == 0


def test_a_stale_interval_fails_on_the_marker():
    assert numbers(flush_of(EX, 4), EX, 5)[1]["marker"] == 1


def test_percentile_and_set_errors_are_relative():
    f = flush_of(EX)
    f[("t0.99percentile", ("env:t",))] = 2.98 * 1.1
    f[("s0", ("env:t",))] = 2.0
    n, _ = numbers(f, EX)
    assert n["pct_err_max"] == pytest.approx(0.1)
    assert n["set_err_max"] == pytest.approx(1.0)


def test_ledger_record_checks():
    rec = SimpleNamespace(sealed=True, balanced=True,
                          received={"dogstatsd": 10, "self-telemetry": 3})
    assert compare.ledger_ok(rec, "dogstatsd", 10)
    assert not compare.ledger_ok(rec, "dogstatsd", 11)
    rec.balanced = False
    assert not compare.ledger_ok(rec, "dogstatsd", 10)
    assert not compare.ledger_ok(None, "dogstatsd", 10)
    assert numbers(flush_of(EX), EX, ledger_ok=False)[0]["exact_off"] == 1


def test_judge_fails_a_missing_number():
    ok, checks = compare.judge({"a": 0, "b": None}, {"a": 0, "b": 1.0})
    assert not ok and checks == {"a": [0, 0], "b": [None, 1.0]}
    assert compare.judge({"a": 0.5}, {"a": 1.0})[0]


def test_exact_quantiles_of_unequal_series():
    s = np.array([0, 1, 0, 1, 1])
    v = np.array([4.0, 1.0, 2.0, 3.0, 2.0])
    q = expected.exact_quantiles(s, v, 3, (0.5,))
    assert q[0, 0] == 3.0 and q[1, 0] == 2.0 and np.isnan(q[2, 0])
