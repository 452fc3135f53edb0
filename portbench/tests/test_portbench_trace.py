"""The traced run's reduction, on a hand-made trace."""

import pytest

from pbench import trace


def ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    ev(trace.WINDOW, "user_annotation", 1000, 1000),
    ev("import", "user_annotation", 1000, 600),
    ev("flush_once", "user_annotation", 1600, 400),
    ev("void (anonymous namespace)::cluster_merge_kernel<4>(float*, int)",
       "kernel", 1100, 50),
    ev("void at::native::foo<float>(at::Tensor)", "kernel", 1120, 60),
    ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 1700, 100),
    ev("void at::native::foo<float>(at::Tensor)", "kernel", 900, 150),
    ev("cpu op", "cpu_op", 1000, 900),
]


def test_busy_union_inside_the_window():
    s = trace.summarize(EVENTS)
    assert s.window_s == pytest.approx(1000e-6)
    # [1000, 1050) clipped, [1100, 1180), [1700, 1800)
    assert s.busy_s == pytest.approx((50 + 80 + 100) * 1e-6)
    assert s.kernel_seconds("cluster_merge") == pytest.approx(50e-6)


def test_ops_and_gaps_are_named():
    s = trace.summarize(EVENTS)
    names = dict(s.top_ops())
    assert names["at::native::foo"] == pytest.approx(110e-6)
    assert names["Memcpy HtoD (Pageable -> Device)"] == pytest.approx(100e-6)
    # idle from 1180 to 1700 under "import", 1800 to 2000 under
    # "flush_once", 1050 to 1100 under "import"
    assert [(n, round(t * 1e6)) for n, t in s.gaps] == [
        ("import", 520), ("flush_once", 200), ("import", 50)]


def test_short_names():
    assert trace.short_name("void at::native::foo<float, 4>(at::T)") == \
        "at::native::foo"
