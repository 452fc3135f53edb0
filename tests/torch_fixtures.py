"""Fixtures shared by the port's test files (``tests/test_torch_*.py``).

Import a fixture by name into a test module to use it there.
"""

from __future__ import annotations

import functools

import pytest

from veneur_tpu.protocol import ssf_convert as jssf_convert
from veneur_tpu_torch.protocol import ssf_convert


@pytest.fixture(autouse=True)
def unsampled_span_uniqueness(monkeypatch):
    """A traced import wire leaves an ``import`` span, and the
    ssfmetrics sink samples every span for its uniqueness sketch with a
    1% random roll, as the reference does: the roll is fixed to "not
    sampled" in both packages, so flushes and ledgers stay
    comparable."""
    for mod in (ssf_convert, jssf_convert):
        monkeypatch.setattr(mod, "convert_span_uniqueness_metrics",
                            functools.partial(
                                mod.convert_span_uniqueness_metrics,
                                _random=lambda: 1.0))
