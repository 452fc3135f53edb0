"""The control (the reference in the program's place, half of each
interval's acknowledged samples left out) comes out not correct."""

import pytest

import control
from conftest import find_cell
from pbench.results import limits_for
from reference import compare


@pytest.mark.parametrize("name,scale", [("local.mixed", 50),
                                        ("global.grpc64", 64)])
def test_control_fails(name, scale):
    cell = find_cell(name)
    nums = control.control_numbers(cell, 12345, scale)
    ok, checks = compare.judge(nums, limits_for(cell))
    assert not ok, checks
    assert nums["exact_off"] > 0
