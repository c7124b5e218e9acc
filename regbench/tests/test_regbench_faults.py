"""`correct` comes out false when the timed path is broken underneath, and
when the control (the reference in bfloat16, the precision below the
configurations' float32) stands in the program's place.

Each fault of `regbench.faults` but those of `faults.SELECTION` (read on the
card at the cells' own sizes) drives a whole tiny run on the CPU past the
harness's look for a card, with the cell's own limits. A cell on one chip
has no exchange between chips to leave out."""

import pytest
import torch

from regbench import compare, control, faults, harness
from regbench.tests.tiny import plain, tiny_cell

CELLS = ["kitti.sweep", "threedmatch.sweep"]


def _run(name, register):
    return harness.run(tiny_cell(name, pairs=8), 2 ** 31 + 21, 0.3, False, torch.device("cpu"),
                       0.0, register=register)


@pytest.mark.parametrize("name", CELLS)
def test_the_sound_program_is_correct(name):
    assert _run(name, plain())["correct"] is True


@pytest.mark.parametrize("fault", sorted(set(faults.FAULTS) - set(faults.SELECTION)))
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_is_not_correct(name, fault):
    res = _run(name, faults.FAULTS[fault](plain()))
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["compared"].values())


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = tiny_cell(name, pairs=8)
    numbers = control.control_numbers(cell, 2 ** 31 + 23, torch.device("cpu"))
    assert not compare.judge(numbers, cell.spec["limits"])
