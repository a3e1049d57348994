"""The controls and the program at the cells' own sizes, on the card only
(``-m chip``); ``calibrate.py`` reads the same on a dozen seeds.  Each
cell's control is its driver's ``CONTROL`` (``harness/core.py:control``)."""

import time

import pytest

from harness import core

MAN = core.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct_at_the_cells_size(name, card):
    res = core.execute(name, 2 ** 31 + 77, 3.0, False, card, time.perf_counter(), MAN)
    assert res["correct"], res["checks"]


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name, card):
    checks = core.judge(core.control(name, 2 ** 31 + 78, card, MAN),
                        core.cell(MAN, name)[3]["limits"])
    assert not all(c.ok for c in checks), checks
