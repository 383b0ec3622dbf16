"""The control (portbench/control.py: the reference in bfloat16 in the
program's place) fails the cell's check, here at a size a test run holds;
its readings at the cells' own sizes are in PERF.md."""

import pytest

from portbench import check, control, harness
from portbench.tests.rehearsal import context


@pytest.mark.parametrize("cell", ["social.fleet4096", "obstacle.fleet4096", "social.robot1",
                                  "social.campaign4096"])
def test_control_is_not_correct(cell):
    traffic = context(cell, 5).traffic
    if "lanes" in traffic["check"]:
        traffic["check"]["lanes"] = 2
    out = control.run_control(cell, 2**31 + 5, workers=4, traffic=traffic)
    ok, checks = check.judge(out["values"], harness.limits(cell))
    assert out["answers"] > 0
    assert not ok, checks
