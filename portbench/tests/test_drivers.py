"""Each driver rehearsed on the CPU at a tiny size, on the kernels' plain
versions: the window, the end-to-end readers, and the check's numbers,
every one a number the cell's limits name."""

import math

import pytest

from portbench import harness
from portbench.tests.rehearsal import rehearse

BENCH = harness.benchmark()


@pytest.mark.parametrize("cell", ["social.fleet4096", "obstacle.fleet4096", "social.robot1",
                                  "social.campaign4096"])
def test_rehearsal(cell):
    r, numbers, _ = rehearse(cell, seed=2**31 + 17)
    assert r.window.solves > 0 and r.window.failed == 0 and r.window.seconds > 0
    for m in harness.cell_metrics(BENCH, cell, "end_to_end"):
        value = harness.load_by_path("metrics", m["name"]).read(r)
        assert value is not None and math.isfinite(value) and value > 0, m["name"]
    values = numbers.values()
    assert numbers.answers > 0
    assert set(harness.limits(cell)) <= set(values), "every limit names a compared number"
    assert all(math.isfinite(v) for v in values.values())
