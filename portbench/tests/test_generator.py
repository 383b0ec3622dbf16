"""The frozen generator (portbench/gen/): the same seed gives the same
batch, another seed another one, lanes are distinct, and the three plan
shapes are dealt out by lane."""

import numpy as np
import pytest

from portbench import harness
from portbench.gen import native

TRAFFIC = harness.traffic("fleet4096")
DOC = harness.read_json(harness.HERE, "configs", "social.json")


def batch(seed, b=9, threads=2):
    return native.generate(TRAFFIC["scenario"], b, seed, 3, DOC["n_agents"],
                           DOC["max_path_points"], threads=threads)


@pytest.mark.parametrize("seed", [0, 12345, 2**31 + 7, 3 * 10**9])
def test_same_seed_same_batch(seed):
    a, b = batch(seed), batch(seed, threads=3)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_seeds_and_lanes_differ():
    a, b = batch(5), batch(6)
    assert not np.array_equal(a["people"], b["people"])
    assert len({a["robot_speed"][i, 0] for i in range(9)}) == 9


def test_plan_shapes_dealt_by_lane():
    a = batch(11)
    straight = np.all(a["path_points"][:, :40, 1] == 0.0, axis=1)
    assert straight.tolist() == [i % 3 == 2 for i in range(9)]
    assert (a["path_n"] == 40).all()


def test_negative_seed_refused():
    with pytest.raises(ValueError):
        native.lane_seed_base(-1)
