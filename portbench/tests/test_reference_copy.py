"""The frozen reference (portbench/reference/oracle.py, jets.py) gives what
the repository's parity/oracle.py gives, on two generated scenarios over
three ticks of an episode."""

import numpy as np
import pytest

from parity import oracle as parity_oracle
from portbench import harness
from portbench.gen import native
from portbench.reference import oracle, tick

DOC = harness.read_json(harness.HERE, "configs", "social.json")
TRAFFIC = harness.traffic("fleet4096")


@pytest.mark.parametrize("lane", [0, 1])
def test_oracle_copy_matches_parity(lane):
    arrays = native.generate(TRAFFIC["scenario"], 2, 424242, 3, DOC["n_agents"],
                             DOC["max_path_points"])
    one = native.lanes(arrays, lane)
    cfg = tick.config_namespace(DOC)
    costmap, esdf = tick.lane_world(one)
    poses = harness.plan_poses(arrays, 3, TRAFFIC["plan_stride"])
    outs = []
    for mod in (oracle, parity_oracle):
        plan, memory, got = tick.plan_of(one), {}, []
        for p in poses:
            cmd, status, plan = mod.oracle_step(cfg, plan, np.asarray(p[lane], np.float64),
                                                np.asarray(one["robot_speed"], np.float64),
                                                np.asarray(one["people"], np.float64),
                                                costmap, esdf, memory)
            got.append((cmd, status, len(plan), memory["prev_cmds"].copy()))
        outs.append(got)
    for a, b in zip(*outs):
        assert a[0] == b[0] and a[1] == b[1] and a[2] == b[2]
        np.testing.assert_array_equal(a[3], b[3])


def test_episode_reports_every_tick():
    arrays = native.generate(TRAFFIC["scenario"], 1, 7, 3, DOC["n_agents"],
                             DOC["max_path_points"])
    poses = [p[0] for p in harness.plan_poses(arrays, 2, TRAFFIC["plan_stride"])]
    ticks = tick.episode(DOC, native.lanes(arrays, 0), poses)
    assert [t["cursor"] for t in ticks] == [0, 4]
    assert all(t["status"] == 0 and t["initial_cost"] > 0 for t in ticks)


def test_bfloat16_rounding():
    assert tick.bf16(1.0) == 1.0
    assert tick.bf16(1.0 + 2.0**-9) == 1.0  # below half an ulp (2**-8)
    assert tick.bf16(1.0 + 3 * 2.0**-9) == 1.0 + 2.0**-7
    assert np.isnan(tick.bf16(float("nan")))
