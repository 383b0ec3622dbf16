"""The port's closed-loop simulator against the JAX package's, in float64
on the CPU, on the two scenarios of tests/test_simulator.py; and B closed
loops in lockstep equal, bit for bit, to the same loops run one by one."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from nav2_social_mpc_controller_tpu.core import config as jconfig
from nav2_social_mpc_controller_tpu.runtime.simulator import make_simulate as jax_make_simulate
from nav2_social_mpc_controller_tpu.utils.scenarios import make_scenario as jax_make_scenario
from nav2_social_mpc_controller_tpu_torch.core.config import config_from_dict
from nav2_social_mpc_controller_tpu_torch.runtime.simulator import (
    SimResult,
    make_simulate,
    simulate,
)
from test_torch_common import run_scalar_cpu_child

CASES = {
    "obstacle": (jconfig.benchmark_obstacle_only_config,
                 dict(seed=0, n_valid_people=0, path_kind="straight", with_obstacles=False)),
    "social": (jconfig.benchmark_social_config,
               dict(seed=3, n_valid_people=3, path_kind="straight")),
}


@pytest.mark.parametrize("name", list(CASES))
def test_simulate_f64_matches_jax(name):
    make_cfg, kw = CASES[name]
    jcfg = make_cfg()
    sc = jax_make_scenario(jcfg, dtype=np.float64, **kw)
    want = jax_make_simulate(jcfg, n_ticks=8)(sc)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    got = make_simulate(cfg, 8, device="cpu", dtype=torch.float64)(sc)
    assert got._fields == want._fields == SimResult._fields
    for field in ("robot_traj", "people_traj", "cmds", "goal_dist"):
        a, b = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert a.shape == b.shape and a.dtype == b.dtype, field
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=field)
    # inf (nobody valid) on both sides, or within the tolerance
    np.testing.assert_allclose(got.min_people_dist.numpy(), np.asarray(want.min_people_dist),
                               atol=1e-6, rtol=0)
    if name == "obstacle":
        assert float(got.min_people_dist) == float("inf")
    assert got.status.dtype == torch.int32
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))


def test_simulate_takes_a_batch_and_make_simulate_one_scenario():
    jcfg = jconfig.benchmark_obstacle_only_config()
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    sc = jax_make_scenario(jcfg, seed=0, n_valid_people=0)
    with pytest.raises(ValueError, match="batched"):
        simulate(cfg, sc, 1, device="cpu")
    two = jax.tree.map(lambda *x: np.stack(x), sc, sc)
    res = make_simulate(cfg, 2, device="cpu")(two)
    assert tuple(res.robot_traj.shape) == (2, 3, 3) and tuple(res.status.shape) == (2, 2)
    assert tuple(res.min_people_dist.shape) == (2,)


# Bit equality across batch widths needs ATen's scalar CPU kernels
# (test_torch_common.run_scalar_cpu_child says why).
_BATCH_CHILD = r"""
import json
import numpy as np, torch
from nav2_social_mpc_controller_tpu_torch.core.config import benchmark_social_config
from nav2_social_mpc_controller_tpu_torch.runtime.simulator import make_simulate
from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario, stack_scenarios

cfg = benchmark_social_config()
lanes = [make_scenario(cfg, seed=s, n_valid_people=3, path_kind="straight", dtype=np.float64)
         for s in (3, 5)]
sim = make_simulate(cfg, 4, device="cpu", dtype=torch.float64)
both = sim(stack_scenarios(lanes))
bad = []
for i, lane in enumerate(lanes):
    one = sim(lane)
    bad += [f"lane {i} {f}" for f, x, y in zip(one._fields, both, one) if not torch.equal(x[i], y)]
print(json.dumps({"bad": bad}))
"""


def test_batched_simulation_is_the_single_simulations_bit_for_bit_f64():
    assert run_scalar_cpu_child(_BATCH_CHILD)["bad"] == []
