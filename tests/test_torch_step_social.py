"""The people path of the PyTorch port as a whole, social benchmark
configuration (N = 3, D = 6, S = 29): the port's batched step on the CPU
against the JAX package's ``make_step_batch`` in float64 on identical NumPy
inputs — every scenario with three valid people, and a mixed batch in which
some scenarios have none; plus ``people_present`` after the FOV filter."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_common import assert_step_parity_f64, people_in_view, run_both

from nav2_social_mpc_controller_tpu.controller import controller as jctl
from nav2_social_mpc_controller_tpu.controller.controller import make_step_batch as jax_make_step_batch
from nav2_social_mpc_controller_tpu.core.config import benchmark_social_config as jax_social_config
from nav2_social_mpc_controller_tpu.utils.scenarios import (
    make_scenario as jax_make_scenario,
    stack_scenarios as jax_stack_scenarios,
)
from nav2_social_mpc_controller_tpu_torch.controller import controller as tctl
from nav2_social_mpc_controller_tpu_torch.core import types as T
from nav2_social_mpc_controller_tpu_torch.core.config import config_from_dict

torch.set_num_threads(1)

N_TICKS = 3
BATCHES = {"all": (3,) * 8, "mixed": (3, 0, 2, 0, 1, 3, 0, 2)}


@functools.lru_cache(maxsize=None)
def _jstep():
    return jax_make_step_batch(jax_social_config())  # compiled once for both batches


@functools.lru_cache(maxsize=None)
def _run(batch):
    return run_both(jax_social_config(), BATCHES[batch], N_TICKS, np.float64, jstep=_jstep())


@pytest.mark.parametrize("tick", range(N_TICKS))
@pytest.mark.parametrize("batch", list(BATCHES))
def test_step_parity_f64(batch, tick):
    """Commands and paths within 1e-6; status, cursor, LM iteration counts,
    termination codes and the carry equal (test_torch_common). Ticks 2-3 run
    with the carry fed back."""
    jax_side, torch_side = _run(batch)[tick]
    assert_step_parity_f64(jax_side, torch_side, tick)
    seen = people_in_view(torch_side)
    if tick == 0:
        assert seen.any()
    if batch == "mixed":
        assert not seen[np.asarray(BATCHES["mixed"]) == 0].any()
    # the people really shape the solve: the projection of a seen person is live
    assert (torch_side[1].people_proj[seen][:, 1, :, 3] != -1.0).any(axis=1).all()


def test_people_change_the_command():
    """The same scenarios with and without their people give different
    commands where a person is in view, and identical ones where none is."""
    with_people = _run("mixed")[0][1]
    jcfg = jax_social_config()
    without = run_both(jcfg, (0,) * 8, 1, np.float64, jstep=_jstep())[0][1]
    seen = people_in_view(with_people)
    delta = np.abs(with_people[0].linear_x - without[0].linear_x) + np.abs(
        with_people[0].angular_z - without[0].angular_z)
    assert (delta[seen] > 1e-6).any()
    np.testing.assert_array_equal(delta[~seen], 0.0)


def test_people_present_is_per_scenario_after_the_fov_filter():
    """optimize_prepare's people_present against the JAX package's: a person
    behind the robot or outside the costmap does not switch the social mask
    on, one in view does, scenario by scenario."""
    jcfg = jax_social_config()
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    sc = jax_stack_scenarios(
        [jax_make_scenario(jcfg, seed=s, n_valid_people=2, dtype=np.float64) for s in range(5)])
    state = np.array(sc.people.state)
    x0, y0, yaw0 = np.asarray(sc.robot.pose).T
    ahead = np.stack([x0 + np.cos(yaw0), y0 + np.sin(yaw0)], axis=1)
    behind = np.stack([x0 - np.cos(yaw0), y0 - np.sin(yaw0)], axis=1)
    off_map = np.asarray(sc.costmap.origin) - 0.5
    state[0, 0, 0:2], state[0, 1, 0:2] = ahead[0], behind[0]  # one in view
    state[1, 0, 0:2], state[1, 1, 0:2] = behind[1], behind[1]  # both outside the cone
    state[2, 0, 0:2], state[2, 1, 0:2] = off_map[2], behind[2]  # off the costmap / behind
    state[3, :, 3] = -1.0  # nobody
    state[4, 0, 0:2], state[4, 1, 3] = ahead[4], -1.0  # the only valid one in view
    sc = sc._replace(people=sc.people._replace(state=state))

    jcarry = jax.tree.map(lambda x: jnp.broadcast_to(x, (5,) + x.shape),
                          jctl.make_carry(jcfg, dtype=jnp.float64))
    jprep = jax.vmap(functools.partial(jctl.step_pre, jcfg))(sc, jcarry).prep
    tprep = tctl.step_pre(
        cfg, T.scenario_from_numpy(sc, device="cpu", dtype=torch.float64),
        tctl.make_carry(cfg, 5, device="cpu", dtype=torch.float64)).prep
    assert tprep.people_present.dtype == torch.bool and tprep.people_present.shape == (5,)
    np.testing.assert_array_equal(tprep.people_present.numpy(), np.asarray(jprep.people_present))
    assert tprep.people_present.tolist() == [True, False, False, False, True]
