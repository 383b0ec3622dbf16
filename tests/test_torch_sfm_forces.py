"""The port's SFM library (desired, obstacle, group forces, update) and its
whole-grid ESDF lookup against the JAX package's, in float64 on identical
NumPy inputs; the port runs them batched over scenarios, the JAX package
per scenario."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nav2_social_mpc_controller_tpu.models import sfm as jsfm
from nav2_social_mpc_controller_tpu.utils.scenarios import make_esdf
from nav2_social_mpc_controller_tpu.world.grid import (
    esdf_nearest_obstacle_diff as jax_esdf_nearest_obstacle_diff,
)
from nav2_social_mpc_controller_tpu_torch.models import sfm as tsfm
from nav2_social_mpc_controller_tpu_torch.world.grid import esdf_nearest_obstacle_diff

TOL = dict(atol=1e-12, rtol=1e-12)
B, M = 3, 6


def _agents(seed):
    """Positions, velocities, goals of B x M agents with the corner cases:
    an invalid agent, a standing agent (zero velocity), an agent at its
    goal, two coincident agents, an agent exactly on its goal radius."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2.0, 2.0, (B, M, 2))
    vel = rng.uniform(-0.8, 0.8, (B, M, 2))
    goal = pos + rng.uniform(-3.0, 3.0, (B, M, 2))
    valid = np.ones((B, M), bool)
    valid[0, 1] = False
    vel[0, 2] = 0.0
    goal[1, 3] = pos[1, 3]
    pos[2, 4] = pos[2, 5]
    goal[2, 0] = pos[2, 0] + np.array([0.25, 0.0])
    return pos, vel, goal, valid


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == np.bool_:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


def _t(*xs):
    return [torch.tensor(x) for x in xs]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_desired_force(seed):
    pos, vel, goal, valid = _agents(seed)
    speed = np.random.default_rng(seed).uniform(0.0, 0.9, (B, M))
    got = tsfm.desired_force(*_t(pos, vel, goal, valid), 0.25, torch.tensor(speed),
                             tsfm.DEFAULT_PARAMS)
    want = jsfm.desired_force(pos, vel, goal, valid, 0.25, speed, jsfm.DEFAULT_PARAMS)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_obstacle_force(seed):
    pos, _, goal, valid = _agents(seed)
    entry = pos - goal * 0.3
    entry[1, 2] = pos[1, 2]  # the agent on its obstacle: the (eps, 0) guard
    got = tsfm.obstacle_force(*_t(pos, entry, valid), 0.5, tsfm.DEFAULT_PARAMS)
    _close(got, jsfm.obstacle_force(pos, entry, valid, 0.5, jsfm.DEFAULT_PARAMS))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sfm_update(seed):
    pos, vel, goal, valid = _agents(seed)
    rng = np.random.default_rng(seed + 10)
    yaw = rng.uniform(-3.0, 3.0, (B, M))
    force = rng.uniform(-20.0, 20.0, (B, M, 2))
    force[0, 2] = -vel[0, 2] / 0.05  # lands exactly at rest
    speed = np.full((B, M), 0.5)
    got = tsfm.sfm_update(*_t(pos, vel, yaw, force, speed, goal, valid), 0.25, 0.05)
    want = jsfm.sfm_update(pos, vel, yaw, force, speed, goal, valid, 0.25, 0.05)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("case", ["none", "pairs", "one_and_three", "all_one_group", "invalid"])
def test_group_forces(case):
    pos, vel, _, valid = _agents(5)
    group = {
        "none": [[-1] * M] * B,
        "pairs": [[0, 0, 1, 1, 2, 2]] * B,
        "one_and_three": [[0, 1, 1, 1, 2, -1], [3, 3, 3, 4, -1, 4], [7, 5, 7, 5, 7, 6]],
        "all_one_group": [[0] * M] * B,
        "invalid": [[0, 0, 0, 1, 1, 1]] * B,
    }[case]
    group = np.asarray(group, np.int32)
    if case != "invalid":
        valid = np.ones((B, M), bool)
    pos[1, :3] = pos[1, 0] + np.array([[0.0, 0.0], [0.3, 0.0], [0.0, 0.4]])  # close: repulsion
    direction = vel.copy()
    direction[0, 0] = 0.0  # no desired direction
    radius = np.full((B, M), 0.35)
    got = tsfm.group_forces(*_t(pos, valid, group, direction, radius), tsfm.DEFAULT_PARAMS)
    want = np.stack([
        np.asarray(jsfm.group_forces(pos[b], valid[b], group[b], direction[b], radius[b],
                                     jsfm.DEFAULT_PARAMS))
        for b in range(B)
    ])
    _close(got, want)
    assert bool(got.any()) == (case != "none")


@pytest.mark.parametrize("seed", [0, 1])
def test_esdf_nearest_obstacle_diff(seed):
    rng = np.random.default_rng(seed)
    grids = [make_esdf(48, 56, resolution=0.05, origin=(-1.0, -1.5 + 0.1 * b),
                       obstacle_cells=[tuple(rng.integers(0, 48, 2)) for _ in range(3)],
                       dtype=np.float64) for b in range(B)]
    pts = rng.uniform(-1.5, 2.5, (B, 40, 2))  # beyond the grid on every side too
    pts[0, 0] = [-1.0, -1.5]  # the origin corner exactly
    stack = lambda f: np.stack([np.asarray(getattr(g, f)) for g in grids])
    diff, inside = esdf_nearest_obstacle_diff(
        *_t(stack("distances"), stack("indexes"), stack("origin"), stack("resolution"), pts))
    want = jax.vmap(jax_esdf_nearest_obstacle_diff)(
        *(jnp.asarray(x) for x in (stack("distances"), stack("indexes"), stack("origin"),
                                    stack("resolution"), pts)))
    _close(diff, want[0])
    _close(inside, want[1])
    assert inside.any() and not inside.all()
