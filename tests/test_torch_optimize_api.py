"""The port's ``controller/optimize.py: optimize`` (optimize_prepare ->
solve_prepared -> optimize_finish) and ``controller/path_handler.py:
get_goal_point`` against the JAX package's functions of the same names, in
float64 on the CPU, on the same seeded NumPy inputs (the JAX functions run
per scenario under jax.vmap)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nav2_social_mpc_controller_tpu.controller import controller as jctl
from nav2_social_mpc_controller_tpu.controller import optimize as jopt
from nav2_social_mpc_controller_tpu.controller import path_handler as jpath
from nav2_social_mpc_controller_tpu.core.config import benchmark_social_config
from nav2_social_mpc_controller_tpu.core.types import PathInput as JaxPath
from nav2_social_mpc_controller_tpu.utils.scenarios import make_scenario, stack_scenarios
from nav2_social_mpc_controller_tpu_torch.controller import optimize as topt
from nav2_social_mpc_controller_tpu_torch.controller import path_handler as tpath
from nav2_social_mpc_controller_tpu_torch.core import types as T
from nav2_social_mpc_controller_tpu_torch.core.config import config_from_dict

torch.set_num_threads(1)


def _front(cfg, sc, carry):
    """The JAX step's head up to optimize's inputs, for one scenario: plan
    windowing, trajectorize and the FOV filter."""
    h, w = sc.costmap.data.shape[-2:]
    dist = jnp.maximum(w * sc.costmap.resolution, h * sc.costmap.resolution) / 2.0
    windowed = jctl.transform_global_plan(sc.path, sc.robot.pose, cfg.max_robot_pose_search_dist,
                                          dist, start=carry.plan_start)
    traj = jctl.trajectorize(cfg.trajectorizer, windowed.path, sc.robot.pose)
    people = jctl.fov_filter(cfg, sc.people, sc.robot.pose, sc.costmap)
    return traj.poses, traj.cmds, traj.n_steps, people


def test_optimize_matches_jax_optimize_f64():
    """optimize on the inputs the JAX step's head gives four social
    scenarios (3, 1, 0 and 2 valid people): the commands, re-integrated
    path and decision blocks within 1e-6, the people projection within
    1e-9, iteration counts, terminations, usability and counts equal."""
    jcfg = benchmark_social_config()
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    sc = stack_scenarios([make_scenario(jcfg, seed=s, n_valid_people=p, dtype=np.float64)
                          for s, p in enumerate((3, 1, 0, 2))])
    carry = jax.tree.map(lambda x: jnp.broadcast_to(x, (4,) + x.shape),
                         jctl.make_carry(jcfg, dtype=jnp.float64))

    def jax_side(sc, carry):
        poses, cmds, n_steps, people = _front(jcfg, sc, carry)
        return (poses, cmds, n_steps, people), jopt.optimize(
            jcfg, poses, cmds, n_steps, sc.robot.speed, people, sc.costmap, sc.esdf, carry)

    (poses, cmds, n_steps, people), want = jax.tree.map(
        np.asarray, jax.jit(jax.vmap(jax_side))(sc, carry))
    f64 = torch.float64
    tsc = T.scenario_from_numpy(sc, device="cpu", dtype=f64)
    got = topt.optimize(
        cfg, torch.tensor(poses), torch.tensor(cmds), torch.tensor(n_steps),
        tsc.robot.speed, T.AgentsState(torch.tensor(people.state)), tsc.costmap, tsc.esdf,
        T.carry_from_numpy(jax.tree.map(np.asarray, carry), device="cpu", dtype=f64))
    got = T.to_numpy(got)
    np.testing.assert_array_equal(got.ok, want.ok)
    assert got.ok.all()
    np.testing.assert_array_equal(got.n, want.n)
    np.testing.assert_allclose(got.cmds, want.cmds, atol=1e-6)
    np.testing.assert_allclose(got.path, want.path, atol=1e-6)
    np.testing.assert_allclose(got.u.reshape(want.u.shape), want.u, atol=1e-6)
    np.testing.assert_allclose(got.people_proj, want.people_proj, atol=1e-9)
    np.testing.assert_array_equal(got.stats.iterations, want.stats.iterations)
    np.testing.assert_array_equal(got.stats.termination, want.stats.termination)
    np.testing.assert_array_equal(got.stats.usable, want.stats.usable)
    np.testing.assert_allclose(got.stats.final_cost, want.stats.final_cost, rtol=1e-6)
    assert got.lm_trace is None and want.lm_trace is None


def test_get_goal_point_matches_jax_f64():
    """get_goal_point on 64 random padded plans (counts 0 to P, some goal
    distances beyond every pose, so the last valid pose is taken): the
    point the JAX function picks, exactly."""
    rng = np.random.default_rng(7)
    b, p = 64, 24
    points = np.cumsum(rng.normal(0.0, 0.4, (b, p, 2)), axis=1)
    n = rng.integers(0, p + 1, b).astype(np.int32)
    n[:3] = (0, 1, p)
    yaw = rng.uniform(-np.pi, np.pi, (b, p))
    pose = np.concatenate([rng.normal(0.0, 1.0, (b, 2)), rng.uniform(-3, 3, (b, 1))], axis=1)
    for goal_dist in (0.0, 0.7, 2.5, 1e3):
        want = np.asarray(jax.vmap(lambda pts, y, k, r: jpath.get_goal_point(
            JaxPath(pts, y, k), r, goal_dist))(points, yaw, n, pose))
        got = tpath.get_goal_point(
            T.PathInput(torch.tensor(points), torch.tensor(yaw), torch.tensor(n)),
            torch.tensor(pose), goal_dist).numpy()
        np.testing.assert_array_equal(got, want)
