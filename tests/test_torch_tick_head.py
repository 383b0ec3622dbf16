"""The tick head of the PyTorch port against the JAX package, in float64 on
identical NumPy inputs (atol 1e-12): plan windowing, trajectorizer, FOV
filter and the warm-start blend."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nav2_social_mpc_controller_tpu.controller import controller as jctl
from nav2_social_mpc_controller_tpu.controller import optimize as jopt
from nav2_social_mpc_controller_tpu.controller import path_handler as jph
from nav2_social_mpc_controller_tpu.controller import trajectorizer as jtraj
from nav2_social_mpc_controller_tpu.core import config as jcfg_mod
from nav2_social_mpc_controller_tpu.core import types as JT
from nav2_social_mpc_controller_tpu.utils.scenarios import make_scenario as jax_make_scenario
from nav2_social_mpc_controller_tpu_torch.controller import controller as tctl
from nav2_social_mpc_controller_tpu_torch.controller import optimize as topt
from nav2_social_mpc_controller_tpu_torch.controller import path_handler as tph
from nav2_social_mpc_controller_tpu_torch.controller import trajectorizer as ttraj
from nav2_social_mpc_controller_tpu_torch.core import config as tcfg_mod
from nav2_social_mpc_controller_tpu_torch.core import types as T
from nav2_social_mpc_controller_tpu_torch.utils import angles as tang

torch.set_num_threads(1)
ATOL = 1e-12


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _paths(seeds, kinds=("sine", "arc", "straight")):
    """Batched f64 PathInput (NumPy) of assorted plans."""
    jcfg = jcfg_mod.benchmark_obstacle_only_config()
    scs = [
        jax_make_scenario(jcfg, seed=s, n_valid_people=0, path_kind=kinds[s % len(kinds)],
                          n_path_points=30 + 3 * s, dtype=np.float64)
        for s in seeds
    ]
    return JT.PathInput(
        points=np.stack([s.path.points for s in scs]),
        yaw=np.stack([s.path.yaw for s in scs]),
        n=np.stack([s.path.n for s in scs]),
    )


@pytest.mark.parametrize("start", [0, 3, 11])
def test_transform_global_plan(start):
    path = _paths(range(6))
    b = path.points.shape[0]
    rng = np.random.default_rng(start)
    at = np.minimum(start + rng.integers(0, 6, b), path.n - 1)
    pose = np.concatenate(
        [path.points[np.arange(b), at] + rng.normal(0, 0.05, (b, 2)), rng.uniform(-1, 1, (b, 1))], 1
    )
    starts = np.full((b,), start, np.int32)
    thr = np.full((b,), 3.0)
    thr[1] = 0.8  # a short window: the find_if cut fires
    ref = jax.vmap(lambda p, r, t, s: jph.transform_global_plan(p, r, 4.0, t, start=s))(
        path, jnp.asarray(pose), jnp.asarray(thr), jnp.asarray(starts)
    )
    got = tph.transform_global_plan(
        T.PathInput(_t(path.points), _t(path.yaw), _t(path.n).to(torch.int32)),
        _t(pose), 4.0, _t(thr), start=_t(starts),
    )
    np.testing.assert_array_equal(got.start_index.numpy(), np.asarray(ref.start_index))
    np.testing.assert_array_equal(got.path.n.numpy(), np.asarray(ref.path.n))
    np.testing.assert_allclose(got.path.points.numpy(), np.asarray(ref.path.points), atol=ATOL)
    np.testing.assert_allclose(got.path.yaw.numpy(), np.asarray(ref.path.yaw), atol=ATOL)
    assert got.start_index.dtype == torch.int32 and (got.start_index.numpy() >= start).all()


def test_transform_global_plan_ties_and_empty():
    """Equidistant poses: the FIRST minimiser wins. An empty plan (n = 0,
    every candidate masked to inf) yields index 0."""
    pts = np.zeros((2, 8, 2))
    pts[0, :, 0] = [0, 1, 2, 3, 4, 5, 6, 7]
    pts[0, :, 1] = 0.0
    pts[1] = pts[0]
    path = JT.PathInput(points=pts, yaw=np.zeros((2, 8)), n=np.array([8, 0], np.int32))
    pose = np.array([[2.5, 0.0, 0.0], [2.5, 0.0, 0.0]])  # poses 2 and 3 tie
    ref = jax.vmap(lambda p, r: jph.transform_global_plan(p, r, 4.0, 10.0))(path, jnp.asarray(pose))
    got = tph.transform_global_plan(
        T.PathInput(_t(pts), _t(path.yaw), _t(path.n)), _t(pose), 4.0, 10.0
    )
    np.testing.assert_array_equal(got.start_index.numpy(), [2, 0])
    np.testing.assert_array_equal(got.start_index.numpy(), np.asarray(ref.start_index))
    np.testing.assert_array_equal(got.path.n.numpy(), np.asarray(ref.path.n))
    np.testing.assert_allclose(got.path.points.numpy(), np.asarray(ref.path.points), atol=ATOL)


@pytest.mark.parametrize("omni", [False, True], ids=["unicycle", "omni"])
def test_trajectorize(omni):
    """Assorted plans, one robot pose facing backwards (rotate in place) and
    one plan with fewer than 2 poses (ok = False, zero steps)."""
    path = _paths(range(7))
    path = path._replace(n=np.where(np.arange(7) == 6, 1, path.n).astype(np.int32))
    b = 7
    pose = np.concatenate([path.points[:, 0], path.yaw[:, :1]], 1)
    pose[2, 2] += 2.8  # facing away: |dtheta| > pi/2
    pose[3, 0:2] += (0.3, -0.2)
    jcfg = jcfg_mod.benchmark_obstacle_only_config().trajectorizer
    tcfg = tcfg_mod.benchmark_obstacle_only_config().trajectorizer
    if omni:
        jcfg = jcfg_mod.benchmark_omni_6agents_config().trajectorizer
        tcfg = tcfg_mod.benchmark_omni_6agents_config().trajectorizer
    ref = jax.vmap(lambda p, r: jtraj.trajectorize(jcfg, p, r))(path, jnp.asarray(pose))
    got = ttraj.trajectorize(
        tcfg, T.PathInput(_t(path.points), _t(path.yaw), _t(path.n)), _t(pose)
    )
    np.testing.assert_array_equal(got.n_steps.numpy(), np.asarray(ref.n_steps))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))
    assert not got.ok[6] and got.n_steps[6] == 0 and got.n_steps[:6].min() >= 1
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(ref.poses), atol=ATOL)
    np.testing.assert_allclose(got.cmds.numpy(), np.asarray(ref.cmds), atol=ATOL)
    assert got.poses.shape == (b, 31, 3) and got.cmds.shape == (b, 30, 3)


def test_lookahead_tie_breaking():
    """Distance ties: the LARGEST index among the minimisers (the backward
    scan updates only on a strictly smaller distance); within the lookahead
    distance, the largest index wins too; no valid pose -> index P-1."""
    px = np.array([[-1.0, 1.0, 1.0, -1.0, 9.0], [0.0, 1.0, 2.0, 3.0, 4.0], [5.0, 6.0, 7.0, 8.0, 9.0]])
    py = np.array([[1.0, 1.0, -1.0, -1.0, 9.0], [0.0, 0.0, 0.0, 0.0, 0.0], [1.0, 1.0, 1.0, 1.0, 2.0]])
    valid = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 1, 1], [0, 0, 0, 0, 0]], bool)
    rx = np.zeros(3)
    ry = np.zeros(3)
    for look in (0.5, 2.5):
        ref = jax.vmap(lambda a, b_, v, x, y: jtraj._lookahead_point(a, b_, v, x, y, look))(
            jnp.asarray(px), jnp.asarray(py), jnp.asarray(valid), jnp.asarray(rx), jnp.asarray(ry)
        )
        got = ttraj._lookahead_point(_t(px), _t(py), _t(valid), _t(rx), _t(ry), look)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    got = ttraj._lookahead_point(_t(px), _t(py), _t(valid), _t(rx), _t(ry), 0.5)
    assert (got[0][0], got[1][0]) == (-1.0, -1.0)  # 4-way tie at sqrt(2): index 3
    assert (got[0][2], got[1][2]) == (9.0, 2.0)  # nothing valid: index P-1


def test_fov_filter():
    """People behind the robot or outside the costmap become invalid; an
    agent exactly on the cone boundary stays out (< is strict)."""
    jcfg = jcfg_mod.benchmark_social_config()
    tcfg = tcfg_mod.benchmark_social_config()
    sc = jax_make_scenario(jcfg, seed=1, n_valid_people=3, dtype=np.float64)
    rng = np.random.default_rng(3)
    st = np.tile(np.asarray(sc.people.state)[None], (5, 1, 1))
    st[:, :, 0:2] = rng.uniform(-2.5, 4.0, (5, 3, 2))
    st[:, :, 3] = 0.0
    st[0, 0, 0:2] = (-1.5, 0.0)  # behind
    st[0, 1, 0:2] = (50.0, 0.0)  # outside the costmap
    st[0, 2, 0:2] = (1.0, 0.3)  # in view
    st[1, 0, 0:2] = (1.0, 1.0)  # exactly on the pi/4 boundary
    st[2, :, 3] = -1.0  # all invalid
    pose = np.zeros((5, 3))
    pose[3] = (0.5, -0.2, 0.9)
    pose[4] = (1.0, 0.4, -2.0)
    ref = jax.vmap(
        lambda s, r: jctl.fov_filter(jcfg, JT.AgentsState(s), r, sc.costmap).state
    )(jnp.asarray(st), jnp.asarray(pose))
    cm = T.Costmap(
        _t(np.tile(sc.costmap.data[None], (5, 1, 1))),
        _t(np.tile(sc.costmap.origin[None], (5, 1))),
        _t(np.full((5,), float(sc.costmap.resolution))),
    )
    got = tctl.fov_filter(tcfg, T.AgentsState(_t(st)), _t(pose), cm).state
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got[0, :, 3].tolist() == [-1.0, -1.0, 0.0] and got[1, 0, 3] == -1.0


@pytest.mark.parametrize("vals", [[-7.0, -np.pi, -1.0, 0.0, 3.0, np.pi, 9.5]])
def test_angles(vals):
    from nav2_social_mpc_controller_tpu.utils import angles as jang

    a = np.asarray(vals)
    np.testing.assert_allclose(tang.wrap_to_pi(_t(a)).numpy(), np.asarray(jang.wrap_to_pi(a)), atol=ATOL)
    np.testing.assert_allclose(tang.wrap_atan2(_t(a)).numpy(), np.asarray(jang.wrap_atan2(a)), atol=ATOL)
    np.testing.assert_allclose(
        tang.shortest_angular_distance(_t(a), _t(a[::-1].copy())).numpy(),
        np.asarray(jang.shortest_angular_distance(a, a[::-1])), atol=ATOL,
    )


@pytest.mark.parametrize("with_prev", [False, True], ids=["first_tick", "warm"])
@pytest.mark.parametrize("name", ["benchmark_obstacle_only_config", "benchmark_stress_h36_config"])
def test_format_to_optimize(name, with_prev):
    """The optimization rows with and without a previous solution in the
    carry (the 0.5/0.5 command blend), incl. a near-goal short trajectory
    and a saturated one (the maxsize-1 truncation quirk)."""
    jcfg = getattr(jcfg_mod, name)()
    tcfg = getattr(tcfg_mod, name)()
    jdims = jopt.ProblemDims.from_config(jcfg)
    tdims = topt.ProblemDims.from_config(tcfg)
    assert jdims == jopt.ProblemDims(**tdims.__dict__)
    rng = np.random.default_rng(11)
    b, ms = 5, jcfg.trajectorizer.max_steps
    poses = rng.normal(size=(b, ms + 1, 3))
    cmds = rng.normal(size=(b, ms, 3))
    n_steps = np.array([ms, ms - 1, 7, 1, ms - 2], np.int32)
    speed = rng.uniform(0, 0.3, (b, 2))
    prev_n = (np.array([jdims.maxsize, 12, 3, 30, 29], np.int32) if with_prev else np.zeros(b, np.int32))
    prev_n = np.minimum(prev_n, jdims.maxsize).astype(np.int32)
    carry = JT.ControllerCarry(
        prev_path=rng.normal(size=(b, jdims.maxsize, 3)),
        prev_cmds=rng.normal(size=(b, jdims.maxsize, 2)),
        prev_n=prev_n,
        plan_start=np.zeros(b, np.int32),
    )
    ref_rows, ref_n = jax.vmap(
        lambda p, c, n, s, cr: jopt.format_to_optimize(jcfg, jdims, p, c, n, s, cr)
    )(jnp.asarray(poses), jnp.asarray(cmds), jnp.asarray(n_steps), jnp.asarray(speed), carry)
    rows, n_rows = topt.format_to_optimize(
        tcfg, tdims, _t(poses), _t(cmds), _t(n_steps), _t(speed),
        T.carry_from_numpy(carry, device="cpu", dtype=torch.float64),
    )
    np.testing.assert_array_equal(n_rows.numpy(), np.asarray(ref_n))
    np.testing.assert_allclose(rows.numpy(), np.asarray(ref_rows), atol=ATOL)
    assert n_rows.dtype == torch.int32 and n_rows[0] == jdims.maxsize - 1
