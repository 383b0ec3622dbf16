"""The SFM people projection of the PyTorch port (kernel K5's plain version,
models/sfm.py) against the JAX package's ``project_people`` scan and, in
interpret mode, its fused Pallas scan kernel, on identical NumPy inputs.

Tolerances: f64 against the reference scan 1e-9 (the same IEEE operations in
the same order; libm's atan2/exp/sin/cos may differ in the last place). f32
against the Pallas kernel 2e-4, the tolerance the JAX package's own test of
that kernel uses (polynomial atan2, round()-based wrap). The t column —
which agents are valid at which step — is always exact."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_common import config_by_name

from nav2_social_mpc_controller_tpu.controller import optimize as jopt
from nav2_social_mpc_controller_tpu.controller.trajectorizer import trajectorize as jax_trajectorize
from nav2_social_mpc_controller_tpu.core import config as jcfg_mod
from nav2_social_mpc_controller_tpu.core import validate as jval
from nav2_social_mpc_controller_tpu.core.types import ControllerCarry as JaxCarry
from nav2_social_mpc_controller_tpu.models import sfm as jsfm
from nav2_social_mpc_controller_tpu.models.sfm_pallas import project_people_pallas
from nav2_social_mpc_controller_tpu.utils.scenarios import make_scenario as jax_make_scenario
from nav2_social_mpc_controller_tpu.world.grid import crop_esdf_obstacle_window
from nav2_social_mpc_controller_tpu_torch import _build
from nav2_social_mpc_controller_tpu_torch.core import config as tcfg_mod
from nav2_social_mpc_controller_tpu_torch.core import validate as tval
from nav2_social_mpc_controller_tpu_torch.models import sfm as tsfm

torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.asarray(x))


@functools.lru_cache(maxsize=None)
def _inputs(name, dtype, n_people, b=5, near_goal=False):
    """(jcfg, NumPy batch): people, robot rows and ESDF straight from the JAX
    package's pipeline. With `near_goal` the later robots start a few poses
    before the end of their plan, so the scan's tail is beyond their rows.
    `name` is a configuration of config_by_name."""
    jcfg = config_by_name(jcfg_mod, name)
    dims = jopt.ProblemDims.from_config(jcfg)
    keys = ("people", "rows", "n_rows", "dist", "idx", "origin", "res", "valid")
    batch = {k: [] for k in keys}
    for seed in range(b):
        sc = jax_make_scenario(jcfg, seed=seed, n_valid_people=n_people, dtype=dtype)
        pose = np.asarray(sc.robot.pose)
        if near_goal and seed >= 2:
            i = int(sc.path.n) - 2 * seed
            pose = np.array([sc.path.points[i, 0], sc.path.points[i, 1], sc.path.yaw[i]], dtype)
        res = jax_trajectorize(jcfg.trajectorizer, sc.path, jnp.asarray(pose))
        carry = JaxCarry(
            prev_path=jnp.zeros((dims.maxsize, 3), dtype),
            prev_cmds=jnp.zeros((dims.maxsize, 2), dtype),
            prev_n=jnp.zeros((), jnp.int32),
        )
        rows, n_rows = jopt.format_to_optimize(
            jcfg, dims, res.poses, res.cmds, res.n_steps, jnp.asarray(sc.robot.speed), carry
        )
        for k, v in zip(keys, (sc.people.state, rows, n_rows, sc.esdf.distances, sc.esdf.indexes,
                               sc.esdf.origin, sc.esdf.resolution, sc.esdf.valid)):
            batch[k].append(np.asarray(v))
    return jcfg, {k: np.stack(v) for k, v in batch.items()}


def _kw(jcfg):
    return dict(
        maxtime=jcfg.trajectorizer.max_time, dt=jcfg.trajectorizer.time_step,
        people_desired_vel=jcfg.people_desired_vel, people_radius=jcfg.people_radius,
        goal_radius=jcfg.goal_radius,
    )


def _jax_scan(jcfg, x, window):
    return np.asarray(jax.vmap(
        lambda p, r, n, d, i, o, rs, v: jsfm._project_people_impl(
            p, r, n, d, i, o, rs, v, esdf_window=window,
            robot_desired_vel=jcfg.robot_sfm_desired_vel, robot_radius=jcfg.robot_sfm_radius,
            **_kw(jcfg))
    )(*(jnp.asarray(x[k]) for k in ("people", "rows", "n_rows", "dist", "idx", "origin", "res",
                                    "valid"))))


def _port(jcfg, x, window, fn=tsfm.project_people):
    return fn(
        _t(x["people"]), _t(x["rows"]), _t(x["n_rows"]), _t(x["idx"]), _t(x["origin"]),
        _t(x["res"]), _t(x["valid"]), esdf_window=window, **_kw(jcfg),
    ).numpy()


@pytest.mark.parametrize(
    "name,n_people,window,near_goal",
    [
        ("benchmark_social_config", 3, 32, False),
        ("benchmark_social_config", 2, 0, False),  # no window: the plain gather
        ("benchmark_social_config", 3, 32, True),  # scan tail beyond the robot's rows
        ("benchmark_omni_6agents_config", 6, 32, False),
        ("benchmark_stress_h36_config", 3, 44, False),
        ("benchmark_obstacle_only_config", 0, 32, False),  # the people-free tick
        ("social_n12", 12, 32, False),  # three sources a lane ... one lane an agent
        ("social_n32", 32, 32, False),  # on the card
    ],
    ids=["social", "no_window", "near_goal", "omni6", "stress36", "no_people", "n12", "n32"],
)
def test_project_people_matches_reference_scan_f64(name, n_people, window, near_goal):
    jcfg, x = _inputs(name, np.float64, n_people, near_goal=near_goal)
    ref = _jax_scan(jcfg, x, window)
    got = _port(jcfg, x, window)
    assert got.shape == ref.shape and got.dtype == np.float64
    np.testing.assert_array_equal(got[..., 3], ref[..., 3])
    np.testing.assert_array_equal(got[:, 0], x["people"])
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)
    if n_people == 0:
        np.testing.assert_array_equal(got, ref)  # padding rows, bit for bit
        assert (got[:, 1:, :, 3] == -1.0).all()
    else:
        assert (got[:, 1, :n_people, 3] > 0).all(), "valid agents must be projected"
    if near_goal:
        n_rows = x["n_rows"]
        assert n_rows.min() < got.shape[1] - 1
        for k, n in enumerate(n_rows):  # steps at and beyond n_rows - 1 are padding
            assert (got[k, max(int(n), 1):, :, 3] == -1.0).all()


def test_project_people_matches_pallas_kernel_f32():
    """float32 against the TPU scan kernel in interpret mode, fed the u16
    obstacle tables its dispatcher crops for it."""
    jcfg, x = _inputs("benchmark_social_config", np.float32, 3)
    # The interpreter unrolls S * N^2 pair forces: two agents over the first
    # 15 steps keep it to seconds and still cover every term of the scan.
    x = dict(x, people=x["people"][:, :2], rows=x["rows"][:, :16],
             n_rows=np.minimum(x["n_rows"], 12))
    window = jcfg.esdf_window_cells
    oxy, scol, srow = jax.vmap(
        lambda idx, p0, o, r: crop_esdf_obstacle_window(idx, p0, o, r, window)
    )(jnp.asarray(x["idx"]), jnp.asarray(x["people"][:, :, 0:2]), jnp.asarray(x["origin"]),
      jnp.asarray(x["res"]))
    ref = np.asarray(project_people_pallas(
        jnp.asarray(x["people"]), jnp.asarray(x["rows"]), jnp.asarray(x["n_rows"]), oxy, scol,
        srow, jnp.asarray(x["origin"]), jnp.asarray(x["res"]), jnp.asarray(x["valid"]),
        x["idx"].shape[-2:], window, params=jsfm.DEFAULT_PARAMS, interpret=True, **_kw(jcfg),
    ))
    got = _port(jcfg, x, window)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got[..., 3], ref[..., 3])
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_invalid_esdf_projects_nobody():
    jcfg, x = _inputs("benchmark_social_config", np.float64, 2)
    x = dict(x, valid=np.zeros_like(x["valid"]))
    got = _port(jcfg, x, 32)
    np.testing.assert_array_equal(got, _jax_scan(jcfg, x, 32))
    assert (got[:, 1:, :, 3] == -1.0).all() and (got[:, 1:, :, [0, 1, 2, 4, 5]] == 0.0).all()
    np.testing.assert_array_equal(got[:, 0], x["people"])


def test_wrapper_takes_the_plain_version_on_the_cpu_only():
    """A CPU tensor runs the plain version and launches nothing; the wrapper
    refuses shapes that are not (B, N, 6) / (B, S+1, 6)."""
    jcfg, x = _inputs("benchmark_social_config", np.float32, 3)
    before = dict(_build.launch_counts)
    np.testing.assert_array_equal(
        _port(jcfg, x, 32), _port(jcfg, x, 32, fn=tsfm.project_people_plain)
    )
    assert _build.launch_counts == before and "sfm_scan" in before
    with pytest.raises(ValueError, match="project_people"):
        tsfm.project_people(
            _t(x["people"][0]), _t(x["rows"]), _t(x["n_rows"]), _t(x["idx"]), _t(x["origin"]),
            _t(x["res"]), _t(x["valid"]), **_kw(jcfg),
        )


@pytest.mark.parametrize("h,w,window,want", [(120, 120, 32, 32), (120, 120, 0, 0),
                                             (120, 120, 128, 0), (300, 120, 32, 0)])
def test_lookup_window_follows_the_reference_gate(h, w, window, want):
    assert tsfm.lookup_window(window, h, w) == want


@pytest.mark.parametrize("name", ["benchmark_social_config", "benchmark_stress_h36_config"])
def test_esdf_window_rule(name):
    jcfg = getattr(jcfg_mod, name)()
    cfg = getattr(tcfg_mod, name)()
    for res in (0.05, 0.025, 0.1):
        assert tval.esdf_window_min_cells(cfg, res) == jval.esdf_window_min_cells(jcfg, res)
    tval.check_esdf_window(cfg, 0.05)
    with pytest.raises(ValueError, match="esdf_window_cells"):
        tval.check_esdf_window(cfg, 0.01)


@pytest.mark.parametrize("n,b,want", [
    (3, 4096, (1, 3, 9, 3, 3, 9, 456)),    # social, stress36: 3 force warps of 3 scenarios
    (3, 4101, (1, 3, 9, 3, 3, 9, 456)),    # ragged: the last block holds 6
    (6, 1024, (2, 3, 18, 1, 5, 5, 205)),   # omni6: two sources a lane, 5 force warps
    (6, 4101, (2, 3, 18, 1, 5, 5, 821)),
    (1, 37, (1, 1, 1, 32, 1, 32, 2)),
    (8, 5, (2, 4, 32, 1, 4, 4, 2)),
    (9, 1024, (3, 3, 27, 1, 3, 3, 342)),   # three sources a lane, 3 force warps
    (17, 1024, (17, 1, 17, 1, 1, 1, 1024)),  # one lane an agent, a scenario a block
    (32, 5, (32, 1, 32, 1, 1, 1, 5)),      # the most one warp of force lanes holds
])
def test_scan_geometry(n, b, want):
    """K5's launch geometry (sources per lane, lanes per agent, force lanes
    per scenario, scenarios per force warp, force warps per block, scenarios
    per block, blocks): the fewest sources a lane with which a scenario fits
    one warp; every source has a lane; the agent warp has a lane for every
    agent of its block; every scenario a block."""
    geo = tsfm.scan_geometry(n, b)
    assert tuple(geo) == want
    assert geo.sources_per_lane * geo.lanes_per_agent >= n
    assert geo.lanes_per_scenario * geo.scenarios_per_warp <= 32
    assert n * geo.scenarios_per_block <= 32 < n * (geo.scenarios_per_block + geo.scenarios_per_warp)
    assert geo.scenarios_per_block == geo.force_warps * geo.scenarios_per_warp
    assert geo.blocks * geo.scenarios_per_block >= b > (geo.blocks - 1) * geo.scenarios_per_block
    if geo.sources_per_lane > 1:  # one source fewer a lane would not fit
        assert n * -(-n // (geo.sources_per_lane - 1)) > 32


@pytest.mark.parametrize("n", [0, 33])
def test_scan_geometry_refuses_counts_the_kernel_is_not_built_for(n):
    with pytest.raises(ValueError, match="agents"):
        tsfm.scan_geometry(n, 8)
