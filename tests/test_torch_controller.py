"""The port's single-robot surface against the JAX package: prune_plan,
make_step (a batch of one through the batched step), SocialMPCController
and the host-boundary window validators, on identical NumPy inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nav2_social_mpc_controller_tpu.controller import controller as jctrl
from nav2_social_mpc_controller_tpu.core import config as jconfig
from nav2_social_mpc_controller_tpu.core import validate as jvalidate
from nav2_social_mpc_controller_tpu.core.types import PathInput, RobotState
from nav2_social_mpc_controller_tpu.utils.scenarios import make_scenario as jax_make_scenario
from nav2_social_mpc_controller_tpu_torch.controller import controller as tctrl
from nav2_social_mpc_controller_tpu_torch.core import validate as tvalidate
from nav2_social_mpc_controller_tpu_torch.core.config import config_from_dict
from nav2_social_mpc_controller_tpu_torch.core.types import scenario_from_numpy
from test_torch_common import run_scalar_cpu_child


def _port_cfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


def _long_straight_plan(cfg, length_m=12.0, n=None):
    """tests/test_host_controller.py's 12 m plan."""
    n = n or cfg.max_path_points
    pts = np.zeros((cfg.max_path_points, 2), np.float32)
    pts[:, 0] = np.linspace(0.0, length_m, cfg.max_path_points)
    return PathInput(points=pts, yaw=np.zeros(cfg.max_path_points, np.float32), n=np.int32(n))


@pytest.mark.parametrize("start", [0, -3, 1, 10, 38, 200])
def test_prune_plan_matches_jax(start):
    plan = _long_straight_plan(jconfig.benchmark_social_config(), n=40)
    want = jctrl.prune_plan(plan, start)
    got = tctrl.prune_plan(plan, start)
    if start <= 0:
        assert got is plan and want is plan
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("shape,dim", [((1, 29), 1), ((5, 40), 1), ((3, 4, 50), -1), ((2, 7, 3), 1)])
def test_prefix_sum_adds_strictly_left_to_right(shape, dim):
    """models.motion.prefix_sum (the tick path's prefix sums, batch-width
    independent on the card) is the sequential sum of every row (float64:
    the CPU's float32 cumsum accumulates in double)."""
    from nav2_social_mpc_controller_tpu_torch.models.motion import prefix_sum

    x = torch.randn(shape, generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    xs = x.movedim(dim, 0)
    acc, want = torch.zeros_like(xs[0]), []
    for row in xs:
        acc = acc + row
        want.append(acc)
    got = prefix_sum(x, dim)
    assert got.shape == x.shape
    assert torch.equal(got, torch.stack(want).movedim(0, dim))


def test_make_carry_unbatched_and_batched_forms():
    cfg = _port_cfg(jconfig.benchmark_social_config())
    one = tctrl.make_carry(cfg, device="cpu")
    many = tctrl.make_carry(cfg, 5, "cpu", torch.float64)
    jc = jctrl.make_carry(jconfig.benchmark_social_config())
    for a, b, j in zip(one, many, jc):
        assert tuple(a.shape) == tuple(np.shape(j))
        assert tuple(b.shape) == (5,) + tuple(np.shape(j))
    assert one.prev_n.dtype == torch.int32 and many.prev_path.dtype == torch.float64


def _scripted_pose(sc, t, stride=4):
    i = min(t * stride, int(sc.path.n) - 1)
    return np.array([sc.path.points[i, 0], sc.path.points[i, 1], sc.path.yaw[i]], np.float64)


@pytest.mark.parametrize("name,seed,people", [("obstacle", 1, 0), ("social", 0, 3)])
def test_make_step_f64_matches_jax_make_step(name, seed, people):
    """Three ticks, the carry fed back, the robot riding its plan: the
    port's make_step in float64 against the JAX package's."""
    jcfg = {"obstacle": jconfig.benchmark_obstacle_only_config,
            "social": jconfig.benchmark_social_config}[name]()
    sc = jax_make_scenario(jcfg, seed=seed, n_valid_people=people, dtype=np.float64)
    jstep = jctrl.make_step(jcfg)
    tstep = tctrl.make_step(_port_cfg(jcfg), device="cpu", dtype=torch.float64)
    jcarry = jctrl.make_carry(jcfg, dtype=jnp.float64)
    tcarry = tctrl.make_carry(_port_cfg(jcfg), device="cpu", dtype=torch.float64)
    for t in range(3):
        sc_t = sc._replace(robot=sc.robot._replace(pose=_scripted_pose(sc, t)))
        jcmd, jaux, jcarry = jstep(sc_t, jcarry)
        tcmd, taux, tcarry = tstep(sc_t, tcarry)
        assert tcmd.linear_x.shape == () and taux.local_path.ndim == 2
        for field in ("linear_x", "linear_y", "angular_z"):
            np.testing.assert_allclose(
                float(getattr(tcmd, field)), float(getattr(jcmd, field)), atol=1e-6, rtol=0)
        assert int(taux.status) == int(jaux.status)
        assert int(taux.solve.iterations) == int(jaux.solve.iterations)
        assert int(taux.solve.termination) == int(jaux.solve.termination)
        assert int(taux.plan_start_index) == int(jaux.plan_start_index)
        assert int(tcarry.prev_n) == int(jcarry.prev_n)
        np.testing.assert_allclose(tcarry.prev_cmds.numpy(), np.asarray(jcarry.prev_cmds),
                                   atol=1e-6, rtol=0)


def test_make_step_refuses_a_batch():
    jcfg = jconfig.benchmark_obstacle_only_config()
    cfg = _port_cfg(jcfg)
    sc = jax_make_scenario(jcfg, seed=0, n_valid_people=0)
    batched = jax.tree.map(lambda x: np.asarray(x)[None], sc)
    step = tctrl.make_step(cfg, device="cpu")
    with pytest.raises(ValueError, match="unbatched"):
        step(batched, tctrl.make_carry(cfg, device="cpu"))
    with pytest.raises(ValueError, match="unbatched"):
        step(sc, tctrl.make_carry(cfg, 1, device="cpu"))


# The bit-for-bit lane check runs in a child process on ATen's scalar CPU
# kernels (test_torch_common.run_scalar_cpu_child says why).
_LANE_CHILD = r"""
import json, sys
import numpy as np, torch
from nav2_social_mpc_controller_tpu_torch.controller.controller import (
    make_carry, make_step, make_step_batch)
from nav2_social_mpc_controller_tpu_torch.core.config import benchmark_social_config
from nav2_social_mpc_controller_tpu_torch.core.types import scenario_from_numpy
from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario_batch

assert torch.backends.cpu.get_cpu_capability() == "DEFAULT"
cfg = benchmark_social_config()
f64 = torch.float64
sc_np = make_scenario_batch(cfg, 3, base_seed=0, n_valid_people=3, dtype=np.float64)
batch = make_step_batch(cfg, device="cpu", dtype=f64)
one = make_step(cfg, device="cpu", dtype=f64)
sc = scenario_from_numpy(sc_np, device="cpu", dtype=f64)
carry = make_carry(cfg, 3, device="cpu", dtype=f64)
carries = [make_carry(cfg, device="cpu", dtype=f64) for _ in range(3)]
bad = []
for t in range(2):
    pose = sc.robot.pose + 0.05 * t
    cmd, aux, carry = batch(sc._replace(robot=sc.robot._replace(pose=pose)), carry)
    for i in range(3):
        lane = type(sc_np)(*(type(x)(*(np.asarray(l)[i] for l in x)) for x in sc_np))
        lane = lane._replace(robot=lane.robot._replace(pose=pose[i].numpy()))
        c1, a1, carries[i] = one(lane, carries[i])
        pairs = [(cmd.linear_x[i], c1.linear_x), (cmd.angular_z[i], c1.angular_z),
                 (aux.status[i], a1.status), (aux.solve.iterations[i], a1.solve.iterations),
                 (aux.solve.termination[i], a1.solve.termination),
                 (aux.solve.final_cost[i], a1.solve.final_cost), (aux.cmds[i], a1.cmds),
                 (aux.people_proj[i], a1.people_proj)]
        pairs += [(x[i], y) for x, y in zip(carry, carries[i])]
        bad += [f"tick {t} lane {i} pair {k}" for k, (x, y) in enumerate(pairs)
                if not torch.equal(x, y)]
print(json.dumps({"bad": bad}))
"""


def test_make_step_is_the_lane_of_make_step_batch_bit_for_bit_f64():
    assert run_scalar_cpu_child(_LANE_CHILD)["bad"] == []


def test_controller_plan_pruning_cursors_match_jax(monkeypatch):
    """tests/test_host_controller.py's protocol — 6 ticks along a 12 m
    straight plan, the robot teleported 1.2 m a tick — through both
    controllers: equal cursors, monotone and advancing; set_plan resets the
    cursor and keeps the warm start; the windows are checked once."""
    jcfg = jconfig.benchmark_social_config()
    cfg = _port_cfg(jcfg)
    checks = []
    real = tctrl.validate_scenario_windows
    monkeypatch.setattr(tctrl, "validate_scenario_windows",
                        lambda *a: (checks.append(a), real(*a))[1])
    ctrls = {"jax": jctrl.SocialMPCController(jcfg),
             "torch": tctrl.SocialMPCController(cfg, device="cpu")}
    sc = jax_make_scenario(jcfg, seed=0, n_valid_people=0)
    plan = _long_straight_plan(jcfg)
    starts = {}
    for side, ctrl in ctrls.items():
        ctrl.activate()
        ctrl.set_plan(plan)
        ctrl.set_speed_limit(0.3, False)  # a no-op on both sides
        pose = np.array([0.0, 0.0, 0.0], np.float32)
        starts[side] = [0]
        for _ in range(6):
            sc_t = sc._replace(robot=RobotState(pose=pose, speed=np.array([0.3, 0.0], np.float32)))
            cmd, aux = ctrl.compute_velocity_commands(sc_t)
            assert np.isfinite(float(cmd.linear_x))
            starts[side].append(int(aux.plan_start_index))
            pose = pose + np.array([1.2, 0.0, 0.0], np.float32)
    assert starts["torch"] == starts["jax"], starts
    s = starts["torch"]
    assert all(b >= a for a, b in zip(s, s[1:])) and s[-1] > s[1], s
    assert len(checks) == 1, "the windows must be checked on the first tick only"

    port = ctrls["torch"]
    prev_n = int(port._carry.prev_n)
    port.set_plan(plan)
    assert int(port._carry.plan_start) == 0 and int(port._carry.prev_n) == prev_n > 0
    port.deactivate()
    port.cleanup()
    assert port._plan is None and int(port._carry.prev_n) == 0


def _window_cfgs():
    base = jconfig.benchmark_social_config()
    return {
        "benchmark": base,
        "small_obstacle": dataclasses.replace(
            base, optimizer=dataclasses.replace(base.optimizer, obstacle_window_cells=10)),
        "small_esdf": dataclasses.replace(base, esdf_window_cells=4),
        "disabled": dataclasses.replace(
            base, esdf_window_cells=0,
            optimizer=dataclasses.replace(base.optimizer, obstacle_window_cells=0)),
    }


@pytest.mark.parametrize("which", ["benchmark", "small_obstacle", "small_esdf", "disabled"])
@pytest.mark.parametrize("res", [(0.05, 0.05), (0.02, 0.05), (0.05, 0.01), (0.2, 0.2), (0.0, -1.0)])
def test_validate_scenario_windows_raises_where_jax_raises(which, res):
    jcfg = _window_cfgs()[which]
    cfg = _port_cfg(jcfg)

    def outcome(fn, *args):
        try:
            fn(*args)
            return None
        except ValueError as e:
            return str(e).split("=")[0]  # which window

    want = outcome(jvalidate.validate_scenario_windows, jcfg, *res)
    assert outcome(tvalidate.validate_scenario_windows, cfg, *res) == want
    assert outcome(tvalidate.validate_scenario_windows, cfg,
                   torch.tensor(res[0]), np.float32(res[1])) == want


@pytest.mark.parametrize("which", ["benchmark", "small_obstacle", "small_esdf"])
def test_validate_batch_windows_takes_the_smallest_resolution(which):
    jcfg = _window_cfgs()[which]
    cfg = _port_cfg(jcfg)
    one = jax_make_scenario(jcfg if which == "benchmark" else jconfig.benchmark_social_config(),
                            seed=0, n_valid_people=1)
    sc = jax.tree.map(lambda *x: np.stack(x), one, one)
    fine = sc._replace(
        costmap=sc.costmap._replace(resolution=np.array([0.05, 0.02], np.float32)),
        esdf=sc.esdf._replace(resolution=np.array([0.05, 0.01], np.float32)))
    for batch in (sc, fine):
        try:
            jvalidate.validate_batch_windows(jcfg, batch)
            raised = False
        except ValueError:
            raised = True
        for leaves in (batch, scenario_from_numpy(batch, device="cpu")):
            if raised:
                with pytest.raises(ValueError):
                    tvalidate.validate_batch_windows(cfg, leaves)
            else:
                tvalidate.validate_batch_windows(cfg, leaves)


def test_window_validator_checks_each_buffer_once(monkeypatch):
    cfg = _port_cfg(jconfig.benchmark_social_config())
    calls = []
    real = tvalidate.validate_batch_windows
    monkeypatch.setattr(tvalidate, "validate_batch_windows",
                        lambda c, s: (calls.append(1), real(c, s))[1])
    check = tvalidate.make_window_validator(cfg)
    sc = scenario_from_numpy(
        jax_make_scenario(jconfig.benchmark_social_config(), seed=0, n_valid_people=0),
        device="cpu")
    check(sc)
    check(sc._replace(robot=sc.robot._replace(pose=sc.robot.pose + 1.0)))
    assert len(calls) == 1
    check(sc._replace(esdf=sc.esdf._replace(resolution=sc.esdf.resolution.clone())))
    assert len(calls) == 2
    bad = sc._replace(costmap=sc.costmap._replace(resolution=sc.costmap.resolution * 0.1))
    with pytest.raises(ValueError, match="obstacle_window_cells"):
        check(bad)


def test_make_step_batch_validate_flag():
    """validate=False skips the window check (for callers that checked at
    construction); the default keeps it."""
    jcfg = _window_cfgs()["small_obstacle"]
    cfg = _port_cfg(jcfg)
    one = jax_make_scenario(jconfig.benchmark_social_config(), seed=0, n_valid_people=0)
    sc = scenario_from_numpy(jax.tree.map(lambda *x: np.stack(x), one, one), device="cpu")
    carry = tctrl.make_carry(cfg, 2, device="cpu")
    for make in (tctrl.make_step_batch,
                 lambda c, **kw: tctrl.make_step_batch_compacted(c, 0.5, **kw)):
        with pytest.raises(ValueError, match="obstacle_window_cells"):
            make(cfg, device="cpu")(sc, carry)
        cmd, _, _ = make(cfg, device="cpu", validate=False)(sc, carry)
        assert cmd.linear_x.shape == (2,)
