"""Shared protocols of the PyTorch port's parity tests; this module holds no
test of its own.

Whole step (``tests/test_torch_step*.py``): both packages run the same NumPy
scenarios for a few ticks with the carry fed back, and the port's results are
held against the JAX package's. Fused evaluation
(``tests/test_torch_fused_*.py``): one batch of LM problems straight from the
JAX package's pipeline, evaluated by both."""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nav2_social_mpc_controller_tpu.controller.controller import (
    make_carry as jax_make_carry,
    make_step_batch as jax_make_step_batch,
)
from nav2_social_mpc_controller_tpu.controller import optimize as jopt
from nav2_social_mpc_controller_tpu.controller.trajectorizer import trajectorize as jax_trajectorize
from nav2_social_mpc_controller_tpu.core import config as jcfg_mod
from nav2_social_mpc_controller_tpu.core.types import ControllerCarry as JaxCarry
from nav2_social_mpc_controller_tpu.models.sfm import project_people as jax_project_people
from nav2_social_mpc_controller_tpu.ops import fused_iter as jfused
from nav2_social_mpc_controller_tpu.utils.scenarios import (
    make_scenario as jax_make_scenario,
    stack_scenarios as jax_stack_scenarios,
)
from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry, make_step_batch
from nav2_social_mpc_controller_tpu_torch.core import types as T
from nav2_social_mpc_controller_tpu_torch.controller import optimize as topt
from nav2_social_mpc_controller_tpu_torch.core import config as tcfg_mod
from nav2_social_mpc_controller_tpu_torch.core.config import config_from_dict
from nav2_social_mpc_controller_tpu_torch.ops import fused_iter as tfused


# Configurations beyond the named ones of core/config.py, by name: the shapes
# the card takes since the kernels run at every NB (D = 2 NB), templated
# from 1 to 6 and general above, and every agent count, templated from 1 to
# 32 and general above (crowds). SocialMPCConfig (the reference's own
# defaults: horizon 5, block 5) is NB = 1.
CONFIG_CHANGES = {
    # horizon 7, block 4: NB = 2 with a partial last block and no
    # velocity-feasibility row (n_vf uses floor division)
    "social_h7_bl4": ("benchmark_social_config",
                      {"optimizer": {"control_horizon": 7, "parameter_block_length": 4}}),
    "social_n12": ("benchmark_social_config", {"n_agents": 12}),  # NB = 3, N = 12
    "social_n32": ("benchmark_social_config", {"n_agents": 32}),
    # a crowd: K5's general form (N > 32)
    "social_n33": ("benchmark_social_config", {"n_agents": 33}),
    "social_n64": ("benchmark_social_config", {"n_agents": 64}),
    # finer blocks and a longer horizon than the benchmark's: the kernels'
    # general forms (NB > 6). Horizon 18 in blocks of 2 (NB = 9, D = 18) and
    # of 1 (NB = 18, D = 36); the H = 36 stress horizon in blocks of 3
    # (NB = 12, D = 24, S = 39).
    "social_bl2": ("benchmark_social_config", {"optimizer": {"parameter_block_length": 2}}),
    "social_bl1": ("benchmark_social_config", {"optimizer": {"parameter_block_length": 1}}),
    "stress36_bl3": ("benchmark_stress_h36_config",
                     {"optimizer": {"parameter_block_length": 3}}),
}


def config_by_name(mod, name):
    """mod's (the JAX package's or the port's core.config) configuration
    `name`: a function of mod, or an entry of CONFIG_CHANGES."""
    if name not in CONFIG_CHANGES:
        return getattr(mod, name)()
    base, changes = CONFIG_CHANGES[name]
    cfg = getattr(mod, base)()
    opt = dataclasses.replace(cfg.optimizer, **changes.get("optimizer", {}))
    return dataclasses.replace(cfg, optimizer=opt,
                               **{k: v for k, v in changes.items() if k != "optimizer"})


def scripted_poses(sc, n_ticks, stride=4):
    """(n_ticks, B, 3) robot poses riding each plan: tick t sits on plan
    point t*stride with the local path yaw (tests/test_parity_step.py)."""
    pts = np.asarray(sc.path.points)
    yaw = np.asarray(sc.path.yaw)
    n = np.asarray(sc.path.n)
    out = []
    for t in range(n_ticks):
        i = np.minimum(t * stride, n - 1)
        b = np.arange(len(n))
        out.append(np.concatenate([pts[b, i], yaw[b, i, None]], axis=1))
    return out


def run_both(jcfg, people, n_ticks, np_dtype, jstep=None, keep_trace=False, make_tstep=make_step_batch):
    """Run both packages over len(people) scenarios (seed k with people[k]
    valid people) x n_ticks ticks with the carry fed back; returns the
    per-tick NumPy results of each side as ((jcmd, jaux, jcarry), (tcmd,
    taux, tcarry)). `jstep` lets a module share one compiled JAX step;
    `keep_trace` keeps the JAX side's aux.lm_trace; `make_tstep` builds the
    port's step (make_step_batch's signature)."""
    n_seeds = len(people)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    sc_np = jax_stack_scenarios(
        [jax_make_scenario(jcfg, seed=s, n_valid_people=p, dtype=np_dtype) for s, p in enumerate(people)]
    )
    poses = scripted_poses(sc_np, n_ticks)
    tdtype = torch.float64 if np_dtype == np.float64 else torch.float32

    jstep = jstep or jax_make_step_batch(jcfg)
    jcarry = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (n_seeds,) + x.shape),
        jax_make_carry(jcfg, dtype=jnp.float64 if np_dtype == np.float64 else jnp.float32),
    )
    tstep = make_tstep(cfg, device="cpu", dtype=tdtype)
    tcarry = make_carry(cfg, n_seeds, device="cpu", dtype=tdtype)

    out = []
    for pose in poses:
        sc_t = sc_np._replace(robot=sc_np.robot._replace(pose=pose.astype(np_dtype)))
        jcmd, jaux, jcarry = jstep(sc_t, jcarry)
        tsc = T.scenario_from_numpy(sc_t, device="cpu", dtype=tdtype)
        tcmd, taux, tcarry = tstep(tsc, tcarry)
        out.append(
            (
                jax.tree.map(
                    np.asarray, (jcmd, jaux if keep_trace else jaux._replace(lm_trace=None), jcarry)),
                T.to_numpy((tcmd, taux, tcarry)),
            )
        )
    return out


def assert_step_parity_f64(jax_side, torch_side, tick, path_atol=1e-6):
    """f64 on the CPU: commands and paths within 1e-6; status, plan cursor,
    LM iteration counts, termination codes and the carry equal; the people
    projection within 1e-9 with its validity column equal. `path_atol`: the
    paths' tolerance, for a horizon long enough that the commands' 1e-6
    integrates to more."""
    (jcmd, jaux, jcarry), (tcmd, taux, tcarry) = jax_side, torch_side
    np.testing.assert_allclose(tcmd.linear_x, jcmd.linear_x, atol=1e-6)
    np.testing.assert_allclose(tcmd.angular_z, jcmd.angular_z, atol=1e-6)
    np.testing.assert_array_equal(tcmd.linear_y, 0.0)
    np.testing.assert_array_equal(taux.status, jaux.status)
    np.testing.assert_array_equal(taux.status, T.STATUS_OK)
    np.testing.assert_array_equal(taux.plan_start_index, jaux.plan_start_index)
    np.testing.assert_array_equal(taux.solve.iterations, jaux.solve.iterations)
    np.testing.assert_array_equal(taux.solve.termination, jaux.solve.termination)
    np.testing.assert_array_equal(taux.solve.usable, jaux.solve.usable)
    np.testing.assert_allclose(taux.solve.initial_cost, jaux.solve.initial_cost, rtol=1e-9)
    np.testing.assert_allclose(taux.solve.final_cost, jaux.solve.final_cost, rtol=1e-6)
    np.testing.assert_allclose(taux.local_path, jaux.local_path, atol=path_atol)
    np.testing.assert_allclose(taux.ref_path, jaux.ref_path, atol=1e-9)
    np.testing.assert_allclose(taux.cmds, jaux.cmds, atol=1e-6)
    np.testing.assert_array_equal(taux.people_proj[..., 3], jaux.people_proj[..., 3])
    np.testing.assert_allclose(taux.people_proj, jaux.people_proj, atol=1e-9)
    np.testing.assert_allclose(tcarry.prev_path, jcarry.prev_path, atol=path_atol)
    np.testing.assert_allclose(tcarry.prev_cmds, jcarry.prev_cmds, atol=1e-6)
    np.testing.assert_array_equal(tcarry.prev_n, jcarry.prev_n)
    np.testing.assert_array_equal(tcarry.plan_start, jcarry.plan_start)
    if tick > 0:
        assert (tcarry.plan_start > 0).all(), "the plan cursor must advance"


def assert_trace_parity_f64(jax_side, torch_side):
    """f64 on the CPU, the debug trace (aux.lm_trace of both sides): rows
    within rtol 1e-6 (atol 1e-9 of the lane's initial cost, for the changes
    near convergence that are differences of nearly equal costs), the
    accept decisions equal, column 0 the initial cost, rows beyond a lane's
    iteration count zero, every lane iterated and accepted a step."""
    jtrace, trace = jax_side[1].lm_trace, torch_side[1].lm_trace
    iters = torch_side[1].solve.iterations
    assert trace.cost.shape == jtrace.cost.shape and trace.accepted.dtype == np.bool_
    np.testing.assert_array_equal(trace.accepted, jtrace.accepted)
    np.testing.assert_array_equal(trace.cost[:, 0], torch_side[1].solve.initial_cost)
    scale = torch_side[1].solve.initial_cost[:, None]
    for name in ("cost", "cost_change"):
        np.testing.assert_allclose(
            getattr(trace, name) / scale, getattr(jtrace, name) / scale, rtol=1e-6, atol=1e-9,
            err_msg=name)
    for name in ("grad_max", "step_norm", "tr_radius"):
        np.testing.assert_allclose(
            getattr(trace, name), getattr(jtrace, name), rtol=1e-6, atol=1e-9, err_msg=name)
    big = np.abs(jtrace.cost_change) > 1e-6 * scale  # rho of a tiny change is noise over noise
    np.testing.assert_allclose(trace.tr_ratio[big], jtrace.tr_ratio[big], rtol=1e-5)
    beyond = np.arange(trace.cost.shape[1])[None, :] >= iters[:, None]
    for buf in trace:
        assert not buf[beyond].any()
    assert (iters > 0).all() and trace.accepted.any(axis=1).all()


def people_in_view(torch_side):
    """(B,) bool: scenarios whose FOV-filtered people (projection row 0)
    keep a valid person."""
    return (torch_side[1].people_proj[:, 0, :, 3] != -1.0).any(axis=1)


def _t(x):
    return torch.as_tensor(np.asarray(x))


@functools.lru_cache(maxsize=None)
def fused_problems(name, dtype, near_goal=True, people=()):
    """(jcfg, jdims, NumPy batch) of problems straight from the JAX package's
    pipeline; with `near_goal` some robots start a few poses before the end
    of the plan, so n_rows is small and h_dyn/bl_dyn shrink, and the others
    run the full horizon. `people` gives the number of valid people per seed
    (none when empty): their SFM projection is the JAX package's."""
    jcfg = config_by_name(jcfg_mod, name)
    jdims = jopt.ProblemDims.from_config(jcfg)
    keys = ("u", "rows", "n_rows", "proj", "present", "cmd", "cmo", "cmr")
    # Each JAX stage compiled once for the five seeds (same shapes).
    trajectorize = jax.jit(functools.partial(jax_trajectorize, jcfg.trajectorizer))
    format_rows = jax.jit(functools.partial(jopt.format_to_optimize, jcfg, jdims))
    project = jax.jit(functools.partial(
        jax_project_people, maxtime=jcfg.trajectorizer.max_time, dt=jcfg.trajectorizer.time_step,
        esdf_window=jcfg.esdf_window_cells))
    batch = {k: [] for k in keys}
    for seed in range(5):
        n_people = people[seed] if people else 0
        sc = jax_make_scenario(jcfg, seed=seed, n_valid_people=n_people, dtype=dtype)
        pose = np.asarray(sc.robot.pose)
        if near_goal and seed >= 2:
            i = int(sc.path.n) - seed  # 2..4 poses before the goal
            pose = np.array([sc.path.points[i, 0], sc.path.points[i, 1], sc.path.yaw[i]], dtype)
        res = trajectorize(sc.path, jnp.asarray(pose))
        carry = JaxCarry(
            prev_path=jnp.zeros((jdims.maxsize, 3), dtype),
            prev_cmds=jnp.zeros((jdims.maxsize, 2), dtype),
            prev_n=jnp.zeros((), jnp.int32),
        )
        rows, n_rows = format_rows(
            res.poses, res.cmds, res.n_steps, jnp.asarray(sc.robot.speed), carry
        )
        proj = np.asarray(project(
            jnp.asarray(sc.people.state, dtype), rows, n_rows,
            jnp.asarray(sc.esdf.distances, dtype), jnp.asarray(sc.esdf.indexes),
            jnp.asarray(sc.esdf.origin, dtype), jnp.asarray(sc.esdf.resolution, dtype),
            jnp.asarray(sc.esdf.valid),
        ))
        batch["u"].append(np.clip(np.asarray(rows[: jdims.n_blocks, 4:6]).reshape(-1), -0.6, 0.6))
        batch["rows"].append(np.asarray(rows))
        batch["n_rows"].append(np.asarray(n_rows))
        batch["proj"].append(proj)
        batch["present"].append(np.asarray(n_people > 0))
        batch["cmd"].append(np.asarray(sc.costmap.data, dtype))
        batch["cmo"].append(np.asarray(sc.costmap.origin, dtype))
        batch["cmr"].append(np.asarray(sc.costmap.resolution, dtype))
    return jcfg, jdims, {k: np.stack(v) for k, v in batch.items()}


def fused_value_grad(tcfg, tdims, bt):
    """The port's ValueGrad over a fused_problems batch, on the CPU."""
    return tfused.build_value_grad(
        tcfg, tdims, _t(bt["rows"]), _t(bt["n_rows"]).to(torch.int32), _t(bt["proj"]),
        _t(bt["present"]), T.Costmap(_t(bt["cmd"]), _t(bt["cmo"]), _t(bt["cmr"])),
    )


PEOPLE_BATCHES = {
    "social": ("benchmark_social_config", (3, 3, 3, 3, 3)),
    "omni6": ("benchmark_omni_6agents_config", (6, 6, 5, 6, 6)),
    "stress36": ("benchmark_stress_h36_config", (3, 3, 3, 2, 3)),
    "mixed": ("benchmark_social_config", (3, 0, 2, 0, 1)),
}


def check_value_grad_with_people(batch, dtype, batches=PEOPLE_BATCHES):
    """cost, g, JtJ with valid people, all three people stages on. f64: the
    port's ValueGrad (plain K6, K1, K2) vs the vmapped _ref_value_grad
    (autodiff over the production residual closure) at 1e-9
    scale-normalised. f32: vs the JAX package's fused pipeline with its
    Pallas kernels in interpret mode at 3e-5 scale-normalised, the tolerance
    of tests/test_fused_iter.py. The mixed batch has scenarios without any
    person, whose people stages must contribute exactly nothing. `batches`:
    name -> (config name, valid people per seed)."""
    name, people = batches[batch]
    jcfg, jdims, bt = fused_problems(name, dtype, True, people)
    tcfg = config_by_name(tcfg_mod, name)
    tdims = topt.ProblemDims.from_config(tcfg)
    assert bt["present"].tolist() == [n > 0 for n in people]
    assert (bt["proj"][bt["present"]][:, 1:, :, 3] != -1.0).any()
    rng = np.random.default_rng(1)
    u = (bt["u"] + rng.uniform(-0.05, 0.05, bt["u"].shape)).astype(dtype)
    args = (u, bt["rows"], bt["n_rows"], bt["proj"], bt["present"], bt["cmd"], bt["cmo"], bt["cmr"])
    # The JAX side runs under one jit: the same functions, compiled once
    # instead of dispatched operation by operation.
    if dtype == np.float64:
        ref = jax.jit(jax.vmap(functools.partial(jfused._ref_value_grad, jcfg, jdims)))(
            *map(jnp.asarray, args))
        tol, rtol = 1e-9, 1e-9
    else:
        ref = jax.jit(functools.partial(jfused._fused_batched, jcfg, jdims, interpret=True))(
            *map(jnp.asarray, args))
        tol, rtol = 3e-5, 2e-5
    c_ref, g_ref, jtj_ref = (np.asarray(x) for x in ref)
    cost, g, jtj = (x.numpy() for x in fused_value_grad(tcfg, tdims, bt)(_t(u)))
    assert cost.dtype == dtype and np.isfinite(jtj).all()
    np.testing.assert_allclose(cost, c_ref, rtol=rtol)
    scale_g = np.maximum(np.abs(g_ref).max(axis=1, keepdims=True), 1.0)
    np.testing.assert_allclose(g / scale_g, g_ref / scale_g, atol=tol)
    scale_j = np.maximum(np.abs(jtj_ref).max(axis=(1, 2), keepdims=True), 1.0)
    np.testing.assert_allclose(jtj / scale_j, jtj_ref / scale_j, atol=tol)

    if batch == "mixed":  # switching the people off changes only the scenarios that have some
        off = dict(bt, present=np.zeros_like(bt["present"]))
        cost_off = fused_value_grad(tcfg, tdims, off)(_t(u))[0].numpy()
        np.testing.assert_array_equal(cost_off[~bt["present"]], cost[~bt["present"]])
        assert (cost_off[bt["present"]] <= cost[bt["present"]]).all()
        assert (cost_off[bt["present"]] < cost[bt["present"]]).any()


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_scalar_cpu_child(code):
    """Run `code` in a child Python on ATen's scalar CPU kernels
    (ATEN_CPU_CAPABILITY=default) and return the JSON object of its last
    output line. Bit equality of one scenario's lane across batch widths
    holds on those kernels only: with the vectorised ones, an element that
    falls into a vector's scalar tail takes libm's sin/cos/atan2 instead of
    the SIMD ones, which can differ in the last bit, and which elements of a
    lane fall into the tail depends on the batch width. On the card every
    elementwise kernel computes each element alike (chip_smoke.py holds the
    same property there in float32)."""
    env = dict(os.environ, ATEN_CPU_CAPABILITY="default",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])
