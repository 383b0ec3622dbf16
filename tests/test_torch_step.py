"""The PyTorch port's batched step as a whole on the obstacle-only benchmark
configuration: the port on the CPU (its kernels' plain versions) against the
JAX package's ``make_step_batch`` on identical NumPy inputs; plus the guards
at the port's call boundary. The configurations with people have a file
each (``tests/test_torch_step_{social,omni6,stress36}.py``)."""

import dataclasses
import os
import re

import jax
import numpy as np
import pytest
import torch

from test_torch_common import assert_step_parity_f64, run_both

from nav2_social_mpc_controller_tpu.core.config import (
    benchmark_obstacle_only_config as jax_obstacle_config,
)
from nav2_social_mpc_controller_tpu.utils.scenarios import make_scenario as jax_make_scenario
from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry, make_step_batch
from nav2_social_mpc_controller_tpu_torch.core import types as T
from nav2_social_mpc_controller_tpu_torch.core.config import benchmark_obstacle_only_config

torch.set_num_threads(1)

N_SEEDS = 8
N_TICKS = 3
_CACHE = {}


def _run_both(np_dtype):
    """Both packages over N_SEEDS people-free scenarios x N_TICKS ticks."""
    if np_dtype not in _CACHE:
        _CACHE[np_dtype] = run_both(jax_obstacle_config(), (0,) * N_SEEDS, N_TICKS, np_dtype)
    return _CACHE[np_dtype]


@pytest.mark.parametrize("tick", range(N_TICKS))
def test_step_parity_f64(tick):
    """f64 on the CPU: commands and paths within 1e-6; status, plan cursor,
    LM iteration counts, termination codes and the carry equal. Ticks 2-3
    run with the carry fed back, so the warm-start blend fires."""
    jax_side, torch_side = _run_both(np.float64)[tick]
    assert_step_parity_f64(jax_side, torch_side, tick)
    np.testing.assert_array_equal(torch_side[1].people_proj, jax_side[1].people_proj)


@pytest.mark.parametrize("tick", range(N_TICKS))
def test_step_parity_f32(tick):
    """f32 on the CPU: status and cursor equal; lanes that converged on both
    sides agree within 1e-3 (lanes stopped by the iteration cap chatter at
    float32 and are not gated); no command leaves its bounds."""
    (jcmd, jaux, _), (tcmd, taux, _) = _run_both(np.float32)[tick]
    np.testing.assert_array_equal(taux.status, jaux.status)
    np.testing.assert_array_equal(taux.plan_start_index, jaux.plan_start_index)
    conv = (taux.solve.termination != 0) & (jaux.solve.termination != 0)
    np.testing.assert_allclose(tcmd.linear_x[conv], jcmd.linear_x[conv], atol=1e-3)
    np.testing.assert_allclose(tcmd.angular_z[conv], jcmd.angular_z[conv], atol=1e-3)
    np.testing.assert_allclose(taux.solve.initial_cost, jaux.solve.initial_cost, rtol=1e-4)
    assert (tcmd.linear_x >= 0.0).all() and (tcmd.linear_x <= np.float32(0.6)).all()
    assert (np.abs(tcmd.angular_z) <= np.float32(1.4)).all()


def test_result_does_not_depend_on_when_the_loop_stops():
    """Done lanes are frozen bit for bit, so a tick whose LM loop checks for
    completion every iteration, every 4th, or never gives identical outputs."""
    cfg = benchmark_obstacle_only_config()
    from nav2_social_mpc_controller_tpu_torch.controller import controller as ctl
    from nav2_social_mpc_controller_tpu_torch.controller.optimize import ProblemDims, make_lm_config
    from nav2_social_mpc_controller_tpu_torch.ops.fused_iter import build_value_grad
    from nav2_social_mpc_controller_tpu_torch.solver.lm import lm_solve
    from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario_batch

    sc = T.scenario_from_numpy(make_scenario_batch(cfg, 4, 100), device="cpu")
    carry0 = make_carry(cfg, 4, device="cpu")
    ctx = ctl.step_pre(cfg, sc, carry0)
    prep = ctx.prep
    vg = build_value_grad(cfg, ProblemDims.from_config(cfg), prep.rows, prep.n_rows,
                          prep.people_proj, prep.people_present, prep.costmap)
    outs = []
    for k in (0, 1, 4):
        u, stats = lm_solve(vg, prep.u0, prep.lower, prep.upper, make_lm_config(cfg.optimizer),
                            check_every=k)
        outs.append(T.to_numpy(ctl.step_post(cfg, ctx, carry0, u, stats)))
    # the entry point's own loop is one of them
    outs.append(T.to_numpy(make_step_batch(cfg, device="cpu")(sc, carry0)))
    for other in outs[1:]:
        for a, b in zip(jax.tree.leaves(outs[0]), jax.tree.leaves(other)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "change",
    [
        {"debug_optimizer": True},
        {"warm_start_mode": "previous_solution"},
        {"weights": {"curvature_weight": 1.0}},
        {"weights": {"pure_angle_weight": 1.0}},
    ],
    ids=["debug_optimizer", "previous_solution", "curvature", "pure_angle"],
)
def test_unsupported_config_is_refused(change):
    cfg = benchmark_obstacle_only_config()
    opt = cfg.optimizer
    if "weights" in change:
        opt = dataclasses.replace(opt, weights=dataclasses.replace(opt.weights, **change["weights"]))
    else:
        opt = dataclasses.replace(opt, **change)
    with pytest.raises(NotImplementedError):
        make_step_batch(dataclasses.replace(cfg, optimizer=opt), device="cpu")


def test_too_small_obstacle_window_is_refused():
    cfg = benchmark_obstacle_only_config()
    cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer, obstacle_window_cells=16))
    sc_np = jax_make_scenario(benchmark_obstacle_only_config(), seed=0, n_valid_people=0)
    sc = T.scenario_from_numpy(sc_np, device="cpu")
    with pytest.raises(ValueError, match="obstacle_window_cells"):
        make_step_batch(cfg, device="cpu")(sc, make_carry(cfg, 1, device="cpu"))


def test_cuda_without_a_card_raises():
    """Every entry point defaults to the card and raises where there is
    none; it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    cfg = benchmark_obstacle_only_config()
    with pytest.raises(RuntimeError, match="cuda"):
        make_step_batch(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        make_carry(cfg, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        T.scenario_from_numpy(jax_make_scenario(jax_obstacle_config(), seed=0, n_valid_people=0))


def test_port_imports_no_jax():
    """No file of the port (nor the chip smoke script) imports jax, the JAX
    package or the parity tools, and none reads a mode from the environment."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(root, "nav2_social_mpc_controller_tpu_torch")
    files = [os.path.join(root, "chip_smoke.py")]
    for d, _, names in os.walk(pkg):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = re.compile(
        r"^\s*(import|from)\s+(jax|parity|nav2_social_mpc_controller_tpu)(\.|\s|$)", re.M
    )
    assert len(files) > 20
    for path in files:
        src = open(path).read()
        assert not bad.search(src), path
        assert "os.environ" not in src and "getenv" not in src, path
