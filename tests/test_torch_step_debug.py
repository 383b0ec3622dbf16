"""The debug-trace tick and a latent-critic tick of the PyTorch port as a
whole: the port's batched step on the CPU against the JAX package's
``make_step_batch`` in float64 on identical NumPy inputs, social benchmark
configuration, three ticks with the carry fed back.

debug_optimizer=True runs the general LM iteration (the damped system solved
by kernel K7's plain version) and returns the per-iteration LMTrace; a config
with pure_angle_weight adds the latent rows' term to the port's fused
evaluation (ops/latent.py), where the JAX package differentiates its
residual function."""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from test_torch_common import (
    assert_step_parity_f64,
    assert_trace_parity_f64,
    people_in_view,
    run_both,
)

from nav2_social_mpc_controller_tpu.core.config import benchmark_social_config as jax_social_config
from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry, make_step_batch
from nav2_social_mpc_controller_tpu_torch.core import types as T
from nav2_social_mpc_controller_tpu_torch.core.config import benchmark_social_config
from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario_batch

torch.set_num_threads(1)

N_TICKS = 3
PEOPLE = (3, 0, 2, 3, 1, 3)


def _optimizer(cfg, weights=None, **changes):
    opt = cfg.optimizer
    if weights:
        opt = dataclasses.replace(opt, weights=dataclasses.replace(opt.weights, **weights))
    return dataclasses.replace(cfg, optimizer=dataclasses.replace(opt, **changes))


@functools.lru_cache(maxsize=None)
def _run(kind):
    if kind == "debug":
        jcfg = _optimizer(jax_social_config(), debug_optimizer=True)
    else:
        jcfg = _optimizer(jax_social_config(), weights={"pure_angle_weight": 0.7})
    return run_both(jcfg, PEOPLE, N_TICKS, np.float64, keep_trace=True)


@pytest.mark.parametrize("tick", range(N_TICKS))
def test_debug_step_parity_f64(tick):
    """Commands and paths within 1e-6; status, cursor, LM iteration counts,
    termination codes and the carry equal (test_torch_common); the trace rows
    within rtol 1e-6 (atol 1e-9 of the lane's initial cost, for the changes
    near convergence that are differences of nearly equal costs), the accept
    decisions equal, rows beyond a lane's iteration count zero."""
    jax_side, torch_side = _run("debug")[tick]
    assert_step_parity_f64(jax_side, torch_side, tick)
    t_len = jax_social_config().optimizer.max_iterations
    assert torch_side[1].lm_trace.cost.shape == (len(PEOPLE), t_len)
    assert_trace_parity_f64(jax_side, torch_side)


def test_debug_step_equals_plain_step_bit_for_bit():
    """The general iteration repeats the default iteration's arithmetic
    (solver/lm.py), so the debug tick returns the plain tick's results
    exactly, in float32 as in float64, and the plain tick has no trace."""
    cfg = benchmark_social_config()
    dbg = _optimizer(cfg, debug_optimizer=True)
    for dtype, np_dtype in ((torch.float32, np.float32), (torch.float64, np.float64)):
        sc = T.scenario_from_numpy(
            make_scenario_batch(cfg, 4, 0, n_valid_people=3, dtype=np_dtype), device="cpu", dtype=dtype)
        carry = make_carry(cfg, 4, device="cpu", dtype=dtype)
        cmd0, aux0, carry0 = make_step_batch(cfg, device="cpu", dtype=dtype)(sc, carry)
        cmd1, aux1, carry1 = make_step_batch(dbg, device="cpu", dtype=dtype)(sc, carry)
        assert aux0.lm_trace is None and aux1.lm_trace is not None
        assert aux1.lm_trace.cost.shape == (4, cfg.optimizer.max_iterations)
        for a, b in zip((*cmd0, *aux0.solve, *carry0), (*cmd1, *aux1.solve, *carry1)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("tick", range(N_TICKS))
def test_latent_critic_step_parity_f64(tick):
    """pure_angle_weight != 0: the JAX package leaves the fused evaluation
    for forward-mode autodiff over the residual function, the port adds the
    latent rows' term to it; same gate as every other step test."""
    jax_side, torch_side = _run("latent")[tick]
    assert_step_parity_f64(jax_side, torch_side, tick)
    assert torch_side[1].lm_trace is None
    if tick == 0:
        assert people_in_view(torch_side).any()


def test_curvature_critic_step_runs():
    """curvature_weight != 0 (with pure_angle_weight): the port solves the
    tick with the latent rows' term — usable, in bounds, and different from
    the tick without the latent critics. (The JAX step raises a shape error
    for this config, so there is no reference to hold it against; the critic
    itself is held against the JAX function in test_torch_residual_path.)"""
    cfg = benchmark_social_config()
    lat = _optimizer(cfg, weights={"pure_angle_weight": 0.5, "curvature_weight": 0.3})
    sc = T.scenario_from_numpy(
        make_scenario_batch(cfg, 3, 0, n_valid_people=3, dtype=np.float64), device="cpu", dtype=torch.float64)
    carry = make_carry(cfg, 3, device="cpu", dtype=torch.float64)
    cmd0, _, _ = make_step_batch(cfg, device="cpu", dtype=torch.float64)(sc, carry)
    cmd, aux, _ = make_step_batch(lat, device="cpu", dtype=torch.float64)(sc, carry)
    assert bool(aux.solve.usable.all()) and (aux.status == T.STATUS_OK).all()
    assert (cmd.linear_x >= 0.0).all() and (cmd.linear_x <= 0.6).all()
    assert (cmd.angular_z.abs() <= 1.4).all()
    assert (aux.solve.initial_cost > 0).all()
    assert not torch.equal(cmd.angular_z, cmd0.angular_z)
