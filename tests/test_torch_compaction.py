"""Converged-lane compaction of the port (solver/batched.py +
make_step_batch_compacted) and warm_start_mode="previous_solution":
per-lane results must be IDENTICAL to the plain batched solver — compaction
may only change how wide the later iterations run, never any lane's
trajectory — and the previous-solution warm start must match the JAX step."""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from test_torch_common import assert_step_parity_f64, run_both

from nav2_social_mpc_controller_tpu.core.config import benchmark_social_config as jax_social_config
from nav2_social_mpc_controller_tpu_torch.controller import controller as tctl
from nav2_social_mpc_controller_tpu_torch.controller import optimize as topt
from nav2_social_mpc_controller_tpu_torch.controller.controller import (
    make_carry,
    make_step_batch,
    make_step_batch_compacted,
)
from nav2_social_mpc_controller_tpu_torch.core import types as T
from nav2_social_mpc_controller_tpu_torch.core.config import benchmark_social_config
from nav2_social_mpc_controller_tpu_torch.solver.batched import lm_solve_batch_compacted, width_ladder
from nav2_social_mpc_controller_tpu_torch.solver.lm import LMConfig, lm_solve
from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario_batch

torch.set_num_threads(1)

N_TICKS = 3


def _warm(cfg):
    return dataclasses.replace(
        cfg, optimizer=dataclasses.replace(cfg.optimizer, warm_start_mode="previous_solution"))


def _scenarios(cfg, batch, dtype):
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    sc = make_scenario_batch(cfg, batch, 0, n_valid_people=3, grid_hw=(64, 64), dtype=np_dtype)
    return T.scenario_from_numpy(sc, device="cpu", dtype=dtype)


@pytest.mark.parametrize("batch,capacity_frac", [(12, 0.25), (16, 0.125)], ids=["cap_0.25", "cap_0.125"])
def test_compacted_matches_plain_solver_exactly(batch, capacity_frac):
    """float64: both paths run the same iteration per lane with frozen done
    lanes, so gather/compact/scatter must reproduce every lane bit for bit —
    commands, solver statistics and the carry, over three warm-started
    ticks; the low capacity descends several levels of the width ladder."""
    dtype = torch.float64
    cfg = _warm(benchmark_social_config())
    sc = _scenarios(cfg, batch, dtype)
    plain = make_step_batch(cfg, device="cpu", dtype=dtype)
    compacted = make_step_batch_compacted(cfg, capacity_frac, device="cpu", dtype=dtype)
    carry_p = carry_c = make_carry(cfg, batch, device="cpu", dtype=dtype)
    for _ in range(N_TICKS):
        cmd_p, aux_p, carry_p = plain(sc, carry_p)
        cmd_c, aux_c, carry_c = compacted(sc, carry_c)
        for a, b in zip((*cmd_p, aux_p.status, *aux_p.solve, *carry_p),
                        (*cmd_c, aux_c.status, *aux_c.solve, *carry_c)):
            assert torch.equal(a, b)
    assert bool(aux_c.solve.usable.all())


def test_compacted_matches_plain_solver_f32():
    """float32 on the CPU: PyTorch's vectorised sin/cos/exp/atan2 round the
    last bit differently for an element in a full SIMD group and one in the
    tail, so a gathered lane can differ by an ulp from the same lane at full
    width (on the card every kernel works scenario by scenario and the two
    are held to equality, tests/test_torch_gpu_kernels.py). One tick, at the
    JAX package's figures for this comparison: rtol 1e-5, atol 1e-6."""
    dtype = torch.float32
    cfg = benchmark_social_config()
    sc = _scenarios(cfg, 12, dtype)
    carry = make_carry(cfg, 12, device="cpu", dtype=dtype)
    cmd_p, aux_p, _ = make_step_batch(cfg, device="cpu", dtype=dtype)(sc, carry)
    cmd_c, aux_c, _ = make_step_batch_compacted(cfg, 0.34, device="cpu", dtype=dtype)(sc, carry)
    np.testing.assert_allclose(cmd_c.linear_x.numpy(), cmd_p.linear_x.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cmd_c.angular_z.numpy(), cmd_p.angular_z.numpy(), rtol=1e-5, atol=1e-6)
    assert torch.equal(aux_c.status, aux_p.status) and bool(aux_c.solve.usable.all())


def _quadratic(targets):
    class ValueGrad:
        def __init__(self, t):
            self.t = t

        def select(self, lanes):
            return ValueGrad(self.t.index_select(0, lanes))

        def __call__(self, u):
            r = u - self.t
            eye = torch.eye(u.shape[1], dtype=u.dtype).expand(u.shape[0], -1, -1)
            return 0.5 * (r * r).sum(1), r, eye.contiguous()

    return ValueGrad(targets)


def test_capacity_validation():
    u0 = torch.zeros((4, 2), dtype=torch.float64)
    vg = _quadratic(torch.ones((4, 2), dtype=torch.float64))
    for capacity in (4, 0, 7):
        with pytest.raises(ValueError, match="capacity"):
            lm_solve_batch_compacted(vg, u0, u0 - 1, u0 + 1, LMConfig(), capacity=capacity)
    with pytest.raises(NotImplementedError, match="jacobi_scaling"):
        lm_solve_batch_compacted(vg, u0, u0 - 1, u0 + 1, LMConfig(jacobi_scaling=True), capacity=2)
    with pytest.raises(TypeError, match="select"):
        lm_solve_batch_compacted(lambda u: vg(u), u0, u0 - 1, u0 + 1, LMConfig(), capacity=2)
    dbg = dataclasses.replace(benchmark_social_config())
    dbg = dataclasses.replace(dbg, optimizer=dataclasses.replace(dbg.optimizer, debug_optimizer=True))
    with pytest.raises(ValueError, match="debug_optimizer"):
        make_step_batch_compacted(dbg, device="cpu")
    assert width_ladder(4096, 1024) == [2048, 1024] and width_ladder(16, 2) == [8, 4, 2]
    assert width_ladder(12, 4) == [6, 4] and width_ladder(4, 3) == [3]


def test_compacted_solver_with_custom_linear_solve():
    """A caller's linear_solve runs the general iteration inside the
    compacted solver too; lanes that need different iteration counts finish
    where the plain solver puts them."""
    rng = np.random.default_rng(0)
    t = torch.tensor(rng.uniform(-3, 3, (10, 2)))
    t[::3] *= 1e-3
    u0 = torch.zeros((10, 2), dtype=torch.float64)
    lo, hi = u0 - 2.0, u0 + 2.0
    cfg = LMConfig(max_iterations=30)

    def lu_solve(a, b):
        return torch.linalg.solve(a, b[:, :, None])[:, :, 0]

    u_p, s_p = lm_solve(_quadratic(t), u0, lo, hi, cfg, linear_solve=lu_solve)
    widths = []
    u_c, s_c = lm_solve_batch_compacted(
        _quadratic(t), u0, lo, hi, cfg, capacity=2, linear_solve=lu_solve, check_every=1,
        width_log=widths)
    assert torch.equal(u_p, u_c)
    for a, b in zip(s_p, s_c):
        assert torch.equal(a, b)
    np.testing.assert_allclose(u_c.numpy(), np.clip(t.numpy(), -2.0, 2.0), atol=1e-6)
    assert widths[0] == 10 and widths == sorted(widths, reverse=True)


@functools.lru_cache(maxsize=None)
def _run_previous_solution():
    jcfg = _warm(jax_social_config())
    return run_both(jcfg, (3, 0, 2, 3, 1, 3), N_TICKS, np.float64, make_tstep=make_step_batch)


@pytest.mark.parametrize("tick", range(N_TICKS))
def test_previous_solution_step_parity_f64(tick):
    """warm_start_mode="previous_solution" against the JAX step, float64:
    the gate of every step test; from tick 1 on the warm start is the
    previous optimum, not the blended reference rows."""
    jax_side, torch_side = _run_previous_solution()[tick]
    assert_step_parity_f64(jax_side, torch_side, tick)


def test_previous_solution_changes_the_start_after_the_first_tick():
    cfg_ref = benchmark_social_config()
    cfg_warm = _warm(cfg_ref)
    sc = _scenarios(cfg_ref, 6, torch.float64)
    carry = make_carry(cfg_ref, 6, device="cpu", dtype=torch.float64)
    with torch.no_grad():
        u0_a = tctl.step_pre(cfg_ref, sc, carry).prep.u0
        u0_b = tctl.step_pre(cfg_warm, sc, carry).prep.u0
        assert torch.equal(u0_a, u0_b)  # no previous solution yet
        _, aux, carry = make_step_batch(cfg_warm, device="cpu", dtype=torch.float64)(sc, carry)
        prep = tctl.step_pre(cfg_warm, sc, carry).prep
        dims = topt.ProblemDims.from_config(cfg_warm)
        starts = np.minimum(np.arange(dims.n_blocks) * dims.block_length, dims.maxsize - 1)
        expected = carry.prev_cmds[:, starts].reshape(6, -1)
        expected = torch.minimum(torch.maximum(expected, prep.lower), prep.upper)
        assert torch.equal(prep.u0, expected)
        assert not torch.equal(prep.u0, tctl.step_pre(cfg_ref, sc, carry).prep.u0)


def test_compacted_warm_start_does_less_work_than_plain():
    """Iterations x width: on warm-started ticks most lanes converge early,
    so the compacted solver's sum of widths over its iterations is below the
    plain solver's batch x (iterations of the slowest lane), which is itself
    a lower bound of what the plain loop runs; and the warm start lowers the
    mean iteration count."""
    cfg = _warm(benchmark_social_config())
    batch = 16
    sc = _scenarios(cfg, batch, torch.float64)
    carry = make_carry(cfg, batch, device="cpu", dtype=torch.float64)
    step = make_step_batch(cfg, device="cpu", dtype=torch.float64)
    lm_cfg = topt.make_lm_config(cfg.optimizer)
    mean_iters = []
    work = []
    for tick in range(N_TICKS):
        with torch.no_grad():
            prep = tctl.step_pre(cfg, sc, carry).prep
            widths = []
            u_c, s_c = lm_solve_batch_compacted(
                topt.build_value_grad(cfg, prep), prep.u0, prep.lower, prep.upper, lm_cfg,
                capacity=2, check_every=1, width_log=widths)
        cmd, aux, carry = step(sc, carry)
        assert torch.equal(s_c.iterations, aux.solve.iterations)
        mean_iters.append(float(aux.solve.iterations.double().mean()))
        work.append((sum(widths), batch * int(aux.solve.iterations.max())))
    assert mean_iters[1] < mean_iters[0] and mean_iters[2] < mean_iters[0]
    for compacted, plain in work[1:]:
        assert compacted < plain, work
