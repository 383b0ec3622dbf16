"""The debug-trace tick of the PyTorch port at D = 12: the stress-horizon
configuration (H = 36: NB = 6, D = 12, S = 39) with debug_optimizer=True, the
port's batched step on the CPU against the JAX package's ``make_step_batch``
in float64 on identical NumPy inputs, one tick.

debug_optimizer=True runs the general LM iteration, whose damped step is
kernel K7's (its plain version on the CPU), and returns the per-iteration
LMTrace; the trace is held as tests/test_torch_step_debug.py holds the
social tick's."""

import dataclasses
import functools

import numpy as np
import torch
from test_torch_common import assert_step_parity_f64, people_in_view, run_both

from nav2_social_mpc_controller_tpu.core.config import benchmark_stress_h36_config

torch.set_num_threads(1)

PEOPLE = (3, 2)  # valid people per seed


@functools.lru_cache(maxsize=None)
def _run():
    jcfg = benchmark_stress_h36_config()
    jcfg = dataclasses.replace(
        jcfg, optimizer=dataclasses.replace(jcfg.optimizer, debug_optimizer=True))
    return run_both(jcfg, PEOPLE, 1, np.float64, keep_trace=True)[0]


def test_debug_step_parity_f64():
    """Commands and paths within 1e-6; status, cursor, LM iteration counts,
    termination codes and the carry equal (test_torch_common); the trace rows
    within rtol 1e-6 (atol 1e-9 of the lane's initial cost), the accept
    decisions equal, rows beyond a lane's iteration count zero."""
    jax_side, torch_side = _run()
    assert_step_parity_f64(jax_side, torch_side, 0)
    assert torch_side[1].cmds.shape[1] == 40 and people_in_view(torch_side).any()
    jtrace, trace = jax_side[1].lm_trace, torch_side[1].lm_trace
    iters = torch_side[1].solve.iterations
    t_len = benchmark_stress_h36_config().optimizer.max_iterations
    assert trace.cost.shape == (len(PEOPLE), t_len) and trace.accepted.dtype == np.bool_
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
    beyond = np.arange(t_len)[None, :] >= iters[:, None]
    for buf in trace:
        assert not buf[beyond].any()
    assert (iters > 0).all() and trace.accepted.any(axis=1).all()
