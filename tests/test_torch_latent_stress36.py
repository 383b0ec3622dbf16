"""The latent-critic tick at D = 12: the stress-horizon configuration
(H = 36: NB = 6, D = 12, S = 39) with pure_angle_weight = 0.7, the port's
make_step_batch (the staged tick, run uncaptured on the CPU, whose
evaluation is ops/latent.py's LatentValueGrad) against the JAX package's
make_step_batch (forward-mode autodiff over its residual function) in
float64 on identical NumPy inputs, B = 8, two ticks with each side's carry
fed back. The curvature critic has no step-level reference (the JAX step
cannot run it); tests/test_torch_latent_value_grad.py holds it against the
port's residual path."""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from test_torch_common import assert_step_parity_f64, people_in_view, run_both

from nav2_social_mpc_controller_tpu.core.config import benchmark_stress_h36_config
from nav2_social_mpc_controller_tpu_torch.controller import graph
from nav2_social_mpc_controller_tpu_torch.controller.controller import make_step_batch

torch.set_num_threads(1)

PEOPLE = (3, 0, 2, 3, 1, 0, 3, 2)  # valid people per seed
N_TICKS = 2


def _staged(cfg, device, dtype):
    step = make_step_batch(cfg, device=device, dtype=dtype)
    assert isinstance(step.tick, graph.GraphTick)
    return step


@functools.lru_cache(maxsize=None)
def _run():
    jcfg = benchmark_stress_h36_config()
    w = dataclasses.replace(jcfg.optimizer.weights, pure_angle_weight=0.7)
    jcfg = dataclasses.replace(jcfg, optimizer=dataclasses.replace(jcfg.optimizer, weights=w))
    return run_both(jcfg, PEOPLE, N_TICKS, np.float64, make_tstep=_staged)


@pytest.mark.parametrize("tick", range(N_TICKS))
def test_latent_step_parity_f64_stress36(tick):
    """Commands and paths within 1e-6; status, cursor, LM iteration counts,
    termination codes and the carry equal (test_torch_common); lanes with
    and without a person in view."""
    jax_side, torch_side = _run()[tick]
    assert_step_parity_f64(jax_side, torch_side, tick)
    seen = people_in_view(torch_side)
    assert seen.any() and not seen.all()
    assert torch_side[2].prev_cmds.shape[1] == 40  # maxsize: S = 39 steps
