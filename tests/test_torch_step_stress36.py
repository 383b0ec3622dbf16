"""The people path of the PyTorch port as a whole, stress-horizon
configuration (H = 36: NB = 6, D = 12, S = 39, ESDF window 44): the port's
batched step on the CPU against the JAX package's ``make_step_batch`` in
float64 on identical NumPy inputs."""

import functools

import numpy as np
import pytest
import torch
from test_torch_common import assert_step_parity_f64, people_in_view, run_both

from nav2_social_mpc_controller_tpu.core.config import benchmark_stress_h36_config

torch.set_num_threads(1)

N_TICKS = 2
PEOPLE = (3, 3, 2, 3)  # valid people per seed


@functools.lru_cache(maxsize=None)
def _run():
    return run_both(benchmark_stress_h36_config(), PEOPLE, N_TICKS, np.float64)


@pytest.mark.parametrize("tick", range(N_TICKS))
def test_step_parity_f64(tick):
    """Commands and paths within 1e-6; status, cursor, LM iteration counts,
    termination codes and the carry equal (test_torch_common)."""
    jax_side, torch_side = _run()[tick]
    assert_step_parity_f64(jax_side, torch_side, tick)
    assert torch_side[1].cmds.shape[1] == 40 and torch_side[1].solve.iterations.shape == (4,)
    assert people_in_view(torch_side).any()
