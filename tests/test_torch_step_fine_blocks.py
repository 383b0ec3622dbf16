"""The port's batched step in finer blocks than the benchmark's, on the CPU
against the JAX package's ``make_step_batch`` in float64 on identical NumPy
inputs: the social config's horizon of 18 in blocks of 2 (NB = 9, D = 18)
and of 1 (NB = 18, D = 36), the shapes that run the kernels' general forms
on the card (kernel_shapes.form). The H = 36 stress horizon in blocks of 3
is in tests/test_torch_step_stress36_bl3.py."""

import functools

import numpy as np
import pytest
import torch
from test_torch_common import (
    assert_step_parity_f64,
    config_by_name,
    people_in_view,
    run_both,
)

from nav2_social_mpc_controller_tpu.controller.optimize import ProblemDims
from nav2_social_mpc_controller_tpu.core import config as jcfg_mod
from nav2_social_mpc_controller_tpu_torch import kernel_shapes

torch.set_num_threads(1)

N_TICKS = 2
CASES = {  # config: (valid people per seed, NB, n_vf)
    "social_bl2": ((3, 3, 0, 2), 9, 8),
    "social_bl1": ((3, 2, 3, 0), 18, 17),
}


@functools.lru_cache(maxsize=None)
def _run(name):
    return run_both(config_by_name(jcfg_mod, name), CASES[name][0], N_TICKS, np.float64)


@pytest.mark.parametrize("tick", range(N_TICKS))
@pytest.mark.parametrize("name", list(CASES))
def test_step_parity_f64(name, tick):
    """Commands and paths within 1e-6; status, cursor, LM iteration counts,
    termination codes and the carry equal (test_torch_common), the carry
    fed back on the second tick."""
    people, nb, n_vf = CASES[name]
    dims = ProblemDims.from_config(config_by_name(jcfg_mod, name))
    assert (dims.n_blocks, dims.n_vf) == (nb, n_vf)
    assert kernel_shapes.form("step", "blocks", nb) == kernel_shapes.GENERAL
    jax_side, torch_side = _run(name)[tick]
    assert_step_parity_f64(jax_side, torch_side, tick)
    assert torch_side[1].people_proj.shape[2] == max(people)
    assert people_in_view(torch_side).any()
