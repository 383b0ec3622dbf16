"""The port's batched step at the H = 36 stress horizon in blocks of 3
(NB = 12, D = 24, S = 39), a longer horizon than the benchmark's six blocks:
on the CPU against the JAX package's ``make_step_batch`` in float64 on
identical NumPy inputs. On the card this config runs the kernels' general
forms (kernel_shapes.form); the social horizon in finer blocks is in
tests/test_torch_step_fine_blocks.py."""

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
NAME = "stress36_bl3"
PEOPLE = (3, 3, 1, 0)  # valid people per seed


@functools.lru_cache(maxsize=None)
def _run():
    return run_both(config_by_name(jcfg_mod, NAME), PEOPLE, N_TICKS, np.float64)


@pytest.mark.parametrize("tick", range(N_TICKS))
def test_step_parity_f64(tick):
    """Commands and paths within 1e-6; status, cursor, LM iteration counts,
    termination codes and the carry equal (test_torch_common), the carry
    fed back on the second tick."""
    dims = ProblemDims.from_config(config_by_name(jcfg_mod, NAME))
    assert (dims.n_blocks, dims.n_vf, dims.s) == (12, 11, 39)
    assert kernel_shapes.form("step", "blocks", dims.n_blocks) == kernel_shapes.GENERAL
    jax_side, torch_side = _run()[tick]
    assert_step_parity_f64(jax_side, torch_side, tick)
    assert torch_side[1].people_proj.shape[2] == max(PEOPLE)
    assert people_in_view(torch_side).any()
