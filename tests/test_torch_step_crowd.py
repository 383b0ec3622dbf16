"""The port's batched step in a crowd: the social benchmark config with 64
agents (NB = 3, D = 6, S = 29), on the CPU against the JAX package's
``make_step_batch`` in float64 on identical NumPy inputs. On the card this
config runs K5's general form (N past the 32 agents a warp of force lanes
holds, kernel_shapes.form); K2's people stages read N at run time."""

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
NAME = "social_n64"
PEOPLE = (64, 64, 32, 0)  # valid people per seed


@functools.lru_cache(maxsize=None)
def _run():
    return run_both(config_by_name(jcfg_mod, NAME), PEOPLE, N_TICKS, np.float64)


@pytest.mark.parametrize("tick", range(N_TICKS))
def test_step_parity_f64(tick):
    """Commands and paths within 1e-6; status, cursor, LM iteration counts,
    termination codes and the carry equal (test_torch_common), the carry
    fed back on the second tick."""
    cfg = config_by_name(jcfg_mod, NAME)
    dims = ProblemDims.from_config(cfg)
    assert (cfg.n_agents, dims.n_blocks, dims.s) == (64, 3, 29)
    assert kernel_shapes.form("step", "agents", cfg.n_agents) == kernel_shapes.GENERAL
    jax_side, torch_side = _run()[tick]
    assert_step_parity_f64(jax_side, torch_side, tick)
    assert torch_side[1].people_proj.shape[2] == max(PEOPLE)
    assert people_in_view(torch_side).any()
