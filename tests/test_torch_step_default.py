"""The reference's own configuration (``SocialMPCConfig()``: horizon 5 in
one block of 5, NB = 1, D = 2, S = 59, a cap of 100 LM iterations, no ESDF
or obstacle window) through the port's batched step on the CPU against the
JAX package's ``make_step_batch`` in float64 on identical NumPy inputs; and
the CLI's bench loop (runtime/bench.py) on it: the last tick's linear_x
against the JAX package's ``cmd_bench`` loop within 1e-6. The bench loop
against its host loop is in tests/test_torch_bench_loop.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_common import assert_step_parity_f64, people_in_view, run_both

from nav2_social_mpc_controller_tpu.controller.controller import (
    make_carry as jax_make_carry,
    make_step_batch as jax_make_step_batch,
)
from nav2_social_mpc_controller_tpu.core.config import SocialMPCConfig as JaxDefaultConfig
from nav2_social_mpc_controller_tpu.utils.scenarios import make_scenario_batch as jax_batch
from nav2_social_mpc_controller_tpu_torch.core import types as T
from nav2_social_mpc_controller_tpu_torch.core.config import SocialMPCConfig
from nav2_social_mpc_controller_tpu_torch.runtime.bench import BenchLoop
from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario_batch

torch.set_num_threads(1)

N_TICKS = 2
PEOPLE = (3, 3, 0, 2)
BENCH_BATCH, BENCH_TICKS = 4, 2


@functools.lru_cache(maxsize=None)
def _jstep():
    return jax_make_step_batch(JaxDefaultConfig())  # compiled once for both tests


@functools.lru_cache(maxsize=None)
def _run():
    return run_both(JaxDefaultConfig(), PEOPLE, N_TICKS, np.float64, jstep=_jstep())


# The paths integrate the commands over the horizon, S * dt = 2.95 s: a
# command within 1e-6 moves the path's end by up to ~3e-6. The lanes that
# take many LM iterations (56 on the second tick of seed 2, which has no
# person) carry two implementations' float64 rounding that far.
PATH_ATOL = 3e-6


@pytest.mark.parametrize("tick", range(N_TICKS))
def test_step_parity_f64(tick):
    """Commands within 1e-6 and paths within PATH_ATOL; status, cursor, LM
    iteration counts, termination codes and the carry equal
    (test_torch_common)."""
    jax_side, torch_side = _run()[tick]
    assert_step_parity_f64(jax_side, torch_side, tick, path_atol=PATH_ATOL)
    assert torch_side[1].cmds.shape[1] == 60  # maxsize: S = 59 steps
    assert people_in_view(torch_side).any()


def _jax_bench(n):
    """The JAX package's cmd_bench loop (its __main__.py: n ticks of the
    vmapped step, the pose moved by 1e-6 * i, the carry fed back; there a
    lax.scan over ticks), each tick through the jitted make_step_batch the
    step parity compiled, returning every lane's linear_x of the last tick
    instead of lane 0's."""
    cfg = JaxDefaultConfig()
    scb = jax.tree.map(jnp.asarray, jax_batch(cfg, BENCH_BATCH, n_valid_people=3,
                                              dtype=np.float64))
    carry = jax.vmap(lambda _: jax_make_carry(cfg, dtype=jnp.float64))(jnp.arange(BENCH_BATCH))
    for i in range(n):
        eps = (1e-6 * jnp.asarray(i)).astype(scb.robot.pose.dtype)
        moved = scb._replace(robot=scb.robot._replace(pose=scb.robot.pose + eps))
        cmd, _, carry = _jstep()(moved, carry)
    return np.asarray(cmd.linear_x)


def test_bench_matches_the_jax_cmd_bench_f64():
    """The last tick's linear_x of BENCH_TICKS bench ticks within 1e-6 of
    the JAX package's cmd_bench loop; some lanes are not at the speed limit,
    so the comparison is not of saturated commands."""
    cfg = SocialMPCConfig()
    sc = T.scenario_from_numpy(make_scenario_batch(cfg, BENCH_BATCH, base_seed=0,
                                                   n_valid_people=3), device="cpu",
                               dtype=torch.float64)
    got = BenchLoop(cfg, device="cpu", dtype=torch.float64)(
        sc, BENCH_TICKS).linear_x.numpy()
    want = _jax_bench(BENCH_TICKS)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert (np.abs(want - 0.6) > 1e-3).any()
