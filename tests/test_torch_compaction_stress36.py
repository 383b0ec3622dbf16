"""The compacted warm-start tick at D = 12: the stress-horizon configuration
(H = 36: NB = 6, D = 12, S = 39) with warm_start_mode="previous_solution",
the port's make_step_batch_compacted (eager, capture=False, and the staged
default) on the CPU against the JAX package's make_step_batch_compacted in
float64 on identical NumPy inputs; and ValueGrad.select at NB = 6.

B = 8 at capacity 0.25 gives the ladder [4, 2]. Two ticks run with each
side's carry fed back; on them no check finds four lanes or fewer active.
A third tick, whose warm start lets six lanes converge early so that one
check drops the active count past both rungs (8 -> 2), starts the port
from the JAX package's carry: with its own carry, lane 2's second tick,
which runs to the iteration cap, ends 1.8e-7 apart from the JAX package's
in angular_z, and that warm start ends the third tick's function-tolerance
stop (22 iterations on both sides) 1.8e-6 apart. Each side's third tick
thus solves from the same inputs."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_common import assert_step_parity_f64, scripted_poses

from nav2_social_mpc_controller_tpu.controller.controller import (
    make_carry as jax_make_carry,
    make_step_batch_compacted as jax_make_step_batch_compacted,
)
from nav2_social_mpc_controller_tpu.core.config import benchmark_stress_h36_config
from nav2_social_mpc_controller_tpu.utils.scenarios import make_scenario, stack_scenarios
from nav2_social_mpc_controller_tpu_torch.controller import graph_compacted
from nav2_social_mpc_controller_tpu_torch.controller.controller import (
    CompactedTick,
    make_carry,
    make_step_batch_compacted,
    step_pre,
)
from nav2_social_mpc_controller_tpu_torch.controller.optimize import build_value_grad
from nav2_social_mpc_controller_tpu_torch.core import types as T
from nav2_social_mpc_controller_tpu_torch.core.config import config_from_dict
from nav2_social_mpc_controller_tpu_torch.solver.batched import width_ladder

torch.set_num_threads(1)

PEOPLE = (3, 0, 2, 0, 1, 0, 3, 0)  # valid people per seed
CAPACITY_FRAC = 0.25
N_TICKS = 3


def _jax_cfg():
    jcfg = benchmark_stress_h36_config()
    return dataclasses.replace(
        jcfg, optimizer=dataclasses.replace(jcfg.optimizer, warm_start_mode="previous_solution"))


@functools.lru_cache(maxsize=None)
def _scenarios():
    """The NumPy batch and its per-tick scenarios (poses riding each plan)."""
    sc = stack_scenarios([make_scenario(_jax_cfg(), seed=s, n_valid_people=p, dtype=np.float64)
                          for s, p in enumerate(PEOPLE)])
    return [sc._replace(robot=sc.robot._replace(pose=pose))
            for pose in scripted_poses(sc, N_TICKS)]


@functools.lru_cache(maxsize=None)
def _jax_ticks():
    jcfg = _jax_cfg()
    step = jax_make_step_batch_compacted(jcfg, CAPACITY_FRAC)
    carry = jax.tree.map(lambda x: jnp.broadcast_to(x, (len(PEOPLE),) + x.shape),
                         jax_make_carry(jcfg, dtype=jnp.float64))
    out = []
    for sc in _scenarios():
        cmd, aux, carry = step(sc, carry)
        out.append(jax.tree.map(np.asarray, (cmd, aux._replace(lm_trace=None), carry)))
    return out


@functools.lru_cache(maxsize=None)
def _port_ticks(capture):
    cfg = config_from_dict(dataclasses.asdict(_jax_cfg()))
    step = make_step_batch_compacted(cfg, CAPACITY_FRAC, device="cpu", dtype=torch.float64,
                                     capture=capture)
    carry = make_carry(cfg, len(PEOPLE), device="cpu", dtype=torch.float64)
    out, widths = [], []
    for tick, sc in enumerate(_scenarios()):
        if tick == N_TICKS - 1:
            carry = T.carry_from_numpy(_jax_ticks()[tick - 1][2], device="cpu",
                                       dtype=torch.float64)
        cmd, aux, carry = step(T.scenario_from_numpy(sc, device="cpu", dtype=torch.float64), carry)
        out.append((cmd, aux, carry))
        widths.append(list(step.tick.width_log))
    return step, out, widths


def test_compacted_step_parity_f64_stress36():
    """Both port ticks against the JAX compacted step (the third tick from
    the JAX package's carry): commands and carry within 1e-6; status, cursor, iteration counts and termination codes
    equal (test_torch_common); the staged tick equal to the eager one bit
    for bit, widths included; the ladder descended past both rungs."""
    eager, eager_out, eager_widths = _port_ticks(False)
    staged, staged_out, staged_widths = _port_ticks(True)
    assert isinstance(eager.tick, CompactedTick)
    assert isinstance(staged.tick, graph_compacted.CompactedGraphTick)
    assert width_ladder(len(PEOPLE), 2) == [4, 2]
    for tick, (jax_side, got, want) in enumerate(zip(_jax_ticks(), staged_out, eager_out)):
        assert_step_parity_f64(jax_side, T.to_numpy(got), tick)
        for a, b in zip(T.tree_leaves(got), T.tree_leaves(want)):
            assert torch.equal(a, b)
    assert staged_widths == eager_widths
    last = eager_widths[-1]
    assert last[0] == len(PEOPLE) and last[-1] == 2 and 4 not in last  # 8 -> 2 in one check


def test_value_grad_select_nb6_bit_for_bit():
    """ValueGrad.select at NB = 6: a gathered lane (in any order, repeated
    lanes too) evaluates to the bits of the same lane of the full batch."""
    cfg = config_from_dict(dataclasses.asdict(_jax_cfg()))
    sc = T.scenario_from_numpy(_scenarios()[0], device="cpu", dtype=torch.float64)
    with torch.no_grad():
        prep = step_pre(cfg, sc, make_carry(cfg, len(PEOPLE), device="cpu",
                                            dtype=torch.float64)).prep
        vg = build_value_grad(cfg, prep)
        assert vg.nb == 6 and prep.u0.shape == (len(PEOPLE), 12)
        u = prep.u0 + 0.01 * torch.arange(12, dtype=torch.float64)
        full = vg(u)
        lanes = torch.tensor([5, 0, 3, 3, 7])
        part = vg.select(lanes)(u.index_select(0, lanes))
    for a, b in zip(part, full):
        assert torch.equal(a, b.index_select(0, lanes))
