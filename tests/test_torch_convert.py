"""The state converter of the PyTorch port: the JAX package's Scenario /
ControllerCarry / config, as NumPy, become the port's and come back
unchanged; the port's own copies of the config constructors and the scenario
generator agree with the JAX package's."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from nav2_social_mpc_controller_tpu.controller.controller import make_carry as jax_make_carry
from nav2_social_mpc_controller_tpu.core import config as jcfg_mod
from nav2_social_mpc_controller_tpu.utils.scenarios import (
    make_scenario as jax_make_scenario,
    stack_scenarios as jax_stack_scenarios,
)
from nav2_social_mpc_controller_tpu_torch.core import config as tcfg_mod
from nav2_social_mpc_controller_tpu_torch.core import types as T
from nav2_social_mpc_controller_tpu_torch.core.validate import obstacle_window_min_cells
from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario, make_scenario_batch

torch.set_num_threads(1)

CONFIG_NAMES = [
    "benchmark_social_config",
    "benchmark_obstacle_only_config",
    "benchmark_omni_6agents_config",
    "benchmark_stress_h36_config",
]


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_config_constructors_and_round_trip(name):
    """Each benchmark constructor gives the same tree in both packages, and
    config_from_dict(asdict(jax_cfg)) is the port's own config."""
    jcfg = getattr(jcfg_mod, name)()
    tcfg = getattr(tcfg_mod, name)()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    back = T.config_from_dict(dataclasses.asdict(jcfg))
    assert back == tcfg and isinstance(back, tcfg_mod.SocialMPCConfig)
    assert back.horizon_steps == jcfg.horizon_steps and back.n_blocks == jcfg.n_blocks


def test_default_config_equal():
    assert dataclasses.asdict(jcfg_mod.SocialMPCConfig()) == dataclasses.asdict(
        tcfg_mod.SocialMPCConfig()
    )


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_scenario_round_trip(dtype):
    """JAX-package scenario batch -> port tensors -> NumPy: every leaf
    unchanged, with the port's dtypes (int32 counts, bool masks)."""
    jcfg = jcfg_mod.benchmark_obstacle_only_config()
    sc_np = jax_stack_scenarios(
        [jax_make_scenario(jcfg, seed=s, n_valid_people=s % 3, dtype=dtype) for s in range(3)]
    )
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    sc = T.scenario_from_numpy(sc_np, device="cpu", dtype=tdtype)
    assert isinstance(sc, T.Scenario) and isinstance(sc.path, T.PathInput)
    assert sc.path.n.dtype == torch.int32 and sc.esdf.indexes.dtype == torch.int32
    assert sc.esdf.valid.dtype == torch.bool and sc.costmap.data.dtype == tdtype
    back = T.to_numpy(sc)
    for a, b in zip(jax.tree.leaves(sc_np), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    np.testing.assert_array_equal(sc.people.valid.numpy(), np.asarray(sc_np.people.state)[..., 3] != -1.0)


def test_unbatched_scenario_and_carry_get_a_batch_axis():
    jcfg = jcfg_mod.benchmark_obstacle_only_config()
    sc = T.scenario_from_numpy(jax_make_scenario(jcfg, seed=1, n_valid_people=0), device="cpu")
    assert sc.robot.pose.shape == (1, 3) and sc.costmap.data.shape == (1, 120, 120)
    assert sc.path.n.shape == (1,) and sc.costmap.resolution.shape == (1,)
    carry = T.carry_from_numpy(jax.tree.map(np.asarray, jax_make_carry(jcfg)), device="cpu")
    assert carry.prev_path.shape == (1, 30, 3) and carry.prev_n.dtype == torch.int32
    assert carry.plan_start.shape == (1,)


def test_port_scenario_generator_matches_jax_package():
    """Same seed, same scenario: the port's NumPy generator is a copy of the
    JAX package's (the ESDF comes from the brute-force transform on the
    port's side; distances agree to float32 rounding)."""
    jcfg = jcfg_mod.benchmark_obstacle_only_config()
    tcfg = tcfg_mod.benchmark_obstacle_only_config()
    for seed in (0, 5):
        a = jax_make_scenario(jcfg, seed=seed, n_valid_people=0)
        b = make_scenario(tcfg, seed=seed)
        for name in ("path", "robot", "people", "costmap"):
            for x, y in zip(jax.tree.leaves(getattr(a, name)), jax.tree.leaves(tuple(getattr(b, name)))):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        np.testing.assert_allclose(a.esdf.distances, b.esdf.distances, atol=1e-6)
    batch = make_scenario_batch(tcfg, 3, base_seed=7)
    assert batch.costmap.data.shape == (3, 120, 120) and batch.path.n.shape == (3,)
    assert not np.array_equal(batch.path.points[0], batch.path.points[1])


def test_window_rule_matches_jax_package():
    from nav2_social_mpc_controller_tpu.core import validate as jval

    for name in CONFIG_NAMES:
        for res in (0.05, 0.025, 0.1):
            assert obstacle_window_min_cells(getattr(tcfg_mod, name)(), res) == (
                jval.obstacle_window_min_cells(getattr(jcfg_mod, name)(), res)
            )
