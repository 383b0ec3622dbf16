"""The port's native host helpers (its own copies of esdf_builder.cpp and
scenario_gen.cpp, built with g++ into the package's build/ directory)
against the JAX package's and the NumPy brute force."""

import shutil

import jax
import numpy as np
import pytest
import torch

from nav2_social_mpc_controller_tpu.core.config import SocialMPCConfig as JaxConfig
from nav2_social_mpc_controller_tpu.core.config import benchmark_social_config
from nav2_social_mpc_controller_tpu.runtime import esdf as jax_esdf
from nav2_social_mpc_controller_tpu.runtime import scenario_native as jax_native
from nav2_social_mpc_controller_tpu_torch.core.config import SocialMPCConfig
from nav2_social_mpc_controller_tpu_torch.core.types import scenario_from_numpy
from nav2_social_mpc_controller_tpu_torch.runtime import esdf, native, scenario_native
from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario_batch


def test_gxx_is_present_and_builds_into_the_package_build_dir():
    assert shutil.which("g++") is not None
    assert esdf.native_available() and scenario_native.native_available()
    assert esdf._lib._name.startswith(native.BUILD_DIR)
    assert scenario_native._lib._name.startswith(native.BUILD_DIR)


def _maps():
    rng = np.random.default_rng(0)
    maps = [rng.random((48, 64)) < d for d in (0.002, 0.05, 0.4)]
    single = np.zeros((32, 32), bool)
    single[10, 20] = True
    return maps + [single, np.zeros((16, 16), bool), np.ones((8, 8), bool)]


@pytest.mark.parametrize("k", range(6))
def test_native_esdf_equals_the_jax_native_esdf_and_the_brute_force(k):
    occ = _maps()[k]
    dist, idx = esdf.build_esdf(occ, 0.05)
    jdist, jidx = jax_esdf.build_esdf(occ, 0.05)
    np.testing.assert_array_equal(dist, jdist)
    np.testing.assert_array_equal(idx, jidx)
    assert dist.dtype == np.float32 and idx.dtype == np.int32
    bdist, _ = esdf.brute_force_esdf(occ, 0.05)
    np.testing.assert_allclose(dist, bdist, atol=1e-5)
    h, w = occ.shape
    if occ.any():  # the index points at an obstacle cell at that distance
        yy, xx = np.mgrid[0:h, 0:w]
        assert occ[idx // w, idx % w].all()
        np.testing.assert_allclose(np.hypot(xx - idx % w, yy - idx // w) * 0.05, bdist,
                                   atol=1e-5)


CASES = {
    "default": dict(batch=16, base_seed=3),
    "one_thread": dict(batch=16, base_seed=3, n_threads=1),
    "straight_no_people": dict(batch=8, base_seed=7, path_kind="straight", n_valid_people=0),
    "arc_grid": dict(batch=8, base_seed=11, path_kind="arc", grid_hw=(64, 72)),
    "no_obstacles": dict(batch=4, base_seed=0, with_obstacles=False, grid_hw=(48, 48)),
    "invalid_grid": dict(batch=2, base_seed=1, grid_hw=(100, 100)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_generate_scenario_batch_equals_the_jax_generator(case):
    kw = dict(CASES[case])
    batch = kw.pop("batch")
    got = scenario_native.generate_scenario_batch(SocialMPCConfig(), batch, **kw)
    want = jax_native.generate_scenario_batch(JaxConfig(), batch, **kw)
    leaves_got, leaves_want = jax.tree.leaves(tuple(got)), jax.tree.leaves(tuple(want))
    assert len(leaves_got) == len(leaves_want) == 14
    for a, b in zip(leaves_got, leaves_want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_native_batch_survives_the_converter_and_drives_a_tick():
    from nav2_social_mpc_controller_tpu_torch.controller.controller import (
        make_carry, make_step_batch)

    cfg = SocialMPCConfig()
    s = scenario_native.generate_scenario_batch(cfg, 2, base_seed=1)
    sc = scenario_from_numpy(s, device="cpu")
    assert sc.esdf.indexes.dtype == torch.int32 and sc.path.n.dtype == torch.int32
    np.testing.assert_array_equal(sc.esdf.indexes.numpy(), s.esdf.indexes)
    cmd, aux, _ = make_step_batch(cfg, device="cpu")(sc, make_carry(cfg, 2, device="cpu"))
    assert torch.isfinite(cmd.linear_x).all() and aux.status.dtype == torch.int32


def test_without_a_compiler_the_numpy_generator_stands_in(monkeypatch):
    monkeypatch.setattr(scenario_native, "_load", lambda: None)
    cfg = benchmark_social_config()
    got = scenario_native.generate_scenario_batch(cfg, 2, base_seed=4, grid_hw=(40, 48))
    want = make_scenario_batch(cfg, 2, 4, n_valid_people=3, grid_hw=(40, 48))
    for a, b in zip(jax.tree.leaves(tuple(got)), jax.tree.leaves(tuple(want))):
        np.testing.assert_array_equal(a, b)


def test_window_check_at_generation():
    import dataclasses

    cfg = dataclasses.replace(SocialMPCConfig(), esdf_window_cells=2)
    with pytest.raises(ValueError, match="esdf_window_cells"):
        scenario_native.generate_scenario_batch(cfg, 1)
