"""The fused LM iteration of the PyTorch port (rollout sensitivities, the
batched prep and kernel K2's plain version) against the JAX package's
reference value_grad (jax.linearize over the production residual closure) on
identical people-free NumPy problems. The same with valid people is in
``tests/test_torch_fused_people_{f64,f32}.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import fused_problems, fused_value_grad

from nav2_social_mpc_controller_tpu.core import config as jcfg_mod
from nav2_social_mpc_controller_tpu.models import motion as jmotion
from nav2_social_mpc_controller_tpu.ops import fused_iter as jfused
from nav2_social_mpc_controller_tpu_torch import _build
from nav2_social_mpc_controller_tpu_torch.controller import optimize as topt
from nav2_social_mpc_controller_tpu_torch.core import config as tcfg_mod
from nav2_social_mpc_controller_tpu_torch.models import motion as tmotion
from nav2_social_mpc_controller_tpu_torch.ops import fused_iter as tfused

torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("h_dyn,bl_dyn", [(18, 6), (7, 4), (1, 1)])
def test_rollout_with_sensitivities(h_dyn, bl_dyn):
    """Rollout, expanded controls and d(poses)/du against the JAX package's
    function (vmapped), incl. shrunk dynamic horizons; and the pose rollout
    against models.motion.rollout_poses of both packages."""
    rng = np.random.default_rng(h_dyn)
    b, s, nb, dt = 4, 29, 3, 0.05
    u = rng.uniform(-0.5, 0.5, (b, nb, 2))
    pose0 = rng.uniform(-1, 1, (b, 3))
    hd = np.full((b,), h_dyn)
    hd[0] = 18  # mixed horizons within one batch
    bd = np.minimum(np.full((b,), bl_dyn), hd)
    bd[0] = 6
    jidx = jax.vmap(lambda h, l: jmotion.block_index_sequence_dynamic(s, h, l))(
        jnp.asarray(hd), jnp.asarray(bd)
    )
    tidx = tmotion.block_index_sequence_dynamic(s, _t(hd), _t(bd))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))

    ref = jax.vmap(lambda uu, p, i: jfused.rollout_with_sensitivities(uu, p, dt, i, nb))(
        jnp.asarray(u), jnp.asarray(pose0), jidx
    )
    got = tfused.rollout_with_sensitivities(_t(u), _t(pose0), dt, tidx, nb)
    for g, r, name in zip(got, ref, ("poses", "vw", "tx", "ty", "tth", "eb")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-12, err_msg=name)
    poses_ref = jax.vmap(lambda p, uu, i: jmotion.rollout_poses(p, uu, dt, i))(
        jnp.asarray(pose0), jnp.asarray(u), jidx
    )
    np.testing.assert_allclose(tmotion.rollout_poses(_t(pose0), _t(u), dt, tidx).numpy(),
                               np.asarray(poses_ref), atol=1e-12)
    np.testing.assert_array_equal(
        tmotion.expand_blocks(_t(u), tidx).numpy(),
        np.asarray(jax.vmap(jmotion.expand_blocks)(jnp.asarray(u), jidx)),
    )
    np.testing.assert_array_equal(
        tmotion.block_index_sequence(29, 18, 6), jmotion.block_index_sequence(29, 18, 6)
    )


@pytest.mark.parametrize(
    "name", ["benchmark_obstacle_only_config", "benchmark_stress_h36_config"], ids=["D6", "D12"]
)
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_value_grad_matches_reference(name, dtype):
    """cost, g, JtJ of the port's ValueGrad (CPU: plain K1 + plain K2) vs the
    vmapped _ref_value_grad, on a batch that mixes full-horizon problems
    with near-goal ones (shrunk h_dyn / bl_dyn). f64: rtol 1e-9. f32: 3e-5 scale-normalised, the
    tolerance of tests/test_fused_iter.py (analytic chain vs autodiff replay
    round differently)."""
    jcfg, jdims, bt = fused_problems(name, dtype)
    tcfg = getattr(tcfg_mod, name)()
    tdims = topt.ProblemDims.from_config(tcfg)
    assert bt["n_rows"].min() <= 8 and bt["n_rows"].max() >= 29
    rng = np.random.default_rng(0)
    u = (bt["u"] + rng.uniform(-0.05, 0.05, bt["u"].shape)).astype(dtype)

    args = (u, bt["rows"], bt["n_rows"], bt["proj"], bt["present"], bt["cmd"], bt["cmo"], bt["cmr"])
    c_ref, g_ref, jtj_ref = (
        np.asarray(x)
        for x in jax.jit(jax.vmap(functools.partial(jfused._ref_value_grad, jcfg, jdims)))(
            *map(jnp.asarray, args)
        )
    )
    _build.reset_launch_counts()
    cost, g, jtj = (x.numpy() for x in fused_value_grad(tcfg, tdims, bt)(_t(u)))
    assert not any(_build.launch_counts.values())
    assert cost.dtype == dtype and g.shape == (5, 2 * tdims.n_blocks)
    np.testing.assert_array_equal(jtj, np.swapaxes(jtj, 1, 2))

    if dtype == np.float64:
        np.testing.assert_allclose(cost, c_ref, rtol=1e-9)
        np.testing.assert_allclose(g, g_ref, rtol=1e-9, atol=1e-9 * np.abs(g_ref).max())
        np.testing.assert_allclose(jtj, jtj_ref, rtol=1e-9, atol=1e-9 * np.abs(jtj_ref).max())
    else:
        np.testing.assert_allclose(cost, c_ref, rtol=2e-5)
        scale_g = np.maximum(np.abs(g_ref).max(axis=1, keepdims=True), 1.0)
        np.testing.assert_allclose(g / scale_g, g_ref / scale_g, atol=3e-5)
        scale_j = np.maximum(np.abs(jtj_ref).max(axis=(1, 2), keepdims=True), 1.0)
        np.testing.assert_allclose(jtj / scale_j, jtj_ref / scale_j, atol=3e-5)


def test_masked_steps_and_unused_blocks_get_no_gradient():
    """Near the goal the horizon shrinks: blocks beyond h_dyn/bl_dyn receive
    exactly zero gradient and zero JtJ rows, as in the JAX package."""
    jcfg, jdims, bt = fused_problems("benchmark_obstacle_only_config", np.float64)
    tcfg = tcfg_mod.benchmark_obstacle_only_config()
    tdims = topt.ProblemDims.from_config(tcfg)
    _, g, jtj = fused_value_grad(tcfg, tdims, bt)(_t(bt["u"]))
    short = bt["n_rows"] - 1 <= 6  # one block only
    assert short.any()
    assert (g[short][:, 2:] == 0).all() and (jtj[short][:, 2:, :] == 0).all()
    assert (g[~short].abs().sum(1) > 0).all()


def test_can_fuse_matches_jax_package():
    import dataclasses

    cfg = tcfg_mod.benchmark_obstacle_only_config()
    assert tfused.can_fuse(cfg) and jfused.can_fuse(jcfg_mod.benchmark_obstacle_only_config())
    w = dataclasses.replace(cfg.optimizer.weights, curvature_weight=0.3)
    latent = dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer, weights=w))
    assert not tfused.can_fuse(latent)
