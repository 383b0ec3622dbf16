"""The autodiff residual path of the port (controller/optimize.py:
build_residual_fn + solver/lm.py: make_value_grad) against the JAX package's
``build_residual_fn`` and its forward-mode Jacobian, in float64 on identical
NumPy problems (tests/test_torch_common.py: fused_problems, straight from the
JAX pipeline, some robots near the goal so the horizon shrinks), and against
the port's own fused ValueGrad.

Tolerance 1e-9, scale-normalised per scenario: both sides evaluate the same
formulas in float64 and differ only in summation order (cumsum, norms) and in
libm's last bits, amplified by the fourth-power distance costs."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwad
from test_torch_common import PEOPLE_BATCHES, _t, fused_problems, fused_value_grad

from nav2_social_mpc_controller_tpu.controller import optimize as jopt
from nav2_social_mpc_controller_tpu.core.types import Costmap as JCostmap
from nav2_social_mpc_controller_tpu.costs import critics as jcritics
from nav2_social_mpc_controller_tpu_torch.controller import optimize as topt
from nav2_social_mpc_controller_tpu_torch.core import config as tcfg_mod
from nav2_social_mpc_controller_tpu_torch.core import types as T
from nav2_social_mpc_controller_tpu_torch.costs import critics as tcritics
from nav2_social_mpc_controller_tpu_torch.solver.lm import make_value_grad

torch.set_num_threads(1)

LATENT = {"pure_angle_weight": 0.7}  # the JAX step accepts this latent critic
CASES = {
    "social": ("social", {}),
    "omni6": ("omni6", {}),
    "stress36": ("stress36", {}),
    "mixed": ("mixed", {}),
    "latent": ("social", LATENT),
}


def _with_weights(cfg, weights):
    w = dataclasses.replace(cfg.optimizer.weights, **weights)
    return dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer, weights=w))


@functools.lru_cache(maxsize=None)
def _problem(case):
    batch, weights = CASES[case]
    name, people = PEOPLE_BATCHES[batch]
    jcfg, jdims, bt = fused_problems(name, np.float64, True, people)
    tcfg = _with_weights(getattr(tcfg_mod, name)(), weights)
    rng = np.random.default_rng(2)
    u = bt["u"] + rng.uniform(-0.05, 0.05, bt["u"].shape)
    return _with_weights(jcfg, weights), jdims, tcfg, topt.ProblemDims.from_config(tcfg), bt, u


def _torch_residual_fn(tcfg, tdims, bt):
    return topt.build_residual_fn(
        tcfg, tdims, _t(bt["rows"]), _t(bt["n_rows"]).to(torch.int32), _t(bt["proj"]),
        _t(bt["present"]), T.Costmap(_t(bt["cmd"]), _t(bt["cmo"]), _t(bt["cmr"])),
    )


def _torch_r_and_j(fn, u):
    u = _t(u)
    cols = []
    with fwad.dual_level():
        for i in range(u.shape[1]):
            tangent = torch.zeros_like(u)
            tangent[:, i] = 1.0
            r, col = fwad.unpack_dual(fn(fwad.make_dual(u, tangent)))
            cols.append(col.detach().clone())
    return r.detach().numpy(), torch.stack(cols, dim=2).numpy()


def _jax_r_and_j(jcfg, jdims, bt, u):
    def lane(u_l, rows, n_rows, proj, present, cmd, cmo, cmr):
        fn = jopt.build_residual_fn(
            jcfg, jdims, rows, n_rows, proj, present, JCostmap(data=cmd, origin=cmo, resolution=cmr))
        return fn(u_l), jax.jacfwd(fn)(u_l)

    args = (u, bt["rows"], bt["n_rows"], bt["proj"], bt["present"], bt["cmd"], bt["cmo"], bt["cmr"])
    r, j = jax.vmap(lane)(*map(jnp.asarray, args))
    return np.asarray(r), np.asarray(j)


@pytest.mark.parametrize("case", list(CASES))
def test_residuals_and_jacobian_match_jax_f64(case):
    jcfg, jdims, tcfg, tdims, bt, u = _problem(case)
    r_ref, j_ref = _jax_r_and_j(jcfg, jdims, bt, u)
    r, j = _torch_r_and_j(_torch_residual_fn(tcfg, tdims, bt), u)
    assert r.shape == r_ref.shape and j.shape == j_ref.shape  # same layout, same row count
    assert np.isfinite(j_ref).all() and np.isfinite(j).all()
    # masked rows are exactly zero on both sides, in the same places
    np.testing.assert_array_equal(r == 0.0, r_ref == 0.0)
    scale_r = np.maximum(np.abs(r_ref).max(axis=1, keepdims=True), 1.0)
    np.testing.assert_allclose(r / scale_r, r_ref / scale_r, atol=1e-9)
    scale_j = np.maximum(np.abs(j_ref).max(axis=(1, 2), keepdims=True), 1.0)
    np.testing.assert_allclose(j / scale_j, j_ref / scale_j, atol=1e-9)
    if case == "latent":
        s = tdims.s
        assert r.shape[1] == 9 * s + tdims.n_vf and np.abs(r[:, 8 * s : 9 * s]).max() > 0
    if case == "mixed":  # a scenario without people has its three people blocks off
        off = ~bt["present"]
        assert (r[off][:, : 3 * tdims.s] == 0).all() and (j[off][:, : 3 * tdims.s] == 0).all()
        assert (np.abs(r[~off][:, : 3 * tdims.s]).max(axis=1) > 0).all()


@pytest.mark.parametrize("case", ["social", "stress36", "mixed"])
def test_residual_value_grad_matches_fused_value_grad(case):
    """cost, g, JtJ from forward-mode autodiff over the residual function vs
    the port's analytic fused evaluation (plain K6, K1, K2), float64."""
    _, _, tcfg, tdims, bt, u = _problem(case)
    d = 2 * tdims.n_blocks
    got = make_value_grad(_torch_residual_fn(tcfg, tdims, bt), d)(_t(u))
    ref = fused_value_grad(tcfg, tdims, bt)(_t(u))
    for x, y in zip(got, ref):
        x, y = x.numpy().reshape(len(u), -1), y.numpy().reshape(len(u), -1)
        scale = np.maximum(np.abs(y).max(axis=1, keepdims=True), 1.0)
        np.testing.assert_allclose(x / scale, y / scale, atol=1e-9)


def test_residual_fn_select_restricts_to_lanes():
    """select(lanes) gathers every per-scenario tensor: the restricted
    function evaluates the chosen scenarios to the same bits."""
    _, _, tcfg, tdims, bt, u = _problem("mixed")
    fn = _torch_residual_fn(tcfg, tdims, bt)
    lanes = torch.tensor([3, 0, 4])
    with torch.no_grad():
        assert torch.equal(fn.select(lanes)(_t(u)[lanes]), fn(_t(u))[lanes])
    vg = topt.ResidualValueGrad(fn, 2 * tdims.n_blocks)
    for x, y in zip(vg.select(lanes)(_t(u)[lanes]), vg(_t(u))):
        assert torch.equal(x, y[lanes])


def test_latent_critics_match_jax_functions():
    """angle_cost and curvature_cost, values and forward-mode tangents, vs
    the JAX functions under vmap on random poses away from their kinks
    (arccos at the clip, the |ang - mid| corner), float64, 1e-12 relative:
    elementwise formulas. The curvature critic is compared at function level
    because the JAX step cannot run it: its mask there has S - 2 entries for
    S - 1 residuals (controller/optimize.py:236-242 of the JAX package)."""
    rng = np.random.default_rng(11)
    b, s = 4, 12
    p = np.cumsum(rng.uniform(0.05, 0.3, (b, s + 2, 2)), axis=1)
    p[..., 1] += 0.3 * np.sin(3.0 * p[..., 0])
    yaw = rng.uniform(-4.0, 4.0, (b, s))
    target = rng.uniform(-2.0, 5.0, (b, 1, 2))
    dp = rng.normal(size=p.shape)
    dyaw = rng.normal(size=yaw.shape)

    jf = jax.vmap(lambda p_, y_, t_: jcritics.angle_cost(0.7, p_[:s], y_, t_))
    ref, ref_t = jax.jvp(lambda p_, y_: jf(p_, y_, jnp.asarray(target)),
                         (jnp.asarray(p), jnp.asarray(yaw)), (jnp.asarray(dp), jnp.asarray(dyaw)))
    with fwad.dual_level():
        pd, yd = fwad.make_dual(_t(p), _t(dp)), fwad.make_dual(_t(yaw), _t(dyaw))
        got, got_t = fwad.unpack_dual(tcritics.angle_cost(0.7, pd[:, :s], yd, _t(target)))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)
        np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), rtol=1e-10, atol=1e-12)

    max_angle = 0.3
    jc = jax.vmap(lambda p_: jcritics.curvature_cost(0.3, max_angle, p_[:-2], p_[1:-1], p_[2:]))
    ref, ref_t = jax.jvp(jc, (jnp.asarray(p),), (jnp.asarray(dp),))
    with fwad.dual_level():
        pd = fwad.make_dual(_t(p), _t(dp))
        got, got_t = fwad.unpack_dual(
            tcritics.curvature_cost(0.3, max_angle, pd[:, :-2], pd[:, 1:-1], pd[:, 2:]))
        assert (np.asarray(ref) > 0).any() and got.shape == (b, s)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)
        np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), rtol=1e-9, atol=1e-12)

    # On a straight line the triplet angle sits at the clip (arccos(-1) = pi):
    # inside the dead band, residual 0 and tangent 0 on both sides.
    line = np.stack([np.linspace(0.0, 1.0, 6), np.zeros(6)], axis=-1)[None]
    dl = rng.normal(size=line.shape)
    ref, ref_t = jax.jvp(jc, (jnp.asarray(line),), (jnp.asarray(dl),))
    with fwad.dual_level():
        ld = fwad.make_dual(_t(line), _t(dl))
        got, got_t = fwad.unpack_dual(
            tcritics.curvature_cost(0.3, max_angle, ld[:, :-2], ld[:, 1:-1], ld[:, 2:]))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert (got.numpy() == 0).all()
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))
