"""The evaluation of a config with latent critics (ops/latent.py:
LatentValueGrad: the fused evaluation plus the latent rows' term on the same
rollout) against the reference it replaces on every entry point, the
residual path (controller/optimize.py: ResidualValueGrad, D forward-mode
passes over the whole residual stack), on problems straight from the JAX
package's pipeline (tests/test_torch_common.py: fused_problems): social
(NB = 3) and stress36 (NB = 6), lanes with and without a person in view,
lanes a few poses before the goal (shrunk dynamic horizon), and one lane
whose first block has v = 0, so that its rollout stands still and a
curvature row's tangent goes through sqrt at 0 and the 1e-30 clamp.

Tolerance 1e-10 relative per scenario in float64: the two evaluations sum
the same rows in another order (K2's plain per-row reduction plus the latent
rows' matrix products, against one (B, R, D) matrix product) over rollouts
that differ in their prefix sums' rounding, both some 1e-16 relative; the
curvature rows' differences of nearly equal poses amplify it to about
1e-13."""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwad
from test_torch_common import _t, fused_problems

from nav2_social_mpc_controller_tpu_torch.controller import optimize as topt
from nav2_social_mpc_controller_tpu_torch.core import config as tcfg_mod
from nav2_social_mpc_controller_tpu_torch.core import types as T
from nav2_social_mpc_controller_tpu_torch.costs import critic_grads as cg
from nav2_social_mpc_controller_tpu_torch.costs import critics
from nav2_social_mpc_controller_tpu_torch.models.motion import expand_blocks, rollout_poses
from nav2_social_mpc_controller_tpu_torch.ops import fused_iter, latent

torch.set_num_threads(1)

TOL = 1e-10  # relative per scenario, float64; see the module docstring
STILL = 0  # the lane whose first block stands still
BATCHES = {
    "social": ("benchmark_social_config", (3, 0, 2, 3, 0)),  # NB = 3
    "stress36": ("benchmark_stress_h36_config", (3, 2, 0, 3, 1)),  # NB = 6
}
WEIGHTS = {
    "both": {"pure_angle_weight": 0.5, "curvature_weight": 0.3},
    "pure_angle": {"pure_angle_weight": 0.7},
    "curvature": {"curvature_weight": 0.3},
}


def _with_weights(cfg, weights):
    w = dataclasses.replace(cfg.optimizer.weights, **weights)
    return dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer, weights=w))


@functools.lru_cache(maxsize=None)
def _problem(batch):
    """(NumPy batch, u): seeds 2-4 start a few poses before their goal;
    lane STILL's first block has v = 0."""
    name, people = BATCHES[batch]
    _, _, bt = fused_problems(name, np.float64, True, people)
    rng = np.random.default_rng(3)
    u = bt["u"] + rng.uniform(-0.05, 0.05, bt["u"].shape)
    u[STILL, 0] = 0.0
    return bt, u


def _args(batch, weights, dtype=torch.float64):
    bt, u = _problem(batch)
    cfg = _with_weights(getattr(tcfg_mod, BATCHES[batch][0])(), WEIGHTS[weights])
    dims = topt.ProblemDims.from_config(cfg)

    def t(x):
        x = _t(x)
        return x.to(dtype) if x.is_floating_point() else x

    args = (cfg, dims, t(bt["rows"]), t(bt["n_rows"]).to(torch.int32), t(bt["proj"]),
            t(bt["present"]), T.Costmap(t(bt["cmd"]), t(bt["cmo"]), t(bt["cmr"])))
    return args, t(u)


def _both(batch, weights, dtype=torch.float64):
    """(new evaluation, reference, u)."""
    args, u = _args(batch, weights, dtype)
    cfg, dims = args[:2]
    new = topt.build_value_grad(cfg, topt.PreparedProblem(*args[2:], u0=u, lower=u, upper=u))
    ref = topt.ResidualValueGrad(topt.build_residual_fn(*args), 2 * dims.n_blocks)
    return new, ref, u


@pytest.mark.parametrize("weights", list(WEIGHTS))
@pytest.mark.parametrize("batch", list(BATCHES))
def test_latent_value_grad_matches_residual_path_f64(batch, weights):
    """cost, g and JtJ of LatentValueGrad against ResidualValueGrad within
    TOL of each scenario's largest entry, non-finite entries equal; JtJ
    also within TOL of each entry's Cauchy-Schwarz bound sqrt(JtJ_ii
    JtJ_jj), which holds the still lane's ordinary entries beside its
    1e30-scale column."""
    new, ref, u = _both(batch, weights)
    assert isinstance(new, latent.LatentValueGrad)
    with torch.no_grad():
        got, want = new(u), ref(u)
    b = u.shape[0]
    for x, y in zip(got, want):
        x, y = x.numpy().reshape(b, -1), y.numpy().reshape(b, -1)
        np.testing.assert_array_equal(np.isfinite(x), np.isfinite(y))
        scale = np.maximum(np.nanmax(np.abs(np.where(np.isfinite(y), y, np.nan)), axis=1,
                                     keepdims=True), 1.0)
        np.testing.assert_allclose(x / scale, y / scale, rtol=0, atol=TOL, equal_nan=True)
    diag = np.diagonal(want[2].numpy(), axis1=1, axis2=2)
    bound = np.maximum(np.sqrt(diag[:, :, None] * diag[:, None, :]), 1.0)
    np.testing.assert_allclose(got[2].numpy() / bound, want[2].numpy() / bound, rtol=0, atol=TOL)
    if weights != "pure_angle":  # the still lane's curvature tangent: ~1e30, squared ~1e60
        assert np.abs(want[2][STILL].numpy()).max() > 1e50
        assert np.abs(want[2].numpy()[np.arange(b) != STILL]).max() < 1e20
    bt, _ = _problem(batch)
    assert not bt["present"].all() and bt["present"].any()
    assert (bt["n_rows"] < bt["rows"].shape[1]).any()  # lanes with a shrunk horizon


@pytest.mark.parametrize("batch", list(BATCHES))
def test_still_lane_overflows_alike_in_float32(batch):
    """float32: the still lane's JtJ overflows to inf on both evaluations
    in the same entries (a non-finite JtJ decides K3's step), and every
    other entry agrees within 1e-4 of its scenario's largest finite one."""
    new, ref, u = _both(batch, "both", torch.float32)
    with torch.no_grad():
        got, want = new(u), ref(u)
    assert not bool(torch.isfinite(want[2][STILL]).all())
    for x, y in zip(got, want):
        x, y = x.reshape(u.shape[0], -1), y.reshape(u.shape[0], -1)
        assert torch.equal(torch.isfinite(x), torch.isfinite(y))
        assert torch.equal(torch.isnan(x), torch.isnan(y))
        fin = torch.isfinite(y)
        scale = torch.where(fin, y.abs(), 0.0).amax(dim=1, keepdim=True).clamp(min=1.0)
        err = torch.where(fin, (x - y).abs() / scale, 0.0)
        assert float(err.max()) <= 1e-4


@pytest.mark.parametrize("batch", list(BATCHES))
def test_select_restricts_to_lanes_bit_for_bit(batch):
    """LatentValueGrad.select(lanes) (any order, repeated lanes) evaluates
    the chosen lanes to the bits of the same lanes of the full batch."""
    new, _, u = _both(batch, "both")
    lanes = torch.tensor([4, 0, 2, 2])
    with torch.no_grad():
        full = new(u)
        part = new.select(lanes)(u.index_select(0, lanes))
    for a, b in zip(part, full):
        assert torch.equal(a, b.index_select(0, lanes))


def _inline_residuals(fn, u_flat):
    """ResidualFn.__call__ as it was before the latent rows were factored
    into ops/latent.py: every row inline."""
    cfg, dims = fn.cfg, fn.dims
    w = cfg.optimizer.weights
    s = dims.s
    u = u_flat.reshape(-1, dims.n_blocks, 2)
    poses = rollout_poses(fn.pose0, u, cfg.trajectorizer.time_step, fn.block_idx)
    new_pos = poses[:, 1:, 0:2]
    new_x, new_y, new_yaw = poses[:, 1:, 0], poses[:, 1:, 1], poses[:, 1:, 2]
    vw_steps = expand_blocks(u, fn.block_idx)
    v_steps = vw_steps[..., 0]
    agent_list = fused_iter.agent_list(fn.agents_steps)
    parts = []

    def add(r, mask):
        parts.append(torch.where(mask, r, torch.zeros_like(r)))

    add(cg.stepwise_critic(lambda px, py, pth, v: cg.social_work_grad(
        w.social_weight, px, py, pth, v, agent_list), new_x, new_y, new_yaw, v_steps),
        fn.social_mask)
    add(cg.stepwise_critic(lambda px, py, pth, v: cg.agent_angle_grad(
        w.agent_angle_weight, pth, fn.steer, fn.agent_active), new_x, new_y, new_yaw, v_steps),
        fn.social_mask)
    add(cg.stepwise_critic(lambda px, py, pth, v: cg.proxemics_grad(
        w.proxemics_weight, px, py, agent_list), new_x, new_y, new_yaw, v_steps), fn.social_mask)
    add(critics.velocity_cost(w.velocity_weight, cfg.optimizer.desired_linear_vel, v_steps,
                              fn.in_horizon), fn.step_mask)
    add(critics.goal_align_cost(w.goal_align_weight, fn.goal_yaw, new_yaw), fn.step_mask)
    add(critics.distance_cost(w.distance_weight, new_pos, fn.final_point), fn.step_mask)
    add(critics.distance_cost(w.angle_weight, new_pos, fn.ref_points), fn.step_mask)
    add(critics.obstacle_cost(w.obstacle_weight, poses[:, 1:], fn.win, fn.win_origin,
                              fn.resolution), fn.step_mask)
    if w.pure_angle_weight != 0.0:
        add(critics.angle_cost(w.pure_angle_weight, new_pos, new_yaw, fn.final_point),
            fn.step_mask)
    if w.curvature_weight != 0.0 and s >= 2:
        add(critics.curvature_cost(w.curvature_weight, w.curvature_max_angle, poses[:, :-2, 0:2],
                                   poses[:, 1:-1, 0:2], poses[:, 2:, 0:2]),
            fn.step_mask[:, 1:])
    vf = critics.velocity_feasibility_cost(w.velocity_feasibility_weight, u, dims.n_vf)
    parts.append(torch.where(fn.vf_mask, vf, torch.zeros_like(vf)))
    return torch.cat(parts, dim=1)


@pytest.mark.parametrize("weights", list(WEIGHTS))
def test_residual_fn_keeps_its_bits(weights):
    """ResidualFn with the latent rows from ops/latent.py gives the bits of
    its former inline form, residuals and every forward-mode Jacobian
    column, the still lane included."""
    args, u = _args("social", weights)
    fn = topt.build_residual_fn(*args)
    with fwad.dual_level():
        for i in range(u.shape[1]):
            tangent = torch.zeros_like(u)
            tangent[:, i] = 1.0
            got = fwad.unpack_dual(fn(fwad.make_dual(u, tangent)))
            want = fwad.unpack_dual(_inline_residuals(fn, fwad.make_dual(u, tangent)))
            for a, b in zip(got, want):
                assert torch.equal(a.view(torch.int64), b.view(torch.int64))


def test_latent_rows_broadcast_over_directions():
    """latent_rows on poses with a leading axis of directions (D, B, S+1, 3)
    against the same (B, S)-shaped final point and mask gives each
    direction's rows of the (B, S+1, 3) call bit for bit."""
    args, u = _args("social", "both")
    fn = topt.build_residual_fn(*args)
    w = args[0].optimizer.weights
    poses = rollout_poses(fn.pose0, u.reshape(-1, args[1].n_blocks, 2),
                          args[0].trajectorizer.time_step, fn.block_idx)
    alone = latent.latent_rows(w, poses, fn.final_point, fn.step_mask)
    tiled = latent.latent_rows(w, poses.expand(3, *poses.shape), fn.final_point, fn.step_mask)
    assert len(alone) == len(tiled) == 2
    for a, b in zip(alone, tiled):
        for d in range(3):
            assert torch.equal(b[d], a)
