"""The three people critics of the PyTorch port (social work, proxemics,
agent angle), their analytic per-step gradients and the 4-tangent duals
against the JAX package's ``costs/critics.py`` / ``costs/critic_grads.py`` on
identical NumPy inputs, in float64.

Tolerances: 1e-9 on values and closed-form gradients, 1e-8 on the
social-work gradients (a ~60-operation dual chain; the JAX package's own
test holds it to the same figure against autodiff)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nav2_social_mpc_controller_tpu.costs import critic_grads as jcg
from nav2_social_mpc_controller_tpu.costs import critics as jcritics
from nav2_social_mpc_controller_tpu.ops.fused_iter import agent_angle_precompute as jax_precompute
from nav2_social_mpc_controller_tpu_torch.costs import critic_grads as tcg
from nav2_social_mpc_controller_tpu_torch.costs import critics as tcritics
from nav2_social_mpc_controller_tpu_torch.ops import dual4 as d4
from nav2_social_mpc_controller_tpu_torch.ops.fused_iter import agent_angle_precompute
from nav2_social_mpc_controller_tpu_torch.ops.fused_iter import agent_list as _agent_list

torch.set_num_threads(1)

B, S = 2, 7


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _inputs(seed, n, case="random"):
    """px, py, yaw, v (B, S), pose0 (B, 3), agents (B, S, N, 6) as NumPy f64."""
    rng = np.random.default_rng(seed)
    px, py = rng.uniform(-2, 2, (2, B, S))
    yaw = rng.uniform(-3, 3, (B, S))
    v = rng.uniform(0, 0.6, (B, S))
    pose0 = np.concatenate([rng.uniform(-1, 1, (B, 2)), rng.uniform(-3, 3, (B, 1))], axis=1)
    agents = rng.uniform(-2, 2, (B, S, n, 6))
    agents[..., 4] = np.abs(agents[..., 4]) * 0.3
    agents[..., 3] = np.where(rng.uniform(size=(B, S, n)) < 0.7, 0.5, -1.0)
    if case == "no_valid":
        agents[..., 3] = -1.0
    elif case == "padding":  # what the SFM scan writes for an invalid slot
        agents[:, :, -1] = 0.0
        agents[:, :, -1, 3] = -1.0
    elif case == "on_robot":  # the `tiny` branch: an agent exactly on the robot
        agents[:, ::2, 0, 0] = px[:, ::2]
        agents[:, ::2, 0, 1] = py[:, ::2]
        agents[:, ::2, 0, 3] = 0.5
    elif case == "tie":  # two valid agents at exactly the same distance
        agents[..., 3] = 0.5
        agents[..., 0, 0], agents[..., 0, 1] = px + 0.5, py
        agents[..., n - 1, 0], agents[..., n - 1, 1] = px - 0.5, py
        if n > 2:
            agents[..., 1:-1, 0] += 10.0
    elif case == "static_closest":  # the closest agent does not move
        agents[..., 0, 0] = pose0[:, None, 0] + 0.1
        agents[..., 0, 1] = pose0[:, None, 1]
        agents[..., 0, 4] = 0.01
    return px, py, yaw, v, pose0, agents


def _jax_agent_list(agents):
    return [
        (agents[:, k, 0], agents[:, k, 1], agents[:, k, 2], agents[:, k, 4], agents[:, k, 3] != -1.0)
        for k in range(agents.shape[1])
    ]


CASES = [(1, "random"), (3, "random"), (6, "random"), (3, "no_valid"), (3, "padding"),
         (3, "on_robot"), (1, "on_robot"), (2, "tie"), (6, "tie"), (3, "static_closest")]


@pytest.mark.parametrize("n,case", CASES, ids=[f"N{n}-{c}" for n, c in CASES])
def test_people_critic_values_match_jax(n, case):
    px, py, yaw, v, pose0, agents = _inputs(10 + n, n, case)
    pos = np.stack([px, py], axis=-1)
    vw = np.stack([v, np.zeros_like(v)], axis=-1)
    w = 120.0

    ref = jax.vmap(lambda p, y, c, a: jcritics.social_work_cost(w, p, y, c, a))(
        *map(jnp.asarray, (pos, yaw, vw, agents)))
    got = tcritics.social_work_cost(w, _t(pos), _t(yaw), _t(vw), _t(agents))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-9, rtol=1e-9)

    ref = jax.vmap(lambda p, a: jcritics.proxemics_cost(90.0, p, a))(
        jnp.asarray(pos), jnp.asarray(agents))
    got = tcritics.proxemics_cost(90.0, _t(pos), _t(agents))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-9, rtol=1e-9)
    if case == "no_valid":
        assert (got == 0).all()

    ref = jax.vmap(lambda y, p0, a: jcritics.agent_angle_cost(40.0, y, p0, a))(
        *map(jnp.asarray, (yaw, pose0, agents)))
    got = tcritics.agent_angle_cost(40.0, _t(yaw), _t(pose0), _t(agents))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-9, rtol=1e-9)


@pytest.mark.parametrize("n,case", CASES, ids=[f"N{n}-{c}" for n, c in CASES])
def test_people_critic_grads_match_jax(n, case):
    """r and (gx, gy, gth, gv) of the three *_grad forms; the same None
    pattern for identically zero partials."""
    px, py, yaw, v, pose0, agents = _inputs(20 + n, n, case)
    tl = _agent_list(_t(agents))

    def compare(got, ref, atol):
        (r, g), (r_ref, g_ref) = got, ref
        np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), atol=atol, rtol=1e-9)
        for a, b_ in zip(g, g_ref):
            assert (a is None) == (b_ is None)
            if a is not None:
                np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=atol, rtol=1e-7)

    ref = jax.vmap(lambda x, y, th, vv, a: jcg.social_work_grad(120.0, x, y, th, vv, _jax_agent_list(a)))(
        *map(jnp.asarray, (px, py, yaw, v, agents)))
    got = tcg.social_work_grad(120.0, _t(px), _t(py), _t(yaw), _t(v), tl)
    compare(got, ref, 1e-8)
    assert torch.isfinite(got[0]).all() and all(torch.isfinite(t).all() for t in got[1][:4])

    ref = jax.vmap(lambda x, y, a: jcg.proxemics_grad(90.0, x, y, _jax_agent_list(a)))(
        *map(jnp.asarray, (px, py, agents)))
    got = tcg.proxemics_grad(90.0, _t(px), _t(py), tl)
    compare(got, ref, 1e-9)
    if case == "tie":  # the first agent (at +0.5 in x) wins: d/dx of exp(-sq/d0^2) is positive
        assert (got[1][0] > 0).all()
    if case == "no_valid":
        assert (got[0] == 0).all() and (got[1][0] == 0).all() and (got[1][1] == 0).all()

    steer_ref, active_ref = jax.vmap(jax_precompute)(jnp.asarray(pose0), jnp.asarray(agents))
    steer, active = agent_angle_precompute(_t(pose0), _t(agents))
    np.testing.assert_array_equal(active.numpy(), np.asarray(active_ref))
    np.testing.assert_allclose(steer.expand_as(active).numpy(), np.asarray(steer_ref), atol=1e-12)
    ref = jax.vmap(lambda th, st, ac: jcg.agent_angle_grad(40.0, th, st, ac))(
        jnp.asarray(yaw), steer_ref, active_ref)
    compare(tcg.agent_angle_grad(40.0, _t(yaw), steer, active), ref, 1e-9)


@pytest.mark.parametrize(
    "agent_yaw,agent_y,expect_active,steer_sign",
    [(np.pi, 0.5, True, -1.0), (np.pi, -0.5, False, -1.0), (0.0, -0.5, True, 1.0),
     (0.0, 0.5, False, 1.0), (-2.9, 0.5, True, -1.0), (0.4, -0.5, True, 1.0)],
    ids=["opposing-left", "opposing-right", "same-right", "same-left", "crossing-left",
         "below-threshold-right"],
)
def test_agent_angle_precompute_branches(agent_yaw, agent_y, expect_active, steer_sign):
    """One moving agent 1 m ahead of a robot at the origin, on either side,
    heading towards it or along with it: each branch of the selection."""
    agents = np.zeros((1, 3, 2, 6))
    agents[..., 3] = -1.0
    agents[:, :, 1] = [1.0, agent_y, agent_yaw, 0.0, 0.4, 0.0]
    agents[:, 2, 1, 0] = 5.0  # step 2: beyond the 2 m safe distance
    pose0 = np.zeros((1, 3))
    steer, active = agent_angle_precompute(_t(pose0), _t(agents))
    steer_ref, active_ref = jax.vmap(jax_precompute)(jnp.asarray(pose0), jnp.asarray(agents))
    np.testing.assert_array_equal(active.numpy(), np.asarray(active_ref))
    np.testing.assert_allclose(steer.expand_as(active).numpy(), np.asarray(steer_ref), atol=1e-12)
    assert active[0].tolist() == [expect_active, expect_active, False]
    np.testing.assert_allclose(steer.expand_as(active)[0, 0].item(), steer_sign * np.pi / 6)


def test_dual4_rules_match_forward_mode_autodiff():
    """Every dual4 rule, through one expression that uses them all, against
    torch.func.jvp along each of the four basis directions; symbolic zeros
    (None) stay symbolic until an op makes them dense."""
    rng = np.random.default_rng(0)
    x, y, yaw, v = (_t(rng.uniform(0.3, 1.5, 5)) for _ in range(4))

    def plain(x, y, yaw, v):
        r = torch.sqrt(x * x + y * y)
        q = (v * torch.cos(yaw) - 2.0 * torch.sin(yaw)) / r
        big = torch.where(r > 1.0, q, -q * 3.0)
        return torch.exp(-(big + torch.atan2(y, x))) + (x - 0.25)

    def dual(x, y, yaw, v):
        dx, dy, dyaw, dv = (d4.seed(p, k) for k, p in enumerate((x, y, yaw, v)))
        r = d4.sqrt_(d4.add(d4.mul(dx, dx), d4.mul(dy, dy)))
        q = d4.div(d4.sub(d4.mul(dv, d4.cos(dyaw)), d4.scale(d4.sin(dyaw), 2.0)), r)
        big = d4.where(r[0] > 1.0, q, d4.scale(d4.neg(q), 3.0))
        return d4.add(d4.exp(d4.neg(d4.add(big, d4.atan2(dy, dx)))),
                      d4.sub(dx, d4.const(torch.full_like(x, 0.25))))

    out = dual(x, y, yaw, v)
    np.testing.assert_allclose(out[0].numpy(), plain(x, y, yaw, v).numpy(), rtol=1e-14)
    for k in range(4):
        tang = tuple(torch.ones_like(x) if j == k else torch.zeros_like(x) for j in range(4))
        _, ref = torch.func.jvp(plain, (x, y, yaw, v), tang)
        np.testing.assert_allclose(d4.tangents(out)[k].numpy(), ref.numpy(), rtol=1e-12, atol=1e-14)

    assert d4.const(x)[1] == (None,) * 4
    sparse = d4.mul(d4.seed(x, 0), d4.const(y))
    assert [t is None for t in sparse[1]] == [False, True, True, True]
    dense = d4.where(x > 1.0, d4.seed(x, 0), d4.seed(y, 1))
    assert [t is None for t in dense[1]] == [False, False, True, True]
    assert all((t == 0).all() for t in d4.tangents(d4.const(x)))
