"""Analytic per-step residuals AND gradients for the fused LM iteration.

Every critic is DIAGONAL in the rollout step axis (residual s depends only
on step s's pose/controls), so its Jacobian contribution is fully described
by the per-step partials w.r.t. the 5 step inputs (x, y, yaw, v, w). The
fused iteration (ops/fused_iter.py) chain-contracts these against the
rollout sensitivities to build J^T r and J^T J without building J. The
gradients are closed forms (polynomial/trig critics) or a mechanical
4-tangent forward pass (the social-work Moussaid chain, ops/dual4.py).

Plain elementwise functions over tensors of any matching shape; agents are a
list of per-agent field tuples (ax, ay, ayaw, alv, avalid). Each function
returns (r, (gx, gy, gth, gv, gw)) with None for identically zero partials.
Reference citations are in costs/critics.py. Angles wrap by
atan2(sin, cos) everywhere.

``stepwise_critic`` turns such a function into a differentiable per-step
critic for the autodiff residual path (controller/optimize.py:
build_residual_fn): its derivative rule IS these per-step partials.
"""

import torch

from nav2_social_mpc_controller_tpu_torch.costs.critics import (
    PROXEMICS_ALPHA,
    PROXEMICS_D0,
    SW_FORCE_FACTOR_SOCIAL,
    SW_GAMMA,
    SW_LAMBDA,
    SW_N,
    SW_NPRIME,
)
from nav2_social_mpc_controller_tpu_torch.ops import dual4 as d4
from nav2_social_mpc_controller_tpu_torch.utils.angles import wrap_atan2


def distance_grad(weight, px, py, tx, ty):
    """w * ||p - t||^4 (critics.distance_cost). t constant per step."""
    dx = px - tx
    dy = py - ty
    sq = dx * dx + dy * dy
    r = weight * sq * sq
    c = 4.0 * weight * sq
    return r, (c * dx, c * dy, None, None, None)


def velocity_grad(weight, desired, v, in_horizon):
    """w * (v_des - v)^2 gated by in_horizon (critics.velocity_cost)."""
    diff = desired - v
    zero = torch.zeros_like(diff)
    r = torch.where(in_horizon, weight * diff * diff, zero)
    gv = torch.where(in_horizon, -2.0 * weight * diff, zero)
    return r, (None, None, None, gv, None)


def goal_align_grad(weight, goal_yaw, yaw):
    """w * wrap(goal_yaw - yaw)^2 (critics.goal_align_cost); wrap' = 1."""
    t = wrap_atan2(goal_yaw - yaw)
    return weight * t * t, (None, None, -2.0 * weight * t, None, None)


def agent_angle_grad(weight, yaw, steer, active):
    """Social-norm steering with the agent-selection branch PRECOMPUTED:
    steer/active depend only on the projected agents and pose_0 — both
    u-independent — so the per-iteration work collapses to
    active * w * wrap(yaw - steer)^2 (critics.agent_angle_cost)."""
    ang = wrap_atan2(yaw - steer)
    zero = torch.zeros_like(ang)
    r = torch.where(active, weight * ang * ang, zero)
    gth = torch.where(active, 2.0 * weight * ang, zero)
    return r, (None, None, gth, None, None)


def proxemics_grad(weight, px, py, agents):
    """w * alpha * exp(-min_valid_dist^2 / d0^2) (critics.proxemics_cost).

    First-minimum selection (a strict `<` scan) matches the minimum over
    where(valid, sq, inf); with no valid agent the exp underflows to 0 and
    the gradient is forced to 0."""
    inf = torch.full_like(px, float("inf"))
    zero = torch.zeros_like(px)
    best_sq = best_dx = best_dy = any_valid = None
    for ax, ay, _ayaw, _alv, avalid in agents:
        dx = px - ax
        dy = py - ay
        sq = torch.where(avalid, dx * dx + dy * dy, inf)
        if best_sq is None:
            best_sq, best_dx, best_dy = sq, dx, dy
            any_valid = avalid
        else:
            take = sq < best_sq  # strict: first minimum wins ties
            best_dx = torch.where(take, dx, best_dx)
            best_dy = torch.where(take, dy, best_dy)
            best_sq = torch.where(take, sq, best_sq)
            any_valid = any_valid | avalid
    inv_d0sq = 1.0 / (PROXEMICS_D0 * PROXEMICS_D0)
    r = torch.where(any_valid, weight * PROXEMICS_ALPHA * torch.exp(-best_sq * inv_d0sq), zero)
    c = -2.0 * inv_d0sq * r
    gx = torch.where(any_valid, c * best_dx, zero)
    gy = torch.where(any_valid, c * best_dy, zero)
    return r, (gx, gy, None, None, None)


def obstacle_grad(weight, val, drow, dcol, yaw, inv_res, front_offset):
    """w * bicubic(costmap)(front point), with the bicubic value and its
    row/col derivatives ALREADY computed (kernel K1 owns that part).
    front = p + off*(cos yaw, sin yaw); row = (fy-oy)/res, col = (fx-ox)/res,
    so the chain to (x, y, yaw) is elementwise."""
    r = weight * val
    gx = weight * dcol * inv_res
    gy = weight * drow * inv_res
    gth = weight * (
        dcol * (-front_offset * torch.sin(yaw) * inv_res)
        + drow * (front_offset * torch.cos(yaw) * inv_res)
    )
    return r, (gx, gy, gth, None, None)


def _social_pair_force(mx, my, mvx, mvy, ox, oy, ovx, ovy):
    """Dual transcription of SocialWorkCost::computeSocialForce for ONE
    (me <- other) pair (social_work_cost_function.hpp:164-228, mirrored from
    critics._critic_social_force). All 8 args are dual4 values; returns
    (fx, fy) duals."""
    dx = d4.sub(mx, ox)
    dy = d4.sub(my, oy)
    dnorm = d4.sqrt_(d4.add(d4.mul(dx, dx), d4.mul(dy, dy)))
    tiny = dnorm[0] < 1e-6
    z = d4.const(torch.zeros_like(dnorm[0]))
    eps = d4.const(torch.full_like(dnorm[0], 1e-6))
    # An agent exactly on the robot has dnorm = 0 and NaN sqrt tangents; the
    # selects below replace them by the constants' (dense) zeros.
    dx = d4.where(tiny, eps, dx)
    dy = d4.where(tiny, z, dy)
    dnorm = d4.where(tiny, eps, dnorm)
    ddx = d4.div(dx, dnorm)
    ddy = d4.div(dy, dnorm)

    ix = d4.add(d4.scale(d4.sub(mvx, ovx), SW_LAMBDA), ddx)
    iy = d4.add(d4.scale(d4.sub(mvy, ovy), SW_LAMBDA), ddy)
    ilen = d4.sqrt_(d4.add(d4.mul(ix, ix), d4.mul(iy, iy)))
    # maximum(ilen, 1e-30): the tangent follows the larger branch, as autodiff
    # does. An interaction vector of exactly zero length (a velocity
    # difference that cancels the unit direction) takes the floor; its
    # direction is then (0, 0) and the atan2 tangent below divides 0 by 0:
    # NaN partials, in the JAX package as here.
    floor = d4.const(torch.full_like(ilen[0], 1e-30))
    ilen = d4.where(ilen[0] > 1e-30, ilen, floor)
    idx = d4.div(ix, ilen)
    idy = d4.div(iy, ilen)

    # theta = wrap(atan2(dd) - atan2(id)); wrap' = 1.
    theta_raw = d4.sub(d4.atan2(ddy, ddx), d4.atan2(idy, idx))
    theta = (wrap_atan2(theta_raw[0]), theta_raw[1])

    b = d4.scale(ilen, SW_GAMMA)
    d_over_b = d4.div(dnorm, b)
    bt = d4.mul(b, theta)
    e_vel = d4.exp(d4.neg(d4.add(d_over_b, d4.mul(d4.scale(bt, SW_NPRIME), d4.scale(bt, SW_NPRIME)))))
    fvel = d4.neg(e_vel)
    one = torch.ones_like(theta[0])
    sign = torch.where(theta[0] > 0.0, one, -one)  # no zero case (hpp:168)
    e_ang = d4.exp(d4.neg(d4.add(d_over_b, d4.mul(d4.scale(bt, SW_N), d4.scale(bt, SW_N)))))
    fang = d4.scale(e_ang, -1.0)
    fang = (fang[0] * sign, tuple(None if t is None else t * sign for t in fang[1]))

    lnx = d4.neg(idy)
    lny = idx
    fx = d4.scale(d4.add(d4.mul(fvel, idx), d4.mul(fang, lnx)), SW_FORCE_FACTOR_SOCIAL)
    fy = d4.scale(d4.add(d4.mul(fvel, idy), d4.mul(fang, lny)), SW_FORCE_FACTOR_SOCIAL)
    return fx, fy


def social_work_grad(weight, px, py, yaw, v, agents):
    """w * (||SF(robot <- agents)||^2 + sum_j ||SF(agent_j <- robot)||^2
    + 1e-6)  (critics.social_work_cost), with its per-step gradient w.r.t.
    (x, y, yaw, v) from a 4-tangent dual forward pass. w (angular) never
    enters. The phantom-agent quirk (invalid slots still FEEL force from the
    robot) is preserved."""
    dpx = d4.seed(px, 0)
    dpy = d4.seed(py, 1)
    dyaw = d4.seed(yaw, 2)
    dv = d4.seed(v, 3)
    rvx = d4.mul(dv, d4.cos(dyaw))
    rvy = d4.mul(dv, d4.sin(dyaw))

    zero = torch.zeros_like(px)

    # wr: force on the robot from each VALID agent, summed then squared.
    sfx = d4.const(zero)
    sfy = d4.const(zero)
    for ax, ay, ayaw, alv, avalid in agents:
        avx = d4.const(alv * torch.cos(ayaw))
        avy = d4.const(alv * torch.sin(ayaw))
        fx, fy = _social_pair_force(dpx, dpy, rvx, rvy, d4.const(ax), d4.const(ay), avx, avy)
        zd = d4.const(zero)
        sfx = d4.add(sfx, d4.where(avalid, fx, zd))
        sfy = d4.add(sfy, d4.where(avalid, fy, zd))
    wr = d4.add(d4.mul(sfx, sfx), d4.mul(sfy, sfy))

    # wp: force on EVERY agent slot (valid or not) from the robot alone.
    wp = d4.const(zero)
    for ax, ay, ayaw, alv, _avalid in agents:
        amvx = d4.const(alv * torch.cos(ayaw))
        amvy = d4.const(alv * torch.sin(ayaw))
        fx, fy = _social_pair_force(d4.const(ax), d4.const(ay), amvx, amvy, dpx, dpy, rvx, rvy)
        wp = d4.add(wp, d4.add(d4.mul(fx, fx), d4.mul(fy, fy)))

    total = d4.scale(d4.add(d4.add(wr, wp), d4.const(torch.full_like(px, 1e-6))), weight)
    gx, gy, gth, gv = d4.tangents(total)
    return total[0], (gx, gy, gth, gv, None)


class _StepwiseCritic(torch.autograd.Function):
    """r = fn(x, y, yaw, v)[0] with fn's exact per-step partials as its
    derivative rule: tangent_out = gx*tx + gy*ty + gth*tth + gv*tv. What the
    JAX package's one-reverse-pass stepwise JVP (costs/critics.py there)
    amounts to, without differentiating through the where-masked chains whose
    untaken branches hold NaN (an agent exactly on the robot)."""

    @staticmethod
    def forward(fn, px, py, pth, v):
        r, grads = fn(px, py, pth, v)
        return (r, *(torch.zeros_like(r) if t is None else t for t in grads[:4]))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(*output[1:])
        ctx.save_for_forward(*output[1:])
        ctx.save_for_backward(*output[1:])

    @staticmethod
    def jvp(ctx, _fn, *tangents):
        t_out = None
        for grad, t in zip(ctx.saved_tensors, tangents):
            if t is not None:
                t_out = grad * t if t_out is None else t_out + grad * t
        return (t_out, None, None, None, None)

    @staticmethod
    def backward(ctx, grad_r, *_unused):
        return (None, *(grad_r * grad for grad in ctx.saved_tensors))


def stepwise_critic(fn, px, py, pth, v):
    """Differentiable per-step critic from fn(px, py, pth, v) ->
    (r, (gx, gy, gth, gv, gw)), one of this module's *_grad functions with
    its constants bound. All inputs (B, S); returns r (B, S)."""
    return _StepwiseCritic.apply(fn, px, py, pth, v)[0]
