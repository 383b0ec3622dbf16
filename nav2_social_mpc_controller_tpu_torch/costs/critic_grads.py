"""Analytic per-step residuals AND gradients of the people-free critics.

Every critic is DIAGONAL in the rollout step axis (residual s depends only
on step s's pose/controls), so its Jacobian contribution is fully described
by the per-step partials w.r.t. the 5 step inputs (x, y, yaw, v, w). The
fused iteration (ops/fused_iter.py) chain-contracts these against the
rollout sensitivities to build J^T r and J^T J without building J.

Plain elementwise functions over tensors of any matching shape. Each
returns (r, (gx, gy, gth, gv, gw)) with None for identically zero partials.
Reference citations are in costs/critics.py. social_work, proxemics and
agent_angle arrive with the people path.
"""

import torch

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
