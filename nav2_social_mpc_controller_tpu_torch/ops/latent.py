"""The latent critics' rows and the evaluation of a config that has them.

The residual vector of a config with latent critics (pure_angle_weight /
curvature_weight non-zero) is the benchmark critic set's rows plus S pure
angle rows and S - 1 curvature rows (``latent_rows``). cost = 1/2 ||r||^2,
g = J^T r and J^T J are sums over rows, so its evaluation is the fused one
(ops/fused_iter.py: the rollout-sample kernel, then K2) plus the same three
sums over the latent rows alone. Those rows read u only through the rollout
poses, which the rollout-sample kernel returns with their sensitivities to
u: the latent term runs no second rollout and samples no costmap.

Its Jacobian columns come from forward-mode differentiation of
``latent_rows``, all D directions in one pass: the poses are tiled D times
(D x B lanes) and direction d's tangent is row d of the sensitivities —
for v_b (dx/dv_b, dy/dv_b, 0), for w_b (dx/dw_b, dy/dw_b, dtheta/dw_b) —
with pose 0 a constant. The rows' formulas are those of the residual path
(controller/optimize.py: ResidualFn), tangents included: at a stationary
step the curvature row's tangent goes through sqrt at 0 and the 1e-30 clamp
of ``critics.curvature_cost`` and comes out near 1e30 (J^T J overflows to
inf in float32) on both.
"""

import torch
import torch.autograd.forward_ad as fwad

from nav2_social_mpc_controller_tpu_torch.costs import critics
from nav2_social_mpc_controller_tpu_torch.ops.fused_iter import ValueGrad, fused_cost_g_jtj


def latent_rows(weights, poses, final_point, step_mask):
    """The latent critics' residual rows, masked: [pure angle (..., S)] when
    pure_angle_weight != 0, then [curvature (..., S - 1)] when
    curvature_weight != 0 and S >= 2 (triplet i reads poses i, i+1, i+2 and
    is valid while step i+1 is; pose 0 is the fixed start).

    weights: core.config.CriticWeights; poses (..., S+1, 3); final_point
    (..., 1, 2) or broadcastable to it; step_mask (..., S) bool. Returns a
    list of the rows' tensors (possibly empty)."""
    rows = []

    def add(r, mask):
        rows.append(torch.where(mask, r, torch.zeros_like(r)))

    s = step_mask.shape[-1]
    if weights.pure_angle_weight != 0.0:
        add(
            critics.angle_cost(weights.pure_angle_weight, poses[..., 1:, 0:2], poses[..., 1:, 2],
                               final_point),
            step_mask,
        )
    if weights.curvature_weight != 0.0 and s >= 2:
        add(
            critics.curvature_cost(
                weights.curvature_weight, weights.curvature_max_angle,
                poses[..., :-2, 0:2], poses[..., 1:-1, 0:2], poses[..., 2:, 0:2],
            ),
            step_mask[..., 1:],
        )
    return rows


def latent_cost_g_jtj(weights, pose0, px, py, pth, dxdv, dydv, dxdw, dydw, dth, final_point,
                      step_mask):
    """cost = 1/2 sum r^2, g = J^T r and J^T J over the latent rows alone.

    pose0 (B, 3); px, py, pth (B, S), the poses after each step; dxdv,
    dydv, dxdw, dydw, dth (B, NB, S) their sensitivities (views with any
    batch stride); final_point (B, 1, 2); step_mask (B, S) bool. Returns
    (cost (B,), g (B, D), jtj (B, D, D)) with D = 2 NB in u's order [v0, w0,
    v1, w1, ...]. The contractions are products summed over the rows in the
    inputs' dtype, never a matrix product (a library's choice of kernel, and
    with it the order of a scenario's sums, may change with the batch width;
    this reduction's does not, so a scenario evaluates to the same bits at
    every width, as in every kernel of the evaluation). J^T J comes out
    exactly symmetric."""
    b, nb, s = dth.shape
    d = 2 * nb
    poses = torch.cat([pose0[:, None, :], torch.stack([px, py, pth], dim=-1)], dim=1)

    def by_direction(dv, dw):  # (B, NB, S) x2 -> (D, B, S), d = 2 b + [0 for v, 1 for w]
        return torch.stack([dv, dw], dim=2).reshape(b, d, s).transpose(0, 1)

    tangent = torch.stack([by_direction(dxdv, dxdw), by_direction(dydv, dydw),
                           by_direction(torch.zeros_like(dth), dth)], dim=-1)
    tangent = torch.cat([tangent.new_zeros((d, b, 1, 3)), tangent], dim=2)  # pose 0: constant
    with fwad.dual_level():
        dual = fwad.make_dual(poses.expand(d, b, s + 1, 3).contiguous(), tangent)
        parts = [fwad.unpack_dual(r) for r in latent_rows(weights, dual, final_point, step_mask)]
    r = torch.cat([p.primal[0] for p in parts], dim=1)  # (B, R), the same in every direction
    jac_t = torch.cat([p.tangent for p in parts], dim=2).transpose(0, 1).contiguous()  # (B, D, R)
    cost = 0.5 * (r * r).sum(1)
    g = (jac_t * r[:, None, :]).sum(2)
    jtj = (jac_t[:, :, None, :] * jac_t[:, None, :, :]).sum(3)
    return cost, g, jtj


class LatentValueGrad(ValueGrad):
    """value_grad(u) -> (cost, g, jtj) of a config with latent critics: the
    fused evaluation (one rollout-sample launch, one K2 launch) plus
    ``latent_cost_g_jtj`` on the same rollout. Same constructor as
    ValueGrad; ``select`` (ValueGrad's) gathers the latent term's
    per-scenario data too, which is ValueGrad's own: the final point is
    ``scal``'s first two columns and the step mask ``m_step``."""

    def __init__(self, cfg, dims, rows, n_rows, people_proj, present, costmap):
        super().__init__(cfg, dims, rows, n_rows, people_proj, present, costmap)
        self.weights = cfg.optimizer.weights

    def __call__(self, u):
        args = self.fused_inputs(u)
        cost, g, jtj = fused_cost_g_jtj(*args)
        c_lat, g_lat, jtj_lat = latent_cost_g_jtj(*self.latent_inputs(args))
        return cost + c_lat, g + g_lat, jtj + jtj_lat

    def latent_inputs(self, fused_args):
        """latent_cost_g_jtj's arguments from K2's argument tuple
        (fused_inputs): the rollout's poses and sensitivities."""
        _, _, px, py, pth, _, dxdv, dydv, dxdw, dydw, dth = fused_args[:11]
        return (self.weights, self.pose0, px, py, pth, dxdv, dydv, dxdw, dydw, dth,
                self.scal[:, None, 0:2], self.m_step)
