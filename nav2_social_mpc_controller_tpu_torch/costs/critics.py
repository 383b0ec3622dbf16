"""The people-free critic set as vectorised residuals over the shared
horizon rollout (batched: a leading scenario axis B, then the step axis S).

Reference mapping (SURVEY.md section 2.2; residuals are scalar per step and
pre-multiplied by their weight, so the solver cost is 0.5*sum(r^2)):

  distance_cost        <- critics/distance_cost_function.hpp:117-132
                          w * ||p_{i+1} - target||^4. Role A "path follow"
                          (target = final trajectorized point), role B "path
                          align" (target = per-step ref point i+1, weight =
                          angle_weight) — optimizer.cpp:330-334.
  obstacle_cost        <- critics/obstacle_cost_function.hpp:137-167
                          w * BiCubic(costmap)(front point), front = pose +
                          0.25 m along heading ("size of jackal").
  velocity_cost        <- critics/velocity_cost_function.hpp:89-99
  goal_align_cost      <- critics/goal_align_cost_function.hpp:100-116
  velocity_feasibility <- critics/velocity_feasibility_cost_function.hpp:86-98

social_work, proxemics and agent_angle arrive with the people path.
"""

import torch

from nav2_social_mpc_controller_tpu_torch.utils.angles import wrap_atan2
from nav2_social_mpc_controller_tpu_torch.world.grid import sample_costmap

FRONT_OFFSET = 0.25  # "considering size of jackal", obstacle_cost_function.hpp:152

# SFM constants hardcoded in the SocialWorkCost ctor
# (social_work_cost_function.cpp:38-43)
SW_LAMBDA = 2.0
SW_GAMMA = 0.35
SW_NPRIME = 3.0
SW_N = 2.0
SW_FORCE_FACTOR_SOCIAL = 2.1

# ProxemicsCost ctor constants (proxemics_cost_function.cpp:37-38)
PROXEMICS_ALPHA = 3.0
PROXEMICS_D0 = 0.5

# AgentAngleCost ctor constants (agent_angle_cost_function.cpp:31 + hpp:159-164)
AGENT_ANGLE_SAFE_DIST_SQ = 4.0
AGENT_ANGLE_MIN_SPEED = 0.05
AGENT_ANGLE_THRESHOLD = 0.5235987755982988  # pi / 6
AGENT_ANGLE_UPPER_THRESHOLD = 2.6179938779914944  # 5 pi / 6


def distance_cost(weight, pos, target):
    """w * ||pos - target||^4. pos (B, S, 2); target (B, 1, 2) or (B, S, 2)."""
    sq = ((pos - target) ** 2).sum(-1)
    return weight * sq * sq


def obstacle_cost(weight, poses, costmap_data, costmap_origin, costmap_resolution):
    """w * bicubic(costmap) at the front point of each pose. poses (B, S, 3)."""
    heading = torch.stack([torch.cos(poses[..., 2]), torch.sin(poses[..., 2])], dim=-1)
    front = poses[..., 0:2] + FRONT_OFFSET * heading
    return weight * sample_costmap(costmap_data, costmap_origin, costmap_resolution, front)


def velocity_cost(weight, desired_linear_vel, v_step, in_horizon):
    """w * (v_des - v_block(i))^2 while i < control_horizon, else 0.
    v_step (B, S); in_horizon (B, S) bool."""
    d = desired_linear_vel - v_step
    return torch.where(in_horizon, weight * d * d, torch.zeros_like(d))


def goal_align_cost(weight, goal_yaw, new_yaw):
    """w * wrap(goal_heading - theta_{i+1})^2. goal_yaw (B, 1); new_yaw (B, S)."""
    t = wrap_atan2(goal_yaw - new_yaw)
    return weight * t * t


def velocity_feasibility_cost(weight, u, n_pairs: int):
    """w*(v_b - v_{b-1})^2 + w*(w_b - w_{b-1})^2 between consecutive blocks
    b = 1..n_pairs (added for 0 < i < control_horizon/block_length,
    optimizer.cpp:364-370). u (B, NB, 2) -> (B, n_pairs)."""
    if n_pairs <= 0:
        return u.new_zeros((u.shape[0], 0))
    d = u[:, 1 : n_pairs + 1] - u[:, 0:n_pairs]
    return weight * (d * d).sum(-1)
