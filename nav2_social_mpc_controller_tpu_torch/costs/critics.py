"""The critic library as vectorised residuals over the shared horizon
rollout (batched: a leading scenario axis B, then the step axis S).

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
  social_work_cost     <- critics/social_work_cost_function.hpp:102-228
  proxemics_cost       <- critics/proxemics_cost_function.hpp:83-151
                          w * 3.0 * exp(-min_dist^2 / 0.5^2)
  agent_angle_cost     <- critics/agent_angle_cost_function.hpp:125-195
  velocity_cost        <- critics/velocity_cost_function.hpp:89-99
  goal_align_cost      <- critics/goal_align_cost_function.hpp:100-116
  velocity_feasibility <- critics/velocity_feasibility_cost_function.hpp:86-98
  angle_cost           <- critics/angle_cost_function.hpp:94-108 (latent:
                          compiled but never instantiated by the reference
                          optimizer; available behind pure_angle_weight)
  curvature_cost       <- critics/curvature_cost_function.hpp:65-87 (latent,
                          behind curvature_weight)

The three people critics read the projected agents (B, S, N, 6) at step i+1
(models/sfm.py); an agent slot is valid when its t column is not -1.
Conditional logic is masked arithmetic with identical branch outcomes.
"""

import math

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
    """w * bicubic(costmap) at the front point of each pose. poses (B, S, 3).
    Differentiable in the poses (world/grid.py: sample_costmap)."""
    heading = torch.stack([torch.cos(poses[..., 2]), torch.sin(poses[..., 2])], dim=-1)
    front = poses[..., 0:2] + FRONT_OFFSET * heading
    return weight * sample_costmap(costmap_data, costmap_origin, costmap_resolution, front)


def _critic_social_force(me_pos, me_vel, agents_pos, agents_vel, agents_valid):
    """SocialWorkCost::computeSocialForce (social_work_cost_function.hpp:164-228).

    Differs deliberately from models.sfm's pairwise social force: the guard
    replaces a < 1e-6 POSITION diff by (1e-6, 0), and sign(theta) has no zero
    case (theta > 0 ? 1 : -1).

    me_pos / me_vel (..., 2); agents_* (..., N, 2); agents_valid (..., N).
    Returns (..., 2), the summed force on `me`."""
    diff = me_pos[..., None, :] - agents_pos
    dnorm = torch.sqrt((diff * diff).sum(-1))
    tiny = dnorm < 1e-6
    eps_vec = torch.tensor([1e-6, 0.0], dtype=diff.dtype, device=diff.device)
    diff = torch.where(tiny[..., None], eps_vec.expand_as(diff), diff)
    dnorm = torch.where(tiny, torch.full_like(dnorm, 1e-6), dnorm)
    diff_dir = diff / dnorm[..., None]

    vel_diff = me_vel[..., None, :] - agents_vel
    interaction = SW_LAMBDA * vel_diff + diff_dir
    ilen = torch.sqrt((interaction * interaction).sum(-1))
    ilen = ilen.clamp(min=1e-30)  # the reference divides unguarded
    idir = interaction / ilen[..., None]

    theta = wrap_atan2(
        torch.atan2(diff_dir[..., 1], diff_dir[..., 0]) - torch.atan2(idir[..., 1], idir[..., 0])
    )
    b = SW_GAMMA * ilen
    fvel_amt = -torch.exp(-dnorm / b - (SW_NPRIME * b * theta) ** 2)
    one = torch.ones_like(theta)
    sign = torch.where(theta > 0.0, one, -one)
    fang_amt = -sign * torch.exp(-dnorm / b - (SW_N * b * theta) ** 2)

    left_normal = torch.stack([-idir[..., 1], idir[..., 0]], dim=-1)
    pair = SW_FORCE_FACTOR_SOCIAL * (fvel_amt[..., None] * idir + fang_amt[..., None] * left_normal)
    return torch.where(agents_valid[..., None], pair, torch.zeros_like(pair)).sum(-2)


def _heading_vel(yaw, lv):
    return torch.stack([lv * torch.cos(yaw), lv * torch.sin(yaw)], dim=-1)


def social_work_cost(weight, robot_pos, robot_yaw, robot_vw, agents):
    """w * (||SF(robot <- agents)||^2 + sum_j ||SF(agent_j <- robot)||^2 + 1e-6).

    robot_pos (B, S, 2) = poses[:, 1:, 0:2]; robot_yaw (B, S); robot_vw
    (B, S, 2) block-expanded controls; agents (B, S, N, 6).

    Faithful quirk: the per-agent term iterates ALL agent slots including
    invalid (t = -1) padding rows — computeSocialForce never checks `me`'s
    own validity (social_work_cost_function.hpp:135-146) — so phantom agents
    at the origin DO feel force from the robot."""
    a_pos = agents[..., 0:2]
    a_vel = _heading_vel(agents[..., 2], agents[..., 4])
    a_valid = agents[..., 3] != -1.0
    r_vel = _heading_vel(robot_yaw, robot_vw[..., 0])

    sf_robot = _critic_social_force(robot_pos, r_vel, a_pos, a_vel, a_valid)
    wr = (sf_robot**2).sum(-1)

    # Force on each agent slot from the robot alone (the robot_agent matrix
    # has only the robot valid, hpp:140-144).
    sf_agents = _critic_social_force(
        a_pos,
        a_vel,
        robot_pos[..., None, None, :].expand(*a_pos.shape[:-1], 1, 2),
        r_vel[..., None, None, :].expand(*a_pos.shape[:-1], 1, 2),
        torch.ones((*a_pos.shape[:-1], 1), dtype=torch.bool, device=a_pos.device),
    )
    wp = (sf_agents**2).sum(-1).sum(-1)
    return weight * (wr + wp + 1e-6)


def proxemics_cost(weight, robot_pos, agents):
    """w * alpha * exp(-min_valid_dist^2 / d0^2). robot_pos (B, S, 2); agents
    (B, S, N, 6). With no valid agent the minimum stays +inf and the residual
    underflows to 0, as the reference's numeric_limits<double>::max()
    initialisation does."""
    a_valid = agents[..., 3] != -1.0
    sq = ((robot_pos[..., None, :] - agents[..., 0:2]) ** 2).sum(-1)
    min_sq = torch.where(a_valid, sq, torch.full_like(sq, float("inf"))).min(dim=-1).values
    return weight * PROXEMICS_ALPHA * torch.exp(-min_sq / (PROXEMICS_D0 * PROXEMICS_D0))


def agent_angle_select(robot_init_pose, agents):
    """The agent-selection head of the agent-angle critic, which depends only
    on pose_0 and the projected agents: closest MOVING (lv > 0.05) agent by
    distance to pose_0; nothing close (d^2 > 4) -> inactive; agent heading
    roughly opposing/crossing (diff <= -5pi/6 or >= pi/6): agent on the left
    -> steer right (yaw_0 - pi/6), agent already right -> inactive; otherwise
    mirrored. The first minimum wins ties (the reference's `<` scan).

    robot_init_pose (B, 3); agents (B, S, N, 6). Returns (steer (B, S),
    active (B, S) bool)."""
    x0, y0, yaw0 = (robot_init_pose[:, k, None] for k in range(3))
    moving = agents[..., 4] > AGENT_ANGLE_MIN_SPEED
    dx = agents[..., 0] - x0[..., None]
    dy = agents[..., 1] - y0[..., None]
    dist_sq = dx * dx + dy * dy
    masked = torch.where(moving, dist_sq, torch.full_like(dist_sq, float("inf")))
    closest_sq = masked.min(dim=-1).values
    ci = masked.argmin(dim=-1)  # the first minimum, as torch documents
    has_agent = torch.isfinite(closest_sq) & (closest_sq <= AGENT_ANGLE_SAFE_DIST_SQ)

    ag = torch.gather(agents, 2, ci[..., None, None].expand(-1, -1, 1, agents.shape[-1]))[:, :, 0]
    agent_angle_initial = torch.atan2(ag[..., 1] - y0, ag[..., 0] - x0)
    heading_diff = wrap_atan2(ag[..., 2] - yaw0)
    side = wrap_atan2(agent_angle_initial - yaw0)

    opposing = (heading_diff <= -AGENT_ANGLE_UPPER_THRESHOLD) | (
        heading_diff >= AGENT_ANGLE_THRESHOLD
    )
    # opposing: active when the agent is on the left (side >= 0), steer right;
    # same direction: active when it is on the right (side <= 0), steer left.
    active = has_agent & torch.where(opposing, side >= 0.0, side <= 0.0)
    steer = torch.where(opposing, yaw0 - AGENT_ANGLE_THRESHOLD, yaw0 + AGENT_ANGLE_THRESHOLD)
    return steer, active


def agent_angle_cost(weight, new_yaw, robot_init_pose, agents):
    """Social-norm steering critic: active * w * wrap(new_yaw - steer)^2.
    new_yaw (B, S) = poses[:, 1:, 2]; robot_init_pose (B, 3); agents
    (B, S, N, 6)."""
    steer, active = agent_angle_select(robot_init_pose, agents)
    ang = wrap_atan2(new_yaw - steer)
    return torch.where(active, weight * ang * ang, torch.zeros_like(ang))


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


def angle_cost(weight, pos, yaw, target):
    """Latent AngleCost: face toward target. pos (B, S, 2); yaw (B, S);
    target (B, 1, 2) or (B, S, 2)."""
    d = target - pos
    point_heading = torch.atan2(d[..., 1], d[..., 0])
    diff = point_heading - wrap_atan2(yaw)
    return weight * diff * diff


def curvature_cost(weight, max_angle, p1, p2, p3):
    """Latent CurvatureCost among three consecutive points, each (B, S, 2);
    zero inside [pi - a, pi + a]."""
    v1 = p2 - p1
    v2 = p2 - p3
    dot = (v1 * v2).sum(-1)
    n1 = torch.sqrt((v1 * v1).sum(-1))
    n2 = torch.sqrt((v2 * v2).sum(-1))
    ang = torch.acos(torch.clamp(dot / torch.clamp(n1 * n2, min=1e-30), -1.0, 1.0))
    lo = math.pi - max_angle
    hi = math.pi + max_angle
    mid = 0.5 * (lo + hi)
    out = weight * torch.exp(torch.sqrt((ang - mid) ** 2))
    return torch.where((ang < lo) | (ang > hi), out, torch.zeros_like(out))
