"""Reference-trajectory generation: the pure-pursuit-like rollout that turns
a geometric plan into a time-parameterised (poses, cmds) pair, batched.

Reference parity target: PathTrajectorizer::trajectorize
(path_trajectorizer.cpp:120-288). The goal-distance-terminated while loop
becomes a fixed max_steps loop with a done mask that reproduces the step
count exactly (the loop runs while goal_dist > 0.2 && steps < max_steps, with
goal_dist initialised to 1000 so at least one step always executes).

The backward lookahead search (:160-175) — scan the path from the END, break
at the first waypoint within lookahead_dist, else track the strict minimum —
becomes two masked reductions with the same tie-breaking: the LARGEST index
among the distance minimisers, written as an explicit masked max of indices.

``trajectorize`` launches ``csrc/trajectorize.cu`` for CUDA tensors (the
whole max_steps loop in one launch, the counterpart of the JAX package's
jitted lax.scan) and takes the plain version, ``trajectorize_plain``, only
for CPU tensors; there is no fallback on the card.
"""

import math
from typing import NamedTuple

import torch

from nav2_social_mpc_controller_tpu_torch import _build, kernel_shapes
from nav2_social_mpc_controller_tpu_torch.core.config import TrajectorizerConfig
from nav2_social_mpc_controller_tpu_torch.core.types import PathInput
from nav2_social_mpc_controller_tpu_torch.models.motion import integrate_step

GOAL_DIST_THRESHOLD = 0.2  # path_trajectorizer.cpp:150


class TrajectorizeResult(NamedTuple):
    poses: torch.Tensor  # (B, max_steps + 1, 3) — poses[:, 0] is the robot pose
    cmds: torch.Tensor  # (B, max_steps, 3) [vx, vy, wz]
    n_steps: torch.Tensor  # (B,) int32 steps actually executed
    ok: torch.Tensor  # (B,) bool — False iff the input path has < 2 poses


def _lookahead_point(px, py, valid, rx, ry, lookahead_dist):
    """Reference backward scan: largest valid index with dist <=
    lookahead_dist; if none, the largest valid index among distance
    minimisers (index P-1 when no pose is valid). px/py/valid (B, P);
    rx/ry (B,). Returns the waypoint coords (B,), (B,)."""
    p = px.shape[1]
    idx = torch.arange(p, device=px.device)[None, :]
    dist = torch.hypot(rx[:, None] - px, ry[:, None] - py)
    within = valid & (dist <= lookahead_dist)
    idx_within = torch.where(within, idx, -1).max(dim=1).values
    masked = torch.where(valid, dist, torch.full_like(dist, float("inf")))
    is_min = masked == masked.min(dim=1, keepdim=True).values
    idx_min = torch.where(is_min, idx, -1).max(dim=1).values
    wp = torch.where(idx_within >= 0, idx_within, idx_min).clamp(0, p - 1)[:, None]
    return torch.gather(px, 1, wp)[:, 0], torch.gather(py, 1, wp)[:, 0]


def trajectorize_plain(cfg: TrajectorizerConfig, path: PathInput, robot_pose) -> TrajectorizeResult:
    """Plain PyTorch version of the kernel: roll the control law along the
    plan. path: batched PathInput (plan frame); robot_pose (B, 3) [x, y,
    yaw]."""
    max_steps = cfg.max_steps
    px = path.points[..., 0]
    py = path.points[..., 1]
    valid = path.valid
    ok = path.n >= 2

    last = (path.n.long() - 1).clamp(0, px.shape[1] - 1)[:, None]
    goal_x = torch.gather(px, 1, last)[:, 0]
    goal_y = torch.gather(py, 1, last)[:, 0]

    v_des = cfg.desired_linear_vel
    w_max = cfg.max_angular_vel
    rx, ry, rtheta = robot_pose[:, 0], robot_pose[:, 1], robot_pose[:, 2]
    zero = torch.zeros_like(rx)
    done = ~ok
    poses = [robot_pose]
    cmds = []
    n_steps = torch.zeros_like(path.n)

    for _ in range(max_steps):
        wpx, wpy = _lookahead_point(px, py, valid, rx, ry, cfg.lookahead_dist)

        # Transform waypoint into the local robot frame (:182-185)
        cos_t, sin_t = torch.cos(rtheta), torch.sin(rtheta)
        dx = (wpx - rx) * cos_t + (wpy - ry) * sin_t
        dy = -(wpx - rx) * sin_t + (wpy - ry) * cos_t
        dtheta = torch.atan2(dy, dx)

        if cfg.omnidirectional:
            vx = v_des * torch.cos(dtheta)
            vy = v_des * torch.sin(dtheta)
            wz = zero
        else:
            point_dist2 = dx * dx + dy * dy
            curvature = torch.where(
                point_dist2 > 0.001, 2.0 * dy / point_dist2.clamp(min=1e-30), zero
            )
            rotate_in_place = dtheta.abs() > math.pi / 2.0
            vx = torch.where(rotate_in_place, zero, zero + v_des)
            wz = torch.where(
                rotate_in_place,
                w_max * torch.where(dtheta > 0, zero + 1.0, zero - 1.0),
                v_des * curvature,
            )
            vy = zero

        nrx, nry, nrtheta = integrate_step(rx, ry, rtheta, vx, vy, wz, cfg.time_step)

        # Hold the pose and emit zero cmds once done (masked-out steps)
        nrx = torch.where(done, rx, nrx)
        nry = torch.where(done, ry, nry)
        nrtheta = torch.where(done, rtheta, nrtheta)
        cmd = torch.where(done[:, None], zero[:, None], torch.stack([vx, vy, wz], dim=1))

        goal_dist = torch.hypot(nrx - goal_x, nry - goal_y)
        n_steps = n_steps + (~done).to(n_steps.dtype)
        done = done | (goal_dist <= GOAL_DIST_THRESHOLD)

        rx, ry, rtheta = nrx, nry, nrtheta
        poses.append(torch.stack([rx, ry, rtheta], dim=1))
        cmds.append(cmd)

    return TrajectorizeResult(
        poses=torch.stack(poses, dim=1),
        cmds=torch.stack(cmds, dim=1),
        n_steps=n_steps,
        ok=ok,
    )


def trajectorize(cfg: TrajectorizerConfig, path: PathInput, robot_pose) -> TrajectorizeResult:
    """Roll the control law along the plan. path: batched PathInput (plan
    frame), points (B, P, 2) and n (B,) int32; robot_pose (B, 3) [x, y,
    yaw]. On the card float32 only, in one launch that stays capturable (no
    host synchronisation, no copy from host memory); CPU tensors (any float
    dtype) take the plain version."""
    if not robot_pose.is_cuda:
        return trajectorize_plain(cfg, path, robot_pose)
    points = path.points.contiguous()
    pose = robot_pose.contiguous()
    n = path.n.contiguous()
    if points.ndim != 3 or points.shape[1] < 1 or points.shape[2] != 2:
        raise ValueError(f"trajectorize: expected points (B, P >= 1, 2), got {tuple(points.shape)}")
    b, p = points.shape[0], points.shape[1]
    dev = pose.device
    for name, t, dtype, shape in (("points", points, torch.float32, (b, p, 2)),
                                  ("n", n, torch.int32, (b,)),
                                  ("robot_pose", pose, torch.float32, (b, 3))):
        _build.check_tensor("trajectorize", name, t, dtype, shape, dev)
    s = cfg.max_steps
    poses = torch.empty((b, s + 1, 3), dtype=torch.float32, device=dev)
    cmds = torch.empty((b, s, 3), dtype=torch.float32, device=dev)
    n_steps = torch.empty((b,), dtype=torch.int32, device=dev)
    ok = torch.empty((b,), dtype=torch.bool, device=dev)
    if b == 0:
        return TrajectorizeResult(poses=poses, cmds=cmds, n_steps=n_steps, ok=ok)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.social_mpc_trajectorize_f32(
            points.data_ptr(), n.data_ptr(), pose.data_ptr(), poses.data_ptr(),
            cmds.data_ptr(), n_steps.data_ptr(), ok.data_ptr(), b, p, s,
            cfg.lookahead_dist, cfg.desired_linear_vel, cfg.max_angular_vel, cfg.time_step,
            int(cfg.omnidirectional), kernel_shapes.trajectorize_lanes(b),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(err, "trajectorize")
    _build.launch_counts["trajectorize"] += 1
    return TrajectorizeResult(poses=poses, cmds=cmds, n_steps=n_steps, ok=ok)
