"""Plan windowing, batched over scenarios.

Reference parity target: mpc::PathHandler::transformGlobalPlan
(path_handler.cpp:40-108): locate the closest plan pose to the robot among
the poses within max_robot_pose_search_dist of INTEGRATED path length from
the start, then window forward until the euclidean distance from the robot
exceeds dist_threshold (half the costmap extent). The reference also erases
the passed poses from the stored plan; here the start index is returned and
carried as a cursor.

Ties are resolved with explicit masked min/max over indices (the FIRST
minimiser here), never by an argmin's tie rule.
"""

from typing import NamedTuple

import torch

from nav2_social_mpc_controller_tpu_torch.core.types import PathInput
from nav2_social_mpc_controller_tpu_torch.models.motion import prefix_sum


class WindowedPlan(NamedTuple):
    path: PathInput  # same static size, re-based to the window
    start_index: torch.Tensor  # (B,) int32 index into the input plan (prune point)


def first_min_index(values):
    """Smallest index among the minimisers of each row of `values` (B, P);
    a row that is all +inf yields 0."""
    p = values.shape[1]
    idx = torch.arange(p, device=values.device)
    is_min = values == values.min(dim=1, keepdim=True).values
    return torch.where(is_min, idx, p).min(dim=1).values.clamp(max=p - 1)


def transform_global_plan(
    path: PathInput,
    robot_pose,
    max_robot_pose_search_dist: float,
    dist_threshold,
    start=None,
) -> WindowedPlan:
    """path: batched PathInput; robot_pose (B, 3); dist_threshold (B,) or
    float; `start` (B,) int32 (default 0) is the cumulative prune cursor: the
    reference ERASES [begin(), transformation_begin) from its STORED plan
    every tick (path_handler.cpp:100), so the next tick's
    integrated-distance search starts from the pruned head. Poses before
    `start` are unsearchable and the cumulative distance is measured from
    `start`. The returned start_index is absolute (cumulative)."""
    b, p = path.yaw.shape
    dev = path.points.device
    idx = torch.arange(p, device=dev)[None, :]
    valid = path.valid

    dseg = path.points[:, 1:] - path.points[:, :-1]
    seg = torch.sqrt((dseg * dseg).sum(-1))
    cum = torch.cat([seg.new_zeros((b, 1)), prefix_sum(seg)], dim=1)
    if start is None:
        start = torch.zeros((b,), dtype=torch.int32, device=dev)
    start = start.long()[:, None]
    in_range = (start >= 0) & (start < p)
    cum0 = torch.where(
        in_range, torch.gather(cum, 1, start.clamp(0, p - 1)), torch.zeros_like(cum[:, :1])
    )
    # first_after_integrated_distance: poses searched are [begin, upper_bound)
    searchable = valid & (idx >= start) & (cum - cum0 <= max_robot_pose_search_dist)

    drob = path.points - robot_pose[:, None, 0:2]
    d_robot = torch.sqrt((drob * drob).sum(-1))
    inf = torch.full_like(d_robot, float("inf"))
    begin = first_min_index(torch.where(searchable, d_robot, inf))[:, None]

    # find_if from begin: first pose farther than dist_threshold ends the window
    thr = dist_threshold[:, None] if isinstance(dist_threshold, torch.Tensor) else dist_threshold
    beyond = valid & (idx >= begin) & (d_robot > thr)
    first_beyond = torch.where(beyond, idx, p).min(dim=1, keepdim=True).values
    n_old = path.n.long()[:, None]
    end = torch.where(beyond.any(dim=1, keepdim=True), first_beyond, n_old.clamp(max=p))

    n_new = (end - begin).clamp(min=0)
    src = (begin + idx).clamp(0, p - 1)
    # Pad tail with the last valid pose so downstream gathers stay safe.
    last_src = (begin + n_new - 1).clamp(0, p - 1)
    src = torch.where(idx < n_new, src, last_src)
    new_points = torch.gather(path.points, 1, src[:, :, None].expand(-1, -1, 2))
    new_yaw = torch.gather(path.yaw, 1, src)
    return WindowedPlan(
        path=PathInput(points=new_points, yaw=new_yaw, n=n_new[:, 0].to(torch.int32)),
        start_index=begin[:, 0].to(torch.int32),
    )
