"""SE(2) frame transforms — the framework's replacement for the reference's
TF2 tree lookups (social_mpc_controller.cpp:285-320 transformPose/
transformPoint, path_handler.cpp:51, obstacle_distance_interface.cpp:116-154
transformObstacleDistance).

A frame is a pose (x, y, yaw) of the child frame expressed in the parent.
The SE(2) operations take tensors batched over leading axes; the grid
rebases below are host-side NumPy.
"""

import math

import numpy as np
import torch

from nav2_social_mpc_controller_tpu_torch.utils.angles import wrap_to_pi


def compose(a, b):
    """Pose composition a ⊕ b: b expressed in a's parent frame.
    a, b: (..., 3) [x, y, yaw]."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    yaw = wrap_to_pi(a[..., 2] + b[..., 2])
    return torch.stack([x, y, yaw], dim=-1)


def inverse(a):
    """Pose inverse: the parent frame expressed in a."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = -(ca * a[..., 0] + sa * a[..., 1])
    y = -(-sa * a[..., 0] + ca * a[..., 1])
    return torch.stack([x, y, wrap_to_pi(-a[..., 2])], dim=-1)


def transform_point(frame, point):
    """Point in `frame` coords -> parent coords. frame: (..., 3);
    point: (..., 2)."""
    c, s = torch.cos(frame[..., 2]), torch.sin(frame[..., 2])
    x = frame[..., 0] + c * point[..., 0] - s * point[..., 1]
    y = frame[..., 1] + s * point[..., 0] + c * point[..., 1]
    return torch.stack([x, y], dim=-1)


def point_to_frame(frame, point):
    """Point in parent coords -> `frame` coords (the trajectorizer's local
    waypoint transform, path_trajectorizer.cpp:182-185)."""
    c, s = torch.cos(frame[..., 2]), torch.sin(frame[..., 2])
    dx = point[..., 0] - frame[..., 0]
    dy = point[..., 1] - frame[..., 1]
    return torch.stack([c * dx + s * dy, -s * dx + c * dy], dim=-1)


def transform_pose(frame, pose):
    """Pose in `frame` coords -> parent coords (== compose)."""
    return compose(frame, pose)


def pose_to_frame(frame, pose):
    """Pose in parent coords -> `frame` coords."""
    return compose(inverse(frame), pose)


def transform_grid_origin(frame, origin_xy):
    """Re-express a grid origin in another frame — the core of
    transformObstacleDistance (obstacle_distance_interface.cpp:116-132),
    which shifts the ESDF origin into the costmap's global frame."""
    return transform_point(frame, origin_xy)


# ---------------------------------------------------------------------------
# Grid frame rebasing (host-side input-adapter stage, SURVEY.md L4)
#
# The reference receives the obstacle_distance grid in an arbitrary frame and
# re-frames it by transforming ONLY the origin pose via TF
# (ObstacleDistInterface::transformObstacleDistance,
# obstacle_distance_interface.cpp:116-132); the cell data is untouched and
# downstream lookups use origin.position only (worldpoint2Cell,
# obstacle_distance_interface.cpp:53-60) — a rotation in the transform is
# silently ignored. rebase_costmap/rebase_esdf reproduce that exactly for
# (near-)pure translations, and go beyond the reference for genuinely rotated
# frames by resampling onto an axis-aligned grid (the samplers, like the
# reference's, assume axis-aligned grids). NumPy on purpose: frame adaptation
# is the data-ingest layer, once per tick per grid, not the device path.
# ---------------------------------------------------------------------------

_ROTATION_TOL = 1e-9


def _shifted_origin(frame, origin):
    """The pure-translation rebase: the origin through transform_point in
    float64, cast back to the origin's dtype."""
    origin = np.asarray(origin)
    new = transform_point(torch.as_tensor(np.asarray(frame, np.float64)),
                          torch.as_tensor(origin.astype(np.float64)))
    return new.numpy().astype(origin.dtype)


def _rebase_geometry(frame, origin, resolution, h, w):
    """Common footprint math: returns (new_origin, new_h, new_w,
    src_cols, src_rows, inside) where src_* are float source-grid coords of
    every target cell CORNER and inside masks cells whose source lies in the
    grid. None when the rotation is negligible (origin shift is exact)."""
    fx, fy, fyaw = float(frame[0]), float(frame[1]), float(frame[2])
    c, s = math.cos(fyaw), math.sin(fyaw)
    ox, oy = float(origin[0]), float(origin[1])
    res = float(resolution)

    if abs(math.sin(fyaw)) < _ROTATION_TOL and math.cos(fyaw) > 0:
        return None  # pure translation: transform the origin, keep the data

    # Axis-aligned bounding box of the rotated footprint's corners.
    corners = np.array([[0.0, 0.0], [w * res, 0.0], [0.0, h * res], [w * res, h * res]])
    rot = np.array([[c, -s], [s, c]])
    world = corners @ rot.T + np.array([fx + c * ox - s * oy, fy + s * ox + c * oy])
    lo = world.min(axis=0)
    hi = world.max(axis=0)
    new_w = int(math.ceil((hi[0] - lo[0]) / res))
    new_h = int(math.ceil((hi[1] - lo[1]) / res))
    new_origin = lo

    # Source coords of each target cell corner: invert the SE(2) frame.
    tx = lo[0] + np.arange(new_w) * res
    ty = lo[1] + np.arange(new_h) * res
    gx, gy = np.meshgrid(tx, ty)  # (new_h, new_w) world coords
    dx = gx - fx
    dy = gy - fy
    sx = c * dx + s * dy  # source-frame world coords
    sy = -s * dx + c * dy
    src_cols = (sx - ox) / res
    src_rows = (sy - oy) / res
    inside = (src_cols >= 0) & (src_cols <= w - 1) & (src_rows >= 0) & (src_rows <= h - 1)
    return new_origin, new_h, new_w, src_cols, src_rows, inside


def rebase_costmap(frame, costmap):
    """Re-express a Costmap (NumPy leaves, one scenario) in the frame
    `frame` (the pose of the costmap's current frame in the target frame).
    Pure translation: origin shift only, bit-exact (the reference's
    transformObstacleDistance behavior). Rotated: bilinear resample onto an
    axis-aligned grid covering the footprint, out-of-footprint cells = 0
    (free)."""
    data = np.asarray(costmap.data)
    h, w = data.shape[-2], data.shape[-1]
    geo = _rebase_geometry(frame, np.asarray(costmap.origin), costmap.resolution, h, w)
    if geo is None:
        return costmap._replace(origin=_shifted_origin(frame, costmap.origin))
    new_origin, new_h, new_w, src_cols, src_rows, inside = geo
    c0 = np.clip(np.floor(src_cols).astype(int), 0, w - 1)
    r0 = np.clip(np.floor(src_rows).astype(int), 0, h - 1)
    c1 = np.minimum(c0 + 1, w - 1)
    r1 = np.minimum(r0 + 1, h - 1)
    fc = np.clip(src_cols - c0, 0.0, 1.0)
    fr = np.clip(src_rows - r0, 0.0, 1.0)
    val = (
        data[r0, c0] * (1 - fr) * (1 - fc)
        + data[r0, c1] * (1 - fr) * fc
        + data[r1, c0] * fr * (1 - fc)
        + data[r1, c1] * fr * fc
    )
    val = np.where(inside, val, 0.0).astype(data.dtype)
    return costmap._replace(
        data=val, origin=new_origin.astype(np.asarray(costmap.origin).dtype)
    )


def rebase_esdf(frame, esdf):
    """Re-express an ObstacleDistanceGrid (NumPy leaves, one scenario) in
    the frame `frame`. Pure translation: origin shift only (exactly
    transformObstacleDistance, obstacle_distance_interface.cpp:116-132).
    Rotated: nearest-neighbor resample of distances; nearest-obstacle flat
    indexes are REBUILT by transforming each source obstacle cell's world
    position into the target frame and re-flattening (x + y*W ordering,
    obstacle_distance_interface.cpp:71-103). Out-of-footprint cells get the
    max distance and index 0."""
    dist = np.asarray(esdf.distances)
    idx = np.asarray(esdf.indexes)
    h, w = dist.shape[-2], dist.shape[-1]
    geo = _rebase_geometry(frame, np.asarray(esdf.origin), esdf.resolution, h, w)
    if geo is None:
        return esdf._replace(origin=_shifted_origin(frame, esdf.origin))
    new_origin, new_h, new_w, src_cols, src_rows, inside = geo
    res = float(esdf.resolution)
    cn = np.clip(np.rint(src_cols).astype(int), 0, w - 1)
    rn = np.clip(np.rint(src_rows).astype(int), 0, h - 1)
    new_dist = np.where(inside, dist[rn, cn], float(dist.max())).astype(dist.dtype)

    # Re-point the nearest-obstacle indexes: source flat index -> source
    # obstacle cell corner -> world -> target frame -> target flat index.
    src_flat = idx[rn, cn]
    ob_y = src_flat // w
    ob_x = src_flat % w
    ox, oy = float(np.asarray(esdf.origin)[0]), float(np.asarray(esdf.origin)[1])
    wx_src = ob_x * res + ox
    wy_src = ob_y * res + oy
    c, s = math.cos(float(frame[2])), math.sin(float(frame[2]))
    wx = float(frame[0]) + c * wx_src - s * wy_src
    wy = float(frame[1]) + s * wx_src + c * wy_src
    tx = np.clip(np.floor((wx - new_origin[0]) / res).astype(int), 0, new_w - 1)
    ty = np.clip(np.floor((wy - new_origin[1]) / res).astype(int), 0, new_h - 1)
    new_idx = np.where(inside, tx + ty * new_w, 0).astype(idx.dtype)
    return esdf._replace(
        distances=new_dist,
        indexes=new_idx,
        origin=np.asarray(new_origin, dtype=np.asarray(esdf.origin).dtype),
    )
