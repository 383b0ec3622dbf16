"""Grid sampling: Catmull-Rom bicubic costmap interpolation and the
rolling-window crop, batched over scenarios.

Reference parity target: ceres::BiCubicInterpolator<ceres::Grid2D<u_char>>
built per tick over the costmap (optimizer.cpp:167-170) and queried by
ObstacleCost at grid coords (p - origin)/resolution with NO cell-centre
offset (obstacle_cost_function.hpp:160-163). Grid2D clamps out-of-range
rows/cols to the border; the interpolator is a cubic Hermite (Catmull-Rom)
spline in each axis.

``esdf_nearest_obstacle_diff`` is the whole-grid ESDF lookup of
Optimizer::computeObstacle, as the closed-loop simulator's pedestrians use
it; the SFM people projection (models/sfm.py) has its own, windowed copy.
"""

import torch

from nav2_social_mpc_controller_tpu_torch.ops.bicubic_cuda import bicubic_linearize


def _cubic_hermite(p0, p1, p2, p3, x):
    """Catmull-Rom cubic through 4 samples, evaluated at x in [0, 1] (the
    polynomial used by ceres::CubicHermiteSpline)."""
    a = 0.5 * (-p0 + 3.0 * p1 - 3.0 * p2 + p3)
    b = 0.5 * (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3)
    c = 0.5 * (-p0 + p2)
    return p1 + x * (c + x * (b + x * a))


def bicubic_interpolate_gather(grid, row, col):
    """Gather-stencil bicubic value (the textbook Hermite formulation), kept
    as the cross-check of the tap-weight form in ops/bicubic_cuda.py.
    grid (B, H, W); row/col (B, S) -> (B, S)."""
    b, h, w = grid.shape
    r0 = torch.floor(row)
    c0 = torch.floor(col)
    fr = row - r0
    fc = col - c0
    r0 = r0.long()
    c0 = c0.long()
    flat = grid.reshape(b, h * w)

    def at(dr, dc):
        # Border clamp == ceres::Grid2D's index clamping.
        rr = (r0 + dr).clamp(0, h - 1)
        cc = (c0 + dc).clamp(0, w - 1)
        return torch.gather(flat, 1, rr * w + cc)

    rows_interp = [
        _cubic_hermite(at(dr, -1), at(dr, 0), at(dr, 1), at(dr, 2), fc)
        for dr in (-1, 0, 1, 2)
    ]
    return _cubic_hermite(*rows_interp, fr)


def crop_grid_window(data, origin, resolution, center_xy, window: int):
    """Extract an (n, n) window of each scenario's grid centred (cell-wise)
    on the world point center_xy, clamped inside the grid; returns
    (window_data (B, n, n), window_origin (B, 2)). One indexed copy per tick,
    so the per-LM-iteration samples read n*n cells instead of the full grid.

    Bit-identical to sampling the full grid (including border clamping)
    whenever every query stays >= 2 cells inside the window — see
    OptimizerConfig.obstacle_window_cells for the sizing rule.

    data (B, H, W); origin (B, 2); resolution (B,); center_xy (B, 2)."""
    b, h, w = data.shape
    if window <= 0 or window >= min(h, w):
        return data, origin
    cell = torch.floor((center_xy - origin) / resolution[:, None]).long()  # (col, row)
    half = window // 2
    start_col = (cell[:, 0] - half).clamp(0, w - window)
    start_row = (cell[:, 1] - half).clamp(0, h - window)
    iwin = torch.arange(window, device=data.device)
    rows = (start_row[:, None] + iwin)[:, :, None]  # (B, n, 1)
    cols = (start_col[:, None] + iwin)[:, None, :]  # (B, 1, n)
    bidx = torch.arange(b, device=data.device)[:, None, None]
    win = data[bidx, rows, cols].contiguous()
    shift = torch.stack([start_col, start_row], dim=-1).to(origin.dtype) * resolution[:, None]
    return win, origin + shift


def costmap_world_to_grid(point_xy, origin, resolution):
    """World -> continuous grid coords, reference convention (no centre
    offset): (p - origin) / resolution. point_xy (B, S, 2); origin (B, 2);
    resolution (B,). Returns (col = x_grid, row = y_grid), each (B, S)."""
    g = (point_xy - origin[:, None, :]) / resolution[:, None, None]
    return g[..., 0], g[..., 1]


class _BicubicSample(torch.autograd.Function):
    """bicubic_linearize with a derivative rule built from its own (value,
    d/drow, d/dcol) triple, so that differentiating a costmap sample launches
    kernel K1 on the card like any other sample (the kernel itself has no
    derivative). The grid is a constant."""

    @staticmethod
    def forward(data, row, col):
        return bicubic_linearize(data, row, col)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(*output[1:])
        ctx.save_for_forward(*output[1:])
        ctx.save_for_backward(*output[1:])

    @staticmethod
    def jvp(ctx, _t_data, t_row, t_col):
        drow, dcol = ctx.saved_tensors
        t_val = None
        for grad, t in ((drow, t_row), (dcol, t_col)):
            if t is not None:
                t_val = grad * t if t_val is None else t_val + grad * t
        return t_val, None, None

    @staticmethod
    def backward(ctx, grad_val, _g_drow, _g_dcol):
        drow, dcol = ctx.saved_tensors
        return None, grad_val * drow, grad_val * dcol


def sample_costmap(costmap_data, origin, resolution, point_xy):
    """Bicubic costmap value at world points, ObstacleCost convention:
    Evaluate(row = y_grid, col = x_grid). Differentiable in point_xy."""
    col, row = costmap_world_to_grid(point_xy, origin, resolution)
    return _BicubicSample.apply(costmap_data, row.contiguous(), col.contiguous())[0]


def esdf_nearest_obstacle_diff(distances, indexes, origin, resolution, point_xy):
    """Vector from the nearest obstacle cell to the query point, replicating
    Optimizer::computeObstacle (optimizer.cpp:688-727).

    Steps: world -> (xcell, ycell) via floor; flat index xcell + ycell*W;
    gather the nearest-obstacle flat index; index -> obstacle cell -> world
    coords at the cell CORNER (cell*res + origin, reference :719-720);
    return diff = point - obstacle (and an in-bounds flag instead of the
    reference's exceptions).

    distances (B, H, W); indexes (B, H, W) int32; origin (B, 2); resolution
    (B,); point_xy (B, N, 2). Returns (diff (B, N, 2), in_bounds (B, N)
    bool)."""
    b, h, w = distances.shape
    cell = torch.floor((point_xy - origin[:, None, :]) / resolution[:, None, None]).long()
    xcell, ycell = cell[..., 0], cell[..., 1]
    in_bounds = (xcell >= 0) & (xcell < w) & (ycell >= 0) & (ycell < h)
    xc = xcell.clamp(0, w - 1)
    yc = ycell.clamp(0, h - 1)
    ob_idx = torch.gather(indexes.reshape(b, h * w).long(), 1, yc * w + xc).clamp(0, h * w - 1)
    ob = torch.stack([ob_idx % w, ob_idx // w], dim=-1).to(point_xy.dtype)
    obstacle = ob * resolution[:, None, None] + origin[:, None, :]
    return point_xy - obstacle, in_bounds
