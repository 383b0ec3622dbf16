"""Synthetic scenario generation for tests, the chip smoke run and
benchmarks: the port's own NumPy copy of the JAX package's generator.

Sinusoidal/arc/straight plans, pedestrian sets, occupancy costmaps with
Gaussian-inflated blobs, and brute-force ESDF grids matching the
obstacle_distance message layout (distances + nearest-obstacle flat indexes,
x + y*W ordering, obstacle_distance_interface.cpp:71-103).

Host-side NumPy on purpose: scenario generation is the data-loading layer,
not the compute path. Every generator takes an explicit seed or Generator.
The results are this package's NamedTuples with NumPy leaves;
``core.types.scenario_from_numpy`` puts them on the device.
"""

import numpy as np

from nav2_social_mpc_controller_tpu_torch.core.config import SocialMPCConfig
from nav2_social_mpc_controller_tpu_torch.core.types import (
    AgentsState,
    Costmap,
    ObstacleDistanceGrid,
    PathInput,
    RobotState,
    Scenario,
)
from nav2_social_mpc_controller_tpu_torch.core.validate import validate_scenario_windows


def make_path(n_points: int, max_points: int, kind: str, rng, dtype=np.float32):
    """Padded PathInput. kind: 'sine' | 'straight' | 'arc'."""
    t = np.linspace(0.0, 6.0, n_points)
    if kind == "sine":
        amp = rng.uniform(0.3, 1.0)
        xs, ys = t, amp * np.sin(0.8 * t)
    elif kind == "arc":
        r = rng.uniform(3.0, 8.0)
        ang = t / r
        xs, ys = r * np.sin(ang), r * (1.0 - np.cos(ang))
    else:
        xs, ys = t, np.zeros_like(t)
    yaw = np.arctan2(np.gradient(ys), np.gradient(xs))

    pts = np.zeros((max_points, 2), dtype)
    yw = np.zeros((max_points,), dtype)
    n = min(n_points, max_points)
    pts[:n, 0], pts[:n, 1], yw[:n] = xs[:n], ys[:n], yaw[:n]
    pts[n:] = pts[n - 1]
    yw[n:] = yw[n - 1]
    return PathInput(points=pts, yaw=yw, n=np.int32(n))


def make_people(n_agents: int, n_valid: int, rng, dtype=np.float32, spread=3.0):
    """AgentsState with n_valid walkers around the path corridor; the rest
    padded invalid (t = -1), like people_to_status (optimizer.cpp:454-482)."""
    st = np.zeros((n_agents, 6), dtype)
    st[:, 3] = -1.0
    for i in range(min(n_valid, n_agents)):
        st[i, 0] = rng.uniform(0.5, spread)
        st[i, 1] = rng.uniform(-1.5, 1.5)
        vx, vy = rng.uniform(-0.6, 0.6, size=2)
        st[i, 2] = np.arctan2(vy, vx)
        st[i, 3] = 0.0
        st[i, 4] = np.hypot(vx, vy)
        st[i, 5] = 0.0
    return AgentsState(state=st)


def make_costmap(h: int, w: int, resolution=0.05, origin=(-1.0, -3.0), obstacles=(), dtype=np.float32):
    """Costmap with Gaussian-inflated obstacle blobs (0..254 like nav2),
    rounded to INTEGERS: nav2's Costmap2D stores unsigned char cost (what the
    reference interpolates, ceres::Grid2D<u_char>, optimizer.cpp:167-170)."""
    data = np.zeros((h, w), dtype)
    yy, xx = np.mgrid[0:h, 0:w]
    for (ox_w, oy_w, radius_m) in obstacles:
        cx = (ox_w - origin[0]) / resolution
        cy = (oy_w - origin[1]) / resolution
        r = radius_m / resolution
        d2 = (xx - cx) ** 2 + (yy - cy) ** 2
        data = np.maximum(data, 254.0 * np.exp(-d2 / max(2.0 * r * r, 1e-6)))
    return Costmap(
        data=np.rint(data).astype(dtype),
        origin=np.asarray(origin, dtype),
        resolution=np.asarray(resolution, dtype),
    )


def brute_force_esdf(occupancy: np.ndarray, resolution: float, empty_value: float = 1e3):
    """Exact distance transform by brute force (O(HW * n_obstacles)):
    (distances (H, W) float32 [m], indexes (H, W) int32 flat x + y*W)."""
    occ = occupancy != 0
    h, w = occ.shape
    ys, xs = np.nonzero(occ)
    if len(xs) == 0:
        return np.full((h, w), empty_value, np.float32), np.zeros((h, w), np.int32)
    yy, xx = np.mgrid[0:h, 0:w]
    d2 = (xx[..., None] - xs[None, None, :]) ** 2 + (yy[..., None] - ys[None, None, :]) ** 2
    nearest = np.argmin(d2, axis=-1)
    dist = (np.sqrt(np.take_along_axis(d2, nearest[..., None], -1)[..., 0]) * resolution).astype(
        np.float32
    )
    idx = (xs[nearest] + ys[nearest] * w).astype(np.int32)
    return dist, idx


def make_esdf(h: int, w: int, resolution=0.05, origin=(-1.0, -3.0), obstacle_cells=None, dtype=np.float32):
    """ESDF matching the obstacle_distance message: per-cell distance [m] to
    the nearest obstacle cell and that cell's flat index (x + y*W). With no
    obstacles, every index points at cell 0 and distances are large.
    (h, w) == (100, 100) would trip the reference's invalid-grid sentinel
    (optimizer.cpp:598) — avoid for valid grids."""
    occ = np.zeros((h, w), np.uint8)
    if obstacle_cells is not None:
        for (x, y) in obstacle_cells:
            if 0 <= x < w and 0 <= y < h:
                occ[y, x] = 1
    distances, indexes = brute_force_esdf(occ, resolution)
    return ObstacleDistanceGrid(
        distances=distances.astype(dtype),
        indexes=indexes,
        origin=np.asarray(origin, dtype),
        resolution=np.asarray(resolution, dtype),
        valid=np.asarray(not (h == 100 and w == 100)),
    )


def make_scenario(
    cfg: SocialMPCConfig,
    seed: int,
    n_valid_people: int = 0,
    path_kind: str = "sine",
    n_path_points: int = 40,
    grid_hw=(120, 120),
    with_obstacles: bool = True,
    dtype=np.float32,
) -> Scenario:
    """One unbatched scenario with NumPy leaves, drawn from `seed`."""
    rng = np.random.default_rng(seed)
    path = make_path(n_path_points, cfg.max_path_points, path_kind, rng, dtype)
    robot = RobotState(
        pose=np.array([path.points[0, 0], path.points[0, 1], path.yaw[0]], dtype),
        speed=np.array([rng.uniform(0.0, 0.3), 0.0], dtype),
    )
    people = make_people(cfg.n_agents, n_valid_people, rng, dtype)
    h, w = grid_hw
    obstacles = [(3.0, 1.2, 0.3), (1.5, -0.8, 0.25)] if with_obstacles else []
    costmap = make_costmap(h, w, obstacles=obstacles, dtype=dtype)
    obs_cells = (
        [(int((ox + 1.0) / 0.05), int((oy + 3.0) / 0.05)) for (ox, oy, _) in obstacles]
        if with_obstacles
        else None
    )
    esdf = make_esdf(h, w, obstacle_cells=obs_cells, dtype=dtype)
    validate_scenario_windows(cfg, costmap.resolution, esdf.resolution)
    return Scenario(path=path, robot=robot, people=people, costmap=costmap, esdf=esdf)


def stack_scenarios(scenarios):
    """Stack a list of same-shaped unbatched Scenarios into a batched one."""

    def stack(*xs):
        if hasattr(xs[0], "_fields"):
            return type(xs[0])(*(stack(*leaves) for leaves in zip(*xs)))
        return np.stack([np.asarray(x) for x in xs])

    return stack(*scenarios)


def make_scenario_batch(cfg: SocialMPCConfig, batch: int, base_seed: int, **kw) -> Scenario:
    """`batch` scenarios of distinct seeds base_seed .. base_seed+batch-1."""
    return stack_scenarios([make_scenario(cfg, seed=base_seed + i, **kw) for i in range(batch)])



def _line(n: int, start, heading: float, spacing: float):
    """n points from `start` along `heading`, `spacing` apart."""
    k = np.arange(n)[:, None]
    return np.asarray(start)[None, :] + k * spacing * np.array([[np.cos(heading), np.sin(heading)]])


# Plans that reach each branch of the trajectorizer (see _trajectorizer_case).
TRAJECTORIZER_CASES = (
    "no_points", "one_point", "full_plan", "all_beyond_lookahead", "tied_minimisers",
    "rotate_left_above", "rotate_left_below", "rotate_right_above", "rotate_right_below",
    "goal_at_step_1", "goal_never_reached",
)


def _trajectorizer_case(name: str, tr, max_points: int):
    """The plan of case `name` in the robot's frame (robot at the origin
    facing +x), (n, 2), for TrajectorizerConfig `tr`."""
    look = tr.lookahead_dist
    reach = tr.desired_linear_vel * tr.time_step * tr.max_steps  # the most a run drives
    if name == "no_points":
        return np.zeros((0, 2))
    if name == "one_point":
        return np.array([[0.3, 0.1]])
    if name == "full_plan":  # every waypoint valid, a gentle curve
        t = np.arange(max_points) * 0.05
        return np.stack([t, 0.3 * np.sin(0.8 * t)], axis=1)
    if name == "all_beyond_lookahead":  # the nearest waypoint 1.5 lookaheads away
        return _line(40, (1.5 * look, 0.5), 0.3, 0.1)
    if name == "tied_minimisers":  # 12 copies of one point 2 lookaheads away
        return np.tile([[0.0, 2.0 * look]], (12, 1))
    if name.startswith("rotate_"):  # |dtheta| 1e-3 above or below pi/2, to either side
        side = 1.0 if "_left_" in name else -1.0
        ang = np.pi / 2.0 + (1e-3 if name.endswith("above") else -1e-3)
        return _line(8, (0.0, 0.0), side * ang, 0.1 * look)  # all within the lookahead
    if name == "goal_at_step_1":  # the goal 0.18 m ahead: done after one step
        return _line(3, (0.0, 0.0), 0.1, 0.09)
    if name == "goal_never_reached":  # the goal a run's reach + 1 m away
        return _line(31, (0.0, 0.0), -0.2, (reach + 1.0) / 30.0)
    raise ValueError(f"unknown trajectorizer case {name!r}")


def make_trajectorizer_cases(tr, batch: int, max_points: int, seed: int, dtype=np.float32):
    """`batch` plans for TrajectorizerConfig `tr` cycling through
    TRAJECTORIZER_CASES, each copy moved by its own random rigid transform
    of the plan frame (robot and plan together, so the case's geometry is
    kept and only the rounding differs). Returns (PathInput with a leading
    batch axis, robot poses (B, 3), the case index of each lane (B,)), NumPy
    leaves; padding beyond n holds the last valid pose (zeros when n = 0)."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((batch, max_points, 2))
    n = np.zeros((batch,), np.int32)
    pose = np.zeros((batch, 3))
    case = np.arange(batch) % len(TRAJECTORIZER_CASES)
    for b in range(batch):
        local = _trajectorizer_case(TRAJECTORIZER_CASES[case[b]], tr, max_points)[:max_points]
        yaw = rng.uniform(-np.pi, np.pi)
        shift = rng.uniform(-5.0, 5.0, 2)
        rot = np.array([[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]])
        n[b] = len(local)
        if n[b]:
            pts[b, : n[b]] = local @ rot.T + shift
            pts[b, n[b]:] = pts[b, n[b] - 1]
        pose[b] = (shift[0], shift[1], yaw)
    path = PathInput(points=pts.astype(dtype), yaw=np.zeros((batch, max_points), dtype), n=n)
    return path, pose.astype(dtype), case
