"""The Social Force Model: the library's forces and update, and K5 — the
people projection: wrapper, plain version and launch count for
``csrc/sfm_scan.cu``.

Counterpart of the JAX package's ``models/sfm.py`` (``project_people``) and
``models/sfm_pallas.py`` (the whole scan as one kernel). Reference parity
target: sfm.hpp (``sfm_controller::SFM``) with its default parameters
(sfm.hpp:43-57), driven as Optimizer::project_people does
(optimizer.cpp:554-671): N pedestrians are simulated forward along the
robot's reference rows, S steps of computeForces + updatePosition, each
agent's nearest obstacle refreshed from the ESDF index grid every step.

Faithful quirks preserved:
  * The projection stores computeObstacle's DIFF vector (agent - obstacle),
    but computeObstacleForce subtracts it from the position again
    (sfm.hpp:210), so the force uses minDiff = the obstacle's world position.
  * An invalid ESDF (optimizer.cpp:598-603) projects NO people: steps >= 1
    are all invalid agents.
  * The robot takes part in the forces of each step but its own SFM update
    is discarded (optimizer.cpp:630-637).
  * Invalid agents and steps beyond the robot's rows are emitted as the
    reference's zero / t = -1 padding rows.

The nearest-obstacle lookup keeps the JAX package's window semantics
(``esdf_window_cells``): the query cell is clamped into a window around the
agent's starting cell, which changes nothing while the agent stays inside
it (core/validate.py holds the sizing rule). No table is cropped for it —
the index grid is read directly.

``desired_force``, ``obstacle_force``, ``pairwise_social_force``,
``group_forces`` and ``sfm_update`` are the SFM library (sfm.hpp) in plain
PyTorch, batched over scenarios — what the closed-loop simulator's
pedestrians run (runtime/simulator.py); the projection's plain version
repeats their arithmetic inline, in the kernel's order.

``project_people`` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors; there is no fallback on the card. The kernel
gives a group of scenarios a block: force warps that compute the pair
forces on parallel lanes and an agent warp for the rest of each agent's
step; ``scan_geometry`` chooses the groups.
"""

import math
from typing import NamedTuple

import torch

from nav2_social_mpc_controller_tpu_torch import _build, kernel_shapes
from nav2_social_mpc_controller_tpu_torch.utils.angles import wrap_to_pi

_EPS_DIR = 1e-6  # coincident-position guard (social_work_cost_function.hpp:124-127)


class SFMParams(NamedTuple):
    """sfm.hpp:43-57 defaults."""

    force_factor_desired: float = 2.0
    force_factor_obstacle: float = 20.0
    force_sigma_obstacle: float = 0.2
    force_factor_social: float = 2.1
    force_factor_group_gaze: float = 3.0
    force_factor_group_coherence: float = 2.0
    force_factor_group_repulsion: float = 1.0
    lam: float = 2.0
    gamma: float = 0.35
    n: float = 2.0
    n_prime: float = 3.0
    relaxation_time: float = 0.5


DEFAULT_PARAMS = SFMParams()


class ScanGeometry(NamedTuple):
    """K5's launch: a block per group of `scenarios_per_block` scenarios,
    `force_warps` force warps and one agent warp. In a force warp each
    agent's N sources (the other agents, then the robot) spread over
    `lanes_per_agent` lanes, `sources_per_lane` pair forces a lane; the agent
    warp has a lane for each agent of the block."""

    sources_per_lane: int
    lanes_per_agent: int
    lanes_per_scenario: int
    scenarios_per_warp: int
    force_warps: int
    scenarios_per_block: int
    blocks: int


# csrc/sfm_scan.cu is instantiated for N = 1..32 (kernel_shapes.SFM_SHAPES):
# at N = 33 a scenario's force lanes no longer fit one warp.
KERNEL_MAX_AGENTS = kernel_shapes.MAX_AGENTS


def scan_geometry(n_agents: int, batch: int) -> ScanGeometry:
    """The launch geometry of the scan for N agents and B scenarios: the
    fewest sources per lane with which a scenario's force lanes fit in one
    warp of 32 (kernel_shapes.sources_per_lane), as many scenarios a force
    warp as fit, and as many force warps a block as the agent warp has lanes
    for their agents."""
    if not 1 <= n_agents <= KERNEL_MAX_AGENTS:
        raise ValueError(
            f"project_people: the kernel is built for 1 to {KERNEL_MAX_AGENTS} agents (a "
            f"scenario's force lanes must fit one warp of 32), got {n_agents}"
        )
    spl = kernel_shapes.sources_per_lane(n_agents)
    lpa = -(-n_agents // spl)
    lps = n_agents * lpa
    spw = 32 // lps
    force_warps = 32 // (n_agents * spw)
    spb = force_warps * spw
    return ScanGeometry(spl, lpa, lps, spw, force_warps, spb, -(-batch // spb))


def scan_shared_bytes(geo: ScanGeometry, n_agents: int, s1: int) -> int:
    """Dynamic shared memory of one block of the scan over s1 - 1 steps: a
    float4 of state and one of forces per agent of the block, and the
    robot's position and velocity at every step of each scenario."""
    steps = max(s1 - 1, 0)
    return 16 * (2 * geo.scenarios_per_block * n_agents + geo.scenarios_per_block * steps)


def lookup_window(esdf_window: int, grid_h: int, grid_w: int) -> int:
    """The window the nearest-obstacle lookup clamps to: `esdf_window` where
    the JAX package would take its windowed lookup (window inside the grid,
    cell coordinates below 256), else 0 = the whole grid."""
    fits = (
        0 < esdf_window <= min(grid_h, grid_w)
        and grid_h <= 256
        and grid_w <= 256
        and grid_h * grid_w < 2**24
    )
    return esdf_window if fits else 0


def _norm(v):
    return torch.sqrt((v * v).sum(-1))


def _safe_normalize(v):
    """normalize with the critic's coincident guard: a zero-length vector is
    replaced by the fixed small direction (eps, 0). Returns (dir, norm)."""
    norm = _norm(v)
    tiny = norm < _EPS_DIR
    fixed = torch.zeros_like(v)
    fixed[..., 0] = _EPS_DIR
    v = torch.where(tiny[..., None], fixed, v)
    norm = torch.where(tiny, torch.full_like(norm, _EPS_DIR), norm)
    return v / norm[..., None], norm


def _cell(q, origin, resolution, n: int):
    """floor((q - origin) / resolution) as int64 clamped to [-1, n]; -1 and n
    stand for every out-of-range cell (NaN counts as out of range)."""
    c = torch.floor((q - origin) / resolution)
    return torch.nan_to_num(c, nan=-1.0).clamp(-1.0, float(n)).long()


def desired_force(pos, vel, goal, has_goal, goal_radius, desired_speed, params: SFMParams):
    """computeDesiredForce (sfm.hpp:188-203), elementwise over leading axes:
    pos/vel/goal (..., 2), has_goal (...) bool, desired_speed (...).
    Returns (force (..., 2), desired_direction (..., 2))."""
    diff = goal - pos
    dist = _norm(diff)
    pursuing = has_goal & (dist > goal_radius)
    direction = diff / dist.clamp(min=_EPS_DIR)[..., None]
    f_goal = (
        params.force_factor_desired
        * (direction * desired_speed[..., None] - vel)
        / params.relaxation_time
    )
    f_stop = -vel / params.relaxation_time
    force = torch.where(pursuing[..., None], f_goal, f_stop)
    direction = torch.where(pursuing[..., None], direction, torch.zeros_like(direction))
    return force, direction


def obstacle_force(pos, obstacle_entry, has_obstacle, radius, params: SFMParams):
    """computeObstacleForce (sfm.hpp:205-235) for a single obstacles1 entry
    per agent, elementwise over leading axes.

    obstacle_entry holds the computeObstacle() output: apos - obstacle_world.
    The SFM then computes minDiff = pos - entry (== the obstacle's world
    position when entry was built from the same pos — replicated verbatim)."""
    min_diff = pos - obstacle_entry
    dist = _norm(min_diff) - radius
    direction, _ = _safe_normalize(min_diff)
    force = (
        params.force_factor_obstacle
        * torch.exp(-dist / params.force_sigma_obstacle)[..., None]
        * direction
    )
    return torch.where(has_obstacle[..., None], force, torch.zeros_like(force))


def group_forces(positions, valid, group_id, desired_direction, radius, params: SFMParams):
    """computeGroupForce (sfm.hpp:325-393), non-_PAPER_VERSION_ branch.

    The reference projection never activates it (groupId = -1 for every
    projected agent), but it is part of the SFM library surface. Entities
    share a group iff group_id matches and >= 0; groups need >= 2 members.
    positions/desired_direction (B, M, 2); valid (B, M) bool; group_id
    (B, M) integer; radius (B, M). Returns (B, M, 2) total group force."""
    m = positions.shape[-2]
    dtype = positions.dtype
    eye = torch.eye(m, dtype=torch.bool, device=positions.device)
    same = (
        (group_id[..., :, None] == group_id[..., None, :])
        & (group_id[..., None, :] >= 0)
        & valid[..., None, :]
        & valid[..., :, None]
    )
    count = same.sum(-1)
    in_group = count >= 2
    members = torch.where(same[..., None], positions[..., None, :, :], 0.0)
    center = members.sum(-2) / count.clamp(min=1)[..., None].to(dtype)

    # Gaze: center of the OTHER members (sfm.hpp:340-341)
    cnt_f = count.to(dtype)
    com_others = (cnt_f[..., None] * center - positions) / (cnt_f - 1.0).clamp(min=1.0)[..., None]
    rel = com_others - positions
    elem = (desired_direction * rel).sum(-1)
    denom = _norm(desired_direction) * _norm(rel)
    com_angle = wrap_to_pi(torch.arccos(torch.clamp(elem / denom.clamp(min=_EPS_DIR), -1.0, 1.0)))
    dd_sq = (desired_direction * desired_direction).sum(-1).clamp(min=_EPS_DIR)
    gaze_f = params.force_factor_group_gaze * (elem / dd_sq)[..., None] * desired_direction
    gaze = torch.where((com_angle > math.pi / 2)[..., None], gaze_f, torch.zeros_like(gaze_f))

    # Coherence (softened tanh version, sfm.hpp:371-376)
    rel_c = center - positions
    dist_c = _norm(rel_c)
    max_dist = (cnt_f - 1.0) / 2.0
    soft = params.force_factor_group_coherence * (torch.tanh(dist_c - max_dist) + 1.0) / 2.0
    coherence = rel_c * soft[..., None]

    # Repulsion (sfm.hpp:379-388)
    diff = positions[..., :, None, :] - positions[..., None, :, :]
    d = _norm(diff)
    close = same & (d < (radius[..., :, None] + radius[..., None, :])) & ~eye
    repulsion = params.force_factor_group_repulsion * torch.where(close[..., None], diff, 0.0).sum(-2)

    total = gaze + coherence + repulsion
    return torch.where(in_group[..., None], total, torch.zeros_like(total))


def sfm_update(pos, vel, yaw, global_force, desired_speed, goal, has_goal, goal_radius, dt):
    """updatePosition (sfm.hpp:525-573) — Euler velocity update with speed
    clamp, yaw from velocity, angular velocity from yaw delta, goal pop.
    Elementwise over leading axes. Returns the tuple
    (pos', vel', yaw', lv', av', has_goal')."""
    vel = vel + global_force * dt
    speed = _norm(vel)
    over = speed > desired_speed
    vel = torch.where(
        over[..., None], vel / speed.clamp(min=_EPS_DIR)[..., None] * desired_speed[..., None], vel
    )
    new_yaw = wrap_to_pi(torch.atan2(vel[..., 1], vel[..., 0]))
    av = wrap_to_pi(new_yaw - yaw) / dt
    pos = pos + vel * dt
    lv = _norm(vel)
    reached = has_goal & (_norm(goal - pos) <= goal_radius)
    return pos, vel, new_yaw, lv, av, has_goal & ~reached


def pairwise_social_force(positions, velocities, valid, params: SFMParams):
    """computeSocialForce (sfm.hpp:237-281) over all entity pairs.
    positions/velocities (B, M, 2); valid (B, M) bool -> (B, M, 2): for each
    entity j the social force exerted by all other valid entities."""
    m = positions.shape[1]
    diff = positions[:, None, :, :] - positions[:, :, None, :]  # [j, k] = pos_k - pos_j
    diff_dir, diff_norm = _safe_normalize(diff)
    vel_diff = velocities[:, :, None, :] - velocities[:, None, :, :]  # vel_j - vel_k
    inter_dir, inter_len = _safe_normalize(params.lam * vel_diff + diff_dir)

    a1 = torch.atan2(inter_dir[..., 1], inter_dir[..., 0])
    a2 = torch.atan2(diff_dir[..., 1], diff_dir[..., 0])
    theta = wrap_to_pi(a2 - a1)

    b = params.gamma * inter_len
    force_vel_amt = -torch.exp(-diff_norm / b - (params.n_prime * b * theta) ** 2)
    force_ang_amt = -torch.sign(theta) * torch.exp(-diff_norm / b - (params.n * b * theta) ** 2)
    left_normal = torch.stack([-inter_dir[..., 1], inter_dir[..., 0]], dim=-1)
    pair_force = params.force_factor_social * (
        force_vel_amt[..., None] * inter_dir + force_ang_amt[..., None] * left_normal
    )
    eye = torch.eye(m, dtype=torch.bool, device=positions.device)
    mask = valid[:, :, None] & valid[:, None, :] & ~eye
    return torch.where(mask[..., None], pair_force, torch.zeros_like(pair_force)).sum(dim=2)


def project_people_plain(
    init_people,  # (B, N, 6) AgentsState rows [x, y, yaw, t, lv, av]
    robot_traj,  # (B, S+1, 6) robot reference rows (format_to_optimize output)
    robot_traj_n,  # (B,) int32: valid rows in robot_traj
    esdf_indexes,  # (B, H, W) int32
    esdf_origin,  # (B, 2)
    esdf_resolution,  # (B,)
    esdf_valid,  # (B,) bool
    maxtime: float,
    dt: float,
    params: SFMParams = DEFAULT_PARAMS,
    people_desired_vel: float = 0.5,
    people_radius: float = 0.5,
    goal_radius: float = 0.25,
    esdf_window: int = 0,
):
    """Plain PyTorch version of the kernel (any float dtype): (B, S+1, N, 6),
    slot 0 is init_people verbatim; slot i >= 1 holds the agents after i SFM
    steps with t = i*dt, or the zero / t = -1 padding row where the agent is
    invalid or the step lies beyond robot_traj_n."""
    b, n, _ = init_people.shape
    s1 = robot_traj.shape[1]
    h, w = esdf_indexes.shape[-2:]
    window = lookup_window(esdf_window, h, w)
    flat_idx = esdf_indexes.reshape(b, h * w).long()
    org = esdf_origin[:, None, :]
    res = esdf_resolution[:, None]

    valid0 = (init_people[..., 3] != -1.0) & esdf_valid[:, None]
    pos = init_people[..., 0:2]
    yaw = init_people[..., 2]
    lv = init_people[..., 4]
    av = init_people[..., 5]
    vel = torch.stack([lv * torch.cos(yaw), lv * torch.sin(yaw)], dim=-1)
    goal = pos + maxtime * vel  # constant-velocity-model goal (optimizer.cpp:587-591)

    if window > 0:
        half = window // 2
        c0 = torch.floor((pos - org) / res[..., None])
        c0 = torch.nan_to_num(c0, nan=0.0).clamp(-1.0e9, 1.0e9).long()
        start_col = (c0[..., 0] - half).clamp(0, w - window)
        start_row = (c0[..., 1] - half).clamp(0, h - window)

    def obstacle_lookup(q):
        """Optimizer::computeObstacle (optimizer.cpp:688-727): query minus the
        world corner of its nearest obstacle cell, and an on-grid flag."""
        xcell = _cell(q[..., 0], org[..., 0], res, w)
        ycell = _cell(q[..., 1], org[..., 1], res, h)
        in_bounds = (xcell >= 0) & (xcell < w) & (ycell >= 0) & (ycell < h)
        xc = xcell.clamp(0, w - 1)
        yc = ycell.clamp(0, h - 1)
        if window > 0:
            xc = start_col + (xc - start_col).clamp(0, window - 1)
            yc = start_row + (yc - start_row).clamp(0, window - 1)
        ob = torch.gather(flat_idx, 1, yc * w + xc).clamp(0, h * w - 1)
        cell = torch.stack([ob % w, ob // w], dim=-1).to(q.dtype)
        return q - (cell * res[..., None] + org), in_bounds

    obs_entry, obs_in = obstacle_lookup(pos)
    obs_has = obs_in & esdf_valid[:, None]
    has_goal = valid0
    robot_valid = torch.ones((b, 1), dtype=torch.bool, device=init_people.device)
    all_valid = torch.cat([valid0, robot_valid], dim=1)
    pad = torch.zeros((b, n, 6), dtype=init_people.dtype, device=init_people.device)
    pad[..., 3] = -1.0

    out = [init_people]
    for i in range(s1 - 1):
        row = robot_traj[:, i]
        r_vel = torch.stack(
            [row[:, 4] * torch.cos(row[:, 2]), row[:, 4] * torch.sin(row[:, 2])], dim=-1
        )
        # computeForces over [people..., robot] (optimizer.cpp:630-633)
        all_pos = torch.cat([pos, row[:, None, 0:2]], dim=1)
        all_vel = torch.cat([vel, r_vel[:, None, :]], dim=1)
        social = pairwise_social_force(all_pos, all_vel, all_valid, params)[:, :n]

        # computeDesiredForce (sfm.hpp:188-203)
        diff = goal - pos
        dist = _norm(diff)
        pursuing = has_goal & (dist > goal_radius)
        direction = diff / dist.clamp(min=_EPS_DIR)[..., None]
        f_goal = (
            params.force_factor_desired * (direction * people_desired_vel - vel)
            / params.relaxation_time
        )
        f_des = torch.where(pursuing[..., None], f_goal, -vel / params.relaxation_time)

        # computeObstacleForce (sfm.hpp:205-235) on the stored entry
        min_diff = pos - obs_entry
        odir, _ = _safe_normalize(min_diff)
        f_obs = (
            params.force_factor_obstacle
            * torch.exp(-(_norm(min_diff) - people_radius) / params.force_sigma_obstacle)[..., None]
            * odir
        )
        f_obs = torch.where((obs_has & valid0)[..., None], f_obs, torch.zeros_like(f_obs))

        # updatePosition (sfm.hpp:525-573); the robot's update is discarded
        vel_n = vel + (f_des + social + f_obs) * dt
        speed = _norm(vel_n)
        over = speed > people_desired_vel
        vel_n = torch.where(
            over[..., None], vel_n / speed.clamp(min=_EPS_DIR)[..., None] * people_desired_vel, vel_n
        )
        yaw_n = wrap_to_pi(torch.atan2(vel_n[..., 1], vel_n[..., 0]))
        av_n = wrap_to_pi(yaw_n - yaw) / dt
        pos_n = pos + vel_n * dt
        lv_n = _norm(vel_n)
        reached = has_goal & (_norm(goal - pos_n) <= goal_radius)

        # refresh the obstacles from the NEW positions (optimizer.cpp:641-645)
        obs_entry_n, obs_in_n = obstacle_lookup(pos_n)

        # freeze invalid agents / steps beyond the robot's rows
        active = valid0 & (i < robot_traj_n[:, None] - 1)
        act2 = active[..., None]
        pos = torch.where(act2, pos_n, pos)
        vel = torch.where(act2, vel_n, vel)
        yaw = torch.where(active, yaw_n, yaw)
        lv = torch.where(active, lv_n, lv)
        av = torch.where(active, av_n, av)
        has_goal = torch.where(active, has_goal & ~reached, has_goal)
        obs_entry = torch.where(act2, obs_entry_n, obs_entry)
        obs_has = torch.where(active, obs_in_n & esdf_valid[:, None], obs_has)

        t_col = torch.full_like(yaw, float(i + 1)) * dt
        step = torch.stack([pos[..., 0], pos[..., 1], yaw, t_col, lv, av], dim=-1)
        out.append(torch.where(act2, step, pad))
    return torch.stack(out, dim=1)


def project_people(
    init_people,
    robot_traj,
    robot_traj_n,
    esdf_indexes,
    esdf_origin,
    esdf_resolution,
    esdf_valid,
    maxtime: float,
    dt: float,
    params: SFMParams = DEFAULT_PARAMS,
    people_desired_vel: float = 0.5,
    people_radius: float = 0.5,
    goal_radius: float = 0.25,
    esdf_window: int = 0,
):
    """SFM forward simulation of the pedestrians along the robot's reference
    rows — see project_people_plain for shapes and semantics. float32 and
    contiguous on the card; CPU tensors (any float dtype) take the plain
    version."""
    if init_people.ndim != 3 or init_people.shape[-1] != 6 or robot_traj.ndim != 3:
        raise ValueError(
            f"project_people: expected people (B, N, 6) and rows (B, S+1, 6), got "
            f"{tuple(init_people.shape)}, {tuple(robot_traj.shape)}"
        )
    if not init_people.is_cuda:
        return project_people_plain(
            init_people, robot_traj, robot_traj_n, esdf_indexes, esdf_origin,
            esdf_resolution, esdf_valid, maxtime, dt, params, people_desired_vel,
            people_radius, goal_radius, esdf_window,
        )
    b, n, _ = init_people.shape
    s1 = robot_traj.shape[1]
    h, w = esdf_indexes.shape[-2:]
    f32, i32 = torch.float32, torch.int32
    for name, t, dtype, shape in (
        ("init_people", init_people, f32, (b, n, 6)),
        ("robot_traj", robot_traj, f32, (b, s1, 6)),
        ("robot_traj_n", robot_traj_n, i32, (b,)),
        ("esdf_indexes", esdf_indexes, i32, (b, h, w)),
        ("esdf_origin", esdf_origin, f32, (b, 2)),
        ("esdf_resolution", esdf_resolution, f32, (b,)),
        ("esdf_valid", esdf_valid, torch.bool, (b,)),
    ):
        _build.check_tensor("project_people", name, t, dtype, shape, init_people.device)
    out = torch.empty((b, s1, n, 6), dtype=f32, device=init_people.device)
    if b == 0 or n == 0:
        return out
    geo = scan_geometry(n, b)
    lib = _build.load()
    with torch.cuda.device(init_people.device):
        err = lib.social_mpc_sfm_scan_f32(
            init_people.data_ptr(), robot_traj.data_ptr(), robot_traj_n.data_ptr(),
            esdf_indexes.data_ptr(), esdf_origin.data_ptr(), esdf_resolution.data_ptr(),
            esdf_valid.data_ptr(), out.data_ptr(),
            b, n, s1, h, w, lookup_window(esdf_window, h, w), geo.sources_per_lane,
            geo.blocks, maxtime, dt,
            params.lam, params.gamma, params.n, params.n_prime, params.force_factor_social,
            params.force_factor_desired, params.relaxation_time,
            params.force_factor_obstacle, params.force_sigma_obstacle,
            people_desired_vel, people_radius, goal_radius,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0 and scan_shared_bytes(geo, n, s1) > 48 * 1024:
        raise RuntimeError(
            f"CUDA kernel sfm_scan failed to launch: cudaError {err}; a block of {n} agents over "
            f"{s1 - 1} steps needs {scan_shared_bytes(geo, n, s1)} bytes of shared memory, more "
            f"than 48 KB, which the card must allow a block (an H100: 227 KB)")
    _build.check_launch(err, "sfm_scan")
    _build.launch_counts["sfm_scan"] += 1
    return out
