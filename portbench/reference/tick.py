"""The benchmark's plain reference, composed from the frozen oracle
(reference/oracle.py, reference/jets.py): one control tick with every
intermediate the comparison reads, an episode of ticks, and the closed-loop
world update of the port's simulator. Plain float64 NumPy; it imports
nothing of the port, of the JAX package or of the repository's parity/.

The configuration is the one JSON file both sides read
(portbench/configs/<name>.json), turned into attribute access by
``config_namespace``.

``control`` (the check's control, never the benchmark's own runs) computes
the same in bfloat16: every stage's result (the trajectory, the formatted
rows, the projected people, each residual and Jacobian entry, each world
update) rounded to bfloat16 before the next stage reads it.
"""

import math
from types import SimpleNamespace

import numpy as np

from portbench.reference import oracle

STATUS_OK, STATUS_FALLBACK_CMDS, STATUS_FALLBACK_CRAWL = 0, 1, 2


def config_namespace(doc: dict):
    """The configuration file's fields as nested attributes."""
    def ns(d):
        return SimpleNamespace(**{k: ns(v) if isinstance(v, dict) else v for k, v in d.items()})
    return ns(doc)


# ------------------------------------------------------------------ bfloat16


def bf16(x):
    """x (a float, an array of floats) rounded to the nearest bfloat16,
    ties to even, as float64."""
    a = np.asarray(x, dtype=np.float64)
    f = a.astype(np.float32)
    bits = f.view(np.uint32).astype(np.uint64)
    rounded = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16
    finite = np.isfinite(f)
    out = np.where(finite, rounded.astype(np.uint32).view(np.float32), f).astype(np.float64)
    return float(out) if np.ndim(out) == 0 else out


def _round_tree(x):
    if isinstance(x, oracle.Jet):
        return oracle.Jet(bf16(x.v), bf16(x.d))
    if isinstance(x, np.ndarray) and x.dtype == object:
        return np.array([_round_tree(v) for v in x.ravel()], dtype=object).reshape(x.shape)
    if isinstance(x, (list, tuple)):
        return type(x)(_round_tree(v) for v in x)
    if isinstance(x, np.ndarray) or isinstance(x, float):
        return bf16(x)
    return x


class Bfloat16Stages:
    """Inside a `with`, the oracle's stages hand bfloat16 results on: the
    trajectorizer, the format, the people projection, the residuals and
    their Jacobians. Restores the oracle's functions on exit."""

    NAMES = ("oracle_trajectorize", "oracle_format", "oracle_project_people",
             "oracle_residuals", "value_and_jacobian")

    def __enter__(self):
        self.saved = {n: getattr(oracle, n) for n in self.NAMES}
        for n, fn in self.saved.items():
            setattr(oracle, n, self._rounded(fn))
        return self

    @staticmethod
    def _rounded(fn):
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            return None if out is None else _round_tree(out)
        return run

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(oracle, n, fn)
        return False


# ------------------------------------------------------------------ one tick


def reference_tick(cfg, plan_pts, robot_pose, speed, people_rows, costmap, esdf, memory,
                   judge=None):
    """oracle_step (SocialMPCController::computeVelocityCommands) with what
    it computes on the way: a dict with cmd (v, w), status, the pruned plan,
    the trajectorizer's poses (ref_path (m, 3)), the FOV-filtered people's
    projection (people_proj, list of (N, 6), valid agents first), the
    solution (cmds (n, 2), path (n, 3)), the LM iterations and whether
    the iteration cap stopped the solve (capped), and the solve's own cost
    (final_cost). With `judge`, an answer's dict with "cmd" and "cmds" for
    this tick, also the reference's cost at that answer (cost_at_answer):
    its command as the first block and its solution's later blocks. MUTATES
    memory, as oracle_step does."""
    cm_data, cm_origin, cm_res = costmap
    h, w = cm_data.shape
    dist_threshold = max(w * cm_res, h * cm_res) / 2.0
    out = dict(cmd=(0.1, 0.0), status=STATUS_FALLBACK_CRAWL, plan=plan_pts, ref_path=None,
               people_proj=None, cmds=None, path=None, iterations=0)
    win = oracle.oracle_transform_global_plan(
        plan_pts, robot_pose, cfg.max_robot_pose_search_dist, dist_threshold)
    if win is None:
        return out
    window, begin = win
    out["plan"] = [tuple(p) for p in plan_pts[begin:]]
    traj = oracle.oracle_trajectorize(cfg.trajectorizer, window, robot_pose)
    if traj is None:
        return out
    poses, cmds = traj
    out["ref_path"] = np.asarray(poses, np.float64)
    people_status, present = oracle.oracle_fov_filter(cfg, people_rows, robot_pose, costmap)
    rows = _rows(cfg, poses, cmds, speed, memory)
    ok, out_cmds, out_path, proj = oracle.oracle_optimize(
        cfg, poses, cmds, people_status, present, costmap, esdf, speed, memory)
    if not ok:
        if cmds:
            out.update(cmd=(cmds[0][0], cmds[0][2]), status=STATUS_FALLBACK_CMDS)
        return out
    out.update(cmd=(float(out_cmds[0][0]), float(out_cmds[0][1])), status=STATUS_OK,
               people_proj=[np.asarray(p, np.float64) for p in proj],
               cmds=np.asarray(out_cmds, np.float64), path=np.asarray(out_path, np.float64),
               iterations=int(memory.get("last_solve_iters", 0)),
               capped=bool(memory.get("last_solve_capped", False)),
               initial_cost=_cost_at(cfg, rows, proj, present, costmap))
    out["final_cost"] = _cost_at(cfg, rows, proj, present, costmap, _answer_blocks(cfg, rows, out))
    if judge is not None:
        out["cost_at_answer"] = _cost_at(cfg, rows, proj, present, costmap,
                                         _answer_blocks(cfg, rows, judge))
    return out


def _rows(cfg, poses, cmds, speed, memory):
    """The formatted rows oracle_optimize builds (its memory seeding
    without mutating `memory`)."""
    prev_path, prev_cmds = memory.get("prev_path"), memory.get("prev_cmds")
    if prev_path is None or len(prev_path) == 0:
        prev_path = np.array([[p[0], p[1], p[2]] for p in poses])
        prev_cmds = np.array([[c[0], c[2]] for c in cmds])
    return oracle.oracle_format(cfg, poses, cmds, speed, prev_path, prev_cmds)


def _cost_at(cfg, rows, proj, present, costmap, u=None):
    """The solve's cost 0.5 |r|^2 at blocks u (n_blocks, 2), or, without
    u, at the warm start clipped to the bounds, as oracle_optimize and
    oracle_lm_solve build it: the cost the LM solve starts from."""
    opt = cfg.optimizer
    n_blocks = _n_blocks(cfg, rows)
    if u is None:
        h = _horizon(cfg, rows)
        bounded = (np.arange(n_blocks) < h // max(min(opt.parameter_block_length, h), 1))[:, None]
        lo = np.where(bounded, [[opt.v_min, opt.w_min]], -np.inf)
        hi = np.where(bounded, [[opt.v_max, opt.w_max]], np.inf)
        u = np.clip(np.array([[rows[b][4], rows[b][5]] for b in range(n_blocks)]), lo, hi)
    u = np.asarray(u, np.float64)[:n_blocks]
    r = np.asarray(oracle.oracle_residuals(cfg, rows, proj, present, costmap[:3], u), np.float64)
    return 0.5 * float(r @ r)


def _horizon(cfg, rows):
    maxsize = int(round(cfg.trajectorizer.max_time / cfg.trajectorizer.time_step))
    return max(min(cfg.optimizer.control_horizon, maxsize - 1, len(rows) - 1), 1)


def _n_blocks(cfg, rows):
    h = _horizon(cfg, rows)
    return (h - 1) // max(min(cfg.optimizer.parameter_block_length, h), 1) + 1


def _answer_blocks(cfg, rows, answer):
    """An answer's blocks as the solve holds them: block 0 its command,
    block b its solution's command at step b * block length."""
    bl = max(min(cfg.optimizer.parameter_block_length, _horizon(cfg, rows)), 1)
    u = np.asarray(answer["cmds"], np.float64)[::bl][:_n_blocks(cfg, rows)].copy()
    u[0] = np.asarray(answer["cmd"], np.float64)
    return u


def lane_world(lane: dict):
    """The costmap and ESDF tuples the oracle takes, from one lane's arrays
    (portbench/gen/native.py's keys)."""
    origin = np.asarray(lane["origin"], np.float64)
    res = float(lane["resolution"])
    costmap = (np.asarray(lane["costmap"], np.float64), origin, res)
    esdf = (np.asarray(lane["esdf_dist"], np.float64), np.asarray(lane["esdf_idx"]), origin, res,
            bool(lane["esdf_valid"]))
    return costmap, esdf


def plan_of(lane: dict):
    n = int(lane["path_n"])
    return [tuple(p) for p in np.asarray(lane["path_points"][:n], np.float64)]


def episode(cfg_doc: dict, lane: dict, poses, speeds=None, people=None, control=False,
            judge=None):
    """The reference's ticks of one robot over an episode that starts from
    an empty memory and the lane's whole plan: tick t at robot pose
    poses[t], with speed speeds[t] and people people[t] (default: the
    lane's own, every tick); `judge`, an answer to the first tick that the
    reference's cost is taken at (reference_tick). Returns a list of
    reference_tick dicts, each with `cursor`, the plan points erased so
    far."""
    cfg = config_namespace(cfg_doc)
    costmap, esdf = lane_world(lane)
    plan = plan_of(lane)
    n0 = len(plan)
    memory = {}
    ticks = []
    for t, pose in enumerate(poses):
        speed = lane["robot_speed"] if speeds is None else speeds[t]
        rows = lane["people"] if people is None else people[t]
        args = (cfg, plan, np.asarray(pose, np.float64), np.asarray(speed, np.float64),
                np.asarray(rows, np.float64), costmap, esdf, memory, judge if t == 0 else None)
        if control:
            with Bfloat16Stages():
                out = reference_tick(*args)
            out["cmd"] = tuple(bf16(np.asarray(out["cmd"])))
        else:
            out = reference_tick(*args)
        plan = out["plan"]
        out["cursor"] = n0 - len(plan)
        del out["plan"]
        ticks.append(out)
    return ticks


# ------------------------------------------------------------ the world update

SFM_DESIRED = 2.0  # force_factor_desired (sfm.hpp:43-57)
SFM_OBSTACLE = 20.0  # force_factor_obstacle
SFM_SIGMA = 0.2  # force_sigma_obstacle
SFM_RELAX = 0.5  # relaxation_time
EPS_DIR = 1e-6


def _social_force_on(j, positions, velocities):
    return oracle._social_force_on(j, positions, velocities, oracle.SFM_PARAMS)


def world_update(cfg_doc: dict, lane: dict, pose, speed, people_rows, cmd, dt: float):
    """One simulated tick after the controller's command, as the port's
    simulator defines it (runtime/simulator.py: advance_world): the robot
    integrates cmd = (v, w) for dt from `pose`; every valid person takes
    one social-force step with the desired force toward its position plus
    10 s of its velocity, the social forces of every other valid person
    and of the robot (at the pre-tick pose and speed[0]), and the force of
    the nearest obstacle cell (none outside the grid); the speed is clamped
    to the people's desired speed. Returns (pose', people', closest
    robot-person distance, inf when nobody is valid)."""
    cfg = config_namespace(cfg_doc)
    x, y, th = (float(v) for v in pose)
    v, w = float(cmd[0]), float(cmd[1])
    new_pose = np.array([x + v * math.cos(th) * dt, y + v * math.sin(th) * dt, th + w * dt])

    rows = np.array(people_rows, np.float64)
    valid = rows[:, 3] != -1.0
    idx = np.flatnonzero(valid)
    pos = [rows[k, 0:2].copy() for k in idx]
    vel = [np.array([rows[k, 4] * math.cos(rows[k, 2]), rows[k, 4] * math.sin(rows[k, 2])])
           for k in idx]
    r_vel = np.array([speed[0] * math.cos(th), speed[0] * math.sin(th)])
    positions = pos + [np.array([x, y])]
    velocities = vel + [r_vel]
    dist_grid, idx_grid, origin, res, esdf_valid = lane_world(lane)[1]
    h, wd = dist_grid.shape
    desired = cfg.people_desired_vel
    out = rows.copy()
    for j, k in enumerate(idx):
        p, vj = pos[j], vel[j]
        goal = p + vj * 10.0
        diff = goal - p
        dist = math.hypot(diff[0], diff[1])
        if dist > cfg.goal_radius:
            f_des = SFM_DESIRED * (diff / max(dist, EPS_DIR) * desired - vj) / SFM_RELAX
        else:
            f_des = -vj / SFM_RELAX
        xc = math.floor((p[0] - origin[0]) / res)
        yc = math.floor((p[1] - origin[1]) / res)
        f_obs = np.zeros(2)
        if 0 <= xc < wd and 0 <= yc < h and esdf_valid:
            ob = int(idx_grid[yc, xc])
            obstacle = np.array([(ob % wd) * res + origin[0], (ob // wd) * res + origin[1]])
            min_diff = p - (p - obstacle)
            nrm = math.hypot(min_diff[0], min_diff[1])
            direction = min_diff / nrm if nrm >= EPS_DIR else np.array([1.0, 0.0])
            f_obs = SFM_OBSTACLE * math.exp(-(nrm - cfg.people_radius) / SFM_SIGMA) * direction
        force = f_des + _social_force_on(j, positions, velocities) + f_obs
        vn = vj + force * dt
        sp = math.hypot(vn[0], vn[1])
        if sp > desired:
            vn = vn / max(sp, EPS_DIR) * desired
        yaw = oracle.wrap(math.atan2(vn[1], vn[0]))
        av = oracle.wrap(yaw - rows[k, 2]) / dt
        pn = p + vn * dt
        out[k] = [pn[0], pn[1], yaw, rows[k, 3], math.hypot(vn[0], vn[1]), av]
    if len(idx):
        closest = min(math.hypot(out[k, 0] - new_pose[0], out[k, 1] - new_pose[1]) for k in idx)
    else:
        closest = math.inf
    return new_pose, out, closest
