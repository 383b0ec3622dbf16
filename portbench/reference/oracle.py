"""A frozen copy of the repository's parity/oracle.py, kept with the
benchmark so that the yardstick does not move when that file does; only
this paragraph and the import of the jets differ.

CPU oracle: a deliberately naive, loop-based, float64 NumPy
reimplementation of the exact reference semantics
(PIC4SeR/nav2_social_mpc_controller), used ONLY to generate golden values for
parity tests of the TPU framework. It shares no code with the JAX
implementation: rollouts are re-integrated per residual exactly like
computeUpdatedStateRedux (update_state.hpp:38-63), Jacobians are exact
forward-mode dual numbers with Ceres-jet semantics (parity/jets.py — the
reference differentiates every critic with ceres::Jet via
DynamicAutoDiffCostFunction), branches are real Python branches. The
residual math is scalar-generic: the identical code evaluates over plain
floats (golden residual values) and over jets (Jacobians), so the two can
never drift apart.

Structured after the C++ call stack (SURVEY.md section 3):
  oracle_trajectorize   <- PathTrajectorizer::trajectorize
  oracle_format         <- Optimizer::format_to_optimize
  oracle_project_people <- Optimizer::project_people + sfm.hpp
  oracle_residuals      <- the 8 active critics, one scalar per (critic, step)
  oracle_lm_solve       <- ceres::Solve LM trust-region semantics
  oracle_step           <- SocialMPCController::computeVelocityCommands
"""

import math

import numpy as np

from portbench.reference.jets import Jet, jatan2, jcos, jexp, jsin, jsqrt
from portbench.reference.jets import val as _val
from portbench.reference.jets import value_and_jacobian

# ---------------------------------------------------------------- helpers


def wrap(a):
    while a <= -math.pi:
        a += 2 * math.pi
    while a > math.pi:
        a -= 2 * math.pi
    return a


def wrap_atan2(a):
    return jatan2(jsin(a), jcos(a))


def _norm2(v2):
    """Euclidean norm of a length-2 vector, scalar-generic (np.linalg.norm
    rejects object arrays of jets; for 2 elements this is the same
    sqrt(x*x + y*y))."""
    return jsqrt(v2[0] * v2[0] + v2[1] * v2[1])


def _dot2(a, b):
    return a[0] * b[0] + a[1] * b[1]


def catmull(p0, p1, p2, p3, x):
    return p1 + 0.5 * x * (
        (p2 - p0) + x * ((2 * p0 - 5 * p1 + 4 * p2 - p3) + x * (3 * (p1 - p2) + p3 - p0))
    )


def oracle_bicubic(grid, r, c):
    # Cell selection on the primal: ceres::BiCubicInterpolator picks the
    # stencil from the jet's scalar part and differentiates the cell-local
    # spline polynomial, exactly as the jet flows through `catmull` below.
    h, w = grid.shape
    r0 = int(math.floor(_val(r)))
    c0 = int(math.floor(_val(c)))
    fr, fc = r - r0, c - c0

    def at(dr, dc):
        return grid[min(max(r0 + dr, 0), h - 1), min(max(c0 + dc, 0), w - 1)]

    rows = [catmull(at(dr, -1), at(dr, 0), at(dr, 1), at(dr, 2), fc) for dr in (-1, 0, 1, 2)]
    return catmull(rows[0], rows[1], rows[2], rows[3], fr)


# ---------------------------------------------------------------- trajectorizer


def oracle_trajectorize(tcfg, path_pts, robot_pose):
    """path_pts: (n, 2) valid points. Returns (poses list[(x,y,th)], cmds
    list[(vx,vy,wz)]) or None when the path has < 2 poses."""
    if len(path_pts) < 2:
        return None
    max_steps = int(round(tcfg.max_time / tcfg.time_step))
    rx, ry, rtheta = float(robot_pose[0]), float(robot_pose[1]), float(robot_pose[2])
    poses = [(rx, ry, rtheta)]
    cmds = []
    goal_dist = 1000.0
    steps = 0
    gx, gy = path_pts[-1]
    while goal_dist > 0.2 and steps < max_steps:
        min_dist = 100.0
        wp_index = -1
        for i in range(len(path_pts) - 1, -1, -1):
            wpx, wpy = path_pts[i]
            d = math.hypot(rx - wpx, ry - wpy)
            if d <= tcfg.lookahead_dist:
                wp_index = i
                break
            if d < min_dist:
                min_dist = d
                wp_index = i
        wpx, wpy = path_pts[wp_index]
        dx = (wpx - rx) * math.cos(rtheta) + (wpy - ry) * math.sin(rtheta)
        dy = -(wpx - rx) * math.sin(rtheta) + (wpy - ry) * math.cos(rtheta)
        dtheta = wrap(math.atan2(dy, dx))
        vx = vy = wz = 0.0
        if tcfg.omnidirectional:
            vx = tcfg.desired_linear_vel * math.cos(dtheta)
            vy = tcfg.desired_linear_vel * math.sin(dtheta)
        else:
            d2 = dx * dx + dy * dy
            curvature = 2.0 * dy / d2 if d2 > 0.001 else 0.0
            vx = tcfg.desired_linear_vel
            if abs(dtheta) > math.pi / 2.0:
                vx = 0.0
                wz = tcfg.max_angular_vel * (1.0 if dtheta > 0 else -1.0)
            else:
                wz = vx * curvature
        rx = rx + (vx * math.cos(rtheta) + vy * math.cos(math.pi / 2 + rtheta)) * tcfg.time_step
        ry = ry + (vx * math.sin(rtheta) + vy * math.sin(math.pi / 2 + rtheta)) * tcfg.time_step
        rtheta = rtheta + wz * tcfg.time_step
        poses.append((rx, ry, rtheta))
        cmds.append((vx, vy, wz))
        goal_dist = math.hypot(rx - gx, ry - gy)
        steps += 1
    return poses, cmds


# ---------------------------------------------------------------- format


def oracle_format(cfg, poses, cmds, speed, prev_path, prev_cmds):
    """Returns rows (n, 6) [x,y,yaw,t,v,w] (optimizer.cpp:484-551).
    prev_path: (m, 3) or None; prev_cmds: (m, 2) or None."""
    tcfg = cfg.trajectorizer
    maxsize = int(round(tcfg.max_time / tcfg.time_step))
    poses = list(poses)
    cmds = list(cmds)
    if len(poses) > maxsize:
        poses = poses[: maxsize - 1]
    if prev_path is None:
        prev_path = np.array([[p[0], p[1], p[2]] for p in poses])
        prev_cmds = np.array([[c[0], c[2]] for c in cmds])
    cpw = cfg.optimizer.current_path_weight
    ccw = cfg.optimizer.current_cmds_weight
    rows = []
    for i, p in enumerate(poses):
        x, y, yaw = p
        if len(prev_path) > 0 and i < len(prev_path):
            x = cpw * x + (1 - cpw) * prev_path[i, 0]
            y = cpw * y + (1 - cpw) * prev_path[i, 1]
            yaw = cpw * yaw + (1 - cpw) * prev_path[i, 2]
        if i == 0:
            v, wv = float(speed[0]), float(speed[1])
        else:
            pv = prev_cmds[i - 1] if i - 1 < len(prev_cmds) else (cmds[i - 1][0], cmds[i - 1][2])
            v = ccw * cmds[i - 1][0] + (1 - ccw) * pv[0]
            wv = ccw * cmds[i - 1][2] + (1 - ccw) * pv[1]
        rows.append([x, y, yaw, i * tcfg.time_step, v, wv])
    return np.array(rows, dtype=np.float64)


# ---------------------------------------------------------------- SFM projection


def _compute_obstacle(apos, esdf):
    dist_grid, idx_grid, origin, res = esdf
    h, w = dist_grid.shape
    xcell = int(math.floor((apos[0] - origin[0]) / res))
    ycell = int(math.floor((apos[1] - origin[1]) / res))
    xcell = min(max(xcell, 0), w - 1)
    ycell = min(max(ycell, 0), h - 1)
    ob_idx = int(idx_grid[ycell, xcell])
    oy = ob_idx // w
    ox = ob_idx % w
    obstacle = np.array([ox * res + origin[0], oy * res + origin[1]])
    return np.asarray(apos, float) - obstacle


def _social_force_on(j, positions, velocities, params):
    lam, gamma, n, nprime, factor = params
    force = np.zeros(2)
    for k in range(len(positions)):
        if k == j:
            continue
        diff = positions[k] - positions[j]
        dn = np.linalg.norm(diff)
        if dn < 1e-6:
            diff = np.array([1e-6, 0.0])
            dn = 1e-6
        diff_dir = diff / dn
        vel_diff = velocities[j] - velocities[k]
        inter = lam * vel_diff + diff_dir
        ilen = np.linalg.norm(inter)
        idir = inter / ilen
        a1 = wrap(math.atan2(idir[1], idir[0]))
        a2 = wrap(math.atan2(diff_dir[1], diff_dir[0]))
        theta = wrap(a2 - a1)
        b = gamma * ilen
        fvel = -math.exp(-dn / b - (nprime * b * theta) ** 2)
        sign = 0.0 if theta == 0 else (1.0 if theta > 0 else -1.0)
        fang = -sign * math.exp(-dn / b - (n * b * theta) ** 2)
        left = np.array([-idir[1], idir[0]])
        force += factor * (fvel * idir + fang * left)
    return force


SFM_PARAMS = (2.0, 0.35, 2.0, 3.0, 2.1)  # lambda, gamma, n, nPrime, factorSocial


def oracle_project_people(cfg, init_people, rows, esdf, esdf_valid=True):
    """init_people: (N, 6); rows: (S+1, 6). Returns list of (N, 6) arrays of
    length len(rows) (optimizer.cpp:554-671). Valid agents are compacted to
    the FRONT like the reference (order-insensitive for the critics)."""
    tcfg = cfg.trajectorizer
    dt = tcfg.time_step
    maxtime = tcfg.max_time
    n_slots = len(init_people)
    traj = [np.array(init_people, dtype=np.float64)]

    agents = []  # dicts
    for i, p in enumerate(init_people):
        if p[3] == -1:
            continue
        if not esdf_valid:
            continue
        a = dict(
            pos=np.array([p[0], p[1]]),
            yaw=float(p[2]),
            lv=float(p[4]),
            av=float(p[5]),
        )
        a["vel"] = np.array([a["lv"] * math.cos(a["yaw"]), a["lv"] * math.sin(a["yaw"])])
        a["goal"] = a["pos"] + maxtime * a["vel"]
        a["has_goal"] = True
        a["obstacle"] = _compute_obstacle(a["pos"], esdf)
        agents.append(a)

    lam, gamma, n_p, nprime, factor = SFM_PARAMS
    for i in range(len(rows) - 1):
        r = rows[i]
        r_pos = np.array([r[0], r[1]])
        r_vel = np.array([r[4] * math.cos(r[2]), r[4] * math.sin(r[2])])
        positions = [a["pos"] for a in agents] + [r_pos]
        velocities = [a["vel"] for a in agents] + [r_vel]

        for j, a in enumerate(agents):
            # desired force (people desired vel 0.5, goal radius 0.25)
            if a["has_goal"] and np.linalg.norm(a["goal"] - a["pos"]) > cfg.goal_radius:
                dd = a["goal"] - a["pos"]
                dd = dd / np.linalg.norm(dd)
                f_des = 2.0 * (dd * cfg.people_desired_vel - a["vel"]) / 0.5
            else:
                f_des = -a["vel"] / 0.5
            # obstacle force: minDiff = pos - stored_entry (sfm.hpp:210)
            min_diff = a["pos"] - a["obstacle"]
            dist = np.linalg.norm(min_diff) - cfg.people_radius
            nrm = np.linalg.norm(min_diff)
            direction = min_diff / nrm if nrm > 1e-6 else np.array([1e-6, 0]) / 1e-6
            f_obs = 20.0 * math.exp(-dist / 0.2) * direction
            f_soc = _social_force_on(j, positions, velocities, SFM_PARAMS)
            a["force"] = f_des + f_obs + f_soc

        for a in agents:
            a["vel"] = a["vel"] + a["force"] * dt
            sp = np.linalg.norm(a["vel"])
            if sp > cfg.people_desired_vel:
                a["vel"] = a["vel"] / sp * cfg.people_desired_vel
            init_yaw = a["yaw"]
            yaw = wrap(math.atan2(a["vel"][1], a["vel"][0]))
            a["yaw"] = yaw
            a["av"] = wrap(yaw - init_yaw) / dt
            a["pos"] = a["pos"] + a["vel"] * dt
            a["lv"] = np.linalg.norm(a["vel"])
            if a["has_goal"] and np.linalg.norm(a["goal"] - a["pos"]) <= cfg.goal_radius:
                a["has_goal"] = False
            a["obstacle"] = _compute_obstacle(a["pos"], esdf)

        out = np.zeros((n_slots, 6))
        out[:, 3] = -1.0
        for j, a in enumerate(agents):
            out[j] = [a["pos"][0], a["pos"][1], a["yaw"], (i + 1) * dt, a["lv"], a["av"]]
        traj.append(out)
    return traj


# ---------------------------------------------------------------- residuals


def _update_state_redux(pose0, u_blocks, dt, i, control_horizon, block_size):
    """computeUpdatedStateRedux (update_state.hpp:38-63): re-integrate from
    pose_0 through step i."""
    x, y, th = float(pose0[0]), float(pose0[1]), float(pose0[2])
    for j in range(i + 1):
        b = j // block_size if j < control_horizon else (control_horizon - 1) // block_size
        x = x + u_blocks[b][0] * jcos(th) * dt
        y = y + u_blocks[b][0] * jsin(th) * dt
        th = th + u_blocks[b][1] * dt
    return x, y, th


def oracle_residuals(cfg, rows, people_proj, people_present, costmap, u_blocks):
    """Residual vector with the SAME layout as
    controller.optimize.build_residual_fn: [social_work, agent_angle,
    proxemics, velocity, goal_align, path_follow, path_align, obstacle] x S
    (S = maxsize-1, masked beyond the row count) + velocity-feasibility pairs.

    costmap: (data, origin, res)."""
    w = cfg.optimizer.weights
    tcfg = cfg.trajectorizer
    dt = tcfg.time_step
    maxsize = int(round(tcfg.max_time / tcfg.time_step))
    s_max = maxsize - 1
    n_rows = len(rows)
    n_vel = n_rows - 1
    # Dynamic horizon shrink (optimizer.cpp:248-249)
    h = max(min(cfg.optimizer.control_horizon, s_max, n_vel), 1)
    bl = max(min(cfg.optimizer.parameter_block_length, h), 1)
    n_vf = max(0, min(cfg.optimizer.control_horizon, s_max) //
               min(cfg.optimizer.parameter_block_length, min(cfg.optimizer.control_horizon, s_max)) - 1)

    pose0 = rows[0]
    final_pt = rows[n_rows - 1][0:2]
    goal_yaw = rows[n_rows - 1][2]
    cm_data, cm_origin, cm_res = costmap

    # Object arrays when u carries jets (parity/jets.py): the SAME residual
    # code below then yields exact Jacobian rows alongside the primals.
    dt_out = object if np.asarray(u_blocks).dtype == object else np.float64
    sw = np.zeros(s_max, dtype=dt_out)
    aa = np.zeros(s_max, dtype=dt_out)
    px = np.zeros(s_max, dtype=dt_out)
    vel = np.zeros(s_max, dtype=dt_out)
    ga = np.zeros(s_max, dtype=dt_out)
    pf = np.zeros(s_max, dtype=dt_out)
    pa = np.zeros(s_max, dtype=dt_out)
    ob = np.zeros(s_max, dtype=dt_out)

    for i in range(min(n_vel, s_max)):
        nx, ny, nth = _update_state_redux(pose0, u_blocks, dt, i, h, bl)
        bi = i // bl if i < h else (h - 1) // bl
        rv, rw = u_blocks[bi]
        agents = people_proj[i + 1] if people_proj is not None else None

        if people_present:
            # social work
            r_pos = np.array([nx, ny])
            r_vel = np.array([rv * jcos(nth), rv * jsin(nth)])
            wr_f = np.zeros(2)
            for a in agents:
                if a[3] == -1:
                    continue
                wr_f = wr_f + _pair_social_force(r_pos, r_vel, a)
            wr = _dot2(wr_f, wr_f)
            wp = 0.0
            robot_as_agent = np.array([nx, ny, nth, 0.0, rv, rw])
            for a in agents:
                me_pos = np.array([a[0], a[1]])
                me_vel = np.array([a[4] * math.cos(a[2]), a[4] * math.sin(a[2])])
                f = _pair_social_force(me_pos, me_vel, robot_as_agent)
                wp = wp + _dot2(f, f)
            sw[i] = w.social_weight * (wr + wp + 1e-6)

            # agent angle
            aa[i] = _oracle_agent_angle(w.agent_angle_weight, nth, pose0, agents)

            # proxemics
            min_sq = np.inf
            for a in agents:
                if a[3] == -1:
                    continue
                d2 = (nx - a[0]) ** 2 + (ny - a[1]) ** 2
                min_sq = min(min_sq, d2)
            px[i] = (
                w.proxemics_weight * 3.0 * jexp(-min_sq / 0.25)
                if np.isfinite(_val(min_sq))
                else 0.0
            )

        if i < h:
            vel[i] = w.velocity_weight * (cfg.optimizer.desired_linear_vel - rv) ** 2
        t = wrap_atan2(goal_yaw - nth)
        ga[i] = w.goal_align_weight * t * t
        d2f = (nx - final_pt[0]) ** 2 + (ny - final_pt[1]) ** 2
        pf[i] = w.distance_weight * d2f * d2f
        d2p = (nx - rows[i + 1][0]) ** 2 + (ny - rows[i + 1][1]) ** 2
        pa[i] = w.angle_weight * d2p * d2p
        fx = nx + 0.25 * jcos(nth)
        fy = ny + 0.25 * jsin(nth)
        gc = (fx - cm_origin[0]) / cm_res
        gr = (fy - cm_origin[1]) / cm_res
        ob[i] = w.obstacle_weight * oracle_bicubic(cm_data, gr, gc)

    vf = np.zeros(n_vf, dtype=dt_out)
    for p in range(n_vf):
        if p + 1 < h // bl and p + 1 < n_vel:
            dv = u_blocks[p + 1][0] - u_blocks[p][0]
            dw = u_blocks[p + 1][1] - u_blocks[p][1]
            vf[p] = w.velocity_feasibility_weight * (dv * dv + dw * dw)

    return np.concatenate([sw, aa, px, vel, ga, pf, pa, ob, vf])


def _pair_social_force(me_pos, me_vel, other_row):
    """SocialWorkCost::computeSocialForce single-pair term
    (social_work_cost_function.hpp:164-228): theta > 0 -> +1 else -1."""
    lam, gamma, n_p, nprime, factor = SFM_PARAMS
    a_pos = np.array([other_row[0], other_row[1]])
    a_vel = np.array(
        [other_row[4] * jcos(other_row[2]), other_row[4] * jsin(other_row[2])]
    )
    diff = me_pos - a_pos
    dn = _norm2(diff)
    if dn < 1e-6:
        diff = np.array([1e-6, 0.0])
        dn = _norm2(diff)
    diff_dir = diff / dn
    vel_diff = me_vel - a_vel
    inter = lam * vel_diff + diff_dir
    ilen = _norm2(inter)
    idir = inter / ilen
    theta = wrap(jatan2(diff_dir[1], diff_dir[0]) - jatan2(idir[1], idir[0]))
    b = gamma * ilen
    fvel = -jexp(-dn / b - (nprime * b * theta) ** 2)
    sign = 1.0 if theta > 0 else -1.0
    fang = -sign * jexp(-dn / b - (n_p * b * theta) ** 2)
    left = np.array([-idir[1], idir[0]])
    return factor * (fvel * idir + fang * left)


def _oracle_agent_angle(weight, new_yaw, pose0, agents):
    closest = -1
    best = np.inf
    for i, a in enumerate(agents):
        dx = a[0] - pose0[0]
        dy = a[1] - pose0[1]
        d2 = dx * dx + dy * dy
        if d2 < best and a[4] > 0.05:
            best = d2
            closest = i
    if closest < 0 or best > 4.0:
        return 0.0
    a = agents[closest]
    agent_angle_initial = math.atan2(a[1] - pose0[1], a[0] - pose0[0])
    robot_yaw = pose0[2]
    heading_diff = wrap_atan2(a[2] - robot_yaw)
    if heading_diff <= -5 * math.pi / 6 or heading_diff >= math.pi / 6:
        if wrap_atan2(agent_angle_initial - robot_yaw) < 0:
            return 0.0
        ang = wrap_atan2(new_yaw - (robot_yaw - math.pi / 6))
    else:
        if wrap_atan2(agent_angle_initial - robot_yaw) > 0:
            return 0.0
        ang = wrap_atan2(new_yaw - (robot_yaw + math.pi / 6))
    return weight * ang * ang


# ---------------------------------------------------------------- LM solve


def oracle_transform_global_plan(plan_pts, robot_pose, max_search_dist, dist_threshold):
    """PathHandler::transformGlobalPlan (path_handler.cpp:40-108): locate the
    closest pose among those within max_search_dist of integrated path length
    (nav2_util first_after_integrated_distance + min_by), window forward until
    euclidean distance from the robot exceeds dist_threshold, and prune the
    passed poses. Returns (window_pts (m, 2), begin) or None when empty."""
    n = len(plan_pts)
    if n == 0:
        return None
    # first_after_integrated_distance: first pose where cumulative segment
    # length exceeds the bound (exclusive upper bound of the search).
    ub = n
    cum = 0.0
    for i in range(n - 1):
        cum += math.hypot(
            plan_pts[i + 1][0] - plan_pts[i][0], plan_pts[i + 1][1] - plan_pts[i][1]
        )
        if cum > max_search_dist:
            ub = i + 1
            break
    # min_by over [0, ub): FIRST minimum wins (std::min_element semantics).
    begin = 0
    best = math.inf
    for i in range(ub):
        d = math.hypot(robot_pose[0] - plan_pts[i][0], robot_pose[1] - plan_pts[i][1])
        if d < best:
            best = d
            begin = i
    # find_if from begin: first pose farther than dist_threshold ends it.
    end = n
    for i in range(begin, n):
        d = math.hypot(robot_pose[0] - plan_pts[i][0], robot_pose[1] - plan_pts[i][1])
        if d > dist_threshold:
            end = i
            break
    window = [tuple(plan_pts[i]) for i in range(begin, end)]
    if not window:
        return None  # "Resulting plan has 0 poses in it." exception
    return window, begin


def oracle_fov_filter(cfg, people_rows, robot_pose, costmap):
    """FOV + costmap filter (social_mpc_controller.cpp:197-215) followed by
    people_to_status padding/truncation to exactly n_agents slots
    (optimizer.cpp:454-482; the reference hardcodes 3). people_rows: (N, 6)
    with t == -1 marking invalid inputs. Returns (status (n_agents, 6),
    people_present bool)."""
    cm_data, cm_origin, cm_res = costmap
    h, w = cm_data.shape
    kept = []
    for p in people_rows:
        if p[3] == -1:
            continue
        # Costmap2D::worldToMap: reject outside [origin, origin + size)
        if p[0] < cm_origin[0] or p[1] < cm_origin[1]:
            continue
        if int((p[0] - cm_origin[0]) / cm_res) >= w or int((p[1] - cm_origin[1]) / cm_res) >= h:
            continue
        angle_to_person = math.atan2(p[1] - robot_pose[1], p[0] - robot_pose[0])
        rel = wrap_atan2(angle_to_person - robot_pose[2])
        if abs(rel) < cfg.fov_angle:
            kept.append(p)
    present = len(kept) != 0  # the critics gate is people.people.size() != 0
    n_slots = len(people_rows)
    status = np.zeros((n_slots, 6))
    status[:, 3] = -1.0
    for i, p in enumerate(kept[:n_slots]):
        status[i] = [p[0], p[1], p[2], 0.0, p[4], p[5]]
    return status, present


def oracle_optimize(cfg, poses, cmds, people_status, people_present, costmap, esdf, speed, memory):
    """Optimizer::optimize (optimizer.cpp:148-452) incl. memory seeding,
    format blend, SFM projection, LM solve, post-horizon extrapolation, and
    path re-rollout.

    poses/cmds: trajectorizer output lists; memory: dict with
    'prev_path' (m, 3) / 'prev_cmds' (m, 2) or empty. MUTATES memory.
    Returns (ok, out_cmds (n, 2), out_path (n, 3), people_proj) — on
    ok=False nothing is returned beyond the flag (caller falls back)."""
    if len(poses) < 2:
        return False, None, None, None  # before memory seeding (:158-162)

    # Memory seeding happens BEFORE format (optimizer.cpp:174-186).
    if memory.get("prev_path") is None or len(memory["prev_path"]) == 0:
        memory["prev_path"] = np.array([[p[0], p[1], p[2]] for p in poses])
        memory["prev_cmds"] = np.array([[c[0], c[2]] for c in cmds])

    rows = oracle_format(
        cfg, poses, cmds, speed, memory["prev_path"], memory["prev_cmds"]
    )
    people_proj = oracle_project_people(
        cfg, people_status, rows, esdf[:4],
        esdf_valid=bool(esdf[4]) if len(esdf) > 4 else True,
    )

    tcfg = cfg.trajectorizer
    n_rows = len(rows)
    n_vel = n_rows - 1
    maxsize = int(round(tcfg.max_time / tcfg.time_step))
    s_max = maxsize - 1
    h = max(min(cfg.optimizer.control_horizon, s_max, n_vel), 1)
    bl = max(min(cfg.optimizer.parameter_block_length, h), 1)
    n_blocks = (h - 1) // bl + 1

    # Warm start: parameter block b aliases row b's velocity storage
    # (optimizer.cpp:251-261).
    u0 = np.array([[rows[b][4], rows[b][5]] for b in range(n_blocks)])
    opt = cfg.optimizer
    n_bounded = h // bl
    lo = np.where((np.arange(n_blocks) < n_bounded)[:, None],
                  [[opt.v_min, opt.w_min]], -np.inf).reshape(-1)
    hi = np.where((np.arange(n_blocks) < n_bounded)[:, None],
                  [[opt.v_max, opt.w_max]], np.inf).reshape(-1)

    cm = costmap[:3]

    def rfn(u_flat):
        return oracle_residuals(
            cfg, rows, people_proj, people_present, cm, u_flat.reshape(n_blocks, 2)
        )

    u_flat, _cost, n_iters, term = oracle_lm_solve(
        rfn, u0.reshape(-1), lo, hi,
        opt.max_iterations, opt.fn_tol, opt.gradient_tol, opt.param_tol,
        return_iters=True, return_term=True,
    )
    # Solve telemetry for study tools (parity_on_chip / chaos_floor): the
    # reference logs the equivalent via Summary::BriefReport
    # (optimizer.cpp:382). A lane is cap-bound when no tolerance fired.
    memory["last_solve_iters"] = n_iters
    memory["last_solve_term"] = term
    memory["last_solve_capped"] = term == "max_iter"
    u = u_flat.reshape(n_blocks, 2)

    # Post-horizon extrapolation + block expansion (optimizer.cpp:389-419):
    # steps i < h take block i//bl; steps i >= h take block (h-1)//bl.
    out_cmds = []
    for i in range(n_vel + 1):
        b = i // bl if i < h else (h - 1) // bl
        out_cmds.append([u[b][0], u[b][1]])
    out_cmds = np.array(out_cmds)
    # Path re-rollout from pose_0 (:420-446); one pose per saving velocity.
    x, y, th = rows[0][0], rows[0][1], rows[0][2]
    out_path = []
    for v, wv in out_cmds:
        x += v * math.cos(th) * cfg.trajectorizer.time_step
        y += v * math.sin(th) * cfg.trajectorizer.time_step
        th += wv * cfg.trajectorizer.time_step
        out_path.append([x, y, th])
    out_path = np.array(out_path)

    memory["prev_path"] = out_path.copy()
    memory["prev_cmds"] = out_cmds.copy()
    return True, out_cmds, out_path, people_proj


def oracle_step(cfg, plan_pts, robot_pose, speed, people_rows, costmap, esdf, memory):
    """SocialMPCController::computeVelocityCommands
    (social_mpc_controller.cpp:162-257): windowing -> trajectorize -> FOV
    filter -> optimize -> degradation ladder. MUTATES memory. Returns
    (cmd (vx, vy, wz), status, pruned_plan_pts):
      status 0 = optimized, 1 = fallback to trajectorizer cmds,
      2 = crawl fallback (trajectorize failed).

    costmap: (data, origin, res); esdf: (dist, idx, origin, res[, valid])."""
    cm_data, cm_origin, cm_res = costmap
    h, w = cm_data.shape
    dist_threshold = max(w * cm_res, h * cm_res) / 2.0

    win = oracle_transform_global_plan(
        plan_pts, robot_pose, cfg.max_robot_pose_search_dist, dist_threshold
    )
    if win is None:
        return (0.1, 0.0, 0.0), 2, plan_pts
    window, begin = win
    pruned_plan = [tuple(p) for p in plan_pts[begin:]]
    # getTransformedGoal(2.5, ...) is computed but its result is a dead
    # variable (social_mpc_controller.cpp:174 'goal' never read).

    traj = oracle_trajectorize(cfg.trajectorizer, window, robot_pose)
    if traj is None:
        return (0.1, 0.0, 0.0), 2, pruned_plan
    poses, cmds = traj
    init_cmds = [tuple(c) for c in cmds]

    people_status, present = oracle_fov_filter(cfg, people_rows, robot_pose, costmap)

    ok, out_cmds, _path, _proj = oracle_optimize(
        cfg, poses, cmds, people_status, present, costmap, esdf, speed, memory
    )
    if not ok:
        if not init_cmds:
            return (0.1, 0.0, 0.0), 2, pruned_plan
        c0 = init_cmds[0]
        return (c0[0], 0.0, c0[2]), 1, pruned_plan
    return (out_cmds[0][0], 0.0, out_cmds[0][1]), 0, pruned_plan


def oracle_lm_solve(residual_fn, u0, lower, upper, max_iter, fn_tol, grad_tol, param_tol,
                    return_iters=False, jacobi_scaling=False, jacobian="jet",
                    return_term=False):
    """Ceres-style LM trust region with exact dual-number Jacobians.

    jacobian: "jet" (default) evaluates residual_fn over jet-seeded u
    (parity/jets.py) — exact forward AD with the same semantics as the
    ceres::Jet autodiff the reference uses; residual_fn must be
    scalar-generic (oracle_residuals is). "fd" keeps the historical central
    difference (eps = 1e-7) as a measurement instrument — the jacobi-scaling
    study used its ~1e-7 probe noise as the attribution floor (VERDICT r4
    missing-item 2), which the jet path eliminates.

    jacobi_scaling replicates Ceres' default column scaling
    (trust_region_minimizer.cc EvaluateGradientAndJacobian): at iteration 0
    compute s_i = 1/(1 + ||J col_i||) and FREEZE it; every iteration scale
    the Jacobian columns (J_hat = J S), compute the LM step in scaled space,
    and map back delta = S delta_hat. The gradient-tolerance check uses the
    UNSCALED gradient (Ceres evaluates it before scaling). With Marquardt
    damping D = diag(J^T J) this is provably a no-op whenever the
    [1e-6, 1e32] diagonal clamp does not bind — S^{-1} clamp(S^2 diag) S^{-1}
    = diag — which tools/jacobi_scaling_study.py verifies numerically at the
    benchmark magnitudes; the flag exists to measure that claim, not because
    the trajectories differ."""
    u = np.clip(np.array(u0, dtype=np.float64), lower, upper)
    radius = 1e4
    decrease_factor = 2.0
    iters_run = 0
    scale = None

    def cost(uu):
        r = residual_fn(uu)
        return 0.5 * float(r @ r)

    if jacobian == "jet":
        def resid_jac(uu):
            return value_and_jacobian(residual_fn, uu)
    elif jacobian == "fd":
        def resid_jac(uu):
            eps = 1e-7
            r0 = residual_fn(uu)
            J = np.zeros((len(r0), len(uu)))
            for k in range(len(uu)):
                e = np.zeros(len(uu))
                e[k] = eps
                J[:, k] = (residual_fn(uu + e) - residual_fn(uu - e)) / (2 * eps)
            return r0, J
    else:
        raise ValueError(f"jacobian must be 'jet' or 'fd', got {jacobian!r}")

    c = cost(u)
    term = "max_iter"
    for _ in range(max_iter):
        iters_run += 1
        r, J = resid_jac(u)
        g = J.T @ r
        if np.max(np.abs(g)) <= grad_tol:
            term = "grad_tol"
            break
        if jacobi_scaling and scale is None:
            scale = 1.0 / (1.0 + np.linalg.norm(J, axis=0))
        if jacobi_scaling:
            Js = J * scale  # column scaling: J @ diag(scale)
            jtj_s = Js.T @ Js
            diag = np.clip(np.diag(jtj_s), 1e-6, 1e32)
            A = jtj_s + np.diag(diag / radius)
            try:
                delta = scale * np.linalg.solve(A, -(scale * g))
            except np.linalg.LinAlgError:
                radius /= decrease_factor
                decrease_factor *= 2
                continue
            jtj = J.T @ J  # unscaled, for the (equivalent) model-cost below
        else:
            jtj = J.T @ J
            diag = np.clip(np.diag(jtj), 1e-6, 1e32)
            A = jtj + np.diag(diag / radius)
            try:
                delta = np.linalg.solve(A, -g)
            except np.linalg.LinAlgError:
                radius /= decrease_factor
                decrease_factor *= 2
                continue
        u_new = np.clip(u + delta, lower, upper)
        delta = u_new - u
        model_change = -(delta @ g) - 0.5 * delta @ (jtj @ delta)
        c_new = cost(u_new)
        rho = (c - c_new) / model_change if model_change > 0 else -1.0
        if model_change > 0 and rho > 1e-3:
            shrink = 2 * rho - 1
            radius = min(radius / max(1 / 3, 1 - shrink**3), 1e16)
            decrease_factor = 2.0
            accepted_change = c - c_new
            step_norm = np.linalg.norm(delta)
            unorm = np.linalg.norm(u)
            u, c = u_new, c_new
            if abs(accepted_change) <= fn_tol * (c + accepted_change):
                term = "fn_tol"
                break
            if step_norm <= param_tol * (unorm + param_tol):
                term = "param_tol"
                break
        else:
            radius /= decrease_factor
            decrease_factor *= 2
            if radius < 1e-32:
                term = "min_radius"
                break
    out = (u, c)
    if return_iters:
        out = out + (iters_run,)
    if return_term:
        out = out + (term,)
    return out
