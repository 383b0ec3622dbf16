"""Checks at the call boundary of the batched step: window exactness, and
the guard that refuses the configurations the port does not implement yet.

`OptimizerConfig.obstacle_window_cells` and
`SocialMPCConfig.esdf_window_cells` are EXACT-output optimisations only when
the window covers the relevant reachable set:

  * obstacle window — the obstacle critic samples the costmap at the rollout
    front points (pose + 0.25 m heading offset,
    obstacle_cost_function.hpp:152-163). From pose_0 (the crop centre) the
    robot can travel at most S * time_step * v_max in S steps
    (optimizer.cpp:373-379 bounds), so every sample lies within
    (S*dt*v_max + front_offset)/resolution cells of the centre, and the
    Catmull-Rom stencil reads 2 more cells beyond the sample cell.

  * ESDF window — the SFM projection refreshes each agent's nearest-obstacle
    cell from the agent's CURRENT position every scan step
    (optimizer.cpp:641-645); updatePosition clamps agent speed to
    people_desired_vel (sfm.hpp:533-540), so after the scan's S-1 steps an
    agent has drifted at most people_desired_vel * dt * (S-1) from the
    window centre, plus 1 cell of floor() slack (models/sfm.py).

Grid resolution is scenario data on the device, so the checks read it back
once per distinct input buffer (identity-cached), never once per tick.
"""

import math

FRONT_OFFSET = 0.25  # "size of jackal" heading offset (obstacle_cost_function.hpp:152)


def obstacle_window_min_cells(cfg, resolution: float) -> int:
    """Smallest exact obstacle_window_cells at this costmap resolution."""
    s = cfg.trajectorizer.max_steps - 1  # velocity steps of the rollout
    reach_m = s * cfg.trajectorizer.time_step * cfg.optimizer.v_max + FRONT_OFFSET
    return 2 * (math.ceil(reach_m / resolution) + 2)


def esdf_window_min_cells(cfg, resolution: float) -> int:
    """Smallest exact esdf_window_cells at this ESDF resolution."""
    s = cfg.trajectorizer.max_steps
    drift_m = cfg.people_desired_vel * cfg.trajectorizer.time_step * (s - 1)
    return 2 * (math.ceil(drift_m / resolution) + 1)


def check_esdf_window(cfg, resolution: float) -> None:
    """Raise ValueError when the configured ESDF window is smaller than its
    exactness bound at this (smallest) ESDF resolution."""
    window = cfg.esdf_window_cells
    if window <= 0 or resolution <= 0.0:
        return
    need = esdf_window_min_cells(cfg, resolution)
    if window < need:
        raise ValueError(
            f"esdf_window_cells={window} < exactness bound {need} at ESDF "
            f"resolution {resolution}: projected agents could leave their "
            "nearest-obstacle window. Raise esdf_window_cells or set it to 0."
        )


def check_obstacle_window(cfg, resolution: float) -> None:
    """Raise ValueError when the configured obstacle window is smaller than
    its exactness bound at this (smallest) costmap resolution."""
    window = cfg.optimizer.obstacle_window_cells
    if window <= 0 or resolution <= 0.0:
        return
    need = obstacle_window_min_cells(cfg, resolution)
    if window < need:
        raise ValueError(
            f"obstacle_window_cells={window} < exactness bound {need} at costmap "
            f"resolution {resolution}: the rolling-window crop would clip "
            "reachable obstacle-critic samples. Raise obstacle_window_cells or "
            "set it to 0."
        )


def check_supported_config(cfg) -> None:
    """Refuse configurations whose code paths are not ported yet, instead of
    silently solving something else."""
    w = cfg.optimizer.weights
    if w.pure_angle_weight != 0.0 or w.curvature_weight != 0.0:
        raise NotImplementedError(
            "latent critics (pure_angle_weight / curvature_weight) need the "
            "autodiff residual path, which is not ported yet"
        )
    if cfg.optimizer.debug_optimizer:
        raise NotImplementedError("debug_optimizer (the LM trace) is not ported yet")
    if cfg.optimizer.warm_start_mode != "reference":
        raise NotImplementedError(
            "warm_start_mode='previous_solution' is not ported yet"
        )


def make_window_validator(cfg):
    """Identity-cached boundary check: returns check(scenario) that runs the
    window checks once per distinct set of input buffers, so steady-state ticks that reuse scenario buffers pay no
    host synchronisation. The cache HOLDS the keyed tensors (not just their
    ids), so a freed buffer's id cannot be recycled by a new, never-checked
    tensor. Tensors are mutable: a caller that overwrites a checked buffer
    in place takes the check upon itself."""
    cache = {}

    def check(scenario) -> None:
        held = (scenario.costmap.resolution, scenario.esdf.resolution)
        key = tuple(id(t) for t in held)
        if key in cache:
            return
        check_obstacle_window(cfg, float(scenario.costmap.resolution.min()))
        check_esdf_window(cfg, float(scenario.esdf.resolution.min()))
        if len(cache) >= 1024:  # bound the cache for long campaigns
            cache.clear()
        cache[key] = held

    return check
