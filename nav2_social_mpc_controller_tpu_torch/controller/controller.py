"""Controller facade: the per-tick step function on a batch of scenarios,
its single-scenario wrapper, and a stateful host wrapper mirroring the
nav2_core::Controller lifecycle API.

Reference parity target: SocialMPCController (social_mpc_controller.cpp).
The 20 Hz computeVelocityCommands orchestration (:162-257) becomes a
function on a batch of B scenarios

    step(scenario, carry) -> (cmd, aux, carry')

with the warm-start memory (TrajectoryMemory singleton) as an explicit carry
and the degradation ladder (SURVEY.md section 5.3) as per-scenario status
codes. ``make_step_batch`` is the workhorse entry point: thousands of
independent solves per call, on the card unless the caller asks for the CPU.
``make_step`` runs one robot's tick as a batch of one, and
``SocialMPCController`` drives it tick by tick.
"""

from typing import NamedTuple, Tuple

import numpy as np
import torch

from nav2_social_mpc_controller_tpu_torch.controller.optimize import (
    PreparedProblem,
    ProblemDims,
    build_value_grad,
    make_lm_config,
    optimize_finish,
    optimize_prepare,
    solve_prepared,
)
from nav2_social_mpc_controller_tpu_torch.controller.path_handler import transform_global_plan
from nav2_social_mpc_controller_tpu_torch.controller.trajectorizer import trajectorize
from nav2_social_mpc_controller_tpu_torch.core.config import SocialMPCConfig
from nav2_social_mpc_controller_tpu_torch.core.types import (
    AGENT_T,
    STATUS_FALLBACK_CMDS,
    STATUS_FALLBACK_CRAWL,
    STATUS_OK,
    AgentsState,
    ControlCommand,
    ControllerCarry,
    Scenario,
    StepAux,
    carry_from_numpy,
    resolve_device,
    scenario_from_numpy,
    tree_map,
)
from nav2_social_mpc_controller_tpu_torch.core.validate import (
    make_window_validator,
    validate_scenario_windows,
)
from nav2_social_mpc_controller_tpu_torch.solver.batched import (
    compacted_capacity,
    lm_solve_batch_compacted,
)
from nav2_social_mpc_controller_tpu_torch.utils.angles import shortest_angular_distance

CRAWL_LINEAR_VEL = 0.1  # fallback cmd (social_mpc_controller.cpp:183)


def fov_filter(cfg: SocialMPCConfig, people: AgentsState, robot_pose, costmap) -> AgentsState:
    """Keep people inside the costmap and within the field-of-view cone
    (social_mpc_controller.cpp:197-215); others become invalid (t = -1).
    people.state (B, N, 6); robot_pose (B, 3)."""
    st = people.state
    px, py = st[..., 0], st[..., 1]

    h, w = costmap.data.shape[-2], costmap.data.shape[-1]
    ox, oy = costmap.origin[:, 0:1], costmap.origin[:, 1:2]
    res = costmap.resolution[:, None]
    # Costmap2D::worldToMap: false if wx < origin or cell >= size
    in_map = (px >= ox) & (py >= oy) & (((px - ox) / res) < w) & (((py - oy) / res) < h)

    angle_to_person = torch.atan2(py - robot_pose[:, 1:2], px - robot_pose[:, 0:1])
    rel = shortest_angular_distance(robot_pose[:, 2:3], angle_to_person)
    keep = people.valid & in_map & (rel.abs() < cfg.fov_angle)

    invalid = torch.zeros_like(st)
    invalid[..., AGENT_T].fill_(-1.0)  # a fill, no copy from the host (controller/graph.py)
    return AgentsState(state=torch.where(keep[..., None], st, invalid))


def prune_plan(path, start: int):
    """Erase the first `start` poses from a (host-side, NumPy) plan, keeping
    the static buffer shape: remaining poses shift to the front, the tail
    holds the last valid pose, and the count shrinks (path_handler.cpp:100
    erases plan_.poses.begin()..transformation_begin from the stored plan)."""
    start = int(start)
    n = int(path.n)
    if start <= 0 or n <= 0:
        return path
    start = min(start, n - 1)  # never erase the whole plan
    p = path.points.shape[0]
    n_new = n - start
    src = np.minimum(start + np.arange(p), start + n_new - 1)
    src = np.clip(src, 0, p - 1)
    return path._replace(
        points=np.asarray(path.points)[src],
        yaw=np.asarray(path.yaw)[src],
        n=np.int32(n_new),
    )


def make_carry(cfg: SocialMPCConfig, batch=None, device="cuda", dtype=torch.float32) -> ControllerCarry:
    """Fresh warm-start memory for `batch` scenarios, sized for this config;
    with batch=None, the unbatched carry of one scenario (for make_step)."""
    dev = resolve_device(device)
    dims = ProblemDims.from_config(cfg)
    lead = () if batch is None else (batch,)
    return ControllerCarry(
        prev_path=torch.zeros(lead + (dims.maxsize, 3), dtype=dtype, device=dev),
        prev_cmds=torch.zeros(lead + (dims.maxsize, 2), dtype=dtype, device=dev),
        prev_n=torch.zeros(lead, dtype=torch.int32, device=dev),
        plan_start=torch.zeros(lead, dtype=torch.int32, device=dev),
    )


class StepContext(NamedTuple):
    """Pre-solve state of one control tick: the prepared LM problem plus the
    trajectorizer outputs and plan cursor the post-solve half consumes."""

    prep: PreparedProblem
    traj_ok: torch.Tensor
    traj_poses: torch.Tensor
    traj_cmds: torch.Tensor
    traj_n_steps: torch.Tensor
    plan_start_index: torch.Tensor


def step_pre(cfg: SocialMPCConfig, scenario: Scenario, carry: ControllerCarry) -> StepContext:
    """Tick head: plan windowing -> trajectorize -> FOV filter -> problem
    assembly (computeVelocityCommands up to the ceres::Solve call)."""
    robot_pose = scenario.robot.pose

    # --- plan windowing (path_handler.cpp:40-108) ---
    h, w = scenario.costmap.data.shape[-2:]
    size_x = w * scenario.costmap.resolution
    size_y = h * scenario.costmap.resolution
    dist_threshold = torch.maximum(size_x, size_y) / 2.0
    windowed = transform_global_plan(
        scenario.path,
        robot_pose,
        cfg.max_robot_pose_search_dist,
        dist_threshold,
        start=carry.plan_start,
    )

    # --- reference trajectory (path_trajectorizer.cpp:120-288) ---
    traj = trajectorize(cfg.trajectorizer, windowed.path, robot_pose)

    # --- people FOV filter (social_mpc_controller.cpp:197-215) ---
    people = fov_filter(cfg, scenario.people, robot_pose, scenario.costmap)

    prep = optimize_prepare(
        cfg, traj.poses, traj.cmds, traj.n_steps, scenario.robot.speed, people,
        scenario.costmap, scenario.esdf, carry,
    )
    return StepContext(
        prep=prep,
        traj_ok=traj.ok,
        traj_poses=traj.poses,
        traj_cmds=traj.cmds,
        traj_n_steps=traj.n_steps,
        plan_start_index=windowed.start_index,
    )


def step(cfg: SocialMPCConfig, scenario: Scenario, carry: ControllerCarry):
    """One control tick for a batch (computeVelocityCommands,
    social_mpc_controller.cpp:162-257).

    Returns (ControlCommand, StepAux, ControllerCarry)."""
    ctx = step_pre(cfg, scenario, carry)
    u_flat, stats, lm_trace = solve_prepared(cfg, ctx.prep)
    return step_post(cfg, ctx, carry, u_flat, stats, lm_trace)


def step_post(cfg: SocialMPCConfig, ctx: StepContext, carry: ControllerCarry, u_flat, stats,
              lm_trace=None):
    """Tick tail: extraction, degradation ladder, warm-start carry update."""
    res = optimize_finish(cfg, ctx.prep, u_flat, stats, lm_trace)

    # --- command selection / degradation ladder ---
    opt_v = res.cmds[:, 0, 0]
    opt_w = res.cmds[:, 0, 1]
    init_v = ctx.traj_cmds[:, 0, 0]
    init_w = ctx.traj_cmds[:, 0, 2]

    use_opt = ctx.traj_ok & res.ok
    use_init = ctx.traj_ok & ~res.ok

    crawl = torch.full_like(opt_v, CRAWL_LINEAR_VEL)
    zero = torch.zeros_like(opt_v)
    linear_x = torch.where(use_opt, opt_v, torch.where(use_init, init_v, crawl))
    angular_z = torch.where(use_opt, opt_w, torch.where(use_init, init_w, zero))
    # linear.y forced to zero in the published command (:252-255)
    cmd = ControlCommand(linear_x=linear_x, linear_y=zero, angular_z=angular_z)

    status = torch.full_like(ctx.traj_n_steps, STATUS_FALLBACK_CRAWL)
    status = torch.where(use_init, torch.full_like(status, STATUS_FALLBACK_CMDS), status)
    status = torch.where(use_opt, torch.full_like(status, STATUS_OK), status)

    # --- warm-start memory update (optimizer.cpp:174-186, 448-449) ---
    dims = ProblemDims.from_config(cfg)
    # First-tick seeding with the trajectorized path/cmds (truncated to the
    # carry buffer) even if the solve then fails:
    seed_n = (ctx.traj_n_steps + 1).clamp(max=dims.maxsize)
    need_seed = (carry.prev_n == 0) & ctx.traj_ok
    seed_path = ctx.traj_poses[:, : dims.maxsize]
    seed_cmds = ctx.traj_cmds[:, : dims.maxsize][..., 0::2]  # [vx, wz]
    base_path = torch.where(need_seed[:, None, None], seed_path, carry.prev_path)
    base_cmds = torch.where(need_seed[:, None, None], seed_cmds, carry.prev_cmds)
    base_n = torch.where(need_seed, seed_n, carry.prev_n)
    # The plan-advance cursor moves every tick regardless of solve success —
    # the reference erases passed poses in transformGlobalPlan, before the
    # optimizer even runs (path_handler.cpp:100).
    new_carry = ControllerCarry(
        prev_path=torch.where(use_opt[:, None, None], res.path, base_path),
        prev_cmds=torch.where(use_opt[:, None, None], res.cmds, base_cmds),
        prev_n=torch.where(use_opt, res.n, base_n),
        plan_start=ctx.plan_start_index,
    )

    aux = StepAux(
        local_path=res.path,
        ref_path=ctx.traj_poses,
        cmds=res.cmds,
        people_proj=res.people_proj,
        status=status,
        solve=res.stats,
        plan_start_index=ctx.plan_start_index,
        lm_trace=res.lm_trace,
    )
    return cmd, aux, new_carry


def make_step_batch(cfg: SocialMPCConfig, device="cuda", dtype=torch.float32,
                    validate: bool = True, capture: bool = True):
    """The batched step closure for `cfg`: step(scenario, carry) ->
    (ControlCommand, StepAux, ControllerCarry), all with a leading batch axis.

    `device` defaults to the card; asking for it where there is none raises
    (the tests pass device="cpu", which runs the kernels' plain versions).
    Scenario and carry tensors must already live on `device` with float
    dtype `dtype` (core.types.scenario_from_numpy / make_carry).

    Scenarios may carry valid people (`AgentsState`, t != -1): the three
    people critics are on per scenario, for those that keep a valid person
    after the FOV filter. Every OptimizerConfig is accepted: the benchmark
    critic sets take the fused evaluation (the rollout-sample kernel, then
    K2), a config with latent critics (pure_angle_weight / curvature_weight)
    the same plus their rows' term (ops/latent.py); debug_optimizer returns
    the per-iteration LMTrace as aux.lm_trace and runs the general LM
    iteration (kernel K7); warm_start_mode="previous_solution" starts each
    block from the previous tick's optimum. The batch checks (obstacle- and
    ESDF-window exactness against the ACTUAL grid resolutions) run once per
    distinct input buffer (identity-cached), so steady-state ticks that reuse
    scenario buffers pay no host synchronisation. ``validate=False`` opts
    out for callers that validated at construction (the built-in generators
    already do).

    With ``capture`` (the default), every config (with or without
    debug_optimizer or latent critics) gets the staged tick of
    controller/graph.py: on CUDA recorded as CUDA graphs at the first call
    with each input signature and launched after as one parent graph whose
    LM solve loops on the device, the port's counterpart of the JAX
    package's jax.jit and lax.while_loop; on the CPU the same stages run as
    plain functions. ``capture=False`` runs the tick eagerly from Python, the
    reference the graphs are held to. The returned step's ``captured`` says
    which runs."""
    dev = resolve_device(device)
    if capture:
        # graph.py builds on this module's step_pre / step_post
        from nav2_social_mpc_controller_tpu_torch.controller import graph

        return _checked(cfg, dev, dtype, graph.GraphTick(cfg, dev), validate)
    return _checked(cfg, dev, dtype, lambda scenario, carry: step(cfg, scenario, carry),
                    validate)


class StepFunction:
    """step(scenario, carry) -> (cmd, aux, carry'): `run` with the tick it
    drives as `tick` (a graph.GraphTick for the staged tick). ``captured``
    says whether the tick runs as CUDA graphs."""

    def __init__(self, run, tick):
        self._run = run
        self.tick = tick

    @property
    def captured(self) -> bool:
        return bool(getattr(self.tick, "captured", False))

    def __call__(self, scenario, carry):
        return self._run(scenario, carry)


def _checked(cfg: SocialMPCConfig, device, dtype, fn, validate: bool = True) -> StepFunction:
    """fn(scenario, carry) behind the call-boundary checks (device, dtype,
    and, with `validate`, window exactness), with autograd's reverse mode
    off."""
    dev = resolve_device(device)
    check = make_window_validator(cfg) if validate else None

    def run(scenario: Scenario, carry: ControllerCarry):
        pose = scenario.robot.pose
        if pose.device.type != dev.type or pose.dtype != dtype:
            raise ValueError(
                f"the step was built for {dev.type}/{dtype} but the scenario "
                f"is on {pose.device}/{pose.dtype}"
            )
        if check is not None:
            check(scenario)
        with torch.no_grad():
            return fn(scenario, carry)

    return StepFunction(run, fn)


class CompactedTick:
    """make_step_batch_compacted's eager tick: step_pre -> the width-ladder
    solver -> step_post, the reference the staged tick is held to.
    ``width_log`` holds the width of each LM iteration of the last tick."""

    def __init__(self, cfg: SocialMPCConfig, capacity_frac: float):
        self.cfg = cfg
        self.capacity_frac = capacity_frac
        self.lm_cfg = make_lm_config(cfg.optimizer)
        self.width_log = []

    def __call__(self, scenario: Scenario, carry: ControllerCarry):
        cfg = self.cfg
        ctx = step_pre(cfg, scenario, carry)
        prep = ctx.prep
        self.width_log = []
        u_flat, stats = lm_solve_batch_compacted(
            build_value_grad(cfg, prep), prep.u0, prep.lower, prep.upper, self.lm_cfg,
            compacted_capacity(prep.u0.shape[0], self.capacity_frac), width_log=self.width_log,
        )
        return step_post(cfg, ctx, carry, u_flat, stats)


def make_step_batch_compacted(cfg: SocialMPCConfig, capacity_frac: float = 0.25,
                              device="cuda", dtype=torch.float32, validate: bool = True,
                              capture: bool = True):
    """Batched step with converged-lane compaction in the LM solve
    (solver/batched.py): step_pre -> the width-ladder solver -> step_post.
    Per-lane results are identical to make_step_batch's; the gain is that a
    warm-started batch (warm_start_mode="previous_solution") stops paying
    full-width iterations once the laggard set fits a narrower width, down to
    capacity_frac * batch lanes. debug_optimizer is unsupported here (the
    per-iteration trace belongs to the plain loop).

    With ``capture`` (the default) it gets the staged tick of
    controller/graph_compacted.py: CUDA graphs per rung of the ladder on the
    card, the counterpart of the JAX package's jitted step; the same stages
    as plain functions on the CPU. ``capture=False`` runs the eager tick
    (``CompactedTick``). The step's ``tick.width_log`` holds the widths its
    last tick ran, ``captured`` whether it replays graphs."""
    if cfg.optimizer.debug_optimizer:
        raise ValueError("compaction does not support debug_optimizer")
    dev = resolve_device(device)
    if capture:
        from nav2_social_mpc_controller_tpu_torch.controller import graph_compacted

        return _checked(cfg, dev, dtype,
                        graph_compacted.CompactedGraphTick(cfg, capacity_frac, dev), validate)
    return _checked(cfg, dev, dtype, CompactedTick(cfg, capacity_frac), validate)


def first_lane(tree):
    """The first (only) scenario of a batched tree: every tensor leaf loses
    its leading axis; None stays None."""
    return tree_map(lambda x: x[0] if isinstance(x, torch.Tensor) else x, tree)


def make_step(cfg: SocialMPCConfig, device="cuda", dtype=torch.float32,
              capture: bool = True):
    """Single-scenario step closure: step(scenario, carry) -> (cmd, aux,
    carry') for ONE unbatched scenario and its unbatched carry
    (make_carry(cfg) with batch=None), the results unbatched too.

    The scenario's leaves may be NumPy (or array-like) or tensors; NumPy
    leaves are copied to `device` on every call (what a robot's tick pays to
    hand its sensor data over), tensors already on `device` are used as they
    are. It runs as a batch of one through the batched step (the same code
    and kernels: every kernel works scenario by scenario, so the result is
    the same scenario's lane of a wider batch). Like the JAX package's
    make_step, it does not check the windows (validate_scenario_windows;
    SocialMPCController checks once, on its first tick). ``capture`` is
    make_step_batch's: the batch of one is one graph launch on the card."""
    dev = resolve_device(device)
    batched = make_step_batch(cfg, device=dev, dtype=dtype, validate=False, capture=capture)

    def run(scenario: Scenario, carry: ControllerCarry):
        if np.ndim(scenario.robot.pose) != 1 or np.ndim(carry.prev_path) != 2:
            raise ValueError(
                "make_step takes one unbatched scenario and carry (robot.pose of shape "
                "(3,), prev_path (maxsize, 3)); use make_step_batch for a batch"
            )
        sc = scenario_from_numpy(scenario, device=dev, dtype=dtype)
        return first_lane(batched(sc, carry_from_numpy(carry, device=dev, dtype=dtype)))

    return StepFunction(run, batched.tick)


class SocialMPCController:
    """Stateful host wrapper with nav2_core::Controller-shaped lifecycle API
    (social_mpc_controller.hpp:70-113). Holds the global plan and the
    warm-start carry; compute_velocity_commands drives make_step on
    `device` (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg: SocialMPCConfig, device="cuda", dtype=torch.float32):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        self._step = make_step(cfg, self.device, dtype)
        self._carry = make_carry(cfg, None, self.device, dtype)
        self._plan = None
        self._active = False
        self._windows_validated = False

    # Lifecycle (configure happens in __init__)
    def activate(self):
        self._active = True

    def deactivate(self):
        self._active = False

    def cleanup(self):
        self._plan = None
        self._carry = make_carry(self.cfg, None, self.device, self.dtype)

    def set_plan(self, path):
        """setPlan (social_mpc_controller.cpp:260-263): installing a new plan
        replaces the stored one (path_handler.cpp:110-113), so the
        plan-advance cursor resets; the warm-start memory persists (the
        reference's TrajectoryMemory is a process singleton)."""
        self._plan = path
        self._carry = self._carry._replace(
            plan_start=torch.zeros((), dtype=torch.int32, device=self.device))

    def set_speed_limit(self, speed_limit: float, percentage: bool):
        """setSpeedLimit — a deliberate no-op, faithfully reproducing the
        reference's dead-store implementation (social_mpc_controller.cpp:265-285)."""

    def compute_velocity_commands(self, scenario: Scenario) -> Tuple[ControlCommand, StepAux]:
        if not self._windows_validated:
            # Hard exactness check of the two windows against the actual
            # grid resolutions (core/validate.py), once: later ticks run the
            # unchecked step and pay no host synchronisation for it.
            validate_scenario_windows(
                self.cfg, scenario.costmap.resolution, scenario.esdf.resolution
            )
            self._windows_validated = True
        if self._plan is not None:
            scenario = scenario._replace(path=self._plan)
        cmd, aux, self._carry = self._step(scenario, self._carry)
        # Plan pruning — the reference ERASES [begin(), transformation_begin)
        # from its plan copy every tick (path_handler.cpp:100) — is the
        # carry's plan_start cursor, advanced to aux.plan_start_index; the
        # next tick's search window starts from that pruned head (prune_plan
        # is the host utility for drivers that shrink their plan buffers;
        # they must then reset the cursor, e.g. via set_plan).
        return cmd, aux
