"""Controller facade: the batched per-tick step function.

Reference parity target: SocialMPCController (social_mpc_controller.cpp).
The 20 Hz computeVelocityCommands orchestration (:162-257) becomes a
function on a batch of B scenarios

    step(scenario, carry) -> (cmd, aux, carry')

with the warm-start memory (TrajectoryMemory singleton) as an explicit carry
and the degradation ladder (SURVEY.md section 5.3) as per-scenario status
codes. ``make_step_batch`` is the workhorse entry point: thousands of
independent solves per call, on the card unless the caller asks for the CPU.
"""

from typing import NamedTuple

import torch

from nav2_social_mpc_controller_tpu_torch.controller.optimize import (
    PreparedProblem,
    ProblemDims,
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
    resolve_device,
)
from nav2_social_mpc_controller_tpu_torch.core.validate import (
    check_supported_config,
    make_window_validator,
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
    invalid[..., AGENT_T] = -1.0
    return AgentsState(state=torch.where(keep[..., None], st, invalid))


def make_carry(cfg: SocialMPCConfig, batch: int, device="cuda", dtype=torch.float32) -> ControllerCarry:
    """Fresh warm-start memory for `batch` scenarios, sized for this config."""
    dev = resolve_device(device)
    dims = ProblemDims.from_config(cfg)
    return ControllerCarry(
        prev_path=torch.zeros((batch, dims.maxsize, 3), dtype=dtype, device=dev),
        prev_cmds=torch.zeros((batch, dims.maxsize, 2), dtype=dtype, device=dev),
        prev_n=torch.zeros((batch,), dtype=torch.int32, device=dev),
        plan_start=torch.zeros((batch,), dtype=torch.int32, device=dev),
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
    u_flat, stats = solve_prepared(cfg, ctx.prep)
    return step_post(cfg, ctx, carry, u_flat, stats)


def step_post(cfg: SocialMPCConfig, ctx: StepContext, carry: ControllerCarry, u_flat, stats):
    """Tick tail: extraction, degradation ladder, warm-start carry update."""
    res = optimize_finish(cfg, ctx.prep, u_flat, stats)

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
    seed_cmds = ctx.traj_cmds[:, : dims.maxsize][..., [0, 2]]
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
    )
    return cmd, aux, new_carry


def make_step_batch(cfg: SocialMPCConfig, device="cuda", dtype=torch.float32):
    """The batched step closure for `cfg`: step(scenario, carry) ->
    (ControlCommand, StepAux, ControllerCarry), all with a leading batch axis.

    `device` defaults to the card; asking for it where there is none raises
    (the tests pass device="cpu", which runs the kernels' plain versions).
    Scenario and carry tensors must already live on `device` with float
    dtype `dtype` (core.types.scenario_from_numpy / make_carry).

    Scenarios may carry valid people (`AgentsState`, t != -1): the three
    people critics are on per scenario, for those that keep a valid person
    after the FOV filter. Configurations the port does not implement yet —
    latent critics, debug_optimizer, warm_start_mode="previous_solution" —
    are refused with NotImplementedError. The batch checks (obstacle- and
    ESDF-window exactness against the ACTUAL grid resolutions) run once per
    distinct input buffer (identity-cached), so steady-state ticks that reuse
    scenario buffers pay no host synchronisation."""
    dev = resolve_device(device)
    check_supported_config(cfg)
    check = make_window_validator(cfg)

    def run(scenario: Scenario, carry: ControllerCarry):
        pose = scenario.robot.pose
        if pose.device.type != dev.type or pose.dtype != dtype:
            raise ValueError(
                f"make_step_batch was built for {dev.type}/{dtype} but the scenario "
                f"is on {pose.device}/{pose.dtype}"
            )
        check(scenario)
        with torch.no_grad():
            return step(cfg, scenario, carry)

    return run
