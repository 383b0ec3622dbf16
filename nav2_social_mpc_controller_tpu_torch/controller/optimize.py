"""The per-tick optimisation pipeline, batched: warm-start blending, problem
assembly, batched LM solve, and command/path extraction.

Reference parity target: Optimizer::optimize (optimizer.cpp:148-452) and its
helpers format_to_optimize (:484-551) and the post-solve extraction
(:390-446). Counterpart of the JAX package's ``controller/optimize.py``: the
SFM people projection runs every tick (kernel K5, models/sfm.py) and, for a
scenario with no valid person, emits its padding rows; the three people
critics read the projection and are masked per scenario by
``people_present``.

The solver's evaluation is the fused analytic one (ops/fused_iter.py: the
rollout-sample kernel, then K2), which covers exactly the benchmark critic
set; a config with latent critics (AngleCost / CurvatureCost) adds their
rows' sums on the same rollout (ops/latent.py). The autodiff evaluation
built here (``build_residual_fn`` + ``solver.lm.make_value_grad``, D
forward-mode passes over the whole residual stack) is the reference both
are pinned against; no entry point solves with it.

Shape notes:
  * maxsize = round(max_time/time_step) (optimizer.cpp:492) is static; the
    row buffer is (B, maxsize, 6) and the step axis S = maxsize - 1.
  * The reference shrinks control_horizon/block_length dynamically to the
    velocity count when the path is shorter (optimizer.cpp:248-249). The
    decision-variable buffer stays static (n_blocks from config) but the
    step->block map, horizon gating, bounds, and extraction all use the
    per-scenario dynamic horizon; unused trailing blocks keep their
    warm-start value and receive no gradient.
  * Truncation quirk preserved: a path longer than maxsize keeps only the
    first maxsize-1 poses (optimizer.cpp:493-497).
"""

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from nav2_social_mpc_controller_tpu_torch.core.config import SocialMPCConfig
from nav2_social_mpc_controller_tpu_torch.core.types import (
    AgentsState,
    ControllerCarry,
    Costmap,
    ObstacleDistanceGrid,
    SolveStats,
)
from nav2_social_mpc_controller_tpu_torch.costs import critic_grads as cg
from nav2_social_mpc_controller_tpu_torch.costs import critics
from nav2_social_mpc_controller_tpu_torch.models.motion import (
    block_index_sequence_dynamic,
    dynamic_horizon,
    expand_blocks,
    rollout_poses,
)
from nav2_social_mpc_controller_tpu_torch.models.sfm import project_people
from nav2_social_mpc_controller_tpu_torch.ops import fused_iter, latent
from nav2_social_mpc_controller_tpu_torch.solver.lm import LMConfig, lm_solve, make_value_grad
from nav2_social_mpc_controller_tpu_torch.world.grid import crop_grid_window


@dataclasses.dataclass(frozen=True)
class ProblemDims:
    """Static problem geometry derived from config."""

    maxsize: int  # max optimization rows (poses)
    s: int  # max velocity steps = maxsize - 1
    horizon: int  # static control horizon (clamped to s)
    block_length: int
    n_blocks: int
    n_vf: int  # velocity-feasibility pair count

    @staticmethod
    def from_config(cfg: SocialMPCConfig) -> "ProblemDims":
        maxsize = cfg.trajectorizer.max_steps
        s = maxsize - 1
        h = min(cfg.optimizer.control_horizon, s)
        bl = min(cfg.optimizer.parameter_block_length, h)
        return ProblemDims(
            maxsize=maxsize,
            s=s,
            horizon=h,
            block_length=bl,
            n_blocks=-(-h // bl),
            n_vf=max(0, h // bl - 1),
        )


class OptimizeResult(NamedTuple):
    ok: torch.Tensor  # (B,) bool — usable solution (IsSolutionUsable analogue)
    cmds: torch.Tensor  # (B, maxsize, 2) optimized [v, w] per step
    path: torch.Tensor  # (B, maxsize, 3) re-integrated poses
    n: torch.Tensor  # (B,) int32 valid cmd/pose count
    people_proj: torch.Tensor  # (B, maxsize, N, 6)
    stats: SolveStats
    u: torch.Tensor  # (B, NB, 2) optimized decision blocks
    lm_trace: object = None  # LMTrace when cfg.optimizer.debug_optimizer


def format_to_optimize(
    cfg: SocialMPCConfig,
    dims: ProblemDims,
    ref_poses,  # (B, max_steps + 1, 3) trajectorizer output
    ref_cmds,  # (B, max_steps, 3) [vx, vy, wz]
    n_traj_steps,  # (B,) int32
    speed,  # (B, 2) [v, w] measured
    carry: ControllerCarry,
):
    """Blend current and previous tick's trajectories into the optimization
    rows [x, y, yaw, t, v, w] (optimizer.cpp:484-551).

    Returns (rows (B, maxsize, 6), n_rows (B,) int32)."""
    maxsize = dims.maxsize
    dev = ref_poses.device
    n_poses = n_traj_steps.long() + 1
    n_rows = torch.where(n_poses > maxsize, maxsize - 1, n_poses)

    i = torch.arange(maxsize, device=dev)
    pose_i = ref_poses[:, :maxsize]  # i <= maxsize-1 <= max_steps
    cpw = cfg.optimizer.current_path_weight
    ccw = cfg.optimizer.current_cmds_weight

    prev_n = carry.prev_n.long()[:, None]
    has_prev = prev_n > 0
    blend_pose = has_prev & (i[None, :] < prev_n)
    prev_pose = carry.prev_path[:, i.clamp(0, carry.prev_path.shape[1] - 1)]
    xy = torch.where(
        blend_pose[:, :, None],
        cpw * pose_i[..., 0:2] + (1.0 - cpw) * prev_pose[..., 0:2],
        pose_i[..., 0:2],
    )
    # Raw linear yaw blend, as in the reference (optimizer.cpp:514-516)
    yaw = torch.where(
        blend_pose, cpw * pose_i[..., 2] + (1.0 - cpw) * prev_pose[..., 2], pose_i[..., 2]
    )

    t = (i.to(xy.dtype) * cfg.trajectorizer.time_step)[None, :].expand(xy.shape[0], -1)

    cmd_prev_idx = (i - 1).clamp(0, ref_cmds.shape[1] - 1)
    cur_cmd = ref_cmds[:, cmd_prev_idx][..., 0::2]  # (v = linear.x, w = angular.z)
    blend_cmd = has_prev & ((i[None, :] - 1) < prev_n)
    prev_cmd = carry.prev_cmds[:, (i - 1).clamp(0, carry.prev_cmds.shape[1] - 1)]
    vw = torch.where(blend_cmd[:, :, None], ccw * cur_cmd + (1.0 - ccw) * prev_cmd, cur_cmd)
    vw = torch.where((i == 0)[None, :, None], speed[:, None, :], vw)

    rows = torch.cat([xy, yaw[..., None], t[..., None], vw], dim=-1)

    # Hold the last valid row in the padding for safe downstream gathers.
    last = (n_rows - 1).clamp(0, maxsize - 1)
    last_row = torch.gather(rows, 1, last[:, None, None].expand(-1, 1, 6))
    rows = torch.where((i[None, :] < n_rows[:, None])[:, :, None], rows, last_row)
    return rows, n_rows.to(torch.int32)


class ResidualFn:
    """residual_fn(u (B, D)) -> r (B, R) for one tick's batch of problems,
    differentiable in u (forward or reverse mode).

    Residual layout, per scenario: [social_work, agent_angle, proxemics,
    velocity, goal_align, path_follow, path_align, obstacle] x S steps, then
    pure angle (S) and curvature (S - 1) when their weights are non-zero,
    then the n_vf velocity-feasibility terms. The constructor does the
    u-independent part once per tick: masks, the dynamic-horizon block map,
    targets, the agent-angle selection and the obstacle-window crop around
    pose_0 (exactness is checked at the call boundary, core/validate.py).

    The three people critics take their exact per-step partials
    (costs/critic_grads.py) as derivative rule; the costmap sample launches
    kernel K1 on the card (world/grid.py); the rollout is the prefix-sum
    rollout_poses; the latent rows are ops/latent.py's ``latent_rows``,
    which the solver's evaluation differentiates too.
    """

    def __init__(self, cfg, dims, rows, n_rows, people_proj, people_present, costmap):
        self.cfg = cfg
        self.dims = dims
        s = dims.s
        dev = rows.device
        self.win, self.win_origin = crop_grid_window(
            costmap.data, costmap.origin, costmap.resolution, rows[:, 0, 0:2],
            cfg.optimizer.obstacle_window_cells,
        )
        self.resolution = costmap.resolution
        self.pose0 = rows[:, 0, 0:3]
        n_vel, h_dyn, bl_dyn = dynamic_horizon(n_rows, dims.horizon, dims.block_length)
        j = torch.arange(s, device=dev)
        self.block_idx = block_index_sequence_dynamic(s, h_dyn, bl_dyn)
        self.in_horizon = j[None, :] < h_dyn[:, None]
        self.step_mask = j[None, :] < n_vel[:, None]
        self.social_mask = self.step_mask & people_present[:, None]
        last = (n_rows.long() - 1).clamp(0, dims.maxsize - 1)
        last_row = torch.gather(rows, 1, last[:, None, None].expand(-1, 1, rows.shape[-1]))
        self.final_point = last_row[:, :, 0:2]  # (B, 1, 2)
        self.goal_yaw = last_row[:, :, 2]  # (B, 1)
        self.ref_points = rows[:, 1:, 0:2]  # (B, S, 2) path-align targets (point i+1)
        self.agents_steps = people_proj[:, 1:]  # (B, S, N, 6)
        self.steer, self.agent_active = critics.agent_angle_select(self.pose0, self.agents_steps)
        # Pair q is step i = q + 1: added for 0 < i < control_horizon /
        # block_length and i within the velocity count (optimizer.cpp:364-370).
        vf_step = torch.arange(dims.n_vf, device=dev) + 1
        self.vf_mask = (vf_step[None, :] < (h_dyn // bl_dyn)[:, None]) & (
            vf_step[None, :] < n_vel[:, None]
        )

    def select(self, lanes):
        """This residual function restricted to the scenarios `lanes` (an
        int64 index tensor), every per-scenario tensor gathered."""
        return fused_iter.select_lanes(self, lanes)

    def __call__(self, u_flat):
        cfg, dims = self.cfg, self.dims
        w = cfg.optimizer.weights
        u = u_flat.reshape(-1, dims.n_blocks, 2)
        poses = rollout_poses(self.pose0, u, cfg.trajectorizer.time_step, self.block_idx)
        new_pos = poses[:, 1:, 0:2]
        new_x, new_y, new_yaw = poses[:, 1:, 0], poses[:, 1:, 1], poses[:, 1:, 2]
        vw_steps = expand_blocks(u, self.block_idx)  # (B, S, 2)
        v_steps = vw_steps[..., 0]
        agent_list = fused_iter.agent_list(self.agents_steps)

        parts = []

        def add(r, mask):
            parts.append(torch.where(mask, r, torch.zeros_like(r)))

        add(
            cg.stepwise_critic(
                lambda px, py, pth, v: cg.social_work_grad(
                    w.social_weight, px, py, pth, v, agent_list),
                new_x, new_y, new_yaw, v_steps,
            ),
            self.social_mask,
        )
        add(
            cg.stepwise_critic(
                lambda px, py, pth, v: cg.agent_angle_grad(
                    w.agent_angle_weight, pth, self.steer, self.agent_active),
                new_x, new_y, new_yaw, v_steps,
            ),
            self.social_mask,
        )
        add(
            cg.stepwise_critic(
                lambda px, py, pth, v: cg.proxemics_grad(w.proxemics_weight, px, py, agent_list),
                new_x, new_y, new_yaw, v_steps,
            ),
            self.social_mask,
        )
        add(
            critics.velocity_cost(
                w.velocity_weight, cfg.optimizer.desired_linear_vel, v_steps, self.in_horizon),
            self.step_mask,
        )
        add(critics.goal_align_cost(w.goal_align_weight, self.goal_yaw, new_yaw), self.step_mask)
        add(critics.distance_cost(w.distance_weight, new_pos, self.final_point), self.step_mask)
        add(critics.distance_cost(w.angle_weight, new_pos, self.ref_points), self.step_mask)
        add(
            critics.obstacle_cost(
                w.obstacle_weight, poses[:, 1:], self.win, self.win_origin, self.resolution),
            self.step_mask,
        )
        parts += latent.latent_rows(w, poses, self.final_point, self.step_mask)

        vf = critics.velocity_feasibility_cost(w.velocity_feasibility_weight, u, dims.n_vf)
        parts.append(torch.where(self.vf_mask, vf, torch.zeros_like(vf)))
        return torch.cat(parts, dim=1)


def build_residual_fn(cfg, dims, rows, n_rows, people_proj, people_present, costmap) -> ResidualFn:
    """residual_fn(u (B, D)) -> (B, R), closing over one tick's scenario
    data: rows (B, maxsize, 6), n_rows (B,), people_proj (B, maxsize, N, 6),
    people_present (B,) bool, costmap: core.types.Costmap."""
    return ResidualFn(cfg, dims, rows, n_rows, people_proj, people_present, costmap)


class ResidualValueGrad:
    """value_grad(u) -> (cost, g, jtj) by forward-mode differentiation of a
    ResidualFn (solver.lm.make_value_grad), restrictable to a set of lanes
    like the fused ValueGrad: the reference evaluation that the fused and
    the latent ones (build_value_grad) are held to."""

    def __init__(self, residual_fn: ResidualFn, d: int):
        self.residual_fn = residual_fn
        self.d = d
        self._value_grad = make_value_grad(residual_fn, d)

    def select(self, lanes):
        return ResidualValueGrad(self.residual_fn.select(lanes), self.d)

    def __call__(self, u):
        return self._value_grad(u)


class PreparedProblem(NamedTuple):
    """Everything the LM solve consumes, produced by optimize_prepare."""

    rows: torch.Tensor  # (B, maxsize, 6)
    n_rows: torch.Tensor  # (B,) int32
    people_proj: torch.Tensor  # (B, maxsize, N, 6)
    people_present: torch.Tensor  # (B,) bool — a valid person after the FOV filter
    costmap: Costmap
    u0: torch.Tensor  # (B, D) clipped warm start
    lower: torch.Tensor  # (B, D)
    upper: torch.Tensor  # (B, D)


def make_lm_config(opt) -> LMConfig:
    return LMConfig(
        max_iterations=opt.max_iterations,
        fn_tol=opt.fn_tol,
        gradient_tol=opt.gradient_tol,
        param_tol=opt.param_tol,
    )


def optimize_prepare(
    cfg: SocialMPCConfig,
    ref_poses,
    ref_cmds,
    n_traj_steps,
    speed,
    people: AgentsState,
    costmap: Costmap,
    esdf: ObstacleDistanceGrid,
    carry: ControllerCarry,
) -> PreparedProblem:
    """Problem assembly half of Optimizer::optimize (optimizer.cpp:148-379):
    warm-start blending, SFM people projection, decision-variable packing
    and box bounds."""
    dims = ProblemDims.from_config(cfg)
    rows, n_rows = format_to_optimize(cfg, dims, ref_poses, ref_cmds, n_traj_steps, speed, carry)
    rows = rows.contiguous()

    people_proj = project_people(
        people.state.contiguous(),
        rows,
        n_rows,
        esdf.indexes,
        esdf.origin,
        esdf.resolution,
        esdf.valid,
        maxtime=cfg.trajectorizer.max_time,
        dt=cfg.trajectorizer.time_step,
        people_desired_vel=cfg.people_desired_vel,
        people_radius=cfg.people_radius,
        goal_radius=cfg.goal_radius,
        esdf_window=cfg.esdf_window_cells,
    )

    # Warm start: block b initializes from optimization ROW b's velocity
    # (optimizer.cpp:256-260), row 0 being the measured speed.
    u0 = rows[:, 0 : dims.n_blocks, 4:6]
    if cfg.optimizer.warm_start_mode == "previous_solution":
        # Framework extension (OptimizerConfig.warm_start_mode): start block
        # b from the previous tick's own block-b optimum. prev_cmds holds the
        # block-expanded commands, so the step at each block start carries
        # that block's value.
        starts = (torch.arange(dims.n_blocks, device=rows.device) * dims.block_length).clamp(
            max=carry.prev_cmds.shape[1] - 1
        )
        u_prev = carry.prev_cmds[:, starts]  # (B, NB, 2)
        u0 = torch.where((carry.prev_n > 0)[:, None, None], u_prev, u0)

    # Box bounds on the first control_horizon/block_length blocks
    # (optimizer.cpp:373-379, with the dynamic horizon shrink of :248-249);
    # any remainder block is unbounded.
    opt = cfg.optimizer
    _, h_dyn, bl_dyn = dynamic_horizon(n_rows, dims.horizon, dims.block_length)
    dtype = rows.dtype
    dev = rows.device
    bounded = torch.arange(dims.n_blocks, device=dev)[None, :] < (h_dyn // bl_dyn)[:, None]
    big = float(np.finfo(np.float32).max)
    # Filled on the device: the tick copies nothing from host memory, which a
    # CUDA graph cannot capture (controller/graph.py).
    lo_b = torch.full((2,), opt.v_min, dtype=dtype, device=dev)
    lo_b[1:].fill_(opt.w_min)
    hi_b = torch.full((2,), opt.v_max, dtype=dtype, device=dev)
    hi_b[1:].fill_(opt.w_max)
    b = rows.shape[0]
    lower = torch.where(bounded[:, :, None], lo_b, torch.full_like(lo_b, -big)).reshape(b, -1)
    upper = torch.where(bounded[:, :, None], hi_b, torch.full_like(hi_b, big)).reshape(b, -1)

    u0_clipped = torch.minimum(torch.maximum(u0.reshape(b, -1), lower), upper)
    return PreparedProblem(
        rows=rows,
        n_rows=n_rows,
        people_proj=people_proj,
        people_present=people.valid.any(dim=1),
        costmap=costmap,
        u0=u0_clipped.contiguous(),
        lower=lower.contiguous(),
        upper=upper.contiguous(),
    )


def build_value_grad(cfg: SocialMPCConfig, prep: PreparedProblem):
    """The value_grad of a PreparedProblem: the fused analytic evaluation
    for the benchmark critic set, and for a config with latent critics the
    same plus the latent rows' term (ops/latent.py: LatentValueGrad)."""
    dims = ProblemDims.from_config(cfg)
    args = (cfg, dims, prep.rows, prep.n_rows, prep.people_proj, prep.people_present,
            prep.costmap)
    if fused_iter.can_fuse(cfg):
        return fused_iter.build_value_grad(*args)
    return latent.LatentValueGrad(*args)


def solve_prepared(cfg: SocialMPCConfig, prep: PreparedProblem):
    """Batched LM solve of a PreparedProblem (the ceres::Solve call,
    optimizer.cpp:381). Returns (u (B, D), SolveStats, lm_trace | None);
    lm_trace is the per-iteration LMTrace (optimizer.cpp:122-130) when
    cfg.optimizer.debug_optimizer."""
    opt = cfg.optimizer
    value_grad = build_value_grad(cfg, prep)
    lm_cfg = make_lm_config(opt)
    if opt.debug_optimizer:
        return lm_solve(
            value_grad, prep.u0, prep.lower, prep.upper, lm_cfg, trace_len=opt.max_iterations
        )
    return (*lm_solve(value_grad, prep.u0, prep.lower, prep.upper, lm_cfg), None)


def optimize_finish(cfg: SocialMPCConfig, prep: PreparedProblem, u_flat, stats: SolveStats,
                    lm_trace=None) -> OptimizeResult:
    """Extraction half of Optimizer::optimize: saving_velocities[j] = block
    min(j, H-1)//bl for j = 0..S (optimizer.cpp:390-419 incl. the
    post-horizon extrapolation), then the path is re-integrated from pose_0
    (:420-446)."""
    dims = ProblemDims.from_config(cfg)
    dt = cfg.trajectorizer.time_step
    rows, n_rows = prep.rows, prep.n_rows
    u = u_flat.reshape(-1, dims.n_blocks, 2)

    _, h_dyn, bl_dyn = dynamic_horizon(n_rows, dims.horizon, dims.block_length)
    ext_idx = block_index_sequence_dynamic(dims.s + 1, h_dyn, bl_dyn)
    cmds_out = expand_blocks(u, ext_idx)  # (B, maxsize, 2)
    path_out = rollout_poses(rows[:, 0, 0:3], u, dt, ext_idx)[:, 1:]  # (B, maxsize, 3)

    return OptimizeResult(
        ok=stats.usable & (n_rows >= 2),
        cmds=cmds_out,
        path=path_out,
        n=n_rows,
        people_proj=prep.people_proj,
        stats=stats,
        u=u,
        lm_trace=lm_trace,
    )
