"""The per-tick optimisation pipeline, batched: warm-start blending, problem
assembly, batched LM solve, and command/path extraction.

Reference parity target: Optimizer::optimize (optimizer.cpp:148-452) and its
helpers format_to_optimize (:484-551) and the post-solve extraction
(:390-446). Counterpart of the JAX package's ``controller/optimize.py``: the
SFM people projection runs every tick (kernel K5, models/sfm.py) and, for a
scenario with no valid person, emits its padding rows; the three people
critics read the projection and are masked per scenario by
``people_present``.

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
from nav2_social_mpc_controller_tpu_torch.models.motion import (
    block_index_sequence_dynamic,
    dynamic_horizon,
    expand_blocks,
    rollout_poses,
)
from nav2_social_mpc_controller_tpu_torch.models.sfm import project_people
from nav2_social_mpc_controller_tpu_torch.ops import fused_iter
from nav2_social_mpc_controller_tpu_torch.solver.lm import LMConfig, lm_solve


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
    cur_cmd = ref_cmds[:, cmd_prev_idx][..., [0, 2]]  # (v = linear.x, w = angular.z)
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

    # Box bounds on the first control_horizon/block_length blocks
    # (optimizer.cpp:373-379, with the dynamic horizon shrink of :248-249);
    # any remainder block is unbounded.
    opt = cfg.optimizer
    _, h_dyn, bl_dyn = dynamic_horizon(n_rows, dims.horizon, dims.block_length)
    dtype = rows.dtype
    dev = rows.device
    bounded = torch.arange(dims.n_blocks, device=dev)[None, :] < (h_dyn // bl_dyn)[:, None]
    big = float(np.finfo(np.float32).max)
    lo_b = torch.tensor([opt.v_min, opt.w_min], dtype=dtype, device=dev)
    hi_b = torch.tensor([opt.v_max, opt.w_max], dtype=dtype, device=dev)
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


def solve_prepared(cfg: SocialMPCConfig, prep: PreparedProblem):
    """Batched LM solve of a PreparedProblem (the ceres::Solve call,
    optimizer.cpp:381). Returns (u (B, D), SolveStats)."""
    dims = ProblemDims.from_config(cfg)
    value_grad = fused_iter.build_value_grad(
        cfg, dims, prep.rows, prep.n_rows, prep.people_proj, prep.people_present, prep.costmap
    )
    return lm_solve(value_grad, prep.u0, prep.lower, prep.upper, make_lm_config(cfg.optimizer))


def optimize_finish(cfg: SocialMPCConfig, prep: PreparedProblem, u_flat, stats: SolveStats) -> OptimizeResult:
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
    )
