"""Core tensor types of the PyTorch port, and the state converter.

Counterpart of the JAX package's ``core/types.py`` (same names, same field
order, same reference mapping — SURVEY.md section 2):

  AgentsState          <- AgentStatus / AgentsStates (type_definitions.hpp:6-9);
                          t == -1 marks an invalid/padded agent
  Costmap              <- nav2_costmap_2d::Costmap2D char map + ceres::Grid2D
  ObstacleDistanceGrid <- obstacle_distance_msgs::ObstacleDistance
  PathInput            <- nav_msgs::Path (padded, counted)
  ControllerCarry      <- TrajectoryMemory singleton, as an explicit carry
  Scenario             <- the per-tick world input of computeVelocityCommands

Every field is a ``torch.Tensor`` with the scenario-batch axis FIRST and
written out: the port has no vmap, so a "scenario" is always a batch of B
scenarios (B may be 1). Counts and cursors are int32, masks are bool.

The converter is what "carrying the state across" means for a system with no
weights: a Scenario / ControllerCarry / config built by either package, as
NumPy leaves, becomes this package's tensors (``scenario_from_numpy``,
``carry_from_numpy``, ``config_from_dict``) and back (``to_numpy``), so both
packages can compute on identical inputs.
"""

from typing import NamedTuple

import numpy as np
import torch

from nav2_social_mpc_controller_tpu_torch.core.config import config_from_dict  # noqa: F401

# AgentsState state-vector component indices (tools/type_definitions.hpp:6)
AGENT_X = 0
AGENT_Y = 1
AGENT_YAW = 2
AGENT_T = 3  # timestamp; -1.0 == invalid agent
AGENT_LV = 4  # linear velocity magnitude
AGENT_AV = 5  # angular velocity


class AgentsState(NamedTuple):
    """States of N agents per scenario: (B, N, 6) [x, y, yaw, t, lv, av]."""

    state: torch.Tensor

    @property
    def valid(self):
        """Agent is real iff t != -1 (optimizer.cpp:470-473)."""
        return self.state[..., AGENT_T] != -1.0


class RobotState(NamedTuple):
    """pose (B, 3) [x, y, yaw] in the planning frame; speed (B, 2) measured
    [linear, angular] body twist."""

    pose: torch.Tensor
    speed: torch.Tensor


class PathInput(NamedTuple):
    """Padded geometric plan: points (B, P, 2), yaw (B, P), n (B,) int32.
    Positions beyond n hold the last valid pose."""

    points: torch.Tensor
    yaw: torch.Tensor
    n: torch.Tensor

    @property
    def valid(self):
        idx = torch.arange(self.points.shape[-2], device=self.points.device)
        return idx < self.n[..., None]


class Costmap(NamedTuple):
    """data (B, H, W) cost values 0..255 as floats; origin (B, 2) world
    coords of cell (0, 0); resolution (B,) m/cell."""

    data: torch.Tensor
    origin: torch.Tensor
    resolution: torch.Tensor


class ObstacleDistanceGrid(NamedTuple):
    """distances (B, H, W) [m]; indexes (B, H, W) int32 flat x + y*W of the
    nearest obstacle cell; origin (B, 2); resolution (B,); valid (B,) bool."""

    distances: torch.Tensor
    indexes: torch.Tensor
    origin: torch.Tensor
    resolution: torch.Tensor
    valid: torch.Tensor


class Scenario(NamedTuple):
    """Everything one control tick consumes: plan, robot, people, grids."""

    path: PathInput
    robot: RobotState
    people: AgentsState
    costmap: Costmap
    esdf: ObstacleDistanceGrid


class ControllerCarry(NamedTuple):
    """Warm-start memory carried across ticks plus the plan-advance cursor.

    prev_path (B, maxsize, 3), prev_cmds (B, maxsize, 2), prev_n (B,) int32
    (0 == no previous solution), plan_start (B,) int32 cumulative prune
    point into the scenario's plan."""

    prev_path: torch.Tensor
    prev_cmds: torch.Tensor
    prev_n: torch.Tensor
    plan_start: torch.Tensor


class ControlCommand(NamedTuple):
    """The tick output: body twist command, each (B,); linear_y is 0."""

    linear_x: torch.Tensor
    linear_y: torch.Tensor
    angular_z: torch.Tensor


# Per-scenario status codes of the failure ladder (SURVEY.md section 5.3)
STATUS_OK = 0  # optimized solution returned
STATUS_FALLBACK_CMDS = 1  # solve unusable -> trajectorizer cmds
STATUS_FALLBACK_CRAWL = 2  # trajectorize failed -> crawl cmd 0.1 m/s
STATUS_INVALID_INPUT = 3  # path < 2 poses


class SolveStats(NamedTuple):
    """Per-scenario solver telemetry, each (B,)."""

    iterations: torch.Tensor  # int32 LM iterations executed
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    termination: torch.Tensor  # int32, see solver.cuda_iter.TERM_*
    usable: torch.Tensor  # bool


class StepAux(NamedTuple):
    """Debug/telemetry outputs of one controller step."""

    local_path: torch.Tensor  # (B, S+1, 3) optimized path poses
    ref_path: torch.Tensor  # (B, S+2, 3) trajectorized reference path
    cmds: torch.Tensor  # (B, S+1, 2) full optimized command sequence
    people_proj: torch.Tensor  # (B, S+1, N, 6) projected people
    status: torch.Tensor  # (B,) int32, STATUS_*
    solve: SolveStats
    plan_start_index: torch.Tensor  # (B,) int32 cumulative prune point
    lm_trace: object = None  # solver.lm.LMTrace when debug_optimizer, (B, T) leaves


def resolve_device(device) -> torch.device:
    """The device an entry point will run on. Asking for CUDA where there is
    none raises: the port never carries on on the CPU by itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run the plain CPU path"
        )
    return dev


def _leaf(x, device, dtype):
    """One leaf (NumPy, array-like or tensor) -> tensor on `device`: floats
    to `dtype`, integers to int32, bools stay bool. NumPy leaves are copied;
    a tensor that is already right is returned as it is."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bool:
            return x.to(device)
        if x.is_floating_point():
            return x.to(device=device, dtype=dtype)
        return x.to(device=device, dtype=torch.int32)
    a = np.asarray(x)
    if a.dtype == np.bool_:
        return torch.tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a.astype(np.int32), device=device)
    return torch.tensor(a, device=device).to(dtype)


def _ndim(x) -> int:
    return x.ndim if isinstance(x, torch.Tensor) else np.asarray(x).ndim


def _convert(tree, template, device, dtype, add_batch):
    out = []
    for name, sub in zip(template._fields, tree):
        kind = template.__annotations__[name]
        if isinstance(kind, type) and issubclass(kind, tuple):
            out.append(_convert(sub, kind, device, dtype, add_batch))
        else:
            t = _leaf(sub, device, dtype)
            out.append(t[None] if add_batch else t)
    return template(*out)


def scenario_from_numpy(sc_np, device="cuda", dtype=torch.float32) -> Scenario:
    """A Scenario with NumPy (or array-like, or tensor) leaves -> this
    package's Scenario on `device`. Accepts any NamedTuple with the same
    field order, in particular the JAX package's. A single unbatched
    scenario gets a leading batch axis of 1."""
    dev = resolve_device(device)
    add_batch = _ndim(sc_np.robot.pose) == 1
    return _convert(sc_np, Scenario, dev, dtype, add_batch)


def carry_from_numpy(carry_np, device="cuda", dtype=torch.float32) -> ControllerCarry:
    """A ControllerCarry with NumPy (or tensor) leaves -> tensors (batch
    axis added when the input is a single unbatched carry)."""
    dev = resolve_device(device)
    add_batch = _ndim(carry_np.prev_path) == 2
    return _convert(tuple(carry_np)[:4], ControllerCarry, dev, dtype, add_batch)


def to_numpy(tree):
    """Inverse of the converters: any (nested) NamedTuple or tuple of tensors
    -> the same structure with NumPy leaves on the host (other leaves, and
    None, as they are)."""
    return tree_map(
        lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x, tree)


def tree_map(fn, tree):
    """fn applied to every leaf of a (nested) NamedTuple or tuple, the
    structure kept; None stays None (StepAux.lm_trace without a trace)."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        leaves = [tree_map(fn, x) for x in tree]
        return type(tree)(*leaves) if hasattr(tree, "_fields") else tuple(leaves)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a (nested) NamedTuple or tuple in field order, depth
    first, None skipped: the order jax.tree.flatten gives the JAX package's
    trees of the same structure."""
    leaves = []
    tree_map(leaves.append, tree)
    return leaves
