"""Motion models: block-constant control rollout and the trajectorizer's
unicycle/omnidirectional integrator, batched over scenarios.

Reference parity targets:
  rollout_poses <- computeUpdatedStateRedux (update_state.hpp:38-63), as
      prefix sums shared by every critic.
  integrate_step <- PathTrajectorizer::computeNew{X,Y,Theta}Position
      (path_trajectorizer.hpp:106-135).
  block_index_sequence <- the per-step parameter-block selection
      j < control_horizon ? j/block : (control_horizon-1)/block
      (update_state.hpp:48-59).
"""

import numpy as np
import torch


def block_index_sequence(n_steps: int, control_horizon: int, block_length: int) -> np.ndarray:
    """Static map step -> decision-variable block index: step j uses block
    j//block_length while j < control_horizon, and the last in-horizon block
    beyond it."""
    j = np.arange(n_steps)
    return (np.minimum(j, control_horizon - 1) // block_length).astype(np.int32)


def dynamic_horizon(n_rows, horizon: int, block_length: int):
    """(n_vel, h_dyn, bl_dyn), each (B,) int64: the reference shrinks
    control_horizon = min(cfg, n_vel) and block_length = min(cfg,
    control_horizon), both >= 1, to the velocity count near the goal
    (optimizer.cpp:248-249). n_rows (B,) integer tensor of optimization rows."""
    n_vel = n_rows.long() - 1
    h_dyn = torch.clamp(n_vel, max=horizon).clamp(min=1)
    bl_dyn = torch.clamp(h_dyn, max=block_length).clamp(min=1)
    return n_vel, h_dyn, bl_dyn


def block_index_sequence_dynamic(n_steps: int, control_horizon, block_length):
    """Per-scenario variant: control_horizon / block_length are (B,) integer
    tensors (the reference shrinks them to the velocity count near the goal,
    optimizer.cpp:248-249). Returns (B, n_steps) int64, ready for gather."""
    j = torch.arange(n_steps, device=control_horizon.device)
    h = control_horizon.long()[:, None]
    return torch.minimum(j[None, :], h - 1) // block_length.long()[:, None]


def expand_blocks(u, block_idx):
    """Per-step controls u[b, block_idx[b, s]]: u (B, NB, 2), block_idx
    (B, S) -> (B, S, 2). An exact gather (a copy of the selected values) —
    never a matrix product, whose reduced-precision modes would quantise
    every expanded control."""
    idx = block_idx[:, :, None].expand(-1, -1, u.shape[-1])
    return torch.gather(u, 1, idx)


def prefix_sum(x, dim: int = 1):
    """torch.cumsum(x, dim), summed strictly left to right in every row
    whatever the batch width (on the CPU float32 accumulates in double, as
    torch.cumsum does there), so that one scenario's sums are the same bits
    alone as in any batch. On CUDA torch.cumsum takes CUB's device scan when
    the tensor holds a single row, and otherwise a blocked tree scan whose
    block width grows as the rows get fewer (so rows longer than 32 are
    associated otherwise); along a dimension that is not the last, each row
    is one thread's sequential loop. Hence the trailing axis of two."""
    dim = dim % x.ndim
    return torch.cumsum(torch.stack([x, x], dim=-1), dim=dim)[..., 0]


def rollout_poses(pose0, u, dt: float, block_idx):
    """Integrate the unicycle model under block-constant controls.

    pose0 (B, 3) [x, y, theta]; u (B, NB, 2) decision blocks [(v, w)];
    block_idx (B, S). Returns (B, S+1, 3): poses[:, 0] == pose0 and
    poses[:, k] is the state after k Euler steps. theta is linear in the
    controls and each position step reads theta BEFORE its own update, so
    the recurrence is three prefix sums."""
    vw = expand_blocks(u, block_idx)  # (B, S, 2)
    th0 = pose0[:, 2:3]
    th = th0 + dt * prefix_sum(vw[..., 1])
    th_prev = torch.cat([th0, th[:, :-1]], dim=1)
    x = pose0[:, 0:1] + dt * prefix_sum(vw[..., 0] * torch.cos(th_prev))
    y = pose0[:, 1:2] + dt * prefix_sum(vw[..., 0] * torch.sin(th_prev))
    traj = torch.stack([x, y, th], dim=-1)
    return torch.cat([pose0[:, None, :], traj], dim=1)


def integrate_step(x, y, theta, vx, vy, wz, dt: float):
    """One trajectorizer Euler step (path_trajectorizer.hpp:106-135); vy
    acts along the body's left axis (omnidirectional strafing)."""
    nx = x + (vx * torch.cos(theta) - vy * torch.sin(theta)) * dt
    ny = y + (vx * torch.sin(theta) + vy * torch.cos(theta)) * dt
    nth = theta + wz * dt
    return nx, ny, nth
