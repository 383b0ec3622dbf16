"""Converged-lane compaction for the batched LM solve.

Counterpart of the JAX package's ``solver/batched.py``. The plain batched
solver runs every lane until the SLOWEST lane converges, so a warm-started
batch whose mean iteration count is far below the cap still pays full-width
iterations up to the cap. Here the solver descends a geometric ladder of
widths (B/2, B/4, ... down to the requested capacity): it runs at the current
width while the number of active (not done) lanes exceeds the next width,
then gathers the active lanes AND their problem data into that width, runs
on, and scatters every level's state back at the end.

Per-lane arithmetic is IDENTICAL to ``lm_solve``: both run the same
iteration, every kernel works scenario by scenario, and a done lane is frozen
bit for bit, so gather / compact / scatter cannot change any lane's
trajectory (tests/test_torch_compaction.py pins it).

In PyTorch the compaction is an ``index_select`` of the solver state, of the
bounds and of the problem data (``value_grad.select(lanes)``), and an
``index_copy`` back. Reading the active count costs a device-to-host
synchronisation, so it is read where ``check_every`` already takes one for
the early exit: a level may start up to ``check_every - 1`` iterations later
than its trigger, which changes the work done and no result.

``Level`` and ``descend`` are shared with the staged compacted tick
(controller/graph_compacted.py), which runs the same iterations and
transitions as one CUDA graph launch, its schedule (this loop's checks,
``active_count`` and ``next_level``) decided on the device by
``compact_continue``.

No reference counterpart — Ceres solves ONE problem; this is the framework's
own batching economics.
"""

from typing import NamedTuple, Optional

import torch

from nav2_social_mpc_controller_tpu_torch.solver.lm import (
    DEFAULT_CHECK_EVERY,
    LMConfig,
    LMState,
    default_linear_solve,
    initial_state,
    lm_iteration,
    lm_iteration_general,
    solve_stats,
)


def width_ladder(batch: int, capacity: int):
    """Geometric halves of `batch` down to `capacity` (inclusive)."""
    levels = []
    width = batch // 2
    while width > capacity:
        levels.append(width)
        width //= 2
    levels.append(capacity)
    return levels


def compacted_capacity(batch: int, capacity_frac: float) -> int:
    """make_step_batch_compacted's narrowest width for a batch of `batch`."""
    return max(1, int(batch * capacity_frac))


def check_compaction(batch: int, capacity: int, cfg: LMConfig, check_every: int):
    """Raise unless compaction can run: 0 < capacity < batch, no Jacobi
    scaling, and an active count read every check_every > 0 iterations."""
    if not 0 < capacity < batch:
        raise ValueError(f"capacity must be in (0, {batch}), got {capacity}")
    if cfg.jacobi_scaling:
        # Keeping the compacted phases scale-free avoids carrying the frozen
        # per-lane scale across the gather/scatter.
        raise NotImplementedError("compaction requires jacobi_scaling=False")
    if check_every <= 0:
        raise ValueError("compaction reads the active count every check_every > 0 iterations")


class Level(NamedTuple):
    """One rung of the ladder: the LM state of its lanes, their bounds and
    problem data; `idx` maps each lane to its lane of the full batch (None at
    full width, where it is the identity)."""

    state: LMState
    lower: torch.Tensor
    upper: torch.Tensor
    value_grad: object
    idx: Optional[torch.Tensor]


def active_count(level: Level) -> int:
    """The number of lanes not done: one reduction and a copy to the host."""
    return int((~level.state.done).sum())


def next_level(widths, k: int, n_active: int) -> int:
    """The rung to run on after a check that counted n_active lanes at rung
    k of `widths` ([B] + width_ladder): the narrowest that still holds them."""
    while k + 1 < len(widths) and n_active <= widths[k + 1]:
        k += 1
    return k


def scatter(full: LMState, level: Level) -> LMState:
    """The full-width state with the level's lanes written back at idx."""
    if level.idx is None:
        return level.state
    return LMState(*(f.index_copy(0, level.idx, p) for f, p in zip(full, level.state)))


def descend(level: Level, width: int) -> Level:
    """The next rung, `width` lanes: a stable sort puts the (<= width)
    active lanes first in their order, then done lanes in theirs; the first
    `width` are gathered with their state and data. Taking two rungs at once
    or one after the other selects the same lanes in the same order."""
    take = torch.argsort(level.state.done.to(torch.uint8), stable=True)[:width]
    return Level(
        LMState(*(f.index_select(0, take) for f in level.state)),
        level.lower.index_select(0, take),
        level.upper.index_select(0, take),
        level.value_grad.select(take),
        take if level.idx is None else level.idx.index_select(0, take),
    )


def lm_solve_batch_compacted(
    value_grad,
    u0: torch.Tensor,
    lower: torch.Tensor,
    upper: torch.Tensor,
    cfg: LMConfig,
    capacity: int,
    linear_solve=default_linear_solve,
    check_every: int = DEFAULT_CHECK_EVERY,
    width_log: list = None,
):
    """Batched box-constrained LM with converged-lane compaction.

    value_grad(u (W, D)) -> (cost, g, jtj) with a method ``select(lanes)``
    that returns it restricted to a set of lanes (ops.fused_iter.ValueGrad,
    controller.optimize.ResidualValueGrad). u0/lower/upper (B, D). capacity:
    the smallest compacted width, in (0, B). check_every > 0: how often the
    active count is read. When `width_log` is a list, the width of every
    iteration run is appended to it (its sum is the work done, in
    lane-iterations).

    Returns (u (B, D), SolveStats with (B,) leaves), equal bit for bit to
    lm_solve's."""
    b = u0.shape[0]
    check_compaction(b, capacity, cfg, check_every)
    if not hasattr(value_grad, "select"):
        raise TypeError("compaction needs a value_grad with a select(lanes) method")

    full = initial_state(value_grad, u0, cfg)
    initial_cost = full.cost
    widths = [b] + width_ladder(b, capacity)
    k = 0
    level = Level(full, lower, upper, value_grad, None)

    # Every active lane has run the same number of iterations, so the
    # per-lane cap iters < max_iterations is the loop bound itself.
    for it in range(cfg.max_iterations):
        if it % check_every == 0:
            n_active = active_count(level)
            if n_active == 0:
                break
            k_new = next_level(widths, k, n_active)
            if k_new != k:
                full = scatter(full, level)
                level = descend(level, widths[k_new])
                k = k_new
        if width_log is not None:
            width_log.append(widths[k])
        vg, lo, hi = level.value_grad, level.lower, level.upper
        if linear_solve is default_linear_solve:
            st = lm_iteration(vg, lo, hi, cfg, level.state)
        else:
            st, _ = lm_iteration_general(vg, lo, hi, cfg, linear_solve, None, level.state)
        level = level._replace(state=st)

    full = scatter(full, level)
    return full.u, solve_stats(full, initial_cost)
