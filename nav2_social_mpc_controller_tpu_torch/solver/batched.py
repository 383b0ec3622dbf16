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

No reference counterpart — Ceres solves ONE problem; this is the framework's
own batching economics.
"""

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
    if not 0 < capacity < b:
        raise ValueError(f"capacity must be in (0, {b}), got {capacity}")
    if cfg.jacobi_scaling:
        # Keeping the compacted phases scale-free avoids carrying the frozen
        # per-lane scale across the gather/scatter.
        raise NotImplementedError("compaction requires jacobi_scaling=False")
    if check_every <= 0:
        raise ValueError("compaction reads the active count every check_every > 0 iterations")
    if not hasattr(value_grad, "select"):
        raise TypeError("compaction needs a value_grad with a select(lanes) method")

    st_full = initial_state(value_grad, u0, cfg)
    initial_cost = st_full.cost
    levels = width_ladder(b, capacity)
    level = 0
    idx = torch.arange(b, device=u0.device)  # current-level lane -> original lane
    st, lo, hi, vg = st_full, lower, upper, value_grad

    def scatter(full: LMState, part: LMState) -> LMState:
        return LMState(*(f.index_copy(0, idx, p) for f, p in zip(full, part)))

    # Every active lane has run the same number of iterations, so the
    # per-lane cap iters < max_iterations is the loop bound itself.
    for it in range(cfg.max_iterations):
        if it % check_every == 0:
            n_active = int((~st.done).sum())
            if n_active == 0:
                break
            width = None
            while level < len(levels) and n_active <= levels[level]:
                width = levels[level]
                level += 1
            if width is not None:
                # Scatter this level's state back, then compact: a stable sort
                # puts the (<= width) active lanes first in original order; the
                # tail beyond `width` is all done.
                st_full = scatter(st_full, st)
                take = torch.argsort(st.done.to(torch.uint8), stable=True)[:width]
                idx = idx.index_select(0, take)
                st = LMState(*(f.index_select(0, take) for f in st))
                lo = lo.index_select(0, take)
                hi = hi.index_select(0, take)
                vg = vg.select(take)
        if width_log is not None:
            width_log.append(st.u.shape[0])
        if linear_solve is default_linear_solve:
            st = lm_iteration(vg, lo, hi, cfg, st)
        else:
            st, _ = lm_iteration_general(vg, lo, hi, cfg, linear_solve, None, st)

    st_full = scatter(st_full, st)
    return st_full.u, solve_stats(st_full, initial_cost)
