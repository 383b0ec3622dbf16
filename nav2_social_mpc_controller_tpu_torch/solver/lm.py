"""Batched Levenberg-Marquardt solver with Ceres trust-region semantics.

Counterpart of the JAX package's ``solver/lm.py`` and the replacement of the
per-tick ``ceres::Solve`` call (optimizer.cpp:381): B independent solves of
D = 2 * n_blocks variables advance together, one batched iteration at a time

    propose (K3) -> value_grad (K6 + K1 + K2) -> commit (K4)

on the default call. A call that asks for the per-iteration trace, for
Jacobi scaling or for its own ``linear_solve`` runs the GENERAL iteration

    damped step (K7, one launch) -> value_grad -> commit's plain
    arithmetic (+ a trace row)

with ``default_linear_solve``; with a caller's ``linear_solve`` the damped
step is its plain composition around that solve

    damped system -> linear_solve -> map-back -> project -> value_grad
    -> commit's plain arithmetic (+ a trace row)

K7's damped step (``cuda_iter.damped_step``) is that composition in one
launch: it factors the same system with the same arithmetic as K3
(``csrc/damped_step.cuh``). The general iteration damps with
``clamp(diag) * (1/radius)`` as K3 does (the JAX package writes
``clamp(diag) / radius``, one rounding apart), so with
``default_linear_solve`` and no scaling a traced solve and an untraced solve
give identical results bit for bit, on the CPU and on the card; and a
caller's ``linear_solve`` that is the standalone solve (``spd_solve``) gives
the bits of the default one.

Semantics reproduced from Ceres:
  * LM with diagonal damping: A = J^T J + (1/radius) * clamp(diag(J^T J)),
    clamp to [min_diagonal=1e-6, max_diagonal=1e32].
  * Trust-region radius update: on acceptance
    radius /= max(1/3, 1 - (2*rho - 1)^3), decrease_factor reset to 2;
    on rejection radius /= decrease_factor, decrease_factor *= 2.
  * Step acceptance: rho = actual_reduction / model_reduction >
    min_relative_decrease (1e-3).
  * Box bounds by projecting the trial point onto the box and re-using the
    projected delta for the model-cost computation.
  * Stopping: max_num_iterations; function_tolerance
    |cost - new_cost| <= fn_tol * cost; gradient_tolerance
    max|g| <= gradient_tol; parameter_tolerance
    ||step|| <= param_tol * (||x|| + param_tol).

A lane that is done stays frozen bit for bit (commit passes it through), so
the results do not depend on WHEN the loop stops: running all
max_iterations, or stopping once every lane is done, give identical outputs.
Asking "is every lane done?" costs a device-to-host synchronisation, so
``check_every`` says how often it is asked (0 = never: a fixed number of
iterations and no synchronisation at all).
"""

from typing import Callable, NamedTuple

import torch
import torch.autograd.forward_ad as fwad

from nav2_social_mpc_controller_tpu_torch.core.types import SolveStats
from nav2_social_mpc_controller_tpu_torch.solver.cuda_iter import (  # noqa: F401
    TERM_FUNCTION_TOL,
    TERM_GRADIENT_TOL,
    TERM_MIN_RADIUS,
    TERM_NO_CONVERGENCE,
    TERM_NUMERIC_FAILURE,
    TERM_PARAMETER_TOL,
    commit,
    commit_with_aux,
    damped_step,
    damped_system,
    project_step,
    propose,
)
from nav2_social_mpc_controller_tpu_torch.solver.cuda_solve import spd_solve

# How often the loop asks the device whether every lane is done. Measured on an
# H100 (PERF.md, "LM loop host syncs"; ``chip_smoke.py --lm-sync-sweep``): on
# the eager tick, bound by the host's launch rate, checking every iteration,
# every 4th, every 8th or never gives tick times that differ by less than
# their own spread. On the captured tick (controller/graph.py) each check
# leaves the card idle for a round trip to the host: every 8th was faster
# than every 4th in 11 of 12 cells (obstacle and social at B = 1, 1024 and
# 4096, two runs), and never asking faster than every 8th in 10 of 12, by
# 0.1-0.6 ms. Every 8th keeps the early exit for batches whose lanes all
# converge well before the cap, and the compacted solver (solver/batched.py)
# needs checks to compact at.
DEFAULT_CHECK_EVERY = 8


class LMConfig(NamedTuple):
    max_iterations: int = 100
    fn_tol: float = 1e-7
    gradient_tol: float = 1e-10
    param_tol: float = 1e-15
    min_relative_decrease: float = 1e-3
    initial_radius: float = 1e4
    max_radius: float = 1e16
    min_radius: float = 1e-32
    min_diagonal: float = 1e-6
    max_diagonal: float = 1e32
    # Ceres' default Jacobi column scaling (trust_region_minimizer.cc):
    # s_i = 1/(1 + ||J col_i|| at iteration 0), frozen; the LM step is
    # computed on the column-scaled system and mapped back delta = S delta'.
    # With Marquardt damping D = diag(J^T J) this is an exact no-op whenever
    # the [min_diagonal, max_diagonal] clamp does not bind in either space,
    # which is why the production default stays False.
    jacobi_scaling: bool = False


class LMTrace(NamedTuple):
    """Per-iteration solver telemetry, the `debug_optimizer` analogue of
    Ceres' PER_MINIMIZER_ITERATION logging (optimizer.cpp:122-130): one row
    per LM iteration and lane, (B, T) with T = trace_len; rows beyond a
    lane's executed count stay zero. Enabled via lm_solve(..., trace_len=T) /
    OptimizerConfig.debug_optimizer."""

    cost: torch.Tensor  # cost at iteration start
    cost_change: torch.Tensor  # actual cost change of the trial step
    grad_max: torch.Tensor  # max|J^T r|
    step_norm: torch.Tensor  # ||delta|| of the (projected) trial step
    tr_ratio: torch.Tensor  # rho = actual/model reduction
    tr_radius: torch.Tensor  # trust-region radius at iteration start
    accepted: torch.Tensor  # bool — step accepted


class LMState(NamedTuple):
    """The solver state of a batch; the Jacobian itself is never carried,
    only the (B, D) / (B, D, D) reductions."""

    u: torch.Tensor  # (B, D)
    cost: torch.Tensor  # (B,)
    g: torch.Tensor  # (B, D)  J^T r at u
    jtj: torch.Tensor  # (B, D, D)  J^T J at u
    radius: torch.Tensor  # (B,)
    decrease_factor: torch.Tensor  # (B,)
    iters: torch.Tensor  # (B,) int32
    done: torch.Tensor  # (B,) bool
    term: torch.Tensor  # (B,) int32
    failed: torch.Tensor  # (B,) bool


def default_linear_solve(a, b):
    """Dense SPD solve of the damped normal equations, a (B, D, D), b (B, D)
    -> (B, D): kernel K7's standalone solve on a CUDA tensor, its plain
    version on a CPU tensor (solver/cuda_solve.py). As lm_solve's default it
    selects K7's damped step instead, which forms, solves and projects the
    same system in one launch with the same bits."""
    return spd_solve(a, b)


def lm_iteration(value_grad: Callable, lower, upper, cfg: LMConfig, st: LMState) -> LMState:
    """ONE batched trust-region iteration of the default call:
    propose -> evaluate -> commit."""
    u_new, delta, model_change = propose(cfg, st.u, st.g, st.jtj, st.radius, lower, upper)
    new_cost, g_new, jtj_new = value_grad(u_new)
    return LMState(*commit(cfg, *st, u_new, delta, model_change, new_cost, g_new, jtj_new))


def lm_iteration_general(value_grad: Callable, lower, upper, cfg: LMConfig, linear_solve,
                         jac_scale, st: LMState):
    """ONE batched trust-region iteration with the damped solve handed to
    `linear_solve` and, when jac_scale (B, D) is given, computed on the
    column-scaled system. With default_linear_solve the damped step is one
    launch of K7. Returns (new state, CommitAux)."""
    if linear_solve is default_linear_solve:
        u_new, delta, model_change = damped_step(
            cfg, st.u, st.g, st.jtj, st.radius, lower, upper, jac_scale)
    else:
        a, rhs = damped_system(cfg, st.g, st.jtj, st.radius, jac_scale)
        step = linear_solve(a.contiguous(), rhs.contiguous())
        if jac_scale is not None:
            step = jac_scale * step
        u_new, delta, model_change = project_step(st.u, step, st.g, st.jtj, lower, upper)
    new_cost, g_new, jtj_new = value_grad(u_new)
    state, aux = commit_with_aux(
        cfg, *st, u_new, delta, model_change, new_cost, g_new, jtj_new
    )
    return LMState(*state), aux


def new_trace(u0, trace_len: int) -> LMTrace:
    """An all-zero LMTrace of (B, trace_len) leaves for the batch of u0."""
    b = u0.shape[0]
    return LMTrace(
        *(torch.zeros((b, trace_len), dtype=u0.dtype, device=u0.device) for _ in range(6)),
        accepted=torch.zeros((b, trace_len), dtype=torch.bool, device=u0.device),
    )


def record_trace(trace: LMTrace, it: int, st: LMState, aux) -> None:
    """Write iteration `it` (from state st, with commit's CommitAux) into
    the trace in place. An active lane's iteration count is `it`: its row is
    column min(it, T-1). Done lanes keep what the column holds."""
    col = min(it, trace.cost.shape[1] - 1)
    grad_max = st.g.abs().max(dim=1).values
    for buf, v in zip(
        trace,
        (st.cost, aux.actual_change, grad_max, aux.step_norm, aux.rho, st.radius, aux.accept),
    ):
        buf[:, col] = torch.where(aux.active, v, buf[:, col])


def jacobi_scale(jtj0):
    """Ceres' Jacobi column scale from J^T J at iteration 0 (B, D, D):
    s_i = 1 / (1 + ||J col_i||), ||J col_i||^2 being its diagonal."""
    diag0 = torch.diagonal(jtj0, dim1=1, dim2=2)
    return 1.0 / (1.0 + torch.sqrt(torch.clamp(diag0, min=0.0)))


def make_value_grad(residual_fn: Callable, d: int):
    """value_grad(u (B, D)) -> (cost (B,), g = J^T r (B, D), JtJ (B, D, D))
    by forward-mode differentiation of residual_fn(u (B, D)) -> r (B, R): D
    tangent passes over the whole batch (every scenario's column i at once),
    reduced immediately so the (B, R, D) Jacobian never enters the solver
    loop. This is the REFERENCE evaluation (controller/optimize.py:
    ResidualValueGrad); the solver's own are ops/fused_iter.py's analytic
    one and, with the latent critics, ops/latent.py's.
    The two contractions are plain float32/float64 matrix products (never
    TF32: nothing in this package enables it)."""

    def value_grad(u):
        cols = []
        r = None
        with fwad.dual_level():
            for i in range(d):
                tangent = torch.zeros_like(u)
                tangent[:, i] = 1.0
                primal, col = fwad.unpack_dual(residual_fn(fwad.make_dual(u, tangent)))
                r = primal.detach()
                cols.append(torch.zeros_like(r) if col is None else col.detach())
        jac = torch.stack(cols, dim=2)  # (B, R, D)
        cost = 0.5 * (r * r).sum(1)
        g = torch.matmul(jac.transpose(1, 2), r[:, :, None])[:, :, 0]
        jtj = torch.matmul(jac.transpose(1, 2), jac)
        return cost, g, jtj

    return value_grad


def initial_state(value_grad: Callable, u0, cfg: LMConfig) -> LMState:
    """The solver state at u0. A lane whose initial cost is not finite
    starts done and failed."""
    b = u0.shape[0]
    dtype = u0.dtype
    dev = u0.device
    cost, g0, jtj0 = value_grad(u0)
    bad = ~torch.isfinite(cost)
    return LMState(
        u=u0,
        cost=cost,
        g=g0,
        jtj=jtj0,
        radius=torch.full((b,), cfg.initial_radius, dtype=dtype, device=dev),
        decrease_factor=torch.full((b,), 2.0, dtype=dtype, device=dev),
        iters=torch.zeros((b,), dtype=torch.int32, device=dev),
        done=bad,
        term=torch.full((b,), TERM_NO_CONVERGENCE, dtype=torch.int32, device=dev),
        failed=bad.clone(),
    )


def solve_stats(st: LMState, initial_cost) -> SolveStats:
    return SolveStats(
        iterations=st.iters,
        initial_cost=initial_cost,
        final_cost=st.cost,
        termination=st.term,
        usable=~st.failed,
    )


def lm_solve(
    value_grad: Callable,
    u0: torch.Tensor,
    lower: torch.Tensor,
    upper: torch.Tensor,
    cfg: LMConfig,
    linear_solve: Callable = default_linear_solve,
    trace_len: int = 0,
    check_every: int = DEFAULT_CHECK_EVERY,
):
    """Minimise 0.5 * ||r(u)||^2 subject to lower <= u <= upper for a batch.

    value_grad(u (B, D)) -> (cost (B,), g (B, D), jtj (B, D, D)) — e.g.
    ops.fused_iter.build_value_grad or make_value_grad(residual_fn, D);
    u0/lower/upper (B, D). linear_solve(a (B, D, D), b (B, D)) -> (B, D)
    solves the damped normal equations. Returns (u_opt (B, D), SolveStats),
    plus an LMTrace with (B, trace_len) leaves when trace_len > 0 (the
    debug_optimizer path).

    The default call (no trace, default_linear_solve, no Jacobi scaling) runs
    kernels K3 and K4 around the evaluation; any other call runs the general
    iteration, whose damped step with the default solve is kernel K7."""
    st = initial_state(value_grad, u0, cfg)
    initial_cost = st.cost
    general = trace_len > 0 or linear_solve is not default_linear_solve or cfg.jacobi_scaling

    # Jacobi scale frozen at iteration 0, as Ceres does.
    jac_scale = jacobi_scale(st.jtj) if cfg.jacobi_scaling else None

    trace = new_trace(u0, trace_len) if trace_len > 0 else None

    # Every active lane has run the same number of iterations, so the
    # per-lane cap iters < max_iterations is the loop bound itself.
    for it in range(cfg.max_iterations):
        if check_every > 0 and it % check_every == 0 and bool(st.done.all()):
            break
        if not general:
            st = lm_iteration(value_grad, lower, upper, cfg, st)
            continue
        st_new, aux = lm_iteration_general(
            value_grad, lower, upper, cfg, linear_solve, jac_scale, st
        )
        if trace is not None:
            record_trace(trace, it, st, aux)
        st = st_new

    stats = solve_stats(st, initial_cost)
    if trace_len > 0:
        return st.u, stats, trace
    return st.u, stats
