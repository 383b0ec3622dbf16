"""Batched Levenberg-Marquardt solver with Ceres trust-region semantics.

Counterpart of the JAX package's ``solver/lm.py`` and the replacement of the
per-tick ``ceres::Solve`` call (optimizer.cpp:381): B independent solves of
D = 2 * n_blocks variables advance together, one batched iteration at a time

    propose (K3) -> value_grad (K1 + K2) -> commit (K4).

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

from nav2_social_mpc_controller_tpu_torch.core.types import SolveStats
from nav2_social_mpc_controller_tpu_torch.solver.cuda_iter import (  # noqa: F401
    TERM_FUNCTION_TOL,
    TERM_GRADIENT_TOL,
    TERM_MIN_RADIUS,
    TERM_NO_CONVERGENCE,
    TERM_NUMERIC_FAILURE,
    TERM_PARAMETER_TOL,
    commit,
    propose,
)

# How often the loop asks the device whether every lane is done. Measured on an
# H100 (PERF.md, "LM loop host syncs"): the tick is bound by the host's launch
# rate, the card waits for the host, and checking every iteration, every 4th,
# every 8th or never gives tick times that differ by less than their own
# spread. Every 4th keeps the early exit for batches whose lanes all converge
# well before the cap at a cost that could not be measured.
DEFAULT_CHECK_EVERY = 4


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
    # Ceres' Jacobi column scaling; the production default is off and the
    # scaled path is not ported yet (lm_solve refuses it).
    jacobi_scaling: bool = False


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


def lm_iteration(value_grad: Callable, lower, upper, cfg: LMConfig, st: LMState) -> LMState:
    """ONE batched trust-region iteration: propose -> evaluate -> commit."""
    u_new, delta, model_change = propose(cfg, st.u, st.g, st.jtj, st.radius, lower, upper)
    new_cost, g_new, jtj_new = value_grad(u_new)
    return LMState(*commit(cfg, *st, u_new, delta, model_change, new_cost, g_new, jtj_new))


def lm_solve(
    value_grad: Callable,
    u0: torch.Tensor,
    lower: torch.Tensor,
    upper: torch.Tensor,
    cfg: LMConfig,
    check_every: int = DEFAULT_CHECK_EVERY,
):
    """Minimise 0.5 * ||r(u)||^2 subject to lower <= u <= upper for a batch.

    value_grad(u (B, D)) -> (cost (B,), g (B, D), jtj (B, D, D));
    u0/lower/upper (B, D). Returns (u_opt (B, D), SolveStats)."""
    if cfg.jacobi_scaling:
        raise NotImplementedError("jacobi_scaling is not ported yet")
    b = u0.shape[0]
    dtype = u0.dtype
    dev = u0.device

    initial_cost, g0, jtj0 = value_grad(u0)
    bad = ~torch.isfinite(initial_cost)  # such lanes start done and failed
    st = LMState(
        u=u0,
        cost=initial_cost,
        g=g0,
        jtj=jtj0,
        radius=torch.full((b,), cfg.initial_radius, dtype=dtype, device=dev),
        decrease_factor=torch.full((b,), 2.0, dtype=dtype, device=dev),
        iters=torch.zeros((b,), dtype=torch.int32, device=dev),
        done=bad,
        term=torch.full((b,), TERM_NO_CONVERGENCE, dtype=torch.int32, device=dev),
        failed=bad.clone(),
    )
    # Every active lane has run the same number of iterations, so the
    # per-lane cap iters < max_iterations is the loop bound itself.
    for it in range(cfg.max_iterations):
        if check_every > 0 and it % check_every == 0 and bool(st.done.all()):
            break
        st = lm_iteration(value_grad, lower, upper, cfg, st)

    stats = SolveStats(
        iterations=st.iters,
        initial_cost=initial_cost,
        final_cost=st.cost,
        termination=st.term,
        usable=~st.failed,
    )
    return st.u, stats
