"""K3 / K4 — the non-evaluation half of one LM iteration: wrappers, plain
versions and launch counts for ``csrc/tr_iter.cu``; and K7's damped step
(``csrc/spd_solve.cu``), the general iteration's counterpart of propose.

Counterpart of the JAX package's ``solver/pallas_iter.py``:

  propose  (u, g, jtj, radius, lower, upper) -> (u_new, delta, model_change)
           = diagonal clamp + damped Cholesky solve + box projection +
           model-cost contractions.
  commit   (state..., trial results...) -> updated state
           = rho, accept/reject, radius & decrease-factor updates, frozen
           done lanes, the three tolerance stops, termination codes.

  damped_step  (propose's inputs[, jac_scale]) -> propose's outputs
           = damped system (in Jacobi column scaling when jac_scale is
           given) + Cholesky solve + map-back + box projection + model
           change, in one launch of K7.

Reference semantics: the Ceres trust-region update rules
(levenberg_marquardt_strategy.cc / trust_region_minimizer.cc).

The plain versions are the SAME arithmetic written as batched tensor
operations (the Cholesky solve is ``solver/cuda_solve.py``'s ``chol_solve``,
shared with kernel K7). On the card each kernel is templated for the even D
from 2 to 12 and has a general form above (``check_dims``), counted under
its name with ``_general`` appended. A library Cholesky is
not a stand-in: a non-positive pivot must flow on as NaN into a non-finite
step that commit rejects, where ``torch.linalg.cholesky`` raises and
``cholesky_ex`` returns garbage silently. CUDA tensors launch the kernels
(float32 only); CPU tensors take the plain versions.
"""

from typing import NamedTuple

import torch

from nav2_social_mpc_controller_tpu_torch import _build
from nav2_social_mpc_controller_tpu_torch.solver.cuda_solve import (
    check_dims,
    chol_solve,
    geometry,
    spd_solve_plain,
)

TERM_NO_CONVERGENCE = 0  # hit max_num_iterations (still usable, like Ceres)
TERM_FUNCTION_TOL = 1
TERM_PARAMETER_TOL = 2
TERM_GRADIENT_TOL = 3
TERM_MIN_RADIUS = 4
TERM_NUMERIC_FAILURE = 5  # NaN/inf encountered -> solution unusable


def damped_system(cfg, g, jtj, radius, jac_scale=None):
    """The damped normal equations of one LM iteration as dense tensors:
    A = JtJ + diag(clamp(diag JtJ) * (1/radius)) (B, D, D) and the right-hand
    side -g (B, D), optionally in Ceres' Jacobi column scaling (JtJ and g
    scaled by jac_scale (B, D) first; the caller maps the step back). The
    damping multiplies by the reciprocal radius, exactly as propose_plain and
    kernel K3 do, so a general iteration that solves this system with K7's
    standalone solve takes bit for bit the step K3 and K7's damped step
    take."""
    if jac_scale is not None:
        jtj = jtj * (jac_scale[:, :, None] * jac_scale[:, None, :])
        g = jac_scale * g
    diag = torch.diagonal(jtj, dim1=1, dim2=2)
    damp = torch.clamp(diag, cfg.min_diagonal, cfg.max_diagonal) * (1.0 / radius)[:, None]
    a = jtj.clone()
    torch.diagonal(a, dim1=1, dim2=2).add_(damp)
    return a, -g


def project_step(u, step, g, jtj, lower, upper):
    """Project the trial point u + step onto the box and evaluate the model
    cost change with the projected delta (constrained trust region). Returns
    (u_new, delta (B, D), model_change (B,)); the sums run serially over D,
    in kernel K3's order."""
    d = u.shape[1]
    # max/min keep NaN, like the kernel's comparisons.
    u_new = torch.minimum(torch.maximum(u + step, lower), upper)
    delta = u_new - u

    # model_change = -<delta, g> - 0.5 <delta, JtJ delta> (undamped JtJ);
    # each row's sum in column order, batched over the rows
    dg = delta[:, 0] * g[:, 0]
    for i in range(1, d):
        dg = dg + delta[:, i] * g[:, i]
    rows = jtj[:, :, 0] * delta[:, 0:1]
    for j in range(1, d):
        rows = rows + jtj[:, :, j] * delta[:, j : j + 1]
    dad = torch.zeros_like(dg)
    for i in range(d):
        dad = dad + delta[:, i] * rows[:, i]
    return u_new, delta, -dg - 0.5 * dad


def damped_step_plain(cfg, u, g, jtj, radius, lower, upper, jac_scale=None):
    """Plain PyTorch version of K7's damped step: damped_system, its
    Cholesky solve, the map-back jac_scale * step and project_step, the
    general iteration's composition exactly. Without jac_scale it is
    propose_plain's function with the same bits."""
    a, rhs = damped_system(cfg, g, jtj, radius, jac_scale)
    step = spd_solve_plain(a, rhs)
    if jac_scale is not None:
        step = jac_scale * step
    return project_step(u, step, g, jtj, lower, upper)


def damped_step(cfg, u, g, jtj, radius, lower, upper, jac_scale=None):
    """The damped step of the general LM iteration (see module docstring):
    u/g/lower/upper (B, D), jtj (B, D, D), radius (B,), jac_scale (B, D) or
    None -> u_new, delta (B, D), model_change (B,). One launch of K7 on CUDA
    tensors (float32, even D from 2 to 12; counted under ``spd_solve``); the plain
    version on CPU tensors, at any D and dtype."""
    if not u.is_cuda:
        return damped_step_plain(cfg, u, g, jtj, radius, lower, upper, jac_scale)
    b, d = u.shape
    form = check_dims("damped_step", d)
    entry, kernel = (_build.counter_name(k, form) for k in ("damped_step", "spd_solve"))
    f32 = torch.float32
    spec = [("u", u, (b, d)), ("g", g, (b, d)), ("jtj", jtj, (b, d, d)),
            ("radius", radius, (b,)), ("lower", lower, (b, d)), ("upper", upper, (b, d))]
    if jac_scale is not None:
        spec.append(("jac_scale", jac_scale, (b, d)))
    for name, t, shape in spec:
        _build.check_tensor("damped_step", name, t, f32, shape, u.device)
    u_new = torch.empty_like(u)
    delta = torch.empty_like(u)
    model_change = torch.empty_like(radius)
    lib = _build.load()
    with torch.cuda.device(u.device):
        err = getattr(lib, f"social_mpc_{entry}_f32")(
            u.data_ptr(), g.data_ptr(), jtj.data_ptr(), radius.data_ptr(),
            lower.data_ptr(), upper.data_ptr(),
            None if jac_scale is None else jac_scale.data_ptr(),
            u_new.data_ptr(), delta.data_ptr(), model_change.data_ptr(),
            b, d, cfg.min_diagonal, cfg.max_diagonal, *geometry(entry, d),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(err, entry)
    _build.launch_counts[kernel] += 1
    return u_new, delta, model_change


def propose_plain(cfg, u, g, jtj, radius, lower, upper):
    """Plain PyTorch version of kernel K3. u/g/lower/upper (B, D), jtj
    (B, D, D), radius (B,) -> u_new, delta (B, D), model_change (B,)."""
    a, rhs = damped_system(cfg, g, jtj, radius)
    return project_step(u, chol_solve(a, rhs), g, jtj, lower, upper)


class CommitAux(NamedTuple):
    """Per-iteration intermediates of commit, surfaced for the debug trace."""

    rho: torch.Tensor  # (B,) actual / model reduction
    actual_change: torch.Tensor  # (B,)
    step_norm: torch.Tensor  # (B,) ||delta|| of the projected trial step
    accept: torch.Tensor  # (B,) bool
    active: torch.Tensor  # (B,) bool: the lane was not done


def commit_plain(cfg, *args):
    """Plain PyTorch version of kernel K4: the accept/reject + convergence
    tail of one LM iteration (arguments as ``commit``). State and trial
    tensors carry a leading batch axis; iters/term int32, done/failed bool.
    Returns the updated
    (u, cost, g, jtj, radius, decrease_factor, iters, done, term, failed)."""
    return commit_with_aux(cfg, *args)[0]


def commit_with_aux(cfg, u, cost, g, jtj, radius, decrease_factor, iters, done, term,
                    failed, u_new, delta, model_change, new_cost, g_new, jtj_new):
    """commit_plain and the intermediates the debug trace records: returns
    (updated state tuple, CommitAux). Plain tensor operations on any device;
    the general LM iteration (solver/lm.py) runs it as its tail."""
    d = u.shape[1]
    grad_ok = g.abs().max(dim=1).values <= cfg.gradient_tol
    actual_change = cost - new_cost
    rho = actual_change / model_change

    step_sq = delta[:, 0] * delta[:, 0]
    u_sq = u[:, 0] * u[:, 0]
    for i in range(1, d):
        step_sq = step_sq + delta[:, i] * delta[:, i]
        u_sq = u_sq + u[:, i] * u[:, i]
    step_valid = (
        (model_change > 0.0) & torch.isfinite(new_cost) & torch.isfinite(delta).all(dim=1)
    )
    active = ~done
    accept = active & step_valid & (rho > cfg.min_relative_decrease)

    shrink = 2.0 * rho - 1.0
    grow = torch.maximum(torch.full_like(rho, 1.0 / 3.0), 1.0 - shrink * shrink * shrink)
    radius_acc = torch.minimum(radius / grow, torch.full_like(rho, cfg.max_radius))
    radius_rej = radius / decrease_factor
    radius_out = torch.where(active, torch.where(accept, radius_acc, radius_rej), radius)
    decrease_out = torch.where(
        active,
        torch.where(accept, torch.full_like(rho, 2.0), decrease_factor * 2.0),
        decrease_factor,
    )

    u_out = torch.where(accept[:, None], u_new, u)
    g_out = torch.where(accept[:, None], g_new, g)
    jtj_out = torch.where(accept[:, None, None], jtj_new, jtj)
    cost_out = torch.where(accept, new_cost, cost)

    fn_conv = accept & (actual_change.abs() <= cfg.fn_tol * cost)
    step_norm = torch.sqrt(step_sq)
    param_conv = accept & (step_norm <= cfg.param_tol * (torch.sqrt(u_sq) + cfg.param_tol))
    radius_dead = active & (radius_out < cfg.min_radius)
    numeric_failed = active & (~torch.isfinite(cost_out) | ~torch.isfinite(u_out).all(dim=1))
    grad_ok = active & grad_ok

    def code(c):
        return torch.full_like(term, c)

    term_new = torch.where(
        numeric_failed, code(TERM_NUMERIC_FAILURE),
        torch.where(
            grad_ok, code(TERM_GRADIENT_TOL),
            torch.where(
                fn_conv, code(TERM_FUNCTION_TOL),
                torch.where(
                    param_conv, code(TERM_PARAMETER_TOL),
                    torch.where(radius_dead, code(TERM_MIN_RADIUS), code(TERM_NO_CONVERGENCE)),
                ),
            ),
        ),
    )
    newly_done = numeric_failed | grad_ok | fn_conv | param_conv | radius_dead
    state = (
        u_out,
        cost_out,
        g_out,
        jtj_out,
        radius_out,
        decrease_out,
        iters + active.to(iters.dtype),
        done | newly_done,
        torch.where(done, term, term_new),
        failed | numeric_failed,
    )
    return state, CommitAux(rho, actual_change, step_norm, accept, active)


def propose(cfg, u, g, jtj, radius, lower, upper):
    """Trial step of one LM iteration (see module docstring). Its general
    form is K7's general damped step without the scale (one body), counted
    as ``propose_general``."""
    if not u.is_cuda:
        return propose_plain(cfg, u, g, jtj, radius, lower, upper)
    b, d = u.shape
    kernel = _build.counter_name("propose", check_dims("propose", d))
    f32 = torch.float32
    for name, t, shape in (
        ("u", u, (b, d)), ("g", g, (b, d)), ("jtj", jtj, (b, d, d)),
        ("radius", radius, (b,)), ("lower", lower, (b, d)), ("upper", upper, (b, d)),
    ):
        _build.check_tensor("propose", name, t, f32, shape, u.device)
    u_new = torch.empty_like(u)
    delta = torch.empty_like(u)
    model_change = torch.empty_like(radius)
    lib = _build.load()
    general = kernel != "propose"
    entry = "damped_step_general" if general else "propose"
    with torch.cuda.device(u.device):
        err = getattr(lib, f"social_mpc_{entry}_f32")(
            u.data_ptr(), g.data_ptr(), jtj.data_ptr(), radius.data_ptr(),
            lower.data_ptr(), upper.data_ptr(), *((None,) if general else ()),
            u_new.data_ptr(), delta.data_ptr(), model_change.data_ptr(),
            b, d, cfg.min_diagonal, cfg.max_diagonal, *geometry(entry, d),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(err, kernel)
    _build.launch_counts[kernel] += 1
    return u_new, delta, model_change


def commit(cfg, u, cost, g, jtj, radius, decrease_factor, iters, done, term,
           failed, u_new, delta, model_change, new_cost, g_new, jtj_new):
    """Accept/reject and convergence tail of one LM iteration (see module
    docstring). Returns new tensors; the inputs are left untouched."""
    args = (u, cost, g, jtj, radius, decrease_factor, iters, done, term, failed,
            u_new, delta, model_change, new_cost, g_new, jtj_new)
    if not u.is_cuda:
        return commit_plain(cfg, *args)
    b, d = u.shape
    kernel = _build.counter_name("commit", check_dims("commit", d))
    f32, i32, bl = torch.float32, torch.int32, torch.bool
    spec = (
        ("u", f32, (b, d)), ("cost", f32, (b,)), ("g", f32, (b, d)), ("jtj", f32, (b, d, d)),
        ("radius", f32, (b,)), ("decrease_factor", f32, (b,)), ("iters", i32, (b,)),
        ("done", bl, (b,)), ("term", i32, (b,)), ("failed", bl, (b,)),
        ("u_new", f32, (b, d)), ("delta", f32, (b, d)), ("model_change", f32, (b,)),
        ("new_cost", f32, (b,)), ("g_new", f32, (b, d)), ("jtj_new", f32, (b, d, d)),
    )
    for (name, dtype, shape), t in zip(spec, args):
        _build.check_tensor("commit", name, t, dtype, shape, u.device)
    outs = tuple(torch.empty_like(t) for t in args[:10])
    lib = _build.load()
    with torch.cuda.device(u.device):
        err = getattr(lib, f"social_mpc_{kernel}_f32")(
            *(t.data_ptr() for t in args), *(t.data_ptr() for t in outs),
            b, d, cfg.gradient_tol, cfg.fn_tol, cfg.param_tol,
            cfg.min_relative_decrease, cfg.max_radius, cfg.min_radius, 1.0 / 3.0,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(err, kernel)
    _build.launch_counts[kernel] += 1
    return outs
