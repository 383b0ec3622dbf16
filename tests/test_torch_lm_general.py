"""The general half of the port's LM solver (solver/lm.py: the trace, Jacobi
scaling, a caller's linear_solve, make_value_grad) against the JAX package's
``lm_solve`` under ``jax.vmap`` in float64, on the problems of
tests/test_solver.py with their data made from a seed with NumPy. Both sides
differentiate the same residual functions (forward mode) and run the same
trust-region rules; the damping differs by one rounding (diag * (1/radius)
here, diag / radius there), so solutions are held to 1e-9 and iteration
counts, termination codes and accept decisions to equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nav2_social_mpc_controller_tpu.solver import lm as jlm
from nav2_social_mpc_controller_tpu_torch.solver import lm as tlm

torch.set_num_threads(1)

CFG = dict(max_iterations=100, fn_tol=1e-12, gradient_tol=1e-12, param_tol=1e-14)
INF = float("inf")


def _solve_both(jres, tres, u0, lower, upper, data=(), trace_len=0, **cfg_kw):
    """u0/lower/upper (B, D) NumPy; data: per-lane arrays (B, ...). jres(u,
    *lane_data) is the JAX per-lane residual, tres(u, *data) the batched
    PyTorch one."""
    kw = dict(CFG, **cfg_kw)
    d = u0.shape[1]

    def one(u, lo, hi, *dl):
        return jlm.lm_solve(lambda x: jres(x, *dl), u, lo, hi, jlm.LMConfig(**kw), trace_len=trace_len)

    jout = jax.vmap(one)(jnp.asarray(u0), jnp.asarray(lower), jnp.asarray(upper), *map(jnp.asarray, data))
    tdata = tuple(torch.tensor(np.asarray(x)) for x in data)
    vg = tlm.make_value_grad(lambda u: tres(u, *tdata), d)
    tout = tlm.lm_solve(vg, torch.tensor(u0), torch.tensor(lower), torch.tensor(upper),
                        tlm.LMConfig(**kw), trace_len=trace_len)
    return jax.tree.map(np.asarray, jout), tout


def _assert_same_solve(jout, tout, atol=1e-9, counts=True):
    (ju, jstats), (tu, tstats) = jout[:2], tout[:2]
    np.testing.assert_allclose(tu.numpy(), ju, atol=atol)
    if counts:
        np.testing.assert_array_equal(tstats.iterations.numpy(), jstats.iterations)
        np.testing.assert_array_equal(tstats.termination.numpy(), jstats.termination)
    np.testing.assert_array_equal(tstats.usable.numpy(), jstats.usable)
    np.testing.assert_allclose(tstats.initial_cost.numpy(), jstats.initial_cost, rtol=1e-12)
    np.testing.assert_allclose(tstats.final_cost.numpy(), jstats.final_cost, rtol=1e-6, atol=1e-18)


def _rosen_j(x):
    return jnp.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])


def _rosen_t(u):
    return torch.stack([10.0 * (u[:, 1] - u[:, 0] ** 2), 1.0 - u[:, 0]], dim=1)


def _rosen_starts(b=6):
    rng = np.random.default_rng(5)
    u0 = np.array([[-1.2, 1.0]]) + rng.uniform(-0.3, 0.3, (b, 2))
    u0[0] = [-1.2, 1.0]
    return u0, np.full((b, 2), -INF), np.full((b, 2), INF)


@pytest.mark.parametrize("trace_len", [0, 100], ids=["default_body", "general_body"])
def test_linear_least_squares_unconstrained(trace_len):
    rng = np.random.default_rng(0)
    b = 7
    a = rng.normal(size=(b, 10, 4))
    y = rng.normal(size=(b, 10))
    jout, tout = _solve_both(
        lambda x, a_l, y_l: a_l @ x - y_l,
        lambda u, a_b, y_b: torch.einsum("brd,bd->br", a_b, u) - y_b,
        np.zeros((b, 4)), np.full((b, 4), -INF), np.full((b, 4), INF), (a, y), trace_len=trace_len,
        # a linear problem is solved after a few steps; with tolerances at the
        # rounding level the stopping iteration is decided by the last bits of
        # the cost (rho is noise at the cost floor), so the counts are compared
        # at a gradient tolerance both sides cross in the same iteration, and
        # the optimum is then reached to that tolerance over the least
        # eigenvalue of JtJ
        gradient_tol=1e-6,
    )
    _assert_same_solve(jout, tout)
    expected = np.stack([np.linalg.lstsq(a[k], y[k], rcond=None)[0] for k in range(b)])
    np.testing.assert_allclose(tout[0].numpy(), expected, atol=1e-6)
    assert set(tout[1].termination.tolist()) <= {
        tlm.TERM_FUNCTION_TOL, tlm.TERM_GRADIENT_TOL, tlm.TERM_PARAMETER_TOL}


def test_box_constrained_projection():
    """minimize (x - t)^2 with x <= 1 -> x* = min(t, 1)."""
    t = np.array([[2.0], [0.3], [5.0], [-4.0]])
    jout, tout = _solve_both(
        lambda x, t_l: x - t_l, lambda u, t_b: u - t_b,
        np.zeros((4, 1)), np.full((4, 1), -1.0), np.full((4, 1), 1.0), (t,), trace_len=100,
    )
    _assert_same_solve(jout, tout)
    np.testing.assert_allclose(tout[0].numpy(), np.clip(t, -1.0, 1.0), atol=1e-8)
    assert bool(tout[1].usable.all())


@pytest.mark.parametrize("trace_len", [0, 100], ids=["default_body", "general_body"])
def test_rosenbrock(trace_len):
    u0, lo, hi = _rosen_starts()
    jout, tout = _solve_both(_rosen_j, _rosen_t, u0, lo, hi, trace_len=trace_len)
    # Rosenbrock's valley amplifies the one-rounding difference in the damping
    # over ~20 iterations: solutions to 1e-7, the optimum itself to 1e-6.
    _assert_same_solve(jout, tout, atol=1e-7)
    np.testing.assert_allclose(tout[0].numpy(), np.ones_like(u0), atol=1e-6)
    assert float(tout[1].final_cost.max()) < 1e-12


def test_jacobi_scaling_is_a_noop_when_clamp_does_not_bind():
    """Column norms 1 vs 1e3: the scaled solve must equal the unscaled one
    (iteration counts equal, solutions within 1e-9), and equal the JAX
    package's scaled solve."""
    rng = np.random.default_rng(3)
    b = 5
    a = rng.normal(size=(b, 12, 4)) * np.array([1.0, 1e3, 1.0, 1e3])
    y = rng.normal(size=(b, 12))

    def jres(x, a_l, y_l):
        return a_l @ x - y_l + 0.05 * jnp.sin(x).sum()

    def tres(u, a_b, y_b):
        return torch.einsum("brd,bd->br", a_b, u) - y_b + 0.05 * torch.sin(u).sum(1, keepdim=True)

    args = (jres, tres, np.zeros((b, 4)), np.full((b, 4), -INF), np.full((b, 4), INF), (a, y))
    # At the cost floor of this nearly linear problem the stopping iteration
    # is decided by rounding noise in rho; the gradient tolerance is set where
    # every solve crosses it in the same iteration (max|g| falls 7.7e3 ->
    # 0.7 -> 5.5e-5).
    j_on, t_on = _solve_both(*args, jacobi_scaling=True, gradient_tol=1e-3)
    _, t_off = _solve_both(*args, jacobi_scaling=False, gradient_tol=1e-3)
    _assert_same_solve(j_on, t_on)
    assert torch.equal(t_on[1].iterations, t_off[1].iterations)
    np.testing.assert_allclose(t_on[0].numpy(), t_off[0].numpy(), rtol=0, atol=1e-9)


def test_max_iterations_respected():
    u0, lo, hi = _rosen_starts()
    jout, tout = _solve_both(_rosen_j, _rosen_t, u0, lo, hi, trace_len=3,
                             max_iterations=3, fn_tol=0.0, gradient_tol=0.0, param_tol=0.0)
    _assert_same_solve(jout, tout)
    assert tout[1].iterations.tolist() == [3] * len(u0)
    assert tout[1].termination.tolist() == [tlm.TERM_NO_CONVERGENCE] * len(u0)
    assert bool(tout[1].usable.all())  # max-iter is usable, like Ceres NO_CONVERGENCE


def test_nan_residuals_marked_unusable():
    """A lane whose initial cost is NaN starts done and failed, writes no
    trace row, and leaves its neighbours alone."""
    scale = np.array([[np.nan], [1.0], [1.0]])
    jout, tout = _solve_both(
        lambda x, s_l: jnp.stack([x[0], x[0]]) * s_l - 1.0,
        lambda u, s_b: torch.cat([u, u], dim=1) * s_b - 1.0,
        np.ones((3, 1)) * 3.0, np.full((3, 1), -INF), np.full((3, 1), INF), (scale,), trace_len=100,
    )
    _assert_same_solve(jout, tout)
    assert tout[1].usable.tolist() == [False, True, True]
    assert tout[1].iterations[0] == 0
    trace = tout[2]
    assert all(not bool(buf[0].any()) for buf in trace)


def test_debug_trace_records_iterations():
    """One row per executed iteration and lane: cost[:, 0] is the initial
    cost, accepted rows decrease the cost by the recorded change, rows beyond
    the executed count stay zero; every column agrees with the JAX trace
    (rtol 1e-6: rho and the change are differences of nearly equal costs near
    convergence, so absolute agreement is held at 1e-12 of the initial cost)."""
    u0, lo, hi = _rosen_starts()
    jout, tout = _solve_both(_rosen_j, _rosen_t, u0, lo, hi, trace_len=50, max_iterations=50)
    _assert_same_solve(jout, tout, atol=1e-7)
    jtrace, trace = jout[2], tout[2]
    stats = tout[1]
    assert trace.cost.shape == (len(u0), 50) and trace.accepted.dtype == torch.bool
    for lane in range(len(u0)):
        n = int(stats.iterations[lane])
        assert 0 < n <= 50
        acc = trace.accepted[lane, :n].numpy()
        cost = trace.cost[lane, :n].numpy()
        change = trace.cost_change[lane, :n].numpy()
        assert cost[0] == float(stats.initial_cost[lane]) and acc.any()
        assert (change[acc] > 0).all()
        assert (trace.tr_ratio[lane, :n].numpy()[acc] > 1e-3).all()
        for i in range(n - 1):
            expected = cost[i] - change[i] if acc[i] else cost[i]
            np.testing.assert_allclose(cost[i + 1], expected, rtol=1e-9)
        for buf in trace:
            assert not bool(buf[lane, n:].any())
        np.testing.assert_array_equal(acc, jtrace.accepted[lane, :n])
    scale = float(stats.initial_cost.max())
    for name in ("cost", "cost_change", "grad_max", "step_norm", "tr_radius"):
        np.testing.assert_allclose(
            getattr(trace, name).numpy(), getattr(jtrace, name), rtol=1e-6, atol=1e-12 * scale,
            err_msg=name)
    # rho divides two small differences: compare where the model change is not tiny
    big = np.abs(jtrace.cost_change) > 1e-9 * scale
    np.testing.assert_allclose(trace.tr_ratio.numpy()[big], jtrace.tr_ratio[big], rtol=1e-5)


def test_custom_linear_solve_is_called_and_agrees():
    """A caller's linear_solve runs the general iteration; a dense LU solve
    gives the solution of the default Cholesky to 1e-9, with the same
    iteration counts."""
    u0, lo, hi = _rosen_starts()
    vg = tlm.make_value_grad(_rosen_t, 2)
    calls = []

    def lu_solve(a, b):
        calls.append(a.shape)
        return torch.linalg.solve(a, b[:, :, None])[:, :, 0]

    cfg = tlm.LMConfig(**CFG)
    args = (vg, torch.tensor(u0), torch.tensor(lo), torch.tensor(hi), cfg)
    u_ref, s_ref = tlm.lm_solve(*args)
    u_lu, s_lu = tlm.lm_solve(*args, linear_solve=lu_solve)
    assert len(calls) >= int(s_lu.iterations.max()) and calls[0] == (len(u0), 2, 2)
    np.testing.assert_allclose(u_lu.numpy(), u_ref.numpy(), atol=1e-9)
    assert torch.equal(s_lu.iterations, s_ref.iterations)


def test_traced_solve_equals_untraced_solve_bit_for_bit():
    """default body (propose/commit) vs general body (damped system +
    spd_solve + commit's arithmetic): the same operations, so equal bits, in
    float32 too."""
    rng = np.random.default_rng(7)
    b = 9
    a = torch.tensor(rng.normal(size=(b, 14, 6)).astype(np.float32))
    y = torch.tensor(rng.normal(size=(b, 14)).astype(np.float32))
    vg = tlm.make_value_grad(lambda u: torch.einsum("brd,bd->br", a, u) + 0.3 * torch.sin(u).sum(1, keepdim=True) - y, 6)
    u0 = torch.zeros((b, 6))
    cfg = tlm.LMConfig(max_iterations=30, fn_tol=1e-6)
    u1, s1 = tlm.lm_solve(vg, u0, u0 - 0.4, u0 + 0.4, cfg)
    u2, s2, trace = tlm.lm_solve(vg, u0, u0 - 0.4, u0 + 0.4, cfg, trace_len=30)
    assert torch.equal(u1, u2)
    for x, y2 in zip(s1, s2):
        assert torch.equal(x, y2)
    assert bool(trace.accepted.any())
