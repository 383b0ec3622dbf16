"""Kernels K3 (propose) and K4 (commit) of the PyTorch port — their plain
versions, which is what CPU tensors take — against the JAX package's
``propose_ref`` / ``commit_ref`` under vmap on identical NumPy states, and the
batched LM loop built from them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nav2_social_mpc_controller_tpu.solver import lm as jlm
from nav2_social_mpc_controller_tpu.solver import pallas_iter as jpi
from nav2_social_mpc_controller_tpu_torch import _build
from nav2_social_mpc_controller_tpu_torch.solver import cuda_iter as K
from nav2_social_mpc_controller_tpu_torch.solver import lm as tlm

torch.set_num_threads(1)

JCFG = jlm.LMConfig(max_iterations=40, fn_tol=1e-5, gradient_tol=1e-8, param_tol=1e-9)
TCFG = tlm.LMConfig(max_iterations=40, fn_tol=1e-5, gradient_tol=1e-8, param_tol=1e-9)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _random_state(rng, b, d, dtype):
    """SPD JtJ = A A^T + eps I with magnitudes like the benchmark problems
    (the generator of tests/test_pallas_iter.py)."""
    a = rng.standard_normal((b, d, d))
    jtj = np.einsum("bij,bkj->bik", a, a) * 10.0 + 1e-3 * np.eye(d)
    g = rng.standard_normal((b, d)) * 5.0
    u = rng.uniform(-0.5, 0.5, (b, d))
    radius = 10.0 ** rng.uniform(-2, 4, b)
    lower = np.full((b, d), -0.7)
    upper = np.full((b, d), 0.7)
    return tuple(x.astype(dtype) for x in (u, g, jtj, radius, lower, upper))


def _jax_propose(args):
    return jax.vmap(lambda *a: jpi.propose_ref(JCFG, *a))(*map(jnp.asarray, args))


@pytest.mark.parametrize("b,d", [(7, 6), (9, 12), (5, 2), (6, 4), (5, 8), (4, 10)])
def test_propose_matches_reference_f64(b, d):
    """f64: the unrolled Cholesky against the library solve of propose_ref;
    active bounds on most lanes (steps of several units against a +-0.7 box)."""
    args = _random_state(np.random.default_rng(d), b, d, np.float64)
    ref = _jax_propose(args)
    _build.reset_launch_counts()
    got = K.propose(TCFG, *map(_t, args))
    assert _build.launch_counts["propose"] == 0
    for g, r, name in zip(got, ref, ("u_new", "delta", "model_change")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-9, atol=1e-12, err_msg=name)
    u_new = got[0].numpy()
    assert ((u_new == 0.7) | (u_new == -0.7)).any(), "some bound must be active"
    assert (np.abs(u_new) <= 0.7).all()


def test_propose_matches_reference_f32():
    """f32: linear-solver-grade tolerance, as tests/test_pallas_iter.py (the
    unrolled Cholesky and LAPACK's cho_solve accumulate differently)."""
    args = _random_state(np.random.default_rng(0), 33, 6, np.float32)
    ref = _jax_propose(args)
    got = K.propose(TCFG, *map(_t, args))
    for g, r, name in zip(got, ref, ("u_new", "delta", "model_change")):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-3, atol=5e-5, err_msg=name)


def test_unbounded_blocks_survive_float32_max_bounds():
    """Remainder blocks are bounded by +-float32 max: u + delta must clamp
    without overflow into inf - inf."""
    big = np.finfo(np.float32).max
    u, g, jtj, radius, lower, upper = _random_state(np.random.default_rng(3), 4, 6, np.float32)
    lower[:, 4:] = -big
    upper[:, 4:] = big
    got = K.propose(TCFG, *map(_t, (u, g, jtj, radius, lower, upper)))
    ref = _jax_propose((u, g, jtj, radius, lower, upper))
    assert all(torch.isfinite(x).all() for x in got)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=2e-3, atol=5e-5)


def _commit_inputs(rng, b, d, dtype):
    """States and trial results spanning accept, reject, invalid step,
    non-PD system, frozen done lanes and every TERM_* code."""
    u, g, jtj, radius, lower, upper = _random_state(rng, b, d, np.float64)
    jtj[1] = -jtj[1]  # lane 1: not positive definite -> NaN step -> rejected
    u_new, delta, mc = (np.array(x) for x in _jax_propose((u, g, jtj, radius, lower, upper)))
    cost = rng.uniform(1.0, 100.0, b)
    new_cost = cost * rng.uniform(0.2, 1.5, b)
    decrease = 2.0 ** rng.integers(1, 4, b).astype(np.float64)
    done = np.zeros(b, bool)
    failed = np.zeros(b, bool)
    term = np.zeros(b, np.int32)
    iters = rng.integers(0, 30, b).astype(np.int32)
    # lane 0: frozen (done) with a stale termination code
    done[0], term[0] = True, jpi.TERM_FUNCTION_TOL
    # lane 2: numeric failure (accepted step with inf cost is impossible; a
    #         NaN model change with inf cost marks the lane failed)
    new_cost[2] = np.inf
    cost[2] = np.inf
    # lane 3: gradient tolerance
    g[3] = 1e-12
    # lane 4: function tolerance (tiny accepted decrease)
    mc[4] = abs(mc[4]) + 1e-3
    new_cost[4] = cost[4] * (1.0 - 1e-7)
    mc[4] = (cost[4] - new_cost[4]) * 1.5
    # lane 5: parameter tolerance (an accepted step of zero length)
    delta[5] = 0.0
    u_new[5] = u[5]
    mc[5] = 1.0
    new_cost[5] = cost[5] - 0.9
    # lane 6: radius collapses below min_radius on a rejected step
    radius[6] = 1e-31
    decrease[6] = 1e3
    new_cost[6] = cost[6] * 2.0
    # lane 7: plainly accepted, lane 8: plainly rejected
    mc[7], new_cost[7] = 1.0, cost[7] - 0.8
    mc[8], new_cost[8] = 1.0, cost[8] + 0.5
    g_new = g * 0.5 + 1.0
    jtj_new = jtj * 0.9
    f = lambda x: x.astype(dtype)
    return (f(u), f(cost), f(g), f(jtj), f(radius), f(decrease), iters, done, term, failed,
            f(u_new), f(delta), f(mc), f(new_cost), f(g_new), f(jtj_new))


NAMES = ("u", "cost", "g", "jtj", "radius", "decrease_factor", "iters", "done", "term", "failed")


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("d", [2, 4, 6, 8, 10, 12])
def test_commit_matches_reference(d, dtype):
    """Every output of commit equals commit_ref's: the arithmetic is the
    same elementwise chain, so floats agree to rounding (rtol 1e-6 in f32,
    1e-12 in f64) and the discrete outputs exactly."""
    args = _commit_inputs(np.random.default_rng(10 + d), 12, d, dtype)
    ref = jax.vmap(lambda *a: jpi.commit_ref(JCFG, *a))(*map(jnp.asarray, args))
    _build.reset_launch_counts()
    got = K.commit(TCFG, *map(_t, args))
    assert _build.launch_counts["commit"] == 0
    rtol = 1e-12 if dtype == np.float64 else 1e-6
    for gk, rk, name in zip(got, ref, NAMES):
        gk, rk = gk.numpy(), np.asarray(rk)
        assert gk.dtype == rk.dtype, name
        if gk.dtype.kind == "f":
            np.testing.assert_allclose(gk, rk, rtol=rtol, err_msg=name)
        else:
            np.testing.assert_array_equal(gk, rk, err_msg=name)
    term = got[8].numpy()
    # the scripted lanes hit every termination code
    assert term[0] == K.TERM_FUNCTION_TOL and term[2] == K.TERM_NUMERIC_FAILURE
    assert term[3] == K.TERM_GRADIENT_TOL and term[4] == K.TERM_FUNCTION_TOL
    assert term[5] == K.TERM_PARAMETER_TOL and term[6] == K.TERM_MIN_RADIUS
    assert term[8] == K.TERM_NO_CONVERGENCE and not got[7][8]
    assert set(term.tolist()) >= {0, 1, 2, 3, 4, 5}
    assert got[9][2] and not got[9][3]  # failed only on the numeric failure


@pytest.mark.parametrize("d", [2, 4, 8, 10])
def test_propose_and_commit_match_the_pallas_kernels(d):
    """K3 and K4's plain versions at the block counts the card now takes
    beside 6 and 12, against the JAX package's Pallas kernels in interpret
    mode (under jax.jit) in float32: propose to the linear-solver tolerance
    of test_propose_matches_reference_f32 (XLA may contract a*b+c where
    PyTorch does not), commit's floats to 1e-6 and its discrete outputs
    equal."""
    args = _random_state(np.random.default_rng(20 + d), 9, d, np.float32)
    ref = jax.jit(lambda *a: jpi.propose_batched_pallas(JCFG, *a, interpret=True))(
        *map(jnp.asarray, args))
    got = K.propose(TCFG, *map(_t, args))
    for g, r, name in zip(got, ref, ("u_new", "delta", "model_change")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-3, atol=5e-5, err_msg=name)
    cargs = _commit_inputs(np.random.default_rng(30 + d), 12, d, np.float32)
    ref = jax.jit(lambda *a: jpi.commit_batched_pallas(JCFG, *a, interpret=True))(
        *map(jnp.asarray, cargs))
    got = K.commit(TCFG, *map(_t, cargs))
    for gk, rk, name in zip(got, ref, NAMES):
        gk, rk = gk.numpy(), np.asarray(rk)
        if gk.dtype.kind == "f":
            np.testing.assert_allclose(gk, rk, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(gk, rk.astype(gk.dtype), err_msg=name)


def test_non_pd_system_is_rejected_and_done_lanes_are_bit_frozen():
    args = _commit_inputs(np.random.default_rng(5), 12, 6, np.float32)
    u_new, delta, mc = K.propose(TCFG, *map(_t, (args[0], args[2], args[3], args[4])),
                                 _t(np.full((12, 6), -0.7, np.float32)),
                                 _t(np.full((12, 6), 0.7, np.float32)))
    assert torch.isnan(delta[1]).all(), "a negative pivot must flow on as NaN"
    targs = list(map(_t, args))
    targs[10], targs[11], targs[12] = u_new, delta, mc
    out = K.commit(TCFG, *targs)
    # lane 1 (not PD): rejected -> state kept, radius shrunk, not failed
    assert torch.equal(out[0][1], targs[0][1]) and out[4][1] < targs[4][1]
    assert not out[9][1] and not out[7][1]
    # lane 0 (done): every field passes through bit for bit
    for k in range(10):
        assert torch.equal(out[k][0], targs[k][0]), NAMES[k]


def _toy_problem(d, r):
    """A small bounded least-squares batch, r residuals t + 0.1 t^3 of
    t = A u - y per scenario; lane 5 has a non-finite initial cost. Returns
    the NumPy arrays and the port's value_grad."""
    rng = np.random.default_rng(2)
    b = 6
    a = rng.standard_normal((b, r, d))
    y = rng.standard_normal((b, r))
    u0 = rng.uniform(-0.3, 0.3, (b, d))
    y[5, 0] = np.nan  # non-finite initial cost
    lower = np.full((b, d), -0.4)
    upper = np.full((b, d), 0.4)
    ta, ty = _t(a), _t(y)

    def value_grad(u):
        t = torch.einsum("brd,bd->br", ta, u) - ty
        res = t + 0.1 * t**3
        jac = (1.0 + 0.3 * t**2)[:, :, None] * ta
        return (0.5 * (res * res).sum(1), torch.einsum("brd,br->bd", jac, res),
                torch.einsum("brd,bre->bde", jac, jac))

    return (a, y, u0, lower, upper), value_grad


def _jax_lm_solve(arrays, cfg):
    def one(a_, y_, u0_, lo, hi):
        def res(u):
            t = a_ @ u - y_
            return t + 0.1 * t**3

        return jlm.lm_solve(res, u0_, lo, hi, cfg)

    return jax.vmap(one)(*map(jnp.asarray, arrays))


def test_lm_solve_matches_jax_lm_solve():
    """The batched LM loop on a small bounded least-squares problem against
    the JAX package's lm_solve under vmap: same iterates, iteration counts
    and termination codes in f64; lanes with a non-finite initial cost start
    done and failed."""
    arrays, value_grad = _toy_problem(6, 10)
    _, _, u0, lower, upper = arrays
    u_ref, st_ref = _jax_lm_solve(arrays, JCFG)
    for k in (0, 1, 4):
        u, st = tlm.lm_solve(value_grad, _t(u0), _t(lower), _t(upper), TCFG, check_every=k)
        np.testing.assert_array_equal(st.iterations.numpy(), np.asarray(st_ref.iterations))
        np.testing.assert_array_equal(st.termination.numpy(), np.asarray(st_ref.termination))
        np.testing.assert_array_equal(st.usable.numpy(), np.asarray(st_ref.usable))
        np.testing.assert_allclose(u.numpy()[:5], np.asarray(u_ref)[:5], atol=1e-8)
        np.testing.assert_allclose(st.final_cost.numpy()[:5], np.asarray(st_ref.final_cost)[:5], rtol=1e-9)
    assert not st.usable[5] and st.iterations[5] == 0 and st.iterations[:5].min() > 0
    assert st.iterations.dtype == torch.int32 and st.usable.dtype == torch.bool


@pytest.mark.parametrize("d,r", [(6, 10), (12, 20)])
def test_jacobi_scaled_lm_solve_matches_jax_lm_solve(d, r):
    """Jacobi scaling (the general iteration, its damped step K7's on the
    card and its plain version here) against the JAX package's scaled solve
    in f64: iteration counts and termination codes equal, iterates within
    1e-8."""
    arrays, value_grad = _toy_problem(d, r)
    _, _, u0, lower, upper = arrays
    u_js_ref, st_js_ref = _jax_lm_solve(arrays, JCFG._replace(jacobi_scaling=True))
    u_js, st_js = tlm.lm_solve(
        value_grad, _t(u0), _t(lower), _t(upper), TCFG._replace(jacobi_scaling=True))
    np.testing.assert_array_equal(st_js.iterations.numpy(), np.asarray(st_js_ref.iterations))
    np.testing.assert_array_equal(st_js.termination.numpy(), np.asarray(st_js_ref.termination))
    np.testing.assert_allclose(u_js.numpy()[:5], np.asarray(u_js_ref)[:5], atol=1e-8)
    assert not st_js.usable[5] and bool(st_js.usable[:5].all())


def test_check_tensor_refuses_what_the_kernels_do_not_take():
    vec = torch.zeros((4, 6))
    _build.check_tensor("commit", "u", vec, torch.float32, (4, 6), vec.device)
    _build.check_tensor("commit", "iters", torch.zeros(4, dtype=torch.int32), torch.int32, (4,),
                        vec.device)
    for bad, match in ((vec.double(), "float32"), (vec[:, :5], r"\(4, 6\)"),
                       (torch.zeros((6, 4)).t(), "contiguous=False")):
        with pytest.raises(ValueError, match=match):
            _build.check_tensor("commit", "u", bad, torch.float32, (4, 6), vec.device)


@pytest.mark.parametrize("d,kind,per_lane", [
    (6, "done", 428), (6, "rejected", 456), (6, "accepted", 500),
    (12, "done", 1388), (12, "rejected", 1440), (12, "accepted", 1532),
])
def test_commit_bound_counts_only_the_selected_source(d, kind, per_lane):
    """K4's byte bound counts what the function needs for each lane: all ten
    outputs, the decision's inputs, and of (u_new, g_new, jtj_new) and JtJ
    only the source the lane's flag selects."""
    import chip_smoke

    b = 4
    vec, mat, one = torch.zeros((b, d)), torch.zeros((b, d, d)), torch.zeros(b)
    i32 = torch.zeros(b, dtype=torch.int32)
    done = torch.full((b,), kind == "done")
    args = (vec, one, vec, mat, one, one, i32, done, i32, torch.zeros(b, dtype=torch.bool),
            vec, vec, one, one, vec, mat)
    accept = torch.full((b,), kind == "accepted")
    assert chip_smoke.commit_bytes_needed(args, accept) == b * per_lane
