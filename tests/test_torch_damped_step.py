"""K7's damped step (solver/cuda_iter.py: damped_step and its plain version
damped_step_plain, which CPU tensors take): the general LM iteration's
composition of plain functions, bit for bit; K3's function without Jacobi
scaling; the JAX package's propose_ref in float64; and lm_solve through the
damped step against lm_solve through a caller's linear_solve."""

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
from nav2_social_mpc_controller_tpu_torch.solver.cuda_solve import spd_solve

torch.set_num_threads(1)

JCFG = jlm.LMConfig(max_iterations=40, fn_tol=1e-5, gradient_tol=1e-8, param_tol=1e-9)
TCFG = tlm.LMConfig(max_iterations=40, fn_tol=1e-5, gradient_tol=1e-8, param_tol=1e-9)
DTYPES = [(np.float32, torch.float32), (np.float64, torch.float64)]


def _state(seed, b, d, np_dtype, not_spd_lane=None):
    """(u, g, jtj, radius, lower, upper, jac_scale) with the magnitudes of
    tests/test_pallas_iter.py; bounds active on most lanes, the last two
    unknowns unbounded; jac_scale as lm_solve forms it from JtJ."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((b, d, d))
    jtj = np.einsum("bij,bkj->bik", a, a) * 10.0 + 1e-3 * np.eye(d)
    if not_spd_lane is not None:
        jtj[not_spd_lane] = -jtj[not_spd_lane]
    g = rng.standard_normal((b, d)) * 5.0
    u = rng.uniform(-0.5, 0.5, (b, d))
    radius = 10.0 ** rng.uniform(-2, 4, b)
    lower, upper = np.full((b, d), -0.7), np.full((b, d), 0.7)
    lower[:, d - 2:], upper[:, d - 2:] = -1e30, 1e30
    args = tuple(torch.tensor(x.astype(np_dtype)) for x in (u, g, jtj, radius, lower, upper))
    return args, tlm.jacobi_scale(args[2])


def _composition(cfg, u, g, jtj, radius, lower, upper, jac_scale):
    """The general iteration's damped step as it was composed of plain
    functions around the default linear solve."""
    a, rhs = K.damped_system(cfg, g, jtj, radius, jac_scale)
    step = tlm.default_linear_solve(a.contiguous(), rhs.contiguous())
    if jac_scale is not None:
        step = jac_scale * step
    return K.project_step(u, step, g, jtj, lower, upper)


def _same_bits(x, y):
    """Equal values, NaN in the same places."""
    return x.dtype == y.dtype and torch.equal(torch.isnan(x), torch.isnan(y)) and torch.equal(
        torch.nan_to_num(x), torch.nan_to_num(y))


@pytest.mark.parametrize("scaled", [False, True], ids=["unscaled", "jacobi"])
@pytest.mark.parametrize("d", [4, 6, 12])
@pytest.mark.parametrize("np_dtype,dtype", DTYPES, ids=["f32", "f64"])
def test_plain_equals_the_composition(np_dtype, dtype, d, scaled):
    """damped_step_plain, and the wrapper on CPU tensors (no launch), give
    the composition's bits; lane 1 is not positive definite: NaN on both
    sides, its neighbours finite."""
    args, s = _state(d, 33, d, np_dtype, not_spd_lane=1)
    jac = s if scaled else None
    ref = _composition(TCFG, *args, jac)
    _build.reset_launch_counts()
    for got in (K.damped_step_plain(TCFG, *args, jac), K.damped_step(TCFG, *args, jac)):
        for x, y in zip(got, ref):
            assert x.dtype == dtype and _same_bits(x, y)
    assert _build.launch_counts["spd_solve"] == 0
    assert torch.isnan(ref[1][1]).all() and torch.isnan(ref[2][1])
    ok = torch.arange(33) != 1
    assert all(bool(torch.isfinite(x[ok]).all()) for x in ref)


@pytest.mark.parametrize("d", [4, 6, 12])
@pytest.mark.parametrize("np_dtype,dtype", DTYPES, ids=["f32", "f64"])
def test_plain_without_scale_equals_propose_plain(np_dtype, dtype, d):
    """Without Jacobi scaling the damped step is K3's function, bit for bit."""
    args, _ = _state(10 + d, 33, d, np_dtype, not_spd_lane=5)
    for x, y in zip(K.damped_step_plain(TCFG, *args), K.propose_plain(TCFG, *args)):
        assert _same_bits(x, y)


@pytest.mark.parametrize("d", [4, 6, 12])
def test_plain_matches_jax_propose_ref_f64(d):
    """float64 against the JAX package's propose_ref under vmap (a library
    solve; damping by clamp(diag) / radius, one rounding from the port's
    clamp(diag) * (1/radius)): the tolerance tests/test_torch_lm_iter.py
    holds propose_plain to."""
    args, _ = _state(20 + d, 9, d, np.float64)
    ref = jax.vmap(lambda *a: jpi.propose_ref(JCFG, *a))(*(jnp.asarray(x.numpy()) for x in args))
    got = K.damped_step_plain(TCFG, *args)
    for x, r, name in zip(got, ref, ("u_new", "delta", "model_change")):
        np.testing.assert_allclose(x.numpy(), np.asarray(r), rtol=1e-9, atol=1e-12, err_msg=name)
    assert ((got[0] == 0.7) | (got[0] == -0.7)).any(), "some bound must be active"


def _toy_problem(np_dtype, d):
    """A bounded nonlinear least-squares batch (tests/test_torch_lm_iter.py's)."""
    rng = np.random.default_rng(2 + d)
    b, r = 6, 10
    a = torch.tensor(rng.standard_normal((b, r, d)).astype(np_dtype))
    y = torch.tensor(rng.standard_normal((b, r)).astype(np_dtype))
    u0 = torch.tensor(rng.uniform(-0.3, 0.3, (b, d)).astype(np_dtype))
    lower, upper = torch.full_like(u0, -0.4), torch.full_like(u0, 0.4)

    def value_grad(u):
        t = torch.einsum("brd,bd->br", a, u) - y
        res = t + 0.1 * t**3
        jac = (1.0 + 0.3 * t**2)[:, :, None] * a
        return (0.5 * (res * res).sum(1), torch.einsum("brd,br->bd", jac, res),
                torch.einsum("brd,bre->bde", jac, jac))

    return value_grad, u0, lower, upper


@pytest.mark.parametrize("kind", ["trace", "jacobi", "trace_jacobi"])
@pytest.mark.parametrize("d", [6, 12])
@pytest.mark.parametrize("np_dtype,dtype", DTYPES, ids=["f32", "f64"])
def test_lm_solve_through_the_damped_step_equals_the_composition(np_dtype, dtype, d, kind,
                                                                   monkeypatch):
    """lm_solve with the default solve goes through damped_step once per
    iteration; with a caller's linear_solve = spd_solve it runs the
    composition and never the damped step. Both give the same bits: solution,
    statistics and trace."""
    vg, u0, lower, upper = _toy_problem(np_dtype, d)
    cfg = TCFG._replace(jacobi_scaling=kind != "trace")
    t_len = 40 if "trace" in kind else 0
    calls = []
    real = tlm.damped_step

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tlm, "damped_step", counted)
    fused = tlm.lm_solve(vg, u0, lower, upper, cfg, trace_len=t_len, check_every=0)
    assert len(calls) == cfg.max_iterations
    composed = tlm.lm_solve(vg, u0, lower, upper, cfg, linear_solve=spd_solve, trace_len=t_len,
                            check_every=0)
    assert len(calls) == cfg.max_iterations
    assert fused[0].dtype == dtype and _same_bits(fused[0], composed[0])
    for x, y in zip(fused[1], composed[1]):
        assert torch.equal(x, y)
    if t_len:
        for x, y in zip(fused[2], composed[2]):
            assert _same_bits(x, y)
        assert bool(fused[2].accepted.any(dim=1).all())
    assert bool(fused[1].usable.all()) and (fused[1].iterations > 0).all()


@pytest.mark.parametrize("d,scaled,per_lane", [(6, False, 296), (6, True, 320),
                                               (12, False, 872), (12, True, 920)])
def test_damped_step_bound_counts_the_bytes_its_function_needs(d, scaled, per_lane):
    """K7's byte bound (chip_smoke.py): u, g, lower, upper, JtJ and radius
    (and the scale) read once, u_new, delta and the model change written
    once, float32."""
    import chip_smoke

    args, s = _state(0, 4, d, np.float32)
    assert chip_smoke.damped_step_bytes(args, s if scaled else None) == 4 * per_lane
