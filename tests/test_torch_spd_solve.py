"""Kernel K7's plain version (solver/cuda_solve.py: spd_solve_plain) against
the JAX package's Pallas SPD-solve kernel in interpret mode, on the systems
of tests/test_pallas_solve.py, made from a seed with NumPy and sent through
both sides; against NumPy in float64; and the missing pivot guard."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nav2_social_mpc_controller_tpu.solver.pallas_solve import batched_spd_solve_pallas
from nav2_social_mpc_controller_tpu_torch.solver import cuda_iter, cuda_solve
from nav2_social_mpc_controller_tpu_torch.solver.lm import LMConfig, default_linear_solve

torch.set_num_threads(1)


def _random_spd(rng, n, d, dtype=np.float32):
    m = rng.normal(size=(n, d, d)).astype(dtype)
    a = np.einsum("nij,nkj->nik", m, m) + 0.5 * np.eye(d, dtype=dtype)
    b = rng.normal(size=(n, d)).astype(dtype)
    return a, b


@pytest.mark.parametrize("seed,n,d", [(0, 37, 6), (1, 1024, 12)], ids=["n37_d6", "n1024_d12"])
def test_plain_matches_pallas_kernel_f32(seed, n, d):
    """Both sides run the same unrolled Cholesky in float32; XLA's CPU
    compiler may contract a*b+c where PyTorch does not, so they agree to a
    few roundings carried through the substitutions: rtol 2e-5, atol 2e-6
    (ten times tighter than either side is held to against float64)."""
    a, b = _random_spd(np.random.default_rng(seed), n, d)
    ref = np.asarray(batched_spd_solve_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = cuda_solve.spd_solve_plain(torch.tensor(a), torch.tensor(b)).numpy()
    assert got.dtype == np.float32 and got.shape == (n, d)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-6)
    x64 = np.linalg.solve(a.astype(np.float64), b.astype(np.float64)[..., None])[..., 0]
    tol = (2e-4, 2e-5) if d == 6 else (2e-3, 2e-4)  # the figures of tests/test_pallas_solve.py
    np.testing.assert_allclose(got, x64, rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("d", [1, 3, 5, 6, 12, 16])
def test_plain_matches_numpy_f64(d):
    """float64, any D: a direct solve of well-conditioned systems, rtol 1e-10
    (the figure of tests/test_pallas_solve.py's f64 case)."""
    a, b = _random_spd(np.random.default_rng(3), 8, d, dtype=np.float64)
    got = default_linear_solve(torch.tensor(a), torch.tensor(b)).numpy()  # CPU tensor: the plain version
    np.testing.assert_allclose(got, np.linalg.solve(a, b[..., None])[..., 0], rtol=1e-10)


def test_non_spd_system_gives_nan_on_both_sides():
    """No pivot guard: sqrt of a negative pivot is NaN and flows through the
    substitutions, in the JAX kernel as here; the neighbours stay finite."""
    a, b = _random_spd(np.random.default_rng(4), 5, 6)
    a[2] = -a[2]
    ref = np.asarray(batched_spd_solve_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = cuda_solve.spd_solve_plain(torch.tensor(a), torch.tensor(b)).numpy()
    assert np.isnan(got[2]).all() and np.isnan(ref[2]).all()
    ok = np.arange(5) != 2
    assert np.isfinite(got[ok]).all()
    np.testing.assert_allclose(got[ok], ref[ok], rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("d", [6, 12])
def test_damped_solve_is_the_propose_step_bit_for_bit(d):
    """The general iteration's damped system solved by spd_solve_plain and
    projected is propose_plain's result exactly (same operations in the same
    order), in float32: what makes a traced solve equal an untraced one."""
    rng = np.random.default_rng(d)
    n = 33
    m = rng.normal(size=(n, d, d))
    jtj = torch.tensor((np.einsum("nij,nkj->nik", m, m) * 10.0).astype(np.float32))
    g = torch.tensor(rng.normal(size=(n, d)).astype(np.float32) * 5.0)
    u = torch.tensor(rng.uniform(-0.5, 0.5, (n, d)).astype(np.float32))
    radius = torch.tensor((10.0 ** rng.uniform(-2, 4, n)).astype(np.float32))
    lower, upper = torch.full((n, d), -0.7), torch.full((n, d), 0.7)
    cfg = LMConfig()
    a, rhs = cuda_iter.damped_system(cfg, g, jtj, radius)
    step = cuda_solve.spd_solve_plain(a, rhs)
    got = cuda_iter.project_step(u, step, g, jtj, lower, upper)
    ref = cuda_iter.propose_plain(cfg, u, g, jtj, radius, lower, upper)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
