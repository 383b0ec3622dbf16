"""The order of operations of K7's general solve (csrc/damped_step.cuh's
general form: the damped step, scaled or not, and the standalone solve past
the templated shapes) keeps the plain version's bits, on the CPU.

Its warp form (D <= 32) factors right-looking: at column k it takes the
pivot, scales the column below it and subtracts L_ik L_jk from every entry
(i, j) of the trailing triangle, so entry (i, j) becomes
((a_ij - L_i0 L_j0) - L_i1 L_j1) - ..., the left-looking serial sum of
chol.cuh and of ``solver/cuda_solve.py: chol_solve`` (which the block form,
D > 32, keeps); the forward substitution's running sums are updated in the
same rounds, in ascending k. Its back substitution forms each product
L_mk x_m as soon as x_m is known, so the chain of row k only subtracts
them, still in ascending m. ``_right_looking_solve`` below is a plain model
of that schedule, written here and not in the package, held to chol_solve
and to the general iteration's damped step bit for bit (NaN in the same
places) in float32 and float64, and to the JAX package's Pallas solve in
interpret mode. The card tests (tests/test_torch_gpu_kernels.py) hold the
kernels themselves to the plain version bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nav2_social_mpc_controller_tpu.solver.pallas_solve import batched_spd_solve_pallas
from nav2_social_mpc_controller_tpu_torch import kernel_shapes
from nav2_social_mpc_controller_tpu_torch.solver import cuda_iter, cuda_solve
from nav2_social_mpc_controller_tpu_torch.solver.lm import LMConfig, jacobi_scale

torch.set_num_threads(1)

DIMS = (14, 18, 24, 33, 36, 64, 237)
N_SYSTEMS = 33  # every 7th negated: not positive definite, NaN


def _right_looking_solve(a, rhs):
    """Solve A x = rhs (a (N, D, D), lower triangle read; rhs (N, D)) in the
    general form's schedule: right-looking factor with the forward
    substitution in its rounds, then back substitution on products formed
    as each x_m becomes known."""
    n, d = rhs.shape
    el = torch.tril(a).clone()
    s = rhs.clone()
    y = torch.empty_like(rhs)
    inv = torch.empty_like(rhs)
    for k in range(d):
        ljj = torch.sqrt(el[:, k, k])
        inv[:, k] = 1.0 / ljj
        col = el[:, k + 1 :, k] * inv[:, k : k + 1]  # L_ik, i > k
        el[:, k + 1 :, k] = col
        y[:, k] = s[:, k] * inv[:, k]
        s[:, k + 1 :] = s[:, k + 1 :] - col * y[:, k : k + 1]
        # every entry of the trailing square; the kernels touch only its lower
        # triangle, and nothing reads the rest
        el[:, k + 1 :, k + 1 :] = el[:, k + 1 :, k + 1 :] - col[:, :, None] * col[:, None, :]
    # The chain of row k, ((y_k - P_k+1,k) - P_k+2,k) - ..., by NumPy's
    # subtract.accumulate, which runs left to right in the arrays' type.
    el, y, inv = el.numpy(), y.numpy(), inv.numpy()
    x = np.empty_like(y)
    prod = np.zeros_like(el)  # prod[:, m, k] = L_mk x_m, formed when x_m is known
    for k in reversed(range(d)):
        chain = np.concatenate([y[:, k : k + 1], prod[:, k + 1 :, k]], axis=1)
        x[:, k] = np.subtract.accumulate(chain, axis=1)[:, -1] * inv[:, k]
        prod[:, k, :k] = el[:, k, :k] * x[:, k : k + 1]
    return torch.from_numpy(x)


def _systems(d, dtype, n=N_SYSTEMS, seed=0):
    rng = np.random.default_rng(seed + d)
    m = rng.standard_normal((n, d, d))
    a = np.einsum("bij,bkj->bik", m, m) + 0.5 * np.eye(d)
    a[::7] = -a[::7]
    return torch.tensor(a, dtype=dtype), torch.tensor(rng.standard_normal((n, d)), dtype=dtype)


def _same_bits(got, ref):
    nan = torch.isnan(got)
    if not torch.equal(nan, torch.isnan(ref)):
        return False
    return torch.equal(got[~nan], ref[~nan]) and torch.equal(
        torch.signbit(got[~nan]), torch.signbit(ref[~nan]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("d", DIMS)
def test_right_looking_schedule_equals_chol_solve(d, dtype):
    """The general form's schedule gives chol_solve's bits, NaN for the
    negated systems and only for them."""
    a, b = _systems(d, dtype)
    got = _right_looking_solve(a, b)
    ref = cuda_solve.chol_solve(a, b)
    assert _same_bits(got, ref)
    bad = torch.isnan(got).any(dim=1)
    assert torch.equal(bad, torch.arange(N_SYSTEMS) % 7 == 0)


@pytest.mark.parametrize("scaled", [False, True], ids=["unscaled", "jacobi"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("d", DIMS)
def test_right_looking_schedule_is_the_damped_step(d, dtype, scaled):
    """The damped system solved in the general form's schedule, mapped back
    and projected, is damped_step_plain's result bit for bit (the general
    iteration's step, K3's without the scale)."""
    rng = np.random.default_rng(100 + d)
    m = rng.standard_normal((N_SYSTEMS, d, d))
    jtj = np.einsum("bij,bkj->bik", m, m) * 10.0 + 1e-3 * np.eye(d)
    jtj[::7] = -jtj[::7]
    jtj = torch.tensor(jtj, dtype=dtype)
    g = torch.tensor(rng.standard_normal((N_SYSTEMS, d)) * 5.0, dtype=dtype)
    u = torch.tensor(rng.uniform(-0.5, 0.5, (N_SYSTEMS, d)), dtype=dtype)
    radius = torch.tensor(10.0 ** rng.uniform(-2, 4, N_SYSTEMS), dtype=dtype)
    lower = torch.full((N_SYSTEMS, d), -0.7, dtype=dtype)
    upper = torch.full((N_SYSTEMS, d), 0.7, dtype=dtype)
    cfg = LMConfig()
    jac = jacobi_scale(jtj) if scaled else None
    a, rhs = cuda_iter.damped_system(cfg, g, jtj, radius, jac)
    step = _right_looking_solve(a, rhs)
    if jac is not None:
        step = jac * step
    got = cuda_iter.project_step(u, step, g, jtj, lower, upper)
    ref = cuda_iter.damped_step_plain(cfg, u, g, jtj, radius, lower, upper, jac)
    for x, y in zip(got, ref):
        assert _same_bits(x, y)
    assert torch.isnan(got[1][0]).all() and bool(torch.isfinite(got[1][1]).all())


@pytest.mark.parametrize("d", [6, 12])
def test_right_looking_schedule_matches_the_pallas_solve(d):
    """Against the JAX package's Pallas SPD solve in interpret mode, as
    tests/test_torch_spd_solve.py holds the plain version: XLA's CPU compiler
    may contract a*b+c, so rtol 2e-5, atol 2e-6; NaN for the same systems."""
    a, b = _systems(d, torch.float32, n=21)
    ref = np.asarray(batched_spd_solve_pallas(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                                              interpret=True))
    got = _right_looking_solve(a, b).numpy()
    bad = np.isnan(got).any(axis=1)
    assert np.array_equal(bad, np.isnan(ref).any(axis=1)) and bad.sum() == 3
    np.testing.assert_allclose(got[~bad], ref[~bad], rtol=2e-5, atol=2e-6)


def test_general_solve_geometry_fits_one_block():
    """Every D the general forms take (14 to the limit): a warp a system up
    to D = 32, several systems a block, in registers (no shared memory); a
    block of whole warps a system above, a thread a row, whose shared memory
    holds the system (general_solve_shared_bytes) and fits one block's
    opt-in limit."""
    for d in range(14, kernel_shapes.GENERAL_MAX_DIM + 1):
        threads, systems, shared = kernel_shapes.general_solve_geometry(d)
        assert threads % 32 == 0 and systems * threads <= 1024
        assert shared <= kernel_shapes.SHARED_BYTES_PER_BLOCK
        if d <= kernel_shapes.GENERAL_SOLVE_WARP_MAX_D:
            assert threads == 32 and systems > 1 and shared == 0
        else:
            assert systems == 1 and d <= threads < max(d + 32, 129)
            assert shared == kernel_shapes.general_solve_shared_bytes(d)
