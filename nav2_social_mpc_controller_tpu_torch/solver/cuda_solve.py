"""K7 — batched tiny-SPD Cholesky solve for the LM normal equations: wrapper,
plain version and launch count for ``csrc/spd_solve.cu``.

Counterpart of the JAX package's ``solver/pallas_solve.py``. The damped
normal equations of one solve are a D x D SPD system with D = 2 * n_blocks
(6 for the benchmark configs, 12 for the H = 36 stress config);
``spd_solve(a (N, D, D), b (N, D)) -> x (N, D)`` solves N of them at once:
K7's standalone entry, for a caller's own ``linear_solve``. The general LM
iteration's default (``solver/lm.py``: debug trace, Jacobi scaling) takes
K7's other entry, the whole damped step in one launch
(``solver/cuda_iter.py: damped_step``), on the same layouts.

The plain version is the SAME unrolled arithmetic as the kernel, written as
batched tensor operations with one (N,) tensor per matrix entry; kernel K3
(``solver/cuda_iter.py``) shares it. There is no pivot guard: a system that
is not positive definite gives ``sqrt`` of a negative number, NaN, which the
iteration rejects as a non-finite step. A library Cholesky is not a stand-in
(``torch.linalg.cholesky`` raises there and ``cholesky_ex`` returns garbage
silently). CUDA tensors launch the kernel (float32, D in {6, 12}); CPU
tensors take the plain version, at any D and dtype.
"""

import torch

from nav2_social_mpc_controller_tpu_torch import _build

KERNEL_DIMS = (6, 12)  # D values csrc/spd_solve.cu and csrc/tr_iter.cu are instantiated for


def chol_solve_unrolled(a, rhs, d: int):
    """Solve A x = rhs by an unrolled Cholesky A = L L^T with reciprocal
    diagonals. ``a(i, j)`` gives the (N,) tensor of A's entry at row i >=
    column j (only the lower triangle is asked for, each entry once); rhs is a
    list of d (N,) tensors. Returns x as a list of d (N,) tensors. The
    operation order is that of ``csrc/chol.cuh``."""
    el = {}
    inv_diag = {}
    for j in range(d):
        s = a(j, j)
        for k in range(j):
            s = s - el[(j, k)] * el[(j, k)]
        ljj = torch.sqrt(s)
        el[(j, j)] = ljj
        inv_diag[j] = 1.0 / ljj
        for i in range(j + 1, d):
            s = a(i, j)
            for k in range(j):
                s = s - el[(i, k)] * el[(j, k)]
            el[(i, j)] = s * inv_diag[j]
    y = {}
    for i in range(d):
        s = rhs[i]
        for k in range(i):
            s = s - el[(i, k)] * y[k]
        y[i] = s * inv_diag[i]
    x = {}
    for i in reversed(range(d)):
        s = y[i]
        for k in range(i + 1, d):
            s = s - el[(k, i)] * x[k]
        x[i] = s * inv_diag[i]
    return [x[i] for i in range(d)]


def spd_solve_plain(a, b):
    """Plain PyTorch version of kernel K7. a (N, D, D), b (N, D) -> (N, D)."""
    d = b.shape[1]
    x = chol_solve_unrolled(lambda i, j: a[:, i, j], [b[:, i] for i in range(d)], d)
    return torch.stack(x, dim=1)


def spd_solve(a, b):
    """Solve N independent SPD systems: a (N, D, D), b (N, D) -> x (N, D)."""
    if not a.is_cuda:
        return spd_solve_plain(a, b)
    n, d = b.shape
    if d not in KERNEL_DIMS:
        raise ValueError(f"spd_solve: kernel is built for D in {KERNEL_DIMS}, got {d}")
    _build.check_tensor("spd_solve", "a", a, torch.float32, (n, d, d), a.device)
    _build.check_tensor("spd_solve", "b", b, torch.float32, (n, d), a.device)
    x = torch.empty_like(b)
    lib = _build.load()
    with torch.cuda.device(a.device):
        err = lib.social_mpc_spd_solve_f32(
            a.data_ptr(), b.data_ptr(), x.data_ptr(), n, d,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(err, "spd_solve")
    _build.launch_counts["spd_solve"] += 1
    return x
