"""K7 — batched tiny-SPD Cholesky solve for the LM normal equations: wrapper,
plain version and launch count for ``csrc/spd_solve.cu``.

Counterpart of the JAX package's ``solver/pallas_solve.py``. The damped
normal equations of one solve are a D x D SPD system with D = 2 * n_blocks
(2 for the reference's default config, 6 for the benchmark configs, 12 for
the H = 36 stress config);
``spd_solve(a (N, D, D), b (N, D)) -> x (N, D)`` solves N of them at once:
K7's standalone entry, for a caller's own ``linear_solve``. The general LM
iteration's default (``solver/lm.py``: debug trace, Jacobi scaling) takes
K7's other entry, the whole damped step in one launch
(``solver/cuda_iter.py: damped_step``), on the same layouts.

The plain version is the SAME arithmetic as the kernel, written as batched
tensor operations in chol.cuh's order (``chol_solve``); kernel K3
(``solver/cuda_iter.py``) shares it. There is no pivot guard: a system that
is not positive definite gives ``sqrt`` of a negative number, NaN, which the
iteration rejects as a non-finite step. A library Cholesky is not a stand-in
(``torch.linalg.cholesky`` raises there and ``cholesky_ex`` returns garbage
silently). CUDA tensors launch the kernel (float32): templated for the standalone solve
at D = 1..16 and for the damped step, K3 and K4 at every even D from 2 to 12,
general above, up to kernel_shapes.GENERAL_MAX_DIM (the general forms count
under their own names, ``spd_solve_general`` for both of K7's entries);
CPU tensors take the plain version, at any D and dtype.
"""

import torch

from nav2_social_mpc_controller_tpu_torch import _build, kernel_shapes
from nav2_social_mpc_controller_tpu_torch.kernel_shapes import SOLVE_DIMS as KERNEL_DIMS
from nav2_social_mpc_controller_tpu_torch.kernel_shapes import SPD_SOLVE_DIMS


def check_dims(fn: str, d: int, dims=KERNEL_DIMS) -> str:
    """The form of the kernel of `fn` that runs D on the card (`dims`:
    KERNEL_DIMS, the even D of K3, K4 and K7's damped step, or
    SPD_SOLVE_DIMS, the standalone solve's): "templated" for D in `dims`,
    "general" up to the general limit; raises past it, naming the limit and
    why (kernel_shapes.form)."""
    kind = "spd_solve" if dims == SPD_SOLVE_DIMS else "solve"
    return kernel_shapes.form(fn, kind, d)


def chol_solve(a, rhs):
    """Solve A x = rhs by a Cholesky A = L L^T with reciprocal diagonals,
    in the operation order of ``csrc/chol.cuh``: a (N, D, D), of which only
    the lower triangle is read; rhs (N, D). Returns x (N, D).

    Each entry is computed by the same operations as one thread of the
    kernels computes it, batched over the rows it does not depend on: a
    column's entries over its rows, the forward substitution's running sums
    over the rows below; the back substitution, whose sums run in ascending
    order over rows solved one after the other, entry by entry."""
    d = rhs.shape[1]
    el = a.clone()
    inv_diag = torch.empty_like(rhs)
    for j in range(d):
        t = el[:, j:, j].clone()  # column j from the pivot down
        for k in range(j):
            t = t - el[:, j:, k] * el[:, j, k : k + 1]
        ljj = torch.sqrt(t[:, 0])
        inv_diag[:, j] = 1.0 / ljj
        el[:, j, j] = ljj
        el[:, j + 1 :, j] = t[:, 1:] * inv_diag[:, j : j + 1]
    s = rhs.clone()
    y = torch.empty_like(rhs)
    for k in range(d):
        y[:, k] = s[:, k] * inv_diag[:, k]
        s[:, k + 1 :] = s[:, k + 1 :] - el[:, k + 1 :, k] * y[:, k : k + 1]
    x = torch.empty_like(rhs)
    for i in reversed(range(d)):
        t = y[:, i]
        for k in range(i + 1, d):
            t = t - el[:, k, i] * x[:, k]
        x[:, i] = t * inv_diag[:, i]
    return x


def spd_solve_plain(a, b):
    """Plain PyTorch version of kernel K7. a (N, D, D), b (N, D) -> (N, D)."""
    return chol_solve(a, b)


def spd_solve(a, b):
    """Solve N independent SPD systems: a (N, D, D), b (N, D) -> x (N, D)."""
    if not a.is_cuda:
        return spd_solve_plain(a, b)
    n, d = b.shape
    kernel = _build.counter_name("spd_solve",
                                 check_dims("spd_solve", d, SPD_SOLVE_DIMS))
    _build.check_tensor("spd_solve", "a", a, torch.float32, (n, d, d), a.device)
    _build.check_tensor("spd_solve", "b", b, torch.float32, (n, d), a.device)
    x = torch.empty_like(b)
    lib = _build.load()
    with torch.cuda.device(a.device):
        err = getattr(lib, f"social_mpc_{kernel}_f32")(
            a.data_ptr(), b.data_ptr(), x.data_ptr(), n, d,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(err, kernel)
    _build.launch_counts[kernel] += 1
    return x
