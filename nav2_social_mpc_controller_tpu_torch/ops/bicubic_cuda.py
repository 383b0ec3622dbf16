"""K1 — batched bicubic sample with analytic derivatives: wrapper, plain
version and launch count for ``csrc/bicubic.cu``.

Counterpart of the JAX package's ``ops/bicubic_pallas.py``
(``bicubic_linearize_pallas_packed`` and ``bicubic_linearize_pallas``, both
replaced by the one CUDA kernel): (value, d/drow, d/dcol) of each scenario's
costmap window at its S rollout front points, with ceres::BiCubicInterpolator
semantics (border clamp with accumulating duplicate taps, floor() excluded
from the derivative).

``bicubic_linearize`` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors; there is no fallback on the card.
"""

import torch

from nav2_social_mpc_controller_tpu_torch import _build


def tap_weights(x):
    """Catmull-Rom tap weights and their x-derivatives for fraction x (any
    shape): two tensors with a trailing tap axis of 4.
      w[-1] = 0.5(-x^3 + 2x^2 - x)     w[0] = 0.5(3x^3 - 5x^2 + 2)
      w[+1] = 0.5(-3x^3 + 4x^2 + x)    w[+2] = 0.5(x^3 - x^2)"""
    x2 = x * x
    x3 = x2 * x
    wts = torch.stack(
        [
            0.5 * (-x3 + 2.0 * x2 - x),
            0.5 * (3.0 * x3 - 5.0 * x2 + 2.0),
            0.5 * (-3.0 * x3 + 4.0 * x2 + x),
            0.5 * (x3 - x2),
        ],
        dim=-1,
    )
    dwts = torch.stack(
        [
            0.5 * (-3.0 * x2 + 4.0 * x - 1.0),
            0.5 * (9.0 * x2 - 10.0 * x),
            0.5 * (-9.0 * x2 + 8.0 * x + 1.0),
            0.5 * (3.0 * x2 - 2.0 * x),
        ],
        dim=-1,
    )
    return wts, dwts


def tap_index(cell0, n: int):
    """floor(coord) (float, (B, S)) -> the four clamped tap indices
    (B, S, 4) int64. The pre-clamp to [-2, n + 1] changes no clamped index
    and keeps the integer cast defined for huge or NaN coordinates."""
    base = torch.nan_to_num(cell0, nan=-2.0).clamp(-2.0, float(n + 1)).long()
    taps = torch.arange(-1, 3, device=cell0.device)
    return (base[..., None] + taps).clamp(0, n - 1)


def bicubic_linearize_plain(win, row, col):
    """Plain PyTorch version of the kernel: win (B, H, W), row/col (B, S)
    -> (val, d_row, d_col), each (B, S). Direct 4x4 tap reads; the sum runs
    over columns first, then rows, as in the kernel."""
    b, h, w = win.shape
    s = row.shape[1]
    r0 = torch.floor(row)
    c0 = torch.floor(col)
    wr, dwr = tap_weights(row - r0)  # (B, S, 4)
    wc, dwc = tap_weights(col - c0)
    ridx = tap_index(r0, h)
    cidx = tap_index(c0, w)
    flat = (ridx[..., :, None] * w + cidx[..., None, :]).reshape(b, s * 16)
    taps = torch.gather(win.reshape(b, h * w), 1, flat).reshape(b, s, 4, 4)
    t = (taps * wc[..., None, :]).sum(-1)  # (B, S, 4): per tap row
    tc = (taps * dwc[..., None, :]).sum(-1)
    val = (wr * t).sum(-1)
    d_row = (dwr * t).sum(-1)
    d_col = (wr * tc).sum(-1)
    return val, d_row, d_col


def bicubic_linearize(win, row, col):
    """(val, d_row, d_col) at (row, col) on each scenario's window.

    win (B, H, W), row/col (B, S), float32 and contiguous on the card. CPU
    tensors (any float dtype) take the plain version."""
    if win.ndim != 3 or row.ndim != 2 or row.shape != col.shape or row.shape[0] != win.shape[0]:
        raise ValueError(
            f"bicubic_linearize: expected win (B, H, W) and row/col (B, S), got "
            f"{tuple(win.shape)}, {tuple(row.shape)}, {tuple(col.shape)}"
        )
    if not win.is_cuda:
        return bicubic_linearize_plain(win, row, col)
    b, h, w = win.shape
    s = row.shape[1]
    for name, t, shape in (("win", win, (b, h, w)), ("row", row, (b, s)), ("col", col, (b, s))):
        _build.check_tensor("bicubic_linearize", name, t, torch.float32, shape, win.device)
    val = torch.empty_like(row)
    d_row = torch.empty_like(row)
    d_col = torch.empty_like(row)
    lib = _build.load()
    with torch.cuda.device(win.device):
        err = lib.social_mpc_bicubic_f32(
            win.data_ptr(), row.data_ptr(), col.data_ptr(),
            val.data_ptr(), d_row.data_ptr(), d_col.data_ptr(),
            b, s, h, w, torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(err, "bicubic")
    _build.launch_counts["bicubic"] += 1
    return val, d_row, d_col
