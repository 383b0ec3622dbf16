"""Rollout prep: the u-DEPENDENT prep of one fused LM evaluation, with CUDA
kernel K6 (``csrc/rollout_prep.cu``) on the card.

Counterpart of the JAX package's ``ops/rollout_pallas.py``. From the decision
vector u it computes, per scenario,

  v_s, w_s     = u[block_idx[s]]                       (exact copies)
  theta_s      = theta_0 + dt * cum(w)
  x_s, y_s     = p_0 + dt * cum(v cos/sin(theta_prev))
  d{x,y}/dv_b  = dt * cum(E_b cos/sin(theta_prev))
  d{x,y}/dw_b  = dt * cum(-/+ v sin/cos(theta_prev) * dtheta_prev/dw_b)
  row/col_s    = (front point - window origin) / resolution

with E_b[s] = [block_idx[s] == b] and dtheta_s/dw_b = dt * cum(E_b), which
does not depend on u and is not an output. Each position step reads theta
from BEFORE its own update (models/motion.rollout_poses). The outputs are
what K1 (row, col) and K2 (the rest) consume.

``rollout_sample`` is what an evaluation runs: the same rollout with K1's
costmap sample at (row, col) in the same launch (``csrc/rollout_sample.cu``),
returning (val, d_row, d_col) in place of (row, col). ``rollout_prep`` alone
(K6, ``csrc/rollout_prep.cu``) is the reference it is held to on the card.
"""

import torch

from nav2_social_mpc_controller_tpu_torch import _build
from nav2_social_mpc_controller_tpu_torch.ops.bicubic_cuda import bicubic_linearize_plain

_KERNEL_BLOCKS = (3, 6)  # NB values csrc/rollout_prep.cu is instantiated for


def rollout_prep_plain(u, pose0, block_idx, win_origin, resolution, dt, front_offset, n_blocks):
    """Plain PyTorch version of kernel K6 (same arguments as
    ``rollout_prep``): the prefix sums are ``torch.cumsum`` along the step
    axis."""
    b = u.shape[0]
    nb = n_blocks
    eb = (block_idx[:, None, :] == torch.arange(nb, device=u.device)[None, :, None]).to(u.dtype)
    dth = dt * torch.cumsum(eb, dim=2)
    ub = u.reshape(b, nb, 2)
    idx = block_idx.long()
    v_t = torch.gather(ub[:, :, 0], 1, idx)  # exact copies, (B, S)
    w_t = torch.gather(ub[:, :, 1], 1, idx)

    th0 = pose0[:, 2:3]
    th = th0 + dt * torch.cumsum(w_t, dim=1)
    th_prev = torch.cat([th0, th[:, :-1]], dim=1)
    dth_prev = torch.cat([torch.zeros_like(dth[:, :, :1]), dth[:, :, :-1]], dim=2)

    cosp = torch.cos(th_prev)
    sinp = torch.sin(th_prev)
    vc = v_t * cosp
    vs = v_t * sinp
    r2 = torch.cat(
        [
            vc[:, None],                  # x integrand
            vs[:, None],                  # y integrand
            eb * cosp[:, None],           # dx/dv_b
            eb * sinp[:, None],           # dy/dv_b
            (-vs)[:, None] * dth_prev,    # dx/dw_b
            vc[:, None] * dth_prev,       # dy/dw_b
        ],
        dim=1,
    )  # (B, 2 + 4NB, S)
    c2 = dt * torch.cumsum(r2, dim=2)
    px = pose0[:, 0:1] + c2[:, 0]
    py = pose0[:, 1:2] + c2[:, 1]
    fxp = px + front_offset * torch.cos(th)
    fyp = py + front_offset * torch.sin(th)
    res = resolution[:, None]
    return {
        "px": px, "py": py, "pth": th, "v": v_t,
        "row": (fyp - win_origin[:, 1:2]) / res,
        "col": (fxp - win_origin[:, 0:1]) / res,
        # Views into c2: inner (NB, S) blocks contiguous, batch stride
        # (2 + 4NB) * S — K2's wrapper takes the stride as given.
        "dxdv": c2[:, 2 : 2 + nb],
        "dydv": c2[:, 2 + nb : 2 + 2 * nb],
        "dxdw": c2[:, 2 + 2 * nb : 2 + 3 * nb],
        "dydw": c2[:, 2 + 3 * nb : 2 + 4 * nb],
    }


def rollout_prep(u, pose0, block_idx, win_origin, resolution, dt, front_offset, n_blocks):
    """The rollout, its position sensitivities and K1's sample coordinates
    at decision vector u.

    u (B, 2*NB) [v0, w0, v1, w1, ...]; pose0 (B, 3); block_idx (B, S)
    integer (int32 on the card); win_origin (B, 2); resolution (B,). Returns
    a dict of px, py, pth, v, row, col (B, S) and dxdv, dydv, dxdw, dydw
    (B, NB, S; slices of one stack).

    CUDA tensors launch kernel K6 (float32 only); CPU tensors take the plain
    version."""
    args = (u, pose0, block_idx, win_origin, resolution, dt, front_offset, n_blocks)
    if not u.is_cuda:
        return rollout_prep_plain(*args)
    nb = n_blocks
    if nb not in _KERNEL_BLOCKS:
        raise ValueError(f"rollout_prep: kernel is built for NB in {_KERNEL_BLOCKS}, got {nb}")
    b, s = block_idx.shape
    f32 = torch.float32
    for name, t, dtype, shape in (
        ("u", u, f32, (b, 2 * nb)), ("pose0", pose0, f32, (b, 3)),
        ("block_idx", block_idx, torch.int32, (b, s)),
        ("win_origin", win_origin, f32, (b, 2)), ("resolution", resolution, f32, (b,)),
    ):
        _build.check_tensor("rollout_prep", name, t, dtype, shape, u.device)

    planes = torch.empty((6, b, s), device=u.device, dtype=f32)
    sens = torch.empty((b, 4 * nb, s), device=u.device, dtype=f32)
    lib = _build.load()
    with torch.cuda.device(u.device):
        err = lib.social_mpc_rollout_prep_f32(
            u.data_ptr(), pose0.data_ptr(), block_idx.data_ptr(), win_origin.data_ptr(),
            resolution.data_ptr(), planes.data_ptr(), sens.data_ptr(),
            b, s, nb, float(dt), float(front_offset),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(err, "rollout_prep")
    _build.launch_counts["rollout_prep"] += 1
    return {
        "px": planes[0], "py": planes[1], "pth": planes[2], "v": planes[3],
        "row": planes[4], "col": planes[5],
        "dxdv": sens[:, 0:nb], "dydv": sens[:, nb : 2 * nb],
        "dxdw": sens[:, 2 * nb : 3 * nb], "dydw": sens[:, 3 * nb : 4 * nb],
    }


def rollout_sample_plain(win, u, pose0, block_idx, win_origin, resolution, dt, front_offset,
                         n_blocks):
    """Plain PyTorch version of the rollout-sample kernel: exactly
    ``rollout_prep_plain`` followed by ``bicubic_linearize_plain`` at its
    (row, col)."""
    r = rollout_prep_plain(u, pose0, block_idx, win_origin, resolution, dt, front_offset,
                           n_blocks)
    val, d_row, d_col = bicubic_linearize_plain(win, r.pop("row"), r.pop("col"))
    return {**r, "val": val, "d_row": d_row, "d_col": d_col}


def rollout_sample(win, u, pose0, block_idx, win_origin, resolution, dt, front_offset,
                   n_blocks):
    """The rollout, its position sensitivities and the costmap sample
    (value, d/drow, d/dcol) at each step's front point, in one launch.

    win (B, H, W) is each scenario's costmap window; the other arguments are
    ``rollout_prep``'s. Returns a dict of px, py, pth, v, val, d_row, d_col
    (B, S) and dxdv, dydv, dxdw, dydw (B, NB, S; slices of one stack).

    CUDA tensors launch the rollout-sample kernel (float32 only); CPU tensors
    take the plain version."""
    args = (u, pose0, block_idx, win_origin, resolution, dt, front_offset, n_blocks)
    if not u.is_cuda:
        return rollout_sample_plain(win, *args)
    nb = n_blocks
    if nb not in _KERNEL_BLOCKS:
        raise ValueError(f"rollout_sample: kernel is built for NB in {_KERNEL_BLOCKS}, got {nb}")
    b, s = block_idx.shape
    f32 = torch.float32
    if win.ndim != 3:
        raise ValueError(f"rollout_sample: expected win (B, H, W), got {tuple(win.shape)}")
    h, w = win.shape[1:]
    for name, t, dtype, shape in (
        ("win", win, f32, (b, h, w)), ("u", u, f32, (b, 2 * nb)), ("pose0", pose0, f32, (b, 3)),
        ("block_idx", block_idx, torch.int32, (b, s)),
        ("win_origin", win_origin, f32, (b, 2)), ("resolution", resolution, f32, (b,)),
    ):
        _build.check_tensor("rollout_sample", name, t, dtype, shape, u.device)

    planes = torch.empty((7, b, s), device=u.device, dtype=f32)
    sens = torch.empty((b, 4 * nb, s), device=u.device, dtype=f32)
    lib = _build.load()
    with torch.cuda.device(u.device):
        err = lib.social_mpc_rollout_sample_f32(
            u.data_ptr(), pose0.data_ptr(), block_idx.data_ptr(), win_origin.data_ptr(),
            resolution.data_ptr(), win.data_ptr(), planes.data_ptr(), sens.data_ptr(),
            b, s, nb, h, w, float(dt), float(front_offset),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(err, "rollout_sample")
    _build.launch_counts["rollout_sample"] += 1
    return {
        "px": planes[0], "py": planes[1], "pth": planes[2], "v": planes[3],
        "val": planes[4], "d_row": planes[5], "d_col": planes[6],
        "dxdv": sens[:, 0:nb], "dydv": sens[:, nb : 2 * nb],
        "dxdw": sens[:, 2 * nb : 3 * nb], "dydw": sens[:, 3 * nb : 4 * nb],
    }
