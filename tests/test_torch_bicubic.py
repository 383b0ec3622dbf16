"""Kernel K1 of the PyTorch port (plain version, which is what a CPU tensor
takes) against the JAX package's bicubic formulations on identical NumPy
inputs, plus the exact window crop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nav2_social_mpc_controller_tpu.ops.bicubic_pallas import (
    bicubic_linearize_pallas,
    bicubic_linearize_pallas_packed,
)
from nav2_social_mpc_controller_tpu.world import grid as jgrid
from nav2_social_mpc_controller_tpu_torch import _build
from nav2_social_mpc_controller_tpu_torch.ops import bicubic_cuda as K1
from nav2_social_mpc_controller_tpu_torch.world import grid as tgrid

torch.set_num_threads(1)


def _inputs(seed, b, s, h, w, dtype, border=False):
    """Integer-valued cost windows (0..254) and sample coords; with `border`
    the coords straddle and leave the grid, so the clamped taps fire."""
    rng = np.random.default_rng(seed)
    win = np.rint(rng.uniform(0, 254, (b, h, w))).astype(dtype)
    if border:
        row = rng.uniform(-4.0, h + 3.0, (b, s)).astype(dtype)
        col = rng.uniform(-4.0, w + 3.0, (b, s)).astype(dtype)
        row[:, 0], col[:, 0] = 0.0, w - 1.0  # exactly on cells
        row[:, 1], col[:, 1] = -0.5, w - 0.25
        row[:, 2], col[:, 2] = h - 1.0, -3.0
    else:
        row = rng.uniform(2.0, h - 3.0, (b, s)).astype(dtype)
        col = rng.uniform(2.0, w - 3.0, (b, s)).astype(dtype)
    return win, row, col


@pytest.mark.parametrize("border", [False, True], ids=["interior", "border_clamp"])
@pytest.mark.parametrize("s", [29, 70])
def test_plain_matches_stencil_matmul_f64(s, border):
    """vs world.grid._bicubic_flat_with_grads (the XLA path every JAX parity
    suite pins), f64: only the summation order differs — (R.G).C there, taps
    by row here — so 1e-9 on values that reach 254."""
    win, row, col = _inputs(0, 5, s, 24, 20, np.float64, border)
    ref = jax.vmap(jgrid._bicubic_flat_with_grads)(*map(jnp.asarray, (win, row, col)))
    got = K1.bicubic_linearize(*map(torch.as_tensor, (win, row, col)))
    for g, r, name in zip(got, ref, ("val", "d_row", "d_col")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-9, err_msg=name)


@pytest.mark.parametrize("border", [False, True], ids=["interior", "border_clamp"])
def test_value_matches_gather_formulation(border):
    """The value against the textbook Hermite gather stencil of both
    packages (a different polynomial grouping): 1e-9 in f64."""
    win, row, col = _inputs(1, 4, 29, 30, 30, np.float64, border)
    ref = jax.vmap(jgrid.bicubic_interpolate_gather)(*map(jnp.asarray, (win, row, col)))
    tw, tr, tc = map(torch.as_tensor, (win, row, col))
    val, _, _ = K1.bicubic_linearize(tw, tr, tc)
    np.testing.assert_allclose(val.numpy(), np.asarray(ref), atol=1e-9)
    np.testing.assert_allclose(tgrid.bicubic_interpolate_gather(tw, tr, tc).numpy(), np.asarray(ref), atol=1e-10)


@pytest.mark.parametrize("s,fn", [(29, "packed"), (70, "unpacked")])
def test_plain_matches_pallas_kernels_f32(s, fn):
    """vs the two TPU kernels K1 replaces, run in interpret mode as the JAX
    package's own tests run them (packed at S=29 with the exact 'highest'
    dot; the unpacked kernel is what S=70 dispatches to). f32: the stencil
    dot sums 64 terms in another order than the 16 direct taps, so 2e-3
    absolute on values up to 254 (8e-6 relative)."""
    win, row, col = _inputs(2, 6, s, 64, 64, np.float32, border=True)
    jw, jr, jc = map(jnp.asarray, (win, row, col))
    if fn == "packed":
        ref = bicubic_linearize_pallas_packed(jw, jr, jc, interpret=True, dot_mode="highest")
    else:
        ref = bicubic_linearize_pallas(jw, jr, jc, interpret=True)
    got = K1.bicubic_linearize(*map(torch.as_tensor, (win, row, col)))
    for g, r, name in zip(got, ref, ("val", "d_row", "d_col")):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-3, err_msg=name)


def test_derivatives_match_finite_differences():
    win, row, col = _inputs(3, 3, 12, 20, 20, np.float64)
    row = np.floor(row) + 0.37  # keep +-eps inside one cell: floor() has no derivative
    col = np.floor(col) + 0.61
    tw = torch.as_tensor(win)
    eps = 1e-6
    val, drow, dcol = K1.bicubic_linearize(tw, torch.as_tensor(row), torch.as_tensor(col))
    vp, _, _ = K1.bicubic_linearize(tw, torch.as_tensor(row + eps), torch.as_tensor(col))
    vm, _, _ = K1.bicubic_linearize(tw, torch.as_tensor(row - eps), torch.as_tensor(col))
    np.testing.assert_allclose(drow.numpy(), ((vp - vm) / (2 * eps)).numpy(), atol=1e-5)
    vp, _, _ = K1.bicubic_linearize(tw, torch.as_tensor(row), torch.as_tensor(col + eps))
    vm, _, _ = K1.bicubic_linearize(tw, torch.as_tensor(row), torch.as_tensor(col - eps))
    np.testing.assert_allclose(dcol.numpy(), ((vp - vm) / (2 * eps)).numpy(), atol=1e-5)


def test_far_outside_and_nan_coordinates():
    """Huge coordinates clamp to the border cell (constant region: value of
    the corner, zero slope); NaN coordinates give NaN, not a crash."""
    win, _, _ = _inputs(4, 2, 3, 10, 10, np.float32)
    row = np.array([[1e12, -1e12, np.nan]] * 2, np.float32)
    col = np.array([[-1e12, 1e12, 3.0]] * 2, np.float32)
    val, drow, dcol = K1.bicubic_linearize(*map(torch.as_tensor, (win, row, col)))
    np.testing.assert_allclose(val[:, 0].numpy(), win[:, 9, 0], rtol=1e-6)
    np.testing.assert_allclose(val[:, 1].numpy(), win[:, 0, 9], rtol=1e-6)
    assert torch.isnan(val[:, 2]).all()


def test_cpu_call_launches_nothing_and_shapes_are_checked():
    _build.reset_launch_counts()
    win, row, col = _inputs(5, 2, 4, 8, 8, np.float32)
    K1.bicubic_linearize(*map(torch.as_tensor, (win, row, col)))
    assert _build.launch_counts["bicubic"] == 0
    with pytest.raises(ValueError):
        K1.bicubic_linearize(torch.as_tensor(win), torch.as_tensor(row), torch.as_tensor(col[:, :3]))


@pytest.mark.parametrize("window", [64, 32, 0, 200])
def test_crop_grid_window_exact(window):
    """The window crop is a pure copy with the same clip(cell - half, 0,
    size - window) start and origin shift as the JAX package's one-hot
    selector product — bit-identical, incl. centres near and beyond the
    grid edge and the pass-through cases (0, or a window >= the grid)."""
    rng = np.random.default_rng(6)
    b, h, w = 6, 120, 100
    data = np.rint(rng.uniform(0, 254, (b, h, w))).astype(np.float32)
    origin = rng.uniform(-3, -1, (b, 2)).astype(np.float32)
    res = np.full((b,), 0.05, np.float32)
    center = (origin + rng.uniform(0, 1, (b, 2)) * np.array([w, h]) * 0.05).astype(np.float32)
    center[0] = origin[0] + 0.01  # corner: clamps to start 0
    center[1] = origin[1] + np.array([w, h], np.float32) * 0.05 + 1.0  # beyond the far edge
    ref_w, ref_o = jax.vmap(lambda d, o, r, c: jgrid.crop_grid_window(d, o, r, c, window))(
        *map(jnp.asarray, (data, origin, res, center))
    )
    got_w, got_o = tgrid.crop_grid_window(*map(torch.as_tensor, (data, origin, res, center)), window)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(ref_w))
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(ref_o))
    n = window if 0 < window < min(h, w) else None
    assert got_w.shape == ((b, n, n) if n else (b, h, w))


def test_sample_costmap_matches_jax_package():
    rng = np.random.default_rng(7)
    b, s = 3, 9
    data = np.rint(rng.uniform(0, 254, (b, 40, 40)))
    origin = rng.uniform(-2, 0, (b, 2))
    res = np.full((b,), 0.05)
    pts = origin[:, None, :] + rng.uniform(0.2, 1.7, (b, s, 2))
    ref = jax.vmap(jgrid.sample_costmap)(*map(jnp.asarray, (data, origin, res, pts)))
    got = tgrid.sample_costmap(*map(torch.as_tensor, (data, origin, res, pts)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-9)
