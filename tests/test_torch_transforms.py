"""The port's SE(2) frames and grid rebases against the JAX package's, in
float64 on identical NumPy inputs."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nav2_social_mpc_controller_tpu.utils.scenarios import make_costmap, make_esdf
from nav2_social_mpc_controller_tpu.world import transforms as jtf
from nav2_social_mpc_controller_tpu_torch.world import transforms as ttf

# name -> shapes of its two arguments' last axis (frame first)
OPS = {
    "compose": (3, 3), "transform_pose": (3, 3), "pose_to_frame": (3, 3),
    "transform_point": (3, 2), "point_to_frame": (3, 2), "transform_grid_origin": (3, 2),
}


def _poses(rng, shape, width):
    x = rng.uniform(-5.0, 5.0, shape + (width,))
    if width == 3:  # yaws across the wrap, exactly +-pi and 0 included
        x[..., 2] = rng.uniform(-3.5 * math.pi, 3.5 * math.pi, shape)
        x.reshape(-1, 3)[:3, 2] = [math.pi, -math.pi, 0.0]
    return x


@pytest.mark.parametrize("name", list(OPS))
def test_se2_matches_jax_f64(name):
    rng = np.random.default_rng(7)
    wa, wb = OPS[name]
    a, b = _poses(rng, (4, 5), wa), _poses(rng, (4, 5), wb)
    got = getattr(ttf, name)(torch.tensor(a), torch.tensor(b)).numpy()
    want = np.asarray(getattr(jtf, name)(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)


def test_inverse_matches_jax_f64():
    a = _poses(np.random.default_rng(8), (3, 7), 3)
    got = ttf.inverse(torch.tensor(a)).numpy()
    np.testing.assert_allclose(got, np.asarray(jtf.inverse(jnp.asarray(a))), atol=1e-12, rtol=0)
    ident = ttf.compose(torch.tensor(a), ttf.inverse(torch.tensor(a))).numpy()
    np.testing.assert_allclose(ident, np.zeros_like(ident), atol=1e-12)


def _world(dtype):
    cm = make_costmap(80, 80, obstacles=[(1.0, 0.5, 0.3)], dtype=dtype)
    esdf = make_esdf(80, 80, obstacle_cells=[(40, 70), (10, 15)], dtype=dtype)
    return cm, esdf


FRAMES = {
    "translated": [2.0, -1.5, 0.0],
    "quarter_turn": [0.0, 0.0, math.pi / 2.0],
    "rotated": [0.7, -0.3, math.pi / 5.0],
    "rotated_far": [1.0, 2.0, math.pi / 3.0],
    "half_turn": [-0.4, 0.9, math.pi],
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("frame", list(FRAMES))
def test_rebase_matches_jax(frame, dtype):
    """Data and indexes equal, origins within 1e-12 (the translation
    branch's origin goes through each package's transform_point in f64)."""
    cm, esdf = _world(dtype)
    f = np.asarray(FRAMES[frame])
    for rebase, grid in (("rebase_costmap", cm), ("rebase_esdf", esdf)):
        got = getattr(ttf, rebase)(f, grid)
        want = getattr(jtf, rebase)(f, grid)
        assert got._fields == want._fields
        for field, a, b in zip(got._fields, got, want):
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype, (rebase, field)
            if field == "origin":
                np.testing.assert_allclose(a, b, atol=1e-12, rtol=0)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{rebase}.{field}")
        if frame == "translated":  # data untouched, origin shifted
            np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(grid[0]))
            np.testing.assert_allclose(np.asarray(got.origin),
                                       np.asarray(grid.origin) + f[:2], atol=1e-6)
