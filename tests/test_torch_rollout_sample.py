"""The rollout sample of the PyTorch port (``ops/rollout_cuda.py``
``rollout_sample``: K6's rollout with K1's costmap sample in one launch on
the card): on CPU tensors it is exactly the rollout prep's plain version
followed by the bicubic sample's, and it agrees with the JAX package's two
TPU kernels run one after the other (interpret mode, under jax.jit)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nav2_social_mpc_controller_tpu.ops.bicubic_pallas import bicubic_linearize_pallas_packed
from nav2_social_mpc_controller_tpu.ops.rollout_pallas import rollout_prep_pallas
from nav2_social_mpc_controller_tpu_torch import _build
from nav2_social_mpc_controller_tpu_torch.models.motion import block_index_sequence_dynamic
from nav2_social_mpc_controller_tpu_torch.ops.bicubic_cuda import bicubic_linearize_plain
from nav2_social_mpc_controller_tpu_torch.ops.rollout_cuda import (
    rollout_prep_plain,
    rollout_sample,
)

torch.set_num_threads(1)

DT, FRONT, RES = 0.05, 0.25, 0.05
H = W = 64
SHAPES = [(5, 3, 29), (4, 6, 39)]  # (B, NB, S): the benchmark ticks' and the stress horizon's
IDS = ["NB3-S29", "NB6-S39"]


def _inputs(seed, b, nb, s, dtype, smooth=False):
    """NumPy inputs: per-scenario block maps (scenario 0 the full horizon),
    windows of 64 x 64 cells whose origin puts the start pose 1.6 m in, so
    the front points stay near the middle and some reach the border.
    `smooth`: a smooth cost field in place of random integer cells."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.8, 0.8, (b, 2 * nb))
    pose0 = np.concatenate([rng.uniform(-5, 5, (b, 2)), rng.uniform(-np.pi, np.pi, (b, 1))], 1)
    h_dyn = rng.integers(1, 6 * nb + 1, b)
    h_dyn[0] = 6 * nb
    origin = pose0[:, :2] - rng.uniform(1.2, 2.0, (b, 2))
    if smooth:
        r, c = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        phase = rng.uniform(0, 2 * np.pi, (b, 1, 1))
        win = 127.0 + 100.0 * np.sin(2 * np.pi * r / 64 + phase) * np.cos(2 * np.pi * c / 48)
    else:
        win = np.rint(rng.uniform(0, 254, (b, H, W)))
    block_idx = block_index_sequence_dynamic(
        s, torch.as_tensor(h_dyn), torch.as_tensor(np.minimum(6, h_dyn))).to(torch.int32)
    arrays = [a.astype(dtype) for a in (win, u, pose0, origin, np.full((b,), RES))]
    return arrays, block_idx


def _torch_args(arrays, block_idx, nb):
    win, u, pose0, origin, res = map(torch.as_tensor, arrays)
    return win, (u, pose0, block_idx, origin, res, DT, FRONT, nb)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("b,nb,s", SHAPES, ids=IDS)
def test_rollout_sample_is_rollout_prep_then_bicubic_on_cpu(b, nb, s, dtype):
    """CPU tensors take the plain version, which is exactly rollout_prep_plain
    then bicubic_linearize_plain at its (row, col): equal bits, no launch."""
    arrays, block_idx = _inputs(nb * 100 + s, b, nb, s, dtype)
    win, args = _torch_args(arrays, block_idx, nb)
    _build.reset_launch_counts()
    got = rollout_sample(win, *args)
    assert not any(_build.launch_counts.values())
    ref = rollout_prep_plain(*args)
    val, d_row, d_col = bicubic_linearize_plain(win, ref.pop("row"), ref.pop("col"))
    ref.update(val=val, d_row=d_row, d_col=d_col)
    assert set(got) == set(ref)
    for name in ref:
        assert got[name].dtype == torch.from_numpy(np.zeros(1, dtype)).dtype, name
        assert torch.equal(got[name], ref[name]), name
    for name in ("dxdv", "dydv", "dxdw", "dydw"):
        assert got[name].shape == (b, nb, s)


@functools.lru_cache(maxsize=None)
def _jax_chain(nb, s):
    """The JAX package's rollout-prep kernel, then its packed bicubic kernel
    at the (row, col) the first wrote, both in interpret mode, compiled once
    per shape."""

    def chain(u_t8, eb_t, sc8, win, b):
        out = rollout_prep_pallas(u_t8, eb_t, sc8, s, nb, DT, FRONT, interpret=True)
        row, col = out[-2][:, :b].T, out[-1][:, :b].T
        sample = bicubic_linearize_pallas_packed(win, row, col, interpret=True,
                                                 dot_mode="highest")
        return out[:-2], sample

    return jax.jit(chain, static_argnums=4)


@pytest.mark.parametrize("b,nb,s", SHAPES, ids=IDS)
def test_rollout_sample_f64_matches_pallas_kernels_in_turn(b, nb, s):
    """The port in float64 against the two TPU kernels the rollout sample
    replaces, run one after the other in float32 (interpret mode): the
    rollout at the rollout kernel's tolerances (rtol 2e-5, atol 1e-5), the
    sample at the bicubic kernels' (2e-3 absolute on values up to 254). The
    window is a smooth cost field: the float32 chain samples at its own
    float32 (row, col), up to 2e-4 cells from the float64 ones, and a field
    of random integer cells (slopes up to 254 a cell) would turn that into
    differences of the coordinates, not of the functions."""
    arrays, block_idx = _inputs(nb * 10 + s, b, nb, s, np.float64, smooth=True)
    win, args = _torch_args(arrays, block_idx, nb)
    got = {k: v.numpy() for k, v in rollout_sample(win, *args).items()}

    f32 = [a.astype(np.float32) for a in arrays]
    win32, u, pose0, origin, res = f32
    eb_t = (block_idx.numpy().T[None, :, :] == np.arange(nb)[:, None, None]).astype(np.float32)
    dp = -(-2 * nb // 8) * 8
    u_t8 = jnp.zeros((dp, b), jnp.float32).at[: 2 * nb].set(u.T)
    sc8 = (jnp.zeros((8, b), jnp.float32).at[0:3].set(pose0.T).at[3:5].set(origin.T)
           .at[5].set(res))
    prep, sample = _jax_chain(nb, s)(u_t8, jnp.asarray(eb_t), sc8, jnp.asarray(win32), b)
    names = "px py pth v dxdv dydv dxdw dydw dth".split()
    for name, r in zip(names, prep):
        if name == "dth":
            continue
        r = np.moveaxis(np.asarray(r), -1, 0)[:b]  # (.., S, B) -> (B, .., S)
        np.testing.assert_allclose(got[name], r, rtol=2e-5, atol=1e-5, err_msg=name)
    for name, r in zip(("val", "d_row", "d_col"), sample):
        np.testing.assert_allclose(got[name], np.asarray(r), atol=2e-3, err_msg=name)
