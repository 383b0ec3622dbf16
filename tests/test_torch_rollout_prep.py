"""The rollout prep of the PyTorch port (kernel K6's plain version,
``ops/rollout_cuda.py``) against the JAX package: its rollout-prep Pallas
kernel in interpret mode (float32, that kernel's own test tolerances) and
``rollout_with_sensitivities`` (float64, 1e-12), with a different dynamic
block map (h_dyn / bl_dyn) in every scenario."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nav2_social_mpc_controller_tpu.models import motion as jmotion
from nav2_social_mpc_controller_tpu.ops import fused_iter as jfused
from nav2_social_mpc_controller_tpu.ops.rollout_pallas import rollout_prep_pallas
from nav2_social_mpc_controller_tpu_torch import _build
from nav2_social_mpc_controller_tpu_torch.models.motion import block_index_sequence_dynamic
from nav2_social_mpc_controller_tpu_torch.ops.rollout_cuda import rollout_prep, rollout_prep_plain

torch.set_num_threads(1)

DT, FRONT = 0.05, 0.25


def _inputs(seed, b, nb, s, dtype):
    """NumPy inputs with per-scenario block maps: scenario 0 runs the full
    horizon, the others a random shrunk one."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.8, 0.8, (b, 2 * nb)).astype(dtype)
    pose0 = np.concatenate(
        [rng.uniform(-5, 5, (b, 2)), rng.uniform(-np.pi, np.pi, (b, 1))], axis=1).astype(dtype)
    h_dyn = rng.integers(1, 6 * nb + 1, b)
    h_dyn[0] = 6 * nb
    bl_dyn = np.minimum(6, h_dyn)
    origin = rng.uniform(-10, 0, (b, 2)).astype(dtype)
    res = np.full((b,), 0.05, dtype)
    return u, pose0, h_dyn, bl_dyn, origin, res


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("b,nb,s", [(7, 3, 29), (4, 6, 39)], ids=["NB3-S29", "NB6-S39"])
def test_rollout_prep_plain_matches_pallas_kernel_interpreted(b, nb, s):
    """float32: poses and sensitivities rtol 2e-5 / atol 1e-5, row/col atol
    2e-4 (they divide by the 0.05 m resolution) — the prefix sums associate
    differently; the copied controls are exact."""
    u, pose0, h_dyn, bl_dyn, origin, res = _inputs(nb, b, nb, s, np.float32)
    block_idx = block_index_sequence_dynamic(s, _t(h_dyn), _t(bl_dyn))
    assert len({tuple(r) for r in block_idx.tolist()}) > 2
    got = rollout_prep_plain(_t(u), _t(pose0), block_idx, _t(origin), _t(res), DT, FRONT, nb)

    eb_t = (block_idx.numpy().T[None, :, :] == np.arange(nb)[:, None, None]).astype(np.float32)
    dp = -(-2 * nb // 8) * 8
    u_t8 = jnp.zeros((dp, b), jnp.float32).at[: 2 * nb].set(u.T)
    sc8 = jnp.zeros((8, b), jnp.float32).at[0:3].set(pose0.T).at[3:5].set(origin.T).at[5].set(res)
    ref = rollout_prep_pallas(u_t8, jnp.asarray(eb_t), sc8, s, nb, DT, FRONT, interpret=True)
    names = "px py pth v dxdv dydv dxdw dydw dth row col".split()
    ref = dict(zip(names, (np.asarray(x) for x in ref)))
    for name, g in got.items():
        r = np.moveaxis(ref[name], -1, 0)  # (.., S, B) -> (B, .., S)
        assert g.shape == r.shape and g.dtype == torch.float32, name
        atol = 2e-4 if name in ("row", "col") else 1e-5
        np.testing.assert_allclose(g.numpy(), r, rtol=2e-5, atol=atol, err_msg=name)
    np.testing.assert_array_equal(got["v"].numpy(), ref["v"].T)


@pytest.mark.parametrize("b,nb,s", [(6, 3, 29), (5, 6, 39)], ids=["NB3-S29", "NB6-S39"])
def test_rollout_prep_plain_matches_rollout_with_sensitivities_f64(b, nb, s):
    """float64 at 1e-12 against the JAX package's per-scenario function; the
    front-point coordinates against their definition."""
    u, pose0, h_dyn, bl_dyn, origin, res = _inputs(10 + nb, b, nb, s, np.float64)
    block_idx = block_index_sequence_dynamic(s, _t(h_dyn), _t(bl_dyn))
    got = rollout_prep_plain(_t(u), _t(pose0), block_idx, _t(origin), _t(res), DT, FRONT, nb)
    got = {k: v.numpy() for k, v in got.items()}

    jidx = jax.vmap(lambda h, l: jmotion.block_index_sequence_dynamic(s, h, l))(
        jnp.asarray(h_dyn), jnp.asarray(bl_dyn))
    np.testing.assert_array_equal(block_idx.numpy(), np.asarray(jidx))
    poses, vw, tx, ty, _tth, _eb = (
        np.asarray(x) for x in jax.vmap(
            lambda uu, p, i: jfused.rollout_with_sensitivities(uu.reshape(nb, 2), p, DT, i, nb)
        )(jnp.asarray(u), jnp.asarray(pose0), jidx)
    )
    np.testing.assert_allclose(got["px"], poses[:, 1:, 0], atol=1e-12)
    np.testing.assert_allclose(got["py"], poses[:, 1:, 1], atol=1e-12)
    np.testing.assert_allclose(got["pth"], poses[:, 1:, 2], atol=1e-12)
    np.testing.assert_array_equal(got["v"], vw[..., 0])
    for name, ref in (("dxdv", tx[..., 0::2]), ("dxdw", tx[..., 1::2]),
                      ("dydv", ty[..., 0::2]), ("dydw", ty[..., 1::2])):
        np.testing.assert_allclose(got[name], np.swapaxes(ref, 1, 2), atol=1e-12, err_msg=name)
    fx = poses[:, 1:, 0] + FRONT * np.cos(poses[:, 1:, 2])
    fy = poses[:, 1:, 1] + FRONT * np.sin(poses[:, 1:, 2])
    np.testing.assert_allclose(got["col"], (fx - origin[:, 0:1]) / res[:, None], atol=1e-9)
    np.testing.assert_allclose(got["row"], (fy - origin[:, 1:2]) / res[:, None], atol=1e-9)


def test_rollout_prep_wrapper_takes_plain_version_on_cpu_tensors_only():
    """On CPU tensors the wrapper is the plain version (any float dtype, any
    integer block map) and launches nothing; the (NB, S) sensitivity blocks
    it returns are what K2's wrapper accepts: contiguous inner blocks of one
    stack."""
    u, pose0, h_dyn, bl_dyn, origin, res = _inputs(3, 4, 3, 29, np.float32)
    block_idx = block_index_sequence_dynamic(29, _t(h_dyn), _t(bl_dyn))
    args = (_t(u), _t(pose0), block_idx.to(torch.int32), _t(origin), _t(res), DT, FRONT, 3)
    _build.reset_launch_counts()
    got = rollout_prep(*args)
    ref = rollout_prep_plain(*args)
    assert not any(_build.launch_counts.values())
    for name in ref:
        assert torch.equal(got[name], ref[name]), name
    for name in ("dxdv", "dydv", "dxdw", "dydw"):
        assert got[name].shape == (4, 3, 29) and got[name].stride()[1:] == (29, 1)
