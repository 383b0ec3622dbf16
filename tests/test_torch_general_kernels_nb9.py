"""The plain versions of the kernels that a config in more than six blocks
runs in their general forms on the card (kernel_shapes.form), at NB = 9
(D = 18: the social horizon in blocks of 2), against the JAX package, each
at that kernel's own tolerance of the templated shapes' tests: the rollout
prep (K6) against its Pallas kernel in interpret mode in float32; the fused
evaluation with people (K2, with K1 and K6 before it), propose (K3) and
commit (K4) against the JAX package's plain references in float64
(_ref_value_grad, propose_ref, commit_ref). The Pallas kernels of those
three in interpret mode took 154 s and 93 s at this shape on the CPU, too
long for the tier-1 run."""

import jax.numpy as jnp
import numpy as np
import torch
from test_torch_common import check_value_grad_with_people
from test_torch_lm_iter import test_commit_matches_reference as _k4_check
from test_torch_lm_iter import test_propose_matches_reference_f64 as _k3_check

from nav2_social_mpc_controller_tpu.ops.rollout_pallas import rollout_prep_pallas
from nav2_social_mpc_controller_tpu_torch import kernel_shapes
from nav2_social_mpc_controller_tpu_torch.models.motion import block_index_sequence_dynamic
from nav2_social_mpc_controller_tpu_torch.ops.rollout_cuda import rollout_prep_plain

torch.set_num_threads(1)

NB = 9
DT, FRONT = 0.05, 0.25


def test_nine_blocks_run_the_general_forms_on_the_card():
    assert kernel_shapes.form("f", "blocks", NB) == kernel_shapes.GENERAL
    assert kernel_shapes.form("f", "solve", 2 * NB) == kernel_shapes.GENERAL


def test_rollout_prep_plain_matches_pallas_kernel_interpreted():
    """K6 at NB = 9 over 29 steps in blocks of 2 (every block has steps in
    the full-horizon scenario 0, the others a shrunk horizon): poses and
    sensitivities rtol 2e-5 / atol 1e-5, row/col atol 2e-4, the copied
    controls exact, as tests/test_torch_rollout_prep.py holds NB = 3 and 6."""
    b, s = 6, 29
    rng = np.random.default_rng(9)
    u = rng.uniform(-0.8, 0.8, (b, 2 * NB)).astype(np.float32)
    pose0 = np.concatenate(
        [rng.uniform(-5, 5, (b, 2)), rng.uniform(-np.pi, np.pi, (b, 1))], axis=1).astype(np.float32)
    h_dyn = rng.integers(1, 2 * NB + 1, b)
    h_dyn[0] = 2 * NB
    bl_dyn = np.minimum(2, h_dyn)
    origin = rng.uniform(-10, 0, (b, 2)).astype(np.float32)
    res = np.full((b,), 0.05, np.float32)
    block_idx = block_index_sequence_dynamic(s, torch.as_tensor(h_dyn), torch.as_tensor(bl_dyn))
    assert set(block_idx[0].tolist()) == set(range(NB))
    got = rollout_prep_plain(torch.as_tensor(u), torch.as_tensor(pose0), block_idx,
                             torch.as_tensor(origin), torch.as_tensor(res), DT, FRONT, NB)

    eb_t = (block_idx.numpy().T[None, :, :] == np.arange(NB)[:, None, None]).astype(np.float32)
    dp = -(-2 * NB // 8) * 8
    u_t8 = jnp.zeros((dp, b), jnp.float32).at[: 2 * NB].set(u.T)
    sc8 = jnp.zeros((8, b), jnp.float32).at[0:3].set(pose0.T).at[3:5].set(origin.T).at[5].set(res)
    ref = rollout_prep_pallas(u_t8, jnp.asarray(eb_t), sc8, s, NB, DT, FRONT, interpret=True)
    names = "px py pth v dxdv dydv dxdw dydw dth row col".split()
    ref = dict(zip(names, (np.asarray(x) for x in ref)))
    np.testing.assert_array_equal(got["v"].numpy(), ref["v"].T)
    for name in ("px", "py", "pth", "row", "col"):
        atol = 2e-4 if name in ("row", "col") else 1e-5
        np.testing.assert_allclose(got[name].numpy(), ref[name].T, rtol=2e-5, atol=atol,
                                   err_msg=name)
    for name in ("dxdv", "dydv", "dxdw", "dydw"):  # Pallas: (NB, S, B)
        np.testing.assert_allclose(got[name].numpy(), np.transpose(ref[name], (2, 0, 1)),
                                   rtol=2e-5, atol=1e-5, err_msg=name)


def test_value_grad_with_people_matches_reference_f64():
    """cost, g and JtJ of the social config in blocks of 2, people in view
    in four of five scenarios, against the vmapped _ref_value_grad
    (test_torch_common's protocol, 1e-9 scale-normalised)."""
    check_value_grad_with_people(
        "social_bl2", np.float64, {"social_bl2": ("social_bl2", (3, 3, 0, 2, 3))})


def test_propose_matches_reference_f64_at_d18():
    """tests/test_torch_lm_iter.py's comparison at D = 18, 5 scenarios."""
    _k3_check(5, 2 * NB)


def test_commit_matches_reference_f64_at_d18():
    """tests/test_torch_lm_iter.py's comparison at D = 18: every
    termination code, the discrete outputs equal."""
    _k4_check(2 * NB, np.float64)
