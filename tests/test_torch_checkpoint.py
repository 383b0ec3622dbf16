"""Checkpoint/restore of batched controller carries (utils/checkpoint.py)
against the JAX package's (tests/test_checkpoint.py): the port's round trip
is exact, and a carry the JAX package saved (its NumPy snapshot, what its
campaign writes) resumes in the port and gives the JAX package's next
tick."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nav2_social_mpc_controller_tpu.controller.controller import (
    make_carry as jax_make_carry,
    make_step_batch as jax_make_step_batch,
)
from nav2_social_mpc_controller_tpu.core.config import benchmark_social_config as jax_social
from nav2_social_mpc_controller_tpu.utils import checkpoint as jax_checkpoint
from nav2_social_mpc_controller_tpu.utils.scenarios import make_scenario as jax_make_scenario
from nav2_social_mpc_controller_tpu.utils.scenarios import stack_scenarios as jax_stack
from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry, make_step_batch
from nav2_social_mpc_controller_tpu_torch.core import types as T
from nav2_social_mpc_controller_tpu_torch.core.config import benchmark_social_config
from nav2_social_mpc_controller_tpu_torch.utils import checkpoint
from test_torch_common import scripted_poses


def _filled_carry(cfg, batch, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    c = make_carry(cfg, batch, device="cpu", dtype=dtype)
    return c._replace(
        prev_path=torch.randn(c.prev_path.shape, generator=g, dtype=dtype),
        prev_cmds=torch.randn(c.prev_cmds.shape, generator=g, dtype=dtype),
        prev_n=torch.randint(0, 30, c.prev_n.shape, generator=g, dtype=torch.int32),
        plan_start=torch.randint(0, 90, c.plan_start.shape, generator=g, dtype=torch.int32),
    )


def test_carry_roundtrip_is_exact(tmp_path):
    cfg = benchmark_social_config()
    carry = _filled_carry(cfg, 4)
    base = str(tmp_path / "sub" / "carry")
    path = checkpoint.save_carry(base, carry)
    assert path == base + ".pt" and os.listdir(tmp_path / "sub") == ["carry.pt"]
    restored = checkpoint.restore_carry(base, make_carry(cfg, 4, device="cpu"))
    assert type(restored) is T.ControllerCarry
    for a, b in zip(restored, carry):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # `like` sets device and dtype; the .pt path itself is accepted too.
    as64 = checkpoint.restore_carry(path, make_carry(cfg, 4, device="cpu", dtype=torch.float64))
    assert as64.prev_path.dtype == torch.float64 and as64.prev_n.dtype == torch.int32
    assert torch.equal(as64.prev_path, carry.prev_path.double())


def test_npz_snapshot_in_the_jax_layout_restores(tmp_path):
    """An .npz of leaf_0..leaf_3 (NumPy, the JAX package's layout) gives the
    same tensors; the port's own .pt wins where both exist."""
    cfg = benchmark_social_config()
    carry = _filled_carry(cfg, 3)
    np.savez(str(tmp_path / "c.npz"), **{f"leaf_{i}": x.numpy() for i, x in enumerate(carry)})
    restored = checkpoint.restore_carry(str(tmp_path / "c"), make_carry(cfg, 3, device="cpu"))
    assert all(torch.equal(a, b) for a, b in zip(restored, carry))
    other = _filled_carry(cfg, 3)._replace(prev_n=torch.zeros(3, dtype=torch.int32))
    checkpoint.save_carry(str(tmp_path / "c"), other)
    restored = checkpoint.restore_carry(str(tmp_path / "c"), make_carry(cfg, 3, device="cpu"))
    assert torch.equal(restored.prev_n, other.prev_n)


def test_restore_raises_on_what_it_cannot_read(tmp_path):
    cfg = benchmark_social_config()
    like = make_carry(cfg, 2, device="cpu")
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        checkpoint.restore_carry(str(tmp_path / "orbax"), like)
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_carry(str(tmp_path / "missing"), like)
    path = checkpoint.save_carry(str(tmp_path / "wide"), make_carry(cfg, 3, device="cpu"))
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore_carry(path, like)
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore_carry(path, like[:3])


def test_jax_snapshot_resumes_in_the_port(tmp_path):
    """One JAX float64 tick, its carry saved with the JAX package's
    save_carry(use_orbax=False); the port restores it exactly, and its next
    tick from it matches the JAX package's next tick within 1e-6 (status,
    cursor and carry counts equal)."""
    jcfg = jax_social()
    cfg = benchmark_social_config()
    sc_np = jax_stack([jax_make_scenario(jcfg, seed=s, n_valid_people=p, dtype=np.float64)
                       for s, p in enumerate((3, 2))])
    poses = scripted_poses(sc_np, 2)
    jstep = jax_make_step_batch(jcfg)
    jcarry = jax.tree.map(lambda x: jnp.broadcast_to(x, (2,) + x.shape),
                          jax_make_carry(jcfg, dtype=jnp.float64))
    ticks = [sc_np._replace(robot=sc_np.robot._replace(pose=p)) for p in poses]
    _, _, jcarry1 = jstep(ticks[0], jcarry)
    path = jax_checkpoint.save_carry(str(tmp_path / "jax_carry"), jcarry1, use_orbax=False)
    assert path.endswith(".npz")
    jcmd2, jaux2, jcarry2 = jax.tree.map(np.asarray, jstep(ticks[1], jcarry1))

    carry1 = checkpoint.restore_carry(str(tmp_path / "jax_carry"),
                                      make_carry(cfg, 2, device="cpu", dtype=torch.float64))
    for a, b in zip(carry1, jcarry1):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    cmd2, aux2, carry2 = T.to_numpy(make_step_batch(cfg, device="cpu", dtype=torch.float64)(
        T.scenario_from_numpy(ticks[1], device="cpu", dtype=torch.float64), carry1))
    np.testing.assert_allclose(cmd2.linear_x, jcmd2.linear_x, atol=1e-6)
    np.testing.assert_allclose(cmd2.angular_z, jcmd2.angular_z, atol=1e-6)
    np.testing.assert_array_equal(aux2.status, jaux2.status)
    np.testing.assert_array_equal(aux2.plan_start_index, jaux2.plan_start_index)
    np.testing.assert_allclose(carry2.prev_path, jcarry2.prev_path, atol=1e-6)
    np.testing.assert_allclose(carry2.prev_cmds, jcarry2.prev_cmds, atol=1e-6)
    np.testing.assert_array_equal(carry2.prev_n, jcarry2.prev_n)
    np.testing.assert_array_equal(carry2.plan_start, jcarry2.plan_start)
    assert (carry2.plan_start > 0).all()
