"""Scenario data parallelism of the port (parallel/mesh.py,
parallel/multihost.py) against the JAX package's (tests/test_parallel.py):
the distributed step over torch.distributed ranks (gloo, on the CPU) gives
what one process gives, and what the JAX package's shard_map'd step gives
on its virtual mesh over the same scenarios."""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from nav2_social_mpc_controller_tpu.controller.controller import make_carry as jax_make_carry
from nav2_social_mpc_controller_tpu.core.config import benchmark_social_config as jax_social
from nav2_social_mpc_controller_tpu.parallel.mesh import (
    make_distributed_step as jax_make_distributed_step,
    make_mesh as jax_make_mesh,
    shard_batch as jax_shard_batch,
)
from nav2_social_mpc_controller_tpu.utils.scenarios import (
    make_scenario_batch as jax_make_scenario_batch,
)
from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry, make_step_batch
from nav2_social_mpc_controller_tpu_torch.core.config import benchmark_social_config
from nav2_social_mpc_controller_tpu_torch.core.types import scenario_from_numpy, tree_leaves
from nav2_social_mpc_controller_tpu_torch.parallel import multihost
from nav2_social_mpc_controller_tpu_torch.parallel.mesh import (
    Mesh,
    gather_batch,
    make_distributed_step,
    make_mesh,
    shard_batch,
)
from nav2_social_mpc_controller_tpu_torch.runtime.campaign import find_free_port
from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One rank of the 2-rank run: the 8 scenarios from the JAX package's
# generator (an .npz in jax.tree.leaves order), this rank's 4 through the
# distributed step in float64, every rank's rows gathered; rank 0 prints them.
RANK = textwrap.dedent("""\
    import json, sys
    import numpy as np, torch
    from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry
    from nav2_social_mpc_controller_tpu_torch.core.config import benchmark_social_config
    from nav2_social_mpc_controller_tpu_torch.core.types import scenario_from_numpy
    from nav2_social_mpc_controller_tpu_torch.parallel import multihost
    from nav2_social_mpc_controller_tpu_torch.parallel.mesh import (
        gather_batch, make_distributed_step, shard_batch)
    from nav2_social_mpc_controller_tpu_torch.utils.checkpoint import restore_carry
    from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario_batch

    port, rank, npz = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    multihost.initialize(f"localhost:{port}", 2, rank, backend="gloo", device="cpu",
                         timeout_s=200)
    mesh = multihost.make_global_mesh("cpu")
    cfg = benchmark_social_config()
    like = scenario_from_numpy(make_scenario_batch(cfg, 8, 0, n_valid_people=3, grid_hw=(64, 64),
                                                   dtype=np.float64), device="cpu", dtype=torch.float64)
    sc = restore_carry(npz, like)
    carry = make_carry(cfg, 8, device="cpu", dtype=torch.float64)
    cmd, aux, new_carry, m = make_distributed_step(cfg, mesh, torch.float64)(
        shard_batch(mesh, sc), shard_batch(mesh, carry))
    assert cmd.linear_x.shape == (4,)
    got = gather_batch(mesh, (cmd.linear_x, cmd.angular_z, aux.status, aux.solve.iterations))
    torch.distributed.destroy_process_group()
    if rank == 0:
        print(json.dumps({"linear_x": got[0].tolist(), "angular_z": got[1].tolist(),
                          "status": got[2].tolist(), "iterations": got[3].tolist(),
                          "metrics": {k: getattr(m, k).item() for k in m._fields},
                          "dtypes": [str(getattr(m, k).dtype) for k in m._fields]}))
""")


@pytest.fixture
def world_of_one():
    """A gloo process group of one rank in this process, torn down after."""
    multihost.initialize(f"localhost:{find_free_port()}", 1, 0, backend="gloo", device="cpu",
                         timeout_s=60)
    try:
        yield make_mesh("cpu")
    finally:
        dist.destroy_process_group()


def test_world_of_one_is_make_step_batch_bit_for_bit(world_of_one):
    """Two ticks with the carry fed back: command, aux and carry equal to
    make_step_batch's on the same inputs; the metrics the local sums and
    mean."""
    mesh = world_of_one
    assert (mesh.rank, mesh.world_size, mesh.device) == (0, 1, torch.device("cpu"))
    assert mesh.group is None  # the default group, not a reference that outlives it
    cfg = benchmark_social_config()
    sc = scenario_from_numpy(make_scenario_batch(cfg, 4, 0, n_valid_people=3, grid_hw=(64, 64)),
                             device="cpu")
    dstep = make_distributed_step(cfg, mesh)
    step = make_step_batch(cfg, device="cpu")
    carry_d = carry_u = make_carry(cfg, 4, device="cpu")
    for t in range(2):
        sc_t = sc._replace(robot=sc.robot._replace(pose=sc.robot.pose + float(np.float32(1e-6 * t))))
        cmd_d, aux_d, carry_d, m = dstep(shard_batch(mesh, sc_t), carry_d)
        cmd_u, aux_u, carry_u = step(sc_t, carry_u)
        for a, b in zip(tree_leaves((cmd_d, aux_d, carry_d)), tree_leaves((cmd_u, aux_u, carry_u))):
            assert torch.equal(a, b)
        assert int(m.n_scenarios) == 4
        assert int(m.n_usable) == int(aux_u.solve.usable.sum())
        assert int(m.n_status_ok) == int((aux_u.status == 0).sum())
        assert int(m.total_iterations) == int(aux_u.solve.iterations.sum())
        assert torch.equal(m.mean_final_cost, aux_u.solve.final_cost.mean())
        assert m.n_scenarios.dtype == torch.int32 and m.mean_final_cost.dtype == torch.float32
    # gather_batch of one rank's rows gives them back.
    back = gather_batch(mesh, carry_d)
    assert all(torch.equal(a, b) for a, b in zip(back, carry_d))


def test_two_ranks_match_the_jax_distributed_step(tmp_path):
    """2 gloo ranks x 4 social scenarios in float64 against the JAX
    package's make_distributed_step on a 4-device virtual mesh over the same
    8 scenarios: commands within 1e-6; status, LM iterations and the four
    counts of FleetMetrics equal; mean_final_cost within 1e-9 relative (a
    mean over 2 ranks of 4 against a mean over 4 devices of 2)."""
    jcfg = jax_social()
    sc_np = jax_make_scenario_batch(jcfg, 8, n_valid_people=3, grid_hw=(64, 64), dtype=np.float64)
    npz = str(tmp_path / "scenarios.npz")
    np.savez(npz, **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(jax.tree.leaves(sc_np))})
    port = str(find_free_port())
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-c", RANK, port, str(r), npz], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        # The JAX side meanwhile (tests/test_parallel.py's protocol).
        mesh = jax_make_mesh(4)
        carry = jax.vmap(lambda _: jax_make_carry(jcfg, dtype=jnp.float64))(jnp.arange(8))
        jcmd, jaux, _, jm = jax_make_distributed_step(jcfg, mesh)(
            jax_shard_batch(mesh, sc_np), jax_shard_batch(mesh, carry))
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, f"exit codes {[q.returncode for q in procs]}: {err[-3000:]}"
    got = json.loads(outs[0][0].strip().splitlines()[-1])
    np.testing.assert_allclose(got["linear_x"], np.asarray(jcmd.linear_x), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["angular_z"], np.asarray(jcmd.angular_z), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got["status"], np.asarray(jaux.status))
    np.testing.assert_array_equal(got["iterations"], np.asarray(jaux.solve.iterations))
    for k in ("n_scenarios", "n_usable", "n_status_ok", "total_iterations"):
        assert got["metrics"][k] == int(getattr(jm, k)), k
    assert got["metrics"]["n_scenarios"] == 8
    np.testing.assert_allclose(got["metrics"]["mean_final_cost"], float(jm.mean_final_cost),
                               rtol=1e-9)
    assert got["dtypes"] == ["torch.int32"] * 4 + ["torch.float64"]


def test_shard_batch_raises_on_a_batch_the_ranks_do_not_divide():
    mesh = Mesh(group=None, rank=1, world_size=2, device=torch.device("cpu"))
    rows = shard_batch(mesh, (np.arange(6), torch.arange(12).reshape(6, 2)))
    assert rows[0].tolist() == [3, 4, 5] and rows[1].tolist() == [[6, 7], [8, 9], [10, 11]]
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        shard_batch(mesh, (torch.zeros(4), torch.zeros(3)))


def test_no_fallback_in_the_rendezvous():
    """The mesh needs an initialised group; NCCL is never taken for CPU
    ranks, and the explicit rendezvous takes all three arguments."""
    with pytest.raises(RuntimeError, match="not initialised"):
        make_mesh("cpu")
    with pytest.raises(ValueError, match="NCCL"):
        multihost.initialize("localhost:1", 1, 0, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="together"):
        multihost.initialize("localhost:1", None, 0, backend="gloo", device="cpu")
    with pytest.raises(ValueError, match="not one of"):
        multihost.initialize("localhost:1", 1, 0, backend="mpi", device="cpu")
    assert multihost.default_backend("cpu") == "gloo"
    assert multihost.default_backend("cuda") == "nccl"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            multihost.initialize("localhost:1", 1, 0)
    assert not dist.is_initialized()
