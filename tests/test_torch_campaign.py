"""The port's multi-process campaign (runtime/campaign.py, the CLI's
`multihost`) end to end on the CPU, with tests/test_campaign.py's
assertions: 2 gloo ranks run a multi-tick campaign with carry
checkpointing, then resume from the snapshots; the resumed carry has the
bits of one uninterrupted run; a failed rank fails the campaign at once.

The children run on ATen's scalar CPU kernels (ATEN_CPU_CAPABILITY=default,
as tests/test_torch_common.py: run_scalar_cpu_child) and on one intra-op
thread: in float32 the plain JtJ's sum over the residual rows is split
between threads when the batch is wide enough, so a scenario's bits depend
on the batch width otherwise. There, 2 ranks x 2 scenarios equal one
process with 4."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from nav2_social_mpc_controller_tpu_torch.runtime.campaign import find_free_port
from test_torch_common import REPO, run_scalar_cpu_child

CHILD_TIMEOUT_S = 240


def _cli(argv, timeout=CHILD_TIMEOUT_S):
    env = dict(os.environ, ATEN_CPU_CAPABILITY="default", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", "nav2_social_mpc_controller_tpu_torch", *argv],
                          capture_output=True, text=True, env=env, cwd=REPO, timeout=timeout)


def _campaign(base, extra):
    proc = _cli(["multihost", "--processes", "2", "--platform", "cpu", "--per-device-batch", "2",
                 "--people", "2", "--port", str(find_free_port()), "--timeout", "180",
                 "--checkpoint", base, *extra])
    assert proc.returncode == 0, f"campaign failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}"
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def campaign(tmp_path_factory):
    """2 ticks checkpointed every tick, then resumed up to tick 3."""
    base = str(tmp_path_factory.mktemp("campaign") / "carry")
    first = _campaign(base, ["--ticks", "2", "--checkpoint-every", "1"])
    metas = [json.load(open(f"{base}.proc{r}.meta.json")) for r in range(2)]
    resumed = _campaign(base, ["--ticks", "3", "--resume"])
    return base, first, metas, resumed


def test_campaign_and_resume(campaign):
    _, s1, metas, s2 = campaign
    assert s1["processes"] == 2
    assert s1["devices"] == 2  # one device per rank
    assert s1["global_batch"] == 4
    assert s1["ticks"] == 2
    assert s1["n_scenarios"] == 4
    assert s1["n_usable"] == 4
    assert s1["platform"] == "cpu" and s1["backend"] == "gloo" and len(s1["generate_s"]) == 2
    assert metas == [{"tick": 2, "local_batch": 2}] * 2

    assert s2["resumed_from_tick"] == 2
    assert s2["ticks"] == 1  # only the remaining tick runs
    assert s2["n_usable"] == 4


def test_resumed_carry_equals_an_uninterrupted_run(campaign):
    """The two ranks' final snapshots, concatenated in rank order, equal one
    process's carry after 3 uninterrupted ticks of the same 4 scenarios
    (rank 0's seeds, then rank 1's) with the same pose jitter, bit for bit."""
    base = campaign[0]
    ref = base + ".reference"
    run_scalar_cpu_child(f"""
import json
import numpy as np, torch
from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry, make_step_batch
from nav2_social_mpc_controller_tpu_torch.core.config import benchmark_social_config
from nav2_social_mpc_controller_tpu_torch.core.types import scenario_from_numpy
from nav2_social_mpc_controller_tpu_torch.utils.checkpoint import save_carry
from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario_batch

def cat(a, b):
    if hasattr(a, "_fields"):
        return type(a)(*(cat(x, y) for x, y in zip(a, b)))
    return np.concatenate([a, b])

torch.set_num_threads(1)
cfg = benchmark_social_config()
parts = [make_scenario_batch(cfg, 2, base_seed=s, n_valid_people=2, grid_hw=(64, 64))
         for s in (0, 100_000)]
sc = scenario_from_numpy(cat(*parts), device="cpu")
step = make_step_batch(cfg, device="cpu")
carry = make_carry(cfg, 4, device="cpu")
for t in range(3):
    eps = float(np.float32(1e-6 * t))
    _, _, carry = step(sc._replace(robot=sc.robot._replace(pose=sc.robot.pose + eps)), carry)
print(json.dumps({{"path": save_carry({ref!r}, carry)}}))
""")
    got = [torch.load(f"{base}.proc{r}.pt", weights_only=True) for r in range(2)]
    want = torch.load(ref + ".pt", weights_only=True)
    assert sorted(want) == [f"leaf_{i}" for i in range(4)]
    for k, w in want.items():
        assert torch.equal(torch.cat([got[0][k], got[1][k]]), w), k


def test_a_failed_rank_fails_the_campaign_at_once(tmp_path):
    """Rank 1 cannot read its snapshot and raises while rank 0 waits for it
    in the tick's collective: the CLI kills rank 0 and exits non-zero long
    before its --timeout."""
    base = str(tmp_path / "carry")
    with open(base + ".proc1.pt", "wb") as f:
        f.write(b"not a snapshot")
    t0 = time.monotonic()
    proc = _cli(["multihost", "--processes", "2", "--platform", "cpu", "--per-device-batch", "2",
                 "--people", "0", "--ticks", "3", "--port", str(find_free_port()),
                 "--timeout", "180", "--checkpoint", base, "--resume"])
    assert proc.returncode != 0
    assert time.monotonic() - t0 < 120
    assert "rank 1 (rc 1)" in proc.stderr


def test_a_world_of_one_without_a_rendezvous(tmp_path):
    proc = _cli(["multihost", "--platform", "cpu", "--per-device-batch", "2", "--people", "0",
                 "--ticks", "1"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "running as a world of one" in proc.stderr
    s = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (s["processes"], s["devices"], s["global_batch"], s["n_scenarios"]) == (1, 1, 2, 2)
