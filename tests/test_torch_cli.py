"""The port's CLI: the same subcommands, flags and JSON keys as the JAX
package's CLI (nav2_social_mpc_controller_tpu/__main__.py), on the CPU with
--platform cpu; on the card by default, so without one it raises."""

import json

import numpy as np
import pytest
import torch

from nav2_social_mpc_controller_tpu.__main__ import main as jax_main
from nav2_social_mpc_controller_tpu_torch.__main__ import main

# The JSON keys the JAX CLI prints (its cmd_step / cmd_sim / cmd_bench).
JAX_KEYS = {
    "step": {"linear_x", "linear_y", "angular_z", "status", "lm_iterations", "initial_cost",
             "final_cost", "termination", "usable"},
    "sim": {"ticks", "goal_dist_final", "min_people_dist", "mean_v", "max_v", "max_abs_w",
            "status_ok_frac", "robot_final_pose"},
    "bench": {"metric", "value", "unit", "batch", "iters", "batch_latency_ms", "warmup_s",
              "platform"},
}
TRACE_KEYS = {"iter", "cost", "cost_change", "gradient_max", "step_norm", "tr_ratio",
              "tr_radius", "accepted"}


def _run(capsys, fn, argv):
    assert fn(argv) is None  # returns; no SystemExit
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("name", ["social", "obstacle", "omni6", "stress36", "default"])
def test_config_equals_the_jax_cli(capsys, name):
    assert _run(capsys, main, ["config", "--config", name]) == \
        _run(capsys, jax_main, ["config", "--config", name])


def test_config_yaml_equals_the_jax_cli(tmp_path, capsys):
    y = tmp_path / "p.yaml"
    y.write_text(
        "FollowPath:\n  optimizer:\n    control_horizon: 12\n"
        "    parameter_block_length: 4\n    debug_optimizer: true\n"
        "  fov_angle: 1.2\n"
    )
    got = _run(capsys, main, ["config", "--yaml", str(y)])
    assert got == _run(capsys, jax_main, ["config", "--yaml", str(y)])
    assert got["optimizer"]["control_horizon"] == 12


def test_step_on_the_cpu(capsys):
    out = _run(capsys, main, ["step", "--config", "obstacle", "--people", "0",
                              "--platform", "cpu"])
    assert JAX_KEYS["step"] <= set(out) and out["platform"] == "cpu"
    assert out["usable"] is True and out["status"] == 0
    assert 0.0 <= out["linear_x"] <= 0.6 + 1e-6
    assert "iterations" not in out


def test_step_debug_optimizer_on_the_cpu(capsys):
    out = _run(capsys, main, ["step", "--debug-optimizer", "--people", "2", "--seed", "1",
                              "--platform", "cpu"])
    assert JAX_KEYS["step"] <= set(out)
    assert len(out["iterations"]) == out["lm_iterations"] > 0
    assert all(set(row) == TRACE_KEYS for row in out["iterations"])


def test_sim_on_the_cpu(capsys, tmp_path):
    dump = str(tmp_path / "traj.npz")
    out = _run(capsys, main, ["sim", "--ticks", "3", "--people", "2", "--platform", "cpu",
                              "--dump-traj", dump])
    assert JAX_KEYS["sim"] | {"trajectory_file"} <= set(out) and out["platform"] == "cpu"
    assert out["ticks"] == 3 and out["max_v"] <= 0.6 + 1e-6
    with np.load(dump) as z:
        assert z["robot_traj"].shape == (4, 3) and z["status"].dtype == np.int32


def test_bench_on_the_cpu(capsys):
    out = _run(capsys, main, ["bench", "--batch", "2", "--iters", "2", "--config", "obstacle",
                              "--people", "0", "--platform", "cpu"])
    assert JAX_KEYS["bench"] <= set(out)
    assert out["unit"] == "solves/s/chip" and out["value"] > 0 and out["platform"] == "cpu"
    assert out["metric"] == "social_mpc_solves_per_s_H18_obstacle"


def test_dryrun_on_the_cpu(capsys):
    """2 gloo ranks, one scenario each, held against make_step_batch over the
    same 2 scenarios in one process (float64, the JAX dryrun's tolerance)."""
    out = _run(capsys, main, ["dryrun", "--devices", "2", "--platform", "cpu",
                              "--timeout", "200"])
    assert out == {"dryrun": "ok", "devices": 2, "platform": "cpu"}


def test_requires_subcommand():
    with pytest.raises(SystemExit):
        main([])


@pytest.mark.parametrize("argv", [["step"], ["sim", "--ticks", "1"],
                                  ["bench", "--batch", "1", "--iters", "1"],
                                  ["dryrun", "--devices", "2"],
                                  ["multihost", "--ticks", "1"],
                                  ["multihost", "--processes", "2", "--backend", "gloo"]])
def test_runs_on_the_card_by_default(argv):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default does not raise here")
    with pytest.raises(RuntimeError, match="cuda"):
        main(argv)
