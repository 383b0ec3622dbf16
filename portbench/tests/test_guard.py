"""The guard against JAX: top-level module names compared whole (the
port's name begins with the JAX package's), the reference's imports, and
the command's refusal to run without a card."""

import os
import subprocess
import sys

from portbench import harness

ROOT = harness.ROOT


def test_forbidden_names_compared_whole(monkeypatch):
    fake = object()
    for name in ("nav2_social_mpc_controller_tpu_torch.controller", "jaxtyping",
                 "flaxen", "nav2_social_mpc_controller_tpu_torchx"):
        monkeypatch.setitem(sys.modules, name, fake)
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "nav2_social_mpc_controller_tpu.core", fake)
    monkeypatch.setitem(sys.modules, "jax", fake)
    assert harness.forbidden_loaded() == ["jax", "nav2_social_mpc_controller_tpu"]


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=ROOT, capture_output=True, text=True, check=True).stdout
    return eval(out.strip().splitlines()[-1])


def test_reference_imports_nothing_of_the_port_or_jax():
    tops = _modules_after("import portbench.reference.jobs, portbench.control")
    for name in ("torch", "jax", "jaxlib", "flax", "parity", harness.PORT,
                 "nav2_social_mpc_controller_tpu"):
        assert name not in tops, name


def test_harness_imports_no_jax():
    tops = _modules_after("import portbench.run as r, portbench.harness, portbench.trace, "
                          "portbench.check\nfrom portbench.drivers import fleet, robot, campaign")
    for name in harness.FORBIDDEN_TOP_LEVEL:
        assert name not in tops, name


def test_command_refuses_without_a_card():
    """Where torch sees no CUDA device the command exits non-zero and prints
    no result (the check runs here, where there is none)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "social.fleet4096",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr
