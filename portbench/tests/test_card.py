"""On the card: one short run of each cell through the command, its last
line as the contract sets it out, and `correct` true. Skips where torch
sees no CUDA device."""

import json
import subprocess
import sys

import pytest

from portbench import harness

BENCH = harness.benchmark()


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                        str(2**31 + 41), "--seconds", "2", "--trace", str(trace)],
                       cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert line["correct"] is True, line["checks"]
    section = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in harness.cell_metrics(BENCH, cell, section)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    else:
        assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0
    assert list(line)[-1] == "checks"
