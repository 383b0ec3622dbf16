#!/usr/bin/env python3
"""The phases of chip_smoke.py that hold the shapes the benchmark configs do
not reach, alone, on one card:

    python3 tools/torch_kernel_shapes.py [--steps] [--bench]

device, build (ptxas and the SASS probes), kernel_shapes (every NB, D and
N instantiation against its plain version, the general forms up to their
limits), and with --steps the step_shapes phase (the reference's defaults,
horizon 7 in blocks of 4, 12 agents, and the configs that run the general
forms: main path, one launch against eager), with --bench the bench phase
(the CLI's bench loop, one launch against the host loop). One JSON line per
phase, then the card's name and power limit.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main():
    _, smi = chip_smoke.phase_device()
    chip_smoke.phase_build()
    chip_smoke.phase_kernel_shapes("cuda")
    if "--steps" in sys.argv[1:]:
        chip_smoke.phase_step_shapes("cuda")
    if "--bench" in sys.argv[1:]:
        chip_smoke.phase_bench("cuda")
    print(smi, flush=True)


if __name__ == "__main__":
    main()
