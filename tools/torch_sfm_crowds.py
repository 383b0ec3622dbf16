#!/usr/bin/env python3
"""How closely K5's general form (the SFM people projection past 32 agents)
follows its plain version in crowds, and how sensitive a crowd's float32
scan is to rounding. On the machine with the card (it needs nvcc):

    python3 tools/torch_sfm_crowds.py [--out FILE]

For each case (N agents, B scenarios of chip_smoke.py's make_batch, every
person valid, the crowd at the scenario generator's density or spread to a
density in people a square metre by chip_smoke.spread_crowd, optionally the
FOV-filtered people a tick hands K5) it prints one JSON line: the kernel's
device ms; per scenario, scale-normalised (chip_smoke.norm_err's measure),
the kernel against the plain version (its quantiles, its largest per output
column: x, y, yaw, t, speed, angular velocity), the plain version in float32
against itself in float64, and the plain version against itself with each
agent's social forces added by torch's reduction or in the reversed order
(chip_smoke.sfm_order_sensitivity); the scenarios whose kernel error passes
1e-4, and how many of them another order of the sums moves by at most 1e-5;
then the card's name and power limit as nvidia-smi gives them. Exits 1
without a card.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (N, B, people a square metre or None for the generator's, FOV-filtered)
CASES = ((33, 1024, None, False), (48, 1024, None, False), (64, 1024, None, False),
         (33, 4096, None, False), (64, 4096, None, False), (64, 4096, None, True),
         (128, 256, None, False), (128, 256, 0.5, False), (256, 256, 0.5, False),
         (1024, 8, 1.0, False), (3567, 4, 1.0, False), (3567, 4, 0.5, False))


def per_scenario(got, ref):
    """(B,) largest |got - ref| over max(1, max |ref|) of each scenario."""
    b = got.shape[0]
    g, r = got.double().reshape(b, -1), ref.double().reshape(b, -1)
    return (g - r).abs().max(dim=1).values / r.abs().max(dim=1).values.clamp(min=1.0)


def quantiles(x):
    import torch

    x = x.double()
    return [float(torch.quantile(x, p)) for p in (0.5, 0.9, 0.99)] + [float(x.max())]


def run_case(n, batch, density, filtered):
    import torch

    import chip_smoke as cs
    from nav2_social_mpc_controller_tpu_torch.controller.controller import (
        fov_filter, make_carry, step_pre,
    )
    from nav2_social_mpc_controller_tpu_torch.models import sfm as K5

    dev = "cuda"
    cfg = cs.agents_config(n)
    sc, poses = cs.make_batch(cfg, batch, dev, n_valid_people=n)
    sc = cs.with_pose(sc, poses[0])
    prep = step_pre(cfg, sc, make_carry(cfg, batch, device=dev)).prep
    if filtered:
        people = fov_filter(cfg, sc.people, sc.robot.pose, sc.costmap).state.contiguous()
    elif density is not None:
        people = cs.spread_crowd(sc.people.state, density)
    else:
        people = sc.people.state
    args = cs.sfm_inputs(sc, people, prep)
    kw = cs.sfm_keywords(cfg)
    got = K5.project_people(*args, **kw)
    ref = K5.project_people_plain(*args, **kw)
    ms = cs.time_cuda(lambda: K5.project_people(*args, **kw), 3 if n <= 256 else 1)
    a64 = tuple(a.double() if a.is_floating_point() else a for a in args)
    f64 = per_scenario(ref, K5.project_people_plain(*a64, **kw))
    calm, move = cs.sfm_order_sensitivity(args, kw, ref)
    e = per_scenario(got, ref)
    scale = ref.double().reshape(batch, -1).abs().max(dim=1).values.clamp(min=1.0)
    cols = ((got.double() - ref.double()).abs() / scale[:, None, None, None]).amax(dim=(0, 1, 2))
    return {
        "n": n, "batch": batch, "people_per_m2": density if density is not None
        else n / cs.GENERATOR_AREA_M2, "fov_filtered": filtered, "kernel_ms": ms,
        "t_column_equal": bool(torch.equal(got[..., 3], ref[..., 3])),
        "kernel_vs_plain_q50_q90_q99_max": quantiles(e),
        "kernel_vs_plain_max_by_column": [float(c) for c in cols],
        "plain_f32_vs_f64_q50_q90_q99_max": quantiles(f64),
        "plain_other_order_q50_q90_q99_max": quantiles(move),
        "scenarios_kernel_over_1e-4": int((e > 1e-4).sum()),
        "scenarios_order_insensitive": int(calm.sum()),
        "scenarios_order_insensitive_kernel_over_1e-4": int((calm & (e > 1e-4)).sum()),
        "scenarios_f64_within_1e-5": int((f64 <= 1e-5).sum()),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the JSON lines here too")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_sfm_crowds: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from nav2_social_mpc_controller_tpu_torch import _build

    _build.build()
    lines = [json.dumps(run_case(*case)) for case in CASES]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    text = "\n".join(lines) + "\n" + smi + "\n"
    print(text, end="")
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
