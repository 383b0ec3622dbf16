#!/usr/bin/env python3
"""Do two checkouts' templated kernels give the same bits? On the machine
with the card (it needs nvcc), for the kernels templated on NB, D and N:

    python3 tools/torch_templated_bits.py PARENT_ROOT [--batch 1024] [--out FILE]

PARENT_ROOT is another checkout of this repository (e.g. the parent commit
unpacked with `git archive` beside this one). For NB = 1..6 (D = 2 NB; the
social config in blocks of 4, every person valid, every fourth robot near its
goal, as chip_smoke.py's kernel_shapes phase) this checkout captures the
inputs of K2 (with people and people-free), K6, rollout_sample, K3, K4 and
K7 (its damped step with and without the Jacobi scale, its standalone solve)
as a real tick hands them over, after 3 LM iterations, and for N = 3, 6, 24
and 32 agents (the social config with N agents, every person valid) the
inputs of K5 as a tick's head hands them over, and saves them. Then,
in a fresh process for each checkout, with that checkout first on sys.path
and its library built from its own sources, every templated wrapper runs on
the saved inputs and its outputs are saved. Prints one JSON line per kernel
and NB (or N) with the number of output elements whose bits differ between the two
checkouts (NaN against NaN counted equal) and the elements compared, then a
summary line, then the card's name and power limit as nvidia-smi gives them.
Exits 1 if a wrapper did not launch its templated form.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CAPTURE = r"""
import sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry

from nav2_social_mpc_controller_tpu_torch.controller.controller import step_pre

dev, batch, out = torch.device("cuda"), int(sys.argv[2]), sys.argv[3]
saved = {"blocks": {}, "agents": {}}
for n in (3, 6, 24, 32):
    cfg = cs.agents_config(n)
    sc, poses = cs.make_batch(cfg, batch, dev, n_valid_people=n)
    sc = cs.with_pose(sc, poses[0])
    prep = step_pre(cfg, sc, make_carry(cfg, batch, device=dev)).prep
    saved["agents"][n] = {"args": cs.sfm_inputs(sc, sc.people.state, prep),
                          "kw": cs.sfm_keywords(cfg)}
for nb in range(1, 7):
    cfg = cs.blocks_config(nb)
    caps = {}
    for n_valid in (cfg.n_agents, 0):
        sc, poses = cs.make_batch(cfg, batch, dev, n_valid_people=n_valid)
        sc = cs.with_pose(sc, cs.near_goal_every(sc, poses[0]))
        caps[n_valid] = cs.capture_iteration(cfg, sc, make_carry(cfg, batch, device=dev))
    cap = caps[cfg.n_agents]
    assert cap["propose"][0].shape[1] == 2 * nb
    saved["blocks"][nb] = {
        "statics": tuple(cap["fused"][0]), "fused": cap["fused"][1:],
        "fused_free": caps[0]["fused"][1:], "lm_cfg": cap["lm_cfg"]._asdict(),
        "rollout_prep": cap["rollout_prep"], "win": cap["bicubic"][0],
        "propose": cap["propose"], "commit": cap["commit"], "jac_scale": cap["jac_scale"],
        "spd_solve": cap["spd_solve"],
    }
torch.cuda.synchronize()
torch.save(saved, out)
"""

RUN = r"""
import sys, torch
sys.path.insert(0, sys.argv[1])
from nav2_social_mpc_controller_tpu_torch import _build
from nav2_social_mpc_controller_tpu_torch.models import sfm as K5
from nav2_social_mpc_controller_tpu_torch.ops import fused_iter as K2
from nav2_social_mpc_controller_tpu_torch.ops import rollout_cuda as K6
from nav2_social_mpc_controller_tpu_torch.solver import cuda_iter as K34
from nav2_social_mpc_controller_tpu_torch.solver import cuda_solve as K7
from nav2_social_mpc_controller_tpu_torch.solver.lm import LMConfig

caps = torch.load(sys.argv[2], weights_only=False)
outs, counts = {}, {}
for n, c in caps["agents"].items():
    before = _build.launch_counts["sfm_scan"]
    outs[("N", n)] = {"sfm_scan": [K5.project_people(*c["args"], **c["kw"])]}
    counts[("N", n)] = {"sfm_scan": _build.launch_counts["sfm_scan"] - before}
for nb, c in caps["blocks"].items():
    statics = K2.FusedStatics(*c["statics"])
    lm_cfg = LMConfig(**c["lm_cfg"])
    before = {k: _build.launch_counts[k] for k in
              ("fused_iter", "rollout_prep", "rollout_sample", "propose", "commit", "spd_solve")}
    prep = K6.rollout_prep(*c["rollout_prep"])
    sample = K6.rollout_sample(c["win"], *c["rollout_prep"])
    outs[("NB", nb)] = {
        "fused_iter": list(K2.fused_cost_g_jtj(statics, *c["fused"])),
        "fused_iter_people_free": list(K2.fused_cost_g_jtj(statics, *c["fused_free"])),
        "rollout_prep": [prep[k] for k in sorted(prep)],
        "rollout_sample": [sample[k] for k in sorted(sample)],
        "propose": list(K34.propose(lm_cfg, *c["propose"])),
        "commit": list(K34.commit(lm_cfg, *c["commit"])),
        "damped_step": list(K34.damped_step(lm_cfg, *c["propose"])),
        "damped_step_jacobi": list(K34.damped_step(lm_cfg, *c["propose"], c["jac_scale"])),
        "spd_solve": [K7.spd_solve(*c["spd_solve"])],
    }
    counts[("NB", nb)] = {k: _build.launch_counts[k] - v for k, v in before.items()}
torch.cuda.synchronize()
torch.save({"outs": {nb: {k: [t.cpu() for t in v] for k, v in o.items()} for nb, o in outs.items()},
            "counts": counts}, sys.argv[3])
"""

WANT_COUNTS = {"fused_iter": 2, "rollout_prep": 1, "rollout_sample": 1, "propose": 1,
               "commit": 1, "spd_solve": 3, "sfm_scan": 1}


def child(code, *args):
    out = subprocess.run([sys.executable, "-c", code, *args], capture_output=True, text=True,
                         cwd=args[0])
    if out.returncode != 0:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-8000:])
        raise SystemExit(f"child failed in {args[0]} (exit {out.returncode})")


def bits_differ(a, b):
    """Elements of a and b (same shape and dtype) whose bits differ, NaN
    against NaN counted equal."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return a.numel()
    if a.is_floating_point():
        both_nan = torch.isnan(a) & torch.isnan(b)
        ai, bi = a.view(torch.int32), b.view(torch.int32)
        return int(((ai != bi) & ~both_nan).sum())
    return int((a != b).sum())


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--out", default=None, help="write the JSON lines here too")
    args = ap.parse_args()
    import torch

    parent = os.path.abspath(args.parent)
    with tempfile.TemporaryDirectory() as tmp:
        caps = os.path.join(tmp, "caps.pt")
        child(CAPTURE, ROOT, str(args.batch), caps)
        runs = {}
        for name, root in (("parent", parent), ("change", ROOT)):
            path = os.path.join(tmp, f"{name}.pt")
            child(RUN, root, caps, path)
            runs[name] = torch.load(path, weights_only=False)
    lines, ok, total_differ, total = [], True, 0, 0
    for key in sorted(runs["change"]["outs"]):
        kind, size = key
        for name, rows in runs["change"]["counts"][key].items():
            if rows != WANT_COUNTS[name] or runs["parent"]["counts"][key][name] != rows:
                ok = False
                print(f"{kind} = {size}: {name} launched its templated form {rows} times "
                      f"(parent {runs['parent']['counts'][key][name]}), want {WANT_COUNTS[name]}",
                      file=sys.stderr)
        for kernel, got in runs["change"]["outs"][key].items():
            ref = runs["parent"]["outs"][key][kernel]
            differ = sum(bits_differ(a, b) for a, b in zip(got, ref))
            n = sum(a.numel() for a in got)
            total_differ += differ
            total += n
            shape = {"nb": size, "d": 2 * size} if kind == "NB" else {"n": size}
            lines.append({"kernel": kernel, **shape, "batch": args.batch,
                          "elements": n, "bits_differ": differ})
    lines.append({"summary": True, "elements": total, "bits_differ": total_differ,
                  "parent": parent, "change": ROOT})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    text = "\n".join(json.dumps(x) for x in lines) + "\n" + smi + "\n"
    print(text, end="")
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
