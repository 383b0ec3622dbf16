#!/usr/bin/env python3
"""First-use build seconds of the port's CUDA kernels, for one or more
checkouts, in turns, on the machine with the card (it needs nvcc).

    python3 tools/torch_build_seconds.py ROOT [ROOT ...] [--rounds 2]

For each round and each ROOT (a checkout of this repository, e.g. the
parent commit unpacked with `git archive` beside this one) it removes the
package's built library, then times `_build.build(verbose=True)` in a fresh
process with ROOT first on sys.path: every source's nvcc process started
together, then the link. Prints one JSON line per build (root, seconds,
sources, and per kernel the registers and spill bytes ptxas reported), then
the card's name and power limit as nvidia-smi gives them.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

CHILD = r"""
import json, re, sys, time
sys.path.insert(0, sys.argv[1])
from nav2_social_mpc_controller_tpu_torch import _build
t0 = time.perf_counter()
_build.build(verbose=True)
seconds = time.perf_counter() - t0
kernels, name = {}, None
for ln in _build.last_build_log.splitlines():
    m = re.search(r"Compiling entry function '(\w+)'", ln)
    if m:
        name = m.group(1)
    m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
    if m and name:
        kernels.setdefault(name, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
    m = re.search(r"Used (\d+) registers", ln)
    if m and name:
        kernels.setdefault(name, {})["registers"] = int(m.group(1))
print(json.dumps({"root": sys.argv[1], "seconds": seconds, "sources": len(_build.sources()),
                  "kernels": kernels}))
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    order = []
    for r in range(args.rounds):
        order += args.roots if r % 2 == 0 else args.roots[::-1]
    for root in order:
        root = os.path.abspath(root)
        shutil.rmtree(os.path.join(root, "nav2_social_mpc_controller_tpu_torch", "build"),
                      ignore_errors=True)
        out = subprocess.run([sys.executable, "-c", CHILD, root], capture_output=True, text=True,
                             cwd=root)
        if out.returncode != 0:
            sys.stderr.write(out.stderr[-4000:])
            raise SystemExit(f"build of {root} failed")
        print(out.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
