#!/usr/bin/env python3
"""Does torch.profiler lose device records of a replayed CUDA graph, and
which padding keeps them? Runs on the machine with the card.

    python3 tools/torch_profiler_loss.py

Captures the social config's one-launch tick at B = 1024, then profiles
each of its stage graphs (head, chunk, tail) 8 times in each of five ways,
in turns: the replay alone ("plain"), behind a ~2 ms spin kernel
("spin_before"), between two ("spin_both"), between two host sleeps of
20 ms ("host_sleep"), and behind 128 empty spin kernels ("pad_kernels",
what chip_smoke.py's device_activity does); an eager tick is profiled
before every other round. Prints,
per stage and way, the records of each profile and, for a short one, how
many of the longest profile's first and last records it kept.
"""
import collections
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import chip_smoke as cs  # noqa: E402
from nav2_social_mpc_controller_tpu_torch.controller.controller import (  # noqa: E402
    make_carry, make_step_batch,
)
from nav2_social_mpc_controller_tpu_torch.core.config import benchmark_social_config  # noqa: E402

PAD = 4_000_000  # ~2 ms of spin
MODES = ("plain", "spin_before", "spin_both", "host_sleep", "pad_kernels")


def device_seq(fn, mode):
    """Names of the device records of one call of fn(), in start order."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if mode in ("spin_before", "spin_both"):
            torch.cuda._sleep(PAD)
        if mode == "host_sleep":
            torch.cuda.synchronize()
            time.sleep(0.02)
        if mode == "pad_kernels":
            for _ in range(128):
                torch.cuda._sleep(0)
        fn()
        if mode == "spin_both":
            torch.cuda._sleep(PAD)
        torch.cuda.synchronize()
        if mode == "host_sleep":
            time.sleep(0.02)
    evs = [e for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    evs.sort(key=lambda e: e.time_range.start)
    return [e.name for e in evs if "spin_kernel" not in e.name]


def main():
    print("torch", torch.__version__, torch.version.cuda, flush=True)
    dev = "cuda"
    cfg = benchmark_social_config()
    sc, poses = cs.make_batch(cfg, 1024, dev, n_valid_people=3)
    step = make_step_batch(cfg, device=dev)
    cs.run_ticks(step, sc, poses, make_carry(cfg, 1024, device=dev))
    stages = cs.program_stages(cs.one_launch_tick(step))
    eager = make_step_batch(cfg, device=dev, capture=False)
    carry0 = make_carry(cfg, 1024, device=dev)

    def eager_run():
        return eager(cs.with_pose(sc, poses[0]), carry0)

    eager_run()
    for what, stage in stages:
        full = None
        res = collections.defaultdict(list)
        for rnd in range(8):
            if rnd % 2 == 0:
                print(f"  eager tick profiled: {len(device_seq(eager_run, 'plain'))} records",
                      flush=True)
            for mode in MODES:
                seq = device_seq(stage.graph.replay, mode)
                res[mode].append(seq)
                if full is None or len(seq) > len(full):
                    full = seq
        print(f"== {what}: longest {len(full)} records", flush=True)
        for mode, seqs in res.items():
            info = []
            for s in seqs:
                if len(s) < len(full):
                    pre = next((i for i, (a, b) in enumerate(zip(s, full)) if a != b), len(s))
                    suf = next((i for i, (a, b) in enumerate(zip(s[::-1], full[::-1]))
                                if a != b), len(s))
                    info.append(f"{len(full) - len(s)} lost; same first {pre}, same last {suf}")
            print(f"  {mode:12s} records {[len(s) for s in seqs]} {info[:3]}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
