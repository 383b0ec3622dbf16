#!/usr/bin/env python3
"""Tick times of the port's make_step_batch on the card, for comparing two
checkouts of the port in turns.

    python3 tools/torch_tick_turns.py --root DIR --label NAME

imports ``nav2_social_mpc_controller_tpu_torch`` from checkout DIR (its
kernels are built there at first use), drives the cells below on one CUDA
device and prints one JSON line: per cell the host-clock ms of each warm
tick (a tick ends in ``torch.cuda.synchronize()``; min, p50, p90) and the
tick's host operations (``step.tick.host_launches`` per tick). Run it once
per checkout and order (parent, change, change, parent) in one call to the
card: two versions are compared only within one machine.

Cells, by group:

  ticks      obstacle and social at B = 1024 and 4096 (three ticks with the
             carry fed back, the robot riding its plan, 64 seeds tiled to
             B), the debug-trace tick (``debug_optimizer``) at social
             B = 4096 and stress36 B = 1024, the social config with both
             latent critics (pure angle 0.5, curvature 0.3) at B = 1024;
  one_robot  one robot (``make_step``, B = 1, the social config and its
             latent variant) riding its plan for 30 ticks;
  compacted  the warm-start tick (warm_start_mode="previous_solution")
             through make_step_batch_compacted (capacity 0.25) and through
             make_step_batch beside it: social B = 4096 over the three
             poses and over 10 ticks from the first pose perturbed by
             1e-6 * t (bench.py's warm ticks), stress36 B = 1024 over the
             three poses;
  sim        a 40-tick closed-loop campaign of 4,096 social scenarios
             (``make_simulate``): ms per simulated tick and the host's
             operations per simulated tick, the simulator's and its
             step's.

Scenarios come from ``utils/scenarios.py: make_scenario_batch`` with a
fixed seed, so every checkout solves the same problems.
"""

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

N_SEEDS = 64
ROUNDS = 4  # timed rounds of the three ticks, after one warm round
ONE_ROBOT_TICKS = 30
ONE_ROBOT_WARM = 5


def stats(ms):
    return {"ticks": len(ms), "min": float(np.min(ms)), "p50": float(np.median(ms)),
            "p90": float(np.percentile(ms, 90)), "mean": float(np.mean(ms))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="checkout whose port is timed")
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    sys.path.insert(0, args.root)

    import torch

    from nav2_social_mpc_controller_tpu_torch import _build
    from nav2_social_mpc_controller_tpu_torch.controller.controller import (
        make_carry, make_step, make_step_batch, make_step_batch_compacted,
    )
    from nav2_social_mpc_controller_tpu_torch.runtime.simulator import make_simulate
    from nav2_social_mpc_controller_tpu_torch.core import config as C
    from nav2_social_mpc_controller_tpu_torch.core.types import scenario_from_numpy
    from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario_batch

    if not torch.cuda.is_available():
        sys.exit("torch_tick_turns: needs a CUDA device")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0

    def replace_opt(cfg, **changes):
        opt = cfg.optimizer
        weights = changes.pop("weights", None)
        if weights:
            opt = dataclasses.replace(opt, weights=dataclasses.replace(opt.weights, **weights))
        return dataclasses.replace(cfg, optimizer=dataclasses.replace(opt, **changes))

    def batch(cfg, b, n_people):
        """64 seeds tiled to b scenarios on the card, and three poses
        riding each plan (plan points 0, 4, 8)."""
        base = scenario_from_numpy(
            make_scenario_batch(cfg, N_SEEDS, base_seed=0, n_valid_people=n_people), device=dev)
        reps = -(-b // N_SEEDS)

        def tile(tree):
            return type(tree)(*(tile(x) if isinstance(x, tuple) else
                                x.repeat(reps, *([1] * (x.dim() - 1)))[:b].contiguous()
                                for x in tree))
        sc = tile(base)
        poses = []
        for t in range(3):
            i = torch.clamp(torch.full_like(sc.path.n, 4 * t), max=sc.path.n - 1).long()
            pts = torch.gather(sc.path.points, 1, i[:, None, None].expand(-1, 1, 2))[:, 0]
            poses.append(torch.cat([pts, torch.gather(sc.path.yaw, 1, i[:, None])], dim=1))
        return sc, poses

    def with_pose(sc, pose):
        return sc._replace(robot=sc.robot._replace(pose=pose))

    def timed_ticks(step, cfg, sc, poses, b):
        ms = []
        for rnd in range(ROUNDS + 1):
            carry = make_carry(cfg, b, device=dev)
            if rnd == 1:
                step.tick.reset_host_launches()
            for pose in poses:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                _, _, carry = step(with_pose(sc, pose), carry)
                torch.cuda.synchronize()
                if rnd > 0:
                    ms.append((time.perf_counter() - t1) * 1e3)
        host = {k: v / len(ms) for k, v in step.tick.host_launches.items()}
        return {**stats(ms), "host_operations_per_tick": host}

    def one_robot(cfg, n_people):
        sc, _ = batch(cfg, 1, n_people)

        def lane(tree):
            return type(tree)(*(lane(x) if isinstance(x, tuple) else x[0] for x in tree))
        one = lane(sc)
        n_pts = int(one.path.n)
        step = make_step(cfg, device=dev)
        ms = []
        carry = make_carry(cfg, device=dev)
        for k in range(ONE_ROBOT_WARM + ONE_ROBOT_TICKS):
            if k == ONE_ROBOT_WARM:
                step.tick.reset_host_launches()
            i = min(k, n_pts - 1)
            scen = one._replace(robot=one.robot._replace(
                pose=torch.cat([one.path.points[i], one.path.yaw[i:i + 1]])))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, _, carry = step(scen, carry)
            torch.cuda.synchronize()
            if k >= ONE_ROBOT_WARM:
                ms.append((time.perf_counter() - t1) * 1e3)
        host = {k: v / len(ms) for k, v in step.tick.host_launches.items()}
        return {**stats(ms), "host_operations_per_tick": host}

    def campaign(cfg, b, n_ticks, rounds=3):
        sc, _ = batch(cfg, b, cfg.n_agents)
        sim = make_simulate(cfg, n_ticks, device=dev)
        sim(sc)  # warm: captures
        ms = []
        sim.reset_host_launches()
        sim.step.tick.reset_host_launches()
        for _ in range(rounds):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            sim(sc)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3 / n_ticks)
        per_tick = rounds * n_ticks
        return {**stats(ms), "simulated_ticks": n_ticks,
                "host_operations_per_simulated_tick": {
                    "simulator": {k: v / per_tick for k, v in sim.host_launches.items()},
                    "step": {k: v / per_tick for k, v in sim.step.tick.host_launches.items()}}}

    social, obstacle = C.benchmark_social_config(), C.benchmark_obstacle_only_config()
    stress36 = C.benchmark_stress_h36_config()
    latent = replace_opt(social, weights={"pure_angle_weight": 0.5, "curvature_weight": 0.3})
    cells = {}
    with torch.no_grad():
        for name, cfg, b in [("obstacle", obstacle, 1024), ("obstacle", obstacle, 4096),
                             ("social", social, 1024), ("social", social, 4096),
                             ("social debug", replace_opt(social, debug_optimizer=True), 4096),
                             ("stress36 debug", replace_opt(stress36, debug_optimizer=True),
                              1024),
                             ("social latent", latent, 1024)]:
            sc, poses = batch(cfg, b, cfg.n_agents if name != "obstacle" else 0)
            cells[f"{name} B={b}"] = timed_ticks(make_step_batch(cfg, device=dev), cfg, sc,
                                                  poses, b)
            del sc
        cells["social one robot B=1"] = one_robot(social, social.n_agents)
        cells["social latent one robot B=1"] = one_robot(latent, social.n_agents)
        for name, cfg, b in [("social", social, 4096), ("stress36", stress36, 1024)]:
            warm = replace_opt(cfg, warm_start_mode="previous_solution")
            sc, poses = batch(warm, b, cfg.n_agents)
            runs = [("", poses)]
            if name == "social":
                runs.append((" warm10", [poses[0] + 1e-6 * t for t in range(10)]))
            for suffix, seq in runs:
                for kind, make in (("compacted", make_step_batch_compacted),
                                   ("warm plain", make_step_batch)):
                    step = make(warm, device=dev)
                    cells[f"{name} {kind}{suffix} B={b}"] = timed_ticks(step, warm, sc, seq, b)
            del sc
        cells["social sim B=4096"] = campaign(social, 4096, 40)
    print(json.dumps({"label": args.label, "root": args.root, "build_s": build_s,
                      "device": torch.cuda.get_device_name(0), "cells": cells}), flush=True)


if __name__ == "__main__":
    main()
