"""The port's CLI: the user-facing runtime surface the reference delegates to
ROS 2 tooling (`ros2 launch` + Nav2 controller_server + rviz). Same
subcommands, flags and JSON keys as the JAX package's CLI, plus the platform
(and the card's name) each ran on.

Subcommands:
  step    one controller tick on a synthetic scenario (or a reference-format
          params YAML) — prints the command and solve telemetry as JSON
  sim     closed-loop simulation (the Gazebo-validation analogue,
          runtime/simulator.py) — prints behavioral metrics
  bench   batched-throughput measurement: B scenarios, a warm tick, then
          --iters ticks
  config  load + resolve a config and dump it as JSON

Everything runs on the card (CUDA) and raises where there is none, unless
--platform cpu asks for the CPU (the kernels' plain versions).

Examples:
  python -m nav2_social_mpc_controller_tpu_torch step --config social
  python -m nav2_social_mpc_controller_tpu_torch sim --ticks 120 --people 3
  python -m nav2_social_mpc_controller_tpu_torch bench --batch 4096 --iters 10
  python -m nav2_social_mpc_controller_tpu_torch config --yaml params.yaml
"""

import argparse
import dataclasses
import json
import time


def _named_config(name: str, yaml_path=None):
    from nav2_social_mpc_controller_tpu_torch.core import config

    if yaml_path:
        return config.load_config_from_yaml(yaml_path)
    return {
        "social": config.benchmark_social_config,
        "obstacle": config.benchmark_obstacle_only_config,
        "omni6": config.benchmark_omni_6agents_config,
        "stress36": config.benchmark_stress_h36_config,
        "default": config.SocialMPCConfig,
    }[name]()


def _device(args):
    """The device the subcommand runs on: the card unless --platform cpu;
    asking for the card where there is none raises."""
    from nav2_social_mpc_controller_tpu_torch.core.types import resolve_device

    return resolve_device("cpu" if args.platform == "cpu" else "cuda")


def _platform(dev):
    """The platform keys of a result: `platform` (cuda or cpu) and, on the
    card, its name."""
    import torch

    out = {"platform": dev.type}
    if dev.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(dev)
    return out


def _add_common(p):
    p.add_argument("--config", default="social",
                   choices=["social", "obstacle", "omni6", "stress36", "default"])
    p.add_argument("--yaml", default=None, help="reference-format params YAML (overrides --config)")
    p.add_argument("--platform", default=None, choices=[None, "cpu"],
                   help="run on the CPU (default: the CUDA card)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--people", type=int, default=3)


def cmd_step(args):
    from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry, make_step
    from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario

    dev = _device(args)
    cfg = _named_config(args.config, args.yaml)
    if args.debug_optimizer:
        cfg = dataclasses.replace(
            cfg, optimizer=dataclasses.replace(cfg.optimizer, debug_optimizer=True)
        )
    sc = make_scenario(cfg, seed=args.seed, n_valid_people=args.people)
    cmd, aux, _ = make_step(cfg, device=dev)(sc, make_carry(cfg, device=dev))
    out = {
        "linear_x": float(cmd.linear_x),
        "linear_y": float(cmd.linear_y),
        "angular_z": float(cmd.angular_z),
        "status": int(aux.status),
        "lm_iterations": int(aux.solve.iterations),
        "initial_cost": float(aux.solve.initial_cost),
        "final_cost": float(aux.solve.final_cost),
        "termination": int(aux.solve.termination),
        "usable": bool(aux.solve.usable),
    }
    if aux.lm_trace is not None:
        # Ceres PER_MINIMIZER_ITERATION-style rows (optimizer.cpp:122-130)
        tr = type(aux.lm_trace)(*(t.cpu() for t in aux.lm_trace))
        out["iterations"] = [
            {
                "iter": i,
                "cost": float(tr.cost[i]),
                "cost_change": float(tr.cost_change[i]),
                "gradient_max": float(tr.grad_max[i]),
                "step_norm": float(tr.step_norm[i]),
                "tr_ratio": float(tr.tr_ratio[i]),
                "tr_radius": float(tr.tr_radius[i]),
                "accepted": bool(tr.accepted[i]),
            }
            for i in range(int(aux.solve.iterations))
        ]
    print(json.dumps({**out, **_platform(dev)}))


def cmd_sim(args):
    import numpy as np

    from nav2_social_mpc_controller_tpu_torch.core.types import to_numpy
    from nav2_social_mpc_controller_tpu_torch.runtime.simulator import make_simulate
    from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario

    dev = _device(args)
    cfg = _named_config(args.config, args.yaml)
    sc = make_scenario(cfg, seed=args.seed, n_valid_people=args.people)
    res = to_numpy(make_simulate(cfg, args.ticks, device=dev)(sc))
    cmds, status = res.cmds, res.status
    out = {
        "ticks": args.ticks,
        "goal_dist_final": float(res.goal_dist),
        "min_people_dist": float(res.min_people_dist),
        "mean_v": float(cmds[:, 0].mean()),
        "max_v": float(cmds[:, 0].max()),
        "max_abs_w": float(np.abs(cmds[:, 1]).max()),
        "status_ok_frac": float((status == 0).mean()),
        "robot_final_pose": [float(x) for x in res.robot_traj[-1]],
    }
    if args.dump_traj:
        np.savez(args.dump_traj, robot_traj=res.robot_traj, people_traj=res.people_traj,
                 cmds=cmds, status=status)
        out["trajectory_file"] = args.dump_traj
    print(json.dumps({**out, **_platform(dev)}))


def cmd_bench(args):
    import torch

    from nav2_social_mpc_controller_tpu_torch.controller.controller import (
        make_carry,
        make_step_batch,
    )
    from nav2_social_mpc_controller_tpu_torch.core.types import scenario_from_numpy
    from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario_batch

    dev = _device(args)
    cfg = _named_config(args.config, args.yaml)
    scb = scenario_from_numpy(
        make_scenario_batch(cfg, args.batch, base_seed=0, n_valid_people=args.people), device=dev)
    step = make_step_batch(cfg, device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def run(n):
        """n ticks with the carry fed back, the pose moved by 1e-6 * i."""
        carry = make_carry(cfg, args.batch, device=dev)
        for i in range(n):
            sc = scb._replace(robot=scb.robot._replace(pose=scb.robot.pose + 1e-6 * i))
            cmd, _, carry = step(sc, carry)
        return cmd.linear_x[0]

    sync()
    t0 = time.perf_counter()
    float(run(1))  # the warm tick: builds the kernels on a cold cache
    warm = time.perf_counter() - t0
    sync()
    t0 = time.perf_counter()
    run(args.iters)
    sync()
    total = time.perf_counter() - t0
    per_tick = total / args.iters
    print(json.dumps({
        "metric": f"social_mpc_solves_per_s_H{cfg.optimizer.control_horizon}_{args.config}",
        "value": round(args.batch / per_tick, 1),
        "unit": "solves/s/chip",
        "batch": args.batch,
        "iters": args.iters,
        "batch_latency_ms": round(per_tick * 1e3, 3),
        "warmup_s": round(warm, 2),
        **_platform(dev),
    }))


def cmd_config(args):
    cfg = _named_config(args.config, args.yaml)
    print(json.dumps(dataclasses.asdict(cfg), indent=2))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="social-mpc-torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("step", help="one controller tick")
    _add_common(p)
    p.add_argument("--debug-optimizer", action="store_true",
                   help="per-LM-iteration trace (Ceres PER_MINIMIZER_ITERATION analogue)")
    p.set_defaults(fn=cmd_step)

    p = sub.add_parser("sim", help="closed-loop simulation")
    _add_common(p)
    p.add_argument("--ticks", type=int, default=100)
    p.add_argument("--dump-traj", default=None, help="write trajectories to this .npz")
    p.set_defaults(fn=cmd_sim)

    p = sub.add_parser("bench", help="batched throughput measurement")
    _add_common(p)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--iters", type=int, default=5)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("config", help="resolve + dump a config as JSON")
    _add_common(p)
    p.set_defaults(fn=cmd_config)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
