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
          --iters ticks (on the card one graph launch for all of them)
  dryrun  N ranks, one scenario each, through the distributed step, held
          against the batched step over the same N scenarios in one process
  config  load + resolve a config and dump it as JSON
  multihost  multi-process scenario campaign (BASELINE config 5) with
          warm-start carry and checkpoint/resume

Everything runs on the card (CUDA) and raises where there is none, unless
--platform cpu asks for the CPU (the kernels' plain versions). A rank of
`dryrun` and `multihost` is one process with one device: several ranks on
one card take --backend gloo (NCCL refuses two ranks on one card), ranks
with a card each NCCL, the default on the card.

Examples:
  python -m nav2_social_mpc_controller_tpu_torch step --config social
  python -m nav2_social_mpc_controller_tpu_torch sim --ticks 120 --people 3
  python -m nav2_social_mpc_controller_tpu_torch bench --batch 4096 --iters 10
  python -m nav2_social_mpc_controller_tpu_torch config --yaml params.yaml
  python -m nav2_social_mpc_controller_tpu_torch dryrun --devices 2 --backend gloo
  python -m nav2_social_mpc_controller_tpu_torch multihost --processes 2 --backend gloo \
      --per-device-batch 2048 --ticks 10 --checkpoint /tmp/carry --checkpoint-every 5
  torchrun --nproc-per-node 4 -m nav2_social_mpc_controller_tpu_torch multihost --ticks 100
"""

import argparse
import dataclasses
import json
import sys
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

    from nav2_social_mpc_controller_tpu_torch.core.types import scenario_from_numpy
    from nav2_social_mpc_controller_tpu_torch.runtime.bench import BenchLoop
    from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario_batch

    dev = _device(args)
    cfg = _named_config(args.config, args.yaml)
    scb = scenario_from_numpy(
        make_scenario_batch(cfg, args.batch, base_seed=0, n_valid_people=args.people), device=dev)
    # n ticks with the carry fed back, the pose moved by 1e-6 * i: one graph
    # launch on the card, the host loop on the CPU (runtime/bench.py)
    loop = BenchLoop(cfg, device=dev)
    bench = loop if dev.type == "cuda" else loop.host_loop
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    sync()
    t0 = time.perf_counter()
    float(bench(scb, 1).linear_x[0])  # the warm tick: builds the kernels on a cold cache
    warm = time.perf_counter() - t0
    sync()
    t0 = time.perf_counter()
    bench(scb, args.iters)
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


def _rank_tail(args):
    """The flags every spawned rank gets from its parent (subcommand's own
    flags come first)."""
    tail = ["--config", args.config, "--people", str(args.people), "--seed", str(args.seed)]
    if args.yaml:
        tail += ["--yaml", args.yaml]
    if args.platform:
        tail += ["--platform", args.platform]
    if args.backend:
        tail += ["--backend", args.backend]
    return tail


def _run_local_cluster(args, command, tail, processes):
    """Spawn the ranks, report every failed one on stderr, print rank 0's
    last output line (its result); exit 1 unless every rank exited 0."""
    from nav2_social_mpc_controller_tpu_torch.runtime import campaign

    results = campaign.spawn_local_cluster(tail, processes, port=args.port,
                                           timeout=args.timeout, command=command)
    for rank, (rc, _, err) in enumerate(results):
        if rc != 0:
            sys.stderr.write(f"--- rank {rank} (rc {rc}) ---\n{err[-3000:]}\n")
    lines = results[0][1].strip().splitlines()
    print(lines[-1] if lines else "{}")
    if not all(rc == 0 for rc, _, _ in results):
        raise SystemExit(1)


def _join_world(args, dev):
    """Initialise this process's group: a spawned rank joins its parent's
    rendezvous, a process with --coordinator the one named, a process
    started by torchrun torch's env:// rendezvous; anything else runs as a
    world of one (and says so). Returns the backend."""
    from nav2_social_mpc_controller_tpu_torch.parallel import multihost
    from nav2_social_mpc_controller_tpu_torch.runtime.campaign import find_free_port

    if args.worker or args.coordinator:
        return multihost.initialize(args.coordinator, args.num_processes, args.process_id,
                                    backend=args.backend, device=dev)
    if multihost.launched_by_torchrun():
        return multihost.initialize(backend=args.backend, device=dev)
    sys.stderr.write(f"{args.command}: no --coordinator, --processes or torchrun rendezvous; "
                     "running as a world of one\n")
    return multihost.initialize(f"localhost:{find_free_port()}", 1, 0,
                                backend=args.backend, device=dev)


def cmd_dryrun(args):
    """N ranks (spawned here, one scenario each) run the distributed step on
    N scenarios; rank 0 gathers every rank's rows and holds them against
    make_step_batch over the same N scenarios in one process: bit for bit on
    the card (float32); on the CPU in float64 within the JAX dryrun's
    tolerance (rtol 1e-5, atol 1e-6), status equal."""
    dev = _device(args)
    if not args.worker:
        tail = ["--devices", str(args.devices), *_rank_tail(args)]
        _run_local_cluster(args, "dryrun", tail, args.devices)
        return
    import torch.distributed as dist

    _join_world(args, dev)
    try:
        _dryrun_rank(args, dev)
    finally:
        dist.destroy_process_group()


def _dryrun_rank(args, dev):
    import numpy as np
    import torch
    import torch.distributed as dist

    from nav2_social_mpc_controller_tpu_torch.controller.controller import (
        make_carry,
        make_step_batch,
    )
    from nav2_social_mpc_controller_tpu_torch.core.types import scenario_from_numpy, tree_leaves
    from nav2_social_mpc_controller_tpu_torch.parallel.mesh import (
        gather_batch,
        make_distributed_step,
        make_mesh,
        shard_batch,
    )
    from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario_batch

    cfg = _named_config(args.config, args.yaml)
    mesh = make_mesh(dev)
    n = mesh.world_size
    sys.stderr.write(f"[rank {mesh.rank}] backend {dist.get_backend()}, device {mesh.device}\n")
    on_card = mesh.device.type == "cuda"
    dtype = torch.float32 if on_card else torch.float64
    sc = scenario_from_numpy(
        make_scenario_batch(cfg, n, base_seed=args.seed, n_valid_people=args.people,
                            grid_hw=(64, 64), dtype=np.float32 if on_card else np.float64),
        device=mesh.device, dtype=dtype)
    carry = make_carry(cfg, n, device=mesh.device, dtype=dtype)
    cmd, aux, new_carry, metrics = make_distributed_step(cfg, mesh, dtype)(
        shard_batch(mesh, sc), shard_batch(mesh, carry))
    got = gather_batch(mesh, (cmd, aux.status, aux.solve.iterations, new_carry))
    if mesh.rank != 0:
        return
    cmd_u, aux_u, carry_u = make_step_batch(cfg, device=mesh.device, dtype=dtype)(sc, carry)
    want = (cmd_u, aux_u.status, aux_u.solve.iterations, carry_u)
    if on_card:
        if not all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want))):
            raise SystemExit("dryrun: the distributed results differ from one process's")
    else:
        for a, b in ((got[0].linear_x, cmd_u.linear_x), (got[0].angular_z, cmd_u.angular_z)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
        if not torch.equal(got[1], aux_u.status):
            raise SystemExit("dryrun: the distributed status differs from one process's")
    expect = {"n_scenarios": n, "n_usable": int(aux_u.solve.usable.sum()),
              "total_iterations": int(aux_u.solve.iterations.sum())}
    seen = {k: int(getattr(metrics, k)) for k in expect}
    if seen != expect:
        raise SystemExit(f"dryrun: fleet metrics {seen}, one process's {expect}")
    print(json.dumps({"dryrun": "ok", "devices": n, **_platform(mesh.device)}))


def cmd_multihost(args):
    """Multi-process campaign runner (BASELINE config 5): a scenario fleet
    over every rank with warm-start carry + checkpoint/resume.

    Modes:
      default         torchrun's env:// rendezvous where torchrun started
                      the process (one process per card on every host);
                      else a world of one
      --processes N   a local cluster: spawn N ranks here (on one card:
                      --backend gloo)
      --worker        internal: a spawned rank
    """
    import torch.distributed as dist

    from nav2_social_mpc_controller_tpu_torch.runtime import campaign

    dev = _device(args)
    if args.processes and not args.worker:
        tail = ["--ticks", str(args.ticks), "--per-device-batch", str(args.per_device_batch),
                *_rank_tail(args)]
        if args.checkpoint:
            tail += ["--checkpoint", args.checkpoint]
        if args.checkpoint_every:
            tail += ["--checkpoint-every", str(args.checkpoint_every)]
        if args.resume:
            tail += ["--resume"]
        _run_local_cluster(args, "multihost", tail, args.processes)
        return
    _join_world(args, dev)
    try:
        summary = campaign.run_campaign(
            _named_config(args.config, args.yaml),
            ticks=args.ticks,
            per_device_batch=args.per_device_batch,
            n_people=args.people,
            seed=args.seed,
            checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every,
            resume=args.resume,
            log=lambda m: sys.stderr.write(m + "\n"),
            device=dev,
        )
    finally:
        dist.destroy_process_group()
    print(json.dumps(summary))


def _add_ranks(p):
    """Flags of the subcommands that run several ranks."""
    p.add_argument("--backend", default=None, choices=[None, "nccl", "gloo"],
                   help="process-group backend (default: nccl on the card, gloo on the CPU); "
                        "ranks that share one card need gloo")
    p.add_argument("--port", type=int, default=0,
                   help="rendezvous port of a local cluster (0 = pick an ephemeral port)")
    p.add_argument("--timeout", type=float, default=540.0,
                   help="seconds a local cluster may take before every rank is killed")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0's rendezvous (with --num-processes, --process-id)")
    p.add_argument("--num-processes", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--process-id", type=int, default=None, help=argparse.SUPPRESS)


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

    p = sub.add_parser("dryrun", help="multi-rank dry run against one process")
    _add_common(p)
    _add_ranks(p)
    p.add_argument("--devices", type=int, default=8, help="ranks to spawn, one scenario each")
    p.set_defaults(fn=cmd_dryrun)

    p = sub.add_parser("config", help="resolve + dump a config as JSON")
    _add_common(p)
    p.set_defaults(fn=cmd_config)

    p = sub.add_parser("multihost", help="multi-process scenario campaign (BASELINE config 5)")
    _add_common(p)
    _add_ranks(p)
    p.add_argument("--ticks", type=int, default=10)
    p.add_argument("--per-device-batch", type=int, default=8,
                   help="scenarios per rank (one device per rank: the JAX CLI's "
                        "--devices-per-process has no counterpart)")
    p.add_argument("--checkpoint", default=None, help="carry checkpoint base path")
    p.add_argument("--checkpoint-every", type=int, default=0, help="ticks between snapshots")
    p.add_argument("--resume", action="store_true", help="restore carry from --checkpoint")
    p.add_argument("--processes", type=int, default=0,
                   help="spawn a local cluster of N ranks")
    p.set_defaults(fn=cmd_multihost)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
