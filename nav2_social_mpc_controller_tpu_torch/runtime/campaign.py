"""Multi-process scenario campaigns: the BASELINE config-5 entry point
(100k+ concurrent scenarios, multi-tick with warm-start carry and
checkpoint/resume) over several ranks, one device each.

Counterpart of the JAX package's ``runtime/campaign.py``. The reference's
fleet story is one robot per process tree (Nav2 controller server + DDS);
here it is scenario data parallelism over a ``torch.distributed`` process
group (``parallel/``): each rank generates its local scenario shard, the
distributed step reduces the fleet metrics as the only traffic between
ranks, and the warm-start carry feeds back tick over tick exactly as in one
process.

Usage (CLI wiring in __main__.py):
  # real hosts, one process per card (torchrun's env:// rendezvous):
  torchrun --nproc-per-node 4 -m nav2_social_mpc_controller_tpu_torch multihost --ticks 100

  # a local cluster of 2 ranks; on one card they share it through gloo:
  python -m nav2_social_mpc_controller_tpu_torch multihost --processes 2 \\
      --backend gloo --ticks 10 --per-device-batch 2048
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

LOCAL_CLUSTER_TIMEOUT_S = 540.0


def _carry_ckpt_path(base: str, rank: int) -> str:
    return f"{base}.proc{rank}"


def run_campaign(
    cfg,
    ticks: int,
    per_device_batch: int,
    n_people: int = 3,
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    log=lambda m: None,
    device="cuda",
    dtype=torch.float32,
):
    """Worker body: run `ticks` distributed control ticks. Call AFTER the
    process group is initialised (``parallel.multihost.initialize``; a world
    of one included). Each rank contributes per_device_batch scenarios of
    seeds ``seed + 100_000 * rank + i``; its carry (the TrajectoryMemory
    equivalent) is checkpointed to ``<checkpoint_path>.proc<rank>.pt`` every
    `checkpoint_every` ticks and at the end, and restored with `resume`
    (a JAX snapshot, ``.proc<rank>.npz``, too). Returns a summary dict
    (identical on every rank) with the JAX package's keys."""
    import torch.distributed as dist

    from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry
    from nav2_social_mpc_controller_tpu_torch.parallel import multihost
    from nav2_social_mpc_controller_tpu_torch.parallel.mesh import (
        gather_batch,
        make_distributed_step,
    )
    from nav2_social_mpc_controller_tpu_torch.utils.checkpoint import restore_carry, save_carry
    from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario_batch

    mesh = multihost.make_global_mesh(device)
    rank = mesh.rank
    backend = dist.get_backend(mesh.group)
    local_batch = per_device_batch  # one device per rank
    global_batch = multihost.global_batch_size(mesh, per_device_batch)
    sync = torch.cuda.synchronize if mesh.device.type == "cuda" else (lambda: None)

    log(f"[proc {rank}] backend {backend}, device {mesh.device}; "
        f"generating {local_batch} local scenarios...")
    t0 = time.perf_counter()
    scb_np = make_scenario_batch(cfg, local_batch, base_seed=seed + 100_000 * rank,
                                 n_valid_people=n_people, grid_hw=(64, 64))
    generate_s = time.perf_counter() - t0
    scb = multihost.host_local_to_global(mesh, scb_np, dtype)
    carry = make_carry(cfg, local_batch, device=mesh.device, dtype=dtype)
    ckpt = _carry_ckpt_path(checkpoint_path, rank) if checkpoint_path else None
    start_tick = 0
    if resume and ckpt and (os.path.exists(ckpt + ".pt") or os.path.exists(ckpt + ".npz")):
        carry = restore_carry(ckpt, carry)
        if os.path.exists(ckpt + ".meta.json"):
            with open(ckpt + ".meta.json") as f:
                start_tick = json.load(f)["tick"]
        log(f"[proc {rank}] resumed carry from {ckpt} at tick {start_tick}")
    step = make_distributed_step(cfg, mesh, dtype)

    def save(tick):
        p = save_carry(ckpt, carry)
        with open(ckpt + ".meta.json", "w") as f:
            json.dump({"tick": tick, "local_batch": local_batch}, f)
        log(f"[proc {rank}] checkpointed tick {tick} -> {p}")

    sync()
    t0 = time.perf_counter()
    metrics = None
    for t in range(start_tick, ticks):
        # Per-tick pose jitter keeps every stage live (as the JAX campaign).
        eps = float(np.float32(1e-6 * t))
        scb_t = scb._replace(robot=scb.robot._replace(pose=scb.robot.pose + eps))
        _, _, carry, metrics = step(scb_t, carry)
        if ckpt and checkpoint_every and (t + 1) % checkpoint_every == 0:
            save(t + 1)
    sync()
    elapsed = time.perf_counter() - t0
    if ckpt:
        save(ticks)
    generate_all = gather_batch(
        mesh, torch.tensor([generate_s], dtype=torch.float64, device=mesh.device))

    n_ticks_run = ticks - start_tick
    n_scenarios = int(metrics.n_scenarios) if metrics is not None else 0
    return {
        "global_batch": global_batch,
        "processes": mesh.world_size,
        "devices": mesh.world_size,
        "ticks": n_ticks_run,
        "resumed_from_tick": start_tick,
        "elapsed_s": round(elapsed, 3),
        "solves_per_s": round(global_batch * max(n_ticks_run, 0) / max(elapsed, 1e-9), 1),
        "n_scenarios": n_scenarios,
        "n_usable": int(metrics.n_usable) if metrics is not None else 0,
        "n_status_ok": int(metrics.n_status_ok) if metrics is not None else 0,
        "mean_lm_iters": (
            int(metrics.total_iterations) / max(n_scenarios, 1) if metrics is not None else 0.0
        ),
        "mean_final_cost": float(metrics.mean_final_cost) if metrics is not None else 0.0,
        "platform": mesh.device.type,
        "backend": backend,
        "generate_s": generate_all.tolist(),
    }


def find_free_port() -> int:
    """Reserve an ephemeral localhost port (bind-0 trick) for a local
    cluster's rendezvous, so parallel runs never collide on a fixed port."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_local_cluster(argv_tail, processes: int, port: int = 0,
                        timeout: float = LOCAL_CLUSTER_TIMEOUT_S, command: str = "multihost"):
    """Launch `processes` copies of the CLI's `command` in --worker mode on
    a localhost rendezvous (port 0: an ephemeral one), each with `argv_tail`,
    and wait for them. As soon as one exits non-zero, every other is killed,
    so a dead rank never leaves the others waiting in a collective; on
    `timeout` every worker is killed and TimeoutError raised. Returns
    [(returncode, stdout, stderr)] in rank order."""
    if port == 0:
        port = find_free_port()
    procs, files = [], []
    timed_out = False
    try:
        for rank in range(processes):
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
            files.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "nav2_social_mpc_controller_tpu_torch", command,
                 "--worker", "--coordinator", f"localhost:{port}",
                 "--num-processes", str(processes), "--process-id", str(rank), *argv_tail],
                stdout=out, stderr=err, text=True,
            ))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes) or all(c is not None for c in codes):
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    results = []
    for p, (out, err) in zip(procs, files):
        with out, err:
            out.seek(0)
            err.seek(0)
            results.append((p.returncode, out.read(), err.read()))
    if timed_out:
        tails = "".join(f"--- rank {r} ---\n{e[-2000:]}\n" for r, (_, _, e) in enumerate(results))
        raise TimeoutError(f"local cluster: no result within {timeout} s; workers killed\n{tails}")
    return results
