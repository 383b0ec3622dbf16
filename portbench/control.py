"""The check's control: the plain reference put in the program's place and
computed in bfloat16, the precision below the float32 the configurations
state, on the lanes a run of the cell would sample, at the cell's size:

    python3 portbench/control.py --workload <cell> --seed <n> [--workers k]

prints one JSON line of the numbers the check compares, each the control's
reading, so that every limit can be set between what the program reads and
what the control reads. Needs no card: the control and the reference are
NumPy. The benchmark's own runs never run it.

For a fleet or a robot cell the control runs the sampled lanes' episodes in
bfloat16 (reference/tick.py: Bfloat16Stages) and the float64 reference
judges them as it judges the program. For a campaign the control runs each
sampled lane's closed loop itself (the controller and the world update in
bfloat16) for the controller ticks the check compares, and the reference
follows the control's world state as it follows the program's.
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import check, harness  # noqa: E402
from portbench.gen import native  # noqa: E402


def closed_loop(job: dict):
    """A lane's closed loop in bfloat16 for job["ticks"] ticks: returns the
    robot poses (T+1, 3), people (T+1, N, 6), commands (T, 2), statuses
    (T,) and closest approaches (T,)."""
    from portbench.reference import tick

    lane, doc = job["lane"], job["config"]
    pose = np.asarray(lane["robot_pose"], np.float64)
    speed = np.asarray(lane["robot_speed"], np.float64)
    people = np.asarray(lane["people"], np.float64)
    poses, crowd, cmds, status, pds = [pose], [people], [], [], []
    cfg = tick.config_namespace(doc)
    costmap, esdf = tick.lane_world(lane)
    plan = tick.plan_of(lane)
    memory = {}
    for _ in range(job["ticks"]):
        with tick.Bfloat16Stages():
            out = tick.reference_tick(cfg, plan, pose, speed, people, costmap, esdf, memory)
        plan = out["plan"]
        cmd = tick.bf16(np.asarray(out["cmd"]))
        pose, people, pd = (tick.bf16(x) for x in tick.world_update(
            doc, lane, pose, speed, people, cmd, job["dt"]))
        speed = cmd
        poses.append(pose)
        crowd.append(people)
        cmds.append(cmd)
        status.append(out["status"])
        pds.append(pd)
    return dict(robot=np.array(poses), people=np.array(crowd), cmds=np.array(cmds),
                status=np.array(status), pds=np.array(pds))


def run_control(cell_name: str, seed: int, workers: int = 0, traffic=None) -> dict:
    """The control's numbers on the lanes a run of the cell samples
    (`traffic`: the cell's own unless given)."""
    bench = harness.benchmark()
    cell = harness.cell(bench, cell_name)
    doc = harness.config_doc(bench, cell["config"])
    traffic = traffic or harness.traffic(cell["traffic"])
    rng = np.random.default_rng(seed)
    c = traffic["check"]
    kind = traffic["driver"]
    size = traffic["batch"] if "batch" in traffic else traffic["scenarios"]
    arrays = native.generate(traffic["scenario"], size, seed, doc["people_per_scenario"],
                             doc["n_agents"], doc["max_path_points"])
    # The lanes and episodes a run of the cell samples, drawn in its order.
    if kind == "fleet":
        lanes = check.sample_lanes(rng, size, c["lanes"])
        rng.integers(0, c["episodes_within"])
        rest = np.setdiff1d(np.arange(size), lanes)
        picks = [(x, traffic["episode_ticks"]) for x in lanes] + \
            [(x, 1) for x in rest[check.sample_lanes(rng, len(rest), c["first_tick_lanes"])]]
    elif kind == "robot":
        drawn = rng.choice(c["episodes_within"], size=c["episodes"] + c["first_tick_episodes"],
                           replace=False)
        picks = [(e % size, traffic["episode_ticks"] if i < c["episodes"] else 1)
                 for i, e in enumerate(drawn)]
    else:
        lanes = check.sample_lanes(rng, size, c["lanes"])
        rest = np.setdiff1d(np.arange(size), lanes)
        picks = [(x, c["controller_ticks"]) for x in lanes] + \
            [(x, 1) for x in rest[check.sample_lanes(rng, len(rest), c["first_tick_lanes"])]]
    jobs = [dict(kind="controller", config=doc, lane=native.lanes(arrays, int(lane)))
            for lane, _ in picks]
    if kind in ("fleet", "robot"):
        poses = harness.plan_poses(arrays, traffic["episode_ticks"], traffic["plan_stride"])
        for job, (lane, n) in zip(jobs, picks):
            job["poses"] = [p[lane] for p in poses[:n]]
        control = check.run_reference([dict(j, control=True) for j in jobs], workers)
        refs = check.run_reference([dict(j, judge=check.judged(c[0]))
                                    for j, c in zip(jobs, control)], workers)
        numbers = check.TickNumbers()
        for prog, ref in zip(control, refs):
            for t, (p, q) in enumerate(zip(prog, ref)):  # reference_tick dicts read as answers
                numbers.add(p, q, first=t == 0, alone=len(prog) == 1)
    else:
        dt = traffic["control_period"]
        runs = [dict(j, ticks=n, dt=dt) for j, (_, n) in zip(jobs, picks)]
        loops = [closed_loop(j) for j in runs] if workers == 1 else \
            _pool(closed_loop, runs, workers)
        follow, world = [], []
        for job, loop in zip(runs, loops):
            k = job["ticks"]
            speeds = [job["lane"]["robot_speed"]] + list(loop["cmds"][:-1])
            follow.append(dict(job, poses=list(loop["robot"][:k]), speeds=speeds,
                               people=list(loop["people"][:k])))
            if k == c["controller_ticks"]:
                world.append(dict(job, kind="world", poses=list(loop["robot"][:k]),
                                  speeds=speeds, people=list(loop["people"][:k]),
                                  cmds=list(loop["cmds"])))
        refs = check.run_reference(follow + world, workers)
        numbers = check.CampaignNumbers()
        for loop, ref in zip(loops, refs[:len(follow)]):
            for t, q in enumerate(ref):
                numbers.add_tick(dict(cmd=tuple(loop["cmds"][t]), status=loop["status"][t]), q,
                                 first=t == 0, alone=len(ref) == 1)
        for loop, ref in zip(loops, refs[len(follow):]):
            numbers.add_world(loop["robot"], loop["people"], ref, float(np.min(loop["pds"])))
    return dict(values=numbers.values(), spread=numbers.spread(), answers=numbers.answers)


def _pool(fn, jobs, workers):
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    workers = workers or max(1, min(len(jobs), (os.cpu_count() or 2) - 1))
    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        return list(pool.map(fn, jobs))


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--workers", type=int, default=0)
    args = p.parse_args()
    out = run_control(args.workload, args.seed, args.workers)
    print(json.dumps(dict(workload=args.workload, seed=args.seed, **out)), flush=True)


if __name__ == "__main__":
    main()
