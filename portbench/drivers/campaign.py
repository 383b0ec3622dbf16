"""Entry point runtime/simulator.py Simulator: B closed loops of T ticks
in lockstep, each campaign one launch from the same start batch, back to
back; after each campaign the host reads the status, the final distance to
the goal and the closest approach to a person.

The check's reference follows the program's world state: the controller's
first `controller_ticks` ticks of each sampled lane run in the reference
from an empty memory, each at the pose, speed and people the program's
campaign reached; every tick's world update of the sampled world lanes is
recomputed from the program's state before it, and their closest approach
to a person from those. Traffic keys: batch,
scenario (portbench/gen/native.py), ticks, control_period,
trace_campaigns, check {lanes, controller_ticks, first_tick_lanes,
world_lanes}: the controller's first tick is judged alone on
`first_tick_lanes` further lanes.
"""

import contextlib
import time

import numpy as np

from portbench import check, harness, trace
from portbench.gen import native


class Driver:
    SPAN = "campaign"
    LABELS = ("launch", "results to host")

    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.batch = t["batch"]
        self.ticks = t["ticks"]

    def setup(self):
        from nav2_social_mpc_controller_tpu_torch.core.types import scenario_from_numpy
        from nav2_social_mpc_controller_tpu_torch.runtime.simulator import Simulator

        ctx, cfg = self.ctx, self.ctx.cfg
        self.arrays = native.generate(ctx.traffic["scenario"], self.batch, ctx.seed,
                                      ctx.config_doc["people_per_scenario"], cfg.n_agents,
                                      cfg.max_path_points)
        self.scen = scenario_from_numpy(harness.scenario_of(self.arrays), device=ctx.device)
        self.sim = Simulator(cfg, self.ticks, control_period=ctx.traffic["control_period"],
                             device=ctx.device)
        self.campaign()
        harness.sync(ctx.device)
        self.kept = None

    def campaign(self, spans=None):
        with spans("launch") if spans else contextlib.nullcontext():
            res = self.sim.run_batch(self.scen)
        with spans("results to host") if spans else contextlib.nullcontext():
            read = (res.status.cpu().numpy(), res.goal_dist.cpu().numpy(),
                    res.min_people_dist.cpu().numpy())
        return res, read

    def window(self, seconds: float) -> harness.Window:
        win = harness.Window()
        start = time.perf_counter()
        end = start
        while end - start < seconds or not win.tick_seconds:
            t0 = time.perf_counter()
            res, (status, goal_dist, _) = self.campaign()
            end = time.perf_counter()
            win.tick_seconds.append(end - t0)
            win.failed += int((~np.isfinite(goal_dist)).sum()) * self.ticks
            if self.kept is None:
                self.kept = res
        win.seconds = end - start
        win.solves = self.batch * self.ticks * len(win.tick_seconds)
        return win

    def traced(self, r):
        from nav2_social_mpc_controller_tpu_torch import _build

        n = self.ctx.traffic["trace_campaigns"]
        step = self.sim.step.tick

        def segment(s):
            step.reset_host_launches()
            self.sim.reset_host_launches()
            r.fused_iter_before = _build.launch_counts["fused_iter"]
            r.failed = 0
            for _ in range(n):
                with s.span(self.SPAN):
                    res, (_, goal_dist, _) = self.campaign(s.span)
                r.failed += int((~np.isfinite(goal_dist)).sum()) * self.ticks
                if self.kept is None:
                    self.kept = res

        r.session = trace.traced(segment, self.SPAN)
        r.span, r.labels, r.ticks = self.SPAN, self.LABELS, n
        prog, = self.sim._programs.values()
        r.replay = harness.replay_tick(step._last, [stage.graph for stage in prog.stages])
        r.replays = n * self.ticks
        r.host_ops = sum(self.sim.host_launches.values())
        r.fused_iter_calls = _build.launch_counts["fused_iter"] - r.fused_iter_before
        r.solves = self.batch * self.ticks * n
        cfg = self.ctx.cfg
        robot = self.kept.robot_traj.cpu().numpy()
        people = self.kept.people_traj.cpu().numpy()
        r.fused_iter_shape = dict(batch=self.batch, steps=cfg.horizon_steps - 1, nb=cfg.n_blocks,
                                  slots=cfg.n_agents)
        r.in_view = harness.fov_in_view(self.ctx.config_doc, self.arrays,
                                        [robot[:, t] for t in range(self.ticks)],
                                        [people[:, t] for t in range(self.ticks)])

    def jobs(self):
        """Controller jobs for the sampled lanes' first ticks and world jobs
        for every tick of the sampled world lanes, from the campaign the
        window kept."""
        c = self.ctx.traffic["check"]
        rng = self.ctx.rng
        res = self.kept
        robot = res.robot_traj.cpu().numpy().astype(np.float64)
        people = res.people_traj.cpu().numpy().astype(np.float64)
        cmds = res.cmds.cpu().numpy().astype(np.float64)
        status = res.status.cpu().numpy()
        mpd = res.min_people_dist.cpu().numpy()
        speed0 = self.arrays["robot_speed"].astype(np.float64)
        k = min(c["controller_ticks"], self.ticks)
        dt = self.ctx.traffic["control_period"]

        def speeds(lane, n):
            return [speed0[lane]] + [cmds[lane, t] for t in range(n - 1)]

        answers, jobs = [], []
        lanes = check.sample_lanes(rng, self.batch, c["lanes"])
        rest = np.setdiff1d(np.arange(self.batch), lanes)
        firsts = rest[check.sample_lanes(rng, len(rest), c["first_tick_lanes"])]
        for lane, n in [(x, k) for x in lanes] + [(x, 1) for x in firsts]:
            answers.append(("controller", [dict(cmd=tuple(cmds[lane, t]), status=status[lane, t])
                                           for t in range(n)]))
            jobs.append(dict(kind="controller", config=self.ctx.config_doc,
                             lane=native.lanes(self.arrays, lane), poses=list(robot[lane, :n]),
                             speeds=speeds(lane, n), people=list(people[lane, :n])))
        for lane in check.sample_lanes(rng, self.batch, c["world_lanes"]):
            answers.append(("world", dict(robot=robot[lane], people=people[lane],
                                          min_people_dist=mpd[lane])))
            jobs.append(dict(kind="world", config=self.ctx.config_doc,
                             lane=native.lanes(self.arrays, lane), dt=dt,
                             poses=list(robot[lane, :self.ticks]),
                             speeds=speeds(lane, self.ticks),
                             people=list(people[lane, :self.ticks]),
                             cmds=list(cmds[lane])))
        return answers, jobs

    def judge(self, answers, refs):
        numbers = check.CampaignNumbers()
        for (kind, prog), ref in zip(answers, refs):
            if kind == "controller":
                for t, (p, q) in enumerate(zip(prog, ref)):
                    numbers.add_tick(p, q, first=t == 0, alone=len(prog) == 1)
            else:
                numbers.add_world(prog["robot"], prog["people"], ref, prog["min_people_dist"])
        return numbers

    def release(self):
        self.kept = None
        del self.sim, self.scen
