"""Entry point SocialMPCController.compute_velocity_commands
(controller/controller.py), as the ROS plugin calls it: one robot, one
tick at a time, back to back.

A pool of P scenarios is generated from the seed; episode e drives the
robot along scenario e mod P: cleanup() and set_plan() at its start (a
robot given a new task), then E ticks, tick k at plan point stride * k,
each handed that scenario's NumPy inputs (plan, pose, speed, people,
costmap, ESDF), which the controller copies to the card; a tick ends when
its command is on the host. Traffic keys: scenarios, scenario
(portbench/gen/native.py), episode_ticks, plan_stride, trace_ticks, check
{episodes, episodes_within, first_tick_episodes}.

The check takes `episodes` sampled episodes whole, and the first tick
alone of `first_tick_episodes` others, all within the first
`episodes_within`.
"""

import contextlib
import time

import numpy as np

from portbench import check, harness, trace
from portbench.gen import native


class Driver:
    SPAN = "tick"
    LABELS = ("step", "command to host")

    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.pool = t["scenarios"]
        self.episode = t["episode_ticks"]
        self.stride = t["plan_stride"]

    def setup(self):
        from nav2_social_mpc_controller_tpu_torch.controller.controller import (
            SocialMPCController)

        ctx, cfg = self.ctx, self.ctx.cfg
        self.arrays = native.generate(ctx.traffic["scenario"], self.pool, ctx.seed,
                                      ctx.config_doc["people_per_scenario"], cfg.n_agents,
                                      cfg.max_path_points)
        self.poses = harness.plan_poses(self.arrays, self.episode, self.stride)
        self.scens = [harness.scenario_of(self.arrays, lane) for lane in range(self.pool)]
        self.ctrl = SocialMPCController(cfg, device=ctx.device)
        self.ctrl.activate()
        self.t = 0
        for _ in range(self.episode):
            self.tick()
        harness.sync(ctx.device)
        self.t = 0
        c = ctx.traffic["check"]
        drawn = [int(e) for e in ctx.rng.choice(
            c["episodes_within"], size=c["episodes"] + c["first_tick_episodes"], replace=False)]
        self.check_episodes = set(drawn[:c["episodes"]])
        self.first_episodes = set(drawn[c["episodes"]:])
        self.kept = {}

    def tick(self, spans=None):
        e, k = divmod(self.t, self.episode)
        lane = e % self.pool
        sc = self.scens[lane]
        with spans("step") if spans else contextlib.nullcontext():
            if k == 0:
                self.ctrl.cleanup()
                self.ctrl.set_plan(sc.path)
            pose = self.poses[k][lane]
            cmd, aux = self.ctrl.compute_velocity_commands(
                sc._replace(robot=sc.robot._replace(pose=pose)))
        with spans("command to host") if spans else contextlib.nullcontext():
            v, w = float(cmd.linear_x), float(cmd.angular_z)
        self.t += 1
        return e, v, w, aux

    def _keep(self, e, v, w, aux):
        if e in self.check_episodes or (e in self.first_episodes and e not in self.kept):
            self.kept.setdefault(e, []).append((v, w, aux))

    def window(self, seconds: float) -> harness.Window:
        win = harness.Window()
        last = max(self.check_episodes | self.first_episodes)
        start = time.perf_counter()
        end = start
        while not (end - start >= seconds and self.t // self.episode > last):
            t0 = time.perf_counter()
            e, v, w, aux = self.tick()
            end = time.perf_counter()
            win.tick_seconds.append(end - t0)
            win.failed += int(not (np.isfinite(v) and np.isfinite(w)))
            self._keep(e, v, w, aux)
        win.seconds = end - start
        win.solves = len(win.tick_seconds)
        return win

    def traced(self, r):
        ticks = self.ctx.traffic["trace_ticks"]
        episodes = ticks // self.episode
        self.check_episodes = {e % episodes for e in self.check_episodes}
        self.first_episodes = {e % episodes for e in self.first_episodes} - self.check_episodes
        tick_prog = self.ctrl._step.tick
        first = [True]

        def segment(s):
            self.t = 0
            tick_prog.reset_host_launches()
            r.failed = 0
            for _ in range(ticks):
                with s.span(self.SPAN):
                    e, v, w, aux = self.tick(s.span)
                r.failed += int(not (np.isfinite(v) and np.isfinite(w)))
                if first[0]:
                    self._keep(e, v, w, aux)
            first[0] = False

        r.session = trace.traced(segment, self.SPAN)
        r.span, r.labels, r.ticks = self.SPAN, self.LABELS, ticks
        r.replay, r.replays = harness.replay_tick(tick_prog._last), ticks
        r.host_ops = sum(tick_prog.host_launches.values())
        r.solves = ticks

    def jobs(self):
        answers, jobs = [], []
        for e in sorted(self.kept):
            lane = e % self.pool
            answers.append([harness.tick_answers(v, w, aux)[0] for v, w, aux in self.kept[e]])
            jobs.append(dict(kind="controller", config=self.ctx.config_doc,
                             lane=native.lanes(self.arrays, lane),
                             poses=[p[lane] for p in self.poses[:len(self.kept[e])]],
                             judge=check.judged(answers[-1][0])))
        return answers, jobs

    def judge(self, answers, refs):
        numbers = check.TickNumbers()
        for prog, ref in zip(answers, refs):
            for t, (p, q) in enumerate(zip(prog, ref)):
                numbers.add(p, q, first=t == 0, alone=len(prog) == 1)
        return numbers

    def release(self):
        self.kept = {}
        del self.ctrl
