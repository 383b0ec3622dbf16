"""Entry point make_step_batch (controller/controller.py), the one-launch
tick, driven as a fleet: B robots a tick, back to back, closed loop.

Tick t puts every robot at its plan point stride * (t mod E) and hands the
port the batch with the carry the last tick returned, a fresh make_carry
every E ticks (a new episode); a tick ends when its commands are on the
host. Traffic keys: batch, scenario (portbench/gen/native.py), episode_ticks,
plan_stride, trace_ticks, check {lanes, episodes_within, first_tick_lanes}.

The check takes the sampled episode whole on `lanes` lanes, and its first
tick alone on `first_tick_lanes` other lanes.
"""

import contextlib
import time

import numpy as np
import torch

from portbench import check, harness, trace
from portbench.gen import native


class Driver:
    SPAN = "tick"
    LABELS = ("step", "commands to host")

    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.batch = t["batch"]
        self.episode = t["episode_ticks"]
        self.stride = t["plan_stride"]

    def setup(self):
        """Inputs on the card, the step, and one warm-up episode: the
        capture of the tick's one signature and every pose it takes."""
        from nav2_social_mpc_controller_tpu_torch.controller.controller import (
            make_carry, make_step_batch)
        from nav2_social_mpc_controller_tpu_torch.core.types import scenario_from_numpy

        ctx, cfg = self.ctx, self.ctx.cfg
        self.arrays = native.generate(ctx.traffic["scenario"], self.batch, ctx.seed,
                                      ctx.config_doc["people_per_scenario"], cfg.n_agents,
                                      cfg.max_path_points)
        base = scenario_from_numpy(harness.scenario_of(self.arrays), device=ctx.device)
        self.poses = harness.plan_poses(self.arrays, self.episode, self.stride)
        self.scens = [base._replace(robot=base.robot._replace(
            pose=torch.as_tensor(p, device=ctx.device))) for p in self.poses]
        self.step = make_step_batch(cfg, device=ctx.device)
        self.carry0 = make_carry(cfg, self.batch, device=ctx.device)
        self.carry = self.carry0
        self.t = 0
        for _ in range(self.episode):
            self.tick()
        harness.sync(ctx.device)
        self.t = 0
        rng = ctx.rng
        c = ctx.traffic["check"]
        self.check_lanes = check.sample_lanes(rng, self.batch, c["lanes"])
        self.check_episode = int(rng.integers(0, c["episodes_within"]))
        rest = np.setdiff1d(np.arange(self.batch), self.check_lanes)
        self.first_lanes = rest[check.sample_lanes(rng, len(rest), c["first_tick_lanes"])]
        self.kept = []

    def tick(self, spans=None):
        k = self.t % self.episode
        carry = self.carry0 if k == 0 else self.carry
        with spans("step") if spans else contextlib.nullcontext():
            cmd, aux, self.carry = self.step(self.scens[k], carry)
        with spans("commands to host") if spans else contextlib.nullcontext():
            v = cmd.linear_x.cpu().numpy()
            w = cmd.angular_z.cpu().numpy()
        self.t += 1
        return v, w, aux

    def _keep(self, ep, v, w, aux):
        if ep == self.check_episode:
            self.kept.append((v, w, aux))

    def window(self, seconds: float) -> harness.Window:
        win = harness.Window()
        start = time.perf_counter()
        end = start
        while True:
            ep = self.t // self.episode
            if end - start >= seconds and ep > self.check_episode:
                break
            t0 = time.perf_counter()
            v, w, aux = self.tick()
            end = time.perf_counter()
            win.tick_seconds.append(end - t0)
            win.failed += int((~(np.isfinite(v) & np.isfinite(w))).sum())
            self._keep(ep, v, w, aux)
        win.seconds = end - start
        win.solves = self.batch * len(win.tick_seconds)
        return win

    def traced(self, r):
        """The traced segment: trace_ticks ticks from an episode's start
        under the profiler; fills the readings `r`."""
        from nav2_social_mpc_controller_tpu_torch import _build

        ticks = self.ctx.traffic["trace_ticks"]
        self.check_episode = min(self.check_episode, ticks // self.episode - 1)
        first = [True]

        def segment(s):
            self.t = 0
            self.step.tick.reset_host_launches()
            r.fused_iter_before = _build.launch_counts["fused_iter"]
            r.iterations, r.failed = [], 0
            for _ in range(ticks):
                ep = self.t // self.episode
                with s.span(self.SPAN):
                    v, w, aux = self.tick(s.span)
                r.iterations.append(aux.solve.iterations)
                r.failed += int((~(np.isfinite(v) & np.isfinite(w))).sum())
                if first[0]:
                    self._keep(ep, v, w, aux)
            first[0] = False

        r.session = trace.traced(segment, self.SPAN)
        r.span, r.labels, r.ticks = self.SPAN, self.LABELS, ticks
        r.replay, r.replays = harness.replay_tick(self.step.tick._last), ticks
        r.host_ops = sum(self.step.tick.host_launches.values())
        r.fused_iter_calls = _build.launch_counts["fused_iter"] - r.fused_iter_before
        r.iterations = [x.cpu().numpy() for x in r.iterations]
        r.solves = self.batch * ticks
        cfg = self.ctx.cfg
        views = harness.fov_in_view(self.ctx.config_doc, self.arrays, self.poses)
        per_tick = [views[k % self.episode] for k in range(ticks)]
        r.fused_iter_shape = dict(batch=self.batch, steps=cfg.horizon_steps - 1, nb=cfg.n_blocks,
                                  slots=cfg.n_agents)
        r.in_view = per_tick

    def jobs(self):
        """(the program's answers, the reference's jobs): the sampled lanes
        over the sampled episode, and the first-tick lanes over its first
        tick."""
        answers, jobs = [], []
        for lanes, kept in ((self.check_lanes, self.kept), (self.first_lanes, self.kept[:1])):
            prog = [harness.tick_answers(v, w, aux, lanes) for v, w, aux in kept]
            for i, lane in enumerate(lanes):
                answers.append([tick[i] for tick in prog])
                jobs.append(dict(kind="controller", config=self.ctx.config_doc,
                                 lane=native.lanes(self.arrays, lane),
                                 poses=[p[lane] for p in self.poses[:len(prog)]],
                                 judge=check.judged(answers[-1][0])))
        return answers, jobs

    def judge(self, answers, refs):
        numbers = check.TickNumbers()
        for prog, ref in zip(answers, refs):
            for t, (p, q) in enumerate(zip(prog, ref)):
                numbers.add(p, q, first=t == 0, alone=len(prog) == 1)
        return numbers

    def release(self):
        self.kept = []
        del self.step, self.scens, self.carry, self.carry0


