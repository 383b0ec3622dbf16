"""Closed-loop simulator: the framework's replacement for the reference's
Gazebo validation loop (SURVEY.md section 4 — the reference was validated by
driving a simulated Jackal with the controller at 20 Hz).

Each tick: the controller produces a command from the current world state,
the robot integrates it for one control period, and pedestrians advance
under the Social Force Model (reacting to the robot). B closed loops run in
lockstep through the batched step (``make_step_batch``, the kernels on the
card); the per-tick state stays on the device, and the host reads nothing
until the caller does.

This is both a demo and the behavioral test harness: tests assert the robot
makes progress along the plan, respects velocity bounds, and keeps social
distance from pedestrians.
"""

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from nav2_social_mpc_controller_tpu_torch.controller.controller import (
    first_lane,
    make_carry,
    make_step_batch,
)
from nav2_social_mpc_controller_tpu_torch import _build
from nav2_social_mpc_controller_tpu_torch.controller import tick_graph
from nav2_social_mpc_controller_tpu_torch.controller.graph import (
    _LoopCounter,
    _Stage,
    collector_held,
)
from nav2_social_mpc_controller_tpu_torch.core.config import SocialMPCConfig
from nav2_social_mpc_controller_tpu_torch.core.types import (
    AgentsState,
    Scenario,
    resolve_device,
    scenario_from_numpy,
    tree_leaves,
    tree_map,
)
from nav2_social_mpc_controller_tpu_torch.core.validate import validate_batch_windows
from nav2_social_mpc_controller_tpu_torch.models import sfm
from nav2_social_mpc_controller_tpu_torch.models.motion import integrate_step
from nav2_social_mpc_controller_tpu_torch.world.grid import esdf_nearest_obstacle_diff


class SimResult(NamedTuple):
    robot_traj: torch.Tensor  # (B, T+1, 3) robot poses
    people_traj: torch.Tensor  # (B, T+1, N, 6)
    cmds: torch.Tensor  # (B, T, 2) executed [v, w]
    status: torch.Tensor  # (B, T) int32 controller status per tick
    min_people_dist: torch.Tensor  # (B,) closest robot-pedestrian approach (inf: nobody)
    goal_dist: torch.Tensor  # (B,) final distance to the plan's last point


def advance_people(cfg: SocialMPCConfig, people: AgentsState, robot_pose, robot_speed, esdf, dt):
    """One SFM step for the simulated pedestrians (robot as social agent).

    Pedestrians feel all three forces of the controller's own world model —
    desired + social + obstacle (sfm.hpp:205-235, 462-485) — so the
    Gazebo-replacement harness is no more forgiving than the SFM world the
    controller assumes during people projection (models/sfm.py).
    people.state (B, N, 6); robot_pose (B, 3); robot_speed (B, 2)."""
    st = people.state
    valid = people.valid
    pos = st[..., 0:2]
    yaw = st[..., 2]
    lv = st[..., 4]
    vel = torch.stack([lv * torch.cos(yaw), lv * torch.sin(yaw)], dim=-1)
    goal = pos + vel * 10.0  # keep walking their way

    r_vel = torch.stack(
        [robot_speed[:, 0] * torch.cos(robot_pose[:, 2]),
         robot_speed[:, 0] * torch.sin(robot_pose[:, 2])], dim=-1
    )
    all_pos = torch.cat([pos, robot_pose[:, None, 0:2]], dim=1)
    all_vel = torch.cat([vel, r_vel[:, None, :]], dim=1)
    all_valid = torch.cat([valid, torch.ones_like(valid[:, :1])], dim=1)
    social = sfm.pairwise_social_force(all_pos, all_vel, all_valid, sfm.DEFAULT_PARAMS)[:, :-1]

    desired = torch.full_like(yaw, cfg.people_desired_vel)
    f_des, _ = sfm.desired_force(
        pos, vel, goal, valid, cfg.goal_radius, desired, sfm.DEFAULT_PARAMS
    )
    obs_entry, obs_in = esdf_nearest_obstacle_diff(
        esdf.distances, esdf.indexes, esdf.origin, esdf.resolution, pos
    )
    f_obs = sfm.obstacle_force(
        pos, obs_entry, obs_in & esdf.valid[:, None] & valid, cfg.people_radius,
        sfm.DEFAULT_PARAMS,
    )
    pos_n, vel_n, yaw_n, lv_n, av_n, _ = sfm.sfm_update(
        pos, vel, yaw, f_des + social + f_obs, desired, goal, valid, cfg.goal_radius, dt
    )
    new = torch.stack(
        [pos_n[..., 0], pos_n[..., 1], yaw_n, st[..., 3], lv_n, av_n], dim=-1
    )
    return AgentsState(state=torch.where(valid[..., None], new, st))


def advance_world(cfg: SocialMPCConfig, scen: Scenario, cmd_x, cmd_y, cmd_z, dt):
    """What a simulated tick does after the controller's step: the robot
    integrates the command [cmd_x, cmd_y, cmd_z] (each (B,)) for dt and the
    pedestrians advance, reacting to the PRE-tick robot pose and speed.
    Returns (new pose (B, 3), new speed (B, 2) [v, w], the people's new
    state (B, N, 6), the closest robot-pedestrian distance (B,), inf where
    nobody is valid)."""
    pose = scen.robot.pose
    x, y, th = integrate_step(pose[:, 0], pose[:, 1], pose[:, 2], cmd_x, cmd_y, cmd_z, dt)
    new_pose = torch.stack([x, y, th], dim=-1)
    new_speed = torch.stack([cmd_x, cmd_z], dim=-1)
    people = advance_people(cfg, scen.people, pose, scen.robot.speed, scen.esdf, dt)
    pd = torch.sqrt(((people.state[..., 0:2] - new_pose[:, None, 0:2]) ** 2).sum(-1))
    pd = torch.where(people.valid, pd, torch.full_like(pd, float("inf"))).amin(dim=1)
    return new_pose, new_speed, people.state, pd


def _goal_dist(start: Scenario, robot_traj):
    last = (start.path.n.long() - 1).clamp(0, start.path.points.shape[1] - 1)
    goal = torch.gather(start.path.points, 1, last[:, None, None].expand(-1, 1, 2))[:, 0]
    return torch.sqrt(((robot_traj[:, -1, 0:2] - goal) ** 2).sum(-1))


class _SimProgram:
    """A staged campaign of one input signature and run length: the
    controller step's tick for that signature as the parts of a nested
    tick (controller/graph.py: GraphTick.nested, which builds no parent
    graph of the step's own), whose static scenario buffers the world
    updates in place (the ESDF distances, which the step never reads, in a
    buffer of this program), the step's command, the histories (B, T+1, ...) and a device tick
    counter. A simulated tick is the step's tick (head, LM loops, tail),
    then ``handoff`` (the command into ``cmd``, the status into its row at
    the tick counter, the new carry into the step's carry buffers), then
    ``stage``, the world update: advance_world, the tick's rows of the
    histories written through the counter (index_copy_ with a device
    index), and the counter steps on, modulo T so that no extra run writes
    outside them.

    Captured (the card), handoff and stage are CUDA graphs recorded after
    one eager warm-up run, and the campaign is one parent graph
    (controller/tick_graph.py): lm_continue counting T ticks (no done
    check), and a WHILE node whose body holds the step's tick node by node,
    its LM loops nested there, then handoff, stage and lm_continue. It is
    launched once a campaign: the host's launches do not depend on T.
    Uncaptured (the CPU) the same loop runs in Python on lm_continue's
    plain version, on the same buffers."""

    def __init__(self, sim: "Simulator", scen: Scenario):
        self.sim = sim
        like = scen.robot.pose
        b, n_ticks = like.shape[0], sim.n_ticks
        self.carry0 = make_carry(sim.cfg, b, device=like.device, dtype=like.dtype)
        self.step = sim.step.tick.nested(scen, self.carry0)
        buf = self.step.scenario
        self.scen = buf._replace(esdf=buf.esdf._replace(distances=scen.esdf.distances.clone()))
        self.cmd = torch.zeros((3, b), dtype=like.dtype, device=like.device)
        self.tick = torch.zeros((1,), dtype=torch.long, device=like.device)
        self.robot_traj = like.new_zeros((b, n_ticks + 1, 3))
        self.people_traj = like.new_zeros((b, n_ticks + 1) + tuple(scen.people.state.shape[1:]))
        self.cmds = like.new_zeros((b, n_ticks, 2))
        self.status_traj = torch.zeros((b, n_ticks), dtype=torch.int32, device=like.device)
        self.pds = like.new_zeros((b, n_ticks))
        self.counter = _LoopCounter(tick_graph.new_stats(1, like.device))
        self.flag = torch.zeros(1, dtype=torch.int32, device=like.device)
        self.unread = torch.zeros(1, dtype=torch.bool, device=like.device)  # no done check
        self.stages = [_Stage(self.handoff), _Stage(self.stage)]
        self.parent = None
        if sim.captured:
            self._capture()

    def handoff(self, out):
        """The step's outputs (cmd, aux, carry') where the world update and
        the next tick read them."""
        cmd, aux, carry = out
        for dst, src in zip(self.cmd, (cmd.linear_x, cmd.linear_y, cmd.angular_z)):
            dst.copy_(src)
        self.status_traj.index_copy_(1, self.tick, aux.status[:, None].to(torch.int32))
        for dst, src in zip(tree_leaves(self.step.carry), tree_leaves(carry)):
            dst.copy_(src)

    def stage(self):
        sc, t = self.scen, self.tick
        new_pose, new_speed, people_state, pd = advance_world(
            self.sim.cfg, sc, self.cmd[0], self.cmd[1], self.cmd[2], self.sim.control_period)
        self.robot_traj.index_copy_(1, t + 1, new_pose[:, None])
        self.people_traj.index_copy_(1, t + 1, people_state[:, None])
        self.cmds.index_copy_(1, t, new_speed[:, None])
        self.pds.index_copy_(1, t, pd[:, None])
        sc.robot.pose.copy_(new_pose)
        sc.robot.speed.copy_(new_speed)
        sc.people.state.copy_(people_state)
        t.add_(1).remainder_(self.sim.n_ticks)

    def _run_stages(self, run):
        run(self.stages[0], self.step.out)
        run(self.stages[1])

    def _capture(self):
        """One eager warm-up run of handoff and stage on the capture stream
        (their writes are overwritten by every run's set-up), then their
        graphs in a pool of their own, the garbage collector held off
        (controller/graph.py), then the parent graph."""
        counts = dict(_build.launch_counts)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self._run_stages(lambda stage, *args: stage(*args))
        torch.cuda.current_stream().wait_stream(stream)
        pool = torch.cuda.graph_pool_handle()
        with collector_held():
            self._run_stages(lambda stage, *args: stage.capture(args, pool, stream))
        torch.cuda.synchronize()
        _build.launch_counts.update(counts)
        self.counter.runs = [(2, tally) for tally in
                             (self.step.tally, *(stage.tally for stage in self.stages))]
        parent = tick_graph.ParentGraph()
        g = parent.root
        handle = parent.handle(g)
        check = parent.lm_continue(g, None, handle, reset=True, add=0, **self._ticks())
        _, body = parent.conditional(g, check, handle, loop=True)
        node = self.step.add_nodes(parent, body, None)
        node = parent.child(body, node, self.stages[0].graph, "the hand-off")
        node = parent.child(body, node, self.stages[1].graph, "the world update")
        parent.lm_continue(body, node, handle, reset=False, add=1, slot=2, **self._ticks())
        self.parent = parent.instantiate()

    def _ticks(self):
        """lm_continue's arguments as the counter of the campaign's ticks."""
        return dict(done=self.unread, stats=self.counter.stats, out=self.flag, need=1,
                    max_iterations=self.sim.n_ticks, check_done=False)

    def _loop(self):
        """The parent graph's loop over ticks, run from the host on
        lm_continue's plain version (the CPU path)."""
        ticks = self._ticks()
        tick_graph.lm_continue(reset=True, add=0, **ticks)
        while bool(self.flag[0]):
            self.stages[0](self.step.run())
            self.stages[1]()
            tick_graph.lm_continue(reset=False, add=1, slot=2, **ticks)

    def __call__(self, scen: Scenario) -> SimResult:
        counts = self.sim.host_launches
        pairs = list(zip(tree_leaves((self.scen, self.step.carry)),
                         tree_leaves((scen, self.carry0))))
        pairs += [(self.robot_traj[:, 0], scen.robot.pose),
                  (self.people_traj[:, 0], scen.people.state)]
        for dst, src in pairs:
            dst.copy_(src)
        self.tick.zero_()
        counts["input_copies"] += len(pairs) + 1
        self.sim.step.tick.nested(scen, self.carry0)  # the step's last program: this one
        if self.parent is None:
            self._loop()
        else:
            self.parent.launch()
            counts["graph_replays"] += 1
            _build.launch_counts.owe(self.counter)
            _build.launch_counts.owe(self.step.counter)
        robot_traj = self.robot_traj.clone()
        counts["output_clones"] += 6
        return SimResult(
            robot_traj=robot_traj,
            people_traj=self.people_traj.clone(),
            cmds=self.cmds.clone(),
            status=self.status_traj.clone(),
            min_people_dist=self.pds.amin(dim=1),
            goal_dist=_goal_dist(scen, robot_traj),
        )


class Simulator:
    """sim(scenario) -> SimResult: B closed loops for `n_ticks` on a batched
    scenario, or one unbatched scenario run as a batch of one (the result
    then unbatched too). Leaves may be NumPy or tensors; they are put on
    `device` with float dtype `dtype`, and the windows are checked once per
    call; the ticks run the unchecked batched step (``step``, make_step_batch
    with its default capture).

    ``capture`` (the default) stages the whole campaign per input
    signature, ``_SimProgram``: on CUDA one launch of a parent graph that
    loops over the ticks on the device, each tick the step's own nodes (its
    LM loops nested), the hand-off of its outputs and the world update, the
    port's counterpart of the JAX package's jitted ``lax.scan`` over ticks;
    on the CPU the same loop run from Python on the same buffers.
    ``capture=False`` runs the reference loop, ``_reference_run``, that the
    staged one is held to bit for bit. A failed capture, build or launch
    raises; nothing retries eagerly. ``host_launches`` counts what a staged
    campaign launches from the host: graph launches (one a campaign on the
    card), input copies (the scenario, the first carry, the histories' first
    rows, the tick counter's reset) and the six result tensors made
    (``output_clones``); none of it depends on the number of ticks, and the
    step's own ``step.tick.host_launches`` do not grow."""

    def __init__(self, cfg: SocialMPCConfig, n_ticks: int, control_period: float = 0.05,
                 device="cuda", dtype=torch.float32, capture: bool = True):
        self.cfg = cfg
        self.n_ticks = n_ticks
        self.control_period = control_period
        self.device = resolve_device(device)
        self.dtype = dtype
        self.staged = capture
        self.captured = capture and self.device.type == "cuda"
        self.step = make_step_batch(cfg, device=self.device, dtype=dtype, validate=False)
        self._programs = {}
        self.host_launches = {}
        self.reset_host_launches()

    def reset_host_launches(self):
        self.host_launches.update(graph_replays=0, input_copies=0, output_clones=0)

    def __call__(self, scenario: Scenario) -> SimResult:
        if np.ndim(scenario.robot.pose) == 1:
            return first_lane(self.run_batch(
                scenario_from_numpy(scenario, device=self.device, dtype=self.dtype)))
        return self.run_batch(scenario)

    def run_batch(self, scenario: Scenario) -> SimResult:
        if np.ndim(scenario.robot.pose) != 2:
            raise ValueError("simulate takes a batched scenario; make_simulate also takes one")
        scen = scenario_from_numpy(scenario, device=self.device, dtype=self.dtype)
        validate_batch_windows(self.cfg, scen)
        on_device = (torch.cuda.device(self.device) if self.captured
                     else contextlib.nullcontext())
        with torch.no_grad(), on_device:
            if not self.staged:
                return self._reference_run(scen)
            # strides too, as the step keys its programs: each campaign
            # program's step program is then the one GraphTick.nested finds
            key = tuple((tuple(x.shape), x.stride(), x.dtype) for x in tree_leaves(scen))
            prog = self._programs.get(key)
            if prog is None:
                prog = self._programs[key] = _SimProgram(self, scen)
            return prog(scen)

    def _reference_run(self, scen: Scenario) -> SimResult:
        """The reference loop: every tick's world update launched from
        Python, the histories stacked at the end."""
        start = scen
        ctrl_carry = make_carry(self.cfg, scen.robot.pose.shape[0], device=self.device,
                                dtype=self.dtype)
        poses, people_t, cmds, status, pds = [], [], [], [], []
        for _ in range(self.n_ticks):
            cmd, aux, ctrl_carry = self.step(scen, ctrl_carry)
            new_pose, new_speed, people_state, pd = advance_world(
                self.cfg, scen, cmd.linear_x, cmd.linear_y, cmd.angular_z, self.control_period)
            scen = scen._replace(robot=scen.robot._replace(pose=new_pose, speed=new_speed),
                                 people=AgentsState(state=people_state))
            poses.append(new_pose)
            people_t.append(people_state)
            cmds.append(new_speed)
            status.append(aux.status)
            pds.append(pd)

        robot_traj = torch.stack([start.robot.pose] + poses, dim=1)
        return SimResult(
            robot_traj=robot_traj,
            people_traj=torch.stack([start.people.state] + people_t, dim=1),
            cmds=torch.stack(cmds, dim=1),
            status=torch.stack(status, dim=1),
            min_people_dist=torch.stack(pds, dim=1).amin(dim=1),
            goal_dist=_goal_dist(start, robot_traj),
        )


def simulate(cfg: SocialMPCConfig, scenario: Scenario, n_ticks: int,
             control_period: float = 0.05, device="cuda", dtype=torch.float32,
             capture: bool = True) -> SimResult:
    """Run B closed loops for n_ticks on a BATCHED scenario (NumPy or tensor
    leaves; put on `device` with float dtype `dtype`): one run of a
    Simulator (see there for `capture`)."""
    return Simulator(cfg, n_ticks, control_period, device, dtype, capture).run_batch(scenario)


def make_simulate(cfg: SocialMPCConfig, n_ticks: int, control_period: float = 0.05,
                  device="cuda", dtype=torch.float32, capture: bool = True) -> Simulator:
    """sim(scenario) -> SimResult for a batched scenario, or for one
    unbatched scenario run as a batch of one: a Simulator, whose step and
    staged programs serve every call."""
    return Simulator(cfg, n_ticks, control_period, device, dtype, capture)
