"""The CLI's batched-throughput loop (``bench``): n ticks of make_step_batch
on one scenario batch, the carry fed back and the robot's pose moved by
1e-6 * i at tick i, the last tick's command returned.

Counterpart of the JAX package's ``cmd_bench`` (its ``__main__.py``), which
scans its n ticks in one jitted ``lax.scan``. On the card the n ticks are
one launch too (``_BenchProgram``), as runtime/simulator.py runs a
campaign: a parent graph (controller/tick_graph.py) whose WHILE node runs,
each time round, the pose stage (the pose of tick i from a device tick
counter), the step's own nodes (controller/graph.py: GraphTick.nested,
its LM loops nested) and the hand-off (the command kept, the new carry into
the step's carry buffers), then ``lm_continue``, which counts the ticks.
The host copies the inputs in, launches once and clones the result; what it
launches does not depend on n.

The number of ticks is not part of the graph: the host writes the loop's
start count as -n into the counter's iteration slot, and lm_continue goes on
while the count stays below 0 (max_iterations 0). One program per input
signature thus serves every n, the warm run of the CLI too.

On the CPU the same program runs its stages from Python on lm_continue's
plain version; ``host_loop``, the reference it is held to bit for bit, is
what the CLI runs there.
"""

import contextlib

import torch

from nav2_social_mpc_controller_tpu_torch import _build
from nav2_social_mpc_controller_tpu_torch.controller import tick_graph
from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry, make_step_batch
from nav2_social_mpc_controller_tpu_torch.controller.graph import (
    _LoopCounter,
    _read_leaves,
    _Stage,
    collector_held,
)
from nav2_social_mpc_controller_tpu_torch.core.types import (
    ControlCommand,
    Scenario,
    resolve_device,
    tree_leaves,
)

POSE_STEP = 1e-6  # the pose of tick i is the start pose + POSE_STEP * i


def moved_pose(pose, i):
    """The robot's pose at bench tick i (an int, or a (1,) int64 device
    tensor): pose + POSE_STEP * i, the offset formed in float64 and rounded
    to the pose's dtype before the add, as `pose + POSE_STEP * i` with a
    Python int does."""
    if isinstance(i, int):
        return pose + POSE_STEP * i
    return pose + (i.to(torch.float64) * POSE_STEP).to(pose.dtype)


class _BenchProgram:
    """The staged bench loop of one input signature: the step's program for
    that signature as the parts of a nested tick, whose static scenario and
    carry buffers the stages write in place, the start pose, a device tick
    counter and the last command. A tick is ``pose`` (the step's
    pose buffer = start pose moved to the counter's tick; the counter steps
    on), the step's tick, then ``handoff``. Captured, pose and handoff are
    CUDA graphs recorded after one eager warm-up run, and the loop is one
    parent graph, launched once a call whatever its n."""

    def __init__(self, bench: "BenchLoop", scen: Scenario):
        self.bench = bench
        like = scen.robot.pose
        self.carry0 = make_carry(bench.cfg, like.shape[0], device=like.device, dtype=like.dtype)
        self.step = bench.step.tick.nested(scen, self.carry0)
        self.pose0 = scen.robot.pose.clone()
        self.tick = torch.zeros((1,), dtype=torch.long, device=like.device)
        self.cmd = like.new_zeros((3, like.shape[0]))
        self.counter = _LoopCounter(tick_graph.new_stats(1, like.device))
        self.flag = torch.zeros(1, dtype=torch.int32, device=like.device)
        self.unread = torch.zeros(1, dtype=torch.bool, device=like.device)  # no done check
        self.stages = [_Stage(self.pose), _Stage(self.handoff)]
        self.parent = None
        if bench.captured:
            self._capture()

    def pose(self):
        self.step.scenario.robot.pose.copy_(moved_pose(self.pose0, self.tick))
        self.tick.add_(1)

    def handoff(self, out):
        """The step's outputs (cmd, aux, carry') where the result and the
        next tick read them."""
        cmd, _, carry = out
        for dst, src in zip(self.cmd, cmd):
            dst.copy_(src)
        for dst, src in zip(tree_leaves(self.step.carry), tree_leaves(carry)):
            dst.copy_(src)

    def _ticks(self):
        """lm_continue's arguments as the counter of the loop's ticks: the
        count starts at -n (written by the host) and the loop goes on while
        it + 1 <= 0."""
        return dict(done=self.unread, stats=self.counter.stats, out=self.flag, need=1,
                    max_iterations=0, check_done=False)

    def _capture(self):
        """One eager warm-up run of the pose stage and the hand-off on the
        capture stream (every call's set-up rewrites what they write), their
        graphs in a pool of their own with the garbage collector held off
        (controller/graph.py), then the parent graph."""
        counts = dict(_build.launch_counts)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self.stages[0]()
            self.stages[1](self.step.out)
        torch.cuda.current_stream().wait_stream(stream)
        pool = torch.cuda.graph_pool_handle()
        with collector_held():
            self.stages[0].capture((), pool, stream)
            self.stages[1].capture((self.step.out,), pool, stream)
        torch.cuda.synchronize()
        _build.launch_counts.update(counts)
        self.counter.runs = [(2, tally) for tally in
                             (self.step.tally, *(stage.tally for stage in self.stages))]
        parent = tick_graph.ParentGraph()
        g = parent.root
        handle = parent.handle(g)
        check = parent.lm_continue(g, None, handle, reset=False, add=0, **self._ticks())
        _, body = parent.conditional(g, check, handle, loop=True)
        node = parent.child(body, None, self.stages[0].graph, "the bench tick's pose")
        node = self.step.add_nodes(parent, body, node)
        node = parent.child(body, node, self.stages[1].graph, "the hand-off")
        parent.lm_continue(body, node, handle, reset=False, add=1, slot=2, **self._ticks())
        self.parent = parent.instantiate()

    def _loop(self):
        """The parent graph's loop, run from the host on lm_continue's plain
        version (the CPU)."""
        ticks = self._ticks()
        tick_graph.lm_continue(reset=False, add=0, **ticks)
        while bool(self.flag[0]):
            self.stages[0]()
            self.stages[1](self.step.run())
            tick_graph.lm_continue(reset=False, add=1, slot=2, **ticks)

    def __call__(self, scen: Scenario, n: int):
        counts = self.bench.host_launches
        pairs = list(zip(tree_leaves((self.step.scenario, self.step.carry)),
                         tree_leaves((_read_leaves(scen), self.carry0))))
        pairs.append((self.pose0, scen.robot.pose))
        for dst, src in pairs:
            dst.copy_(src)
        self.tick.zero_()
        self.counter.stats[0].fill_(-n)
        counts["input_copies"] += len(pairs) + 2
        self.bench.step.tick.nested(scen, self.carry0)  # the step's last program: this one
        if self.parent is None:
            self._loop()
        else:
            self.parent.launch()
            counts["graph_replays"] += 1
            _build.launch_counts.owe(self.counter)
            _build.launch_counts.owe(self.step.counter)
        counts["output_clones"] += 3
        return ControlCommand(*self.cmd.clone())


class BenchLoop:
    """bench(scenario, n) -> the ControlCommand (linear_x, linear_y, angular_z,
    each (B,)) of the last of n ticks of make_step_batch(cfg) on a batched
    scenario on `device`, the carry fed back from make_carry's and the pose
    of tick i moved by POSE_STEP * i.

    A call runs the n ticks as a program per input signature
    (``_BenchProgram``): one graph launch on the card, its stages from Python
    on the CPU; ``host_loop`` is the reference, one step call a tick.
    ``host_launches`` counts what a call launches from the host:
    graph launches, input copies (the scenario's leaves the step reads, the
    first carry, the start pose, the tick counter's and the loop count's
    reset) and the result's three clones; ``step.tick.host_launches`` do not
    grow."""

    def __init__(self, cfg, device="cuda", dtype=torch.float32):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        self.captured = self.device.type == "cuda"
        self.step = make_step_batch(cfg, device=self.device, dtype=dtype)
        self._programs = {}
        self.host_launches = {}
        self.reset_host_launches()

    def reset_host_launches(self):
        self.host_launches.update(graph_replays=0, input_copies=0, output_clones=0)

    def host_loop(self, scen: Scenario, n: int):
        """The n ticks launched from Python, one step call a tick."""
        carry = make_carry(self.cfg, scen.robot.pose.shape[0], device=self.device,
                           dtype=self.dtype)
        cmd = None
        for i in range(n):
            sc = scen._replace(robot=scen.robot._replace(pose=moved_pose(scen.robot.pose, i)))
            cmd, _, carry = self.step(sc, carry)
        return cmd

    def __call__(self, scen: Scenario, n: int):
        if n < 1:
            raise ValueError(f"bench: at least one tick, got {n}")
        on_device = (torch.cuda.device(self.device) if self.captured
                     else contextlib.nullcontext())
        with torch.no_grad(), on_device:
            key = tuple((tuple(x.shape), x.stride(), x.dtype) for x in tree_leaves(scen))
            prog = self._programs.get(key)
            if prog is None:
                prog = self._programs[key] = _BenchProgram(self, scen)
            return prog(scen, n)
