"""The compiled tick: ``make_step_batch``'s tick as one CUDA graph launch.

Counterpart of the JAX package's ``jax.jit(jax.vmap(step))``
(``controller/controller.py: make_step_batch``) and of its LM
``lax.while_loop`` on the device (``solver/lm.py``). Eagerly, a tick is some
3,000 launches from Python; here it is recorded once per input signature, in
stages, and the stages are put into one parent graph
(``controller/tick_graph.py``, ``csrc/tick_graph.cu``) that a tick launches
once:

  head    ``step_pre`` (plan windowing, trajectorize, FOV filter, problem
          assembly with the SFM projection, K5), the evaluation's per-tick
          set-up (``build_value_grad``) and the LM state at u0 (the first
          evaluation: rollout_sample, K2, and with latent critics their
          term, ops/latent.py);
  loops   for each chunk length n (``check_every``, then the remainder of
          ``max_iterations`` if any; with ``check_every = 0`` one chunk of
          every iteration), a conditional WHILE node whose body is a chunk
          of n default LM iterations (K3 -> rollout_sample -> K2 -> K4
          each) from the head's LM state, written back into it in place,
          then ``lm_continue``, which counts the iterations on the device and
          goes on while a lane is active and the cap allows another chunk:
          the eager loop's checks (``solver/lm.py: lm_solve``), so the
          iteration counts, and the bits, are the eager loop's. With
          debug_optimizer (the counterpart of the JAX package's traced
          ``lax.while_loop``) a chunk runs the general iteration (K7's
          damped step -> rollout_sample -> K2 -> ``commit_with_aux``) and
          writes each lane's trace column at the lane's own iteration count
          (``lm.record_trace_by_lane``), so one body serves every column;
  tail    the solve statistics and ``step_post`` (extraction, degradation
          ladder, carry, the trace).

Between the input copies and the output clones the host reads nothing of
the device. ``controller/graph_compacted.py`` stages
make_step_batch_compacted's tick on the same head and tail, with chunks at
each width of its ladder and the transitions between them, in one parent
graph whose schedule ``compact_continue`` decides on the device;
runtime/simulator.py nests this module's tick in its loop over ticks.

The stages read static tensors: the scenario and carry leaves the tick reads
are copied into buffers of the program (``copy_``, never rebound, since the
kernels take raw pointers), and the head's outputs stay referenced for the
graphs' lifetime. The graphs share one memory pool and run in the order
they were captured (head, chunks, tail). A program is captured at the first
call with a new signature (every leaf's shape, stride and dtype: B and N
people among them), after one eager warm-up tick on the capture stream, so
that capture is the first use of nothing, and with Python's garbage
collector held off (``collector_held``). Outputs are cloned out of the
graphs' tensors: no two calls return tensors that alias each other or the
program's buffers.

Launch counts: a graph calls no kernel wrapper, so each stage keeps the
``_build.launch_counts`` tally its capture made; a launch of the parent
graph adds the head's and the tail's, and the chunks' times their bodies'
runs, with lm_continue's launches, are read from the device counter when
the counts are read (``_build.LaunchCounts``), never inside the tick. The
warm-up tick and the capture add nothing. The counters thus go on meaning
"kernels the ticks ran". ``host_launches`` counts what the host does
instead: graph launches, input copies and output clones.

On the CPU (no graphs) the same stages run as plain functions on the same
static buffers, the loops in Python on lm_continue's plain version, with
the same copy-back and the same clones. A failed capture, build,
instantiation or launch raises; nothing falls back to host checks or to the
eager tick.
"""

import contextlib
import gc
import time
from typing import NamedTuple, Optional

import torch

from nav2_social_mpc_controller_tpu_torch import _build
from nav2_social_mpc_controller_tpu_torch.controller.controller import (
    StepContext,
    step_post,
    step_pre,
)
from nav2_social_mpc_controller_tpu_torch.controller import tick_graph
from nav2_social_mpc_controller_tpu_torch.controller.optimize import (
    build_value_grad,
    make_lm_config,
)
from nav2_social_mpc_controller_tpu_torch.core.types import (
    ControllerCarry,
    Scenario,
    tree_leaves,
    tree_map,
)
from nav2_social_mpc_controller_tpu_torch.ops import fused_iter
from nav2_social_mpc_controller_tpu_torch.solver import lm
from nav2_social_mpc_controller_tpu_torch.solver.batched import Level


class TickHead(NamedTuple):
    """What the head stage leaves for the chunks and the tail."""

    ctx: StepContext
    value_grad: fused_iter.ValueGrad  # or its subclass latent.LatentValueGrad
    state: lm.LMState  # updated in place by the chunks
    initial_cost: torch.Tensor
    trace: Optional[lm.LMTrace] = None  # zeroed by the head, written by the chunks


def tick_head(cfg, lm_cfg, scenario: Scenario, carry: ControllerCarry,
              trace_len: int = 0) -> TickHead:
    """step_pre, the evaluation's set-up, the LM state at u0 and, with
    trace_len > 0, a zeroed (B, trace_len) trace. The state's u and cost get
    tensors of their own: the chunks write into them, while prep.u0 and the
    initial cost must keep their values."""
    ctx = step_pre(cfg, scenario, carry)
    value_grad = build_value_grad(cfg, ctx.prep)
    st = lm.initial_state(value_grad, ctx.prep.u0, lm_cfg)
    state = st._replace(u=st.u.clone(), cost=st.cost.clone())
    trace = lm.new_trace(ctx.prep.u0, trace_len) if trace_len > 0 else None
    return TickHead(ctx, value_grad, state, st.cost, trace)


def full_width(head: TickHead) -> Level:
    """The head's LM state and problem as the ladder's first rung."""
    prep = head.ctx.prep
    return Level(head.state, prep.lower, prep.upper, head.value_grad, None)


def lm_chunk(lm_cfg, level: Level, n: int, trace: Optional[lm.LMTrace] = None) -> None:
    """n LM iterations from level.state, written back into its tensors in
    place: the default iteration, or with `trace` the general one (K7's
    damped step, commit_with_aux) writing each lane's trace column at its
    own iteration count (lm.record_trace_by_lane)."""
    st = level.state
    for _ in range(n):
        if trace is None:
            st = lm.lm_iteration(level.value_grad, level.lower, level.upper, lm_cfg, st)
            continue
        st_new, aux = lm.lm_iteration_general(
            level.value_grad, level.lower, level.upper, lm_cfg, lm.default_linear_solve, None, st)
        lm.record_trace_by_lane(trace, st, aux)
        st = st_new
    for dst, src in zip(level.state, st):
        dst.copy_(src)


def tick_tail(cfg, head: TickHead, carry: ControllerCarry):
    """The solve statistics and step_post: (cmd, aux, carry')."""
    stats = lm.solve_stats(head.state, head.initial_cost)
    return step_post(cfg, head.ctx, carry, head.state.u, stats, head.trace)


def signature(scenario: Scenario, carry: ControllerCarry):
    """What a program is captured for: every leaf's shape, stride, dtype and
    device."""
    return tuple((tuple(x.shape), x.stride(), x.dtype, x.device)
                 for x in tree_leaves((scenario, carry)))


@contextlib.contextmanager
def collector_held():
    """Python's cyclic garbage collector run once, then held off while CUDA
    graphs are captured: a dead program (a tick and its stages refer to each
    other, so only the collector frees them) destroyed mid-capture would
    free its graphs and their pool, which invalidates the capture
    (cudaErrorStreamCaptureInvalidated)."""
    enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class _Stage:
    """fn(*args), uncaptured called every time, or captured once as a CUDA
    graph that is a child of a parent graph (keep_graph: its cudaGraph_t is
    kept for the parent to clone, and the stage is never reset: its pool
    holds the memory the clone uses)."""

    def __init__(self, fn):
        self.fn = fn
        self.graph = None
        self.out = None
        self.tally = {}

    def capture(self, args, pool, stream):
        """Record fn(*args) and return its outputs; the launch counts its
        wrappers added are the tally of a run (the caller takes them
        back: capture runs nothing)."""
        before = dict(_build.launch_counts)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            self.out = self.fn(*args)
        self.tally = {k: n - before[k] for k, n in _build.launch_counts.items() if n != before[k]}
        self.graph = graph
        return self.out

    def count(self) -> None:
        """Add the tally of a run to the launch counts."""
        for k, n in self.tally.items():
            _build.launch_counts.add(k, n)

    def __call__(self, *args):
        if self.graph is not None:
            raise RuntimeError("a captured stage runs only as a node of its parent graph")
        return self.fn(*args)


class _Program:
    """The staged tick of one input signature: static input buffers, the
    head and tail stages, and the solve's stages, which a subclass gives
    (``_stages``: every stage once, in capture order; ``_solve``: the
    solve's loops run from the host on the conditions' plain versions;
    ``_parent``: the parent graph of the captured stages; ``counter``, a
    _LoopCounter of its loops; ``slots``, (slot of the counter's stats,
    stage) for each stage run in a loop, whose runs the device counts
    there; ``width_log``). A program nested in a caller's parent graph
    (``standalone`` false: GraphTick.nested) builds its own parent graph
    only if one of its ticks is launched alone."""

    def __init__(self, tick: "GraphTick", scenario: Scenario, carry: ControllerCarry,
                 standalone: bool = True):
        cfg, lm_cfg = tick.cfg, tick.lm_cfg
        self.tick = tick
        self.scenario = tree_map(torch.clone, _read_leaves(scenario))
        self.carry = tree_map(torch.clone, carry)
        self.batch = self.scenario.robot.pose.shape[0]
        self.head = _Stage(lambda: tick_head(cfg, lm_cfg, self.scenario, self.carry,
                                             tick.trace_len))
        self.tail = _Stage(lambda h: tick_tail(cfg, h, self.carry))
        self._build()
        self.parent = None
        self.capture_seconds = None
        if tick.captured:
            t0 = time.perf_counter()
            self._capture()
            if standalone:
                self.parent = self._parent()
            self.capture_seconds = time.perf_counter() - t0

    def _every_stage(self, run):
        """run(stage, *args) on every stage once, in capture order, each
        stage's arguments being what the stages before it returned."""
        h = run(self.head)
        self._stages(run, h)
        run(self.tail, h)

    def _capture(self):
        """One eager warm-up of every stage on the capture stream (results
        dropped), then the graphs in one pool, in the order a tick runs
        them (a stage's outputs may sit where an earlier graph kept its
        temporaries, which it never reads after that graph runs again);
        the launch counts left as they were."""
        counts = dict(_build.launch_counts)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self._every_stage(lambda stage, *args: stage(*args))
        torch.cuda.current_stream().wait_stream(stream)
        pool = torch.cuda.graph_pool_handle()
        with collector_held():
            self._every_stage(
                lambda stage, *args: stage.capture(args, pool, stream))
        torch.cuda.synchronize()
        _build.launch_counts.update(counts)
        self.counter.runs = [(slot, stage.tally) for slot, stage in self.slots]

    def _run(self):
        """One tick from head to tail: one launch of the parent graph, or,
        uncaptured, the stages and the solve's loops from the host."""
        if not self.tick.captured:
            h = self.head()
            self._solve(h)
            return self.tail(h)
        if self.parent is None:
            self.parent = self._parent()
        self.parent.launch()
        self.tick.host_launches["graph_replays"] += 1
        self.head.count()
        self.tail.count()
        _build.launch_counts.owe(self.counter)
        return self.tail.out

    def __call__(self, scenario: Scenario, carry: ControllerCarry):
        counts = self.tick.host_launches
        for dst, src in zip(tree_leaves((self.scenario, self.carry)),
                            tree_leaves((_read_leaves(scenario), carry))):
            dst.copy_(src)
            counts["input_copies"] += 1
        out = tree_map(torch.clone, self._run())
        counts["output_clones"] += len(tree_leaves(out))
        return out


class _LoopCounter:
    """The device's record of a program's loops (``stats``: see
    controller/tick_graph.py) and what it owes _build.launch_counts: the
    condition kernel's launches (stats[1]) and, for each (slot, tally) of
    ``runs``, a stage's tally times stats[slot], the stage's runs since the
    last drain; ``body_slots`` are the slots of the LM chunks' runs. Apart
    from the program, so that a program that dies with launches owed is
    freed all the same (the counts keep only this)."""

    def __init__(self, stats: torch.Tensor, kernel: str = "lm_continue"):
        self.stats = stats
        self.kernel = kernel
        self.runs = []
        self.body_slots = []
        self.body_runs = 0

    def drain(self) -> dict:
        """The launches counted since the last drain (a read of the device,
        which _build.launch_counts makes when it is read)."""
        stats = self.stats.tolist()
        owed = {self.kernel: stats[1]}
        for slot, tally in self.runs:
            for name, n in tally.items():
                owed[name] = owed.get(name, 0) + n * stats[slot]
        self.body_runs += sum(stats[slot] for slot in self.body_slots)
        drained = sorted({1} | {slot for slot, _ in self.runs} | set(self.body_slots))
        self.stats.index_fill_(0, torch.tensor(drained, device=self.stats.device), 0)
        return owed


class _LoopProgram(_Program):
    """make_step_batch's staged tick: the LM solve as the loops of
    controller/tick_graph.py (a body of check_every iterations, a body of
    the remainder), their chunks at full width; with the trace each chunk
    writes the columns of its lanes' own iteration counts, so one chunk
    serves every position. Captured, the head, the loops and the tail are
    one parent graph, launched once a tick; uncaptured, the loops run in
    Python on lm_continue's plain version."""

    def _build(self):
        tick, lm_cfg = self.tick, self.tick.lm_cfg
        self.lengths = tick_graph.loop_lengths(lm_cfg.max_iterations, tick.check_every)
        self.chunks = [_Stage(lambda h, n=n: lm_chunk(lm_cfg, full_width(h), n, h.trace))
                       for n in self.lengths]
        self.counter = _LoopCounter(tick_graph.new_stats(len(self.lengths), tick.device))
        self.slots = [(2 + k, chunk) for k, chunk in enumerate(self.chunks)]
        self.counter.body_slots = [slot for slot, _ in self.slots]
        self.flag = torch.zeros(1, dtype=torch.int32, device=tick.device)

    def _stages(self, run, h):
        for chunk in self.chunks:
            run(chunk, h)

    def add_nodes(self, parent: tick_graph.ParentGraph, graph, dep):
        """This program's tick into `graph` of `parent` after `dep`: its
        stages, its loops and their lm_continue nodes (tick_graph.add_tick);
        returns the last node. The caller owes the head's and the tail's
        tallies for each run, the counter the loops'."""
        return tick_graph.add_tick(
            parent, graph, dep, self.head.graph, [c.graph for c in self.chunks],
            self.tail.graph, self.lengths, self.head.out.state.done, self.counter.stats,
            self.flag, self.tick.lm_cfg.max_iterations, self.tick.check_every > 0)

    def _parent(self):
        parent = tick_graph.ParentGraph()
        self.add_nodes(parent, parent.root, None)
        return parent.instantiate()

    def _solve(self, h):
        """The parent graph's loops, run from the host: each condition is
        lm_continue's plain version on the same tensors (the CPU path)."""
        max_iterations = self.tick.lm_cfg.max_iterations
        for k, (n, chunk) in enumerate(zip(self.lengths, self.chunks)):
            step = dict(reset=k == 0, add=0, slot=-1)
            while True:
                tick_graph.lm_continue(h.state.done, self.counter.stats, self.flag, need=n,
                                       max_iterations=max_iterations,
                                       check_done=self.tick.check_every > 0, **step)
                if not bool(self.flag[0]):
                    break
                chunk(h)
                step = dict(reset=False, add=n, slot=2 + k)

    def width_log(self):
        """The width of every LM iteration of the last tick (the device's
        count: a read of the device)."""
        return [self.batch] * int(self.counter.stats[0]) if self.lengths else []

    def last_runs(self):
        """How often each loop's body ran in the last tick (from the
        device's iteration count: a loop runs every body that fits, the
        next one the rest)."""
        left, runs = int(self.counter.stats[0]), []
        for n in self.lengths:
            runs.append(left // n)
            left -= runs[-1] * n
        return runs


def _read_leaves(scenario: Scenario) -> Scenario:
    """The scenario without the one leaf the tick never reads: the SFM
    projection takes the ESDF's nearest-obstacle index grid, not its
    distances, which are therefore not copied."""
    return scenario._replace(esdf=scenario.esdf._replace(distances=None))



class NestedTick(NamedTuple):
    """A program's tick as parts of a caller's own loop (GraphTick.nested):
    its static input buffers, which the caller writes in place; on the card
    the tail's outputs, ``add_nodes(parent, graph, dep)`` that puts the tick
    into a parent graph and returns its last node, the loop counter the
    caller owes _build.launch_counts after each launch, and ``tally``, the
    head's and the tail's launches, which the caller owes for each tick;
    on the CPU ``run()``, one tick from the host, returning its outputs."""

    scenario: Scenario
    carry: ControllerCarry
    out: Optional[tuple]
    counter: _LoopCounter
    tally: dict
    add_nodes: object
    run: object


class GraphTick:
    """tick(scenario, carry) -> (cmd, aux, carry'): make_step_batch's tick
    for any config, staged as above; on CUDA one launch of a parent graph
    whose LM solve loops on the device, plain functions on the CPU. The
    scenario and carry must lie on `device`. With debug_optimizer the chunks
    run the general iteration and the tail returns the (B, max_iterations)
    trace; with latent critics the evaluation in every stage is
    ops/latent.py's LatentValueGrad.

    ``check_every`` is lm_solve's: how many LM iterations a loop body holds
    between two of lm_continue's checks (the results do not depend on it).
    ``capture_seconds`` holds each program's warm-up plus capture time, in
    order of capture; ``host_launches`` the host's operations since
    ``reset_host_launches`` (graph launches, input copies, output clones:
    no tick reads the device); ``body_runs`` the runs of the loops' bodies
    in that time and ``width_log`` the width of every LM iteration of the last
    tick, both read from the device when asked."""

    program = _LoopProgram

    def __init__(self, cfg, device, check_every: int = lm.DEFAULT_CHECK_EVERY):
        self.cfg = cfg
        self.lm_cfg = make_lm_config(cfg.optimizer)
        self.trace_len = cfg.optimizer.max_iterations if cfg.optimizer.debug_optimizer else 0
        self.device = torch.device(device)
        self.captured = self.device.type == "cuda"
        self.check_every = check_every
        self.capture_seconds = []
        self._programs = {}
        self._last = None
        self.host_launches = {}
        self.reset_host_launches()

    def _counters(self):
        return [p.counter for p in self._programs.values() if p.counter is not None]

    def reset_host_launches(self):
        _build.launch_counts.settle()
        self.host_launches.update(
            graph_replays=0, input_copies=0, output_clones=0)
        for counter in self._counters():
            counter.body_runs = 0

    @property
    def body_runs(self) -> int:
        _build.launch_counts.settle()
        return sum(counter.body_runs for counter in self._counters())

    @property
    def width_log(self):
        return [] if self._last is None else self._last.width_log()

    def _on_device(self):
        return torch.cuda.device(self.device) if self.captured else contextlib.nullcontext()

    def __call__(self, scenario: Scenario, carry: ControllerCarry):
        with torch.no_grad(), self._on_device():
            prog = self._last = self._program(scenario, carry)
            return prog(scenario, carry)

    def nested(self, scenario: Scenario, carry: ControllerCarry) -> "NestedTick":
        """The program of this input signature as the parts of a tick that
        a caller nests in a parent graph of its own (runtime/simulator.py),
        recorded as the last program (``width_log`` reads it). On the card
        its stages are captured, and its own parent graph is built only if
        the tick is later called with that signature."""
        with torch.no_grad(), self._on_device():
            prog = self._last = self._program(scenario, carry, standalone=False)
        tally = dict(prog.head.tally)
        for name, n in prog.tail.tally.items():
            tally[name] = tally.get(name, 0) + n
        return NestedTick(scenario=prog.scenario, carry=prog.carry, out=prog.tail.out,
                          counter=prog.counter, tally=tally, add_nodes=prog.add_nodes,
                          run=prog._run)

    def _program(self, scenario, carry, standalone: bool = True) -> _Program:
        key = signature(scenario, carry)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = self.program(self, scenario, carry, standalone)
            if prog.capture_seconds is not None:
                self.capture_seconds.append(prog.capture_seconds)
        return prog
