"""The compiled tick: ``make_step_batch``'s tick replayed as CUDA graphs.

Counterpart of the JAX package's ``jax.jit(jax.vmap(step))``
(``controller/controller.py: make_step_batch``) and of its LM
``lax.while_loop`` on the device (``solver/lm.py``). Eagerly, a tick is some
3,000 launches from Python; here it is recorded once per input signature and
replayed, in three stages split where the eager tick already waits for the
device:

  head    ``step_pre`` (plan windowing, trajectorize, FOV filter, problem
          assembly with the SFM projection, K5), the evaluation's per-tick
          set-up (``build_value_grad``) and the LM state at u0 (the first
          evaluation: rollout_sample, K2, and with latent critics their
          term, ops/latent.py);
  chunk   ``check_every`` default LM iterations (K3 -> rollout_sample -> K2
          -> K4 each) from the head's LM state, written back into it in
          place; between chunks the host asks whether every lane is done, at
          the iterations where the eager loop asks (``solver/lm.py:
          lm_solve``), so the iteration counts, and the bits, are the eager
          loop's. A remainder chunk covers ``max_iterations % check_every``;
          with ``check_every = 0`` one chunk holds every iteration and the
          host never asks. With debug_optimizer (the counterpart of the
          JAX package's traced ``lax.while_loop``) a chunk runs the general
          iteration (K7's damped step -> rollout_sample -> K2 ->
          ``commit_with_aux``) and writes its iterations' trace columns;
          a column is the chunk's position times ``check_every`` plus the
          iteration's place in it, so there is one graph per position;
  tail    the solve statistics and ``step_post`` (extraction, degradation
          ladder, carry, the trace).

``controller/graph_compacted.py`` stages make_step_batch_compacted's tick on
the same head and tail, with chunks at each width of its ladder and the
transitions between them.

The stages read static tensors: the scenario and carry leaves the tick reads
are copied into buffers of the program (``copy_``, never rebound, since the
kernels take raw pointers), and the head's outputs stay referenced for the
graphs' lifetime. The graphs share one memory pool. A program is
captured at the first call with a new signature (every leaf's shape, stride
and dtype: B and N people among them), after one eager warm-up tick on the
capture stream, so that capture is the first use of nothing, and with
Python's garbage collector held off (``collector_held``). Outputs are
cloned out of the graphs' tensors: no two calls return tensors that alias
each other or the program's buffers.

Launch counts: a replay calls no kernel wrapper, so each graph keeps the
``_build.launch_counts`` tally its capture made and adds it at every replay;
the warm-up tick and the capture add nothing. The counters thus go on
meaning "kernels the ticks ran". ``host_launches`` counts what the host does
instead: graph replays, input copies, output clones and done checks.

On the CPU (no graphs) the same stages run as plain functions on the same
static buffers, with the same copy-back and the same clones. A failed
capture, instantiation or replay raises; nothing retries eagerly.
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


def lm_chunk(lm_cfg, level: Level, n: int, trace: Optional[lm.LMTrace] = None,
             it0: int = 0) -> None:
    """n LM iterations from level.state, written back into its tensors in
    place: the default iteration, or with `trace` the general one (K7's
    damped step, commit_with_aux) writing trace columns it0, it0 + 1, ..."""
    st = level.state
    for i in range(n):
        if trace is None:
            st = lm.lm_iteration(level.value_grad, level.lower, level.upper, lm_cfg, st)
            continue
        st_new, aux = lm.lm_iteration_general(
            level.value_grad, level.lower, level.upper, lm_cfg, lm.default_linear_solve, None, st)
        lm.record_trace(trace, it0 + i, st, aux)
        st = st_new
    for dst, src in zip(level.state, st):
        dst.copy_(src)


def tick_tail(cfg, head: TickHead, carry: ControllerCarry):
    """The solve statistics and step_post: (cmd, aux, carry')."""
    stats = lm.solve_stats(head.state, head.initial_cost)
    return step_post(cfg, head.ctx, carry, head.state.u, stats, head.trace)


def chunk_schedule(max_iterations: int, check_every: int):
    """The iteration counts of the chunks, in order: the eager loop's
    stretches between two checks (check_every = 0: one stretch)."""
    if check_every <= 0:
        return [max_iterations] if max_iterations > 0 else []
    return [min(check_every, max_iterations - it) for it in range(0, max_iterations, check_every)]


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
    """fn(*args) as a CUDA graph, captured once and replayed (its outputs
    the graph's tensors), or, uncaptured, called every time."""

    def __init__(self, fn):
        self.fn = fn
        self.graph = None
        self.out = None
        self.tally = {}

    def capture(self, args, pool, stream):
        """Record fn(*args) and return its outputs; the launch counts its
        wrappers added are the tally of a replay (the caller takes them
        back: capture runs nothing)."""
        before = dict(_build.launch_counts)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            self.out = self.fn(*args)
        self.tally = {k: n - before[k] for k, n in _build.launch_counts.items() if n != before[k]}
        self.graph = graph
        return self.out

    def __call__(self, *args):
        if self.graph is None:
            return self.fn(*args)
        self.graph.replay()
        for k, n in self.tally.items():
            _build.launch_counts[k] += n
        return self.out


class _Program:
    """The staged tick of one input signature: static input buffers, the
    head and tail stages, and the solve's stages and host schedule, which
    a subclass gives (``_stages``: every stage once, in capture order;
    ``_solve``: one tick's chunks between head and tail)."""

    def __init__(self, tick: "GraphTick", scenario: Scenario, carry: ControllerCarry):
        cfg, lm_cfg = tick.cfg, tick.lm_cfg
        self.tick = tick
        self.scenario = tree_map(torch.clone, _read_leaves(scenario))
        self.carry = tree_map(torch.clone, carry)
        self.schedule = chunk_schedule(lm_cfg.max_iterations, tick.check_every)
        self.head = _Stage(lambda: tick_head(cfg, lm_cfg, self.scenario, self.carry,
                                             tick.trace_len))
        self.tail = _Stage(lambda h: tick_tail(cfg, h, self.carry))
        self._build()
        self.capture_seconds = None
        if tick.captured:
            self._capture()

    def _every_stage(self, run):
        """run(stage, *args) on every stage once, in capture order, each
        stage's arguments being what the stages before it returned."""
        h = run(self.head)
        self._stages(run, h)
        run(self.tail, h)

    def _capture(self):
        """One eager warm-up of every stage on the capture stream (results
        dropped), then the graphs in one pool, in the order a tick replays
        them (a stage's outputs may sit where an earlier graph kept its
        temporaries, which it never reads after that graph replays again);
        the launch counts left as they were."""
        t0 = time.perf_counter()
        counts = dict(_build.launch_counts)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self._every_stage(lambda stage, *args: stage(*args))
        torch.cuda.current_stream().wait_stream(stream)
        pool = torch.cuda.graph_pool_handle()
        with collector_held():
            self._every_stage(lambda stage, *args: stage.capture(args, pool, stream))
        torch.cuda.synchronize()
        _build.launch_counts.update(counts)
        self.capture_seconds = time.perf_counter() - t0

    def __call__(self, scenario: Scenario, carry: ControllerCarry):
        counts = self.tick.host_launches
        for dst, src in zip(tree_leaves((self.scenario, self.carry)),
                            tree_leaves((_read_leaves(scenario), carry))):
            dst.copy_(src)
            counts["input_copies"] += 1
        h = self.head()
        replays = self._solve(h)
        out = tree_map(torch.clone, self.tail(h))
        if self.tick.captured:
            counts["graph_replays"] += replays + 2
        counts["output_clones"] += len(tree_leaves(out))
        return out


class _ChunkProgram(_Program):
    """make_step_batch's staged tick: the LM chunks at full width, one
    graph per chunk length, or with the trace one per chunk position (its
    columns are the chunk's iterations)."""

    def _build(self):
        lm_cfg, trace_len = self.tick.lm_cfg, self.tick.trace_len
        starts = [sum(self.schedule[:i]) for i in range(len(self.schedule))]
        if trace_len:
            self.keys = list(range(len(self.schedule)))
            self.chunks = {i: _Stage(lambda h, n=n, it0=it0: lm_chunk(
                lm_cfg, full_width(h), n, h.trace, it0))
                for i, (n, it0) in enumerate(zip(self.schedule, starts))}
        else:
            self.keys = self.schedule
            self.chunks = {n: _Stage(lambda h, n=n: lm_chunk(lm_cfg, full_width(h), n))
                           for n in sorted(set(self.schedule))}

    def _stages(self, run, h):
        for chunk in self.chunks.values():
            run(chunk, h)

    def _solve(self, h) -> int:
        counts = self.tick.host_launches
        ran = []
        for key, n in zip(self.keys, self.schedule):
            if self.tick.check_every > 0:
                counts["done_checks"] += 1
                if bool(h.state.done.all()):
                    break
            self.chunks[key](h)
            ran.append(n)
        self.tick.width_log = [h.state.u.shape[0]] * sum(ran)
        return len(ran)


def _read_leaves(scenario: Scenario) -> Scenario:
    """The scenario without the one leaf the tick never reads: the SFM
    projection takes the ESDF's nearest-obstacle index grid, not its
    distances, which are therefore not copied."""
    return scenario._replace(esdf=scenario.esdf._replace(distances=None))



class GraphTick:
    """tick(scenario, carry) -> (cmd, aux, carry'): make_step_batch's tick
    for any config, staged as above; captured as CUDA graphs when `device`
    is CUDA, plain functions on the CPU. The scenario and carry must lie on
    `device`. With debug_optimizer the chunks run the general iteration and
    the tail returns the (B, max_iterations) trace; with latent critics the
    evaluation in every stage is ops/latent.py's LatentValueGrad.

    ``check_every`` is lm_solve's: how often the host asks whether every
    lane is done (the results do not depend on it). ``capture_seconds``
    holds each program's warm-up plus capture time, in order of capture;
    ``host_launches`` the host's operations since ``reset_host_launches``
    (graph replays, input copies, output clones, done checks — each check
    one reduction launch and one copy to the host); ``width_log`` the width
    of every LM iteration of the last tick."""

    program = _ChunkProgram

    def __init__(self, cfg, device, check_every: int = lm.DEFAULT_CHECK_EVERY):
        self.cfg = cfg
        self.lm_cfg = make_lm_config(cfg.optimizer)
        self.trace_len = cfg.optimizer.max_iterations if cfg.optimizer.debug_optimizer else 0
        self.device = torch.device(device)
        self.captured = self.device.type == "cuda"
        self.check_every = check_every
        self.capture_seconds = []
        self.width_log = []
        self._programs = {}
        self.host_launches = {}
        self.reset_host_launches()

    def reset_host_launches(self):
        self.host_launches.update(
            graph_replays=0, input_copies=0, output_clones=0, done_checks=0)

    def __call__(self, scenario: Scenario, carry: ControllerCarry):
        on_device = torch.cuda.device(self.device) if self.captured else contextlib.nullcontext()
        with torch.no_grad(), on_device:
            return self._program(scenario, carry)(scenario, carry)

    def _program(self, scenario, carry) -> _Program:
        key = signature(scenario, carry)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = self.program(self, scenario, carry)
            if prog.capture_seconds is not None:
                self.capture_seconds.append(prog.capture_seconds)
        return prog
