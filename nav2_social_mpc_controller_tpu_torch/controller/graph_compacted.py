"""The compacted warm-start tick replayed as CUDA graphs.

Counterpart of the JAX package's jitted ``make_step_batch_compacted``
(``controller/controller.py``): make_step_batch_compacted's tick staged on
the head and tail of controller/graph.py, with the compacted solver
(solver/batched.py) in between as graphs per rung of its width ladder
[B] + width_ladder(B, capacity):

  chunk       per rung and distinct chunk length n: n default LM
              iterations on the rung's static state, bounds and
              ``ValueGrad.select``-ed data (``LatentValueGrad``'s with
              latent critics), written back in place (the first rung is
              the head's full-width state);
  transition  per pair of neighbouring rungs: the upper rung's state
              written back into the head's state at its lanes (``idx``),
              then the first W lanes of a stable sort of ``done`` gathered
              into the lower rung's buffers: state, bounds, data, idx
              (``batched.descend``);
  scatter     per rung below the first: its state written back into the
              head's state, before the tail.

The host schedule is the eager solver's: before each chunk it reads the
current rung's active count once (the one synchronisation the eager solver
takes there), stops at zero, and otherwise picks the rung the eager loop
picks (``batched.next_level``). A check that falls past several rungs
replays the transitions between them one after the other: the active lanes
come first in the same order either way, and the done lanes that pad a rung
are the same ones, frozen bit for bit, so the lanes and their bits are the
eager solver's (tests/test_torch_graph_compacted.py). Every rung is captured
at the first call with a signature, even those the first tick does not
reach. ``width_log`` holds the width of each LM iteration of the last tick.
"""

from nav2_social_mpc_controller_tpu_torch.controller.graph import (
    GraphTick,
    _Program,
    _Stage,
    full_width,
    lm_chunk,
)
from nav2_social_mpc_controller_tpu_torch.solver import batched, lm


def chunk_schedule(max_iterations: int, check_every: int):
    """The iteration counts of the chunks, in order: the eager loop's
    stretches between two checks."""
    return [min(check_every, max_iterations - it) for it in range(0, max_iterations, check_every)]


def scatter_back(head, level: batched.Level) -> None:
    """The rung's state written back into the head's state at its lanes."""
    for f, p in zip(head.state, level.state):
        f.index_copy_(0, level.idx, p)


def transition(head, level: batched.Level, width: int) -> batched.Level:
    """Level's lanes written back into the head's state (at full width they
    are the head's state already), then the next rung of `width` lanes."""
    if level.idx is not None:
        scatter_back(head, level)
    return batched.descend(level, width)


class _CompactedProgram(_Program):
    """make_step_batch_compacted's staged tick for one input signature."""

    def _build(self):
        tick, lm_cfg = self.tick, self.tick.lm_cfg
        b = self.batch
        capacity = batched.compacted_capacity(b, tick.capacity_frac)
        batched.check_compaction(b, capacity, lm_cfg, tick.check_every)
        self.schedule = chunk_schedule(lm_cfg.max_iterations, tick.check_every)
        self.log = []
        self.widths = [b] + batched.width_ladder(b, capacity)
        self.chunks = [{n: _Stage(lambda level, n=n: lm_chunk(lm_cfg, level, n))
                        for n in sorted(set(self.schedule))} for _ in self.widths]
        self.transitions = [_Stage(lambda h, level, w=w: transition(h, level, w))
                            for w in self.widths[1:]]
        self.scatters = [None] + [_Stage(scatter_back) for _ in self.widths[1:]]

    def _stages(self, run, h):
        levels = [full_width(h)]
        for k in range(len(self.widths)):
            for chunk in self.chunks[k].values():
                run(chunk, levels[k])
            if k + 1 < len(self.widths):
                levels.append(run(self.transitions[k], h, levels[k]))
        for k in range(1, len(self.widths)):
            run(self.scatters[k], h, levels[k])

    def _run(self):
        h = self.head()
        replays = self._solve(h)
        out = self.tail(h)
        if self.tick.captured:
            self.tick.host_launches["graph_replays"] += replays + 2
        return out

    def width_log(self):
        return self.log

    def _solve(self, h) -> int:
        counts = self.tick.host_launches
        level, k, replays, log = full_width(h), 0, 0, []
        for n in self.schedule:
            counts["done_checks"] += 1
            n_active = batched.active_count(level)
            if n_active == 0:
                break
            for _ in range(batched.next_level(self.widths, k, n_active) - k):
                level = self.transitions[k](h, level)
                k += 1
                replays += 1
            self.chunks[k][n](level)
            replays += 1
            log += [self.widths[k]] * n
        if k:
            self.scatters[k](h, level)
            replays += 1
        self.log = log
        return replays


class CompactedGraphTick(GraphTick):
    """tick(scenario, carry) -> (cmd, aux, carry'): make_step_batch_compacted's
    tick, staged as above; captured as CUDA graphs when `device` is CUDA,
    plain functions on the CPU. capacity_frac sets the narrowest rung
    (batched.compacted_capacity); the rest is GraphTick's."""

    program = _CompactedProgram

    def __init__(self, cfg, capacity_frac: float, device,
                 check_every: int = lm.DEFAULT_CHECK_EVERY):
        if cfg.optimizer.debug_optimizer:
            raise ValueError("compaction does not support debug_optimizer")
        super().__init__(cfg, device, check_every)
        self.capacity_frac = capacity_frac
