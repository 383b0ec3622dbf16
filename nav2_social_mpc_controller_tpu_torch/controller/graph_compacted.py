"""The compacted warm-start tick as one CUDA graph launch.

Counterpart of the JAX package's jitted ``make_step_batch_compacted``
(``controller/controller.py``), whose solver (``solver/batched.py``) runs a
``lax.while_loop`` per rung of its width ladder, compacts on the device and
runs a final loop. Here make_step_batch_compacted's tick is staged on the
head and tail of controller/graph.py, with the compacted solver
(solver/batched.py) in between as graphs per rung of its width ladder
[B] + width_ladder(B, capacity):

  chunk       per rung and chunk length n (check_every; the remainder of
              max_iterations if check_every does not divide it): n default
              LM iterations on the rung's static state, bounds and
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

Captured, they are the children of one parent graph
(controller/tick_graph.py), launched once a tick:

  head
  for each rung k: compact_continue, WHILE { chunk_k, compact_continue },
                   IF { remainder chunk_k }, IF { transition k -> k+1 }
  compact_continue (finish), for each rung k >= 1: IF { scatter_k }
  tail

``compact_continue`` runs the eager solver's schedule
(``batched.lm_solve_batch_compacted``) on the device: before each chunk it
counts the active lanes of the rung reached, stops at zero or at the cap,
descends while the count fits the next rung, and otherwise runs a chunk of
check_every iterations, or the remainder of max_iterations at the last
check, at that rung. A check that falls past several rungs runs the
transitions between them one after the other: the active lanes come first
in the same order either way, and the done lanes that pad a rung are the
same ones, frozen bit for bit, so the lanes and their bits are the eager
solver's (tests/test_torch_compacted_loop.py). Between the input copies and
the output clones the host reads nothing of the device. On the CPU the same
structure runs in Python, each condition computed by compact_continue's
plain version. Every rung is captured at the first call with a signature,
even those the first tick does not reach. ``width_log`` holds the width of
each LM iteration of the last tick, from the device's record (read when
asked).
"""

import torch

from nav2_social_mpc_controller_tpu_torch.controller import tick_graph
from nav2_social_mpc_controller_tpu_torch.controller.graph import (
    GraphTick,
    _LoopCounter,
    _Program,
    _Stage,
    full_width,
    lm_chunk,
)
from nav2_social_mpc_controller_tpu_torch.solver import batched, lm


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
        b, every, cap = self.batch, tick.check_every, lm_cfg.max_iterations
        capacity = batched.compacted_capacity(b, tick.capacity_frac)
        batched.check_compaction(b, capacity, lm_cfg, every)
        self.widths = [b] + batched.width_ladder(b, capacity)
        n_rungs = len(self.widths)
        if n_rungs > tick_graph.MAX_HANDLES:
            raise ValueError(f"a ladder of {n_rungs} rungs: the device schedule takes at most "
                             f"{tick_graph.MAX_HANDLES}")
        self.full = every if cap >= every else None  # a chunk between two checks
        self.rest = cap % every or None  # the chunk at the last check
        self.chunks = [{n: _Stage(lambda level, n=n: lm_chunk(lm_cfg, level, n))
                        for n in (self.full, self.rest) if n} for _ in self.widths]
        self.transitions = [_Stage(lambda h, level, w=w: transition(h, level, w))
                            for w in self.widths[1:]]
        self.scatters = [None] + [_Stage(scatter_back) for _ in self.widths[1:]]
        L = n_rungs
        self.counter = _LoopCounter(tick_graph.compact_stats(L, tick.device), "compact_continue")
        self.counter.body_slots = [4 + m * L + k for m in (1, 2) for k in range(L)]
        self.slots = []
        for k in range(L):
            self.slots += [(4 + m * L + k, self.chunks[k][n])
                           for m, n in ((1, self.full), (2, self.rest)) if n]
            if k + 1 < L:
                self.slots.append((4 + 3 * L + k, self.transitions[k]))
            if k:
                self.slots.append((4 + 4 * L + k, self.scatters[k]))
        self.flags = torch.zeros(max(3, L), dtype=torch.int32, device=tick.device)

    def _stages(self, run, h):
        levels = [full_width(h)]
        for k in range(len(self.widths)):
            for chunk in self.chunks[k].values():
                run(chunk, levels[k])
            if k + 1 < len(self.widths):
                levels.append(run(self.transitions[k], h, levels[k]))
        for k in range(1, len(self.widths)):
            run(self.scatters[k], h, levels[k])

    def _check(self, k: int, level):
        """compact_continue's arguments at rung k (level: the rung's Level,
        None on the CPU before the tick reached it)."""
        widths = self.widths
        return dict(done=None if level is None else level.state.done,
                    stats=self.counter.stats, out=self.flags, rung=k, n_rungs=len(widths),
                    next_width=widths[k + 1] if k + 1 < len(widths) else 0,
                    check_every=self.tick.check_every,
                    max_iterations=self.tick.lm_cfg.max_iterations)

    def _solve(self, h) -> None:
        """The parent graph's schedule, run from the host: each condition is
        compact_continue's plain version on the same tensors (the CPU
        path)."""
        levels = [full_width(h)] + [None] * (len(self.widths) - 1)
        flags = self.flags
        for k in range(len(self.widths)):
            check = self._check(k, levels[k])
            tick_graph.compact_continue(reset=k == 0, **check)
            while flags[0]:
                self.chunks[k][self.full](levels[k])
                tick_graph.compact_continue(reset=False, **check)
            if flags[1]:
                self.chunks[k][self.rest](levels[k])
            if flags[2]:
                levels[k + 1] = self.transitions[k](h, levels[k])
        tick_graph.compact_continue(reset=False, finish=True, **self._check(0, levels[0]))
        for k in range(1, len(self.widths)):
            if flags[k]:
                self.scatters[k](h, levels[k])

    def _parent(self):
        L = len(self.widths)
        levels = [full_width(self.head.out)] + [t.out for t in self.transitions]
        parent = tick_graph.ParentGraph()
        g = parent.root
        prev = parent.child(g, None, self.head.graph, "the tick's head")
        for k, level in enumerate(levels):
            w = self.widths[k]
            handles = [parent.handle(g) if has else None
                       for has in (self.full, self.rest, k + 1 < L)]
            check = self._check(k, level)
            prev = parent.compact_continue(g, prev, handles, reset=k == 0, **check)
            if self.full:
                prev, body = parent.conditional(g, prev, handles[0], loop=True)
                node = parent.child(body, None, self.chunks[k][self.full].graph,
                                    f"the chunk of {self.full} LM iterations at width {w}")
                parent.compact_continue(body, node, handles, reset=False, **check)
            if self.rest:
                prev, body = parent.conditional(g, prev, handles[1], loop=False)
                parent.child(body, None, self.chunks[k][self.rest].graph,
                             f"the chunk of {self.rest} LM iterations at width {w}")
            if k + 1 < L:
                prev, body = parent.conditional(g, prev, handles[2], loop=False)
                parent.child(body, None, self.transitions[k].graph,
                             f"the transition from width {w}")
        handles = [None] + [parent.handle(g) for _ in range(1, L)]
        prev = parent.compact_continue(g, prev, handles, reset=False, finish=True,
                                       **self._check(0, levels[0]))
        for k in range(1, L):
            prev, body = parent.conditional(g, prev, handles[k], loop=False)
            parent.child(body, None, self.scatters[k].graph,
                         f"the scatter from width {self.widths[k]}")
        parent.child(g, prev, self.tail.graph, "the tick's tail")
        return parent.instantiate()

    def width_log(self):
        """The width of every LM iteration of the last tick (the device's
        record: a read of the device)."""
        at = self.counter.stats[4:4 + len(self.widths)].tolist()
        return [w for w, n in zip(self.widths, at) for _ in range(n)]


class CompactedGraphTick(GraphTick):
    """tick(scenario, carry) -> (cmd, aux, carry'): make_step_batch_compacted's
    tick, staged as above; on CUDA one launch of a parent graph whose
    schedule runs on the device, plain functions on the CPU. capacity_frac
    sets the narrowest rung (batched.compacted_capacity); the rest is
    GraphTick's."""

    program = _CompactedProgram

    def __init__(self, cfg, capacity_frac: float, device,
                 check_every: int = lm.DEFAULT_CHECK_EVERY):
        if cfg.optimizer.debug_optimizer:
            raise ValueError("compaction does not support debug_optimizer")
        super().__init__(cfg, device, check_every)
        self.capacity_frac = capacity_frac
