"""The compacted tick's schedule on the device (``controller/graph_compacted.py``,
``controller/tick_graph.py: compact_continue``) run on the CPU.

On the card make_step_batch_compacted's tick is one launch of a parent graph
whose width-ladder schedule ``compact_continue`` decides: per rung a WHILE
node over chunks of check_every LM iterations, an IF node over the chunk of
the remainder, an IF node over the transition to the next rung, then the
scatter of the rung reached. On the CPU the same structure runs in Python,
each condition computed by compact_continue's plain version on the same
tensors. These tests hold that structure against the eager solver
(``solver/batched.py: lm_solve_batch_compacted``) on problems whose lanes
converge when the test wants them to (a check that falls past two and three
rungs, every lane done at the first check, the remainder chunk at a lower
rung), bit for bit in float32 and float64 with equal widths; the compacted
tick against the eager compacted tick (``capture=False``) on the social and
the stress-horizon (D = 12) configs and with latent critics; and the plain
version against hand-worked counts. The ``gpu`` tests hold the kernel
against its plain version and the one-launch compacted tick against the
eager one on the card:

    python -m pytest tests/test_torch_compacted_loop.py -q --noconftest -p no:cacheprovider -m gpu
"""

import dataclasses
import shutil
import types

import numpy as np
import pytest
import torch

from nav2_social_mpc_controller_tpu_torch import _build
from nav2_social_mpc_controller_tpu_torch.controller import tick_graph
from nav2_social_mpc_controller_tpu_torch.controller.controller import (
    make_carry,
    make_step_batch_compacted,
    step_post,
    step_pre,
)
from nav2_social_mpc_controller_tpu_torch.controller.graph_compacted import _CompactedProgram
from nav2_social_mpc_controller_tpu_torch.controller.optimize import build_value_grad, make_lm_config
from nav2_social_mpc_controller_tpu_torch.core import config as C
from nav2_social_mpc_controller_tpu_torch.core import types as T
from nav2_social_mpc_controller_tpu_torch.solver import batched, lm
from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario_batch

torch.set_num_threads(1)

DTYPES = pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])


# ---------------------------------------------------------------------------
# compact_continue's plain version
# ---------------------------------------------------------------------------

L3 = 3  # a ladder of three rungs, e.g. [16, 8, 4]


def _stats(it=0, launches=0, rung=0, stopped=0):
    s = tick_graph.compact_stats(L3, "cpu")
    s[:4] = torch.tensor([it, launches, rung, stopped])
    return s


def _run(stats, active, **kw):
    """compact_continue's plain version on `active` lanes of 16 (rung 0
    defaults: next rung 8, a chunk of 8 iterations, cap 40); returns the
    flags it set."""
    done = torch.arange(16) >= active
    out = torch.full((4,), 7, dtype=torch.int32)
    args = dict(rung=0, n_rungs=L3, next_width=8, reset=False, check_every=8, max_iterations=40)
    tick_graph.compact_continue(done, stats, out, **{**args, **kw})
    return out.tolist()


def test_compact_continue_plain_against_hand_worked_counts():
    """Every role and outcome of the condition, worked by hand: a tick's
    first check (reset), a full chunk, a descent, the remainder at the last
    check, a stop at zero and at the cap, a rung not reached, a stopped
    schedule, and the finish role picking the scatter."""
    s = _stats(it=33, launches=5, rung=2, stopped=1)
    s[4:] = 9  # per-rung iterations reset; run counters kept
    assert _run(s, 12, reset=True)[:3] == [1, 0, 0]  # 12 > 8: a chunk of 8 at rung 0
    assert s[:7].tolist() == [8, 6, 0, 0, 8, 0, 0] and s[7].item() == 10  # full chunks at 0
    assert _run(s, 5)[:3] == [0, 0, 1]  # 5 <= 8: descend, iterations unchanged
    assert s[:4].tolist() == [8, 7, 1, 0] and s[4 + 3 * L3].item() == 10
    assert _run(s, 5)[:3] == [0, 0, 0] and s[:4].tolist() == [8, 8, 1, 0]  # rung 0 not reached
    assert _run(s, 5, rung=1, next_width=4)[:3] == [1, 0, 0]  # 5 > 4 at rung 1: a chunk
    assert s[:4].tolist() == [16, 9, 1, 0] and s[5].item() == 8
    s[0] = 36  # the last check: 4 iterations left
    assert _run(s, 5, rung=1, next_width=4)[:3] == [0, 1, 0]
    assert s[:4].tolist() == [40, 10, 1, 1] and s[5].item() == 12 and s[4 + 2 * L3 + 1] == 10
    assert _run(s, 5, rung=1, next_width=4)[:3] == [0, 0, 0]  # stopped: nothing
    assert _run(s, 0, finish=True) == [0, 1, 0, 7]  # the scatter of rung 1
    assert s[4 + 4 * L3 + 1].item() == 10 and s[1].item() == 12
    s = _stats(rung=2)
    assert _run(s, 0, rung=2, next_width=0)[:3] == [0, 0, 0] and s[3].item() == 1  # all done
    s = _stats(it=40, rung=2)
    assert _run(s, 3, rung=2, next_width=0)[:3] == [0, 0, 0] and s[3].item() == 1  # the cap
    s = _stats(rung=0)
    assert _run(s, 3, finish=True)[:3] == [0, 0, 0]  # at full width: no scatter
    s = _stats(it=32, rung=2)
    assert _run(s, 2, rung=2, next_width=0, check_every=6)[:3] == [1, 0, 0]
    assert s[:4].tolist() == [38, 1, 2, 0]  # 8 left at the last rung: a chunk of 6


# ---------------------------------------------------------------------------
# the schedule against the eager solver, on problems built for it
# ---------------------------------------------------------------------------


class Rosenbrock:
    """Per lane r(u) = [a (u1 - u0^2), 1 - u0]: a = 1 from (0.5, 0.3)
    converges in a few LM iterations, a = 100 from (-1.2, 1) takes tens; a
    NaN a starts the lane done (its initial cost is not finite)."""

    def __init__(self, a):
        self.a = a

    def select(self, lanes):
        return Rosenbrock(self.a.index_select(0, lanes))

    def __call__(self, u):
        a, x, y = self.a, u[:, 0], u[:, 1]
        r = torch.stack([a * (y - x * x), 1 - x], 1)
        jac = torch.stack([torch.stack([-2 * a * x, a], 1),
                           torch.stack([-torch.ones_like(x), torch.zeros_like(x)], 1)], 1)
        g = (jac.transpose(1, 2) @ r[:, :, None])[:, :, 0]
        return 0.5 * (r * r).sum(1), g.contiguous(), (jac.transpose(1, 2) @ jac).contiguous()


def _problem(batch, dtype, hard=(), nan=()):
    a = torch.ones(batch, dtype=dtype)
    u0 = torch.tensor([0.5, 0.3], dtype=dtype).repeat(batch, 1)
    for i in hard:
        a[i] = 100.0
        u0[i] = torch.tensor([-1.2, 1.0], dtype=dtype)
    a[list(nan)] = float("nan")
    return Rosenbrock(a), u0, u0 - 5, u0 + 5


def _same_bits(a, b):
    """Equal dtype, shape and bits (a NaN cost equals itself)."""
    ints = {torch.float64: torch.int64, torch.float32: torch.int32}
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype])) if a.dtype in ints \
        else torch.equal(a, b)


def _device_schedule(value_grad, u0, lower, upper, cfg, capacity_frac, check_every):
    """The compacted program's schedule (its stages uncaptured, its
    conditions compact_continue's plain version) on one problem: (u,
    SolveStats, program)."""
    prog = object.__new__(_CompactedProgram)
    prog.tick = types.SimpleNamespace(capacity_frac=capacity_frac, check_every=check_every,
                                      lm_cfg=cfg, device=u0.device)
    prog.batch = u0.shape[0]
    prog._build()
    st = lm.initial_state(value_grad, u0, cfg)
    head = types.SimpleNamespace(
        state=st._replace(u=st.u.clone(), cost=st.cost.clone()), value_grad=value_grad,
        ctx=types.SimpleNamespace(prep=types.SimpleNamespace(lower=lower, upper=upper)))
    prog._solve(head)
    return head.state.u, lm.solve_stats(head.state, st.cost), prog


def _runs(prog):
    """{what: [per rung]} of the program's counters."""
    s, n = prog.counter.stats.tolist(), len(prog.widths)
    names = ("iterations", "chunks", "remainders", "transitions", "scatters")
    return {name: s[4 + m * n:4 + (m + 1) * n] for m, name in enumerate(names)}


SCHEDULES = {
    # B, capacity, check_every, cap, hard lanes, NaN lanes
    "past_three_rungs": (16, 0.125, 8, 40, (3, 11), ()),
    "past_two_rungs_remainder_below": (12, 0.25, 6, 20, (5,), ()),
    "all_done_after_one_chunk": (16, 0.125, 8, 40, (), ()),
    "all_done_at_the_first_check": (8, 0.25, 8, 40, (), tuple(range(8))),
    "done_from_the_start_and_late": (12, 0.25, 6, 40, (0, 7), (1, 2, 3, 4, 5, 6)),
}


@DTYPES
@pytest.mark.parametrize("case", list(SCHEDULES))
def test_device_schedule_equals_the_eager_solver(case, dtype):
    """The schedule gives lm_solve_batch_compacted's u and SolveStats bit for
    bit, runs the eager solver's widths, and takes the path the case was
    built for."""
    batch, frac, every, cap, hard, nan = SCHEDULES[case]
    cfg = lm.LMConfig(max_iterations=cap)
    vg, u0, lo, hi = _problem(batch, dtype, hard, nan)
    log = []
    u_e, s_e = batched.lm_solve_batch_compacted(
        vg, u0, lo, hi, cfg, batched.compacted_capacity(batch, frac), check_every=every,
        width_log=log)
    u, s, prog = _device_schedule(vg, u0, lo, hi, cfg, frac, every)
    for a, b in zip((u, *s), (u_e, *s_e)):
        assert _same_bits(a, b)
    assert prog.width_log() == log
    runs = _runs(prog)
    if case == "past_three_rungs":  # one check: 16 -> 8 -> 4 -> 2
        assert prog.widths == [16, 8, 4, 2] and runs["transitions"] == [1, 1, 1, 0]
        assert runs["iterations"] == [8, 0, 0, 32] and runs["scatters"] == [0, 0, 0, 1]
    elif case == "past_two_rungs_remainder_below":  # 12 -> 6 -> 3, then 2 of 20 at 3
        assert runs["transitions"] == [1, 1, 0] and runs["remainders"] == [0, 0, 1]
        assert log == [12] * 6 + [3] * 14
    elif case == "all_done_after_one_chunk":
        assert log == [16] * 8 and runs["transitions"] == [0] * 4
    elif case == "all_done_at_the_first_check":
        assert log == [] and sum(sum(v) for v in runs.values()) == 0
        assert prog.counter.stats[1].item() == len(prog.widths) + 1  # one check a rung, finish
    else:  # the first check descends twice before any iteration: 6 active of 12
        assert runs["iterations"] == [0, 6, 34] and runs["transitions"] == [1, 1, 0]
        assert runs["remainders"] == [0, 0, 1] and log[-4:] == [3] * 4


# ---------------------------------------------------------------------------
# the compacted tick
# ---------------------------------------------------------------------------


def _warm(cfg, latent=False):
    opt = dataclasses.replace(cfg.optimizer, warm_start_mode="previous_solution")
    if latent:
        opt = dataclasses.replace(opt, weights=dataclasses.replace(
            opt.weights, pure_angle_weight=0.5, curvature_weight=0.3))
    return dataclasses.replace(cfg, optimizer=opt)


def _ticks(step, cfg, sc, n_ticks):
    """[((cmd, aux, carry'), widths)] of n_ticks warm ticks, the carry fed
    back (the same poses: from the second tick on most lanes start near
    their optimum and converge early)."""
    carry = make_carry(cfg, sc.robot.pose.shape[0], device=sc.robot.pose.device,
                       dtype=sc.robot.pose.dtype)
    out = []
    for _ in range(n_ticks):
        cmd, aux, carry = step(sc, carry)
        out.append(((cmd, aux, carry), list(step.tick.width_log)))
    return out


class _EagerTickAt:
    """The eager compacted tick (controller.CompactedTick: step_pre,
    lm_solve_batch_compacted, step_post) at a check_every of its own."""

    def __init__(self, cfg, capacity_frac, check_every):
        self.cfg, self.frac, self.every = cfg, capacity_frac, check_every
        self.tick = self
        self.width_log = []

    def __call__(self, scenario, carry):
        cfg = self.cfg
        with torch.no_grad():
            ctx = step_pre(cfg, scenario, carry)
            prep = ctx.prep
            self.width_log = []
            u, stats = batched.lm_solve_batch_compacted(
                build_value_grad(cfg, prep), prep.u0, prep.lower, prep.upper,
                make_lm_config(cfg.optimizer),
                batched.compacted_capacity(prep.u0.shape[0], self.frac),
                check_every=self.every, width_log=self.width_log)
            return step_post(cfg, ctx, carry, u, stats)


def _scenarios(cfg, batch, dtype, device="cpu"):
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return T.scenario_from_numpy(make_scenario_batch(cfg, batch, 0, n_valid_people=3,
                                                     grid_hw=(64, 64), dtype=np_dtype),
                                 device=device, dtype=dtype)


TICKS = {
    # config, latent critics, B, capacity, check_every, ticks
    "social": (C.benchmark_social_config, False, 12, 0.25, 8, 3),
    "social_check_every_6": (C.benchmark_social_config, False, 12, 0.25, 6, 2),
    "stress36": (C.benchmark_stress_h36_config, False, 8, 0.25, 8, 2),
    "social_latent": (C.benchmark_social_config, True, 12, 0.25, 6, 2),
}


@DTYPES
@pytest.mark.parametrize("case", list(TICKS))
def test_compacted_tick_equals_the_eager_tick(case, dtype):
    """Warm ticks with the carry fed back: the compacted tick on its device
    schedule gives the eager compacted tick's commands, aux and carry bit
    for bit, with its widths: make_step_batch_compacted(capture=False) at
    the default check_every, the same solver at another one (in float32 on
    the CPU a lane's last bit can depend on the width it runs at, so the
    widths must be the same)."""
    make_cfg, latent, batch, frac, every, n_ticks = TICKS[case]
    cfg = _warm(make_cfg(), latent)
    sc = _scenarios(cfg, batch, dtype)
    step = make_step_batch_compacted(cfg, frac, device="cpu", dtype=dtype)
    step.tick.check_every = every  # read when a program is built
    got = _ticks(step, cfg, sc, n_ticks)
    if every == lm.DEFAULT_CHECK_EVERY:
        eager = make_step_batch_compacted(cfg, frac, device="cpu", dtype=dtype, capture=False)
    else:
        eager = _EagerTickAt(cfg, frac, every)
    for (out, log), (out_e, log_e) in zip(got, _ticks(eager, cfg, sc, n_ticks)):
        for a, b in zip(T.tree_leaves(out), T.tree_leaves(out_e)):
            assert _same_bits(a, b)
        assert log == log_e
    host = step.tick.host_launches
    assert host == {"graph_replays": 0, "input_copies": 17 * n_ticks,
                    "output_clones": 18 * n_ticks}


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when a test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the CUDA kernels have no CPU mode")
    if shutil.which("nvcc") is None:
        _build.find_nvcc()  # raises with the reason when there is no toolkit
    return torch.device("cuda")


@pytest.mark.gpu
def test_compact_continue_kernel_equals_plain_on_the_card(card):
    """compact_continue outside a graph (it sets no condition) against its
    plain version on the card: counters and flags equal in every role (a
    tick's first check, a rung's check and its body's, the finish) from
    states before, at and after the cap, at rungs reached and not, with no,
    one, half and every lane active, at 4,096, 1,000 and 3 lanes."""
    gen = torch.Generator().manual_seed(0)
    compared = 0
    for width in (4096, 1000, 3):
        order = torch.randperm(width, generator=gen)
        for active in sorted({0, 1, width // 2, width}):
            done = torch.ones(width, dtype=torch.bool)
            done[order[:active]] = False
            done = done.to(card)
            for it, rung, stopped in ((0, 0, 0), (32, 1, 0), (36, 1, 0), (40, 1, 0), (8, 2, 1)):
                for role in (dict(rung=0, reset=True), dict(rung=1, reset=False),
                             dict(rung=2, reset=False, next_width=0),
                             dict(rung=1, reset=False, finish=True)):
                    role = {"next_width": max(width // 4, 1), **role}
                    res = []
                    for fn in (tick_graph.compact_continue, tick_graph.compact_continue_plain):
                        stats = torch.arange(4 + 5 * L3, dtype=torch.int64, device=card)
                        stats[:4] = torch.tensor([it, 3, rung, stopped])
                        out = torch.full((4,), 7, dtype=torch.int32, device=card)
                        fn(done, stats, out, n_rungs=L3, check_every=8, max_iterations=40,
                           **role)
                        res.append(torch.cat([stats, out.long()]))
                    assert torch.equal(res[0], res[1]), (width, active, it, rung, role)
                    compared += 1
    assert compared == 3 * 4 * 5 * 4 - 5 * 4  # width 3 has three distinct actives


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["social", "stress36", "social_latent"])
def test_one_launch_compacted_tick_on_the_card(card, case):
    """After the first tick (capture), a compacted tick is the input copies,
    one graph launch and the output clones, with no done check and no
    hidden synchronisation (torch.cuda.set_sync_debug_mode("error")); its
    results and widths equal the eager compacted tick's bit for bit (every
    kernel works scenario by scenario), and so do its kernel launches, but
    for compact_continue's own; the parent graph holds a WHILE per rung and
    an IF per transition and per scatter."""
    make_cfg, latent, _, frac, _, _ = TICKS[case]
    cfg = _warm(make_cfg(), latent)
    batch = 128 if case == "stress36" else 256
    sc = _scenarios(cfg, batch, torch.float32, device=card)
    runs, counts = {}, {}
    for capture in (True, False):
        step = make_step_batch_compacted(cfg, frac, device=card, capture=capture)
        assert step.captured == capture
        _build.reset_launch_counts()
        carry = make_carry(cfg, batch, device=card)
        out = []
        for t in range(3):
            if capture and t == 1:
                step.tick.reset_host_launches()
            torch.cuda.synchronize()
            if capture and t:
                torch.cuda.set_sync_debug_mode("error")
            try:
                cmd, aux, carry = step(sc, carry)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            out.append(((cmd, aux, carry), list(step.tick.width_log)))
        torch.cuda.synchronize()
        counts[capture] = dict(_build.launch_counts)
        runs[capture] = out
        if capture:
            assert step.tick.host_launches == {"graph_replays": 2, "input_copies": 2 * 17,
                                               "output_clones": 2 * 18}
            prog, = step.tick._programs.values()
            n = len(prog.widths)
            types = prog.parent.node_types()
            assert types["conditional"] == n + (n - 1) * 2 and types["kernel"] > 100
    for (got, log), (want, log_e) in zip(runs[True], runs[False]):
        for a, b in zip(T.tree_leaves(got), T.tree_leaves(want)):
            assert _same_bits(a, b)
        assert log == log_e
    assert counts[True].pop("compact_continue") > 0 and counts[False].pop("compact_continue") == 0
    assert counts[True] == counts[False] and counts[True]["propose"] > 0
    assert min(runs[True][-1][1]) < batch or case == "stress36"
