"""The LM loop of the one-launch tick (``controller/graph.py``,
``controller/tick_graph.py``) on the CPU.

On the card a tick is one launch of a parent graph whose solve is a
conditional WHILE node; on the CPU the same loops run in Python, each
condition computed by ``lm_continue``'s plain version on the same tensors,
and the debug trace is written at each lane's own iteration count
(``lm.record_trace_by_lane``). These tests hold that CPU path against
``capture=False`` bit for bit (with and without the trace), its iteration
counts against ``lm_solve``'s for several (max_iterations, check_every),
its trace against the JAX package's traced ``lax.while_loop`` in float64,
and ``lm_continue``'s plain version on its own. The card's tests are the
``gpu`` ones of ``tests/test_torch_graph_step.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from nav2_social_mpc_controller_tpu_torch.controller import graph, tick_graph
from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry, make_step_batch
from nav2_social_mpc_controller_tpu_torch.core import config as C
from nav2_social_mpc_controller_tpu_torch.core.types import scenario_from_numpy, tree_leaves
from nav2_social_mpc_controller_tpu_torch.solver import lm
from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario_batch

torch.set_num_threads(1)


def _cfg(max_iterations=40, debug=False):
    cfg = C.benchmark_social_config()
    return dataclasses.replace(cfg, optimizer=dataclasses.replace(
        cfg.optimizer, max_iterations=max_iterations, debug_optimizer=debug))


def _batch(cfg, batch):
    """(scenario batch with three valid people, per-tick robot poses riding
    each plan)."""
    sc = scenario_from_numpy(make_scenario_batch(cfg, batch, base_seed=0, n_valid_people=3),
                             device="cpu")
    poses = []
    for t in range(3):
        i = torch.clamp(torch.full_like(sc.path.n, 4 * t), max=sc.path.n - 1).long()
        pts = torch.gather(sc.path.points, 1, i[:, None, None].expand(-1, 1, 2))[:, 0]
        poses.append(torch.cat([pts, torch.gather(sc.path.yaw, 1, i[:, None])], dim=1))
    return sc, poses


def _ticks(step, cfg, sc, poses, logs=None):
    carry = make_carry(cfg, sc.robot.pose.shape[0], device="cpu")
    out = []
    for pose in poses:
        cmd, aux, carry = step(sc._replace(robot=sc.robot._replace(pose=pose)), carry)
        out.append((cmd, aux, carry))
        if logs is not None:
            logs.append(list(step.tick.width_log))
    return out


def _bits(x):
    ints = {torch.float64: torch.int64, torch.float32: torch.int32}
    return x.view(ints[x.dtype]) if x.dtype in ints else x


def _assert_same_bits(got, want):
    g, w = tree_leaves(tuple(got)), tree_leaves(tuple(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))


@functools.lru_cache(maxsize=None)
def _eager(max_iterations, debug, n_ticks=3):
    cfg = _cfg(max_iterations, debug)
    sc, poses = _batch(cfg, 8)
    return _ticks(make_step_batch(cfg, device="cpu", capture=False), cfg, sc, poses[:n_ticks])


@pytest.mark.parametrize("debug", [False, True])
def test_loop_tick_equals_eager_bit_for_bit(debug):
    """Social B = 8 over three ticks with the carry fed back: the staged
    tick's loops (lm_continue's plain version deciding every body) give
    capture=False's commands, aux and carry bit for bit; with the debug
    trace its columns come from the lanes' own iteration counts, and the
    trace equals the eager tick's positional one bit for bit."""
    cfg = _cfg(debug=debug)
    sc, poses = _batch(cfg, 8)
    step = make_step_batch(cfg, device="cpu")
    assert isinstance(step.tick, graph.GraphTick) and not step.captured
    got = _ticks(step, cfg, sc, poses)
    _assert_same_bits(got, _eager(40, debug))
    if debug:
        assert all(aux.lm_trace.cost.shape == (8, 40) for _, aux, _ in got)
        _assert_same_bits([(c, a._replace(lm_trace=None), k) for c, a, k in got],
                          _eager(40, False))
    prog, = step.tick._programs.values()
    assert prog.lengths == [8] and len(prog.chunks) == 1
    host = step.tick.host_launches
    assert host["graph_replays"] == 0 and host["done_checks"] == 0


def _loop_iterations(iters, max_iterations, check_every):
    """The LM iterations lm_solve's loop runs: a check every check_every
    from iteration 0, until every lane is done (the most iterations any
    lane ran) or the cap."""
    if check_every <= 0:
        return max_iterations
    most = int(iters.max())
    return min(max_iterations, -(-most // check_every) * check_every)


@pytest.mark.parametrize("max_iterations,check_every,lengths", [
    (40, 8, [8]), (40, 0, [40]), (40, 1, [1]), (37, 8, [8, 5])])
def test_loop_iterations_equal_lm_solve(max_iterations, check_every, lengths):
    """The loops (a remainder loop where check_every does not divide the
    cap; check_every = 0: one body of every iteration) give lm_solve's
    outputs and SolveStats.iterations bit for bit, and run as many LM
    iterations (width_log, from the loop's counter) as lm_solve's loop at
    the same check_every."""
    assert tick_graph.loop_lengths(max_iterations, check_every) == lengths
    cfg = _cfg(max_iterations)
    sc, poses = _batch(cfg, 8)
    step = make_step_batch(cfg, device="cpu")
    step.tick.check_every = check_every  # read when a program is built
    logs = []
    got = _ticks(step, cfg, sc, poses[:2], logs)
    want = _eager(max_iterations, False, 2)
    _assert_same_bits(got, want)
    for (_, aux, _), (_, aux_e, _), log in zip(got, want, logs):
        assert torch.equal(aux.solve.iterations, aux_e.solve.iterations)
        n = _loop_iterations(aux_e.solve.iterations, max_iterations, check_every)
        assert log == [8] * n
    prog, = step.tick._programs.values()
    assert prog.lengths == lengths
    # the bodies' runs on the loops' counters: a body of loop k runs
    # lengths[k] iterations, and together they are the ticks' iterations
    runs = prog.counter.stats[2:].tolist()
    assert sum(r * n for r, n in zip(runs, lengths)) == sum(len(log) for log in logs)
    last = prog.last_runs()  # the last tick's, from its iteration count
    assert sum(r * n for r, n in zip(last, lengths)) == len(logs[-1])
    assert all(0 <= r <= k for r, k in zip(last, runs))


@pytest.mark.parametrize("reset,add,need,check_done,slot", [
    (True, 0, 8, True, -1), (False, 8, 8, True, 2), (False, 8, 5, True, 3),
    (False, 0, 5, False, -1), (False, 3, 0, True, 2)])
def test_lm_continue_plain(reset, add, need, check_done, slot):
    """lm_continue's plain version: the tick's iteration count reset or
    advanced, its launches and the body's runs counted, and the loop goes
    on while (no check or a lane is active) and the cap allows `need` more
    iterations."""
    for it0 in (0, 24, 32, 37, 40):
        for done in ([True] * 5, [True, False, True, True, True], [False] * 5):
            stats = torch.tensor([it0, 7, 3, 1], dtype=torch.int64)
            out = torch.full((1,), 9, dtype=torch.int32)
            tick_graph.lm_continue(torch.tensor(done), stats, out, reset, add, need, 37,
                                   check_done, slot)
            it = 0 if reset else it0 + add
            want = [it, 8, 3 + (slot == 2), 1 + (slot == 3)]
            assert stats.tolist() == want
            go = (not check_done or not all(done)) and need > 0 and it + need <= 37
            assert out.tolist() == [int(go)]


def test_trace_by_lane_equals_positional_trace():
    """lm_solve's traced loop with record_trace (the loop's index) and with
    record_trace_by_lane (each lane's iteration count) write the same bits,
    lanes that start done and lanes that reach the cap included."""
    cfg = _cfg(12, debug=True)
    sc, poses = _batch(cfg, 8)
    step = make_step_batch(cfg, device="cpu", capture=False)
    carry = make_carry(cfg, 8, device="cpu")
    want = step(sc._replace(robot=sc.robot._replace(pose=poses[0])), carry)[1].lm_trace
    got = make_step_batch(cfg, device="cpu")(
        sc._replace(robot=sc.robot._replace(pose=poses[0])), carry)[1].lm_trace
    _assert_same_bits(got, want)
    assert bool((got.cost[:, -1] != 0).any())  # some lane ran to the cap


def test_loop_trace_matches_jax_traced_while_loop_f64():
    """float64: the staged debug tick's trace (columns from the lanes'
    iteration counts) against the JAX package's traced lax.while_loop,
    social B = 4 over two ticks, with the trace-parity tolerances (1e-6)."""
    from test_torch_common import assert_step_parity_f64, assert_trace_parity_f64, run_both

    from nav2_social_mpc_controller_tpu.core.config import benchmark_social_config

    def staged(cfg, device, dtype):
        step = make_step_batch(cfg, device=device, dtype=dtype)
        assert isinstance(step.tick, graph.GraphTick) and step.tick.trace_len > 0
        return step

    jcfg = benchmark_social_config()
    jcfg = dataclasses.replace(jcfg, optimizer=dataclasses.replace(
        jcfg.optimizer, debug_optimizer=True))
    for tick, (jax_side, torch_side) in enumerate(
            run_both(jcfg, (3, 1, 0, 2), 2, np.float64, keep_trace=True, make_tstep=staged)):
        assert_step_parity_f64(jax_side, torch_side, tick)
        assert_trace_parity_f64(jax_side, torch_side)


def test_lm_solve_keeps_its_positional_trace():
    """record_trace_by_lane is the graph's; lm_solve (the eager reference)
    keeps record_trace at the loop's index, and the two agree on a solve
    whose lanes finish at different iterations."""
    torch.manual_seed(0)
    b, d = 6, 4
    target = torch.randn(b, d, dtype=torch.float64)
    scale = torch.linspace(0.5, 4.0, b, dtype=torch.float64)[:, None]

    def value_grad(u):
        r = scale * (u - target) + 0.1 * (u - target) ** 3
        jac = scale + 0.3 * (u - target) ** 2
        return 0.5 * (r * r).sum(1), jac * r, torch.diag_embed(jac * jac)

    u0 = torch.zeros(b, d, dtype=torch.float64)
    lo, hi = torch.full_like(u0, -10.0), torch.full_like(u0, 10.0)
    cfg = lm.LMConfig(max_iterations=20)
    _, stats, trace = lm.lm_solve(value_grad, u0, lo, hi, cfg, trace_len=20)
    st = lm.initial_state(value_grad, u0, cfg)
    by_lane = lm.new_trace(u0, 20)
    for _ in range(20):
        st_new, aux = lm.lm_iteration_general(value_grad, lo, hi, cfg, lm.default_linear_solve,
                                              None, st)
        lm.record_trace_by_lane(by_lane, st, aux)
        st = st_new
    assert torch.equal(st.iters, stats.iterations)
    assert len(set(stats.iterations.tolist())) > 1
    _assert_same_bits(by_lane, trace)
