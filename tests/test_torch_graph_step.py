"""The staged tick of ``controller/graph.py`` (make_step_batch's tick as
CUDA graphs on the card) held against the eager tick.

On the CPU the same stages run uncaptured: the head, the LM loops with
their chunks' in-place copy-back (a remainder loop where max_iterations is
no multiple of check_every), the tail, the static input buffers and the
cloned outputs. They must give the eager tick's results bit for bit, with any
check_every, and outputs that alias neither each other nor the buffers; one
float64 case is held against the JAX package's make_step_batch. The debug
tick (debug_optimizer: the general iteration, one loop body for every column, the
trace) is held likewise, against the eager debug tick and the JAX step, and
so is the latent tick (both latent critics, ops/latent.py's evaluation), with
and without the trace, at B = 4 and through make_step at B = 1. The tests
marked ``gpu`` hold the one-launch ticks (a parent graph whose LM solve is
a conditional WHILE node) against the eager ones on the card, and check
that a tick reads nothing of the device:

    python -m pytest tests/test_torch_graph_step.py -q --noconftest -p no:cacheprovider -m gpu
"""

import dataclasses
import functools
import shutil

import numpy as np
import pytest
import torch

from nav2_social_mpc_controller_tpu_torch import _build
from nav2_social_mpc_controller_tpu_torch.controller import graph, tick_graph
from nav2_social_mpc_controller_tpu_torch.controller.controller import (
    make_carry,
    make_step,
    make_step_batch,
)
from nav2_social_mpc_controller_tpu_torch.core import config as C
from nav2_social_mpc_controller_tpu_torch.core.types import scenario_from_numpy, tree_leaves
from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario_batch

torch.set_num_threads(1)

CONFIGS = {
    "social": (C.benchmark_social_config, 3),
    "obstacle": (C.benchmark_obstacle_only_config, 0),
    "stress36": (C.benchmark_stress_h36_config, 3),
}


def _batch(name, batch, device="cpu"):
    """(cfg, scenario batch, per-tick robot poses riding each plan)."""
    make_cfg, n_people = CONFIGS[name]
    cfg = make_cfg()
    sc = scenario_from_numpy(
        make_scenario_batch(cfg, batch, base_seed=0, n_valid_people=n_people), device=device)
    poses = []
    for t in range(3):
        i = torch.clamp(torch.full_like(sc.path.n, 4 * t), max=sc.path.n - 1).long()
        pts = torch.gather(sc.path.points, 1, i[:, None, None].expand(-1, 1, 2))[:, 0]
        poses.append(torch.cat([pts, torch.gather(sc.path.yaw, 1, i[:, None])], dim=1))
    return cfg, sc, poses


def _ticks(step, cfg, sc, poses, device="cpu"):
    """[(cmd, aux, carry)] of len(poses) ticks with the carry fed back."""
    carry = make_carry(cfg, sc.robot.pose.shape[0], device=device)
    out = []
    for pose in poses:
        cmd, aux, carry = step(sc._replace(robot=sc.robot._replace(pose=pose)), carry)
        out.append((cmd, aux, carry))
    return out


def _bits(x):
    """x as integers of its width: equal bits compare equal, NaN too (the
    trace's rho is 0/0 where a lane's step changes nothing)."""
    ints = {torch.float64: torch.int64, torch.float32: torch.int32}
    return x.view(ints[x.dtype]) if x.dtype in ints else x


def _assert_same_bits(got, want):
    g, w = tree_leaves(tuple(got)), tree_leaves(tuple(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))


@functools.lru_cache(maxsize=None)
def _eager(name, batch, n_ticks):
    cfg, sc, poses = _batch(name, batch)
    return _ticks(make_step_batch(cfg, device="cpu", capture=False), cfg, sc, poses[:n_ticks])


@pytest.mark.parametrize("name,batch,n_ticks", [("social", 8, 3), ("obstacle", 8, 3),
                                                ("stress36", 2, 1)])
def test_staged_tick_equals_eager_tick_bit_for_bit(name, batch, n_ticks):
    """make_step_batch's default step on the CPU is the staged tick, run
    uncaptured; with the carry fed back it gives the eager tick's commands,
    aux (status, cursor, iterations, termination, costs, paths, people
    projection) and carry bit for bit (stress36: D = 12, NB = 6)."""
    cfg, sc, poses = _batch(name, batch)
    step = make_step_batch(cfg, device="cpu")
    assert isinstance(step.tick, graph.GraphTick) and not step.captured
    got = _ticks(step, cfg, sc, poses[:n_ticks])
    _assert_same_bits(got, _eager(name, batch, n_ticks))
    host = step.tick.host_launches
    assert host["graph_replays"] == 0  # nothing is captured on the CPU
    assert host["input_copies"] == 17 * n_ticks  # every leaf but the ESDF distances
    assert host["output_clones"] == 18 * n_ticks


@pytest.mark.parametrize("check_every,schedule", [
    (0, [40]), (1, [1]), (4, [4]), (7, [7, 5])])
def test_check_every_changes_no_bit(check_every, schedule):
    """The loops' bodies (a remainder loop of 5 at check_every = 7) and the
    results: the same bits whatever the check policy."""
    assert tick_graph.loop_lengths(40, check_every) == schedule
    cfg, sc, poses = _batch("social", 8)
    got = _ticks(graph.GraphTick(cfg, "cpu", check_every=check_every), cfg, sc, poses[:2])
    _assert_same_bits(got, _eager("social", 8, 3)[:2])


def test_outputs_alias_nothing():
    """Mutating tick 1's outputs leaves tick 2 unchanged, and tick 2 does
    not overwrite tick 1's: every call returns tensors of its own."""
    cfg, sc, poses = _batch("social", 8)
    step = make_step_batch(cfg, device="cpu")
    carry = make_carry(cfg, 8, device="cpu")
    first = step(sc._replace(robot=sc.robot._replace(pose=poses[0])), carry)
    kept = [x.clone() for x in tree_leaves(first)]
    second = step(sc._replace(robot=sc.robot._replace(pose=poses[1])), first[2])
    for a, b in zip(tree_leaves(first), kept):
        assert torch.equal(a, b)  # tick 2 wrote nothing into tick 1's outputs
    prog, = step.tick._programs.values()
    buffers = {x.data_ptr() for x in tree_leaves((prog.scenario, prog.carry))}
    ptrs = [x.data_ptr() for x in tree_leaves((first, second)) if x.numel()]
    assert len(set(ptrs)) == len(ptrs) and not buffers & set(ptrs)
    want = [x.clone() for x in tree_leaves(second)]
    for x in tree_leaves(first):
        if x.dtype == torch.bool:
            x.logical_not_()
        else:
            x.add_(1)
    for a, b in zip(tree_leaves(second), want):
        assert torch.equal(a, b)


def test_a_program_per_input_signature():
    """A new batch width gets its own program; the same signature reuses
    it; B = 1 through make_step is the staged tick too."""
    cfg, sc, poses = _batch("social", 4)
    step = make_step_batch(cfg, device="cpu")
    _ticks(step, cfg, sc, poses[:1])
    _ticks(step, cfg, sc, poses[1:2])
    assert len(step.tick._programs) == 1
    _ticks(step, cfg, type(sc)(*(_head(x, 2) for x in sc)), [poses[0][:2]])
    assert len(step.tick._programs) == 2
    single = make_step(cfg, device="cpu")
    assert isinstance(single.tick, graph.GraphTick) and not single.captured


def _head(tree, n):
    return type(tree)(*(_head(x, n) if isinstance(x, tuple) else x[:n] for x in tree))


def test_capture_is_decided_by_the_config():
    """Every config gets the staged tick: the four benchmark configs, with
    the debug trace too, and a config with latent critics (its evaluation
    ops/latent.py's LatentValueGrad), with the debug trace too; only
    capture=False runs the eager tick."""
    for make_cfg in (C.benchmark_social_config, C.benchmark_obstacle_only_config,
                     C.benchmark_omni_6agents_config, C.benchmark_stress_h36_config):
        for c in (make_cfg(), _debug(make_cfg()), _latent(make_cfg())):
            assert isinstance(make_step_batch(c, device="cpu").tick, graph.GraphTick)
    cfg = C.benchmark_social_config()
    for c in (cfg, _debug(cfg), _latent(cfg), _debug(_latent(cfg))):
        assert isinstance(graph.GraphTick(c, "cpu"), graph.GraphTick)
        assert not isinstance(make_step_batch(c, device="cpu", capture=False).tick,
                              graph.GraphTick)


def _debug(cfg):
    return dataclasses.replace(
        cfg, optimizer=dataclasses.replace(cfg.optimizer, debug_optimizer=True))


def _latent(cfg, pure_angle_weight=0.5, curvature_weight=0.3):
    """cfg with both latent critics on."""
    w = dataclasses.replace(cfg.optimizer.weights, pure_angle_weight=pure_angle_weight,
                            curvature_weight=curvature_weight)
    return dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer, weights=w))


@functools.lru_cache(maxsize=None)
def _eager_latent(name, batch, n_ticks, debug=False):
    cfg, sc, poses = _batch(name, batch)
    lat = _debug(_latent(cfg)) if debug else _latent(cfg)
    return _ticks(make_step_batch(lat, device="cpu", capture=False), lat, sc, poses[:n_ticks])


def test_staged_latent_tick_equals_eager_latent_tick_bit_for_bit():
    """With both latent critics the staged tick runs ops/latent.py's
    evaluation in its head and chunks; social B = 4 over two ticks with the
    carry fed back, it gives the eager latent tick's results bit for bit,
    and these differ from the tick without the latent critics."""
    cfg, sc, poses = _batch("social", 4)
    lat = _latent(cfg)
    step = make_step_batch(lat, device="cpu")
    assert isinstance(step.tick, graph.GraphTick) and not step.captured
    got = _ticks(step, lat, sc, poses[:2])
    _assert_same_bits(got, _eager_latent("social", 4, 2))
    assert not torch.equal(got[0][0].angular_z, _eager("social", 4, 1)[0][0].angular_z)


def test_single_robot_latent_tick_equals_eager_bit_for_bit():
    """make_step (one robot, B = 1) with the latent critics: the staged
    tick equals the eager one bit for bit, seed by seed, over two ticks."""
    cfg, sc, poses = _batch("social", 2)
    lat = _latent(cfg)
    steps = {capture: make_step(lat, device="cpu", capture=capture) for capture in (False, True)}
    assert isinstance(steps[True].tick, graph.GraphTick) and not steps[True].captured
    for i in range(2):
        res = {}
        for capture, step in steps.items():
            carry, res[capture] = make_carry(lat, device="cpu"), []
            for pose in poses[:2]:
                one = _lane(sc._replace(robot=sc.robot._replace(pose=pose)), i)
                cmd, aux, carry = step(one, carry)
                res[capture].append((cmd, aux, carry))
        _assert_same_bits(res[True], res[False])


def _lane(tree, i):
    return type(tree)(*(_lane(x, i) if isinstance(x, tuple) else x[i] for x in tree))


def test_staged_debug_latent_tick_equals_eager_bit_for_bit():
    """debug_optimizer with the latent critics: the staged tick (the general
    iteration in one loop body, the trace) equals the eager debug
    latent tick bit for bit, trace included, and its results without the
    trace equal the staged latent tick's (the general iteration repeats the
    default one's arithmetic)."""
    cfg, sc, poses = _batch("social", 4)
    lat = _debug(_latent(cfg))
    step = make_step_batch(lat, device="cpu")
    assert isinstance(step.tick, graph.GraphTick) and step.tick.trace_len == 40
    got = _ticks(step, lat, sc, poses[:2])
    _assert_same_bits(got, _eager_latent("social", 4, 2, debug=True))
    assert all(aux.lm_trace.cost.shape == (4, 40) for _, aux, _ in got)
    for (cmd, aux, carry), plain in zip(got, _eager_latent("social", 4, 2)):
        _assert_same_bits((cmd, aux._replace(lm_trace=None), carry), plain)


@functools.lru_cache(maxsize=None)
def _eager_debug(name, batch, n_ticks):
    cfg, sc, poses = _batch(name, batch)
    return _ticks(make_step_batch(_debug(cfg), device="cpu", capture=False), cfg, sc,
                  poses[:n_ticks])


@pytest.mark.parametrize("name,batch,n_ticks", [("social", 8, 3), ("stress36", 2, 1)])
def test_staged_debug_tick_equals_eager_debug_tick_bit_for_bit(name, batch, n_ticks):
    """With debug_optimizer the staged tick runs the general iteration in
    one loop body, whose lanes write the trace columns of their own
    iteration counts; with the carry fed back it gives the eager debug
    tick's results bit for bit, the (B, max_iterations) trace included, and
    those of the staged plain tick (the general iteration repeats the
    default one's arithmetic)."""
    cfg, sc, poses = _batch(name, batch)
    step = make_step_batch(_debug(cfg), device="cpu")
    assert isinstance(step.tick, graph.GraphTick) and step.tick.trace_len == 40
    got = _ticks(step, cfg, sc, poses[:n_ticks])
    want = _eager_debug(name, batch, n_ticks)
    _assert_same_bits(got, want)
    assert all(aux.lm_trace.cost.shape == (batch, 40) for _, aux, _ in got)
    prog, = step.tick._programs.values()
    assert prog.lengths == [8] and len(prog.chunks) == 1  # 40 iterations, a check every 8
    for (cmd, aux, carry), (cmd_p, aux_p, carry_p) in zip(got, _eager(name, batch, n_ticks)):
        _assert_same_bits((cmd, aux._replace(lm_trace=None), carry), (cmd_p, aux_p, carry_p))
    host = step.tick.host_launches
    assert host["output_clones"] == 25 * n_ticks  # the plain tick's 18 and 7 trace leaves


def test_staged_debug_tick_matches_jax_step_f64():
    """float64: the staged debug tick against the JAX package's
    make_step_batch with debug_optimizer, social B = 2, one tick, with
    tests/test_torch_step_debug.py's tolerances (trace included)."""
    from test_torch_common import assert_step_parity_f64, assert_trace_parity_f64, run_both

    from nav2_social_mpc_controller_tpu.core.config import benchmark_social_config

    def staged(cfg, device, dtype):
        step = make_step_batch(cfg, device=device, dtype=dtype)
        assert isinstance(step.tick, graph.GraphTick) and step.tick.trace_len > 0
        return step

    (jax_side, torch_side), = run_both(_debug(benchmark_social_config()), (3, 1), 1, np.float64,
                                       keep_trace=True, make_tstep=staged)
    assert_step_parity_f64(jax_side, torch_side, 0)
    assert_trace_parity_f64(jax_side, torch_side)


def test_staged_tick_matches_jax_step_f64():
    """float64: the staged tick against the JAX package's make_step_batch,
    social B = 4 over 2 ticks, within the 1e-6 of the step-parity tests."""
    from test_torch_common import assert_step_parity_f64, run_both

    from nav2_social_mpc_controller_tpu.core.config import benchmark_social_config

    def staged(cfg, device, dtype):
        step = make_step_batch(cfg, device=device, dtype=dtype)
        assert isinstance(step.tick, graph.GraphTick)
        return step

    for tick, (jax_side, torch_side) in enumerate(
            run_both(benchmark_social_config(), (3, 3, 0, 2), 2, np.float64, make_tstep=staged)):
        assert_step_parity_f64(jax_side, torch_side, tick)


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when a test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the CUDA kernels have no CPU mode")
    if shutil.which("nvcc") is None:
        _build.find_nvcc()  # raises with the reason when there is no toolkit
    return torch.device("cuda")


def _assert_same_counts(captured, eager):
    """The one-launch tick's kernel launch counts (tallied from the device's
    loop counter) equal the eager tick's; lm_continue, the loop's own
    kernel, runs in the captured tick only."""
    assert captured["lm_continue"] > 0 and eager["lm_continue"] == 0
    assert {k: n for k, n in captured.items() if k != "lm_continue"} == \
        {k: n for k, n in eager.items() if k != "lm_continue"}


@pytest.mark.gpu
@pytest.mark.parametrize("name,batch,n_ticks", [("social", 64, 3), ("stress36", 16, 1)])
def test_captured_tick_equals_eager_tick_on_the_card(card, name, batch, n_ticks):
    """On the card make_step_batch launches one CUDA graph a tick, its LM
    solve a loop on the device; its results equal the eager tick's bit for
    bit, and the kernel launch counts (the chunk's tally times the loop
    body's runs, read from the device) equal the eager tick's."""
    cfg, sc, poses = _batch(name, batch, device=card)
    counts = {}
    outs = {}
    for capture in (False, True):
        step = make_step_batch(cfg, device=card, capture=capture)
        assert step.captured == capture
        _build.reset_launch_counts()
        outs[capture] = _ticks(step, cfg, sc, poses[:n_ticks], device=card)
        torch.cuda.synchronize()
        counts[capture] = dict(_build.launch_counts)
    _assert_same_bits(outs[True], outs[False])
    _assert_same_counts(counts[True], counts[False])
    assert counts[True]["propose"] > 0 and counts[True]["sfm_scan"] == n_ticks


@pytest.mark.gpu
@pytest.mark.parametrize("name,batch,n_ticks", [("social", 64, 3), ("stress36", 16, 1)])
def test_captured_debug_tick_equals_eager_debug_tick_on_the_card(card, name, batch, n_ticks):
    """On the card the debug tick is one graph launch too; its results equal
    the eager debug tick's bit for bit, trace included, and the kernel
    launch counts (K7's damped step, no K3 or K4) the eager tick's."""
    cfg, sc, poses = _batch(name, batch, device=card)
    counts = {}
    outs = {}
    for capture in (False, True):
        step = make_step_batch(_debug(cfg), device=card, capture=capture)
        assert step.captured == capture
        _build.reset_launch_counts()
        outs[capture] = _ticks(step, cfg, sc, poses[:n_ticks], device=card)
        torch.cuda.synchronize()
        counts[capture] = dict(_build.launch_counts)
    _assert_same_bits(outs[True], outs[False])
    _assert_same_counts(counts[True], counts[False])
    assert counts[True]["spd_solve"] > 0 and counts[True]["propose"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("name,batch,n_ticks,debug", [
    ("social", 64, 3, False), ("stress36", 16, 1, False), ("social", 64, 2, True)])
def test_captured_latent_tick_equals_eager_latent_tick_on_the_card(card, name, batch, n_ticks,
                                                                  debug):
    """On the card the latent tick (both latent critics; with debug the
    general iteration and its trace) is one graph launch; its results equal
    the eager latent tick's bit for bit and the kernel launch counts the
    eager tick's: an evaluation launches rollout_sample once and K2 once,
    the standalone K1 never. B = 1 through make_step likewise."""
    cfg, sc, poses = _batch(name, batch, device=card)
    lat = _debug(_latent(cfg)) if debug else _latent(cfg)
    counts = {}
    outs = {}
    for capture in (False, True):
        step = make_step_batch(lat, device=card, capture=capture)
        assert step.captured == capture
        _build.reset_launch_counts()
        outs[capture] = _ticks(step, lat, sc, poses[:n_ticks], device=card)
        torch.cuda.synchronize()
        counts[capture] = dict(_build.launch_counts)
    _assert_same_bits(outs[True], outs[False])
    _assert_same_counts(counts[True], counts[False])
    assert counts[True]["rollout_sample"] == counts[True]["fused_iter"] > 0
    assert counts[True]["bicubic"] == 0 and counts[True]["rollout_prep"] == 0
    if debug:
        return
    single = {}
    for capture in (False, True):
        step = make_step(lat, device=card, capture=capture)
        assert step.captured == capture
        carry, single[capture] = make_carry(lat, device=card), []
        for pose in poses[:2]:
            cmd, aux, carry = step(_lane(sc._replace(robot=sc.robot._replace(pose=pose)), 0),
                                   carry)
            single[capture].append((cmd, aux, carry))
    _assert_same_bits(single[True], single[False])


@pytest.mark.gpu
def test_capture_holds_the_garbage_collector_off(card, monkeypatch):
    """A dead captured step (its tick and programs refer to each other, so
    only the cyclic collector frees them) collected during another capture
    destroys its graphs mid-capture, which invalidates that capture; so
    every capture of a staged tick runs with the collector held off, and
    the step it captures equals the eager tick."""
    import gc

    cfg, sc, poses = _batch("social", 8, device=card)

    def leave_a_dead_step():
        _ticks(make_step_batch(cfg, device=card), cfg, sc, poses[:1], device=card)

    leave_a_dead_step()
    with pytest.raises(Exception, match="capture"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            torch.ones(4, device=card).mul_(2)
            gc.collect()  # the hazard itself
    leave_a_dead_step()
    seen = []
    begin = torch.cuda.CUDAGraph.capture_begin

    def capture_begin(self, *args, **kwargs):
        seen.append(gc.isenabled())
        return begin(self, *args, **kwargs)

    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin", capture_begin)
    step = make_step_batch(cfg, device=card)
    got = _ticks(step, cfg, sc, poses[:1], device=card)
    assert step.captured and len(seen) == 3 and not any(seen)  # head, chunk, tail
    want = _ticks(make_step_batch(cfg, device=card, capture=False), cfg, sc, poses[:1],
                  device=card)
    _assert_same_bits(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("debug", [False, True])
def test_one_launch_tick_reads_nothing_of_the_device(card, debug):
    """After the first tick (capture, and the window check of new buffers),
    a tick is the input copies, one graph launch and the output clones:
    social B = 64 over three ticks inside torch.cuda.set_sync_debug_mode
    ("error"), where a hidden synchronisation raises; host_launches counts
    one launch and nothing else a tick, the loop's counters say how many
    LM iterations ran, and the results equal capture=False's."""
    cfg, sc, poses = _batch("social", 64, device=card)
    cfg = _debug(cfg) if debug else cfg
    step = make_step_batch(cfg, device=card)
    carry = make_carry(cfg, 64, device=card)
    first = step(sc._replace(robot=sc.robot._replace(pose=poses[0])), carry)
    step.tick.reset_host_launches()
    got = [first]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for pose in poses[1:]:
            got.append(step(sc._replace(robot=sc.robot._replace(pose=pose)), got[-1][2]))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    host = step.tick.host_launches
    assert host == {"graph_replays": 2, "input_copies": 2 * 17, "output_clones":
                    2 * (25 if debug else 18)}
    prog, = step.tick._programs.values()
    log, runs = step.tick.width_log, step.tick.body_runs  # read from the device
    assert set(log) == {64} and len(log) % 8 == 0 and 0 < len(log) <= 40
    assert len(log) <= 8 * runs <= 2 * 40  # two ticks of bodies of 8 iterations
    assert int(got[-1][1].solve.iterations.max()) <= len(log)
    types = prog.parent.node_types()
    assert types["conditional"] == 1 and types["kernel"] > 100
    want = _ticks(make_step_batch(cfg, device=card, capture=False), cfg, sc, poses, device=card)
    _assert_same_bits(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("debug", [False, True])
def test_single_robot_one_launch_tick_on_the_card(card, debug):
    """make_step (B = 1): the one-launch tick equals capture=False bit for
    bit, seed by seed over two ticks, with and without the debug trace."""
    cfg, sc, poses = _batch("social", 2, device=card)
    cfg = _debug(cfg) if debug else cfg
    steps = {capture: make_step(cfg, device=card, capture=capture) for capture in (False, True)}
    assert steps[True].captured and not steps[False].captured
    for i in range(2):
        res = {}
        for capture, step in steps.items():
            carry, res[capture] = make_carry(cfg, device=card), []
            for pose in poses[:2]:
                cmd, aux, carry = step(_lane(sc._replace(robot=sc.robot._replace(pose=pose)), i),
                                       carry)
                res[capture].append((cmd, aux, carry))
        _assert_same_bits(res[True], res[False])
