"""The staged compacted tick of ``controller/graph_compacted.py``
(make_step_batch_compacted's tick as one parent graph launch on the card)
held against the eager compacted tick.

On the CPU the same stages run uncaptured, on the device schedule's plain
conditions: the head, the chunks at each rung of the width ladder, the
transitions between rungs, the scatter back and the tail. They must give the eager compacted tick's results bit for bit in
float64 and float32 (both gather the same lanes into the same widths), with
the widths the eager solver ran, for a check that drops the active count
past two rungs at once, for any check_every and for each input signature.
The latent tick (both latent critics: rungs of LatentValueGrad.select-ed
data) is held likewise. The tests marked ``gpu`` hold the captured compacted
tick against the eager compacted tick and the captured plain tick on the
card, and the captured compacted latent tick against the eager one:

    python -m pytest tests/test_torch_graph_compacted.py -q --noconftest -p no:cacheprovider -m gpu
"""

import dataclasses
import functools
import shutil

import numpy as np
import pytest
import torch

from nav2_social_mpc_controller_tpu_torch import _build
from nav2_social_mpc_controller_tpu_torch.controller.controller import (
    CompactedTick,
    StepFunction,
    make_carry,
    make_step_batch,
    make_step_batch_compacted,
    step_pre,
)
from nav2_social_mpc_controller_tpu_torch.controller.graph_compacted import CompactedGraphTick
from nav2_social_mpc_controller_tpu_torch.controller.optimize import build_value_grad, make_lm_config
from nav2_social_mpc_controller_tpu_torch.core import types as T
from nav2_social_mpc_controller_tpu_torch.core.config import benchmark_social_config
from nav2_social_mpc_controller_tpu_torch.solver.batched import (
    compacted_capacity,
    lm_solve_batch_compacted,
    width_ladder,
)
from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario_batch

torch.set_num_threads(1)

N_TICKS = 3


def _warm_cfg():
    cfg = benchmark_social_config()
    return dataclasses.replace(
        cfg, optimizer=dataclasses.replace(cfg.optimizer, warm_start_mode="previous_solution"))


def _scenarios(batch, dtype, device="cpu"):
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    sc = make_scenario_batch(_warm_cfg(), batch, 0, n_valid_people=3, grid_hw=(64, 64),
                             dtype=np_dtype)
    return T.scenario_from_numpy(sc, device=device, dtype=dtype)


def _ticks(step, batch, dtype, n_ticks=N_TICKS, device="cpu", cfg=None):
    """[(cmd, aux, carry, width_log)] of n_ticks warm ticks with the carry fed
    back (the same poses: from the second tick on most lanes start near
    their optimum and converge early); `cfg` sizes the carry (default
    _warm_cfg())."""
    sc = _scenarios(batch, dtype, device)
    carry = make_carry(cfg or _warm_cfg(), batch, device=device, dtype=dtype)
    out = []
    for _ in range(n_ticks):
        cmd, aux, carry = step(sc, carry)
        out.append((cmd, aux, carry, list(step.tick.width_log)))
    return out


@functools.lru_cache(maxsize=None)
def _eager(batch, capacity_frac, dtype):
    step = make_step_batch_compacted(_warm_cfg(), capacity_frac, device="cpu", dtype=dtype,
                                     capture=False)
    return _ticks(step, batch, dtype)


def _eager_widths(batch, capacity_frac, dtype, check_every):
    """The eager solver's widths of each of _eager's ticks at check_every:
    lm_solve_batch_compacted on each tick's problems (the results do not
    depend on check_every, so each tick starts from _eager's carry)."""
    cfg = _warm_cfg()
    sc = _scenarios(batch, dtype)
    carries = [make_carry(cfg, batch, device="cpu", dtype=dtype)]
    carries += [c for _, _, c, _ in _eager(batch, capacity_frac, dtype)[:-1]]
    out = []
    with torch.no_grad():
        for carry in carries:
            prep = step_pre(cfg, sc, carry).prep
            log = []
            lm_solve_batch_compacted(
                build_value_grad(cfg, prep), prep.u0, prep.lower, prep.upper,
                make_lm_config(cfg.optimizer), compacted_capacity(batch, capacity_frac),
                check_every=check_every, width_log=log)
            out.append(log)
    return out


def _assert_same(got, want):
    """Every leaf bit for bit, and the widths."""
    g, w = T.tree_leaves(tuple(got[:3])), T.tree_leaves(tuple(want[:3]))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    assert got[3] == want[3]


def _jumps(log, widths):
    """The number of rungs each change of width in `log` went down."""
    return [widths.index(b) - widths.index(a) for a, b in zip(log, log[1:]) if a != b]


CASES = [(12, 0.25), (16, 0.125)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("batch,capacity_frac", CASES, ids=["B12_cap0.25", "B16_cap0.125"])
def test_staged_compacted_tick_equals_eager_bit_for_bit(batch, capacity_frac, dtype):
    """make_step_batch_compacted's default step on the CPU is the staged
    tick, run uncaptured; over three warm ticks with the carry fed back it
    gives the eager compacted tick's commands, aux, carry and widths bit for
    bit, and it descends the ladder."""
    step = make_step_batch_compacted(_warm_cfg(), capacity_frac, device="cpu", dtype=dtype)
    assert isinstance(step.tick, CompactedGraphTick) and not step.captured
    got = _ticks(step, batch, dtype)
    want = _eager(batch, capacity_frac, dtype)
    for g, w in zip(got, want):
        _assert_same(g, w)
    assert min(got[-1][3]) < batch  # the last tick ran below full width
    host = step.tick.host_launches
    assert host["graph_replays"] == 0  # nothing is captured on the CPU
    assert host["input_copies"] == 17 * N_TICKS and host["output_clones"] == 18 * N_TICKS


def test_a_check_past_two_rungs():
    """float32, B = 16 at capacity 0.125 (ladder [8, 4, 2]): on the third
    tick one check finds at most two lanes active at full width. The eager
    solver jumps 16 -> 2; the staged tick replays the transitions 16 -> 8
    -> 4 -> 2 one after the other and gathers the same lanes in the same
    order, so the bits and the widths are the eager solver's."""
    widths = [16] + width_ladder(16, 2)
    log = _eager(16, 0.125, torch.float32)[-1][3]
    assert 3 in _jumps(log, widths), log
    step = make_step_batch_compacted(_warm_cfg(), 0.125, device="cpu", dtype=torch.float32)
    got = _ticks(step, 16, torch.float32)
    _assert_same(got[-1], _eager(16, 0.125, torch.float32)[-1])
    prog, = step.tick._programs.values()
    assert prog.widths == widths and len(prog.transitions) == 3


@pytest.mark.parametrize("check_every", [1, 8])
def test_check_every_changes_no_bit(check_every):
    """The check policy moves where the ladder descends (the widths
    are the eager solver's at the same check_every), never a result."""
    tick = CompactedGraphTick(_warm_cfg(), 0.25, "cpu", check_every=check_every)
    got = _ticks(StepFunction(tick, tick), 12, torch.float64)
    for g, w in zip(got, _eager(12, 0.25, torch.float64)):
        _assert_same(g[:3] + (None,), w[:3] + (None,))
    assert [g[3] for g in got] == _eager_widths(12, 0.25, torch.float64, check_every)


def test_a_program_per_input_signature():
    """A new batch width gets its own program, with its own ladder; the
    same signature reuses it; each equals the eager tick."""
    step = make_step_batch_compacted(_warm_cfg(), 0.25, device="cpu", dtype=torch.float64)
    for batch in (12, 16, 12):
        got = _ticks(step, batch, torch.float64, n_ticks=1)
        want = _ticks(make_step_batch_compacted(
            _warm_cfg(), 0.25, device="cpu", dtype=torch.float64, capture=False),
            batch, torch.float64, n_ticks=1)
        _assert_same(got[0], want[0])
    assert sorted(p.widths for p in step.tick._programs.values()) == [[12, 6, 3], [16, 8, 4]]


def test_compacted_capture_is_decided_by_the_config():
    """Every config gets the staged compacted tick, one with latent critics
    too; capture=False runs the eager compacted tick; debug_optimizer is
    refused either way; a batch too narrow for the capacity raises as the
    eager solver does."""
    cfg = _warm_cfg()
    latent = _latent(cfg)
    for c in (cfg, latent):
        assert isinstance(make_step_batch_compacted(c, device="cpu").tick, CompactedGraphTick)
        assert isinstance(make_step_batch_compacted(c, device="cpu", capture=False).tick,
                          CompactedTick)
    assert isinstance(CompactedGraphTick(latent, 0.25, "cpu"), CompactedGraphTick)
    debug = dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer,
                                                                   debug_optimizer=True))
    for capture in (False, True):
        with pytest.raises(ValueError, match="debug_optimizer"):
            make_step_batch_compacted(debug, device="cpu", capture=capture)
    with pytest.raises(ValueError, match="capacity"):
        _ticks(make_step_batch_compacted(cfg, 0.25, device="cpu", dtype=torch.float64),
               1, torch.float64, n_ticks=1)


def _latent(cfg):
    """cfg with both latent critics on."""
    w = dataclasses.replace(cfg.optimizer.weights, pure_angle_weight=0.5, curvature_weight=0.3)
    return dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer, weights=w))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_staged_compacted_latent_tick_equals_eager_bit_for_bit(dtype):
    """With both latent critics the rungs hold LatentValueGrad.select-ed
    data: over three warm ticks (B = 12 at capacity 0.25, ladder [6, 3]) the
    staged compacted latent tick gives the eager compacted latent tick's
    results and widths bit for bit, and descends the ladder. In float64 both
    equal the plain latent tick's results (make_step_batch)."""
    lat = _latent(_warm_cfg())
    batch = 12
    runs = {}
    for kind, step in (
            ("staged", make_step_batch_compacted(lat, 0.25, device="cpu", dtype=dtype)),
            ("eager", make_step_batch_compacted(lat, 0.25, device="cpu", dtype=dtype,
                                                capture=False))):
        runs[kind] = _ticks(step, batch, dtype, cfg=lat)
    for got, want in zip(runs["staged"], runs["eager"]):
        _assert_same(got, want)
    assert min(runs["staged"][-1][3]) < batch
    if dtype == torch.float64:
        plain = _ticks(make_step_batch(lat, device="cpu", dtype=dtype), batch, dtype, cfg=lat)
        for got, want in zip(runs["staged"], plain):
            _assert_same(got[:3] + (None,), want[:3] + (None,))


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when a test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the CUDA kernels have no CPU mode")
    if shutil.which("nvcc") is None:
        _build.find_nvcc()  # raises with the reason when there is no toolkit
    return torch.device("cuda")


@pytest.mark.gpu
def test_captured_compacted_tick_on_the_card(card):
    """On the card make_step_batch_compacted's tick is one parent graph
    launch; over three warm ticks its results equal the eager compacted
    tick's and the captured plain tick's bit for bit (every kernel works
    scenario by scenario), its widths the eager tick's, and its kernel
    launch counts the eager compacted tick's, but for the schedule's own
    compact_continue."""
    batch, dtype = 256, torch.float32
    runs, counts = {}, {}
    for name, make in (
            ("eager", lambda: make_step_batch_compacted(_warm_cfg(), device=card, capture=False)),
            ("captured", lambda: make_step_batch_compacted(_warm_cfg(), device=card)),
            ("plain", lambda: make_step_batch(_warm_cfg(), device=card))):
        step = make()
        assert step.captured == (name != "eager")
        _build.reset_launch_counts()
        runs[name] = _ticks(step, batch, dtype, device=card)
        torch.cuda.synchronize()
        counts[name] = dict(_build.launch_counts)
    for got, want, plain in zip(runs["captured"], runs["eager"], runs["plain"]):
        _assert_same(got, want)
        _assert_same(got[:3] + (None,), plain[:3] + (None,))
    assert counts["captured"].pop("compact_continue") > 0  # the schedule's checks
    assert counts["eager"].pop("compact_continue") == 0
    assert counts["captured"] == counts["eager"] and counts["captured"]["propose"] > 0
    assert min(runs["captured"][-1][3]) < batch


@pytest.mark.gpu
def test_captured_compacted_latent_tick_on_the_card(card):
    """The compacted latent tick on the card: over three warm ticks the
    captured one equals the eager one bit for bit, widths and kernel launch
    counts included (rollout_sample and K2 once an evaluation, the
    standalone K1 never)."""
    lat = _latent(_warm_cfg())
    batch, dtype = 256, torch.float32
    runs, counts = {}, {}
    for capture in (False, True):
        step = make_step_batch_compacted(lat, device=card, capture=capture)
        assert step.captured == capture
        _build.reset_launch_counts()
        runs[capture] = _ticks(step, batch, dtype, device=card, cfg=lat)
        torch.cuda.synchronize()
        counts[capture] = dict(_build.launch_counts)
    for got, want in zip(runs[True], runs[False]):
        _assert_same(got, want)
    assert counts[True].pop("compact_continue") > 0 and counts[False].pop("compact_continue") == 0
    assert counts[True] == counts[False]
    assert counts[True]["rollout_sample"] == counts[True]["fused_iter"] > 0
    assert counts[True]["bicubic"] == 0
