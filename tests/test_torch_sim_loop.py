"""The simulator's campaign as one launch (``runtime/simulator.py:
_SimProgram``) run on the CPU.

On the card a staged campaign of T ticks is the input copies, one launch of
a parent graph and the result clones: lm_continue counts the ticks (no done
check) and a WHILE node's body holds a tick, the step's own nodes with its
LM loops nested, the hand-off of its outputs into the world's buffers and
the world update. On the CPU the same loop runs in Python on lm_continue's
plain version, on the same buffers. These tests hold it against the
reference loop (``capture=False``) bit for bit in float32 and float64 over
a run length that is no multiple of the LM loop's check_every, against the
JAX package's make_simulate in float64 within the 1e-6 of
tests/test_torch_simulator.py, and count its host operations, which do not
depend on T. The ``gpu`` test holds the one-launch campaign against the
reference loop on the card:

    python -m pytest tests/test_torch_sim_loop.py -q --noconftest -p no:cacheprovider -m gpu
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from nav2_social_mpc_controller_tpu_torch import _build
from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry
from nav2_social_mpc_controller_tpu_torch.core import config as C
from nav2_social_mpc_controller_tpu_torch.core.config import config_from_dict
from nav2_social_mpc_controller_tpu_torch.core.types import scenario_from_numpy, tree_leaves
from nav2_social_mpc_controller_tpu_torch.runtime.simulator import SimResult, Simulator, simulate
from nav2_social_mpc_controller_tpu_torch.solver.lm import DEFAULT_CHECK_EVERY
from nav2_social_mpc_controller_tpu_torch.utils.scenarios import (
    make_scenario_batch,
    stack_scenarios,
)

torch.set_num_threads(1)  # float32 bits across stagings need one intra-op thread

T_ODD = 5  # ticks: no multiple of the LM loop's check_every
assert T_ODD % DEFAULT_CHECK_EVERY


def _batch(make_cfg, batch, n_people, dtype):
    cfg = make_cfg()
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return cfg, make_scenario_batch(cfg, batch, base_seed=2, n_valid_people=n_people,
                                    dtype=np_dtype)


def _same_bits(got, want):
    assert got._fields == want._fields == SimResult._fields
    for field, a, b in zip(got._fields, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert torch.equal(a, b), field


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_campaign_loop_equals_the_reference_loop_bit_for_bit(dtype):
    """Social, three scenarios with people, T_ODD ticks: the staged
    campaign's SimResult is the reference loop's bit for bit; its loop over
    ticks checked T + 1 times and ran T bodies; the step took no host
    operation of its own, and its last tick's LM iterations are the
    reference's."""
    cfg, sc = _batch(C.benchmark_social_config, 3, 3, dtype)
    sims = {capture: Simulator(cfg, T_ODD, device="cpu", dtype=dtype, capture=capture)
            for capture in (True, False)}
    got, want = sims[True](sc), sims[False](sc)
    _same_bits(got, want)
    prog, = sims[True]._programs.values()
    assert prog.counter.stats.tolist() == [T_ODD, T_ODD + 1, T_ODD]
    assert all(n == 0 for n in sims[True].step.tick.host_launches.values())
    assert sims[True].step.tick.width_log == sims[False].step.tick.width_log
    assert len(sims[True].step.tick.width_log) > 0


def test_host_operations_do_not_depend_on_the_run_length():
    """Obstacle, two scenarios, 2 and 7 ticks: a staged campaign's host
    operations are the same for both, each equal to the reference loop."""
    cfg, sc = _batch(C.benchmark_obstacle_only_config, 2, 0, torch.float64)
    host = []
    for n_ticks in (2, 7):
        sim = Simulator(cfg, n_ticks, device="cpu", dtype=torch.float64)
        _same_bits(sim(sc), simulate(cfg, sc, n_ticks, device="cpu", dtype=torch.float64,
                                     capture=False))
        host.append(dict(sim.host_launches))
    # in: the scenario, the first carry, the histories' first rows, the
    # tick counter's reset; out: the six result tensors
    n_in = len(tree_leaves(scenario_from_numpy(sc, device="cpu", dtype=torch.float64)))
    n_in += len(tree_leaves(make_carry(cfg, 2, device="cpu", dtype=torch.float64))) + 3
    assert host[0] == host[1] == {"graph_replays": 0, "input_copies": n_in, "output_clones": 6}


def test_campaign_matches_jax_f64():
    """Two social scenarios with people, 9 ticks (more than a chunk of LM
    iterations' worth, no multiple of it), against the JAX package's
    make_simulate (vmapped) within 1e-6; JAX is imported here: the gpu test
    runs where it need not be installed."""
    import jax

    from nav2_social_mpc_controller_tpu.core import config as jconfig
    from nav2_social_mpc_controller_tpu.runtime.simulator import (
        make_simulate as jax_make_simulate,
    )
    from nav2_social_mpc_controller_tpu.utils.scenarios import make_scenario as jax_make_scenario

    jcfg = jconfig.benchmark_social_config()
    sc = stack_scenarios([jax_make_scenario(jcfg, seed=s, n_valid_people=3, path_kind="straight",
                                            dtype=np.float64) for s in (4, 6)])
    want = jax.vmap(jax_make_simulate(jcfg, n_ticks=9))(sc)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    got = simulate(cfg, sc, 9, device="cpu", dtype=torch.float64)
    for field in SimResult._fields:
        a, b = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert a.shape == b.shape, field
        if field == "status":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=field)


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when a test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the CUDA kernels have no CPU mode")
    if shutil.which("nvcc") is None:
        _build.find_nvcc()  # raises with the reason when there is no toolkit
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["social", "obstacle"])
def test_one_launch_campaign_on_the_card(card, name):
    """64 scenarios, 3 and 6 ticks: a staged campaign is one graph launch
    whose SimResult equals the reference loop's bit for bit; a second
    campaign (the first captures) runs with no hidden synchronisation
    (torch.cuda.set_sync_debug_mode("error")) and the same host operations
    at both run lengths; the step itself launches nothing from the host;
    the kernels are the reference loop's, the loop over ticks adding its
    T + 1 lm_continue checks; the parent graph nests the step's LM loops in
    the loop over ticks; the step's program builds a parent graph of its
    own only when a tick of it runs alone."""
    make_cfg, n_people = {"social": (C.benchmark_social_config, 3),
                          "obstacle": (C.benchmark_obstacle_only_config, 0)}[name]
    cfg, sc_np = _batch(make_cfg, 64, n_people, torch.float32)
    sc = scenario_from_numpy(sc_np, device=card)
    host = []
    for n_ticks in (3, 6):
        sim = Simulator(cfg, n_ticks, device=card)
        ref = Simulator(cfg, n_ticks, device=card, capture=False)
        assert sim.captured and not ref.captured
        sim(sc)  # captures
        counts = {}
        for kind, s in (("captured", sim), ("reference", ref)):
            s.reset_host_launches()
            s.step.tick.reset_host_launches()
            _build.reset_launch_counts()
            torch.cuda.synchronize()
            if kind == "captured":
                prog, = sim._programs.values()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    with torch.no_grad():
                        res = prog(sc)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            else:
                want = s(sc)
            torch.cuda.synchronize()
            counts[kind] = dict(_build.launch_counts)
        _same_bits(res, want)
        assert sim.host_launches["graph_replays"] == 1
        assert all(n == 0 for n in sim.step.tick.host_launches.values())
        outer = counts["captured"].pop("lm_continue") - counts["reference"].pop("lm_continue")
        assert outer == n_ticks + 1 and counts["captured"] == counts["reference"]
        types = prog.parent.node_types()
        assert types["conditional"] == 1 + len(prog.step.counter.body_slots)
        step_prog, = sim.step.tick._programs.values()
        assert step_prog.parent is None  # nested: no parent graph of the step's own
        cmd, _, _ = sim.step(sc, make_carry(cfg, 64, device=card))  # that program, alone
        assert step_prog.parent is not None and bool(torch.isfinite(cmd.linear_x).all())
        host.append(dict(sim.host_launches))
    assert host[0] == host[1]
