"""The simulator's staged campaign (runtime/simulator.py: the step's tick,
the hand-off of its outputs and the world update on static buffers, one
parent graph launched once a campaign on the card) held against the
reference loop, ``simulate(..., capture=False)``.

On the CPU the same loop runs from Python on the same buffers. It must give
the reference loop's SimResult bit for bit (social and obstacle, B = 4, 3
ticks, in float64 and in float32 with ATen on one intra-op thread), stay
within 1e-6 of the JAX package's make_simulate in float64 on a batch, and
return results that alias nothing. The test marked ``gpu`` holds the
captured campaign against the reference loop on the card:

    python -m pytest tests/test_torch_sim_graph.py -q --noconftest -p no:cacheprovider -m gpu
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from nav2_social_mpc_controller_tpu_torch import _build
from nav2_social_mpc_controller_tpu_torch.core import config as C
from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry
from nav2_social_mpc_controller_tpu_torch.core.config import config_from_dict
from nav2_social_mpc_controller_tpu_torch.core.types import scenario_from_numpy, tree_leaves
from nav2_social_mpc_controller_tpu_torch.runtime.simulator import (
    SimResult,
    Simulator,
    make_simulate,
    simulate,
)
from nav2_social_mpc_controller_tpu_torch.utils.scenarios import (
    make_scenario_batch,
    stack_scenarios,
)

torch.set_num_threads(1)  # float32 bits across stagings need one intra-op thread

CONFIGS = {
    "social": (C.benchmark_social_config, 3),
    "obstacle": (C.benchmark_obstacle_only_config, 0),
}


def _batch(name, batch, np_dtype):
    make_cfg, n_people = CONFIGS[name]
    cfg = make_cfg()
    return cfg, make_scenario_batch(cfg, batch, base_seed=0, n_valid_people=n_people,
                                    dtype=np_dtype)


def _assert_same_bits(got, want):
    assert got._fields == want._fields == SimResult._fields
    for field, a, b in zip(got._fields, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert torch.equal(a, b), field


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_staged_simulation_equals_the_reference_loop_bit_for_bit(name, dtype):
    cfg, sc = _batch(name, 4, np.float64 if dtype == torch.float64 else np.float32)
    sim = make_simulate(cfg, 3, device="cpu", dtype=dtype)
    assert sim.staged and not sim.captured
    got = sim(sc)
    _assert_same_bits(got, simulate(cfg, sc, 3, device="cpu", dtype=dtype, capture=False))
    assert got.robot_traj.shape == (4, 4, 3) and got.status.dtype == torch.int32
    # per run, whatever the ticks: the scenario, the first carry, the
    # histories' first rows and the tick counter in; nothing launched; the
    # six result tensors out
    n_in = len(tree_leaves(scenario_from_numpy(sc, device="cpu", dtype=dtype)))
    n_in += len(tree_leaves(make_carry(cfg, 4, device="cpu", dtype=dtype))) + 3
    assert sim.host_launches == {"graph_replays": 0, "input_copies": n_in, "output_clones": 6}


def test_staged_simulation_matches_jax_f64():
    """A batch of two social scenarios, 5 ticks, against the JAX package's
    make_simulate (vmapped) within the 1e-6 of tests/test_torch_simulator.py
    (JAX imported here: the gpu tests run where it need not be installed)."""
    import jax

    from nav2_social_mpc_controller_tpu.core import config as jconfig
    from nav2_social_mpc_controller_tpu.runtime.simulator import (
        make_simulate as jax_make_simulate,
    )
    from nav2_social_mpc_controller_tpu.utils.scenarios import make_scenario as jax_make_scenario

    jcfg = jconfig.benchmark_social_config()
    lanes = [jax_make_scenario(jcfg, seed=s, n_valid_people=3, path_kind="straight",
                               dtype=np.float64) for s in (3, 5)]
    sc = stack_scenarios(lanes)
    want = jax.vmap(jax_make_simulate(jcfg, n_ticks=5))(sc)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    got = simulate(cfg, sc, 5, device="cpu", dtype=torch.float64)
    for field in SimResult._fields:
        a, b = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert a.shape == b.shape, field
        if field == "status":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=field)


def _lane(tree, i):
    return type(tree)(*(_lane(x, i) if isinstance(x, tuple) else x[i] for x in tree))


def test_a_program_per_signature_and_results_of_their_own():
    """A second run with the same signature reuses the program and gives
    the same bits; it writes nothing into the first run's results; another
    batch width gets a program of its own; an unbatched scenario runs as a
    batch of one."""
    cfg, sc = _batch("social", 3, np.float64)
    sim = Simulator(cfg, 2, device="cpu", dtype=torch.float64)
    first = sim(sc)
    kept = [x.clone() for x in first]
    second = sim(sc)
    assert len(sim._programs) == 1
    _assert_same_bits(second, first)
    ptrs = [x.data_ptr() for x in (*first, *second)]
    assert len(set(ptrs)) == len(ptrs)
    for x in second:
        x.add_(1)
    _assert_same_bits(first, SimResult(*kept))
    one = sim(_lane(sc, 0))
    assert len(sim._programs) == 2 and one.robot_traj.shape == (3, 3)
    with pytest.raises(ValueError, match="batched"):
        simulate(cfg, _lane(sc, 0), 1, device="cpu")


def test_the_tick_counter_wraps_inside_the_histories():
    """The stage steps its device counter modulo the run length: stage runs
    beyond the last tick (a timing loop replaying the graph) write inside
    the histories, never past their end (index_copy_ would raise)."""
    cfg, sc = _batch("obstacle", 2, np.float64)
    sim = Simulator(cfg, 2, device="cpu", dtype=torch.float64)
    sim(sc)
    prog, = sim._programs.values()
    assert int(prog.tick) == 0
    for _ in range(3):
        prog.stage()
    assert int(prog.tick) == 1 and prog.robot_traj.shape == (2, 3, 3)


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when a test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the CUDA kernels have no CPU mode")
    if shutil.which("nvcc") is None:
        _build.find_nvcc()  # raises with the reason when there is no toolkit
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CONFIGS))
def test_captured_simulation_equals_the_reference_loop_on_the_card(card, name):
    """On the card the campaign is one graph launch; the SimResult equals
    the reference loop's bit for bit, and both ran the same kernels of the
    step, the campaign's loop over ticks adding its lm_continue checks (its
    first and one a tick)."""
    cfg, sc = _batch(name, 64, np.float32)
    counts, res = {}, {}
    for capture in (False, True):
        sim = make_simulate(cfg, 4, device=card, capture=capture)
        assert sim.captured == capture
        _build.reset_launch_counts()
        res[capture] = sim(sc)
        torch.cuda.synchronize()
        counts[capture] = dict(_build.launch_counts)
        if capture:  # one launch for the whole campaign
            assert sim.host_launches["graph_replays"] == 1
    _assert_same_bits(res[True], res[False])
    outer = counts[True].pop("lm_continue") - counts[False].pop("lm_continue")
    assert counts[True] == counts[False] and counts[True]["trajectorize"] == 4
    assert outer == 4 + 1
