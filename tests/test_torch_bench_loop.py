"""The CLI's bench loop (runtime/bench.py: BenchLoop): n ticks of the
batched step with the carry fed back and the pose moved by 1e-6 * i. Its
staged form, one graph launch on the card, is held to the host loop (one
step call a tick) bit for bit: on the CPU its stages run from Python on
lm_continue's plain version, on the card (marker `gpu`) as one launch. This
file imports no JAX; the comparison with the JAX package's cmd_bench is in
tests/test_torch_step_default.py."""

import functools

import pytest
import torch

from nav2_social_mpc_controller_tpu_torch import _build
from nav2_social_mpc_controller_tpu_torch.core import config as C
from nav2_social_mpc_controller_tpu_torch.core.types import scenario_from_numpy
from nav2_social_mpc_controller_tpu_torch.runtime.bench import BenchLoop
from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario_batch

torch.set_num_threads(1)

N_TICKS = 2


@functools.lru_cache(maxsize=None)
def _bench(dtype):
    cfg = C.benchmark_social_config()
    sc = scenario_from_numpy(make_scenario_batch(cfg, 4, base_seed=0, n_valid_people=3),
                             device="cpu", dtype=dtype)
    return BenchLoop(cfg, device="cpu", dtype=dtype), sc


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_staged_bench_loop_equals_the_host_loop(dtype):
    """The staged loop gives the host loop's last command (every field)
    bit for bit, for one tick and for N_TICKS; its host operations do not
    grow with the ticks and the step's own stay at 0."""
    bench, sc = _bench(dtype)
    for n in (1, N_TICKS):
        bench.reset_host_launches()
        got = bench(sc, n)
        ops = dict(bench.host_launches)
        want = bench.host_loop(sc, n)
        for a, b in zip(got, want):
            assert a.dtype == dtype and torch.equal(a, b)
        assert ops == {"graph_replays": 0, "input_copies": 20, "output_clones": 3}
    assert bench.step.tick.host_launches["graph_replays"] == 0
    with pytest.raises(ValueError, match="at least one tick"):
        bench(sc, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name,batch", [("benchmark_social_config", 1024),
                                        ("SocialMPCConfig", 64)])
def test_one_launch_bench_equals_the_host_loop(name, batch):
    """On the card: 3 ticks as one graph launch give the host loop's last
    command bit for bit, with the same kernel launches but lm_continue's
    (the loop over ticks adds its own), the trajectorizer once a tick, one
    graph launch and no step launch of the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the one-launch loop is a CUDA graph")
    cfg = getattr(C, name)()
    sc = scenario_from_numpy(make_scenario_batch(cfg, batch, base_seed=0, n_valid_people=3),
                             device="cuda")
    bench = BenchLoop(cfg, device="cuda")
    assert bench.captured
    bench(sc, 1)
    bench.host_loop(sc, 1)  # capture, warm
    got, launches = {}, {}
    for kind, run in (("one_launch", lambda: bench(sc, 3)),
                      ("host_loop", lambda: bench.host_loop(sc, 3))):
        bench.reset_host_launches()
        bench.step.tick.reset_host_launches()
        _build.reset_launch_counts()
        got[kind] = run()
        torch.cuda.synchronize()
        launches[kind] = dict(_build.launch_counts)
        if kind == "one_launch":
            assert bench.host_launches["graph_replays"] == 1
            assert bench.step.tick.host_launches["graph_replays"] == 0
    for a, b in zip(got["one_launch"], got["host_loop"]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    loops = {"lm_continue"}
    assert {k: v for k, v in launches["one_launch"].items() if k not in loops} == \
        {k: v for k, v in launches["host_loop"].items() if k not in loops}
    assert launches["one_launch"]["trajectorize"] == 3
    assert launches["one_launch"]["lm_continue"] > launches["host_loop"]["lm_continue"]
