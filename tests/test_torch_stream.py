"""The port's streaming runtime: latest-value semantics (the cases of
tests/test_stream.py) and the fixed-rate loop driving the port's make_step
on the CPU."""

import threading
import time

import numpy as np
import torch

from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry, make_step
from nav2_social_mpc_controller_tpu_torch.core.config import benchmark_social_config
from nav2_social_mpc_controller_tpu_torch.runtime.stream import ControllerLoop, LatestValueCache
from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario


def test_latest_value_cache_overwrites():
    c = LatestValueCache()
    v, age = c.get()
    assert v is None and age is None
    c.put(1)
    c.put(2)
    v, age = c.get()
    assert v == 2 and age >= 0.0


def test_latest_value_cache_thread_race():
    c = LatestValueCache(0)
    stop = threading.Event()

    def writer():
        i = 0
        while not stop.is_set():
            i += 1
            c.put(i)

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    seen = [c.get()[0] for _ in range(2000)]
    stop.set()
    t.join(2)
    assert all(b >= a for a, b in zip(seen, seen[1:])), "monotone latest-value reads"


def test_controller_loop_drives_make_step_and_skips():
    """Every third snapshot is a sensor dropout (skipped tick); the loop
    runs until four commands are out. A CPU tick takes longer than the
    period, so overruns are expected and only counted."""
    cfg = benchmark_social_config()
    sc = make_scenario(cfg, seed=0, n_valid_people=2, grid_hw=(64, 64))
    step = make_step(cfg, device="cpu")
    people_cache = LatestValueCache(sc.people)
    cmds = []
    n_calls = [0]

    def scenario_fn():
        n_calls[0] += 1
        if n_calls[0] % 3 == 0:
            return None  # simulated sensor dropout -> skipped tick
        people, _ = people_cache.get()
        return sc._replace(people=people)

    loop = ControllerLoop(
        step, make_carry(cfg, device="cpu"), scenario_fn,
        lambda cmd, aux: cmds.append(float(cmd.linear_x)), frequency_hz=20.0,
    ).start()
    deadline = time.monotonic() + 120.0
    while len(cmds) < 4 and time.monotonic() < deadline:
        time.sleep(0.05)
    loop.stop()

    assert loop.ticks >= 4, f"expected >= 4 ticks, got {loop.ticks}"
    assert loop.missed >= 1
    assert len(cmds) == loop.ticks
    assert all(np.isfinite(c) for c in cmds)
    assert loop.overruns >= 0
    # the carry advanced (warm-start memory populated), unbatched
    assert loop.carry.prev_n.shape == () and int(loop.carry.prev_n) >= 2
    assert loop.carry.prev_path.dtype == torch.float32
