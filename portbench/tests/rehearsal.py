"""A run of a cell on the CPU at a tiny size, for the tests: the driver
driven directly (the command itself refuses to run without a card), on the
kernels' plain versions, then the check against the reference."""

import copy

from portbench import check, harness
from portbench import run as bench_run

TINY = {
    "fleet": dict(batch=8, check=dict(lanes=4, episodes_within=1, first_tick_lanes=4)),
    "robot": dict(scenarios=4, check=dict(episodes=2, episodes_within=4, first_tick_episodes=2)),
    "campaign": dict(batch=8, ticks=5, check=dict(lanes=3, controller_ticks=3, first_tick_lanes=3,
                                                  world_lanes=4)),
}


def context(cell_name: str, seed: int):
    bench = harness.benchmark()
    ctx = bench_run.context(bench, cell_name, seed, "cpu")
    traffic = copy.deepcopy(ctx.traffic)
    tiny = TINY[traffic["driver"]]
    traffic.update({k: v for k, v in tiny.items() if k != "check"})
    traffic["check"].update(tiny["check"])
    ctx.traffic = traffic
    return ctx


def rehearse(cell_name: str, seed: int, fault=None, workers: int = 4):
    """(readings, numbers, correct) of one untraced run at the tiny size;
    `fault(driver)` breaks the driver's timed path after set-up."""
    ctx = context(cell_name, seed)
    driver = harness.driver_module(ctx.traffic["driver"]).Driver(ctx)
    driver.setup()
    if fault is not None:
        fault(driver)
    r = bench_run.SimpleNamespace(setup_s=1.0)
    r.window = driver.window(0.0)
    r.solves = r.window.solves
    answers, jobs = driver.jobs()
    driver.release()
    numbers = driver.judge(answers, check.run_reference(jobs, workers))
    ok, _ = check.judge(numbers.values(), harness.limits(cell_name))
    return r, numbers, ok and numbers.answers > 0
