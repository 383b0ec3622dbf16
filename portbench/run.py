"""One run of one benchmark cell of the PyTorch/CUDA port
(nav2_social_mpc_controller_tpu_torch):

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

loads the cell's configuration and traffic (BENCHMARK.json), makes its
inputs from the seed, warms up every shape it uses (set-up), measures for
--seconds seconds (--trace 0: the end-to-end metrics) or runs its traced
segment under torch.profiler (--trace 1: the per-layer metrics), checks the
answers of lanes sampled from the seed against the plain reference
(portbench/reference/), and prints one JSON line. It runs on the card only:
with no CUDA device, or fewer than the cell asks for, it exits non-zero and
prints no result; so it does if JAX or the JAX package is loaded once the
window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def context(bench, cell_name, seed, device):
    """What a driver is built from: the port's config (through
    config_from_dict), the configuration file, the traffic, the seed and a
    generator of the check's samples drawn from it."""
    import numpy as np

    from portbench import harness

    cell = harness.cell(bench, cell_name)
    doc = harness.config_doc(bench, cell["config"])
    return SimpleNamespace(
        cell=cell, config_doc=doc, cfg=harness.port_config(doc),
        traffic=harness.traffic(cell["traffic"]), seed=seed, device=device,
        rng=np.random.default_rng(seed))


def measure(driver, ctx, seconds: float, trace: bool):
    """Set-up, then the window or the traced segment: the readings the
    metric readers take (portbench/metrics/<name>.py)."""
    r = SimpleNamespace(traffic=ctx.traffic, config_doc=ctx.config_doc)
    driver.setup()
    r.setup_s = time.perf_counter() - T_START
    if trace:
        r.failed = 0
        driver.traced(r)
    else:
        r.window = driver.window(seconds)
        r.solves = r.window.solves
    return r


def read_metrics(bench, cell_name, section, r):
    from portbench import harness

    out = {}
    for m in harness.cell_metrics(bench, cell_name, section):
        value = harness.load_by_path("metrics", m["name"]).read(r)
        if harness.finite(value):
            out[m["name"]] = harness.metric(value, m["unit"])
    return out


def correctness(driver, cell_name):
    """The sampled answers against the reference, after the program's state
    is freed: (correct, checks)."""
    from portbench import check, harness

    answers, jobs = driver.jobs()
    driver.release()
    free_card_memory()
    refs = check.run_reference(jobs)
    numbers = driver.judge(answers, refs)
    ok, checks = check.judge(numbers.values(), harness.limits(cell_name))
    check.report(checks, numbers.spread())
    return ok and numbers.answers > 0, checks, numbers.answers


def free_card_memory():
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def main(argv=None):
    args = parse(sys.argv[1:] if argv is None else argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench import harness

    bench = harness.benchmark()
    ctx_cell = harness.cell(bench, args.workload)
    harness.require_card(ctx_cell["chips"])
    import torch

    ctx = context(bench, args.workload, args.seed, "cuda")
    driver = harness.driver_module(ctx.traffic["driver"]).Driver(ctx)
    torch.cuda.reset_peak_memory_stats()
    r = measure(driver, ctx, args.seconds, bool(args.trace))
    torch.cuda.synchronize()
    device = harness.device_info(ctx_cell["chips"])
    loaded = harness.forbidden_loaded()
    if loaded:
        raise SystemExit(f"portbench: forbidden modules loaded in the run: {loaded}")
    r.power_limit_w = harness.power_limit_w()
    section = "per_layer" if args.trace else "end_to_end"
    metrics = read_metrics(bench, args.workload, section, r)
    out = {}
    if args.trace:
        from portbench import trace

        window_s, busy_s = trace.window_and_busy(r.session, r.span)
        print(f"portbench: trace: {len(r.session.device)} device records, "
              f"{r.session.pads} of {trace.PAD_KERNELS} pad kernels, {r.ticks} {r.span}s",
              file=sys.stderr)
        device.update(busy_s=busy_s, window_s=window_s)
        out["breakdown"] = {
            "device_ops": trace.top_ops(trace.compose(r.replay, r.replays)),
            "idle_gaps": trace.idle_gaps(r.session, r.span, r.labels),
        }
        r.session = None
    device["power_limit_w"] = r.power_limit_w
    attempted = r.solves
    failed = r.window.failed if not args.trace else r.failed
    ok, checks, answers = correctness(driver, args.workload)
    if harness.forbidden_loaded():
        raise SystemExit(f"portbench: forbidden modules loaded: {harness.forbidden_loaded()}")
    line = {"correct": ok, "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": device, **out, "answers_checked": answers, "checks": checks}
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
