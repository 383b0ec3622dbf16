#!/usr/bin/env python3
"""Time variants of the PyTorch/CUDA port's K2 or K6 source against each
other on one NVIDIA GPU, in turns, at the shapes chip_smoke.py holds them at.

    python3 tools/torch_kernel_variants.py NAME=PATH.cu [NAME=PATH.cu ...]

Each PATH is a complete variant of `csrc/fused_iter.cu` (K2) or of
`csrc/rollout_prep.cu` (K6), exporting the same C entry point; the kernel is
told by that entry point. The source in the checkout is added as `shipped`.
Every variant is built with `_build.NVCC_FLAGS` into its own library (all
nvcc runs started together), the wrapper is pointed at each in turn, and
every variant is timed with `chip_smoke.time_cuda` over 4 rounds, the order
reversed every other round, on inputs captured from real ticks:

  social_main           social config, B = 4096, 3 valid people per input
                        (the main path's shape)
  obstacle_main         obstacle config, B = 4096 (people-free, D = 6)
  social_all_valid      social config, B = 4096, every person valid, every
                        fourth robot near its goal
  omni6_all_valid       six agents, B = 1024, likewise
  stress36_all_valid    stress horizon (D = 12, S = 39), B = 1024, likewise
  stress36_people_free  stress horizon, B = 1024, no person

Prints JSON lines: the `device` and `build` lines of chip_smoke.py, ptxas
usage per variant, then {"variants": [{shape, kernel, variant, ms (one per
round), min_ms, err}]}, where err is K2's scale-normalised error against its
plain version or K6's share of its allowance; then the nvidia-smi name and
power limit. Exits with a code other than 0 if a variant does not build or
exceeds its kernel's tolerance.
"""

import collections
import ctypes
import os
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

ENTRY = {"social_mpc_fused_iter_f32": "fused_iter", "social_mpc_rollout_prep_f32": "rollout_prep"}
ROUNDS = 4
REPS = 200


def parse_args(argv):
    from nav2_social_mpc_controller_tpu_torch import _build

    variants = {}
    for arg in argv:
        name, sep, path = arg.partition("=")
        if not sep or not os.path.isfile(path):
            cs.fail(f"expected NAME=PATH.cu, got {arg!r}")
        variants[name] = path
    kernels = set()
    for path in variants.values():
        text = open(path).read()
        found = [k for e, k in ENTRY.items() if e in text]
        if len(found) != 1:
            cs.fail(f"{path} exports neither or both of {sorted(ENTRY)}")
        kernels.add(found[0])
    if len(kernels) != 1:
        cs.fail("all variants must be of one kernel")
    kernel = kernels.pop()
    variants["shipped"] = os.path.join(_build.CSRC_DIR, f"{kernel}.cu")
    return kernel, variants


def build_all(variants):
    from nav2_social_mpc_controller_tpu_torch import _build

    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, path in variants.items():
        so = os.path.join(out_dir, f"{name}.so")
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", _build.CSRC_DIR,
               "-shared", "-o", so, path]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    libs, usage = {}, {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            cs.fail(f"variant {name} does not build:\n{log[-3000:]}")
        usage[name] = cs.ptxas_usage(log)
        lib = ctypes.CDLL(so)
        entry = next(e for e in ENTRY if hasattr(lib, e))
        fn = getattr(lib, entry)
        fn.argtypes = _build._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        libs[name] = types.SimpleNamespace(**{entry: fn})
    return libs, usage


def captures():
    from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry
    from nav2_social_mpc_controller_tpu_torch.core import config as C

    def cap(cfg, batch, n_valid, near_goal):
        sc, poses = cs.make_batch(cfg, batch, "cuda", n_valid_people=n_valid)
        pose = cs.near_goal_every(sc, poses[0]) if near_goal else poses[0]
        return cs.capture_iteration(cfg, cs.with_pose(sc, pose), make_carry(cfg, batch, device="cuda"))

    social, obstacle = C.benchmark_social_config(), C.benchmark_obstacle_only_config()
    omni6, stress = C.benchmark_omni_6agents_config(), C.benchmark_stress_h36_config()
    return {
        "social_main": cap(social, cs.B_MAIN, 3, False),
        "obstacle_main": cap(obstacle, cs.B_MAIN, 0, False),
        "social_all_valid": cap(social, cs.B_MAIN, social.n_agents, True),
        "omni6_all_valid": cap(omni6, cs.B_WIDE, omni6.n_agents, True),
        "stress36_all_valid": cap(stress, cs.B_WIDE, stress.n_agents, True),
        "stress36_people_free": cap(stress, cs.B_WIDE, 0, False),
    }


def error(kernel, got, ref):
    if kernel == "fused_iter":
        return max(cs.norm_err(a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1))[0]
                   for a, b in zip(got, ref))
    share = 0.0
    for name, r in ref.items():
        atol = cs.K6_ATOL_ROWCOL if name in ("row", "col") else cs.K6_ATOL
        diff = (got[name].double() - r.double()).abs()
        share = max(share, float((diff / (atol + cs.K6_RTOL * r.double().abs())).max()))
    return share


def main():
    import torch

    from nav2_social_mpc_controller_tpu_torch import _build
    from nav2_social_mpc_controller_tpu_torch.ops import fused_iter as K2
    from nav2_social_mpc_controller_tpu_torch.ops import rollout_cuda as K6

    _, smi = cs.phase_device()
    kernel, variants = parse_args(sys.argv[1:])
    cs.phase_build()
    libs, usage = build_all(variants)
    cs.emit({"ptxas": usage})
    if kernel == "fused_iter":
        run, plain, arg_key = K2.fused_cost_g_jtj, K2.fused_cost_g_jtj_plain, "fused"
    else:
        run, plain, arg_key = K6.rollout_prep, K6.rollout_prep_plain, "rollout_prep"
    times, errs, tols = collections.defaultdict(list), {}, {}
    order = list(libs)
    try:
        for shape, cap in captures().items():
            args = cap[arg_key]
            ref = plain(*args)
            people = kernel == "fused_iter" and bool(args[18].any())
            tols[shape] = cs.TOL["fused_iter_people" if people else kernel]
            for rnd in range(ROUNDS):
                for name in (order if rnd % 2 == 0 else order[::-1]):
                    _build._lib = libs[name]
                    if rnd == 0:
                        errs[(shape, name)] = error(kernel, run(*args), ref)
                    times[(shape, name)].append(cs.time_cuda(lambda: run(*args), REPS))
    finally:
        _build._lib = None
    torch.cuda.synchronize()
    table = [{"shape": s, "kernel": kernel, "variant": n, "ms": v, "min_ms": min(v),
              "err": errs[(s, n)], "tol": tols[s]} for (s, n), v in times.items()]
    cs.emit({"variants": table})
    print(smi, flush=True)
    bad = [r for r in table if not r["err"] <= r["tol"]]
    if bad:
        cs.fail(f"variants beyond their tolerance: {bad}")


if __name__ == "__main__":
    main()
