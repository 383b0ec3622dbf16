#!/usr/bin/env python3
"""Time variants of the PyTorch/CUDA port's kernel sources against each
other on one NVIDIA GPU, in turns, at the shapes chip_smoke.py holds them at.

    python3 tools/torch_kernel_variants.py NAME=PATH.cu [NAME=PATH.cu ...]

Each PATH is a complete variant of `csrc/fused_iter.cu` (K2), of
`csrc/rollout_prep.cu` (K6), of `csrc/tr_iter.cu` (K3 propose and K4
commit), of `csrc/sfm_scan.cu` (K5), of `csrc/rollout_sample.cu` (K6's
rollout with K1's sample) or of `csrc/spd_solve.cu` (K7), exporting the same
C entry points; the kind is told by those entry points. A K7 variant may
lack the damped-step entry (as the parent's file does): its damped step is
then timed as the plain composition around its solve, damped_system, the
solve, the map-back and project_step. The source in the checkout is added as `shipped` (a parent's source
comes from `git show <commit>:<path>` before the call; a variant file must
lie inside the copy of the repo, e.g. in a git-ignored directory). The
variants against which `csrc/tr_iter.cu`'s and `csrc/sfm_scan.cu`'s designs
were chosen are kept in `tools/tr_iter_variants/` and
`tools/sfm_scan_variants/` (those of `csrc/rollout_sample.cu` in
`tools/rollout_sample_variants/`, those of `csrc/spd_solve.cu` in
`tools/spd_solve_variants/`), each named in its first line. Every
variant is built with `_build.NVCC_FLAGS` into its own library (all nvcc runs
started together), the wrappers are pointed at each in turn, and every
kernel of every variant is timed with `chip_smoke.time_cuda` over 4 rounds,
the order reversed every other round, on inputs captured from real ticks.
K2 and K6 at six shapes:

  social_main           social config, B = 4096, 3 valid people per input
                        (the main path's shape)
  obstacle_main         obstacle config, B = 4096 (people-free, D = 6)
  social_all_valid      social config, B = 4096, every person valid, every
                        fourth robot near its goal
  omni6_all_valid       six agents, B = 1024, likewise
  stress36_all_valid    stress horizon (D = 12, S = 39), B = 1024, likewise
  stress36_people_free  stress horizon, B = 1024, no person

K3 and K4 (both timed in each turn), K5, the rollout sample and K7 (its
damped step without and with the Jacobi scale, and its standalone solve of
the damped system, all three timed in each turn) at the four default ticks'
shapes, one width of the compaction ladder and a ragged batch:

  social_main           social config, B = 4096, D = 6, 3 valid people
  obstacle_main         obstacle config, B = 4096, D = 6
  omni6_main            six agents, B = 1024, D = 6, every person valid
  stress36_main         stress horizon, B = 1024, D = 12, every person valid
  social_1024           social config, B = 1024
  social_ragged         social config, B = 4096 + 5

Prints JSON lines: the `device` and `build` lines of chip_smoke.py, ptxas
usage per variant, the launch floor (`time_cuda` of an empty
`torch.cuda._sleep(0)`), then {"variants": [{shape, kernel, variant, ms (one
per round), min_ms, err, tol}]}, where err is K2's scale-normalised error
against its plain version, K6's share of its allowance, or for K3/K4 the
number of output elements whose bits differ from the plain version's (NaN
against NaN counted equal; tolerance 0; so for K7's three), K5's
scale-normalised error against
its plain version (inf where its t column differs), and for the rollout
sample the number of elements whose bits differ from K6 then K1 on the card,
which are also timed, as `k6_then_k1`, in every turn; then the nvidia-smi
name and power limit. Exits with a code other than 0 if a variant does not build or exceeds
its kernel's tolerance.
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

# kind (the csrc/ file a variant replaces) -> the C entry points it exports
KINDS = {
    "fused_iter": ("social_mpc_fused_iter_f32",),
    "rollout_prep": ("social_mpc_rollout_prep_f32",),
    "tr_iter": ("social_mpc_propose_f32", "social_mpc_commit_f32"),
    "sfm_scan": ("social_mpc_sfm_scan_f32",),
    "rollout_sample": ("social_mpc_rollout_sample_f32",),
    "spd_solve": ("social_mpc_spd_solve_f32",),
}
# entry points a variant of the kind may lack (timed otherwise, see kernels())
OPTIONAL = {"spd_solve": ("social_mpc_damped_step_f32",)}
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
    kinds = set()
    for path in variants.values():
        text = open(path).read()
        found = [k for k, entries in KINDS.items() if all(e in text for e in entries)]
        if len(found) != 1:
            cs.fail(f"{path} exports the entry points of none or several of {sorted(KINDS)}")
        kinds.add(found[0])
    if len(kinds) != 1:
        cs.fail("all variants must be of one kind")
    kind = kinds.pop()
    variants["shipped"] = os.path.join(_build.CSRC_DIR, f"{kind}.cu")
    return kind, variants


def build_all(kind, variants):
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
        fns = {}
        for entry in KINDS[kind] + OPTIONAL.get(kind, ()):
            if entry not in KINDS[kind] and not hasattr(lib, entry):
                continue
            fn = getattr(lib, entry)
            fn.argtypes = _build._SIGNATURES[entry]
            fn.restype = ctypes.c_int
            fns[entry] = fn
        libs[name] = types.SimpleNamespace(**fns)
    return libs, usage


def captures(kind):
    from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry
    from nav2_social_mpc_controller_tpu_torch.core import config as C

    def cap(cfg, batch, n_valid, near_goal=False):
        sc, poses = cs.make_batch(cfg, batch, "cuda", n_valid_people=n_valid)
        pose = cs.near_goal_every(sc, poses[0]) if near_goal else poses[0]
        c = cs.capture_iteration(cfg, cs.with_pose(sc, pose), make_carry(cfg, batch, device="cuda"))
        return {**c, "cfg": cfg}

    social, obstacle = C.benchmark_social_config(), C.benchmark_obstacle_only_config()
    omni6, stress = C.benchmark_omni_6agents_config(), C.benchmark_stress_h36_config()
    if kind in ("tr_iter", "sfm_scan", "rollout_sample", "spd_solve"):
        return {
            "social_main": cap(social, cs.B_MAIN, 3),
            "obstacle_main": cap(obstacle, cs.B_MAIN, 0),
            "omni6_main": cap(omni6, cs.B_WIDE, omni6.n_agents),
            "stress36_main": cap(stress, cs.B_WIDE, stress.n_agents),
            "social_1024": cap(social, cs.B_WIDE, 3),
            "social_ragged": cap(social, cs.B_MAIN + 5, 3),
        }
    return {
        "social_main": cap(social, cs.B_MAIN, 3),
        "obstacle_main": cap(obstacle, cs.B_MAIN, 0),
        "social_all_valid": cap(social, cs.B_MAIN, social.n_agents, True),
        "omni6_all_valid": cap(omni6, cs.B_WIDE, omni6.n_agents, True),
        "stress36_all_valid": cap(stress, cs.B_WIDE, stress.n_agents, True),
        "stress36_people_free": cap(stress, cs.B_WIDE, 0),
    }


def kernels(kind):
    """[(kernel, its wrapper on a capture, its plain version on a capture)]"""
    from nav2_social_mpc_controller_tpu_torch.models import sfm as K5
    from nav2_social_mpc_controller_tpu_torch.ops import fused_iter as K2
    from nav2_social_mpc_controller_tpu_torch.ops import rollout_cuda as K6
    from nav2_social_mpc_controller_tpu_torch import _build
    from nav2_social_mpc_controller_tpu_torch.solver import cuda_iter as K34
    from nav2_social_mpc_controller_tpu_torch.solver import cuda_solve as K7

    if kind == "spd_solve":
        def step(c, jac):
            if hasattr(_build._lib, "social_mpc_damped_step_f32"):
                return K34.damped_step(c["lm_cfg"], *c["propose"], jac)
            u, g, jtj, radius, lower, upper = c["propose"]
            a, rhs = K34.damped_system(c["lm_cfg"], g, jtj, radius, jac)
            x = K7.spd_solve(a.contiguous(), rhs.contiguous())
            return K34.project_step(u, x if jac is None else jac * x, g, jtj, lower, upper)

        return [("damped_step", lambda c: step(c, None),
                 lambda c: K34.damped_step_plain(c["lm_cfg"], *c["propose"])),
                ("damped_step_jacobi", lambda c: step(c, c["jac_scale"]),
                 lambda c: K34.damped_step_plain(c["lm_cfg"], *c["propose"], c["jac_scale"])),
                ("spd_solve", lambda c: K7.spd_solve(*c["spd_solve"]),
                 lambda c: K7.spd_solve_plain(*c["spd_solve"]))]
    if kind == "fused_iter":
        return [("fused_iter", lambda c: K2.fused_cost_g_jtj(*c["fused"]),
                 lambda c: K2.fused_cost_g_jtj_plain(*c["fused"]))]
    if kind == "rollout_prep":
        return [("rollout_prep", lambda c: K6.rollout_prep(*c["rollout_prep"]),
                 lambda c: K6.rollout_prep_plain(*c["rollout_prep"]))]
    if kind == "sfm_scan":
        return [("sfm_scan", lambda c: K5.project_people(*c["sfm"], **cs.sfm_keywords(c["cfg"])),
                 lambda c: K5.project_people_plain(*c["sfm"], **cs.sfm_keywords(c["cfg"])))]
    if kind == "rollout_sample":
        return [("rollout_sample", lambda c: K6.rollout_sample(c["bicubic"][0], *c["rollout_prep"]),
                 lambda c: cs.prep_then_sample(c["bicubic"][0], c["rollout_prep"]))]
    return [("propose", lambda c: K34.propose(c["lm_cfg"], *c["propose"]),
             lambda c: K34.propose_plain(c["lm_cfg"], *c["propose"])),
            ("commit", lambda c: K34.commit(c["lm_cfg"], *c["commit"]),
             lambda c: K34.commit_plain(c["lm_cfg"], *c["commit"]))]


def error(kernel, got, ref):
    if kernel == "fused_iter":
        return max(cs.norm_err(a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1))[0]
                   for a, b in zip(got, ref))
    if kernel in ("propose", "commit", "damped_step", "damped_step_jacobi"):
        return cs.bits_differ(got, ref)
    if kernel == "spd_solve":
        return cs.bits_differ([got], [ref])
    if kernel == "rollout_sample":
        return cs.bits_differ([got[k] for k in sorted(ref)], [ref[k] for k in sorted(ref)])
    if kernel == "sfm_scan":
        if not bool((got[..., 3] == ref[..., 3]).all()):
            return float("inf")
        return cs.norm_err(got, ref)[0]
    share = 0.0
    for name, r in ref.items():
        atol = cs.K6_ATOL_ROWCOL if name in ("row", "col") else cs.K6_ATOL
        diff = (got[name].double() - r.double()).abs()
        share = max(share, float((diff / (atol + cs.K6_RTOL * r.double().abs())).max()))
    return share


def tolerance(kernel, cap):
    if kernel in ("propose", "commit", "rollout_sample", "damped_step", "damped_step_jacobi",
                  "spd_solve"):
        return 0.0
    if kernel == "fused_iter" and bool(cap["fused"][18].any()):
        return cs.TOL["fused_iter_people"]
    return cs.TOL[kernel]


def main():
    import torch

    from nav2_social_mpc_controller_tpu_torch import _build

    _, smi = cs.phase_device()
    kind, variants = parse_args(sys.argv[1:])
    cs.phase_build()
    libs, usage = build_all(kind, variants)
    cs.emit({"ptxas": usage})
    cs.emit({"launch_floor_ms": cs.launch_floor_ms(REPS)})
    times, errs, tols = collections.defaultdict(list), {}, {}
    full = _build.load()  # the checkout's library: every entry point
    order = list(libs)
    if kind == "rollout_sample":  # the two launches it replaces, in turns with it
        libs["k6_then_k1"] = full
        order.append("k6_then_k1")
    try:
        for shape, cap in captures(kind).items():
            for kernel, run, plain in kernels(kind):
                _build._lib = full
                ref = plain(cap)
                tols[(shape, kernel)] = tolerance(kernel, cap)
                for rnd in range(ROUNDS):
                    for name in (order if rnd % 2 == 0 else order[::-1]):
                        _build._lib = libs[name]
                        fn = (lambda: plain(cap)) if name == "k6_then_k1" else (lambda: run(cap))
                        if rnd == 0:
                            errs[(shape, kernel, name)] = error(kernel, fn(), ref)
                        times[(shape, kernel, name)].append(cs.time_cuda(fn, REPS))
    finally:
        _build._lib = full
    torch.cuda.synchronize()
    table = [{"shape": s, "kernel": k, "variant": n, "ms": v, "min_ms": min(v),
              "err": errs[(s, k, n)], "tol": tols[(s, k)]} for (s, k, n), v in times.items()]
    cs.emit({"variants": table})
    print(smi, flush=True)
    bad = [r for r in table if not r["err"] <= r["tol"]]
    if bad:
        cs.fail(f"variants beyond their tolerance: {bad}")


if __name__ == "__main__":
    main()
