#!/usr/bin/env python3
"""Time variants of the PyTorch/CUDA port's kernel sources against each
other on one NVIDIA GPU, in turns, at the shapes chip_smoke.py holds them at.

    python3 tools/torch_kernel_variants.py [--general | --general-solve] [--threads T,...]
                                           [--systems S,...] [--bits-against NAME]
                                           NAME=PATH.cu [...]

Each PATH is a complete variant of `csrc/fused_iter.cu` (K2), of
`csrc/fused_general.cu` (K2's general form), of `csrc/rollout_prep.cu`
(K6), of `csrc/tr_iter.cu` (K3 propose and K4 commit), of
`csrc/sfm_scan.cu` (K5; `--general`: its general form, at the crowd shapes
below), of `csrc/rollout_sample.cu` (K6's rollout with K1's sample) or of
`csrc/spd_solve.cu` (K7; `--general-solve`: its general form, at the
general shapes below), exporting the same C entry points; the kind is
told by those entry points. `--threads`: with `--general`, K5's shipped
source is timed again at each of these threads a scenario (variants
`shipped@T`; the wrapper's choice is models/sfm.py:
general_threads_per_scenario), and the variants list may be empty; with
`--general-solve`, K7's at each of these threads a system past D = 32
(`shipped@tT`), and `--systems` at each of these systems a block up to
D = 32 (`shipped@sS`; the wrapper's choice of both is
kernel_shapes.general_solve_geometry, which every variant is launched with).
`--bits-against NAME`: each variant's output elements whose bits differ
from variant NAME's on the same inputs (`bits_differ_from`). A K7 variant may
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

K2's general form at the configs that run it (chip_smoke.py: step_configs),
every third robot near its goal:

  social_bl2_main       horizon 18 in blocks of 2 (NB = 9, D = 18), B = 4096,
                        3 valid people (the main path's shape)
  social_bl2_people_free  likewise without people
  stress36_bl3          the H = 36 stress horizon in blocks of 3 (NB = 12,
                        D = 24, S = 39), B = 1024, 3 valid people
  social_bl1            blocks of 1 (NB = 18, D = 36), B = 1024
  nb118                 the limit, NB = 118 (S = 123), B = 16

K5's general form (`--general`): social_n64_main (the crowd config's main
path, B = 4096, N = 64, the FOV-filtered people of a real tick); N = 33 and
64 at B = 1024 with every agent valid (the generator's density); N = 128
and 256 at B = 256, spread to one person every two square metres. Its
error is taken over the scenarios whose plain version another order of its
sums moves by at most 1e-5 (chip_smoke.py: sfm_order_sensitivity).

K7's general form (`--general-solve`: the damped step without and with
the Jacobi scale and the standalone solve of its system, at the configs
that run it, every third robot near its goal; the standalone solve alone
on random SPD systems, every 97th negated), with one library call that
solves the same systems (torch.linalg.cholesky_ex then
torch.cholesky_solve; variant `library`, timed as a yardstick and not
gated) beside each:

  social_bl2_main       horizon 18 in blocks of 2 (D = 18), B = 4096, 3 valid
                        people (the main path's shape)
  stress36_bl3          the H = 36 stress horizon in blocks of 3 (D = 24),
                        B = 1024
  social_bl1            blocks of 1 (D = 36), B = 1024
  nb118_b16             D = 236 at B = 16: one block's latency
  spd_d64, spd_d128, spd_d237   random SPD systems at B = 1024 (standalone
                        solve only)

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
import re
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# kind (the csrc/ file a variant replaces) -> the C entry points it exports
KINDS = {
    "fused_iter": ("social_mpc_fused_iter_f32",),
    "fused_general": ("social_mpc_fused_iter_general_f32",),
    "rollout_prep": ("social_mpc_rollout_prep_f32",),
    "tr_iter": ("social_mpc_propose_f32", "social_mpc_commit_f32"),
    "sfm_scan": ("social_mpc_sfm_scan_f32",),
    "rollout_sample": ("social_mpc_rollout_sample_f32",),
    "spd_solve": ("social_mpc_spd_solve_f32",),
}
# entry points a variant of the kind may lack (timed otherwise, see kernels())
OPTIONAL = {"spd_solve": ("social_mpc_damped_step_f32", "social_mpc_damped_step_general_f32",
                          "social_mpc_spd_solve_general_f32"),
            "sfm_scan": ("social_mpc_sfm_scan_general_f32",)}
ROUNDS = 4
REPS = 200


def parse_args(argv):
    from nav2_social_mpc_controller_tpu_torch import _build

    general, solve, threads, systems, against = False, False, (), (), None
    if argv[:1] == ["--general"]:
        general, argv = True, argv[1:]
    elif argv[:1] == ["--general-solve"]:
        solve, argv = True, argv[1:]
    if argv[:1] == ["--threads"] and len(argv) > 1:
        threads, argv = tuple(int(t) for t in argv[1].split(",")), argv[2:]
    if argv[:1] == ["--systems"] and len(argv) > 1:
        systems, argv = tuple(int(t) for t in argv[1].split(",")), argv[2:]
    if argv[:1] == ["--bits-against"] and len(argv) > 1:
        against, argv = argv[1], argv[2:]
    variants = {}
    for arg in argv:
        name, sep, path = arg.partition("=")
        if not sep or not os.path.isfile(path):
            cs.fail(f"expected NAME=PATH.cu, got {arg!r}")
        variants[name] = path
    kinds = set()
    for path in variants.values():
        defined = set(re.findall(r'extern "C" int (social_mpc_\w+)\(', open(path).read()))
        found = [k for k, entries in KINDS.items() if set(entries) <= defined]
        if len(found) != 1:
            cs.fail(f"{path} exports the entry points of none or several of {sorted(KINDS)}")
        kinds.add(found[0])
    if general:
        kinds.add("sfm_scan")
    if solve:
        kinds.add("spd_solve")
    if len(kinds) != 1:
        cs.fail("all variants must be of one kind")
    kind = kinds.pop()
    if kind == "sfm_scan" and general:
        kind = "sfm_scan_general"
    elif kind == "spd_solve" and solve:
        kind = "spd_solve_general"
    elif threads:
        cs.fail("--threads times a general form: give --general or --general-solve first")
    if systems and kind != "spd_solve_general":
        cs.fail("--systems times K7's general form: give --general-solve first")
    variants["shipped"] = os.path.join(_build.CSRC_DIR, f"{kind.replace('_general', '')}.cu")
    if against is not None and against not in variants and against != "shipped":
        cs.fail(f"--bits-against {against}: no such variant")
    return kind, variants, threads, systems, against


def build_all(kind, variants):
    from nav2_social_mpc_controller_tpu_torch import _build

    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, path in variants.items():
        so = os.path.join(out_dir, f"{name}.so")
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", _build.CSRC_DIR,
               "-I", _build.write_shapes_header(out_dir), "-shared", "-o", so, path]
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
        base = kind.replace("_general", "")
        for entry in KINDS[base] + OPTIONAL.get(base, ()):
            if entry not in KINDS[base] and not hasattr(lib, entry):
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

    def crowd(n, batch):
        """K5's inputs with every one of N agents valid (chip_smoke.py:
        check_sfm_general_shapes), spread past 64."""
        from nav2_social_mpc_controller_tpu_torch.controller.controller import step_pre

        cfg = cs.agents_config(n)
        sc, poses = cs.make_batch(cfg, batch, "cuda", n_valid_people=n)
        sc = cs.with_pose(sc, poses[0])
        prep = step_pre(cfg, sc, make_carry(cfg, batch, device="cuda")).prep
        people = sc.people.state if n <= 64 else cs.spread_crowd(sc.people.state)
        return {"sfm": cs.sfm_inputs(sc, people, prep), "cfg": cfg}

    social, obstacle = C.benchmark_social_config(), C.benchmark_obstacle_only_config()
    omni6, stress = C.benchmark_omni_6agents_config(), C.benchmark_stress_h36_config()
    if kind == "fused_general":
        return {
            "social_bl2_main": cap(cs.replace_optimizer(social, parameter_block_length=2),
                                   cs.B_MAIN, 3),
            "social_bl2_people_free": cap(cs.replace_optimizer(social, parameter_block_length=2),
                                          cs.B_MAIN, 0),
            "stress36_bl3": cap(cs.replace_optimizer(stress, parameter_block_length=3),
                                cs.B_WIDE, 3, True),
            "social_bl1": cap(cs.replace_optimizer(social, parameter_block_length=1),
                              cs.B_WIDE, 3, True),
            "nb118": cap(cs.general_blocks_config(118), 16, 3, True),
        }
    if kind == "spd_solve_general":
        import torch

        rng = torch.Generator(device="cuda").manual_seed(1)

        def random_spd(d, n=cs.B_WIDE):
            m = torch.randn((n, d, d), device="cuda", generator=rng)
            a = m @ m.transpose(1, 2) + 0.5 * torch.eye(d, device="cuda")
            a[::97] = -a[::97]
            return {"spd_solve": (a.contiguous(), torch.randn((n, d), device="cuda", generator=rng))}

        return {
            "social_bl2_main": cap(cs.replace_optimizer(social, parameter_block_length=2),
                                   cs.B_MAIN, 3),
            "stress36_bl3": cap(cs.replace_optimizer(stress, parameter_block_length=3),
                                cs.B_WIDE, 3, True),
            "social_bl1": cap(cs.replace_optimizer(social, parameter_block_length=1),
                              cs.B_WIDE, 3, True),
            "nb118_b16": cap(cs.general_blocks_config(118), 16, 3, True),
            **{f"spd_d{d}": random_spd(d) for d in (64, 128, 237)},
        }
    if kind == "sfm_scan_general":
        return {"social_n64_main": cap(cs.agents_config(64), cs.B_MAIN, 64),
                **{f"n{n}_all_valid": crowd(n, b) for n, b in ((33, cs.B_WIDE), (64, cs.B_WIDE),
                                                             (128, 256), (256, 256))}}
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

    if kind == "spd_solve_general":
        return [("damped_step", lambda c: K34.damped_step(c["lm_cfg"], *c["propose"]),
                 lambda c: K34.damped_step_plain(c["lm_cfg"], *c["propose"])),
                ("damped_step_jacobi",
                 lambda c: K34.damped_step(c["lm_cfg"], *c["propose"], c["jac_scale"]),
                 lambda c: K34.damped_step_plain(c["lm_cfg"], *c["propose"], c["jac_scale"])),
                ("spd_solve", lambda c: K7.spd_solve(*c["spd_solve"]),
                 lambda c: K7.spd_solve_plain(*c["spd_solve"]))]
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
    if kind == "fused_general":
        return [("fused_iter_general", lambda c: K2.fused_cost_g_jtj(*c["fused"]),
                 lambda c: K2.fused_cost_g_jtj_plain(*c["fused"]))]
    if kind == "sfm_scan_general":
        return [("sfm_scan_general",
                 lambda c: K5.project_people(*c["sfm"], **cs.sfm_keywords(c["cfg"])),
                 lambda c: K5.project_people_plain(*c["sfm"], **cs.sfm_keywords(c["cfg"])))]
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


def library_solve(cap):
    """One library factorisation and solve of a capture's standalone
    systems (a yardstick; the port never calls it)."""
    import torch

    a, b = cap["spd_solve"]
    chol, _ = torch.linalg.cholesky_ex(a)
    return torch.cholesky_solve(b[:, :, None], chol)[..., 0]


def error(kernel, got, ref, cap):
    if kernel == "sfm_scan_general":
        if not bool((got[..., 3] == ref[..., 3]).all()):
            return float("inf")
        calm = cap["calm"]
        return cs.norm_err(got[calm], ref[calm])[0]
    if kernel in ("fused_iter", "fused_iter_general"):
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
    if kernel in ("fused_iter", "fused_iter_general") and bool(cap["fused"][18].any()):
        return cs.TOL["fused_iter_people"]
    return cs.TOL[kernel.replace("_general", "")]


def main():
    import torch

    from nav2_social_mpc_controller_tpu_torch import _build

    from nav2_social_mpc_controller_tpu_torch.models import sfm as K5

    from nav2_social_mpc_controller_tpu_torch import kernel_shapes

    _, smi = cs.phase_device()
    kind, variants, threads, systems, against = parse_args(sys.argv[1:])
    cs.phase_build()
    libs, usage = build_all(kind, variants)
    cs.emit({"ptxas": usage})
    cs.emit({"launch_floor_ms": cs.launch_floor_ms(REPS)})
    times, errs, tols, bits = collections.defaultdict(list), {}, {}, {}
    full = _build.load()  # the checkout's library: every entry point
    order = list(libs)
    if kind == "rollout_sample":  # the two launches it replaces, in turns with it
        libs["k6_then_k1"] = full
        order.append("k6_then_k1")
    if kind == "spd_solve_general":  # the library's solve, in turns with the kernels
        libs["library"] = full
        order.append("library")
    per_scenario = K5.general_threads_per_scenario
    solve_geometry = kernel_shapes.general_solve_geometry
    at = ([f"t{t}" for t in threads] + [f"s{n}" for n in systems]
          if kind == "spd_solve_general" else [str(t) for t in threads])
    for a in at:  # the shipped K5 at other threads a scenario; K7 at other geometries
        libs[f"shipped@{a}"] = libs["shipped"]
        order.append(f"shipped@{a}")

    def geometry(name):
        a = name.split("@")[1] if "@" in name else ""
        if kind != "spd_solve_general":
            K5.general_threads_per_scenario = (lambda n: int(a)) if a else per_scenario
            return
        if not a:
            kernel_shapes.general_solve_geometry = solve_geometry
            return

        def at_geometry(d, n=int(a[1:]), what=a[0]):
            threads_, systems_, _ = solve_geometry(d)
            if what == "t" and d > kernel_shapes.GENERAL_SOLVE_WARP_MAX_D:
                threads_ = n
            if what == "s" and d <= kernel_shapes.GENERAL_SOLVE_WARP_MAX_D:
                systems_ = n
            return threads_, systems_, systems_ * kernel_shapes.general_solve_shared_bytes(d)
        kernel_shapes.general_solve_geometry = at_geometry
    try:
        for shape, cap in captures(kind).items():
            for kernel, run, plain in kernels(kind):
                if kernel.startswith("damped_step") and "propose" not in cap:
                    continue  # random systems: the standalone solve only
                if kernel != "spd_solve" and "library" in order:
                    names = [n for n in order if n != "library"]
                else:
                    names = order
                _build._lib = full
                ref = plain(cap)
                if kernel == "sfm_scan_general":
                    cap["calm"] = cs.sfm_order_sensitivity(
                        cap["sfm"], cs.sfm_keywords(cap["cfg"]), ref)[0]
                tols[(shape, kernel)] = tolerance(kernel, cap)
                outs = {}
                big = "spd_solve" in cap and cap["spd_solve"][1].shape[1] > 64
                reps = REPS // 10 if big else REPS
                for rnd in range(ROUNDS):
                    for name in (names if rnd % 2 == 0 else names[::-1]):
                        _build._lib = libs[name]
                        geometry(name)
                        fn = ((lambda: plain(cap)) if name == "k6_then_k1" else
                              (lambda: library_solve(cap)) if name == "library" else
                              (lambda: run(cap)))
                        if rnd == 0:
                            out = fn()
                            errs[(shape, kernel, name)] = (
                                None if name == "library" else error(kernel, out, ref, cap))
                            if against is not None:
                                outs[name] = ([out] if torch.is_tensor(out) else
                                              [out[k] for k in sorted(out)]
                                              if isinstance(out, dict) else list(out))
                        times[(shape, kernel, name)].append(cs.time_cuda(fn, reps))
                for name, out in outs.items():
                    bits[(shape, kernel, name)] = cs.bits_differ(out, outs[against])
                outs.clear()
    finally:
        _build._lib = full
        K5.general_threads_per_scenario = per_scenario
        kernel_shapes.general_solve_geometry = solve_geometry
    torch.cuda.synchronize()
    table = [{"shape": s, "kernel": k, "variant": n, "ms": v, "min_ms": min(v),
              "err": errs[(s, k, n)], "tol": None if n == "library" else tols[(s, k)],
              **({"bits_differ_from": {against: bits[(s, k, n)]}} if against else {})}
             for (s, k, n), v in times.items()]
    cs.emit({"variants": table})
    print(smi, flush=True)
    bad = [r for r in table if r["tol"] is not None and not r["err"] <= r["tol"]]
    if bad:
        cs.fail(f"variants beyond their tolerance: {bad}")


if __name__ == "__main__":
    main()
