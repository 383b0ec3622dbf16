#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

drives the port's main paths — ``make_step_batch`` on the social benchmark
configuration (three valid people per scenario) and on the obstacle-only one,
B = 4096 scenarios with 120x120 grids, three ticks with the warm-start carry
fed back, then one tick each of the six-agent and the stress-horizon
configurations at B = 1024 — through the six hand-written CUDA kernels, and
checks them. Phases, each printing one JSON line:

  device     the card (torch + nvidia-smi name and power limit)
  build      nvcc build of csrc/*.cu into the package's build/ directory
  shapes     kernel-vs-plain at a people-free D = 12 / S = 39 shape (and K1
             at S = 70); then with every person valid at the social
             (B = 4096, N = 3), six-agent (B = 1024, N = 6) and
             stress-horizon (B = 1024, D = 12, S = 39) shapes, every fourth
             robot near its goal (shrunk block maps, no person in view): the
             SFM scan (K5), K2 with its people stages and the rollout prep (K6)
  main_path  one line per path: launch counts, status, bounds, cursor, the
             people projection; for the 3-tick paths agreement of 64
             scenarios with the port's plain path on the CPU in float32
  timing     ms/tick and solves/s at B = 1024 and B = 4096 for the obstacle
             and the social configuration, tick breakdown, launches, memory
  kernels    K1-K6 at the social main path's shapes (inputs captured from a
             real tick): error vs the plain version against a stated
             tolerance, kernel / plain / library ms, the bound, launches

``python3 chip_smoke.py --lm-sync-sweep`` runs, instead of the phases after
``build``, the one measurement behind the LM loop's ``DEFAULT_CHECK_EVERY``:
ms/tick by how often the loop asks the device whether every lane is done.

Any failed check raises: the exit code is then not 0 and no ``ok`` line is
printed. Without a CUDA device the script exits with code 1 at once. The last
line of a good run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores

B_MAIN = 4096
B_WIDE = 1024  # batch of the D = 12 / S = 39 kernel check
N_BASE = 64  # distinct scenarios (seeds), tiled on the device to B
N_TICKS = 3
POSE_STRIDE = 4  # plan points the robot advances per tick
SPIN_CYCLES = 100_000_000  # ~50 ms of device spin, see time_cuda


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_cuda(fn, reps, warm=3):
    """Mean device milliseconds of fn() over `reps` back-to-back calls.

    The kernels here run for a few microseconds, less than the host needs to
    launch one, so a plain event pair would time the host. The stream is
    therefore first blocked by a spin kernel (~50 ms); the host queues the
    calls behind it, and the events then bracket the device running them back
    to back. (A callable that makes more launches than the launch queue holds
    is still partly timed by the host: that is the plain versions' own cost.)"""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def time_host(fn, reps):
    """Mean host milliseconds one call of fn() takes to return (the wrapper's
    checks, allocations and the launch), the device not waited for."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def norm_err(got, ref):
    """Largest |got - ref| per scenario over max(1, max |ref|) of that
    scenario; returns (scale-normalised error, max abs error)."""
    got = got.double().reshape(got.shape[0], -1)
    ref = ref.double().reshape(ref.shape[0], -1)
    if not torch.equal(torch.isfinite(got), torch.isfinite(ref)):
        return float("inf"), float("inf")
    fin = torch.isfinite(ref)
    diff = torch.where(fin, (got - ref).abs(), torch.zeros_like(ref))
    scale = torch.where(fin, ref.abs(), torch.zeros_like(ref)).max(dim=1).values.clamp(min=1.0)
    return float((diff.max(dim=1).values / scale).max()), float(diff.max())


def lanes_beyond(got, ref, level):
    """Number of scenarios whose scale-normalised error exceeds `level`."""
    got = got.double().reshape(got.shape[0], -1)
    ref = ref.double().reshape(ref.shape[0], -1)
    scale = ref.abs().max(dim=1).values.clamp(min=1.0)
    return int((((got - ref).abs().max(dim=1).values / scale) > level).sum())


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_flops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------


def make_batch(cfg, batch, dev, n_valid_people=0):
    """`batch` scenarios on the device: N_BASE distinct seeds generated with
    NumPy, tiled. Returns (scenario, per-tick robot poses)."""
    from nav2_social_mpc_controller_tpu_torch.core.types import scenario_from_numpy
    from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario_batch

    base = scenario_from_numpy(
        make_scenario_batch(cfg, N_BASE, base_seed=0, n_valid_people=n_valid_people), device=dev)
    reps = batch // N_BASE

    def tile(t):
        return t.repeat((reps,) + (1,) * (t.ndim - 1)).contiguous()

    def tile_tree(tree):
        return type(tree)(*(tile_tree(x) if isinstance(x, tuple) else tile(x) for x in tree))

    sc = tile_tree(base)
    poses = []
    for t in range(N_TICKS):
        i = torch.clamp(torch.full_like(sc.path.n, t * POSE_STRIDE), max=sc.path.n - 1).long()
        pts = torch.gather(sc.path.points, 1, i[:, None, None].expand(-1, 1, 2))[:, 0]
        yaw = torch.gather(sc.path.yaw, 1, i[:, None])
        poses.append(torch.cat([pts, yaw], dim=1).contiguous())
    return sc, poses


def with_pose(sc, pose):
    return sc._replace(robot=sc.robot._replace(pose=pose))


def near_goal_every(sc, pose, every=4):
    """`pose` with every `every`-th robot moved 2-7 plan points before its
    goal: its horizon and block length shrink (another block map), trailing
    steps are masked, and the people lie behind it, outside its view."""
    k = torch.arange(pose.shape[0], device=pose.device)
    i = (sc.path.n.long() - 2 - (k // every) % 6).clamp(min=0)
    pts = torch.gather(sc.path.points, 1, i[:, None, None].expand(-1, 1, 2))[:, 0]
    yaw = torch.gather(sc.path.yaw, 1, i[:, None])
    near = torch.cat([pts, yaw], dim=1)
    return torch.where((k % every == every - 1)[:, None], near, pose).contiguous()


def capture_iteration(cfg, sc, carry, n_iters=3):
    """Inputs of K1-K6 as a real tick hands them over: the problem of this
    scenario batch, advanced `n_iters` LM iterations, then one more
    iteration taken apart."""
    from nav2_social_mpc_controller_tpu_torch.controller.controller import fov_filter, step_pre
    from nav2_social_mpc_controller_tpu_torch.controller.optimize import ProblemDims, make_lm_config
    from nav2_social_mpc_controller_tpu_torch.ops.fused_iter import build_value_grad
    from nav2_social_mpc_controller_tpu_torch.solver import lm

    dims = ProblemDims.from_config(cfg)
    lm_cfg = make_lm_config(cfg.optimizer)
    prep = step_pre(cfg, sc, carry).prep
    vg = build_value_grad(cfg, dims, prep.rows, prep.n_rows, prep.people_proj,
                          prep.people_present, prep.costmap)
    b = prep.u0.shape[0]
    cost, g, jtj = vg(prep.u0)
    st = lm.LMState(
        u=prep.u0, cost=cost, g=g, jtj=jtj,
        radius=torch.full((b,), lm_cfg.initial_radius, device=cost.device),
        decrease_factor=torch.full((b,), 2.0, device=cost.device),
        iters=torch.zeros((b,), dtype=torch.int32, device=cost.device),
        done=~torch.isfinite(cost),
        term=torch.zeros((b,), dtype=torch.int32, device=cost.device),
        failed=~torch.isfinite(cost),
    )
    for _ in range(n_iters):
        st = lm.lm_iteration(vg, prep.lower, prep.upper, lm_cfg, st)
    propose_in = (st.u, st.g, st.jtj, st.radius, prep.lower, prep.upper)
    u_new, delta, mc = lm.propose(lm_cfg, *propose_in)
    prep_in = vg.prep_inputs(u_new)
    _, win, row, col = vg.bicubic_inputs(u_new)
    fused_in = vg.fused_inputs(u_new)
    new_cost, g_new, jtj_new = vg(u_new)
    commit_in = tuple(st) + (u_new, delta, mc, new_cost, g_new, jtj_new)
    people = fov_filter(cfg, sc.people, sc.robot.pose, sc.costmap)
    return {
        "lm_cfg": lm_cfg, "dims": dims, "bicubic": (win, row.contiguous(), col.contiguous()),
        "sfm": sfm_inputs(sc, people.state, prep), "rollout_prep": prep_in,
        "fused": fused_in, "propose": propose_in, "commit": commit_in,
    }


# ---------------------------------------------------------------------------
# kernel vs plain
# ---------------------------------------------------------------------------

# Tolerances of kernel vs plain version, scale-normalised per scenario (see
# norm_err). K1/K2: nvcc contracts a*b+c into FMA and K2's warp reduction
# sums in another order than the plain version, so they differ by float32
# rounding of 16-term (K1) and ~150-term (K2) sums. K3/K4 are written with
# round-to-nearest intrinsics that are never contracted and repeat the plain
# version operation for operation: expected 0, gated at 1e-6. K5 (SFM scan)
# carries FMA contraction and CUDA's own atan2f/expf/sinf/cosf through up to
# 39 steps of the pedestrian dynamics, and the angular velocity divides a yaw
# difference by the time step; its t column (validity) must be exact. K2 with
# its people stages on runs exp/atan2/sin/cos chains of ~60 dual operations
# per pair force, CUDA's functions against torch's: 3e-5, the JAX package's
# tolerance for its fused kernel; people-free it stays at 1e-5. K6 sums in
# the plain version's (serial) order and is held element by element to the
# JAX package's tolerances for its rollout kernel: |got - ref| <= atol +
# 2e-5 |ref| with atol 1e-5, and 2e-4 on row/col (values up to 64 cells);
# its error is reported as a share of that allowance (tolerance 1.0), and its
# expanded controls, being copies, must be equal.
TOL = {"sfm_scan": 1e-4, "rollout_prep": 1.0, "bicubic": 1e-5, "fused_iter": 1e-5,
       "fused_iter_people": 3e-5, "propose": 1e-6, "commit": 1e-6}
K6_RTOL, K6_ATOL, K6_ATOL_ROWCOL = 2e-5, 1e-5, 2e-4


def sfm_inputs(sc, people_state, prep):
    """Arguments of the SFM scan wrapper for this scenario batch and problem."""
    return (people_state.contiguous(), prep.rows, prep.n_rows, sc.esdf.indexes,
            sc.esdf.origin, sc.esdf.resolution, sc.esdf.valid)


def check_sfm(cfg, args, reps):
    from nav2_social_mpc_controller_tpu_torch.models import sfm as K5

    kw = dict(maxtime=cfg.trajectorizer.max_time, dt=cfg.trajectorizer.time_step,
              people_desired_vel=cfg.people_desired_vel, people_radius=cfg.people_radius,
              goal_radius=cfg.goal_radius, esdf_window=cfg.esdf_window_cells)
    got = K5.project_people(*args, **kw)
    ref = K5.project_people_plain(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got[..., 3], ref[..., 3]):
        fail("kernel sfm_scan: the t column (agent validity) differs from the plain version")
    err = norm_err(got, ref)
    people, rows, n_rows = args[:3]
    b, n, _ = people.shape
    s1 = rows.shape[1]
    # The work depends on the data: only valid agents are simulated, and only
    # over the steps the robot's rows cover. Bytes: every input but the index
    # grid read once, one 4-byte grid cell per lookup made, the output written
    # once. Operations: ~120 per pair force (two atan2f and two expf counted
    # as one each), ~100 per agent step for the other forces and the update.
    nv = ((people[..., 3] != -1.0) & args[6][:, None]).sum(dim=1).double()
    steps = (n_rows.double() - 1.0).clamp(0.0, float(s1 - 1))
    lookups = float((nv * (steps + 1.0)).sum())
    flops = float((steps * (nv * nv * 120.0 + nv * 100.0)).sum())
    moved = nbytes(people, rows, n_rows, args[4], args[5], args[6], got) + 4.0 * lookups
    bnd, by = bound(moved, flops)
    return {
        "shape": f"people({b},{n},6) rows({b},{s1},6)", "valid_agents": int(nv.sum()),
        "max_err": err[0], "max_abs_err": err[1], "tol": TOL["sfm_scan"],
        "ms": time_cuda(lambda: K5.project_people(*args, **kw), reps),
        "host_ms": time_host(lambda: K5.project_people(*args, **kw), reps),
        "plain_ms": time_cuda(lambda: K5.project_people_plain(*args, **kw), 2, warm=1),
        "bound_ms": bnd, "bound_by": by, "library_ms": None,
    }


def check_rollout(args, reps):
    from nav2_social_mpc_controller_tpu_torch.ops import rollout_cuda as K6

    got = K6.rollout_prep(*args)
    ref = K6.rollout_prep_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(got["v"], ref["v"]):
        fail("kernel rollout_prep: the expanded controls are not copies of u")
    share, worst_abs = 0.0, 0.0
    for name, r in ref.items():
        atol = K6_ATOL_ROWCOL if name in ("row", "col") else K6_ATOL
        diff = (got[name].double() - r.double()).abs()
        if not bool(torch.isfinite(diff).all()):
            share = float("inf")
        share = max(share, float((diff / (atol + K6_RTOL * r.double().abs())).max()))
        worst_abs = max(worst_abs, float(diff.max()))
    u, pose0, block_idx, origin, res = args[:5]
    b, s = block_idx.shape
    nb = args[7]
    # Bytes: the inputs once, the 6 + 4*NB output planes once. Operations per
    # step: two sincosf counted as ~40, ~20 for the pose and the sample
    # coordinates, 8 per block for the sensitivities.
    bnd, by = bound(nbytes(u, pose0, block_idx, origin, res) + (6 + 4 * nb) * b * s * 4,
                    b * s * (60.0 + 8.0 * nb))
    maps = len({tuple(r) for r in block_idx[:256].tolist()})
    chain_ms = time_cuda(lambda: K6.rollout_prep_plain(*args), max(reps // 10, 3))
    return {
        "shape": f"B={b} S={s} NB={nb}", "distinct_block_maps_in_256": maps,
        "max_err": share, "max_abs_err": worst_abs, "tol": TOL["rollout_prep"],
        "tol_rule": f"|got-ref| <= atol + {K6_RTOL}|ref|, atol {K6_ATOL} ({K6_ATOL_ROWCOL} row/col)",
        "ms": time_cuda(lambda: K6.rollout_prep(*args), reps),
        "host_ms": time_host(lambda: K6.rollout_prep(*args), reps),
        "plain_ms": chain_ms, "bound_ms": bnd, "bound_by": by,
        # No single PyTorch call computes this function; the nearest library
        # form is the torch.cumsum chain the port ran before this kernel,
        # which is the plain version itself.
        "library_ms": chain_ms, "library_is": "the plain version's torch.cumsum chain",
    }


def check_bicubic(win, row, col, reps):
    from nav2_social_mpc_controller_tpu_torch.ops import bicubic_cuda as K1

    got = K1.bicubic_linearize(win, row, col)
    ref = K1.bicubic_linearize_plain(win, row, col)
    torch.cuda.synchronize()
    errs = [norm_err(a, b) for a, b in zip(got, ref)]
    b, h, w = win.shape
    s = row.shape[1]
    # The work depends on the data: a sample reads its 4x4 taps, not the whole
    # window. Count every distinct window cell this run's samples touch once,
    # row/col read once, the three outputs written once; ~150 flops a sample.
    ridx = K1.tap_index(torch.floor(row), h)  # (B, S, 4)
    cidx = K1.tap_index(torch.floor(col), w)
    cells = (torch.arange(b, device=win.device)[:, None, None, None] * h
             + ridx[..., :, None]) * w + cidx[..., None, :]
    touched = int(torch.unique(cells).numel())
    bnd, by = bound(touched * win.element_size() + nbytes(row, col) + 3 * nbytes(row),
                    150.0 * b * s)
    return {
        "shape": f"win({b},{h},{w}) S={s}", "window_cells_touched": touched,
        "max_err": max(e[0] for e in errs), "max_abs_err": max(e[1] for e in errs),
        "tol": TOL["bicubic"],
        "ms": time_cuda(lambda: K1.bicubic_linearize(win, row, col), reps),
        "host_ms": time_host(lambda: K1.bicubic_linearize(win, row, col), reps),
        "plain_ms": time_cuda(lambda: K1.bicubic_linearize_plain(win, row, col), max(reps // 10, 3)),
        "bound_ms": bnd, "bound_by": by, "library_ms": None,
    }


def check_fused(args, reps):
    from nav2_social_mpc_controller_tpu_torch.ops import fused_iter as K2

    got = K2.fused_cost_g_jtj(*args)
    ref = K2.fused_cost_g_jtj_plain(*args)
    torch.cuda.synchronize()
    errs = [norm_err(a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)) for a, b in zip(got, ref)]
    statics, u = args[0], args[1]
    dth, agents, m_step, m_social = args[10], args[15], args[16], args[18]
    b, nb, s = dth.shape
    d = 2 * nb
    n = statics.n_agents
    tensors = [t for t in args[1:] if isinstance(t, torch.Tensor) and t is not agents]
    # The work depends on the data: masked-off steps are skipped, and the
    # agents are read (5 of their 6 fields) only for steps whose social mask
    # is on. A contraction costs 8D + D(D+1) + 3 operations; a step of the
    # people stages 2N pair forces of ~450 operations each (60 dual
    # operations of ~7, atan2f/expf/sinf/cosf counted as one each) plus the
    # proxemics scan, and three more contractions.
    live = float(m_step.sum())
    social = float(m_social.sum())
    contraction = 8 * d + d * (d + 1) + 3
    flops = (live * (5 * contraction + 120) + social * (2 * n * 450 + 10 * n + 3 * contraction)
             + b * statics.n_vf * 40)
    bnd, by = bound(nbytes(*tensors) + nbytes(*got) + social * n * 5 * 4, flops)
    people = social > 0
    return {
        "shape": f"B={b} S={s} D={d} N={n}", "social_steps": int(social),
        "max_err": max(e[0] for e in errs), "max_abs_err": max(e[1] for e in errs),
        "tol": TOL["fused_iter_people" if people else "fused_iter"],
        "scenarios_beyond_1e-5": max(lanes_beyond(a, b_, 1e-5) for a, b_ in zip(got, ref)),
        "ms": time_cuda(lambda: K2.fused_cost_g_jtj(*args), reps),
        "host_ms": time_host(lambda: K2.fused_cost_g_jtj(*args), reps),
        "plain_ms": time_cuda(lambda: K2.fused_cost_g_jtj_plain(*args), max(reps // 10, 3)),
        "bound_ms": bnd, "bound_by": by, "library_ms": None,
    }


def check_propose(lm_cfg, args, reps):
    from nav2_social_mpc_controller_tpu_torch.solver import cuda_iter as K

    got = K.propose(lm_cfg, *args)
    ref = K.propose_plain(lm_cfg, *args)
    torch.cuda.synchronize()
    errs = [norm_err(a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)) for a, b in zip(got, ref)]
    u, g, jtj, radius = args[:4]
    b, d = u.shape
    bnd, by = bound(nbytes(*args) + nbytes(*got), b * (d**3 / 3.0 + 6.0 * d * d + 10.0 * d))

    def library():
        # One library factorisation + solve of the same damped system; timed
        # as a yardstick only, the port never calls it.
        diag = torch.diagonal(jtj, dim1=1, dim2=2).clamp(lm_cfg.min_diagonal, lm_cfg.max_diagonal)
        a = jtj + torch.diag_embed(diag / radius[:, None])
        chol, _ = torch.linalg.cholesky_ex(a)
        return torch.cholesky_solve(-g[:, :, None], chol)

    return {
        "shape": f"B={b} D={d}",
        "max_err": max(e[0] for e in errs), "max_abs_err": max(e[1] for e in errs),
        "tol": TOL["propose"],
        "ms": time_cuda(lambda: K.propose(lm_cfg, *args), reps),
        "host_ms": time_host(lambda: K.propose(lm_cfg, *args), reps),
        "plain_ms": time_cuda(lambda: K.propose_plain(lm_cfg, *args), 3, warm=1),
        "bound_ms": bnd, "bound_by": by, "library_ms": time_cuda(library, max(reps // 10, 3)),
    }


def check_commit(lm_cfg, args, reps):
    from nav2_social_mpc_controller_tpu_torch.solver import cuda_iter as K

    got = K.commit(lm_cfg, *args)
    ref = K.commit_plain(lm_cfg, *args)
    torch.cuda.synchronize()
    worst, worst_abs = 0.0, 0.0
    for a, b_, name in zip(got, ref, ("u", "cost", "g", "jtj", "radius", "decrease_factor",
                                      "iters", "done", "term", "failed")):
        if a.dtype != b_.dtype:
            fail(f"commit: {name} dtype {a.dtype} != plain {b_.dtype}")
        if a.is_floating_point():
            e = norm_err(a.reshape(a.shape[0], -1), b_.reshape(b_.shape[0], -1))
            worst, worst_abs = max(worst, e[0]), max(worst_abs, e[1])
        elif not torch.equal(a, b_):
            fail(f"commit: discrete output {name} differs from the plain version "
                 f"in {int((a != b_).sum())} lanes")
    b, d = args[0].shape
    bnd, by = bound(nbytes(*args) + nbytes(*got), b * (12.0 * d + 40.0))
    return {
        "shape": f"B={b} D={d}",
        "max_err": worst, "max_abs_err": worst_abs, "tol": TOL["commit"],
        "ms": time_cuda(lambda: K.commit(lm_cfg, *args), reps),
        "host_ms": time_host(lambda: K.commit(lm_cfg, *args), reps),
        "plain_ms": time_cuda(lambda: K.commit_plain(lm_cfg, *args), 5, warm=1),
        "bound_ms": bnd, "bound_by": by, "library_ms": None,
    }


KERNEL_INFO = {
    "sfm_scan": {
        "route": "cuda", "source": "nav2_social_mpc_controller_tpu_torch/csrc/sfm_scan.cu",
        "replaces": "nav2_social_mpc_controller_tpu/models/sfm_pallas.py:306",
    },
    "rollout_prep": {
        "route": "cuda", "source": "nav2_social_mpc_controller_tpu_torch/csrc/rollout_prep.cu",
        "replaces": "nav2_social_mpc_controller_tpu/ops/rollout_pallas.py:158",
    },
    "bicubic": {
        "route": "cuda", "source": "nav2_social_mpc_controller_tpu_torch/csrc/bicubic.cu",
        "replaces": "nav2_social_mpc_controller_tpu/ops/bicubic_pallas.py:288 (and :346)",
    },
    "fused_iter": {
        "route": "cuda", "source": "nav2_social_mpc_controller_tpu_torch/csrc/fused_iter.cu",
        "replaces": "nav2_social_mpc_controller_tpu/ops/fused_iter.py:462",
    },
    "propose": {
        "route": "cuda", "source": "nav2_social_mpc_controller_tpu_torch/csrc/tr_iter.cu",
        "replaces": "nav2_social_mpc_controller_tpu/solver/pallas_iter.py:322",
    },
    "commit": {
        "route": "cuda", "source": "nav2_social_mpc_controller_tpu_torch/csrc/tr_iter.cu",
        "replaces": "nav2_social_mpc_controller_tpu/solver/pallas_iter.py:362",
    },
}


def check_all_kernels(cfg, cap, reps):
    out = {
        "sfm_scan": check_sfm(cfg, cap["sfm"], reps),
        "rollout_prep": check_rollout(cap["rollout_prep"], reps),
        "bicubic": check_bicubic(*cap["bicubic"], reps),
        "fused_iter": check_fused(cap["fused"], reps),
        "propose": check_propose(cap["lm_cfg"], cap["propose"], reps),
        "commit": check_commit(cap["lm_cfg"], cap["commit"], reps),
    }
    for name, r in out.items():
        if not r["max_err"] <= r["tol"]:
            fail(f"kernel {name} disagrees with its plain version at {r['shape']}: "
                 f"scale-normalised error {r['max_err']:.3e} > tolerance {r['tol']:.1e}")
    return out


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: FAILED: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        raise SystemExit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    # Nothing in the port may enable TF32; the kernels use no tensor cores.
    if torch.backends.cuda.matmul.allow_tf32:
        fail("torch.backends.cuda.matmul.allow_tf32 is on")
    dev = {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    emit({"phase": "device", **dev, "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return dev, smi


def phase_build():
    from nav2_social_mpc_controller_tpu_torch import _build

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.load()
    seconds = time.perf_counter() - t0
    regs = [ln.strip() for ln in _build.last_build_log.splitlines()
            if "registers" in ln or "spill" in ln.lower() or "entry function" in ln]
    print("\n".join(regs), file=sys.stderr)
    emit({"phase": "build", "seconds": seconds, "sources": len(_build.sources())})


def phase_shapes(dev):
    """Kernel vs plain away from the main path's shape: the stress-horizon
    config (D = 12, S = 39) people-free at B = 1024, K1 also at S = 70; then
    the kernels that read people at the three people shapes."""
    from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry
    from nav2_social_mpc_controller_tpu_torch.core.config import benchmark_stress_h36_config

    cfg = benchmark_stress_h36_config()
    b = B_WIDE
    sc, poses = make_batch(cfg, b, dev)
    cap = capture_iteration(cfg, with_pose(sc, poses[0]), make_carry(cfg, b, device=dev))
    if cap["dims"].s != 39 or cap["propose"][0].shape[1] != 12:
        fail(f"wide shape is not S=39/D=12: {cap['dims']}")
    res = check_all_kernels(cfg, cap, reps=50)
    win = cap["bicubic"][0]
    gen = torch.Generator(device=dev).manual_seed(0)
    row = torch.rand((b, 70), device=dev, generator=gen) * 70.0 - 3.0  # straddles the border
    col = torch.rand((b, 70), device=dev, generator=gen) * 70.0 - 3.0
    s70 = check_bicubic(win, row, col, reps=50)
    if not s70["max_err"] <= s70["tol"]:
        fail(f"kernel bicubic disagrees at S=70: {s70['max_err']:.3e} > {s70['tol']:.1e}")
    emit({"phase": "shapes", "kernels_wide": [{"name": k, **v} for k, v in res.items()]
          + [{"name": "bicubic", **s70}] + phase_people_shapes(dev)})


def phase_people_shapes(dev):
    """The kernels that read people against their plain versions with every
    person VALID: the social config at the main path's shape (B = 4096, N = 3,
    S = 29), six agents (B = 1024, N = 6), and the stress horizon (B = 1024,
    D = 12, S = 39). Every fourth robot stands near its goal, so the batch
    mixes block maps and scenarios with and without a person in view. K5 is
    given the unfiltered people; K2 and K6 the inputs of a real tick after
    3 LM iterations."""
    from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry
    from nav2_social_mpc_controller_tpu_torch.core import config as C

    out = []
    for name, batch in (("benchmark_social_config", B_MAIN),
                        ("benchmark_omni_6agents_config", B_WIDE),
                        ("benchmark_stress_h36_config", B_WIDE)):
        cfg = getattr(C, name)()
        sc, poses = make_batch(cfg, batch, dev, n_valid_people=cfg.n_agents)
        sc = with_pose(sc, near_goal_every(sc, poses[0]))
        cap = capture_iteration(cfg, sc, make_carry(cfg, batch, device=dev))
        sfm_args = (sc.people.state,) + cap["sfm"][1:]
        checks = {"sfm_scan": check_sfm(cfg, sfm_args, reps=50),
                  "fused_iter": check_fused(cap["fused"], reps=50),
                  "rollout_prep": check_rollout(cap["rollout_prep"], reps=50)}
        if checks["sfm_scan"]["valid_agents"] != batch * cfg.n_agents:
            fail(f"sfm_scan check at {name}: only {checks['sfm_scan']['valid_agents']} valid agents")
        present = float(cap["fused"][18].any(dim=1).float().mean())
        if not 0.2 <= present <= 0.8:
            fail(f"{name}: {present:.2f} of the scenarios have a person in view; the check "
                 "needs a batch that mixes scenarios with and without")
        if checks["rollout_prep"]["distinct_block_maps_in_256"] < 2:
            fail(f"{name}: the rollout-prep check needs mixed block maps")
        for kname, r in checks.items():
            if not r["max_err"] <= r["tol"]:
                fail(f"kernel {kname} disagrees with its plain version at {name} {r['shape']}: "
                     f"{r['max_err']:.3e} > {r['tol']:.1e}")
            out.append({"name": kname, "config": name, "share_with_people": present, **r})
    return out


def run_ticks(step, sc, poses, carry):
    outs = []
    for pose in poses:
        cmd, aux, carry = step(with_pose(sc, pose), carry)
        outs.append((cmd, aux))
    torch.cuda.synchronize()
    return outs, carry


def head(tree, n, to):
    """The first n scenarios of a batched tree, moved to device `to`."""
    return type(tree)(*(head(x, n, to) if isinstance(x, tuple) else x[:n].to(to) for x in tree))


def phase_main_path(name, cfg, dev, batch, n_valid_people, n_ticks=N_TICKS, compare_cpu=True):
    """Drive one path: `n_ticks` ticks of make_step_batch(cfg) at `batch`
    scenarios with the carry fed back, the launch counts set to 0 just before
    and read just after. Returns (launches, scenario, poses)."""
    from nav2_social_mpc_controller_tpu_torch import _build
    from nav2_social_mpc_controller_tpu_torch.controller.controller import (
        fov_filter, make_carry, make_step_batch, step_pre,
    )
    from nav2_social_mpc_controller_tpu_torch.controller.optimize import ProblemDims
    from nav2_social_mpc_controller_tpu_torch.core.types import STATUS_OK
    from nav2_social_mpc_controller_tpu_torch.ops.fused_iter import build_value_grad

    sc, poses = make_batch(cfg, batch, dev, n_valid_people=n_valid_people)
    poses = poses[:n_ticks]
    step = make_step_batch(cfg, device=dev)
    carry0 = make_carry(cfg, batch, device=dev)

    _build.reset_launch_counts()
    outs, carry = run_ticks(step, sc, poses, carry0)
    launches = dict(_build.launch_counts)

    for kname, n in launches.items():
        if n <= 0:
            fail(f"{name}: kernel {kname} was never launched on the main path")
    opt = cfg.optimizer
    dims = ProblemDims.from_config(cfg)
    prev_cursor = torch.zeros_like(carry.plan_start)
    iters_mean, with_people = [], []
    for t, (cmd, aux) in enumerate(outs):
        if not bool(aux.solve.usable.all()):
            fail(f"{name} tick {t}: {int((~aux.solve.usable).sum())} lanes unusable")
        if not bool((aux.status == STATUS_OK).all()):
            fail(f"{name} tick {t}: status not all STATUS_OK")
        for x in (cmd.linear_x, cmd.angular_z, aux.local_path, aux.cmds, aux.people_proj):
            if not bool(torch.isfinite(x).all()):
                fail(f"{name} tick {t}: non-finite output")
        if not bool(((cmd.linear_x >= opt.v_min) & (cmd.linear_x <= opt.v_max)
                     & (cmd.angular_z >= opt.w_min) & (cmd.angular_z <= opt.w_max)).all()):
            fail(f"{name} tick {t}: a published command left its bounds")
        if not bool((aux.plan_start_index >= prev_cursor).all()):
            fail(f"{name} tick {t}: the plan cursor went backwards")
        prev_cursor = aux.plan_start_index
        # The people projection: row 0 is the FOV-filtered input, and a
        # scenario's agents are projected (t != -1 at step 1) exactly when it
        # keeps a valid person; a people-free batch is all padding.
        proj = aux.people_proj
        if tuple(proj.shape) != (batch, dims.maxsize, cfg.n_agents, 6):
            fail(f"{name} tick {t}: people projection of shape {tuple(proj.shape)}")
        seen = fov_filter(cfg, sc.people, poses[t], sc.costmap)
        if not torch.equal(proj[:, 0], seen.state):
            fail(f"{name} tick {t}: projection row 0 is not the filtered people")
        if not torch.equal((proj[:, 1, :, 3] != -1.0), seen.valid):
            fail(f"{name} tick {t}: projected rows are not valid exactly where a person is")
        if n_valid_people == 0 and not bool((proj[:, 1:, :, :3] == 0.0).all()):
            fail(f"{name} tick {t}: the projection of a people-free batch is not padding")
        with_people.append(float(seen.valid.any(dim=1).float().mean()))
        iters_mean.append(float(aux.solve.iterations.float().mean()))
    if n_valid_people > 0 and not with_people[0] >= 0.5:
        fail(f"{name}: only {with_people[0]:.2f} of the scenarios have a person in view")
    if n_ticks > 1 and not bool((carry.prev_n > 0).all() and (carry.plan_start > 0).all()):
        fail(f"{name}: the carry was not fed back (prev_n / plan_start still 0)")
    if tuple(outs[0][1].local_path.shape) != (batch, dims.maxsize, 3):
        fail(f"{name}: unexpected local_path shape {tuple(outs[0][1].local_path.shape)}")
    term = torch.bincount(outs[-1][1].solve.termination.long(), minlength=6).tolist()
    line = {
        "phase": "main_path", "config": name, "batch": batch, "ticks": n_ticks,
        "valid_people_per_scenario": n_valid_people, "share_with_a_person_in_view": with_people,
        "launches": launches, "launches_per_tick": {k: v / n_ticks for k, v in launches.items()},
        "mean_lm_iterations_per_tick": iters_mean, "termination_counts_last_tick": term,
    }
    if not compare_cpu:
        emit(line)
        return launches, sc, poses

    # Tick 1 of the first N_BASE scenarios against the port's plain path on
    # the CPU in float32 (same code, kernels' plain versions).
    sc_cpu = head(with_pose(sc, poses[0]), N_BASE, "cpu")
    step_cpu = make_step_batch(cfg, device="cpu")
    cmd_c, aux_c, _ = step_cpu(sc_cpu, make_carry(cfg, N_BASE, device="cpu"))
    cmd_g, aux_g = outs[0]
    if not torch.equal(aux_g.status[:N_BASE].cpu(), aux_c.status):
        fail(f"{name}: status differs between the card and the CPU plain path")
    if not torch.equal(aux_g.plan_start_index[:N_BASE].cpu(), aux_c.plan_start_index):
        fail(f"{name}: plan cursor differs between the card and the CPU plain path")
    vals = {}
    for side, where, scen in (("card", dev, head(with_pose(sc, poses[0]), N_BASE, dev)),
                              ("cpu", "cpu", sc_cpu)):
        prep = step_pre(cfg, scen, make_carry(cfg, N_BASE, device=where)).prep
        vals[side] = build_value_grad(cfg, dims, prep.rows, prep.n_rows, prep.people_proj,
                                       prep.people_present, prep.costmap)(prep.u0)
    init_err = max(
        norm_err(a.cpu().reshape(N_BASE, -1), b_.reshape(N_BASE, -1))[0]
        for a, b_ in zip(vals["card"], vals["cpu"])
    )
    if not init_err <= 1e-4:
        fail(f"{name}: initial cost/g/JtJ differ between the card and the CPU: {init_err:.3e} > 1e-4")
    delta = torch.maximum(
        (cmd_g.linear_x[:N_BASE].cpu() - cmd_c.linear_x).abs(),
        (cmd_g.angular_z[:N_BASE].cpu() - cmd_c.angular_z).abs(),
    )
    p50 = float(delta.quantile(0.5))
    if not p50 <= 1e-3:
        fail(f"{name}: command delta p50 between the card and the CPU is {p50:.3e} > 1e-3")
    # A lane that stopped by a tolerance on both sides after the same number
    # of iterations walked the same trajectory and must agree. Lanes stopped
    # by the iteration cap chatter at float32, and the function tolerance
    # (relative cost decrease below fn_tol) is a discrete branch that two
    # float32 trajectories can take many iterations apart; both tails are
    # reported, not gated.
    it_g, it_c = aux_g.solve.iterations[:N_BASE].cpu(), aux_c.solve.iterations
    stopped = (aux_g.solve.termination[:N_BASE].cpu() != 0) & (aux_c.solve.termination != 0)
    converged = stopped & (it_g == it_c)
    apart = stopped & (it_g != it_c)
    worst_conv = float(delta[converged].max()) if bool(converged.any()) else 0.0
    if not worst_conv <= 1e-3:
        fail(f"{name}: a lane converged on the card and on the CPU after the same number of "
             f"iterations yet differs by {worst_conv:.3e}")
    line["gpu_vs_cpu"] = {
        "scenarios": N_BASE, "initial_cost_g_jtj_norm_err": init_err,
        "cmd_delta_p50": p50, "cmd_delta_p90": float(delta.quantile(0.9)),
        "cmd_delta_max": float(delta.max()),
        "share_within_1e-3": float((delta <= 1e-3).float().mean()),
        "converged_on_both": int(converged.sum()), "converged_delta_max": worst_conv,
        "tolerance_stops_iterations_apart": int(apart.sum()),
        "tolerance_stops_apart_delta_max": float(delta[apart].max()) if bool(apart.any()) else 0.0,
        "iterations_equal_share": float(
            (aux_g.solve.iterations[:N_BASE].cpu() == aux_c.solve.iterations).float().mean()),
    }
    emit(line)
    return launches, sc, poses


def count_device_launches(fn, top=8):
    """Device kernels one call of fn() starts, from torch.profiler: (their
    number, their summed device time in ms, the `top` kernels by device time
    as [name, count, ms]); (None, None, None) if the profiler records no
    device activity on this machine."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if str(getattr(ev, "device_type", "")).endswith("CUDA") and dev_us > 0:
            rows.append([ev.key[:72], ev.count, dev_us / 1e3])
    if not rows:
        return None, None, None
    rows.sort(key=lambda r: -r[2])
    return sum(r[1] for r in rows), sum(r[2] for r in rows), rows[:top]


def phase_timing(configs, dev):
    """`configs`: (name, cfg, valid people per scenario) of each path timed."""
    from nav2_social_mpc_controller_tpu_torch import _build
    from nav2_social_mpc_controller_tpu_torch.controller.controller import (
        make_carry, make_step_batch, step_post, step_pre,
    )
    from nav2_social_mpc_controller_tpu_torch.controller.optimize import solve_prepared

    def sync_clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    cells = []
    for name, cfg, n_valid_people, batch in [
            (*c, batch) for c in configs for batch in (1024, B_MAIN)]:
        sc, poses = make_batch(cfg, batch, dev, n_valid_people=n_valid_people)
        step = make_step_batch(cfg, device=dev)
        # Twelve warm-up ticks: after only three, the timed ticks at B = 4096
        # came out 1.5x slower than the same ticks later in the same process.
        for _ in range(4):
            run_ticks(step, sc, poses, make_carry(cfg, batch, device=dev))
        ticks = []
        for _ in range(3):
            carry = make_carry(cfg, batch, device=dev)
            for pose in poses:
                ms, (_, _, carry) = sync_clock(lambda: step(with_pose(sc, pose), carry))
                ticks.append(ms)
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        outs, carry = run_ticks(step, sc, poses, make_carry(cfg, batch, device=dev))
        per_tick = {k: v / N_TICKS for k, v in _build.launch_counts.items()}
        peak = torch.cuda.max_memory_allocated()
        aux = outs[-1][1]
        # breakdown of the last (warm) tick by stage, host clock around syncs
        scen = with_pose(sc, poses[-1])
        carry_in = run_ticks(step, sc, poses[:-1], make_carry(cfg, batch, device=dev))[1]
        stages = {"tick_head": [], "solve": [], "tick_tail": []}
        with torch.no_grad():
            for _ in range(5):  # the host clock spreads: keep the least of five
                ms, ctx = sync_clock(lambda: step_pre(cfg, scen, carry_in))
                stages["tick_head"].append(ms)
                ms, (u, stats) = sync_clock(lambda: solve_prepared(cfg, ctx.prep))
                stages["solve"].append(ms)
                ms, _ = sync_clock(lambda: step_post(cfg, ctx, carry_in, u, stats))
                stages["tick_tail"].append(ms)
        n_dev, dev_ms, top_kernels = count_device_launches(lambda: step(scen, carry_in))
        ms = float(np.mean(ticks))
        cells.append({
            "config": name, "batch": batch, "ms_per_tick": ms, "solves_per_s": batch / ms * 1e3,
            "ms_per_tick_p50": float(np.median(ticks)), "ms_per_tick_min": float(np.min(ticks)),
            "mean_lm_iterations": float(aux.solve.iterations.float().mean()),
            "max_lm_iterations": int(aux.solve.iterations.max()),
            "termination_counts": torch.bincount(aux.solve.termination.long(), minlength=6).tolist(),
            "kernel_launches_per_tick": per_tick,
            "device_launches_per_tick": n_dev, "device_busy_ms_per_tick": dev_ms,
            "top_device_kernels": top_kernels,
            "breakdown_min_ms": {k: float(np.min(v)) for k, v in stages.items()},
            "peak_device_memory_bytes": peak,
        })
    emit({"phase": "timing", "cells": cells})


def phase_lm_sync_sweep(cfg, dev, policies=(0, 1, 4, 8)):
    """ms/tick with lm_solve(check_every=k) for each k, timed in turns
    (forwards, backwards, forwards) so that no policy always runs first. The
    results of a tick do not depend on k (done lanes are frozen bit for bit)."""
    from nav2_social_mpc_controller_tpu_torch.controller.controller import (
        make_carry, step_post, step_pre,
    )
    from nav2_social_mpc_controller_tpu_torch.controller.optimize import ProblemDims, make_lm_config
    from nav2_social_mpc_controller_tpu_torch.ops.fused_iter import build_value_grad
    from nav2_social_mpc_controller_tpu_torch.solver.lm import lm_solve

    dims = ProblemDims.from_config(cfg)
    lm_cfg = make_lm_config(cfg.optimizer)

    def tick(k, scen, carry):
        ctx = step_pre(cfg, scen, carry)
        p = ctx.prep
        vg = build_value_grad(cfg, dims, p.rows, p.n_rows, p.people_proj, p.people_present,
                              p.costmap)
        u, stats = lm_solve(vg, p.u0, p.lower, p.upper, lm_cfg, check_every=k)
        return step_post(cfg, ctx, carry, u, stats)

    cells = []
    with torch.no_grad():
        for batch in (1024, B_MAIN):
            sc, poses = make_batch(cfg, batch, dev)
            ticks = {k: [] for k in policies}
            for rnd in range(4):  # round 0 warms up and is not kept
                for k in policies[:: 1 if rnd % 2 == 0 else -1]:
                    carry = make_carry(cfg, batch, device=dev)
                    for pose in poses:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        _, _, carry = tick(k, with_pose(sc, pose), carry)
                        torch.cuda.synchronize()
                        if rnd > 0:
                            ticks[k].append((time.perf_counter() - t0) * 1e3)
            cells.append({
                "batch": batch,
                "mean_ms_per_tick": {str(k): float(np.mean(v)) for k, v in ticks.items()},
                "min_ms_per_tick": {str(k): float(np.min(v)) for k, v in ticks.items()},
            })
    emit({"phase": "lm_sync_sweep", "ticks_per_policy": 9, "cells": cells})


def main():
    dev_info, smi = phase_device()
    dev = "cuda"
    phase_build()

    from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry
    from nav2_social_mpc_controller_tpu_torch.core.config import (
        benchmark_obstacle_only_config, benchmark_omni_6agents_config, benchmark_social_config,
        benchmark_stress_h36_config,
    )

    obstacle = benchmark_obstacle_only_config()
    if sys.argv[1:] == ["--lm-sync-sweep"]:
        phase_lm_sync_sweep(obstacle, dev)
        print(smi, flush=True)
        return 0
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}")
    phase_shapes(dev)
    social = benchmark_social_config()
    launches, sc, poses = phase_main_path("social", social, dev, B_MAIN, social.n_agents)
    launches_obstacle, _, _ = phase_main_path("obstacle", obstacle, dev, B_MAIN, 0)
    omni6 = benchmark_omni_6agents_config()
    phase_main_path("omni6", omni6, dev, B_WIDE, omni6.n_agents, n_ticks=1, compare_cpu=False)
    stress36 = benchmark_stress_h36_config()
    phase_main_path("stress36", stress36, dev, B_WIDE, stress36.n_agents, n_ticks=1,
                    compare_cpu=False)
    phase_timing([("obstacle", obstacle, 0), ("social", social, social.n_agents)], dev)

    # K1-K6 at the social main path's shapes, inputs captured from a real tick.
    cap = capture_iteration(social, with_pose(sc, poses[0]), make_carry(social, B_MAIN, device=dev))
    res = check_all_kernels(social, cap, reps=200)
    emit({"kernels": [
        {"name": k, **KERNEL_INFO[k], "launches": launches[k],
         "launches_obstacle_path": launches_obstacle[k], **v} for k, v in res.items()
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": dev_info})
    return 0


if __name__ == "__main__":
    sys.exit(main())
