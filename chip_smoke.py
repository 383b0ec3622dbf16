#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

drives the port's main paths — ``make_step_batch`` on the social benchmark
configuration (three valid people per scenario) and on the obstacle-only one,
B = 4096 scenarios with 120x120 grids, three ticks with the warm-start carry
fed back, then one tick each of the six-agent and the stress-horizon
configurations at B = 1024 — and the general paths: the debug-trace tick
(the general LM iteration, K7's damped step) on the social and the
stress-horizon configurations, a Jacobi-scaled solve, a latent-critic
tick (the autodiff residual path) and the compacted warm-start tick — through
the eight hand-written CUDA kernels (an evaluation's rollout and costmap
sample run as one, rollout_sample), and checks them. Phases, each printing
one JSON line:

  device     the card (torch + nvidia-smi name and power limit)
  build      nvcc build of csrc/*.cu into the package's build/ directory;
             ptxas registers, stack and spills of every kernel, and the SASS
             instruction counts (FP32, MUFU) of K2's pair force in each
             direction and of the robot's duals, one sincosf, one division,
             and K5's pair force and agent step, behind the operation bounds
             of K2, K5, K6 and rollout_sample
  shapes     kernel-vs-plain at a people-free D = 12 / S = 39 shape (and K1
             at S = 70); then with every person valid at the social
             (B = 4096, N = 3), six-agent (B = 1024, N = 6) and
             stress-horizon (B = 1024, D = 12, S = 39) shapes, every fourth
             robot near its goal (shrunk block maps, no person in view): the
             SFM scan (K5), K2 with its people stages, the rollout prep (K6)
             and rollout_sample; rollout_sample also at the obstacle tick's
             shape and on a ragged batch (B = 4101), each time bit for bit
             against K6 then K1
  main_path  one line per path: launch counts, status, bounds, cursor, the
             people projection; for the 3-tick paths agreement of 64
             scenarios with the port's plain path on the CPU in float32
  debug_tick social config with debug_optimizer=True, B = 4096, 3 ticks,
             then stress36 (D = 12) at B = 1024, 1 tick: K7's damped step
             launched once per LM iteration run, K3/K4 never; the trace's
             invariants; every result equal to the plain tick's, bit for
             bit; the first tick's solve through a caller's linear_solve
             (K7's standalone solve in the plain composition) equal to it
             bit for bit; device launches and busy ms per tick and per loop
             iteration of both solves
  jacobi     the same prepared problems through lm_solve with Jacobi scaling
             (the damped step with the scale), and through a caller's
             linear_solve, bit for bit; launches and busy ms of both
  latent_tick  social config with pure_angle_weight and curvature_weight,
             B = 1024, one tick through the residual path (K1 launched by the
             differentiable costmap sample, K2 never); and the residual
             path's (cost, g, JtJ) against the fused path's
  compacted_tick  warm_start_mode="previous_solution", B = 4096, 3 ticks:
             make_step_batch_compacted equal to make_step_batch bit for bit;
             iterations x width and ms/tick of both
  timing     ms/tick and solves/s at B = 1024 and B = 4096 for the obstacle
             and the social configuration, tick breakdown, launches, memory
  kernels    every kernel at the social main path's shapes (inputs captured from a
             real tick): error vs the plain version against a stated
             tolerance, kernel / plain / library ms, the bound, launches (K7:
             its damped step with and without the Jacobi scale and its
             standalone solve under `entries`);
             beside them the launch floor, an almost empty kernel timed the
             same way

``python3 chip_smoke.py --lm-sync-sweep`` runs, instead of the phases after
``build``, the one measurement behind the LM loop's ``DEFAULT_CHECK_EVERY``:
ms/tick by how often the loop asks the device whether every lane is done.

Any failed check raises: the exit code is then not 0 and no ``ok`` line is
printed. Without a CUDA device the script exits with code 1 at once. The last
line of a good run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores
# Instruction rates behind that figure (132 SMs at 1.98 GHz): the FP32 pipe
# issues 128 lanes per clock per SM (an FFMA is 2 of the 67e12 flops), the
# multi-function unit (MUFU: rcp, rsq, ex2, lg2, sin, cos) and the type
# conversions 16 (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0).
FP32_INSTR_PER_S = F32_FLOPS_PER_S / 2
SLOW_INSTR_PER_S = F32_FLOPS_PER_S / 16

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


def launch_floor_ms(reps):
    """Device ms of an almost empty kernel, torch.cuda._sleep(0), timed as
    time_cuda times the kernels: what any launch costs the card when the
    launches are queued back to back, the floor under a kernel of a few us."""
    return time_cuda(lambda: torch.cuda._sleep(0), reps)


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


def bound_by_instructions(bytes_moved, flops, fp32_instr, slow_instr):
    """The least time of a kernel whose transcendental chains were counted
    in SASS instructions: bytes over the memory rate against the operations,
    which take the larger of the FP32 pipe's time (`flops` counted as before
    plus `fp32_instr` instructions) and the MUFU/conversion pipe's time
    (`slow_instr`). Returns (ms, "bytes" or "operations", the three times)."""
    parts = {
        "bytes_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
        "fp32_ms": (flops / F32_FLOPS_PER_S + fp32_instr / FP32_INSTR_PER_S) * 1e3,
        "mufu_ms": slow_instr / SLOW_INSTR_PER_S * 1e3,
    }
    ops = max(parts["fp32_ms"], parts["mufu_ms"])
    return max(parts["bytes_ms"], ops), ("bytes" if parts["bytes_ms"] >= ops else "operations"), parts


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# instruction counts of the transcendental chains, from the compiled SASS
# ---------------------------------------------------------------------------

# Probe kernels compiled with the kernels' own flags, each one piece of the
# function K2's and K6's bounds count, with nothing of how the kernels list
# or select their work: the robot's duals at one step (seeded state, velocity
# from the heading's sin/cos), built as K2 builds them; one pair force in
# each direction with its own end (the force on the robot from one agent,
# stored; the force on one agent from the robot, squared), each of which
# also builds the robot's duals, counted once per step instead; one sincosf
# (K6's step; the headings K2 needs once per social step and agent) and one
# IEEE division (K6's row/col). The kernel source is included, so these are
# the same device functions.
SASS_PROBE_SOURCE = r"""
#include "fused_iter.cu"

__device__ __forceinline__ void probe_store(float* p, const Dual4& x) {
    p[0] = x.p;
#pragma unroll
    for (int k = 0; k < 4; ++k) p[1 + k] = x.t[k];
}

__device__ __forceinline__ void probe_state(const float* in, Dual4& x, Dual4& y, Dual4& vx,
                                            Dual4& vy) {
    const float* r = in + 6 * threadIdx.x;  // x, y, yaw, v, sin yaw, cos yaw
    const Dual4 yaw = d4_seed(r[2], 2);
    const Dual4 v = d4_seed(r[3], 3);
    x = d4_seed(r[0], 0);
    y = d4_seed(r[1], 1);
    vx = d4_mul(v, d4_cos(yaw, r[4], r[5]));
    vy = d4_mul(v, d4_sin(yaw, r[4], r[5]));
}

__device__ __forceinline__ void probe_agent(const float* in, Dual4& x, Dual4& y, Dual4& vx,
                                            Dual4& vy) {
    const float* q = in + 6 * blockDim.x + 4 * threadIdx.x;  // x, y, vx, vy
    x = d4_const(q[0]);
    y = d4_const(q[1]);
    vx = d4_const(q[2]);
    vy = d4_const(q[3]);
}

__global__ void probe_robot_state(const float* in, float* out) {
    Dual4 x, y, vx, vy;
    probe_state(in, x, y, vx, vy);
    float* o = out + 20 * threadIdx.x;
    probe_store(o, x);
    probe_store(o + 5, y);
    probe_store(o + 10, vx);
    probe_store(o + 15, vy);
}

__global__ void probe_force_on_robot(const float* in, float* out) {
    Dual4 x, y, vx, vy, ax, ay, avx, avy, fx, fy;
    probe_state(in, x, y, vx, vy);
    probe_agent(in, ax, ay, avx, avy);
    social_pair_force(x, y, vx, vy, ax, ay, avx, avy, fx, fy);
    probe_store(out + 10 * threadIdx.x, fx);
    probe_store(out + 10 * threadIdx.x + 5, fy);
}

__global__ void probe_force_on_agent(const float* in, float* out) {
    Dual4 x, y, vx, vy, ax, ay, avx, avy, fx, fy;
    probe_state(in, x, y, vx, vy);
    probe_agent(in, ax, ay, avx, avy);
    social_pair_force(ax, ay, avx, avy, x, y, vx, vy, fx, fy);
    probe_store(out + 5 * threadIdx.x, d4_add(d4_mul(fx, fx), d4_mul(fy, fy)));
}

__global__ void probe_sincosf(const float* in, float* out) {
    float s, c;
    sincosf(in[threadIdx.x], &s, &c);
    out[2 * threadIdx.x] = s;
    out[2 * threadIdx.x + 1] = c;
}

__global__ void probe_fdiv(const float* in, float* out) {
    out[threadIdx.x] = in[2 * threadIdx.x] / in[2 * threadIdx.x + 1];
}
"""
# K5's pieces, in a unit of their own (its helpers share names with K2's):
# one pair force, and one active step of an agent given the social force on
# it (the desired and obstacle forces, the update, the new yaw and angular
# velocity, the goal test and the nearest-obstacle lookup at the new
# position), each from memory to memory.
SFM_PROBE_SOURCE = r"""
#include "sfm_scan.cu"

__global__ void probe_sfm_pair(const SfmArgs a, const float* in, float* out) {
    const float* q = in + 8 * threadIdx.x;
    float fx, fy;
    pair_social(a, q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7], fx, fy);
    out[2 * threadIdx.x] = fx;
    out[2 * threadIdx.x + 1] = fy;
}

__global__ void probe_sfm_step(const SfmArgs a, const Esdf* es, Agent* agents,
                               const float* social) {
    Agent g = agents[threadIdx.x];
    float fdx, fdy, fox, foy;
    desired_force(a, g, fdx, fdy);
    obstacle_force(a, g, fox, foy);
    move(a, fdx, fdy, social[2 * threadIdx.x], social[2 * threadIdx.x + 1], fox, foy, g.px, g.py,
         g.vx, g.vy);
    goal_test(a, g, g.px, g.py);
    nearest_obstacle(a, es[threadIdx.x], g, g.px, g.py);
    heading(a, g, g.vx, g.vy);
    agents[threadIdx.x] = g;
}
"""
SASS_PROBES = ("probe_robot_state", "probe_force_on_robot", "probe_force_on_agent",
               "probe_sincosf", "probe_fdiv", "probe_sfm_pair", "probe_sfm_step")
# Opcodes issued to the FP32 pipe, and to the MUFU / conversion pipe.
FP32_OPCODES = {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET", "FCHK", "FSWZADD"}
SLOW_OPCODES = {"MUFU", "F2I", "I2F", "F2F", "FRND"}
SASS_COUNTS = {}  # probe -> {"fp32", "mufu", "all"}; filled by phase_build


def cuda_tool(name):
    """A CUDA toolkit program that sits beside nvcc."""
    from nav2_social_mpc_controller_tpu_torch import _build

    path = os.path.join(os.path.dirname(_build.find_nvcc()), name)
    if not os.path.exists(path):
        fail(f"{name} not found beside nvcc")
    return path


def start_sass_probes():
    """Start compiling the probe kernels to cubins (runs beside the build):
    [(cubin, nvcc process)], one per probe source."""
    from nav2_social_mpc_controller_tpu_torch import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    started = []
    for name, text in (("sass_probe", SASS_PROBE_SOURCE), ("sass_probe_sfm", SFM_PROBE_SOURCE)):
        src = os.path.join(_build.BUILD_DIR, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        cubin = os.path.join(_build.BUILD_DIR, f"{name}.cubin")
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-cubin", "-o",
               cubin, src]
        started.append((cubin, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    return started


SASS_LINE = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@(!?)(U?P\w+)\s+)?([A-Z][A-Z0-9_]*)\S*\s*([^;]*)")
# Below 105615 sinf/cosf reduce their argument inline; at or above it they
# branch to a long reduction (integer and local-memory work) that no angle of
# these kernels reaches: they lie within a few turns of 0. Likewise K5's
# angle wrap takes fmodf only where its argument reaches 2 * (2 pi) =
# 12.56637..., which no difference of two wrapped angles does.
HUGE_ANGLES = ("105615", "12.56637")


def sass_opcodes(listing):
    """{function name: its opcodes up to the first unconditional EXIT} of a
    cuobjdump -sass listing: a static count of the path these kernels run.
    Out-of-line slow paths (the subroutines after EXIT, e.g. of a division)
    and the inline path of a huge angle (the instructions a `@!P BRA` jumps
    over, P being set by a compare of |x| with one of HUGE_ANGLES) are left
    out; any other branch is counted whether taken or not."""
    funcs, name, done = {}, None, True
    huge, skip_to = set(), None
    for ln in listing.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name, done, huge, skip_to = m.group(1), False, set(), None
            funcs[name] = []
            continue
        m = SASS_LINE.match(ln)
        if not m or name is None or done:
            continue
        addr, negated, guard, op, args = (int(m.group(1), 16), m.group(2), m.group(3),
                                          m.group(4), m.group(5))
        if skip_to is not None:
            if addr < skip_to:
                continue
            skip_to = None
        funcs[name].append(op[:-3] if op.endswith("32I") else op)
        done = op == "EXIT" and not guard
        operands = [t.strip() for t in args.split(",")]
        if op == "BRA" and negated and guard in huge:
            skip_to = int(operands[-1], 16)
            continue
        # predicates this instruction writes: the leading ones, or a carry-out
        # after a register destination
        written = []
        for t in operands:
            if not re.fullmatch(r"U?P(\d|T)", t):
                break
            written.append(t)
        if len(operands) > 1 and not written and re.fullmatch(r"U?P\d", operands[1]):
            written.append(operands[1])
        huge.difference_update(written)
        if op == "FSETP" and any(h in args for h in HUGE_ANGLES) and written:
            huge.add(written[0])
    return funcs


def finish_sass_probes(started):
    funcs = {}
    for cubin, proc in started:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"nvcc failed for the SASS probes:\n{out}")
        listing = subprocess.run([cuda_tool("cuobjdump"), "-sass", cubin], capture_output=True,
                                 text=True, check=True).stdout
        funcs.update(sass_opcodes(listing))
    for probe in SASS_PROBES:
        ops = next((v for k, v in funcs.items() if probe in k), None)
        if not ops:
            fail(f"SASS probe {probe} not found in the cuobjdump listing")
        SASS_COUNTS[probe] = {"fp32": sum(op in FP32_OPCODES for op in ops),
                              "mufu": sum(op in SLOW_OPCODES for op in ops), "all": len(ops)}
    return dict(SASS_COUNTS)


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------


def make_batch(cfg, batch, dev, n_valid_people=0):
    """`batch` scenarios on the device: N_BASE distinct seeds generated with
    NumPy, tiled (the last copy cut where `batch` is no multiple of N_BASE).
    Returns (scenario, per-tick robot poses)."""
    from nav2_social_mpc_controller_tpu_torch.core.types import scenario_from_numpy
    from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario_batch

    base = scenario_from_numpy(
        make_scenario_batch(cfg, N_BASE, base_seed=0, n_valid_people=n_valid_people), device=dev)
    reps = -(-batch // N_BASE)

    def tile(t):
        return t.repeat((reps,) + (1,) * (t.ndim - 1))[:batch].contiguous()

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
    """Inputs of K1-K7 as a real tick hands them over: the problem of this
    scenario batch, advanced `n_iters` LM iterations, then one more
    iteration taken apart; the Jacobi scale from the problem's first JtJ."""
    from nav2_social_mpc_controller_tpu_torch.controller.controller import fov_filter, step_pre
    from nav2_social_mpc_controller_tpu_torch.controller.optimize import ProblemDims, make_lm_config
    from nav2_social_mpc_controller_tpu_torch.ops.fused_iter import build_value_grad
    from nav2_social_mpc_controller_tpu_torch.solver import cuda_iter, lm

    dims = ProblemDims.from_config(cfg)
    lm_cfg = make_lm_config(cfg.optimizer)
    prep = step_pre(cfg, sc, carry).prep
    vg = build_value_grad(cfg, dims, prep.rows, prep.n_rows, prep.people_proj,
                          prep.people_present, prep.costmap)
    b = prep.u0.shape[0]
    cost, g, jtj = vg(prep.u0)
    jac_scale = lm.jacobi_scale(jtj)  # frozen at iteration 0, as lm_solve does
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
        # the damped step of the general iteration takes propose's inputs
        # (and the Jacobi scale); a caller's linear_solve gets the damped
        # normal equations
        "jac_scale": jac_scale,
        "spd_solve": tuple(t.contiguous() for t in cuda_iter.damped_system(
            lm_cfg, st.g, st.jtj, st.radius)),
    }


# ---------------------------------------------------------------------------
# kernel vs plain
# ---------------------------------------------------------------------------

# Tolerances of kernel vs plain version, scale-normalised per scenario (see
# norm_err). K1/K2: nvcc contracts a*b+c into FMA and K2's warp reduction
# sums in another order than the plain version, so they differ by float32
# rounding of 16-term (K1) and ~150-term (K2) sums. K3/K4 are written with
# round-to-nearest intrinsics that are never contracted and repeat the plain
# version operation for operation: expected 0, gated at 1e-6. K7 compiles
# K3's bodies (csrc/damped_step.cuh) and chol.cuh's solve: its two entries are
# held to equal bits with their plain versions (NaN in the same places), its
# error the number of output elements whose bits differ, tolerance 0. K5 (SFM scan)
# carries FMA contraction and CUDA's own atan2f/expf/sinf/cosf through up to
# 39 steps of the pedestrian dynamics, and the angular velocity divides a yaw
# difference by the time step; its t column (validity) must be exact. K2 with
# its people stages on runs exp/atan2/sin/cos chains of ~60 dual operations
# per pair force, CUDA's functions against torch's: 3e-5, the JAX package's
# tolerance for its fused kernel; people-free it stays at 1e-5. K6 sums by
# warp scans (a tree order; the plain version's torch.cumsum is serial on
# the CPU and a scan on the card) and is held element by element to the
# JAX package's tolerances for its rollout kernel: |got - ref| <= atol +
# 2e-5 |ref| with atol 1e-5, and 2e-4 on row/col (values up to 64 cells);
# its error is reported as a share of that allowance (tolerance 1.0), and its
# expanded controls, being copies, must be equal. The rollout-sample kernel
# compiles K6's and K1's arithmetic from the headers they compile from: its
# error is the number of output elements whose bits differ from K6's then
# K1's on the card (NaN against NaN counted equal), tolerance 0.
TOL = {"sfm_scan": 1e-4, "rollout_prep": 1.0, "bicubic": 1e-5, "fused_iter": 1e-5,
       "fused_iter_people": 3e-5, "propose": 1e-6, "commit": 1e-6, "spd_solve": 0,
       "rollout_sample": 0}
K6_RTOL, K6_ATOL, K6_ATOL_ROWCOL = 2e-5, 1e-5, 2e-4


def sfm_inputs(sc, people_state, prep):
    """Arguments of the SFM scan wrapper for this scenario batch and problem."""
    return (people_state.contiguous(), prep.rows, prep.n_rows, sc.esdf.indexes,
            sc.esdf.origin, sc.esdf.resolution, sc.esdf.valid)


def sfm_keywords(cfg):
    """The SFM scan wrapper's keyword arguments for config `cfg`."""
    return dict(maxtime=cfg.trajectorizer.max_time, dt=cfg.trajectorizer.time_step,
                people_desired_vel=cfg.people_desired_vel, people_radius=cfg.people_radius,
                goal_radius=cfg.goal_radius, esdf_window=cfg.esdf_window_cells)


def check_sfm(cfg, args, reps):
    from nav2_social_mpc_controller_tpu_torch.models import sfm as K5

    kw = sfm_keywords(cfg)
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
    # once. Operations, by the SASS instructions of their probes: at each
    # active step of a valid agent one pair force from each other valid agent
    # and one from the robot, then the agent's step (update and lookup); the
    # robot's velocity (a sincosf) once per row of a scenario with a valid
    # agent.
    nv = ((people[..., 3] != -1.0) & args[6][:, None]).sum(dim=1).double()
    steps = (n_rows.double() - 1.0).clamp(0.0, float(s1 - 1))
    lookups = float((nv * (steps + 1.0)).sum())
    pairs = float((steps * nv * nv).sum())
    agent_steps = float((steps * nv).sum())
    robot_rows = float((nv > 0).sum()) * (s1 - 1)
    sc = SASS_COUNTS

    def instr(kind):
        return (pairs * sc["probe_sfm_pair"][kind] + agent_steps * sc["probe_sfm_step"][kind]
                + robot_rows * sc["probe_sincosf"][kind])

    moved = nbytes(people, rows, n_rows, args[4], args[5], args[6], got) + 4.0 * lookups
    bnd, by, parts = bound_by_instructions(moved, 0.0, instr("fp32"), instr("mufu"))
    ms = time_cuda(lambda: K5.project_people(*args, **kw), reps)
    # One block's scenarios alone (the first that hold a valid agent): the
    # launch and the chain of S - 1 dependent steps, nothing to hide it.
    per_block = K5.scan_geometry(n, b).scenarios_per_block
    first = int(torch.nonzero(nv > 0)[0]) if bool((nv > 0).any()) else 0
    one = tuple(a[first:first + per_block].contiguous() for a in args)
    one_block_ms = time_cuda(lambda: K5.project_people(*one, **kw), reps)
    return {
        "shape": f"people({b},{n},6) rows({b},{s1},6)", "valid_agents": int(nv.sum()),
        "pair_forces": int(pairs), "agent_steps": int(agent_steps),
        "max_err": err[0], "max_abs_err": err[1], "tol": TOL["sfm_scan"],
        "ms": ms, "ms_per_step": ms / max(s1 - 1, 1),
        "one_block_ms": one_block_ms, "one_block_ms_per_step": one_block_ms / max(s1 - 1, 1),
        "host_ms": time_host(lambda: K5.project_people(*args, **kw), reps),
        "plain_ms": time_cuda(lambda: K5.project_people_plain(*args, **kw), 2, warm=1),
        "bound_ms": bnd, "bound_by": by, "bound_parts": parts, "library_ms": None,
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
    # Bytes: the inputs once, the 6 + 4*NB output planes once; operations:
    # rollout_operations.
    bnd, by, parts = bound_by_instructions(
        nbytes(u, pose0, block_idx, origin, res) + (6 + 4 * nb) * b * s * 4,
        *rollout_operations(args))
    maps = len({tuple(r) for r in block_idx[:256].tolist()})
    chain_ms = time_cuda(lambda: K6.rollout_prep_plain(*args), max(reps // 10, 3))
    return {
        "shape": f"B={b} S={s} NB={nb}", "distinct_block_maps_in_256": maps,
        "max_err": share, "max_abs_err": worst_abs, "tol": TOL["rollout_prep"],
        "tol_rule": f"|got-ref| <= atol + {K6_RTOL}|ref|, atol {K6_ATOL} ({K6_ATOL_ROWCOL} row/col)",
        "ms": time_cuda(lambda: K6.rollout_prep(*args), reps),
        "host_ms": time_host(lambda: K6.rollout_prep(*args), reps),
        "plain_ms": chain_ms, "bound_ms": bnd, "bound_by": by, "bound_parts": parts,
        # No single PyTorch call computes this function; the nearest library
        # form is the torch.cumsum chain the port ran before this kernel,
        # which is the plain version itself.
        "library_ms": chain_ms, "library_is": "the plain version's torch.cumsum chain",
    }


def window_sectors(win, row, col):
    """(distinct 4-byte cells, distinct 32-byte sectors) of the windows that
    the samples at (row, col) read: a sample reads its 4x4 taps, not the
    whole window, and the card moves 32-byte sectors, so a bound counts each
    sector this run's samples touch once."""
    from nav2_social_mpc_controller_tpu_torch.ops import bicubic_cuda as K1

    b, h, w = win.shape
    ridx = K1.tap_index(torch.floor(row), h)  # (B, S, 4)
    cidx = K1.tap_index(torch.floor(col), w)
    cells = (torch.arange(b, device=win.device)[:, None, None, None] * h
             + ridx[..., :, None]) * w + cidx[..., None, :]
    return (int(torch.unique(cells).numel()),
            int(torch.unique(cells // (32 // win.element_size())).numel()))


def bits_differ(got, ref):
    """Number of elements whose bits differ (NaN against NaN counted equal)
    between two sequences of tensors."""
    n = 0
    for a, b in zip(got, ref):
        if a.dtype != b.dtype or a.shape != b.shape:
            return float("inf")
        if a.is_floating_point():
            nan = torch.isnan(a)
            n += int((nan != torch.isnan(b)).sum())
            both = ~(nan | torch.isnan(b))
            n += int((a.view(torch.int32) != b.view(torch.int32))[both].sum())
        else:
            n += int((a != b).sum())
    return float(n)


def prep_then_sample(win, args):
    """K6 then K1 on the card: what the rollout-sample kernel is held to."""
    from nav2_social_mpc_controller_tpu_torch.ops import bicubic_cuda as K1
    from nav2_social_mpc_controller_tpu_torch.ops import rollout_cuda as K6

    r = K6.rollout_prep(*args)
    val, d_row, d_col = K1.bicubic_linearize(win, r.pop("row"), r.pop("col"))
    return {**r, "val": val, "d_row": d_row, "d_col": d_col}


def rollout_operations(args):
    """(flops, FP32 instructions, MUFU instructions) of K6's function on
    these inputs: per step one sincosf and the two divisions of row/col by
    their SASS instruction counts, ~20 flops for the pose and the sample
    coordinates, 8 per block for the sensitivities."""
    b, s = args[2].shape
    nb = args[7]
    steps = b * s
    sc, dv = SASS_COUNTS["probe_sincosf"], SASS_COUNTS["probe_fdiv"]
    return (steps * (20.0 + 8.0 * nb), steps * (sc["fp32"] + 2 * dv["fp32"]),
            steps * (sc["mufu"] + 2 * dv["mufu"]))


def check_rollout_sample(win, args, reps):
    """The rollout-sample kernel against K6 then K1 on the same inputs (equal
    bits), and against its plain version (scale-normalised, for the record)."""
    from nav2_social_mpc_controller_tpu_torch.ops import rollout_cuda as K

    got = K.rollout_sample(win, *args)
    ref = prep_then_sample(win, args)
    plain = K.rollout_sample_plain(win, *args)
    torch.cuda.synchronize()
    keys = sorted(ref)
    differ = bits_differ([got[k] for k in keys], [ref[k] for k in keys])
    vs_plain = max(norm_err(got[k].reshape(got[k].shape[0], -1),
                            plain[k].reshape(plain[k].shape[0], -1))[0] for k in keys)
    u, pose0, block_idx, origin, res = args[:5]
    b, s = block_idx.shape
    nb = args[7]
    # Bytes: K6's inputs once, the windows' sectors its samples touch, the
    # 7 + 4*NB output planes once. Operations: K6's and ~150 flops a sample.
    r = K.rollout_prep_plain(*args)
    _, sectors = window_sectors(win, r["row"], r["col"])
    flops, fp32, mufu = rollout_operations(args)
    bnd, by, parts = bound_by_instructions(
        nbytes(u, pose0, block_idx, origin, res) + sectors * 32 + (7 + 4 * nb) * b * s * 4,
        flops + 150.0 * b * s, fp32, mufu)
    return {
        "shape": f"B={b} S={s} NB={nb} win({win.shape[1]},{win.shape[2]})",
        "max_err": differ, "max_abs_err": float(max(
            (got[k].double() - ref[k].double()).abs().nan_to_num(0.0).max() for k in keys)),
        "tol": TOL["rollout_sample"],
        "err_is": "output elements whose bits differ from rollout_prep then bicubic",
        "vs_plain_norm_err": vs_plain,
        "ms": time_cuda(lambda: K.rollout_sample(win, *args), reps),
        "k6_then_k1_ms": time_cuda(lambda: prep_then_sample(win, args), reps),
        "host_ms": time_host(lambda: K.rollout_sample(win, *args), reps),
        "plain_ms": time_cuda(lambda: K.rollout_sample_plain(win, *args), max(reps // 10, 3)),
        "bound_ms": bnd, "bound_by": by, "bound_parts": parts, "library_ms": None,
    }


def check_bicubic(win, row, col, reps):
    from nav2_social_mpc_controller_tpu_torch.ops import bicubic_cuda as K1

    got = K1.bicubic_linearize(win, row, col)
    ref = K1.bicubic_linearize_plain(win, row, col)
    torch.cuda.synchronize()
    errs = [norm_err(a, b) for a, b in zip(got, ref)]
    b, h, w = win.shape
    s = row.shape[1]
    # row/col read once, the three outputs written once, the window's sectors
    # the samples touch (window_sectors); ~150 flops a sample.
    touched, sectors = window_sectors(win, row, col)
    bnd, by = bound(sectors * 32 + nbytes(row, col) + 3 * nbytes(row), 150.0 * b * s)
    return {
        "shape": f"win({b},{h},{w}) S={s}", "window_cells_touched": touched,
        "window_sectors_touched": sectors,
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
    # is on. A contraction costs 8D + D(D+1) + 3 operations. A social step
    # needs the robot's duals once, the sin/cos of 1 + N headings, the force
    # on each of the N agents' slots and the force on the robot from each
    # valid agent (an invalid agent's is selected away), counted by the FP32
    # and MUFU instructions of their SASS probes (a force probe less the
    # robot's duals it also builds), plus the pair sums, the proxemics scan
    # and three more contractions.
    live = float(m_step.sum())
    social = float(m_social.sum())
    on_robot_pairs = float(((agents[..., 3] != -1.0) & m_social[..., None]).sum())
    on_agent_pairs = social * n
    contraction = 8 * d + d * (d + 1) + 3
    flops = (live * (5 * contraction + 120) + social * (10 * n + 3 * contraction)
             + b * statics.n_vf * 40)
    sc = SASS_COUNTS
    state = sc["probe_robot_state"]

    def people(kind):
        return (on_robot_pairs * (sc["probe_force_on_robot"][kind] - state[kind])
                + on_agent_pairs * (sc["probe_force_on_agent"][kind] - state[kind])
                + social * (state[kind] + (1 + n) * sc["probe_sincosf"][kind]))

    bnd, by, parts = bound_by_instructions(
        nbytes(*tensors) + nbytes(*got) + social * n * 5 * 4, flops, people("fp32"), people("mufu"))
    people = social > 0
    return {
        "shape": f"B={b} S={s} D={d} N={n}", "social_steps": int(social),
        "pair_forces": int(on_robot_pairs + on_agent_pairs),
        "max_err": max(e[0] for e in errs), "max_abs_err": max(e[1] for e in errs),
        "tol": TOL["fused_iter_people" if people else "fused_iter"],
        "scenarios_beyond_1e-5": max(lanes_beyond(a, b_, 1e-5) for a, b_ in zip(got, ref)),
        "ms": time_cuda(lambda: K2.fused_cost_g_jtj(*args), reps),
        "host_ms": time_host(lambda: K2.fused_cost_g_jtj(*args), reps),
        "plain_ms": time_cuda(lambda: K2.fused_cost_g_jtj_plain(*args), max(reps // 10, 3)),
        "bound_ms": bnd, "bound_by": by, "bound_parts": parts, "library_ms": None,
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
        "tol": TOL["propose"], "bits_differ": bits_differ(got, ref),
        "ms": time_cuda(lambda: K.propose(lm_cfg, *args), reps),
        "host_ms": time_host(lambda: K.propose(lm_cfg, *args), reps),
        "plain_ms": time_cuda(lambda: K.propose_plain(lm_cfg, *args), 3, warm=1),
        "bound_ms": bnd, "bound_by": by, "library_ms": time_cuda(library, max(reps // 10, 3)),
    }


def commit_bytes_needed(args, accept):
    """Bytes K4's function must move on this run's data, each once: the ten
    outputs; every lane's cost, radius, iters, done, failed, u and g; a lane
    already done its decrease, term and JtJ to pass them through; an active
    lane its decrease (when rejected), delta, model change and new cost; and
    only the source its accept flag selects: JtJ when rejected, u_new, g_new
    and jtj_new when accepted."""
    (u, cost, g, jtj, radius, decrease, iters, done, term, failed,
     u_new, delta, mc, new_cost, g_new, jtj_new) = args
    b = u.shape[0]

    def lane(*ts):
        return nbytes(*ts) // b

    n_done, n_acc = int(done.sum()), int(accept.sum())
    n_rej = b - n_done - n_acc
    return (nbytes(*args[:10])
            + b * lane(cost, radius, iters, done, failed, u, g)
            + n_done * lane(decrease, term, jtj)
            + n_rej * lane(decrease, delta, mc, new_cost, jtj)
            + n_acc * lane(delta, mc, new_cost, u_new, g_new, jtj_new))


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
    bnd, by = bound(commit_bytes_needed(args, K.commit_with_aux(lm_cfg, *args)[1].accept),
                    b * (12.0 * d + 40.0))
    return {
        "shape": f"B={b} D={d}",
        "max_err": worst, "max_abs_err": worst_abs, "tol": TOL["commit"],
        "ms": time_cuda(lambda: K.commit(lm_cfg, *args), reps),
        "host_ms": time_host(lambda: K.commit(lm_cfg, *args), reps),
        "plain_ms": time_cuda(lambda: K.commit_plain(lm_cfg, *args), 5, warm=1),
        "bound_ms": bnd, "bound_by": by, "library_ms": None,
    }


def damped_step_bytes(args, jac_scale=None):
    """Bytes K7's damped step must move: u, g, JtJ, radius, lower, upper and
    the scale read once; u_new, delta and the model change written once."""
    scale = () if jac_scale is None else (jac_scale,)
    return nbytes(*args, *scale) + nbytes(args[0], args[0], args[3])


def damped_step_bound(args, jac_scale=None):
    """Least time of K7's damped step: damped_step_bytes against its
    operations, as propose's (D^3/3 for the factorisation, 6 D^2 + 10 D for
    the substitutions, damping, projection and model change; D^2 + 2 D more
    for the scaling)."""
    b, d = args[0].shape
    flops = d**3 / 3.0 + 6.0 * d * d + 10.0 * d + (0 if jac_scale is None else d * d + 2.0 * d)
    return bound(damped_step_bytes(args, jac_scale), b * flops)


def check_spd_solve_system(a, b, reps):
    """K7's standalone entry, spd_solve(a, b), against spd_solve_plain:
    elements whose bits differ (NaN against NaN counted equal), device, host
    and plain ms, the library's solve of the same systems, the bound."""
    from nav2_social_mpc_controller_tpu_torch.solver import cuda_solve as K7

    got = K7.spd_solve(a, b)
    ref = K7.spd_solve_plain(a, b)
    torch.cuda.synchronize()
    n, d = b.shape
    # Bytes: a and b read once, x written once ((D*D + 2*D) * 4 per system).
    # Operations: D^3/3 for the factorisation, 2*D^2 for the substitutions.
    bnd, by = bound(nbytes(a, b, got), n * (d**3 / 3.0 + 2.0 * d * d))

    def library():
        # One library factorisation + solve of the same systems; timed as a
        # yardstick only, the port never calls it.
        chol, _ = torch.linalg.cholesky_ex(a)
        return torch.cholesky_solve(b[:, :, None], chol)

    return {
        "shape": f"N={n} D={d}", "non_finite_systems": int((~torch.isfinite(ref)).any(dim=1).sum()),
        "max_err": bits_differ([got], [ref]), "max_abs_err": norm_err(got, ref)[1],
        "tol": TOL["spd_solve"],
        "ms": time_cuda(lambda: K7.spd_solve(a, b), reps),
        "host_ms": time_host(lambda: K7.spd_solve(a, b), reps),
        "plain_ms": time_cuda(lambda: K7.spd_solve_plain(a, b), 3, warm=1),
        "bound_ms": bnd, "bound_by": by, "library_ms": time_cuda(library, max(reps // 10, 3)),
    }


def check_spd_solve(lm_cfg, cap, reps):
    """K7 at a capture: the damped step (the general iteration's entry)
    without and with the Jacobi scale, each against damped_step_plain and
    beside the parent's way of taking it (damped_system, the standalone
    solve, the map-back and project_step: `composition_ms`); then the
    standalone entry on the damped normal equations. The row's own numbers
    are the unscaled damped step's, the debug tick's entry; `max_err` counts
    the elements of all three whose bits differ from their plain versions."""
    from nav2_social_mpc_controller_tpu_torch.solver import cuda_iter as K
    from nav2_social_mpc_controller_tpu_torch.solver import cuda_solve as K7

    args = cap["propose"]
    u, g, jtj, radius, lower, upper = args
    b, d = u.shape

    def composition(jac):
        a, rhs = K.damped_system(lm_cfg, g, jtj, radius, jac)
        step = K7.spd_solve(a.contiguous(), rhs.contiguous())
        if jac is not None:
            step = jac * step
        return K.project_step(u, step, g, jtj, lower, upper)

    entries = {}
    for name, jac in (("damped_step", None), ("damped_step_jacobi", cap["jac_scale"])):
        got = K.damped_step(lm_cfg, *args, jac)
        ref = K.damped_step_plain(lm_cfg, *args, jac)
        torch.cuda.synchronize()
        bnd, by = damped_step_bound(args, jac)
        entries[name] = {
            "bits_differ": bits_differ(got, ref),
            "bits_differ_from_composition": bits_differ(got, composition(jac)),
            "max_abs_err": max(norm_err(x.reshape(b, -1), y.reshape(b, -1))[1]
                               for x, y in zip(got, ref)),
            "ms": time_cuda(lambda: K.damped_step(lm_cfg, *args, jac), reps),
            "host_ms": time_host(lambda: K.damped_step(lm_cfg, *args, jac), reps),
            "plain_ms": time_cuda(lambda: K.damped_step_plain(lm_cfg, *args, jac), 3, warm=1),
            "composition_ms": time_cuda(lambda: composition(jac), max(reps // 10, 3)),
            "bound_ms": bnd, "bound_by": by,
        }
    system = check_spd_solve_system(*cap["spd_solve"], reps)
    entries["spd_solve"] = system
    main = entries["damped_step"]
    return {
        "shape": f"B={b} D={d}",
        "max_err": sum(e["bits_differ"] + e["bits_differ_from_composition"]
                       for e in entries.values() if "bits_differ" in e) + system["max_err"],
        "max_abs_err": max(main["max_abs_err"], entries["damped_step_jacobi"]["max_abs_err"],
                           system["max_abs_err"]),
        "tol": TOL["spd_solve"],
        **{k: main[k] for k in ("ms", "host_ms", "plain_ms", "bound_ms", "bound_by")},
        # the library's factorisation and solve of the damped system, as K3's row
        "library_ms": system["library_ms"],
        "entries": entries,
    }


KERNEL_INFO = {
    "sfm_scan": {
        "route": "cuda", "source": "nav2_social_mpc_controller_tpu_torch/csrc/sfm_scan.cu",
        "replaces": "nav2_social_mpc_controller_tpu/models/sfm_pallas.py:306", "redesigned": "PR 6",
    },
    "rollout_prep": {
        "route": "cuda", "source": "nav2_social_mpc_controller_tpu_torch/csrc/rollout_prep.cu",
        "replaces": "nav2_social_mpc_controller_tpu/ops/rollout_pallas.py:158", "redesigned": "PR 4",
    },
    "bicubic": {
        "route": "cuda", "source": "nav2_social_mpc_controller_tpu_torch/csrc/bicubic.cu",
        "replaces": "nav2_social_mpc_controller_tpu/ops/bicubic_pallas.py:288 (and :346)",
        "redesigned": "PR 6",
    },
    "rollout_sample": {
        "route": "cuda", "source": "nav2_social_mpc_controller_tpu_torch/csrc/rollout_sample.cu",
        "replaces": "nav2_social_mpc_controller_tpu/ops/rollout_pallas.py:158 then "
                    "nav2_social_mpc_controller_tpu/ops/bicubic_pallas.py:288",
        "redesigned": "PR 6",
    },
    "fused_iter": {
        "route": "cuda", "source": "nav2_social_mpc_controller_tpu_torch/csrc/fused_iter.cu",
        "replaces": "nav2_social_mpc_controller_tpu/ops/fused_iter.py:462", "redesigned": "PR 4",
    },
    "propose": {
        "route": "cuda", "source": "nav2_social_mpc_controller_tpu_torch/csrc/tr_iter.cu",
        "replaces": "nav2_social_mpc_controller_tpu/solver/pallas_iter.py:322", "redesigned": "PR 5",
    },
    "commit": {
        "route": "cuda", "source": "nav2_social_mpc_controller_tpu_torch/csrc/tr_iter.cu",
        "replaces": "nav2_social_mpc_controller_tpu/solver/pallas_iter.py:362", "redesigned": "PR 5",
    },
    "spd_solve": {
        "route": "cuda", "source": "nav2_social_mpc_controller_tpu_torch/csrc/spd_solve.cu",
        "replaces": "nav2_social_mpc_controller_tpu/solver/pallas_solve.py:93", "redesigned": "PR 7",
    },
}

# Kernels of the default tick (K3/K4 iteration) and of the debug tick (general
# iteration: K7 in place of K3/K4). An evaluation runs K6's rollout and K1's
# sample as one launch, rollout_sample; the standalone K1 serves the latent
# tick's residual path, and the standalone K6 is the reference rollout_sample
# is held to.
DEFAULT_PATH_KERNELS = ("sfm_scan", "rollout_sample", "fused_iter", "propose", "commit")
DEBUG_PATH_KERNELS = ("sfm_scan", "rollout_sample", "fused_iter", "spd_solve")
LATENT_PATH_KERNELS = ("sfm_scan", "bicubic", "propose", "commit")


def check_all_kernels(cfg, cap, reps):
    out = {
        "sfm_scan": check_sfm(cfg, cap["sfm"], reps),
        "rollout_prep": check_rollout(cap["rollout_prep"], reps),
        "bicubic": check_bicubic(*cap["bicubic"], reps),
        "rollout_sample": check_rollout_sample(cap["bicubic"][0], cap["rollout_prep"], reps),
        "fused_iter": check_fused(cap["fused"], reps),
        "propose": check_propose(cap["lm_cfg"], cap["propose"], reps),
        "commit": check_commit(cap["lm_cfg"], cap["commit"], reps),
        "spd_solve": check_spd_solve(cap["lm_cfg"], cap, reps),
    }
    for name, r in out.items():
        if not r["max_err"] <= r["tol"]:
            fail(f"kernel {name} disagrees with its plain version at {r['shape']}: "
                 f"error {r['max_err']:.3e} > tolerance {r['tol']:.1e}")
    if out["propose"]["bits_differ"] != 0:  # K3 compiles the damped step's bodies
        fail(f"kernel propose: {out['propose']['bits_differ']:.0f} elements with other bits "
             f"than its plain version at {out['propose']['shape']}")
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


def ptxas_usage(log):
    """{kernel: {registers, stack_bytes, spill_stores, spill_loads}} from
    ptxas -v output (template kernels named like fused_kernel<3> or
    sfm_scan_kernel<3,1>)."""
    usage, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
        if m:
            raw = m.group(1)
            short = re.search(r"([a-z_]+_kernel)(?:I((?:L\w+?E)+)E)?", raw)
            targs = re.findall(r"L\w+?(\d+)E", short.group(2) or "") if short else []
            name = raw if not short else (
                f"{short.group(1)}<{','.join(targs)}>" if targs else short.group(1))
            usage.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            usage[name].update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            usage[name]["registers"] = int(m.group(1))
    return usage


def phase_build():
    from nav2_social_mpc_controller_tpu_torch import _build

    t0 = time.perf_counter()
    probes = start_sass_probes()
    _build.build(verbose=True)
    _build.load()
    seconds = time.perf_counter() - t0
    sass = finish_sass_probes(probes)
    regs = [ln.strip() for ln in _build.last_build_log.splitlines()
            if "registers" in ln or "spill" in ln.lower() or "entry function" in ln]
    print("\n".join(regs), file=sys.stderr)
    emit({"phase": "build", "seconds": seconds, "sources": len(_build.sources()),
          "ptxas": ptxas_usage(_build.last_build_log), "sass_probe_instructions": sass})


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
    # K7's standalone solve on random SPD systems with a few that are not
    # positive definite: the same bits, NaN in the same places on both sides.
    mixed = []
    for d in (6, 12):
        m = torch.randn((B_MAIN, d, d), device=dev, generator=gen)
        a = m @ m.transpose(1, 2) + 0.5 * torch.eye(d, device=dev)
        a[::97] = -a[::97]
        r = check_spd_solve_system(
            a.contiguous(), torch.randn((B_MAIN, d), device=dev, generator=gen), reps=50)
        if not r["max_err"] <= r["tol"] or r["non_finite_systems"] != len(range(0, B_MAIN, 97)):
            fail(f"kernel spd_solve on random systems at D={d}: {r['max_err']:.0f} elements with "
                 f"other bits, {r['non_finite_systems']} non-finite systems")
        mixed.append({"name": "spd_solve", "systems": "random SPD, every 97th negated", **r})
    # The rollout-sample kernel at the obstacle tick's shape and on a ragged
    # batch (the other default ticks' shapes are held with the people).
    from nav2_social_mpc_controller_tpu_torch.core.config import (
        benchmark_obstacle_only_config, benchmark_social_config,
    )

    fused_shapes = [
        {"name": "rollout_sample", "config": name,
         **check_rollout_sample(*evaluation_inputs(c, batch, dev, n_valid), reps=50)}
        for name, c, batch, n_valid in (
            ("benchmark_obstacle_only_config", benchmark_obstacle_only_config(), B_MAIN, 0),
            ("benchmark_social_config", benchmark_social_config(), B_MAIN + 5, 3))]
    for r in fused_shapes:
        if not r["max_err"] <= r["tol"]:
            fail(f"kernel rollout_sample differs from rollout_prep then bicubic at {r['config']} "
                 f"{r['shape']} in {r['max_err']:.0f} elements")
    emit({"phase": "shapes", "kernels_wide": [{"name": k, **v} for k, v in res.items()]
          + [{"name": "bicubic", **s70}] + mixed + phase_people_shapes(dev) + fused_shapes})


def evaluation_inputs(cfg, batch, dev, n_valid_people):
    """(window, K6's arguments) of the first evaluation of a tick of `batch`
    scenarios: the rollout-sample kernel's inputs."""
    from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry, step_pre
    from nav2_social_mpc_controller_tpu_torch.controller.optimize import build_value_grad

    sc, poses = make_batch(cfg, batch, dev, n_valid_people=n_valid_people)
    prep = step_pre(cfg, with_pose(sc, poses[0]), make_carry(cfg, batch, device=dev)).prep
    vg = build_value_grad(cfg, prep)
    return vg.win, vg.prep_inputs(prep.u0)


def phase_people_shapes(dev):
    """The kernels that read people against their plain versions with every
    person VALID: the social config at the main path's shape (B = 4096, N = 3,
    S = 29), six agents (B = 1024, N = 6), and the stress horizon (B = 1024,
    D = 12, S = 39). Every fourth robot stands near its goal, so the batch
    mixes block maps and scenarios with and without a person in view. K5 is
    given the unfiltered people; K2 and K6 the inputs of a real tick after
    3 LM iterations; the rollout-sample kernel the inputs of K6 and K1."""
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
                  "rollout_prep": check_rollout(cap["rollout_prep"], reps=50),
                  "rollout_sample": check_rollout_sample(cap["bicubic"][0], cap["rollout_prep"],
                                                         reps=50)}
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


def check_tick_outputs(where, cfg, cmd, aux):
    """All lanes usable and STATUS_OK, outputs finite, commands in bounds."""
    from nav2_social_mpc_controller_tpu_torch.core.types import STATUS_OK

    opt = cfg.optimizer
    if not bool(aux.solve.usable.all()):
        fail(f"{where}: {int((~aux.solve.usable).sum())} lanes unusable")
    if not bool((aux.status == STATUS_OK).all()):
        fail(f"{where}: status not all STATUS_OK")
    for x in (cmd.linear_x, cmd.angular_z, aux.local_path, aux.cmds, aux.people_proj):
        if not bool(torch.isfinite(x).all()):
            fail(f"{where}: non-finite output")
    if not bool(((cmd.linear_x >= opt.v_min) & (cmd.linear_x <= opt.v_max)
                 & (cmd.angular_z >= opt.w_min) & (cmd.angular_z <= opt.w_max)).all()):
        fail(f"{where}: a published command left its bounds")


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


def check_launches(name, launches, expected):
    """Every kernel of the path launched, every other kernel not at all."""
    for kname, n in launches.items():
        if kname in expected and n <= 0:
            fail(f"{name}: kernel {kname} was never launched on this path")
        if kname not in expected and n != 0:
            fail(f"{name}: kernel {kname} is not on this path yet was launched {n} times")


def check_one_sample_per_evaluation(name, launches):
    """An evaluation launches the rollout-sample kernel once, then K2."""
    if launches["rollout_sample"] != launches["fused_iter"]:
        fail(f"{name}: rollout_sample launched {launches['rollout_sample']} times for "
             f"{launches['fused_iter']} evaluations")


def loop_iterations(iterations, max_iterations):
    """LM iterations the loop of lm_solve ran for a batch whose lanes ran
    `iterations`: it stops at the first check (every DEFAULT_CHECK_EVERY-th
    iteration) that finds every lane done, or at the cap."""
    from nav2_social_mpc_controller_tpu_torch.solver.lm import DEFAULT_CHECK_EVERY as every

    return min(max_iterations, -(-int(iterations.max()) // every) * every)


def phase_main_path(name, cfg, dev, batch, n_valid_people, n_ticks=N_TICKS, compare_cpu=True):
    """Drive one path: `n_ticks` ticks of make_step_batch(cfg) at `batch`
    scenarios with the carry fed back, the launch counts set to 0 just before
    and read just after. Returns (launches, scenario, poses)."""
    from nav2_social_mpc_controller_tpu_torch import _build
    from nav2_social_mpc_controller_tpu_torch.controller.controller import (
        fov_filter, make_carry, make_step_batch, step_pre,
    )
    from nav2_social_mpc_controller_tpu_torch.controller.optimize import ProblemDims
    from nav2_social_mpc_controller_tpu_torch.ops.fused_iter import build_value_grad

    sc, poses = make_batch(cfg, batch, dev, n_valid_people=n_valid_people)
    poses = poses[:n_ticks]
    step = make_step_batch(cfg, device=dev)
    carry0 = make_carry(cfg, batch, device=dev)

    _build.reset_launch_counts()
    outs, carry = run_ticks(step, sc, poses, carry0)
    launches = dict(_build.launch_counts)

    check_launches(name, launches, DEFAULT_PATH_KERNELS)
    check_one_sample_per_evaluation(name, launches)
    opt = cfg.optimizer
    dims = ProblemDims.from_config(cfg)
    prev_cursor = torch.zeros_like(carry.plan_start)
    iters_mean, with_people = [], []
    for t, (cmd, aux) in enumerate(outs):
        check_tick_outputs(f"{name} tick {t}", cfg, cmd, aux)
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
                ms, (u, stats, _) = sync_clock(lambda: solve_prepared(cfg, ctx.prep))
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


def time_ticks(step, sc, poses, fresh_carry, rounds=2):
    """Host-clock ms of each tick (synchronised) over `rounds` runs of the
    tick sequence with the carry fed back, after the caller's warm-up."""
    ms = []
    for _ in range(rounds):
        carry = fresh_carry()
        for pose in poses:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, carry = step(with_pose(sc, pose), carry)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def profile_last_tick(step, sc, poses, fresh_carry):
    """(device launches, device busy ms) of the last tick of the sequence,
    from torch.profiler."""
    carry = run_ticks(step, sc, poses[:-1], fresh_carry())[1]
    scen = with_pose(sc, poses[-1])
    n_dev, dev_ms, _ = count_device_launches(lambda: step(scen, carry))
    return n_dev, dev_ms


def replace_optimizer(cfg, weights=None, **changes):
    import dataclasses

    opt = cfg.optimizer
    if weights:
        opt = dataclasses.replace(opt, weights=dataclasses.replace(opt.weights, **weights))
    return dataclasses.replace(cfg, optimizer=dataclasses.replace(opt, **changes))


def same_results(where, a, b):
    """Fail unless two (cmd, aux) pairs of a tick agree bit for bit in their
    commands, command sequences, paths and solver statistics."""
    (cmd_a, aux_a), (cmd_b, aux_b) = a, b
    pairs = {
        "linear_x": (cmd_a.linear_x, cmd_b.linear_x), "angular_z": (cmd_a.angular_z, cmd_b.angular_z),
        "cmds": (aux_a.cmds, aux_b.cmds), "local_path": (aux_a.local_path, aux_b.local_path),
        "iterations": (aux_a.solve.iterations, aux_b.solve.iterations),
        "termination": (aux_a.solve.termination, aux_b.solve.termination),
        "final_cost": (aux_a.solve.final_cost, aux_b.solve.final_cost),
        "status": (aux_a.status, aux_b.status),
    }
    for name, (x, y) in pairs.items():
        if not torch.equal(x, y):
            fail(f"{where}: {name} differs in {int((x != y).reshape(x.shape[0], -1).any(dim=1).sum())} "
                 f"of {x.shape[0]} lanes")


def general_solve_vs_composition(where, cfg, lm_cfg, dev, sc, pose, trace_len):
    """One tick's prepared problems solved by the general iteration twice:
    through K7's damped step (default_linear_solve, one launch an
    iteration) and through a caller's linear_solve that is K7's standalone
    solve (the composition of plain damping, solve, map-back and projection
    at full width). Fails unless both give the same bits (solution,
    statistics and trace). Returns the launch counts of the first, the loop
    iterations it ran, for each device launches and busy ms of the solve
    (torch.profiler) and per iteration of the loop, and the first's result."""
    from nav2_social_mpc_controller_tpu_torch import _build
    from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry, step_pre
    from nav2_social_mpc_controller_tpu_torch.controller.optimize import build_value_grad
    from nav2_social_mpc_controller_tpu_torch.solver.cuda_solve import spd_solve
    from nav2_social_mpc_controller_tpu_torch.solver.lm import default_linear_solve, lm_solve

    batch = pose.shape[0]
    with torch.no_grad():
        prep = step_pre(cfg, with_pose(sc, pose), make_carry(cfg, batch, device=dev)).prep
        vg = build_value_grad(cfg, prep)

        def solve(linear_solve):
            return lm_solve(vg, prep.u0, prep.lower, prep.upper, lm_cfg,
                            linear_solve=linear_solve, trace_len=trace_len)

        def leaves(out):
            return [out[0], *out[1], *(out[2] if trace_len else ())]

        _build.reset_launch_counts()
        fused = solve(default_linear_solve)
        torch.cuda.synchronize()
        launches = dict(_build.launch_counts)
        composed = solve(spd_solve)  # a caller's solve: not default_linear_solve
        torch.cuda.synchronize()
        differ = bits_differ(leaves(fused), leaves(composed))
        if differ != 0:
            fail(f"{where}: the solve through the damped step and through a caller's "
                 f"linear_solve (K7's standalone solve) differ in {differ:.0f} elements")
        ran = loop_iterations(fused[1].iterations, lm_cfg.max_iterations)
        profiles = {}
        for name, ls in (("damped_step", default_linear_solve), ("composition", spd_solve)):
            n_dev, dev_ms, _ = count_device_launches(lambda: solve(ls))
            profiles[name] = {
                "device_launches": n_dev, "device_busy_ms": dev_ms,
                "device_launches_per_loop_iteration": None if n_dev is None else n_dev / ran,
                "device_busy_ms_per_loop_iteration": None if dev_ms is None else dev_ms / ran,
            }
    return launches, ran, {"loop_iterations": ran, "bit_equal": True, **profiles}, fused


def phase_debug_tick(name, cfg, dev, sc, poses):
    """The debug-trace tick at full width: `cfg` with debug_optimizer=True on
    the batch the main path solved, the main path's ticks with the carry fed
    back. The general LM iteration launches K7's damped step once per
    iteration the loop runs and K3/K4 never; it repeats the default
    iteration's arithmetic, so every result must equal the plain tick's bit
    for bit (the gate ROADMAP.md defines — lanes that stopped after the same
    number of iterations within 1e-3 — is implied and checked first). Then
    the first tick's solve through a caller's linear_solve (K7's standalone
    solve) against the damped step (general_solve_vs_composition). Returns
    the launch counts."""
    from nav2_social_mpc_controller_tpu_torch import _build
    from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry, make_step_batch
    from nav2_social_mpc_controller_tpu_torch.controller.optimize import make_lm_config

    batch = sc.robot.pose.shape[0]
    dbg = replace_optimizer(cfg, debug_optimizer=True)
    t_len = cfg.optimizer.max_iterations
    plain_outs, plain_carry = run_ticks(
        make_step_batch(cfg, device=dev), sc, poses, make_carry(cfg, batch, device=dev))
    step = make_step_batch(dbg, device=dev)
    carry0 = make_carry(cfg, batch, device=dev)
    _build.reset_launch_counts()
    outs, carry = run_ticks(step, sc, poses, carry0)
    launches = dict(_build.launch_counts)
    where = f"debug_tick {name}"
    check_launches(where, launches, DEBUG_PATH_KERNELS)
    check_one_sample_per_evaluation(where, launches)

    ran = sum(loop_iterations(aux.solve.iterations, t_len) for _, aux in outs)
    if launches["spd_solve"] != ran:
        fail(f"{where}: spd_solve launched {launches['spd_solve']} times, the LM loops ran "
             f"{ran} iterations")
    apart_lanes, worst_same = 0, 0.0
    for t, ((cmd, aux), (cmd_p, aux_p)) in enumerate(zip(outs, plain_outs)):
        check_tick_outputs(f"{where} tick {t}", dbg, cmd, aux)
        trace = aux.lm_trace
        if trace is None or tuple(trace.cost.shape) != (batch, t_len):
            fail(f"{where} tick {t}: no (B, {t_len}) trace")
        iters = aux.solve.iterations.long()
        col = torch.arange(t_len, device=dev)[None, :]
        beyond = col >= iters[:, None]
        for field, buf in zip(trace._fields, trace):
            if bool(buf[beyond].any()):
                fail(f"{where} tick {t}: trace.{field} is not zero beyond a lane's iteration count")
        if not torch.equal(trace.cost[:, 0], aux.solve.initial_cost):
            fail(f"{where} tick {t}: trace.cost[:, 0] is not the initial cost")
        # The cost falls exactly on accepted rows and stays on rejected ones.
        inside = (col[:, 1:] < iters[:, None])
        fell = trace.cost[:, 1:] < trace.cost[:, :-1]
        same = trace.cost[:, 1:] == trace.cost[:, :-1]
        if not bool((torch.where(trace.accepted[:, :-1], fell, same) | ~inside).all()):
            fail(f"{where} tick {t}: the traced cost does not fall exactly on accepted rows")
        if not bool(trace.accepted.any(dim=1).all()):
            fail(f"{where} tick {t}: a lane accepted no step")
        delta = torch.maximum((cmd.linear_x - cmd_p.linear_x).abs(),
                              (cmd.angular_z - cmd_p.angular_z).abs())
        same_iters = aux.solve.iterations == aux_p.solve.iterations
        apart_lanes += int((~same_iters).sum())
        worst_same = max(worst_same, float(delta[same_iters].max()))
        if not worst_same <= 1e-3:
            fail(f"{where} tick {t}: a lane that stopped after the same number of iterations "
                 f"as on the plain tick differs by {worst_same:.3e} > 1e-3")
        same_results(f"{where} tick {t} vs the plain tick", (cmd, aux), (cmd_p, aux_p))
    for x, y in zip(carry, plain_carry):
        if not torch.equal(x, y):
            fail(f"{where}: the carry differs from the plain ticks' carry")

    def fresh():
        return make_carry(cfg, batch, device=dev)

    ms = time_ticks(step, sc, poses, fresh)
    n_dev, dev_ms = profile_last_tick(step, sc, poses, fresh)
    _, _, vs_caller, _ = general_solve_vs_composition(
        where, dbg, make_lm_config(dbg.optimizer), dev, sc, poses[0], t_len)
    ran_last = loop_iterations(outs[-1][1].solve.iterations, t_len)
    emit({
        "phase": "debug_tick", "config": f"{name} + debug_optimizer", "batch": batch,
        "ticks": len(outs), "launches": launches, "lm_loop_iterations": ran,
        "ms_per_tick": float(np.mean(ms)), "ms_per_tick_min": float(np.min(ms)),
        "device_launches_per_tick": n_dev, "device_busy_ms_per_tick": dev_ms,
        "lm_loop_iterations_last_tick": ran_last,
        "device_launches_per_loop_iteration_last_tick": None if n_dev is None else n_dev / ran_last,
        "mean_lm_iterations_per_tick": [float(a.solve.iterations.float().mean()) for _, a in outs],
        "vs_plain_tick": {"lanes_with_other_iteration_count": apart_lanes,
                          "cmd_delta_max_same_iterations": worst_same, "bit_equal": True},
        "first_tick_solve_vs_caller_linear_solve": vs_caller,
    })
    return launches


def phase_jacobi(cfg, dev, sc, pose):
    """A Jacobi-scaled solve of the prepared problems of one tick
    (LMConfig(jacobi_scaling=True) through lm_solve: the general iteration,
    K7's damped step with the scale, once per loop iteration), beside the
    unscaled general solve; and the same scaled solve through a caller's
    linear_solve (K7's standalone solve in the plain composition), which must
    give the same bits. Gated: all lanes usable, the solution inside its box.
    The share of lanes with the unscaled solve's iteration count is printed,
    not gated (scaling is a no-op only where the diagonal clamp binds in
    neither space, and cap-bound lanes chatter at float32). Returns the
    scaled solve's launch counts."""
    from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry, step_pre
    from nav2_social_mpc_controller_tpu_torch.controller.optimize import (
        build_value_grad, make_lm_config,
    )
    from nav2_social_mpc_controller_tpu_torch.solver.lm import lm_solve

    batch = pose.shape[0]
    lm_cfg = make_lm_config(cfg.optimizer)
    jac_cfg = lm_cfg._replace(jacobi_scaling=True)
    launches, ran, vs_caller, (u_jac, s_jac) = general_solve_vs_composition(
        "jacobi", cfg, jac_cfg, dev, sc, pose, 0)
    with torch.no_grad():
        prep = step_pre(cfg, with_pose(sc, pose), make_carry(cfg, batch, device=dev)).prep
        vg = build_value_grad(cfg, prep)
        u_gen, s_gen, _ = lm_solve(vg, prep.u0, prep.lower, prep.upper, lm_cfg,
                                   trace_len=lm_cfg.max_iterations)
        torch.cuda.synchronize()
    if launches["spd_solve"] != ran:
        fail(f"jacobi: spd_solve launched {launches['spd_solve']} times, the loop ran {ran}")
    if launches["propose"] or launches["commit"]:
        fail("jacobi: the scaled solve went through propose/commit")
    if not bool(s_jac.usable.all()):
        fail(f"jacobi: {int((~s_jac.usable).sum())} lanes unusable")
    if not bool((torch.isfinite(u_jac) & (u_jac >= prep.lower) & (u_jac <= prep.upper)).all()):
        fail("jacobi: a solution left its box")
    delta = (u_jac - u_gen).abs().max(dim=1).values
    emit({
        "phase": "jacobi", "batch": batch, "launches_spd_solve": launches["spd_solve"],
        "launches": launches,
        "mean_lm_iterations": {"scaled": float(s_jac.iterations.float().mean()),
                               "unscaled": float(s_gen.iterations.float().mean())},
        "share_same_iteration_count": float((s_jac.iterations == s_gen.iterations).float().mean()),
        "u_delta_p50": float(delta.quantile(0.5)), "u_delta_max": float(delta.max()),
        "final_cost_rel_delta_p50": float(
            ((s_jac.final_cost - s_gen.final_cost).abs() / s_gen.final_cost.abs().clamp(min=1.0))
            .quantile(0.5)),
        "solve_vs_caller_linear_solve": vs_caller,
    })
    return launches


# The residual path's (cost, g, JtJ) against the fused path's, scale-normalised
# per scenario: two float32 evaluations of the same fourth-power costs that
# sum in other orders (a (B, R, D) Jacobian contracted by a matrix product
# against per-step accumulation in K2's warps) and, in the people stages,
# torch's exp/atan2 against CUDA's.
RESIDUAL_VS_FUSED_TOL = 1e-4


def phase_latent_tick(cfg, dev):
    """A latent-critic tick: `cfg` with pure_angle_weight and curvature_weight
    non-zero, B = 1024, one tick. The config cannot take the fused
    evaluation, so the solve differentiates the residual function (forward
    mode): K1 is launched through the differentiable costmap sample, K6 and
    K2 never, K3/K4 run the iteration. Then, on `cfg` itself (which can
    fuse), the residual path's (cost, g, JtJ) against the fused path's."""
    from nav2_social_mpc_controller_tpu_torch import _build
    from nav2_social_mpc_controller_tpu_torch.controller.controller import (
        make_carry, make_step_batch, step_pre,
    )
    from nav2_social_mpc_controller_tpu_torch.controller.optimize import (
        ProblemDims, ResidualValueGrad, build_residual_fn, build_value_grad,
    )
    from nav2_social_mpc_controller_tpu_torch.ops import fused_iter

    batch = B_WIDE
    lat = replace_optimizer(cfg, weights={"pure_angle_weight": 0.5, "curvature_weight": 0.3})
    if fused_iter.can_fuse(lat) or not fused_iter.can_fuse(cfg):
        fail("latent_tick: the configs do not sit on the two sides of can_fuse")
    sc, poses = make_batch(lat, batch, dev, n_valid_people=lat.n_agents)
    scen = with_pose(sc, poses[0])
    step = make_step_batch(lat, device=dev)
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cmd, aux, _ = step(scen, make_carry(lat, batch, device=dev))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    check_launches("latent_tick", launches, LATENT_PATH_KERNELS)
    check_tick_outputs("latent_tick", lat, cmd, aux)
    if aux.lm_trace is not None:
        fail("latent_tick: a trace without debug_optimizer")

    dims = ProblemDims.from_config(cfg)
    with torch.no_grad():
        prep = step_pre(cfg, scen, make_carry(cfg, batch, device=dev)).prep
        args = (cfg, dims, prep.rows, prep.n_rows, prep.people_proj, prep.people_present,
                prep.costmap)
        residual = ResidualValueGrad(build_residual_fn(*args), 2 * dims.n_blocks)(prep.u0)
        fused = build_value_grad(cfg, prep)(prep.u0)
        torch.cuda.synchronize()
    # One evaluation of the residual path (D tangent passes) under the
    # profiler; a tick makes one per LM iteration and one at the start.
    with torch.no_grad():
        prep_lat = step_pre(lat, scen, make_carry(lat, batch, device=dev)).prep
        vg_lat = build_value_grad(lat, prep_lat)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vg_lat(prep_lat.u0)
        torch.cuda.synchronize()
        ms_eval = (time.perf_counter() - t0) * 1e3
        n_dev, dev_ms, _ = count_device_launches(lambda: vg_lat(prep_lat.u0))
    errs = [norm_err(a, b_)[0] for a, b_ in zip(residual, fused)]
    if not max(errs) <= RESIDUAL_VS_FUSED_TOL:
        fail(f"latent_tick: residual path vs fused path (cost, g, JtJ) differ by {errs} > "
             f"{RESIDUAL_VS_FUSED_TOL}")
    emit({
        "phase": "latent_tick", "config": "social + pure_angle_weight 0.5 + curvature_weight 0.3",
        "batch": batch, "ticks": 1, "launches": launches, "seconds_per_tick": seconds,
        "evaluations_per_tick": launches["bicubic"] // (2 * dims.n_blocks),
        "one_evaluation": {"ms": ms_eval, "device_launches": n_dev, "device_busy_ms": dev_ms},
        "mean_lm_iterations": float(aux.solve.iterations.float().mean()),
        "termination_counts": torch.bincount(aux.solve.termination.long(), minlength=6).tolist(),
        "share_with_a_person_in_view": float(prep.people_present.float().mean()),
        "residual_vs_fused_norm_err": {"cost": errs[0], "g": errs[1], "jtj": errs[2],
                                       "tol": RESIDUAL_VS_FUSED_TOL},
    })
    return launches


def phase_compacted_tick(cfg, dev, sc, poses, capacity_frac=0.25):
    """The compacted warm-start tick at full width: `cfg` with
    warm_start_mode="previous_solution", 3 ticks, once through
    make_step_batch and once through make_step_batch_compacted. Every kernel
    works scenario by scenario, so compaction must change no lane: commands,
    iteration counts, termination codes and the carry equal bit for bit.
    Printed: mean iterations, iterations x width of both solvers, ms/tick of
    both (host clock, in turns)."""
    from nav2_social_mpc_controller_tpu_torch import _build
    from nav2_social_mpc_controller_tpu_torch.controller.controller import (
        make_carry, make_step_batch, make_step_batch_compacted, step_pre,
    )
    from nav2_social_mpc_controller_tpu_torch.controller.optimize import (
        build_value_grad, make_lm_config,
    )
    from nav2_social_mpc_controller_tpu_torch.solver.batched import lm_solve_batch_compacted

    batch = sc.robot.pose.shape[0]
    warm = replace_optimizer(cfg, warm_start_mode="previous_solution")
    lm_cfg = make_lm_config(warm.optimizer)
    plain = make_step_batch(warm, device=dev)
    compacted = make_step_batch_compacted(warm, capacity_frac, device=dev)

    def fresh():
        return make_carry(warm, batch, device=dev)

    outs_p, carry_p = run_ticks(plain, sc, poses, fresh())
    _build.reset_launch_counts()
    outs_c, carry_c = run_ticks(compacted, sc, poses, fresh())
    launches = dict(_build.launch_counts)
    check_launches("compacted_tick", launches, DEFAULT_PATH_KERNELS)
    check_one_sample_per_evaluation("compacted_tick", launches)
    for t, (a, b_) in enumerate(zip(outs_c, outs_p)):
        check_tick_outputs(f"compacted_tick tick {t}", warm, *a)
        same_results(f"compacted_tick tick {t} vs the plain tick", a, b_)
    for x, y in zip(carry_c, carry_p):
        if not torch.equal(x, y):
            fail("compacted_tick: the carry differs from the plain ticks' carry")

    # Work done, in lane-iterations: the plain loop runs every lane for as
    # many iterations as it runs at all; the compacted solver logs the width
    # of each of its iterations (same solver call as make_step_batch_compacted).
    work_plain, work_compacted, carry = [], [], fresh()
    with torch.no_grad():
        for t, pose in enumerate(poses):
            prep = step_pre(warm, with_pose(sc, pose), carry).prep
            widths = []
            lm_solve_batch_compacted(
                build_value_grad(warm, prep), prep.u0, prep.lower, prep.upper, lm_cfg,
                max(1, int(batch * capacity_frac)), width_log=widths)
            work_compacted.append(sum(widths))
            work_plain.append(batch * loop_iterations(outs_p[t][1].solve.iterations,
                                                      lm_cfg.max_iterations))
            _, _, carry = plain(with_pose(sc, pose), carry)

    ms = {"plain": [], "compacted": []}
    for name, step in (("plain", plain), ("compacted", compacted), ("compacted", compacted),
                       ("plain", plain)):
        ms[name] += time_ticks(step, sc, poses, fresh, rounds=1)
    profiles = {name: profile_last_tick(step, sc, poses, fresh)
                for name, step in (("plain", plain), ("compacted", compacted))}
    n = len(poses)
    emit({
        "phase": "compacted_tick", "config": "social + warm_start_mode=previous_solution",
        "batch": batch, "ticks": n, "capacity_frac": capacity_frac, "launches": launches,
        "bit_equal_to_plain": True,
        "mean_lm_iterations_per_tick": [float(a.solve.iterations.float().mean()) for _, a in outs_p],
        "max_lm_iterations_per_tick": [int(a.solve.iterations.max()) for _, a in outs_p],
        "iterations_x_width": {"plain": work_plain, "compacted": work_compacted},
        "ms_per_tick_by_tick": {k: [float(np.mean(v[t::n])) for t in range(n)] for k, v in ms.items()},
        "ms_per_tick_mean": {k: float(np.mean(v)) for k, v in ms.items()},
        "device_launches_last_tick": {k: v[0] for k, v in profiles.items()},
        "device_busy_ms_last_tick": {k: v[1] for k, v in profiles.items()},
    })
    return launches


def main():
    t_start = time.perf_counter()
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
    _, sc36, poses36 = phase_main_path("stress36", stress36, dev, B_WIDE, stress36.n_agents,
                                       n_ticks=1, compare_cpu=False)
    launches_debug = phase_debug_tick("social", social, dev, sc, poses)
    phase_debug_tick("stress36", stress36, dev, sc36, poses36)
    launches_jacobi = phase_jacobi(social, dev, sc, poses[0])
    launches_latent = phase_latent_tick(social, dev)
    launches_compacted = phase_compacted_tick(social, dev, sc, poses)
    phase_timing([("obstacle", obstacle, 0), ("social", social, social.n_agents)], dev)

    # Every kernel at the social main path's shapes, inputs captured from a
    # real tick. `launches` is the count on the kernel's own paths: three
    # social ticks, three debug ticks and the Jacobi-scaled solve for K7, one
    # latent tick for the standalone K1; the standalone K6 runs on no path
    # (an evaluation runs it inside rollout_sample, which is held to it).
    cap = capture_iteration(social, with_pose(sc, poses[0]), make_carry(social, B_MAIN, device=dev))
    res = check_all_kernels(social, cap, reps=200)
    by_path = {"social": launches, "obstacle": launches_obstacle, "debug": launches_debug,
               "jacobi": launches_jacobi, "latent": launches_latent,
               "compacted": launches_compacted}
    own_path = {k: "social" for k in res} | {"spd_solve": "debug, jacobi", "bicubic": "latent",
                                             "rollout_prep": None}
    emit({"kernels": [
        {"name": k, **KERNEL_INFO[k], "path": own_path[k],
         "launches": sum(by_path[p][k] for p in own_path[k].split(", ")) if own_path[k] else 0,
         "launches_by_path": {p: n[k] for p, n in by_path.items()}, **v}
        for k, v in res.items()
    ], "launch_floor_ms": launch_floor_ms(200)})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": dev_info})
    return 0


if __name__ == "__main__":
    sys.exit(main())
