#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

drives the port's main paths — ``make_step_batch`` on the social benchmark
configuration (three valid people per scenario) and on the obstacle-only one,
B = 4096 scenarios with 120x120 grids, three ticks with the warm-start carry
fed back, then one tick each of the six-agent and the stress-horizon
configurations at B = 1024 — and the general paths: the debug-trace tick
(the general LM iteration, K7's damped step) on the social and the
stress-horizon configurations, a Jacobi-scaled solve, the compacted
warm-start tick and the latent-critic tick (the fused evaluation plus the
latent rows' term) with and without the trace and compaction — through
the ten hand-written CUDA kernels (an evaluation's rollout and costmap
sample run as one, rollout_sample; every tick's trajectorizer, the port's own
kernel, once; the LM loop's condition, lm_continue, the port's own too), and
checks them. ``make_step_batch`` (and with it ``make_step``, the controller,
the simulator, the loop, the distributed step and the CLI) launches its tick
on the card as one CUDA graph whose LM solve is a conditional WHILE node
(``controller/tick_graph.py``), the debug-trace tick and the latent-critic
tick too; ``make_step_batch_compacted`` replays its stages as CUDA graphs
between host checks. The ``graph``, ``debug_tick``, ``compacted_tick`` and
``latent_tick`` phases hold each against its eager tick (``capture=False``),
and the one-launch ones print their host launches, the loop's body runs
(the device's counter) and the parent graph's nodes. The simulator replays
the world update of each simulated tick as one more graph; the ``sim`` phase
holds it against its reference loop.
Phases, each printing one JSON line:

  device     the card (torch + nvidia-smi name and power limit)
  build      nvcc build of csrc/*.cu into the package's build/ directory;
             ptxas registers, stack and spills of every kernel, and the SASS
             instruction counts (FP32, MUFU) of K2's pair force in each
             direction and of the robot's duals, one sincosf, one division,
             one hypotf, one atan2f, and K5's pair force and agent step,
             behind the operation bounds of K2, K5, K6, rollout_sample and
             the trajectorizer
  shapes     kernel-vs-plain at a people-free D = 12 / S = 39 shape (and K1
             at S = 70); then with every person valid at the social
             (B = 4096, N = 3), six-agent (B = 1024, N = 6) and
             stress-horizon (B = 1024, D = 12, S = 39) shapes, every fourth
             robot near its goal (shrunk block maps, no person in view): the
             SFM scan (K5), K2 with its people stages, the rollout prep (K6)
             and rollout_sample; rollout_sample also at the obstacle tick's
             shape and on a ragged batch (B = 4101), each time bit for bit
             against K6 then K1; the trajectorizer bit for bit against its
             plain version on the plans of TRAJECTORIZER_CASES at B = 4101
             (social, omni6, stress36 and the reference's default
             trajectorizer) and on plan windows at B = 1024 and B = 1
  kernel_shapes  every block and agent count past the benchmark configs'
             (B = 1024; kernel_shapes.py lists them): for NB = 1..6 (the
             social config in blocks of 4) K2 with and without its people
             stages, K6, rollout_sample against K6 then K1 bit for bit (also
             in its long form, S = 69), K3, K4 and K7's damped step with and
             without the scale; the general forms (NB and D at run time) of
             the same kernels at NB = 7, 9, 12, 18, 36 and the limit (118;
             the social config in blocks of 1 over S = max(69, NB + 5)
             steps), and at NB = 3 and 6 against the templated forms; K7's
             standalone solve at D = 1..16 and, in its general form, at
             D = 17, 24, 32, 33, 64, 128 and the limit (237) on random SPD
             systems with every 97th negated; K5 at N = 9, 12, 16, 24, 32
             and at N = 1 over 99 steps (shared memory past 48 KB a block);
             K5's general form (N at run time) at N = 33, 48, 64, 128, 256
             and the limit (3567; past 64 the crowd spread to one person
             every two square metres), gated on the scenarios whose plain
             version another order of its sums does not move
             (sfm_order_sensitivity), and beside the templated form at
             N = 24 and 32; K2 with its people stages at N = 12, 32 and 64
  step_shapes  the reference's defaults (NB = 1, D = 2, S = 59, cap 100),
             horizon 7 in blocks of 4 (NB = 2, n_vf = 0) and 12 agents
             (NB = 3) at B = 1024, and the configs that run the general
             forms: the social horizon in blocks of 2 (NB = 9, B = 4096) and
             of 1 (NB = 18), the stress horizon in blocks of 3 (NB = 12) at
             B = 1024, and a crowd, the social config with 64 agents (K5's
             general form) at B = 4096; 3 ticks each: a main_path line (with
             the f32 gate against the CPU), then the one-launch tick against
             the eager tick bit for bit, the same launch counts, one graph
             launch a tick, a profile of the captured tick naming each
             kernel's form; the debug tick too at NB = 1, on the blocks of 2
             and in the crowd, and there the compacted_tick phase
  bench      the CLI's bench loop (runtime/bench.py), 10 ticks as one graph
             launch against the host loop (social B = 4096, the reference's
             defaults B = 1024): the last command bit for bit, launch counts,
             host operations and ms per bench tick of both in turns
  main_path  one line per path: launch counts, status, bounds, cursor, the
             people projection; for the 3-tick paths agreement of 64
             scenarios with the port's plain path on the CPU in float32
  graph      the one-launch tick against the eager tick on the four main
             paths' batches (the carry fed back) and at B = 1 (make_step, 8
             seeds x 2 ticks): every output and the carry bit for bit, the
             kernels' launch counts equal (lm_continue the captured tick's
             own), the device kernels of a tick counted by torch.profiler
             equal but lm_continue's; host-side launches per tick of both
             (one graph launch a tick), the loop's body
             runs and the parent graph's nodes; the single-robot tick of both in turns; ms/tick at B =
             1024 and 4096 (obstacle, social) in turns, capture seconds,
             device memory; the device ms of each stage graph, and the
             trajectorizer's kernel beside its plain loop's own graph; the
             staged programs and the phase that holds each
  debug_tick social config with debug_optimizer=True, B = 4096, 3 ticks,
             then stress36 (D = 12) at B = 1024, 1 tick: the one-launch debug
             tick (one loop body, the lanes' trace columns their own
             iteration counts) equal to the eager one
             bit for bit, trace included, with the same launch counts; K7's
             damped step launched once per LM iteration run, K3/K4 never;
             the trace's invariants; every result equal to the plain tick's,
             bit for bit; the first tick's solve through a caller's
             linear_solve (K7's standalone solve in the plain composition)
             equal to it bit for bit; ms/tick of the captured and the eager
             tick in turns, device launches and busy ms per tick and per
             loop iteration, stage graphs, host launches, capture seconds,
             memory
  jacobi     the same prepared problems through lm_solve with Jacobi scaling
             (the damped step with the scale), and through a caller's
             linear_solve, bit for bit; launches and busy ms of both; on the
             social (D = 6) and the stress36 (D = 12) batches
  latent_evaluation  one evaluation of the social config with
             pure_angle_weight 0.5 and curvature_weight 0.3 (the latent
             critics), B = 1024: the latent evaluation (rollout_sample, K2,
             the latent rows' term) against the residual path (D
             forward-mode passes, the reference), and on the social config
             the fused evaluation against it; its kernel launches; device
             launches, busy and host ms of the latent and the residual
             evaluation; device ms of the latent and fused evaluations and
             of the latent term alone as CUDA graphs
  latent_tick  that config's tick, social B = 1024 x 3 ticks and stress36
             B = 1024 x 1 tick: captured equal to eager bit for bit with the
             same launch counts (the default path's kernels, the standalone
             K1 never); ms/tick of both in turns, device and host launches,
             stage graphs, capture seconds, memory; social's first tick
             against the same tick solved through the residual path (timed;
             ROADMAP.md's fault rule); one robot (make_step, B = 1) bit for
             bit over 8 seeds x 2 ticks and its warm tick min/p50/p90, the
             captured p90 under 50 ms. Then the debug_tick phase on the
             latent config at B = 1024 and the compacted_tick phase on it at
             B = 4096
  compacted_tick  warm_start_mode="previous_solution", social B = 4096, 3
             ticks, and stress36 B = 1024, 1 tick: make_step_batch_compacted
             captured (graphs per rung of its width ladder) equal bit for bit
             to it eager and to the captured make_step_batch, with the eager
             one's widths and launch counts; on social also 10 warm ticks
             under bench.py's per-tick pose perturbation; iterations x width,
             ms/tick of the three in turns, host launches, stage graphs,
             capture seconds, peak memory
  timing     ms/tick and solves/s of the captured tick at B = 1024 and B =
             4096 for the obstacle and the social configuration, capture
             seconds, the eager stages' breakdown, launches, memory (the
             eager tick's peak beside it)
  single_step  make_step (one robot, a batch of one) for the social,
             obstacle, omni6 and stress36 configs, the social one with
             the latent critics and with the debug trace, 8 seeds, 2 ticks
             each: command, status, LM iterations, termination, carry (and
             the trace) equal to the same scenario's lane of a B = 1024
             tick bit for bit; the loop's body runs and host operations a
             tick; the
             warm single-robot tick latency (min, p50, p90 on the host
             clock, from tensors and from NumPy) and one profiled tick
  controller SocialMPCController over 6 ticks of a 12 m straight plan with
             the robot teleported 1.2 m a tick: a monotone, advancing plan
             cursor, reset by set_plan; the windows checked once
  native     the g++-built scenario generator (must be available): 4,096
             social scenarios timed, one tick on them
  sim        the closed-loop simulator on those 4,096 scenarios, 40 ticks,
             captured (the world update one CUDA graph a tick) and the
             reference loop in turns: the SimResults bit for bit equal;
             finite poses, commands in bounds, the STATUS_OK share; lanes 0
             and 1 equal to B = 1 simulations over 10 ticks bit for bit; the
             two scenarios of tests/test_simulator.py; ms per simulated tick
             of both, the people update's share, host launches per
             simulated tick
  stream     ControllerLoop at 20 Hz for 3 s driving make_step: ticks,
             missed, overruns (reported; no tick at all fails)
  cli        python -m nav2_social_mpc_controller_tpu_torch config, step,
             step --debug-optimizer, sim --ticks 40, bench --batch 4096
             --iters 10 and bench --config default --batch 1024 --iters 10
             in subprocesses: exit 0, the JAX CLI's keys, cuda
  distributed  make_distributed_step in a world of one (NCCL, TCP
             rendezvous on a free port) on the social main path's batch,
             3 ticks: everything bit-equal to make_step_batch, the metrics
             the local sums and mean; ms/tick of both in turns
  checkpoint a carry on the card saved and restored bit for bit; an .npz in
             the JAX package's layout restores to the same tensors
  campaign   the CLI's multihost: 2 gloo ranks on the one card x 2,048
             social scenarios, 3 ticks checkpointed every tick, then resumed
             for a 4th; the ranks' snapshots bit-equal to one 4,096-scenario
             process run 4 ticks; wall time, solves/s, generation time
  dryrun     the CLI's dryrun --devices 2 --backend gloo: bit-equal to one
             process; beside it, multihost with NCCL and two ranks on the
             one card must fail the run
  kernels    every kernel at the social main path's shapes (inputs captured from a
             real tick; the trajectorizer's, the tick's plan windows;
             lm_continue's, the LM state's done flags, in each of its roles):
             error vs the plain version against a stated
             tolerance, kernel / plain / library ms, the bound, launches (K7:
             its damped step with and without the Jacobi scale and its
             standalone solve under `entries`; `launches_by_path` adds the
             single_step, controller, sim, stream and distributed paths);
             the general forms at the blocks-of-2 config's shapes (B = 4096,
             NB = 9, D = 18; K7 also at D = 36) and K5's at the crowd's
             (B = 4096, N = 64), their launches on the step_shapes paths;
             beside them the launch floor, an almost empty kernel timed the
             same way

``python3 chip_smoke.py --lm-sync-sweep`` runs, instead of the phases after
``build``, the one measurement behind the LM loop's ``DEFAULT_CHECK_EVERY``:
ms/tick by how many LM iterations lie between two checks whether every lane
is done: on the eager tick the host asks, on the one-launch tick lm_continue
asks on the device at the end of each loop body; at B = 1, 1024 and 4096.

Any failed check raises: the exit code is then not 0 and no ``ok`` line is
printed. Without a CUDA device the script exits with code 1 at once. The last
line of a good run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
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


T_START = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line also says when it ended (seconds from
    the script's start)."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - T_START}
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
# (K6's step; the headings K2 needs once per social step and agent), one
# IEEE division (K6's row/col), and one hypotf and one atan2f (the
# trajectorizer's distances and heading). The kernel source is included, so
# these are the same device functions.
SASS_PROBE_SOURCE = r"""
#include "fused_rows.cuh"

using namespace fused;

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

__global__ void probe_hypotf(const float* in, float* out) {
    out[threadIdx.x] = hypotf(in[2 * threadIdx.x], in[2 * threadIdx.x + 1]);
}

__global__ void probe_atan2f(const float* in, float* out) {
    out[threadIdx.x] = atan2f(in[2 * threadIdx.x], in[2 * threadIdx.x + 1]);
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
               "probe_sincosf", "probe_fdiv", "probe_hypotf", "probe_atan2f", "probe_sfm_pair",
               "probe_sfm_step")
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
        include = _build.write_shapes_header(os.path.join(_build.BUILD_DIR, "include"))
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-I", include,
               "-cubin", "-o", cubin, src]
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
        "trajectorize": (cfg.trajectorizer, windowed_plan(cfg, sc, sc.robot.pose), sc.robot.pose),
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
# K1's on the card (NaN against NaN counted equal), tolerance 0. The
# trajectorizer's kernel repeats its plain loop operation for operation with
# round-to-nearest intrinsics and the functions ATen calls: its error is the
# number of output elements whose bits differ from the plain version on the
# card, tolerance 0. lm_continue counts and compares integers: its counters
# and its condition must equal its plain version's, tolerance 0.
TOL = {"sfm_scan": 1e-4, "rollout_prep": 1.0, "bicubic": 1e-5, "fused_iter": 1e-5,
       "fused_iter_people": 3e-5, "propose": 1e-6, "commit": 1e-6, "spd_solve": 0,
       "rollout_sample": 0, "trajectorize": 0, "lm_continue": 0,
       "compact_continue": 0}
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


# A scenario of the scan whose plain version moves by more than this
# (scale-normalised) when only the order in which each agent's social forces
# are added changes is sensitive to float32 rounding at the level at which
# K5 and its plain version differ (FMA contraction, CUDA's and ATen's
# functions): its forces cancel, or a goal test, the sign of a pair's angle
# or an obstacle cell turns on the last bits, and the angular velocity, a
# heading difference over dt, carries it. K5's general form is held to its
# tolerance on the other scenarios, which must be most of a check's.
SFM_ORDER_SENSITIVE = 1e-5
SFM_INSENSITIVE_SHARE = 0.5  # of a check's scenarios, at least


@contextlib.contextmanager
def sfm_sum_order(fn):
    """The plain scan adds each agent's social forces with `fn`
    ((B, N, M, 2) -> (B, N, 2)) in place of the list's order while the block
    runs."""
    from nav2_social_mpc_controller_tpu_torch.models import sfm as K5

    saved = K5.sum_in_list_order
    K5.sum_in_list_order = fn
    try:
        yield
    finally:
        K5.sum_in_list_order = saved


def sfm_order_sensitivity(args, kw, ref):
    """(B,) bool, the scenarios insensitive to rounding: the plain version
    (`ref`, its forces added in the list's order) moves by at most
    SFM_ORDER_SENSITIVE when they are added by torch's reduction or in the
    reversed order; and (B,) the larger move."""
    from nav2_social_mpc_controller_tpu_torch.models import sfm as K5

    serial = K5.sum_in_list_order
    b = ref.shape[0]
    r = ref.double().reshape(b, -1)
    move = torch.zeros(b, dtype=torch.float64, device=ref.device)
    for fn in (lambda f: f.sum(dim=2), lambda f: serial(f.flip(2))):
        with sfm_sum_order(fn):
            other = K5.project_people_plain(*args, **kw).double().reshape(b, -1)
        move = torch.maximum(move, (other - r).abs().max(dim=1).values
                             / r.abs().max(dim=1).values.clamp(min=1.0))
    return move <= SFM_ORDER_SENSITIVE, move


def check_sfm(cfg, args, reps, conditioned=False):
    """K5 against its plain version, its time, bound and the plain version's
    time. `conditioned` (the general form): the error over the scenarios
    insensitive to rounding (sfm_order_sensitivity) is the one gated, and
    the error over all of them is reported beside it."""
    from nav2_social_mpc_controller_tpu_torch.models import sfm as K5

    kw = sfm_keywords(cfg)
    got = K5.project_people(*args, **kw)
    ref = K5.project_people_plain(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got[..., 3], ref[..., 3]):
        fail("kernel sfm_scan: the t column (agent validity) differs from the plain version")
    err = norm_err(got, ref)
    split = {}
    if conditioned:
        calm, move = sfm_order_sensitivity(args, kw, ref)
        if float(calm.float().mean()) < SFM_INSENSITIVE_SHARE:
            fail(f"kernel sfm_scan at {tuple(got.shape)}: only {int(calm.sum())} of "
                 f"{calm.numel()} scenarios are insensitive to the order of their sums")
        touchy = ~calm
        split = {
            "max_err_all": err[0], "scenarios": int(calm.numel()),
            "order_insensitive_scenarios": int(calm.sum()),
            "order_sensitive_plain_move_max": float(move[touchy].max())
            if bool(touchy.any()) else None,
            "order_sensitive_kernel_vs_plain_max": norm_err(got[touchy], ref[touchy])[0]
            if bool(touchy.any()) else None,
        }
        err = norm_err(got[calm], ref[calm])[0], err[1]
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
        "max_err": err[0], "max_abs_err": err[1], "tol": TOL["sfm_scan"], **split,
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
    # is on. A live step has 5 rows and a social one 3 more; the rows'
    # partials reach cost, g and JtJ by the fewer operations of two
    # contractions: the templated form's per-row outer product, 8D + D(D+1)
    # + 3 a row, or the general form's per-step one, M_s = sum p p^T, q_s
    # and the cost (31 a row), then P = M_s f_j for each column (24 D a
    # step) and e_i^T P_j over JtJ's upper triangle and g (3 D(D+1) + 6 D a
    # step). A social step needs the robot's duals once, the sin/cos of
    # 1 + N headings, the force on each of the N agents' slots and the force
    # on the robot from each valid agent (an invalid agent's is selected
    # away), counted by the FP32 and MUFU instructions of their SASS probes
    # (a force probe less the robot's duals it also builds), plus the pair
    # sums and the proxemics scan.
    live = float(m_step.sum())
    social = float(m_social.sum())
    on_robot_pairs = float(((agents[..., 3] != -1.0) & m_social[..., None]).sum())
    on_agent_pairs = social * n
    rows = 5 * live + 3 * social
    outer_product = rows * (8 * d + d * (d + 1) + 3)
    per_step = rows * 31 + live * (3 * d * (d + 1) + 30 * d)
    rest = live * 120 + social * 10 * n + b * statics.n_vf * 40
    sc = SASS_COUNTS
    state = sc["probe_robot_state"]

    def people(kind):
        return (on_robot_pairs * (sc["probe_force_on_robot"][kind] - state[kind])
                + on_agent_pairs * (sc["probe_force_on_agent"][kind] - state[kind])
                + social * (state[kind] + (1 + n) * sc["probe_sincosf"][kind]))

    moved = nbytes(*tensors) + nbytes(*got) + social * n * 5 * 4
    bnd, by, parts = bound_by_instructions(
        moved, rest + min(outer_product, per_step), people("fp32"), people("mufu"))
    bnd_outer, _, _ = bound_by_instructions(
        moved, rest + outer_product, people("fp32"), people("mufu"))
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
        "contraction_flops": {"outer_product": outer_product, "per_step": per_step},
        "bound_ms_outer_product": bnd_outer,
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


def windowed_plan(cfg, sc, pose):
    """The plan window step_pre hands the trajectorizer at a first tick
    (plan cursor 0)."""
    from nav2_social_mpc_controller_tpu_torch.controller.path_handler import transform_global_plan

    h, w = sc.costmap.data.shape[-2:]
    thr = torch.maximum(w * sc.costmap.resolution, h * sc.costmap.resolution) / 2.0
    return transform_global_plan(sc.path, pose, cfg.max_robot_pose_search_dist, thr).path


def plain_graph(fn):
    """fn() captured as a CUDA graph after one warm-up call on the capture
    stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def check_trajectorize(tr, path, pose, reps):
    """The trajectorizer's kernel against trajectorize_plain on the card:
    elements whose bits differ, device / host / plain ms (the plain loop
    launched eagerly and as its own CUDA graph), the bound."""
    from nav2_social_mpc_controller_tpu_torch.controller import trajectorizer as K

    got = K.trajectorize(tr, path, pose)
    ref = K.trajectorize_plain(tr, path, pose)
    torch.cuda.synchronize()
    b, p = path.points.shape[:2]
    s = tr.max_steps
    # The work depends on the data: a lane computes only the steps it
    # executes (n_steps; a done lane holds its pose), over its n valid
    # waypoints. Bytes: the valid waypoints, n and the pose read once, the
    # four outputs written once. Operations, by SASS instructions: per
    # executed step a hypotf, two subtractions and two compares per valid
    # waypoint, then one sincosf, one atan2f (and one more sincosf for the
    # omnidirectional law), the goal's hypotf, and ~25 flops of law and
    # integrator.
    steps = ref.n_steps.double()
    n = path.n.double()
    hyp, atan, sc = (SASS_COUNTS[k] for k in ("probe_hypotf", "probe_atan2f", "probe_sincosf"))
    per_step = {k: sc[k] * (1 + int(tr.omnidirectional)) + atan[k] + hyp[k] for k in ("fp32", "mufu")}
    fp32 = float((steps * (n * (hyp["fp32"] + 4) + per_step["fp32"])).sum())
    mufu = float((steps * (n * hyp["mufu"] + per_step["mufu"])).sum())
    bnd, by, parts = bound_by_instructions(
        float(n.sum()) * 8 + b * (4 + 12 + 4 + 1) + nbytes(ref.poses, ref.cmds),
        25.0 * float(steps.sum()), fp32, mufu)
    graph = plain_graph(lambda: K.trajectorize_plain(tr, path, pose))
    return {
        "shape": f"B={b} P={p} S={s}" + (" omnidirectional" if tr.omnidirectional else ""),
        **trajectorize_launch(b, p),
        "steps_executed": int(ref.n_steps.sum()),
        "max_err": bits_differ(got, ref), "max_abs_err": float(max(
            (x.double() - y.double()).abs().max() for x, y in zip(got[:2], ref[:2]))),
        "tol": TOL["trajectorize"],
        "err_is": "output elements whose bits differ from trajectorize_plain",
        "ms": time_cuda(lambda: K.trajectorize(tr, path, pose), reps),
        "host_ms": time_host(lambda: K.trajectorize(tr, path, pose), reps),
        "plain_ms": time_cuda(lambda: K.trajectorize_plain(tr, path, pose), 3, warm=1),
        "plain_graph_ms": time_cuda(graph.replay, 10),
        "bound_ms": bnd, "bound_by": by, "bound_parts": parts, "library_ms": None,
    }


def trajectorize_launch(b, p):
    """The trajectorizer's launch at B scenarios of P waypoints: lanes a
    scenario (kernel_shapes.trajectorize_lanes) and the ptxas registers and
    spills of the kernel that runs (csrc/trajectorize.cu: trajectorize_kernel
    <L, waypoints in registers>)."""
    from nav2_social_mpc_controller_tpu_torch import _build, kernel_shapes

    lanes = kernel_shapes.trajectorize_lanes(b)
    name = f"trajectorize_kernel<{lanes},{int(p <= 128)}>"
    return {"lanes_per_scenario": lanes,
            "ptxas": {name: ptxas_usage(_build.last_build_log).get(name)}}


def rollout_general_launch(nb, s, batch):
    """The general rollouts' launch at NB blocks over S steps and a batch
    of B, as the wrappers pass it (kernel_shapes.rollout_general_geometry), and the ptxas
    registers and spills of the kernels that take it (csrc/rollout_sample.cu,
    csrc/rollout_prep.cu: *_general_kernel<CEIL, ONE>, CEIL the register
    ceiling at or above the blocks a warp; ONE at S <= 32, one chunk, no
    carries, CEIL 4)."""
    from nav2_social_mpc_controller_tpu_torch import _build, kernel_shapes

    warps, share = kernel_shapes.rollout_general_geometry(nb, batch, s)
    ceil = next(c for c in kernel_shapes.ROLLOUT_GENERAL_CEILINGS if share <= c)
    form = "4,1" if s <= 32 else f"{ceil},0"
    usage = ptxas_usage(_build.last_build_log)
    names = [f"rollout_{k}_general_kernel<{form}>" for k in ("sample", "prep")]
    return {"warps_per_scenario": warps, "blocks_per_warp": share,
            "ptxas": {n: usage.get(n) for n in names}}


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
    # The general forms (NB and D at run time).
    "rollout_prep_general": {
        "route": "cuda", "source": "nav2_social_mpc_controller_tpu_torch/csrc/rollout_prep.cu",
        "replaces": "nav2_social_mpc_controller_tpu/ops/rollout_pallas.py:158",
        "form": "general (NB at run time)", "redesigned": "PR 21",
    },
    "rollout_sample_general": {
        "route": "cuda", "source": "nav2_social_mpc_controller_tpu_torch/csrc/rollout_sample.cu",
        "replaces": "nav2_social_mpc_controller_tpu/ops/rollout_pallas.py:158 then "
                    "nav2_social_mpc_controller_tpu/ops/bicubic_pallas.py:288",
        "form": "general (NB at run time)", "redesigned": "PR 21",
    },
    "fused_iter_general": {
        "route": "cuda", "source": "nav2_social_mpc_controller_tpu_torch/csrc/fused_general.cu",
        "replaces": "nav2_social_mpc_controller_tpu/ops/fused_iter.py:462",
        "form": "general (NB at run time)", "redesigned": "PR 19",
    },
    "propose_general": {
        # K7's general damped step without the scale (damped_step.cuh's body)
        "route": "cuda", "source": "nav2_social_mpc_controller_tpu_torch/csrc/spd_solve.cu",
        "replaces": "nav2_social_mpc_controller_tpu/solver/pallas_iter.py:322",
        "form": "general (D at run time)", "redesigned": "PR 20",
    },
    "commit_general": {
        "route": "cuda", "source": "nav2_social_mpc_controller_tpu_torch/csrc/tr_iter.cu",
        "replaces": "nav2_social_mpc_controller_tpu/solver/pallas_iter.py:362",
        "form": "general (D at run time)",
    },
    "spd_solve_general": {
        "route": "cuda", "source": "nav2_social_mpc_controller_tpu_torch/csrc/spd_solve.cu",
        "replaces": "nav2_social_mpc_controller_tpu/solver/pallas_solve.py:93",
        "form": "general (D at run time)", "redesigned": "PR 20",
    },
    "sfm_scan_general": {
        "route": "cuda", "source": "nav2_social_mpc_controller_tpu_torch/csrc/sfm_scan.cu",
        "replaces": "nav2_social_mpc_controller_tpu/models/sfm_pallas.py:306",
        "form": "general (N at run time)", "redesigned": "PR 19",
    },
    "trajectorize": {
        "route": "cuda", "source": "nav2_social_mpc_controller_tpu_torch/csrc/trajectorize.cu",
        "replaces": "nav2_social_mpc_controller_tpu/controller/trajectorizer.py:123 "
                    "(lax.scan, no Pallas kernel)", "kind": "the port's own kernel",
        "redesigned": "PR 21",
    },
    "lm_continue": {
        "route": "cuda", "source": "nav2_social_mpc_controller_tpu_torch/csrc/tick_graph.cu",
        "replaces": "nav2_social_mpc_controller_tpu/solver/lm.py:401 "
                    "(the LM lax.while_loop's cond, no Pallas kernel)",
        "kind": "the port's own kernel",
    },
    "compact_continue": {
        "route": "cuda", "source": "nav2_social_mpc_controller_tpu_torch/csrc/tick_graph.cu",
        "replaces": "nav2_social_mpc_controller_tpu/solver/batched.py:147 "
                    "(the compacted solver's lax.while_loop cond, no Pallas kernel)",
        "kind": "the port's own kernel",
    },
}

# Kernels of the default tick (K3/K4 iteration) and of the debug tick (general
# iteration: K7 in place of K3/K4). An evaluation runs K6's rollout and K1's
# sample as one launch, rollout_sample, then K2; with the latent critics it
# adds their rows' term, which launches none of these kernels. The standalone
# K1 serves only the reference evaluation (the residual path), and the
# standalone K6 is the reference rollout_sample is held to. Every tick's head
# runs the trajectorizer once.
DEFAULT_PATH_KERNELS = ("trajectorize", "sfm_scan", "rollout_sample", "fused_iter", "propose",
                        "commit", "lm_continue")
DEBUG_PATH_KERNELS = ("trajectorize", "sfm_scan", "rollout_sample", "fused_iter", "spd_solve",
                      "lm_continue")
# The one-launch ticks' loop kernels: lm_continue runs only where the device
# loops (make_step_batch's tick and the simulator's loop over ticks on the
# card), compact_continue only where it runs the compacted tick's schedule;
# neither runs on an eager tick (capture=False).
LOOP_KERNEL = "lm_continue"
LOOP_KERNELS = (LOOP_KERNEL, "compact_continue")
COMPACTED_PATH_KERNELS = ("trajectorize", "sfm_scan", "rollout_sample", "fused_iter", "propose",
                          "commit", "compact_continue")
# The kernels with a general form (NB and D at run time): a path of NB blocks
# past kernel_shapes.BLOCKS launches each of them in that form, counted under
# its name with "_general" appended; K5's (N at run time) runs past
# kernel_shapes.SFM_SHAPES' agent counts.
GENERAL_FORMS = ("rollout_prep", "rollout_sample", "fused_iter", "propose", "commit", "spd_solve")
# The kernels' names in a profile, templated form and general form (the
# general form's a regular expression).
PROFILE_NAMES = {
    "sfm_scan": ("sfm_scan_kernel<", "sfm_scan_general_kernel"),
    "rollout_sample": ("rollout_sample_kernel<", "rollout_sample_general_kernel"),
    "fused_iter": ("fused_kernel<", "fused_general_kernel"),
    "propose": ("propose_", r"damped_step_general_\w+_kernel<(\d+, )?false>"),
    "commit": ("commit_kernel<", "commit_general_kernel"),
    "spd_solve": ("damped_step_", "damped_step_general_"),
}


def counter(kernel, nb, n_agents=1):
    """The launch counter of `kernel` on a path of NB blocks and N agents."""
    from nav2_social_mpc_controller_tpu_torch import kernel_shapes

    if kernel in GENERAL_FORMS and nb not in kernel_shapes.BLOCKS:
        return kernel + "_general"
    if kernel == "sfm_scan" and (kernel_shapes.form(kernel, "agents", n_agents)
                                 == kernel_shapes.GENERAL):
        return kernel + "_general"
    return kernel


def path_kernels(kernels, nb, n_agents=1):
    """The counters a path of NB blocks and N agents launches."""
    return tuple(counter(k, nb, n_agents) for k in kernels)


def check_profiled_forms(where, by_name, kernels, nb, n_agents=1):
    """Fail unless a profile's kernel names ({name: count}) show, for each
    of `kernels` that has a general form, the form the path runs and not
    the other (the general form past kernel_shapes.BLOCKS, K5's past
    kernel_shapes.SFM_SHAPES). Returns the names of the forms seen."""
    seen = {}
    for k in kernels:
        if k not in PROFILE_NAMES:
            continue
        general = counter(k, nb, n_agents) != k
        templated_tag, general_tag = PROFILE_NAMES[k]
        gen = [n for n in by_name if re.search(general_tag, n)]
        tmpl = [n for n in by_name if templated_tag in n and not re.search(general_tag, n)]
        want, other = (gen, tmpl) if general else (tmpl, gen)
        if not want or other:
            fail(f"{where}: the profile shows {tmpl} (templated) and {gen} (general) for "
                 f"{k} at NB = {nb}, N = {n_agents}")
        seen[k] = sorted(n[:80] for n in want)
    return seen


def without_loop_names(by_name):
    """{device kernel name: count} of a profile but the loop kernels'."""
    return {k: n for k, n in by_name.items() if not any(lk in k for lk in LOOP_KERNELS)}


def without_loop(kernels):
    """The kernels (names, or name -> launches) but the loops' own: what a
    one-launch tick and an eager tick must share."""
    if isinstance(kernels, dict):
        return {k: n for k, n in kernels.items() if k not in LOOP_KERNELS}
    return tuple(k for k in kernels if k not in LOOP_KERNELS)


def check_lm_continue(lm_cfg, done, reps):
    """lm_continue (outside a graph: it sets no loop's condition) against its
    plain version on the card, on the LM state's done flags of a real tick
    and on all-done flags, in every role the parent graph gives it: the
    tick's first check, a body's end, the remainder loop's first check and
    the check of a tick without checks. Error: the largest difference of
    the counters and the condition; the bound: the B flags read once and
    the counters read and written once (its compares are ~B operations)."""
    from nav2_social_mpc_controller_tpu_torch.controller import tick_graph as K

    b = done.shape[0]
    m = lm_cfg.max_iterations
    roles = [dict(reset=True, add=0, need=8, check_done=True, slot=-1),
             dict(reset=False, add=8, need=8, check_done=True, slot=2),
             dict(reset=False, add=0, need=m % 8 or 8, check_done=True, slot=-1),
             dict(reset=False, add=8, need=m, check_done=False, slot=3)]
    worst, calls = 0, 0
    for flags in (done, torch.ones_like(done)):
        for it0 in (0, 16, m - 8, m):
            for role in roles:
                res = []
                for fn in (K.lm_continue, K.lm_continue_plain):
                    stats = torch.tensor([it0, 5, 2, 1], dtype=torch.int64, device=done.device)
                    out = torch.full((1,), 7, dtype=torch.int32, device=done.device)
                    fn(flags, stats, out, max_iterations=m, **role)
                    res.append(torch.cat([stats, out.long()]))
                worst = max(worst, int((res[0] - res[1]).abs().max()))
                calls += 1
    torch.cuda.synchronize()
    stats = torch.zeros(4, dtype=torch.int64, device=done.device)
    out = torch.zeros(1, dtype=torch.int32, device=done.device)
    bnd, by = bound(b + 3 * 8 * 2 + 4, float(b))
    return {
        "shape": f"B={b}", "calls_compared": calls,
        "max_err": worst, "max_abs_err": worst, "tol": TOL["lm_continue"],
        "ms": time_cuda(lambda: K.lm_continue(done, stats, out, max_iterations=m, **roles[1]),
                        reps),
        "host_ms": time_host(
            lambda: K.lm_continue(done, stats, out, max_iterations=m, **roles[1]), reps),
        "plain_ms": time_cuda(
            lambda: K.lm_continue_plain(done, stats, out, max_iterations=m, **roles[1]), 3,
            warm=1),
        "bound_ms": bnd, "bound_by": by, "library_ms": None,
    }


def check_compact_continue(lm_cfg, done, reps):
    """compact_continue (outside a graph: it sets no condition) against its
    plain version on the card, on the LM state's done flags of a real tick
    and on all-done flags, at full width (the next rung B/2) and at a
    narrower rung (its first B/4 flags), in every role the compacted
    tick's parent graph gives it (a tick's first check, a rung's entry and
    its body's check, the last rung's, the finish), from states before, at
    and after the last check, reached and stopped. Error: the largest
    difference of the counters and the flags; the bound: the W flags read
    once, the counters the timed role (a tick's first check at full width)
    reads or writes, once each, and its three flags written."""
    from nav2_social_mpc_controller_tpu_torch.controller import tick_graph as K

    b, m = done.shape[0], lm_cfg.max_iterations
    n_rungs = 3
    worst, calls = 0, 0
    for flags in (done, torch.ones_like(done), done[:b // 4].contiguous()):
        w = flags.shape[0]
        for it0, rung, stopped in ((0, 0, 0), (16, 1, 0), (m - 4, 1, 0), (m, 2, 0), (8, 1, 1)):
            for role in (dict(rung=0, reset=True, next_width=w // 2),
                         dict(rung=1, reset=False, next_width=w // 2),
                         dict(rung=2, reset=False, next_width=0),
                         dict(rung=0, reset=False, next_width=0, finish=True)):
                res = []
                for fn in (K.compact_continue, K.compact_continue_plain):
                    stats = torch.arange(4 + 5 * n_rungs, dtype=torch.int64, device=done.device)
                    stats[:4] = torch.tensor([it0, 5, rung, stopped])
                    out = torch.full((n_rungs,), 7, dtype=torch.int32, device=done.device)
                    fn(flags, stats, out, n_rungs=n_rungs, check_every=8, max_iterations=m,
                       **role)
                    res.append(torch.cat([stats, out.long()]))
                worst = max(worst, int((res[0] - res[1]).abs().max()))
                calls += 1
    torch.cuda.synchronize()
    stats = K.compact_stats(n_rungs, done.device)
    out = torch.zeros(n_rungs, dtype=torch.int32, device=done.device)
    body = dict(rung=0, n_rungs=n_rungs, next_width=b // 2, reset=True, check_every=8,
                max_iterations=m)
    # The first check writes s[0], s[2], s[3] and the rung's iteration
    # slots s[4..4+L) (its reset), reads and writes s[1], and, unless no lane
    # is active, reads and writes one more: a transition's or a full chunk's
    # run counter (and s[0], s[4] again, or s[2]).
    active = bool((~done).any())
    bnd, by = bound(b + 8 * (3 + n_rungs) + 2 * 8 * (1 + active) + 4 * 3, float(b))
    return {
        "shape": f"W={b}", "calls_compared": calls,
        "max_err": worst, "max_abs_err": worst, "tol": TOL["compact_continue"],
        "ms": time_cuda(lambda: K.compact_continue(done, stats, out, **body), reps),
        "host_ms": time_host(lambda: K.compact_continue(done, stats, out, **body), reps),
        "plain_ms": time_cuda(lambda: K.compact_continue_plain(done, stats, out, **body), 3,
                              warm=1),
        "bound_ms": bnd, "bound_by": by, "library_ms": None,
    }


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
        "trajectorize": check_trajectorize(*cap["trajectorize"], reps),
        "lm_continue": check_lm_continue(cap["lm_cfg"], cap["commit"][7], reps),
        "compact_continue": check_compact_continue(cap["lm_cfg"], cap["commit"][7], reps),
    }
    for name, r in out.items():
        if not r["max_err"] <= r["tol"]:
            fail(f"kernel {name} disagrees with its plain version at {r['shape']}: "
                 f"error {r['max_err']:.3e} > tolerance {r['tol']:.1e}")
    if out["propose"]["bits_differ"] != 0:  # K3 compiles the damped step's bodies
        fail(f"kernel propose: {out['propose']['bits_differ']:.0f} elements with other bits "
             f"than its plain version at {out['propose']['shape']}")
    return out


def check_general_kernels(dev, reps):
    """Every general form at the main path's shapes of the config in blocks
    of 2 (social_bl2: B_MAIN, NB = 9, D = 18, S = 29), inputs captured from a
    real tick: K6 and rollout_sample, K2, K3, K4 and K7 (the damped step,
    its scaled form and the standalone solve of its system); K7 also at
    D = 36 (social_bl1 at B_WIDE), its library solve beside it; K5's at the
    crowd cell's (social_n64: B_MAIN, N = 64). Returns {name: row}."""
    from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry

    configs = {name: (cfg, n_valid, batch) for name, cfg, n_valid, batch in step_configs()}
    cfg, n_valid, batch = configs[BLOCKS_CELL]
    sc, poses = make_batch(cfg, batch, dev, n_valid_people=n_valid)
    cap = capture_iteration(cfg, with_pose(sc, poses[0]), make_carry(cfg, batch, device=dev))
    if cap["propose"][0].shape[1] != 18:
        fail(f"general kernels: {BLOCKS_CELL} solves D = {cap['propose'][0].shape[1]}")
    launch = rollout_general_launch(cap["rollout_prep"][7], cap["dims"].s, batch)
    out = {
        "rollout_prep_general": {**check_rollout(cap["rollout_prep"], reps), **launch},
        "rollout_sample_general": {
            **check_rollout_sample(cap["bicubic"][0], cap["rollout_prep"], reps), **launch},
        "fused_iter_general": check_fused(cap["fused"], reps),
        "propose_general": check_propose(cap["lm_cfg"], cap["propose"], reps),
        "commit_general": check_commit(cap["lm_cfg"], cap["commit"], reps),
        "spd_solve_general": check_spd_solve(cap["lm_cfg"], cap, reps),
    }
    del cap, sc
    cfg36, n36, b36 = configs["social_bl1"]
    sc36, poses36 = make_batch(cfg36, b36, dev, n_valid_people=n36)
    cap36 = capture_iteration(cfg36, with_pose(sc36, poses36[0]),
                              make_carry(cfg36, b36, device=dev))
    d36 = check_spd_solve(cap36["lm_cfg"], cap36, reps)
    out["spd_solve_general"]["at_d36"] = {k: d36[k] for k in (
        "shape", "max_err", "max_abs_err", "ms", "host_ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms")}
    del cap36, sc36
    # K5's general form at the crowd cell's main-path shapes (B_MAIN, N = 64)
    cfg64, n64, b64 = configs[CROWD_CELL]
    sc64, poses64 = make_batch(cfg64, b64, dev, n_valid_people=n64)
    cap64 = capture_iteration(cfg64, with_pose(sc64, poses64[0]),
                              make_carry(cfg64, b64, device=dev))
    out["sfm_scan_general"] = check_sfm(cfg64, cap64["sfm"], reps, conditioned=True)
    del cap64, sc64
    for name, r in list(out.items()) + [("spd_solve_general at D = 36", d36)]:
        if not r["max_err"] <= r["tol"]:
            fail(f"kernel {name} disagrees with its plain version at {r['shape']}: "
                 f"error {r['max_err']:.3e} > tolerance {r['tol']:.1e}")
    if out["propose_general"]["bits_differ"] != 0:
        fail(f"kernel propose_general: {out['propose_general']['bits_differ']:.0f} elements "
             f"with other bits than its plain version at {out['propose_general']['shape']}")
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
    the kernels that read people at the three people shapes. K7's
    standalone solve on random systems is in phase_kernel_shapes, at every
    D it takes."""
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
          + [{"name": "bicubic", **s70}] + phase_people_shapes(dev) + fused_shapes
          + trajectorize_shapes(dev)})


def trajectorize_shapes(dev):
    """The trajectorizer's kernel against its plain version, bit for bit:
    the plans of utils/scenarios.py's TRAJECTORIZER_CASES (no waypoint, one,
    a full plan, all beyond the lookahead, tied minimisers, rotate-in-place
    just above and below pi/2 to either side, a goal reached after one step
    and one never reached) at B = B_MAIN + 5, for the social config, omni6
    (the omnidirectional law), stress36 (40 steps) and the reference's
    default trajectorizer (lookahead 0.4, 60 steps); and for the three
    configs the plan windows of a B_WIDE batch and the first of them alone
    (B = 1)."""
    from nav2_social_mpc_controller_tpu_torch.core import config as C
    from nav2_social_mpc_controller_tpu_torch.core.types import PathInput
    from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_trajectorizer_cases

    out = []
    for name in ("benchmark_social_config", "benchmark_omni_6agents_config",
                 "benchmark_stress_h36_config", "TrajectorizerConfig"):
        real = name != "TrajectorizerConfig"
        cfg = getattr(C, name)() if real else C.benchmark_social_config()
        tr = cfg.trajectorizer if real else C.TrajectorizerConfig()
        path_np, pose_np, _ = make_trajectorizer_cases(tr, B_MAIN + 5, cfg.max_path_points, seed=1)
        rows = [("cases", PathInput(*(torch.as_tensor(x, device=dev) for x in path_np)),
                 torch.as_tensor(pose_np, device=dev))]
        if real:
            sc, poses = make_batch(cfg, B_WIDE, dev, n_valid_people=cfg.n_agents)
            win = windowed_plan(cfg, sc, poses[0])
            rows += [("plan windows", win, poses[0]),
                     ("plan window, B = 1", PathInput(*(x[:1] for x in win)), poses[0][:1])]
        for plans, path, pose in rows:
            r = check_trajectorize(tr, path, pose, reps=50)
            if not r["max_err"] <= r["tol"]:
                fail(f"kernel trajectorize differs from its plain version at {name} {plans} "
                     f"{r['shape']} in {r['max_err']:.0f} elements")
            out.append({"name": "trajectorize", "config": name, "plans": plans, **r})
    return out


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


# ---------------------------------------------------------------------------
# every block and agent count the JAX package runs
# ---------------------------------------------------------------------------

B_SHAPES = B_WIDE  # batch of the kernel_shapes phase
K5_AGENT_COUNTS = (9, 12, 16, 24, 32)  # beside the benchmark configs' 3 and 6
K5_LONG_STEPS = 99  # N = 1 past 94 steps: shared memory over 48 KB
K5_GENERAL_AGENT_COUNTS = (33, 48, 64, 128, 256)  # and kernel_shapes.GENERAL_MAX_AGENTS
K5_CROSS_CHECK_AGENTS = (24, 32)  # K5's general form beside its templated one
K2_AGENT_COUNTS = (12, 32, 64)  # K2 with its people stages, beside the social config's 3
# Crowds past 64 agents stand at this many people a square metre, a busy
# pedestrian street: the scenario generator puts every person in the same
# 2.5 m x 3 m in front of the robot (8.5 a square metre at 64, a crush far
# beyond any walking crowd at 128).
CROWD_DENSITY = 0.5
GENERATOR_AREA_M2 = 2.5 * 3.0


def k5_general_batch(n):
    """The batch of the general K5's check at N agents: B_SHAPES to 64,
    fewer above (the plain version forms (B, N + 1, N + 1) pair tensors, in
    float64 too for the conditioning)."""
    return B_SHAPES if n <= 64 else (256 if n <= 256 else 2)


def spread_crowd(people, density=CROWD_DENSITY):
    """`people` (B, N, 6) with the valid agents' positions spread about the
    generator's near edge (x = 0.5 m, y = 0) so that N stand at `density`
    a square metre (never drawn closer)."""
    n = people.shape[1]
    k = max(1.0, (n / (GENERATOR_AREA_M2 * density)) ** 0.5)
    valid = people[..., 3] != -1.0
    out = people.clone()
    out[..., 0] = torch.where(valid, 0.5 + (people[..., 0] - 0.5) * k, people[..., 0])
    out[..., 1] = torch.where(valid, people[..., 1] * k, people[..., 1])
    return out.contiguous()


def blocks_config(nb, long_rollout=False):
    """The social config at NB blocks of length 4 (horizon 4 NB, S = 29);
    `long_rollout`: 69 steps (the rollout kernels' long form), windows off
    (their exactness rule is sized for 29 steps)."""
    import dataclasses

    from nav2_social_mpc_controller_tpu_torch.core.config import benchmark_social_config

    cfg = replace_optimizer(benchmark_social_config(), control_horizon=4 * nb,
                            parameter_block_length=4)
    if long_rollout:
        cfg = dataclasses.replace(
            replace_optimizer(cfg, obstacle_window_cells=0), esdf_window_cells=0,
            trajectorizer=dataclasses.replace(cfg.trajectorizer, max_time=3.5))
    return cfg


GENERAL_BLOCK_COUNTS = (7, 9, 12, 18, 36)  # and kernel_shapes.GENERAL_MAX_BLOCKS
GENERAL_SOLVE_DIMS = (17, 24, 32, 33, 64, 128)  # and kernel_shapes.GENERAL_MAX_DIM
GENERAL_CROSS_CHECK_BLOCKS = (3, 6)  # the general forms against the templated ones


def general_blocks_config(nb):
    """The social config at NB blocks of length 1 (horizon NB) over a long
    rollout, S = max(69, NB + 5) steps, windows off (their exactness rule is
    sized for 29 steps)."""
    import dataclasses

    from nav2_social_mpc_controller_tpu_torch.core.config import benchmark_social_config

    cfg = replace_optimizer(benchmark_social_config(), control_horizon=nb,
                            parameter_block_length=1, obstacle_window_cells=0)
    tr = cfg.trajectorizer
    return dataclasses.replace(
        cfg, esdf_window_cells=0,
        trajectorizer=dataclasses.replace(tr, max_time=max(70, nb + 6) * tr.time_step))


def general_batch(nb):
    """The batch of the general forms' check at NB: B_SHAPES up to 18 blocks;
    fewer above, where the plain K2 forms a (B, rows, D, D) product."""
    return B_SHAPES if nb <= 18 else (256 if nb <= 36 else 16)


def agents_config(n, steps=None):
    """The social config with N agents; `steps`: S + 1 = steps + 1 rows,
    windows off."""
    import dataclasses

    from nav2_social_mpc_controller_tpu_torch.core.config import benchmark_social_config

    cfg = dataclasses.replace(benchmark_social_config(), n_agents=n)
    if steps is not None:
        tr = cfg.trajectorizer
        cfg = dataclasses.replace(
            replace_optimizer(cfg, obstacle_window_cells=0), esdf_window_cells=0,
            trajectorizer=dataclasses.replace(tr, max_time=(steps + 1) * tr.time_step))
    return cfg


def gate(rows):
    """Fail on the first row whose error passes its tolerance."""
    for r in rows:
        if not r["max_err"] <= r["tol"]:
            fail(f"kernel {r['name']} disagrees with its plain version at {r['shape']}: "
                 f"error {r['max_err']:.3e} > tolerance {r['tol']:.1e}")
    return rows


@contextlib.contextmanager
def general_forms():
    """Every wrapper takes its kernel's general form, at a templated shape
    too, while the block runs: kernel_shapes.form reads the lists of
    templated shapes at each call, and these are empty for that while (the
    built library and its dispatch tables are untouched)."""
    from nav2_social_mpc_controller_tpu_torch import kernel_shapes

    names = ("BLOCKS", "SOLVE_DIMS", "SPD_SOLVE_DIMS", "SFM_SHAPES")
    saved = {name: getattr(kernel_shapes, name) for name in names}
    for name in names:
        setattr(kernel_shapes, name, ())
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(kernel_shapes, name, value)


def general_solve_launch(d, standalone=False):
    """K7's general form at D: the launch the wrappers pass
    (kernel_shapes.general_solve_geometry) and the ptxas registers and
    spills of the kernels that take D (csrc/spd_solve.cu: to D = 32 the warp
    form unrolled to the ceiling at or above D, 16, 20, 24, 28 or 32; the
    block form above; the damped step's without and with the scale, or the
    standalone solve's)."""
    from nav2_social_mpc_controller_tpu_torch import _build, kernel_shapes

    threads, systems, shared = kernel_shapes.general_solve_geometry(d)
    entry = "spd_solve" if standalone else "damped_step"
    if d <= kernel_shapes.GENERAL_SOLVE_WARP_MAX_D:
        cap = max(16, -(-d // 4) * 4)
        names = [f"{entry}_general_warp_kernel<{cap}{'' if standalone else f',{j}'}>"
                 for j in ((None,) if standalone else (0, 1))]
    else:
        names = [f"{entry}_general_block_kernel" + ("" if standalone else f"<{j}>")
                 for j in ((None,) if standalone else (0, 1))]
    usage = ptxas_usage(_build.last_build_log)
    return {"threads_per_system": threads, "systems_per_block": systems,
            "shared_bytes_per_block": shared, "ptxas": {n: usage.get(n) for n in names}}


def check_general_vs_templated(cap):
    """Each general form at a templated shape (general_forms), on a capture's
    inputs: K2 against the templated K2 (its tolerance: the two sum in
    another order), K6 and rollout_sample against the templated kernels
    (the same scans: the elements whose bits differ are reported, not gated,
    since ptxas contracts by context), K3, K4 and K7's damped step (with and
    without the scale) and its standalone solve against their plain versions
    bit for bit, as the templated forms are. Returns {name: row}."""
    from nav2_social_mpc_controller_tpu_torch.ops import fused_iter as K2
    from nav2_social_mpc_controller_tpu_torch.ops import rollout_cuda as K6
    from nav2_social_mpc_controller_tpu_torch.solver import cuda_iter as K34
    from nav2_social_mpc_controller_tpu_torch.solver import cuda_solve as K7

    lm_cfg, prep, win = cap["lm_cfg"], cap["rollout_prep"], cap["bicubic"][0]
    people = bool(cap["fused"][18].any())
    with general_forms():
        got = K2.fused_cost_g_jtj(*cap["fused"])
    ref = K2.fused_cost_g_jtj(*cap["fused"])
    torch.cuda.synchronize()
    errs = [norm_err(a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)) for a, b in zip(got, ref)]
    out = {"fused_iter_general": {
        "shape": f"B={got[0].shape[0]} D={got[1].shape[1]}", "against": "templated K2",
        "max_err": max(e[0] for e in errs), "max_abs_err": max(e[1] for e in errs),
        "tol": TOL["fused_iter_people" if people else "fused_iter"]}}
    for name, fn, args in (("rollout_prep_general", K6.rollout_prep, prep),
                           ("rollout_sample_general", K6.rollout_sample, (win, *prep))):
        with general_forms():
            g = fn(*args)
        t = fn(*args)
        keys = sorted(t)
        torch.cuda.synchronize()
        out[name] = {"shape": f"B={prep[2].shape[0]} S={prep[2].shape[1]} NB={prep[7]}",
                     "against": "templated kernel", "max_err": 0.0, "tol": 0.0,
                     "bits_differ_from_templated": bits_differ([g[k] for k in keys],
                                                               [t[k] for k in keys]),
                     "max_abs_err": float(max((g[k].double() - t[k].double()).abs()
                                              .nan_to_num(0.0).max() for k in keys))}
    with general_forms():
        gp = K34.propose(lm_cfg, *cap["propose"])
        cg = K34.commit(lm_cfg, *cap["commit"])
        gd = [K34.damped_step(lm_cfg, *cap["propose"], jac) for jac in (None, cap["jac_scale"])]
        gs = K7.spd_solve(*cap["spd_solve"])
    bits = bits_differ(gp, K34.propose_plain(lm_cfg, *cap["propose"]))
    out["propose_general"] = {"against": "plain version", "max_err": bits, "tol": 0.0,
                              "bits_differ": bits}
    cp = K34.commit_plain(lm_cfg, *cap["commit"])
    out["commit_general"] = {"against": "plain version", "max_err": bits_differ(cg, cp),
                             "tol": 0.0}
    differ = 0.0
    for got_d, jac in zip(gd, (None, cap["jac_scale"])):
        differ += bits_differ(got_d, K34.damped_step_plain(lm_cfg, *cap["propose"], jac))
    differ += bits_differ([gs], [K7.spd_solve_plain(*cap["spd_solve"])])
    out["spd_solve_general"] = {"against": "plain version (damped step, scaled, standalone)",
                                "max_err": differ, "tol": 0.0}
    torch.cuda.synchronize()
    return out


def phase_kernel_shapes(dev, reps=20):
    """Every instantiation the card now takes, against its plain version on
    the same inputs, at B = B_SHAPES: for NB = 1..6 (D = 2 NB; the social
    config in blocks of 4, every person valid, every fourth robot near its
    goal) the inputs of a real tick after 3 LM iterations: K2 with its
    people stages and people-free, K6, rollout_sample against K6 then K1
    bit for bit, K3, K4 and K7's damped step with and without the scale
    (and the standalone solve of its system); rollout_sample and K6 in their
    long form (S = 69); K7's standalone solve at D = 1..16 on random SPD
    systems with every 97th negated; K5 at N = 9, 12, 16, 24 and 32 and at
    N = 1 over 99 steps, past 48 KB of shared memory a block, and its
    general form (check_sfm_general_shapes); K2 at N = 12, 32, 64. The general
    forms (NB and D at run time): at NB = 7, 9, 12, 18, 36 and the limit
    (general_blocks_config, blocks of 1 over S = max(69, NB + 5) steps) the
    same checks of K2, K6, rollout_sample, K3, K4 and K7 against their plain
    versions; at NB = 3 and 6 each general form against the templated one
    (check_general_vs_templated); K7's standalone solve at D = 17, 24, 32,
    33, 64, 128 and the limit."""
    from nav2_social_mpc_controller_tpu_torch import kernel_shapes
    from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry, step_pre

    rows = []

    def add(name, what, r):
        rows.append({"name": name, **what, **r})

    for nb in kernel_shapes.BLOCKS:
        cfg = blocks_config(nb)
        what = {"nb": nb, "d": 2 * nb}
        for n_valid in (cfg.n_agents, 0):
            sc, poses = make_batch(cfg, B_SHAPES, dev, n_valid_people=n_valid)
            sc = with_pose(sc, near_goal_every(sc, poses[0]))
            cap = capture_iteration(cfg, sc, make_carry(cfg, B_SHAPES, device=dev))
            if cap["propose"][0].shape[1] != 2 * nb:
                fail(f"kernel_shapes: the config for NB = {nb} solves D = "
                     f"{cap['propose'][0].shape[1]}")
            add("fused_iter", {**what, "people": bool(n_valid)}, check_fused(cap["fused"], reps))
            if not n_valid:
                continue
            add("rollout_prep", what, check_rollout(cap["rollout_prep"], reps))
            add("rollout_sample", what,
                check_rollout_sample(cap["bicubic"][0], cap["rollout_prep"], reps))
            add("propose", what, check_propose(cap["lm_cfg"], cap["propose"], reps))
            add("commit", what, check_commit(cap["lm_cfg"], cap["commit"], reps))
            k7 = check_spd_solve(cap["lm_cfg"], cap, reps)
            add("spd_solve", what, k7)
        long_cfg = blocks_config(nb, long_rollout=True)
        win, args = evaluation_inputs(long_cfg, B_SHAPES, dev, long_cfg.n_agents)
        if args[2].shape[1] <= 64:
            fail(f"kernel_shapes: the long rollout has {args[2].shape[1]} steps")
        add("rollout_prep", {**what, "form": "long"}, check_rollout(args, reps))
        add("rollout_sample", {**what, "form": "long"}, check_rollout_sample(win, args, reps))
    # The general forms: at NB past the templated list, in blocks of 1 over a
    # long rollout, each against its plain version; at NB = 3 and 6 against
    # the templated forms too.
    for nb in GENERAL_BLOCK_COUNTS + (kernel_shapes.GENERAL_MAX_BLOCKS,):
        cfg = general_blocks_config(nb)
        batch = general_batch(nb)
        what = {"nb": nb, "d": 2 * nb, "batch": batch}
        reps_nb = reps if nb <= 18 else 3
        for n_valid in (cfg.n_agents, 0):
            sc, poses = make_batch(cfg, batch, dev, n_valid_people=n_valid)
            sc = with_pose(sc, near_goal_every(sc, poses[0]))
            cap = capture_iteration(cfg, sc, make_carry(cfg, batch, device=dev))
            if cap["propose"][0].shape[1] != 2 * nb:
                fail(f"kernel_shapes: the config for NB = {nb} solves D = "
                     f"{cap['propose'][0].shape[1]}")
            what["s"] = cap["dims"].s
            threads, spb, tile, shared = kernel_shapes.fused_general_geometry(nb, what["s"])
            add("fused_iter_general", {**what, "people": bool(n_valid), "threads": threads,
                                       "scenarios_per_block": spb, "step_tile": tile,
                                       "shared_bytes": shared},
                check_fused(cap["fused"], reps_nb))
            if not n_valid:
                continue
            launch = rollout_general_launch(nb, what["s"], batch)
            add("rollout_prep_general", {**what, **launch},
                check_rollout(cap["rollout_prep"], reps_nb))
            add("rollout_sample_general", {**what, **launch},
                check_rollout_sample(cap["bicubic"][0], cap["rollout_prep"], reps_nb))
            launch = general_solve_launch(2 * nb)
            add("propose_general", {**what, **launch},
                check_propose(cap["lm_cfg"], cap["propose"], reps_nb))
            add("commit_general", what, check_commit(cap["lm_cfg"], cap["commit"], reps_nb))
            add("spd_solve_general", {**what, **launch},
                check_spd_solve(cap["lm_cfg"], cap, reps_nb))
            del cap
    for nb in GENERAL_CROSS_CHECK_BLOCKS:
        cfg = blocks_config(nb)
        sc, poses = make_batch(cfg, B_SHAPES, dev, n_valid_people=cfg.n_agents)
        sc = with_pose(sc, near_goal_every(sc, poses[0]))
        cap = capture_iteration(cfg, sc, make_carry(cfg, B_SHAPES, device=dev))
        for name, r in check_general_vs_templated(cap).items():
            add(name, {"nb": nb, "d": 2 * nb, "form": "general against templated"}, r)
    gen = torch.Generator(device=dev).manual_seed(1)
    for d in kernel_shapes.SPD_SOLVE_DIMS + GENERAL_SOLVE_DIMS + (kernel_shapes.GENERAL_MAX_DIM,):
        m = torch.randn((B_SHAPES, d, d), device=dev, generator=gen)
        a = m @ m.transpose(1, 2) + 0.5 * torch.eye(d, device=dev)
        a[::97] = -a[::97]
        r = check_spd_solve_system(
            a.contiguous(), torch.randn((B_SHAPES, d), device=dev, generator=gen),
            reps if d <= 64 else 3)
        if r["non_finite_systems"] != len(range(0, B_SHAPES, 97)):
            fail(f"kernel spd_solve on random systems at D={d}: {r['non_finite_systems']} "
                 "non-finite systems")
        name = "spd_solve" if d in kernel_shapes.SPD_SOLVE_DIMS else "spd_solve_general"
        launch = {} if name == "spd_solve" else general_solve_launch(d, standalone=True)
        add(name, {"d": d, "entry": "standalone", "systems": "random SPD, every 97th negated",
                   **launch}, r)
        del m, a
    for n, steps in [(n, None) for n in K5_AGENT_COUNTS] + [(1, K5_LONG_STEPS)]:
        from nav2_social_mpc_controller_tpu_torch.models.sfm import scan_geometry, scan_shared_bytes

        cfg = agents_config(n, steps)
        sc, poses = make_batch(cfg, B_SHAPES, dev, n_valid_people=n)
        sc = with_pose(sc, poses[0])
        prep = step_pre(cfg, sc, make_carry(cfg, B_SHAPES, device=dev)).prep
        args = sfm_inputs(sc, sc.people.state, prep)
        s1 = args[1].shape[1]
        shared = scan_shared_bytes(scan_geometry(n, B_SHAPES), n, s1)
        if steps is not None and shared <= 48 * 1024:
            fail(f"kernel_shapes: K5 at N = 1 over {s1 - 1} steps takes {shared} bytes")
        r = check_sfm(cfg, args, reps)
        if r["valid_agents"] != B_SHAPES * n:
            fail(f"kernel_shapes: K5 at N = {n}: only {r['valid_agents']} valid agents")
        add("sfm_scan", {"n": n, "steps": s1 - 1, "shared_bytes": shared,
                         "sources_per_lane": scan_geometry(n, 1).sources_per_lane}, r)
    rows.extend(check_sfm_general_shapes(dev, reps))
    # K2's people stages read N at run time: its time as N grows (the social
    # config with N agents, every person valid, every fourth robot near its
    # goal, a real tick's inputs after 3 LM iterations)
    for n in K2_AGENT_COUNTS:
        cfg = agents_config(n)
        sc, poses = make_batch(cfg, B_SHAPES, dev, n_valid_people=n)
        sc = with_pose(sc, near_goal_every(sc, poses[0]))
        cap = capture_iteration(cfg, sc, make_carry(cfg, B_SHAPES, device=dev))
        add("fused_iter", {"n": n, "nb": cap["dims"].n_blocks, "people": True},
            check_fused(cap["fused"], reps))
        del cap
    gate(rows)
    for r in rows:
        if r["name"] in ("propose", "propose_general") and r["bits_differ"] != 0:
            fail(f"kernel propose: {r['bits_differ']:.0f} elements with other bits than its "
                 f"plain version at {r['shape']}")
    emit({"phase": "kernel_shapes", "batch": B_SHAPES, "kernels": rows})


def check_sfm_general_shapes(dev, reps):
    """K5's general form (N at run time) at N = K5_GENERAL_AGENT_COUNTS and
    the limit, every agent valid (past 64 the crowd spread to CROWD_DENSITY;
    k5_general_batch scenarios), against its plain version on the
    scenarios insensitive to rounding (check_sfm), with its ptxas registers and
    spills; at N = 24 and 32 (general_forms) beside the templated form: the
    elements whose bits differ and the largest difference, reported, and
    each against the plain version. Returns the rows."""
    from nav2_social_mpc_controller_tpu_torch import _build, kernel_shapes
    from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry, step_pre
    from nav2_social_mpc_controller_tpu_torch.models import sfm as K5

    ptx = ptxas_usage(_build.last_build_log).get("sfm_scan_general_kernel")
    rows = []
    limit = kernel_shapes.GENERAL_MAX_AGENTS
    for n in K5_GENERAL_AGENT_COUNTS + (limit,) + K5_CROSS_CHECK_AGENTS:
        cfg = agents_config(n)
        batch = k5_general_batch(n)
        sc, poses = make_batch(cfg, batch, dev, n_valid_people=n)
        sc = with_pose(sc, poses[0])
        prep = step_pre(cfg, sc, make_carry(cfg, batch, device=dev)).prep
        people = sc.people.state if n <= 64 else spread_crowd(sc.people.state)
        args = sfm_inputs(sc, people, prep)
        s1 = args[1].shape[1]
        what = {"n": n, "batch": batch, "steps": s1 - 1,
                "people_per_m2": n / GENERATOR_AREA_M2 if n <= 64 else CROWD_DENSITY}
        reps_n = reps if n <= 128 else (3 if n < limit else 1)
        if n in K5_CROSS_CHECK_AGENTS:
            tmpl = K5.project_people(*args, **sfm_keywords(cfg))
            with general_forms():
                geo = K5.scan_geometry(n, batch)
                r = check_sfm(cfg, args, reps_n, conditioned=True)
                got = K5.project_people(*args, **sfm_keywords(cfg))
            torch.cuda.synchronize()
            what.update(form="general against templated",
                        bits_differ_from_templated=bits_differ([got], [tmpl]),
                        max_err_against_templated=norm_err(got, tmpl)[0])
        else:
            geo = K5.scan_geometry(n, batch)
            r = check_sfm(cfg, args, reps_n, conditioned=True)
        if r["valid_agents"] != batch * n:
            fail(f"kernel_shapes: K5 at N = {n}: only {r['valid_agents']} valid agents")
        if not isinstance(geo, K5.GeneralScanGeometry):
            fail(f"kernel_shapes: K5 at N = {n} took {type(geo).__name__}")
        rows.append({"name": "sfm_scan_general", **what,
                     "shared_bytes": K5.scan_shared_bytes(geo, n, s1),
                     "threads_per_scenario": geo.threads_per_scenario,
                     "scenarios_per_block": geo.scenarios_per_block,
                     "ptxas": ptx, **r})
    return rows


def step_configs():
    """(name, config, valid people, batch) of the shapes the benchmark
    configs do not reach: the reference's defaults (NB = 1, D = 2, S = 59, a
    cap of 100 iterations, no window), horizon 7 in blocks of 4 (NB = 2,
    n_vf = 0) and 12 agents (NB = 3, K5 with 6 sources a lane), at B_WIDE;
    and the configs in more than six blocks, which run the kernels' general
    forms: the social horizon of 18 in blocks of 2 (NB = 9, D = 18, at the
    social benchmark's width B_MAIN) and of 1 (NB = 18, D = 36), and the
    H = 36 stress horizon in blocks of 3 (NB = 12, D = 24, S = 39), at
    B_WIDE; and a crowd, the social config with 64 agents (K5's general
    form; NB = 3, D = 6, S = 29), at B_MAIN."""
    from nav2_social_mpc_controller_tpu_torch.core.config import (
        SocialMPCConfig, benchmark_social_config, benchmark_stress_h36_config,
    )

    social = benchmark_social_config()
    return [("default", SocialMPCConfig(), 3, B_WIDE),
            ("social_h7_bl4", replace_optimizer(social, control_horizon=7,
                                                parameter_block_length=4), 3, B_WIDE),
            ("social_n12", agents_config(12), 12, B_WIDE),
            ("social_bl2", replace_optimizer(social, parameter_block_length=2), 3, B_MAIN),
            ("social_bl1", replace_optimizer(social, parameter_block_length=1), 3, B_WIDE),
            ("stress36_bl3", replace_optimizer(benchmark_stress_h36_config(),
                                               parameter_block_length=3), 3, B_WIDE),
            (CROWD_CELL, agents_config(64), 64, B_MAIN)]


BLOCKS_CELL = "social_bl2"  # the config in finer blocks whose debug and compacted ticks run
CROWD_CELL = "social_n64"  # the crowd config whose debug and compacted ticks run
GENERAL_DEBUG_CELLS = (BLOCKS_CELL, CROWD_CELL)


def phase_step_shapes(dev):
    """The step_configs through the main path at their batches, 3 ticks
    with the carry fed back (phase_main_path: launches, outputs, the f32
    gate against the CPU plain path), then the one-launch tick against the
    eager tick (capture=False) on the same ticks: every output and the carry
    bit for bit, the launch counts equal but lm_continue's, one graph launch
    a tick, and the profile of a captured tick naming each kernel's form
    (the general forms, and no templated one, past NB = 6; K5's past
    N = 32); on the reference's defaults and on GENERAL_DEBUG_CELLS also the
    debug tick, captured against eager bit for bit, with K7's damped step
    once per iteration the loop runs and every result equal to the plain
    tick's; on GENERAL_DEBUG_CELLS the compacted warm-start tick too
    (phase_compacted_tick). Returns the launch counts by path: the main-path
    runs, the debug ticks' and the compacted ticks', each summed."""
    from nav2_social_mpc_controller_tpu_torch import _build
    from nav2_social_mpc_controller_tpu_torch.controller.controller import (
        make_carry, make_step_batch,
    )
    from nav2_social_mpc_controller_tpu_torch.controller.optimize import ProblemDims

    totals = {"step_shapes": {}, "step_shapes_debug": {}, "step_shapes_compacted": {}}

    def add(path, launches):
        for k, n in launches.items():
            totals[path][k] = totals[path].get(k, 0) + n

    cells = []
    for name, cfg, n_valid, batch in step_configs():
        dims = ProblemDims.from_config(cfg)
        nb = dims.n_blocks
        launches, sc, poses = phase_main_path(name, cfg, dev, batch, n_valid)
        add("step_shapes", launches)
        debug = nb == 1 or name in GENERAL_DEBUG_CELLS
        kinds = [("plain", cfg)] + ([("debug", replace_optimizer(cfg, debug_optimizer=True))]
                                    if debug else [])
        plain_outs = None
        for kind, c in kinds:
            where = f"step_shapes {name} {kind}"
            steps = {"captured": make_step_batch(c, device=dev),
                     "eager": make_step_batch(c, device=dev, capture=False)}
            outs, by_kind = {}, {}
            for k, step in steps.items():
                run_ticks(step, sc, poses[:1], make_carry(c, batch, device=dev))  # capture
                if k == "captured":
                    step.tick.reset_host_launches()
                _build.reset_launch_counts()
                outs[k] = run_ticks(step, sc, poses, make_carry(c, batch, device=dev))
                by_kind[k] = dict(_build.launch_counts)
            for t, (got, want) in enumerate(zip(outs["captured"][0], outs["eager"][0])):
                same_bits(f"{where} tick {t}", got, want, parts=("cmd", "aux"))
            same_bits(where, (outs["captured"][1],), (outs["eager"][1],), parts=("carry",))
            if without_loop(by_kind["captured"]) != without_loop(by_kind["eager"]):
                fail(f"{where}: kernel launches {by_kind['captured']} captured, "
                     f"{by_kind['eager']} eager")
            kernels = DEBUG_PATH_KERNELS if kind == "debug" else DEFAULT_PATH_KERNELS
            check_launches(where, by_kind["captured"], path_kernels(kernels, nb, cfg.n_agents),
                           ticks=len(poses))
            host_ops = dict(steps["captured"].tick.host_launches)
            if host_ops["graph_replays"] != len(poses):
                fail(f"{where}: {host_ops} over {len(poses)} ticks, not one graph launch a tick")
            # the kernels a captured tick ran, by their names in a profile
            _build.launch_counts.settle()
            run_ticks(steps["captured"], sc, poses[:1], make_carry(c, batch, device=dev))
            torch.cuda.synchronize()
            by_name = one_launch_profile(steps["captured"])[3]
            forms = check_profiled_forms(where, by_name, kernels, nb, cfg.n_agents)
            cell = {"config": name, "kind": kind, "nb": nb, "d": 2 * nb,
                    "s": dims.s, "n_agents": cfg.n_agents, "batch": batch,
                    "ticks": len(poses), "captured_bit_equal_to_eager": True,
                    "launches": by_kind["captured"], "host_operations": host_ops,
                    "profiled_kernel_forms": forms, **loop_record(steps["captured"])}
            if kind == "plain":
                plain_outs = outs["captured"][0]
            else:
                add("step_shapes_debug", by_kind["captured"])
                t_len = c.optimizer.max_iterations
                ran = sum(loop_iterations(aux.solve.iterations, t_len)
                          for _, aux in outs["captured"][0])
                k7 = counter("spd_solve", nb)
                if by_kind["captured"][k7] != ran:
                    fail(f"{where}: {k7} launched {by_kind['captured'][k7]} "
                         f"times, the LM loops ran {ran} iterations")
                for t, (got, want) in enumerate(zip(outs["captured"][0], plain_outs)):
                    same_results(f"{where} tick {t} vs the plain tick", got, want)
                cell["equal_to_the_plain_tick"] = True
            cells.append(cell)
            del steps, outs
        if name in GENERAL_DEBUG_CELLS:
            add("step_shapes_compacted", phase_compacted_tick([(name, cfg, sc, poses)], dev))
        del sc
    emit({"phase": "step_shapes", "cells": cells})
    return totals


BENCH_TICKS = 10  # the CLI's --iters in the cli phase


def phase_bench(dev):
    """The CLI's bench loop (runtime/bench.py: BenchLoop), BENCH_TICKS ticks
    on the social config at B = B_MAIN and on the reference's defaults at
    B = B_WIDE: one graph launch for all the ticks against the host loop
    (one step launch a tick), the last tick's command bit for bit; the
    kernels' launch counts equal but lm_continue's (the loop over ticks adds
    its own), the trajectorizer once a tick; host operations per bench tick
    of both; ms per bench tick of both in turns (host loop, one launch, one
    launch, host loop, twice). Returns the one launch's launch counts."""
    from nav2_social_mpc_controller_tpu_torch import _build
    from nav2_social_mpc_controller_tpu_torch.core.config import (
        SocialMPCConfig, benchmark_social_config,
    )
    from nav2_social_mpc_controller_tpu_torch.runtime.bench import BenchLoop

    n = BENCH_TICKS
    cells, total = [], {}
    for name, cfg, batch in (("social", benchmark_social_config(), B_MAIN),
                             ("default", SocialMPCConfig(), B_WIDE)):
        sc, _ = make_batch(cfg, batch, dev, n_valid_people=3)
        bench = BenchLoop(cfg, device=dev)
        if not bench.captured:
            fail(f"bench {name}: the bench loop is not one launch on the card")
        kinds = {"one_launch": lambda: bench(sc, n), "host_loop": lambda: bench.host_loop(sc, n)}
        for run in kinds.values():
            run()  # capture, warm
        torch.cuda.synchronize()
        got, launches, host_ops = {}, {}, {}
        for kind, run in kinds.items():
            bench.reset_host_launches()
            bench.step.tick.reset_host_launches()
            _build.reset_launch_counts()
            got[kind] = run()
            torch.cuda.synchronize()
            launches[kind] = dict(_build.launch_counts)
            host_ops[kind] = dict(bench.host_launches if kind == "one_launch"
                                  else bench.step.tick.host_launches)
        differ = bits_differ(got["one_launch"], got["host_loop"])
        if differ != 0:
            fail(f"bench {name}: the one launch's last command differs from the host loop's "
                 f"in {differ:.0f} elements")
        if without_loop(launches["one_launch"]) != without_loop(launches["host_loop"]):
            fail(f"bench {name}: kernel launches {launches['one_launch']} in one launch, "
                 f"{launches['host_loop']} in the host loop")
        check_launches(f"bench {name}", launches["one_launch"], DEFAULT_PATH_KERNELS, ticks=n)
        if host_ops["one_launch"]["graph_replays"] != 1:
            fail(f"bench {name}: {host_ops['one_launch']} for {n} ticks, not one graph launch")
        ms = {kind: [] for kind in kinds}
        for _ in range(2):
            for kind in ("host_loop", "one_launch", "one_launch", "host_loop"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                kinds[kind]()
                torch.cuda.synchronize()
                ms[kind].append((time.perf_counter() - t0) * 1e3 / n)
        for k, v in launches["one_launch"].items():
            total[k] = total.get(k, 0) + v
        cells.append({
            "config": name, "batch": batch, "ticks": n, "bit_equal_to_host_loop": True,
            "launches": launches["one_launch"], "host_operations": host_ops,
            "host_operations_per_tick": {k: sum(v.values()) / n for k, v in host_ops.items()},
            "ms_per_tick": ms,
            "ms_per_tick_median": {k: float(np.median(v)) for k, v in ms.items()},
            "linear_x_lane0": float(got["one_launch"].linear_x[0]),
        })
        del bench, kinds
    emit({"phase": "bench", "cells": cells})
    return total


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


def check_launches(name, launches, expected, ticks=None):
    """Every kernel of the path launched, every other kernel not at all;
    with `ticks`, the trajectorizer once a tick."""
    for kname, n in launches.items():
        if kname in expected and n <= 0:
            fail(f"{name}: kernel {kname} was never launched on this path")
        if kname not in expected and n != 0:
            fail(f"{name}: kernel {kname} is not on this path yet was launched {n} times")
    if ticks is not None and launches["trajectorize"] != ticks:
        fail(f"{name}: trajectorize launched {launches['trajectorize']} times in {ticks} ticks")


def check_one_sample_per_evaluation(name, launches):
    """An evaluation launches the rollout-sample kernel once, then K2 (each
    in either form)."""
    samples = launches["rollout_sample"] + launches["rollout_sample_general"]
    evaluations = launches["fused_iter"] + launches["fused_iter_general"]
    if samples != evaluations:
        fail(f"{name}: rollout_sample launched {samples} times for {evaluations} evaluations")


def loop_iterations(iterations, max_iterations):
    """LM iterations the loop of lm_solve ran for a batch whose lanes ran
    `iterations`: it stops at the first check (every DEFAULT_CHECK_EVERY-th
    iteration) that finds every lane done, or at the cap."""
    from nav2_social_mpc_controller_tpu_torch.solver.lm import DEFAULT_CHECK_EVERY as every

    if every <= 0:  # the loop never asks: it runs to the cap
        return max_iterations
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
    loops = loop_record(step)

    opt = cfg.optimizer
    dims = ProblemDims.from_config(cfg)
    check_launches(name, launches,
                   path_kernels(DEFAULT_PATH_KERNELS, dims.n_blocks, cfg.n_agents),
                   ticks=n_ticks)
    check_one_sample_per_evaluation(name, launches)
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
        "host_operations": dict(step.tick.host_launches), **loops,
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


PROFILE_PAD_KERNELS = 128  # empty spin kernels a profiled call runs behind
PROFILE_PADS_SEEN = []  # the spin kernels each device_activity saw, newest last


def device_activity(fn):
    """[name, count, device ms] of every device activity (kernels and
    copies) one call of fn() starts, from torch.profiler, largest first;
    empty if the profiler records no device activity on this machine. A
    CUDA graph's replay lists each of its kernels and copies. On the card
    the profiler now and then loses a session's first records (13 to 33 of
    them, often in most sessions late in a long run), or all of them, so
    the call runs behind PROFILE_PAD_KERNELS empty spin kernels: the
    records lost are theirs. Spin kernels are left out of the rows; the
    number seen goes to PROFILE_PADS_SEEN."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD_KERNELS):
            torch.cuda._sleep(0)
        fn()
        torch.cuda.synchronize()
    rows, pads = [], 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if not str(getattr(ev, "device_type", "")).endswith("CUDA") or dev_us <= 0:
            continue
        if "spin_kernel" in ev.key:
            pads += ev.count
        else:
            rows.append([ev.key, ev.count, dev_us / 1e3])
    PROFILE_PADS_SEEN.append(pads)
    rows.sort(key=lambda r: -r[2])
    return rows


def count_device_launches(fn, top=8):
    """Device launches one call of fn() starts, from torch.profiler: (their
    number, kernels and copies, their summed device time in ms, the `top`
    by device time as [name, count, ms]); (None, None, None) if the profiler
    records no device activity on this machine."""
    rows = device_activity(fn)
    if not rows:
        return None, None, None
    return (sum(r[1] for r in rows), sum(r[2] for r in rows),
            [[name[:72], n, ms] for name, n, ms in rows[:top]])


def is_copy(name):
    """A device copy: a memcpy or memset (a CUDA graph's memcpy node may be
    listed as a kernel named memcpy32_post), or ATen's copy kernel (a
    copy_ or clone between layouts that a memcpy cannot do)."""
    return name.lower().startswith(("memcpy", "memset")) or "direct_copy_kernel" in name


def one_launch_tick(step):
    """The program of `step`'s last tick if that tick was one launch of a
    parent graph (make_step_batch's on the card), else None."""
    prog = getattr(getattr(step, "tick", None), "_last", None)
    return prog if getattr(prog, "parent", None) is not None else None


def last_tick_stages(prog):
    """([(name, stage, runs in the last tick)], (loop kernel, its launches
    in the last tick)) of a one-launch program, as the device recorded them
    in its loop counter (the runs of each stage run in a loop, prog.slots,
    and the condition kernel's launches, counted since the launch counts
    were last settled): the caller settles them just before the tick and
    calls this before anything reads them again. The head and the tail run
    once a tick."""
    s = prog.counter.stats.tolist()
    runs = {id(stage): s[slot] for slot, stage in prog.slots}
    return ([(name, stage, runs.get(id(stage), 1)) for name, stage in program_stages(prog)],
            (prog.counter.kernel, s[1]))


def one_launch_profile(step):
    """(device kernels, device copies, busy ms, {kernel name: count}) of the
    last tick of a one-launch `step`. torch.profiler (CUPTI) lists a
    conditional node's body once however often it runs, so the tick is
    composed: each stage graph that ran profiled alone (replayed: the next
    tick rewrites every buffer before it reads it) times its runs in that
    tick (last_tick_stages, from the device's record: the launch counts
    settled just before the tick), and the loop kernel at its launches (its
    time, ~2 us a launch, not in the busy ms)."""
    prog = one_launch_tick(step)
    stages, (loop_name, loop) = last_tick_stages(prog)
    kernels = copies = 0
    busy, by_name = 0.0, {}
    for what, stage, times in stages:
        if not times:
            continue
        k, c, ms, names = count_kernels_and_copies(stage.graph.replay, f"the {what} graph")
        kernels, copies, busy = kernels + k * times, copies + c * times, busy + ms * times
        for name, n in names.items():
            by_name[name] = by_name.get(name, 0) + n * times
    by_name[f"{loop_name}_kernel"] = loop
    return kernels + loop, copies, busy, by_name


def parent_graph_ms(step, reps=20):
    """One launch of the last program's parent graph: its device ms, timed
    as time_cuda times a kernel (the one-launch tick's device span from its
    static inputs), and the host ms the launch call takes to return. The
    launch counts owed by the device are settled first and its loop
    counters left as they were."""
    from nav2_social_mpc_controller_tpu_torch import _build

    prog = one_launch_tick(step)
    _build.launch_counts.settle()
    saved = prog.counter.stats.clone()
    out = {"parent_graph_device_ms": time_cuda(prog.parent.launch, reps),
           "parent_graph_launch_host_ms": time_host(prog.parent.launch, 5)}
    prog.counter.stats.copy_(saved)
    return out


def tick_activity(step, run, top=8):
    """count_device_launches of one tick run(), for a one-launch tick
    composed by one_launch_profile (the top kernels then by count)."""
    from nav2_social_mpc_controller_tpu_torch import _build

    if one_launch_tick(step) is None:
        return count_device_launches(run, top)
    _build.launch_counts.settle()
    run()
    torch.cuda.synchronize()
    kernels, copies, busy, by_name = one_launch_profile(step)
    most = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return kernels + copies, busy, [[name[:72], n, None] for name, n in most]


def count_kernels_and_copies(fn, what="a call", tries=3, most=8):
    """(device kernels, device copies, busy ms, {kernel name: count}) of one
    call of fn(), from torch.profiler. The profiler loses records (see
    device_activity) and never adds any, so fn(), which must launch the
    same work each call, is profiled at least `tries` times and until the
    profile with the most records has come twice, at most `most` times; the
    profile with the most records among those that came at least twice is
    taken; fails if none came twice. Differing profiles are printed to
    stderr."""
    def size(p):
        return sum(p[0].values()) + p[1]

    seen = []
    for k in range(most):
        rows = device_activity(fn)
        by_name = {}
        for name, n, _ in rows:
            if not is_copy(name):
                by_name[name] = by_name.get(name, 0) + n
        copies = sum(r[1] for r in rows if is_copy(r[0]))
        seen.append((by_name, copies, sum(r[2] for r in rows)))
        twice = [p for i, p in enumerate(seen) if p[0] and any(
            (p[0], p[1]) == (q[0], q[1]) for q in seen[:i])]
        if k + 1 >= tries and twice and size(max(twice, key=size)) == max(map(size, seen)):
            break
    if not any(p[0] for p in seen):
        fail(f"torch.profiler recorded no device activity for {what}")
    if not twice:
        fail(f"torch.profiler gave {len(seen)} different profiles of {what}: kernels "
             f"{[sum(p[0].values()) for p in seen]}, copies {[p[1] for p in seen]}")
    by_name, copies, busy = max(twice, key=size)
    if len({(tuple(sorted(p[0].items())), p[1]) for p in seen}) > 1:
        print(f"chip_smoke: profiles of {what}: kernels {[sum(p[0].values()) for p in seen]}, "
              f"copies {[p[1] for p in seen]}, spin kernels "
              f"{PROFILE_PADS_SEEN[-len(seen):]}", file=sys.stderr)
    return sum(by_name.values()), copies, busy, by_name


def phase_timing(configs, dev):
    """`configs`: (name, cfg, valid people per scenario) of each path timed:
    make_step_batch's tick (captured), beside it the eager tick's peak
    memory and the eager stages' breakdown."""
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
        eager = make_step_batch(cfg, device=dev, capture=False)
        torch.cuda.reset_peak_memory_stats()
        run_ticks(eager, sc, poses, make_carry(cfg, batch, device=dev))
        peak_eager = torch.cuda.max_memory_allocated()
        del eager
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
        # breakdown of the last (warm) tick by stage, host clock around
        # syncs: the eager tick's stage functions
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
        n_dev, dev_ms, top_kernels = tick_activity(step, lambda: step(scen, carry_in))
        ms = float(np.mean(ticks))
        cells.append({
            "config": name, "batch": batch, "captured": step.captured,
            "capture_s": step.tick.capture_seconds,
            "ms_per_tick": ms, "solves_per_s": batch / ms * 1e3,
            "ms_per_tick_p50": float(np.median(ticks)), "ms_per_tick_min": float(np.min(ticks)),
            "mean_lm_iterations": float(aux.solve.iterations.float().mean()),
            "max_lm_iterations": int(aux.solve.iterations.max()),
            "termination_counts": torch.bincount(aux.solve.termination.long(), minlength=6).tolist(),
            "kernel_launches_per_tick": per_tick,
            "device_launches_per_tick": n_dev, "device_busy_ms_per_tick": dev_ms,
            "top_device_kernels": top_kernels,
            "breakdown_min_ms": {k: float(np.min(v)) for k, v in stages.items()},
            "peak_device_memory_bytes": peak, "peak_device_memory_bytes_eager": peak_eager,
        })
    emit({"phase": "timing", "cells": cells})


def phase_lm_sync_sweep(configs, dev, policies=(0, 1, 4, 8)):
    """ms/tick with lm_solve(check_every=k) for each k, on the eager tick and
    on the one-launch tick (controller/graph.py's GraphTick with the same k,
    whose loop bodies hold k iterations, checked on the device), timed in
    turns (forwards, backwards,
    forwards) so that no policy always runs first; at B = 1 (one robot),
    1024 and 4096. The results of a tick do not depend on k (done lanes are
    frozen bit for bit). `configs`: (name, cfg, valid people per scenario)."""
    from nav2_social_mpc_controller_tpu_torch.controller.controller import (
        make_carry, step_post, step_pre,
    )
    from nav2_social_mpc_controller_tpu_torch.controller.graph import GraphTick
    from nav2_social_mpc_controller_tpu_torch.controller.optimize import ProblemDims, make_lm_config
    from nav2_social_mpc_controller_tpu_torch.ops.fused_iter import build_value_grad
    from nav2_social_mpc_controller_tpu_torch.solver.lm import lm_solve

    def eager_tick(cfg, k):
        dims = ProblemDims.from_config(cfg)
        lm_cfg = make_lm_config(cfg.optimizer)
        t_len = lm_cfg.max_iterations if cfg.optimizer.debug_optimizer else 0

        def tick(scen, carry):
            ctx = step_pre(cfg, scen, carry)
            p = ctx.prep
            vg = build_value_grad(cfg, dims, p.rows, p.n_rows, p.people_proj, p.people_present,
                                  p.costmap)
            u, stats, *trace = lm_solve(vg, p.u0, p.lower, p.upper, lm_cfg, trace_len=t_len,
                                        check_every=k)
            return step_post(cfg, ctx, carry, u, stats, *trace)
        return tick

    cells = []
    with torch.no_grad():
        for (name, cfg, n_valid), mode, batch in [
                (c, m, b) for c in configs for m in ("eager", "captured")
                for b in (1, B_WIDE, B_MAIN)]:
            sc, poses = make_batch(cfg, batch, dev, n_valid_people=n_valid)
            ticks, iters = {k: [] for k in policies}, []
            steps = {k: eager_tick(cfg, k) if mode == "eager" else GraphTick(cfg, dev, k)
                     for k in policies}
            for rnd in range(4):  # round 0 warms up (and captures) and is not kept
                for k in policies[:: 1 if rnd % 2 == 0 else -1]:
                    carry = make_carry(cfg, batch, device=dev)
                    for pose in poses:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        _, aux, carry = steps[k](with_pose(sc, pose), carry)
                        torch.cuda.synchronize()
                        if rnd > 0:
                            ticks[k].append((time.perf_counter() - t0) * 1e3)
                        iters.append(float(aux.solve.iterations.float().mean()))
            cells.append({
                "config": name, "tick": mode, "batch": batch,
                "mean_lm_iterations": float(np.mean(iters)),
                "mean_ms_per_tick": {str(k): float(np.mean(v)) for k, v in ticks.items()},
                "min_ms_per_tick": {str(k): float(np.min(v)) for k, v in ticks.items()},
                "max_ms_per_tick": {str(k): float(np.max(v)) for k, v in ticks.items()},
            })
            if mode == "captured":  # the device's counters, every round's ticks
                cells[-1]["loop_body_runs"] = {str(k): s.body_runs for k, s in steps.items()}
    emit({"phase": "lm_sync_sweep", "ticks_per_policy": 9, "cells": cells})


def named_leaves(tree, prefix=""):
    """(dotted field name, tensor) of every leaf of a (nested) NamedTuple."""
    for field, x in zip(tree._fields, tree):
        if isinstance(x, tuple):
            yield from named_leaves(x, f"{prefix}{field}.")
        elif x is not None:
            yield f"{prefix}{field}", x


def same_bits(where, got, want, parts=("cmd", "aux", "carry"), kinds=("captured", "eager")):
    """Fail unless two results, trees named by `parts`, agree in every leaf
    bit for bit (commands, status, cursor, iterations, termination, costs,
    paths, the people projection, the carry, the trace; NaN against NaN of
    the same bits is equal). `kinds` names the two ticks in the message."""
    for part, a, b in zip(parts, got, want):
        la, lb = list(named_leaves(a, f"{part}.")), list(named_leaves(b, f"{part}."))
        if [n for n, _ in la] != [n for n, _ in lb]:
            fail(f"{where}: the {kinds[0]} and the {kinds[1]} tick return other leaves")
        for (name, x), (_, y) in zip(la, lb):
            if bits_differ([x], [y]) != 0:
                fail(f"{where}: {name} of the {kinds[0]} tick differs from the {kinds[1]} tick's")


GRAPH_TIMED_ROUNDS = 3


def program_stages(prog):
    """(name, stage) of every graph of a captured program's tick: head, the
    chunks (the loops' bodies by length n, `chunk_{n}`; compacted, by rung
    width W and length, `chunk_{W}x{n}`), the compacted tick's transitions
    and scatters, tail."""
    stages = [("head", prog.head)]
    widths = getattr(prog, "widths", None)
    if widths is None:
        stages += [(f"chunk_{n}", c) for n, c in zip(prog.lengths, prog.chunks)]
    else:
        for k, w in enumerate(widths):
            stages += [(f"chunk_{w}x{n}", c) for n, c in prog.chunks[k].items()]
            if k + 1 < len(widths):
                stages.append((f"transition_{w}_to_{widths[k + 1]}", prog.transitions[k]))
        stages += [(f"scatter_{w}", prog.scatters[k]) for k, w in enumerate(widths) if k]
    return stages + [("tail", prog.tail)]


def loop_record(step):
    """What the one-launch tick of `step` says of its last program: the LM
    iterations of its last tick and the loops' body runs since the tick's
    reset_host_launches (both read from the device counter), and, if the
    program has a parent graph of its own (one nested in a campaign has
    none), its nodes, in all and by type (its own, its child graphs' and
    its loops' bodies')."""
    tick = step.tick
    record = {"lm_iterations_last_tick": len(tick.width_log), "loop_body_runs": tick.body_runs}
    if tick._last.parent is not None:
        types = tick._last.parent.node_types()
        record.update(parent_graph_nodes=sum(types.values()), parent_graph_node_types=types)
    return record


def stage_device_ms(step, reps=20):
    """Device ms of each stage graph of the one program `step`'s captured
    tick holds (program_stages), replayed back to back as time_cuda times a
    kernel. Direct replays: the launch counts stay; the next tick rewrites
    every buffer before it reads it."""
    prog, = step.tick._programs.values()
    return {name: time_cuda(stage.graph.replay, reps) for name, stage in program_stages(prog)}


def trajectorize_alone(cfg, sc, pose, reps=20):
    """The trajectorizer by itself on the scenarios' whole plans (not the
    tick's plan windows) and the tick's pose: the kernel's device ms,
    beside the plain loop of small launches, its device kernels (profiler)
    and the device ms of its own CUDA graph, both timed as time_cuda times
    a kernel."""
    from nav2_social_mpc_controller_tpu_torch.controller.trajectorizer import (
        trajectorize, trajectorize_plain,
    )

    def run():
        return trajectorize_plain(cfg.trajectorizer, sc.path, pose)

    graph = plain_graph(run)
    kernels, _, busy, _ = count_kernels_and_copies(run)
    return {"kernel_ms": time_cuda(lambda: trajectorize(cfg.trajectorizer, sc.path, pose), reps),
            "plain_kernels": kernels, "plain_busy_ms": busy,
            "plain_graph_ms": time_cuda(graph.replay, reps)}


def host_launches_per_tick(tick, n_ticks):
    """What the host launched a tick for the captured tick: graph launches,
    input copies and output clones."""
    return sum(tick.host_launches.values()) / n_ticks


def phase_graph(paths, dev):
    """The one-launch tick (make_step_batch's default on the card: one
    parent graph a tick, its LM solve a conditional WHILE node) against the
    eager tick (capture=False), on the four configs.

    `paths`: (name, cfg, valid people, scenario batch, per-tick poses) at the
    main paths' shapes, the carry fed back: every output and the carry bit
    for bit; the kernels' launch counts equal but lm_continue's (the chunk's
    tally times the bodies' runs, read from the device); the device kernels
    of one tick equal but the eager loop's done-check reductions, which are
    lm_continue's work in the one-launch tick (its kernels composed by
    one_launch_profile: the profiler lists a WHILE body once); one graph
    launch a tick; host-side launches per tick of both,
    the loop's body runs, the parent graph's nodes, device ms and launch
    host ms. Then B = 1 (make_step), SINGLE_STEP_SEEDS seeds x 2 ticks each,
    bit for bit, and the single-robot tick of both in turns; then ms/tick at
    B = 1024 and 4096 (obstacle, social) in turns, capture seconds and
    device memory."""
    from nav2_social_mpc_controller_tpu_torch import _build
    from nav2_social_mpc_controller_tpu_torch.controller.controller import (
        make_carry, make_step, make_step_batch,
    )

    cells = []
    for name, cfg, n_valid, sc, poses in paths:
        batch = sc.robot.pose.shape[0]
        steps = {"eager": make_step_batch(cfg, device=dev, capture=False),
                 "captured": make_step_batch(cfg, device=dev)}
        if steps["eager"].captured or not steps["captured"].captured:
            fail(f"graph {name}: make_step_batch does not capture the default tick on the card")
        outs, launches = {}, {}
        for kind, step in steps.items():
            run_ticks(step, sc, poses[:1], make_carry(cfg, batch, device=dev))  # capture, warm
            if kind == "captured":
                step.tick.reset_host_launches()
            _build.reset_launch_counts()
            outs[kind] = run_ticks(step, sc, poses, make_carry(cfg, batch, device=dev))
            launches[kind] = dict(_build.launch_counts)
        for t, (got, want) in enumerate(zip(outs["captured"][0], outs["eager"][0])):
            same_bits(f"graph {name} B = {batch} tick {t}", got, want)
        same_bits(f"graph {name} B = {batch}", (outs["captured"][1],), (outs["eager"][1],),
                  parts=("carry",))
        if without_loop(launches["captured"]) != without_loop(launches["eager"]):
            fail(f"graph {name}: kernel launches {launches['captured']} captured, "
                 f"{launches['eager']} eager")
        check_launches(f"graph {name}", launches["captured"], DEFAULT_PATH_KERNELS,
                       ticks=len(poses))
        host = host_launches_per_tick(steps["captured"].tick, len(poses))
        host_ops = dict(steps["captured"].tick.host_launches)
        if host_ops["graph_replays"] != len(poses):
            fail(f"graph {name}: {host_ops} over {len(poses)} ticks, not one graph launch a "
                 "tick")
        loops = loop_record(steps["captured"])
        carry = make_carry(cfg, batch, device=dev)
        prof = {"eager": count_kernels_and_copies(
            lambda: steps["eager"](with_pose(sc, poses[0]), carry))}
        _build.launch_counts.settle()  # the device's record then holds this tick's runs
        steps["captured"](with_pose(sc, poses[0]), carry)
        torch.cuda.synchronize()
        prof["captured"] = one_launch_profile(steps["captured"])
        # the eager loop's done checks (a reduction each) are lm_continue's
        # work in the one-launch tick
        checks = {k: n for k, n in prof["eager"][3].items() if "and_kernel" in k}
        loop_kernels = {k: n for k, n in prof["captured"][3].items()
                        if any(lk in k for lk in LOOP_KERNELS)}
        eager_rest = {k: n for k, n in prof["eager"][3].items() if k not in checks}
        if not loop_kernels or without_loop_names(prof["captured"][3]) != eager_rest:
            got, want = prof["captured"][3], eager_rest
            diff = {k[:160]: [want.get(k, 0), got.get(k, 0)] for k in set(got) | set(want)
                    if got.get(k, 0) != want.get(k, 0)}
            fail(f"graph {name}: the profiler counts {prof['captured'][0]} device kernels in "
                 f"a captured tick, {prof['eager'][0]} in an eager tick; by name [eager, "
                 f"captured]: {json.dumps(diff)}")
        stages = stage_device_ms(steps["captured"])
        cells.append({
            "config": name, "batch": batch, "ticks": len(poses), "bit_equal": True,
            "stage_device_ms": stages,
            "trajectorize": trajectorize_alone(cfg, sc, poses[0]),
            "launches": launches["captured"],
            "device_kernels_one_tick": {k: v[0] for k, v in prof.items()},
            "device_copies_one_tick": {k: v[1] for k, v in prof.items()},
            "device_busy_ms_one_tick": {k: v[2] for k, v in prof.items()},
            "host_launches_per_tick": {"eager": sum(prof["eager"][:2]), "captured": host},
            "host_operations": host_ops, "lm_continue_kernels_one_tick": loop_kernels,
            "eager_done_check_reductions_one_tick": checks,
            **parent_graph_ms(steps["captured"]),
            **loops, "capture_s": steps["captured"].tick.capture_seconds,
        })
        del steps, outs

    # One robot: make_step of both against each other, seed by seed.
    single = []
    for name, cfg, n_valid, _, _ in paths:
        sc, poses = make_batch(cfg, SINGLE_STEP_SEEDS, dev, n_valid_people=n_valid)
        steps = {"eager": make_step(cfg, device=dev, capture=False),
                 "captured": make_step(cfg, device=dev)}
        if not steps["captured"].captured:
            fail("graph: make_step does not capture its tick on the card")
        for i in range(SINGLE_STEP_SEEDS):
            res = {}
            for kind, step in steps.items():
                carry, res[kind] = make_carry(cfg, device=dev), []
                for pose in poses[:2]:
                    cmd, aux, carry = step(lane(with_pose(sc, pose), i), carry)
                    res[kind].append((cmd, aux, carry))
            for t, (got, want) in enumerate(zip(res["captured"], res["eager"])):
                same_bits(f"graph {name} B = 1 seed {i} tick {t}", got, want)
        single.append(name)
    name, cfg, n_valid, _, _ = paths[0]
    sc, _ = make_batch(cfg, 1, dev, n_valid_people=n_valid)
    one = lane(sc, 0)
    n_pts = int(one.path.n)
    steps = {"eager": make_step(cfg, device=dev, capture=False),
             "captured": make_step(cfg, device=dev)}
    ms = {k: [] for k in steps}
    for kind in ("eager", "captured", "captured", "eager") * 2:
        carry = make_carry(cfg, device=dev)
        for k in range(30):
            i = min(k, n_pts - 1)
            scen = one._replace(robot=one.robot._replace(
                pose=torch.cat([one.path.points[i], one.path.yaw[i:i + 1]])))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, carry = steps[kind](scen, carry)
            torch.cuda.synchronize()
            if k >= 5:
                ms[kind].append((time.perf_counter() - t0) * 1e3)
    one_robot = {"config": name, **{k: host_ms_stats(v) for k, v in ms.items()},
                 **loop_record(steps["captured"]),
                 "stage_device_ms": stage_device_ms(steps["captured"]),
                 "trajectorize": trajectorize_alone(cfg, sc, sc.robot.pose)}
    del steps

    # ms/tick of both in turns; capture seconds; device memory of each.
    timing = []
    for name, cfg, n_valid, batch in [(n, c, v, b) for n, c, v, _, _ in paths[:2]
                                      for b in (B_WIDE, B_MAIN)]:
        sc, poses = make_batch(cfg, batch, dev, n_valid_people=n_valid)
        steps, memory = {}, {}
        for kind in ("eager", "captured"):
            steps[kind], memory[kind] = step_memory(
                lambda: make_step_batch(cfg, device=dev, capture=kind == "captured"),
                lambda step: run_ticks(step, sc, poses, make_carry(cfg, batch, device=dev)))
        ms = {k: [] for k in steps}
        for _ in range(GRAPH_TIMED_ROUNDS):
            for kind in ("eager", "captured", "captured", "eager"):
                ms[kind] += time_ticks(steps[kind], sc, poses,
                                       lambda: make_carry(cfg, batch, device=dev), rounds=1)
        timing.append({"config": name, "batch": batch,
                       "ms_per_tick": {k: host_ms_stats(v) for k, v in ms.items()},
                       "capture_s": steps["captured"].tick.capture_seconds, "memory": memory})
        del steps
    emit({"phase": "graph", "cells": cells, "single_step_bit_equal": single,
          "single_step_seeds": SINGLE_STEP_SEEDS, "single_robot_ms": one_robot,
          "timing": timing, "programs": GRAPH_PROGRAMS})


# The staged programs the card replays, and the phase that holds each
# against its eager tick (each of those phases prints its stage graphs).
GRAPH_PROGRAMS = {
    "make_step_batch": {"stages": "head, chunk_{n}, tail", "launch":
                        "one parent graph: head, WHILE {chunk_{n}, lm_continue}, tail",
                        "phase": "graph"},
    "make_step_batch + debug_optimizer": {"stages": "head, chunk_{n}, tail",
                                          "launch": "one parent graph, as above",
                                          "phase": "debug_tick"},
    "make_step_batch_compacted": {
        "stages": "head, chunk_{W}x{n}, transition_{W}_to_{W'}, scatter_{W}, tail",
        "launch": "one parent graph: head, per rung compact_continue, WHILE {chunk, "
                  "compact_continue}, IF {remainder chunk}, IF {transition}; compact_continue, "
                  "IF {scatter} per rung; tail",
        "phase": "compacted_tick"},
    "Simulator campaign": {"stages": "the step's, handoff, world",
                           "launch": "one parent graph: lm_continue, WHILE {the step's nodes, "
                                     "handoff, world, lm_continue}",
                           "phase": "sim"},
}


def step_memory(make, run):
    """(step, memory): a step built by make() and run by run(step), with the
    device memory it took at its peak and what it keeps reserved after
    (its graphs' pool, for a captured step), in bytes."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base, base_reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    step = make()
    run(step)
    peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.empty_cache()  # what stays reserved is the step's own
    return step, {"peak_allocated_bytes": peak,
                  "held_bytes": torch.cuda.memory_reserved() - base_reserved}


def in_turns(steps, order, run):
    """{kind: [host ms of each tick]} of run(steps[kind]) (time_ticks's
    list) for kind in `order`: the kinds taken in turns within one call."""
    ms = {kind: [] for kind in steps}
    for kind in order:
        ms[kind] += run(steps[kind])
    return ms


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
    n_dev, dev_ms, _ = tick_activity(step, lambda: step(scen, carry))
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
    back. make_step_batch's default launches it as one CUDA graph a tick
    (one loop body, whose lanes write the trace columns of their own
    iteration counts); the eager
    debug tick (capture=False) runs the same ticks: every leaf, the trace
    included, equal bit for bit, and the same launch counts. The general LM
    iteration launches K7's damped step once per iteration the loop runs and
    K3/K4 never; it repeats the default iteration's arithmetic, so every
    result must equal the plain tick's bit for bit (the gate ROADMAP.md
    defines — lanes that stopped after the same number of iterations within
    1e-3 — is implied and checked first). Then ms/tick of both in turns,
    their device launches, the stage graphs, host launches, capture seconds
    and memory; and the first tick's solve through a caller's linear_solve
    (K7's standalone solve) against the damped step
    (general_solve_vs_composition). Returns the captured ticks' launch
    counts."""
    from nav2_social_mpc_controller_tpu_torch import _build
    from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry, make_step_batch
    from nav2_social_mpc_controller_tpu_torch.controller.optimize import ProblemDims, make_lm_config

    batch = sc.robot.pose.shape[0]
    dbg = replace_optimizer(cfg, debug_optimizer=True)
    t_len = cfg.optimizer.max_iterations
    where = f"debug_tick {name}"
    nb = ProblemDims.from_config(cfg).n_blocks
    k7 = counter("spd_solve", nb)

    def fresh():
        return make_carry(cfg, batch, device=dev)

    plain_outs, plain_carry = run_ticks(make_step_batch(cfg, device=dev), sc, poses, fresh())
    steps, memory = {}, {}
    for kind in ("captured", "eager"):  # the first tick captures the graphs
        steps[kind], memory[kind] = step_memory(
            lambda: make_step_batch(dbg, device=dev, capture=kind == "captured"),
            lambda step: run_ticks(step, sc, poses[:1], fresh()))
    if not steps["captured"].captured or steps["eager"].captured:
        fail(f"{where}: make_step_batch does not capture the debug tick on the card")
    steps["captured"].tick.reset_host_launches()
    runs, by_kind = {}, {}
    for kind in ("captured", "eager"):
        _build.reset_launch_counts()
        runs[kind] = run_ticks(steps[kind], sc, poses, fresh())
        by_kind[kind] = dict(_build.launch_counts)
    host = host_launches_per_tick(steps["captured"].tick, len(poses))
    host_ops = dict(steps["captured"].tick.host_launches)
    outs, carry = runs["captured"]
    for t, (got, want) in enumerate(zip(outs, runs["eager"][0])):
        same_bits(f"{where} tick {t}", got, want, parts=("cmd", "aux"))
    same_bits(where, (carry,), (runs["eager"][1],), parts=("carry",))
    if without_loop(by_kind["captured"]) != without_loop(by_kind["eager"]):
        fail(f"{where}: kernel launches {by_kind['captured']} captured, {by_kind['eager']} eager")
    launches = by_kind["captured"]
    check_launches(where, launches, path_kernels(DEBUG_PATH_KERNELS, nb, cfg.n_agents),
                   ticks=len(poses))
    if host_ops["graph_replays"] != len(poses):
        fail(f"{where}: {host_ops} over {len(poses)} ticks, not one graph launch a tick")
    loops = loop_record(steps["captured"])
    check_one_sample_per_evaluation(where, launches)

    ran = sum(loop_iterations(aux.solve.iterations, t_len) for _, aux in outs)
    if launches[k7] != ran:
        fail(f"{where}: {k7} launched {launches[k7]} times, the LM loops ran "
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

    ms = in_turns(steps, ("eager", "captured", "captured", "eager") * 2,
                  lambda step: time_ticks(step, sc, poses, fresh, rounds=1))
    profiles = {kind: profile_last_tick(step, sc, poses, fresh) for kind, step in steps.items()}
    _, _, vs_caller, _ = general_solve_vs_composition(
        where, dbg, make_lm_config(dbg.optimizer), dev, sc, poses[0], t_len)
    ran_last = loop_iterations(outs[-1][1].solve.iterations, t_len)
    emit({
        "phase": "debug_tick", "config": f"{name} + debug_optimizer", "batch": batch,
        "ticks": len(outs), "launches": launches, "lm_loop_iterations": ran,
        "captured_bit_equal_to_eager": True,
        "ms_per_tick": {k: host_ms_stats(v) for k, v in ms.items()},
        "device_launches_per_tick": {k: v[0] for k, v in profiles.items()},
        "device_busy_ms_per_tick": {k: v[1] for k, v in profiles.items()},
        "lm_loop_iterations_last_tick": ran_last,
        "device_launches_per_loop_iteration_last_tick": {
            k: None if v[0] is None else v[0] / ran_last for k, v in profiles.items()},
        "host_launches_per_tick": host, "host_operations": host_ops, **loops,
        **parent_graph_ms(steps["captured"]),
        "stage_device_ms": stage_device_ms(steps["captured"]),
        "capture_s": steps["captured"].tick.capture_seconds, "memory": memory,
        "mean_lm_iterations_per_tick": [float(a.solve.iterations.float().mean()) for _, a in outs],
        "vs_plain_tick": {"lanes_with_other_iteration_count": apart_lanes,
                          "cmd_delta_max_same_iterations": worst_same, "bit_equal": True},
        "first_tick_solve_vs_caller_linear_solve": vs_caller,
    })
    return launches


def phase_jacobi(name, cfg, dev, sc, pose):
    """A Jacobi-scaled solve of the prepared problems of one tick
    (LMConfig(jacobi_scaling=True) through lm_solve: the general iteration,
    K7's damped step with the scale, once per loop iteration), beside the
    unscaled general solve; and the same scaled solve through a caller's
    linear_solve (K7's standalone solve in the plain composition), which must
    give the same bits; on `name`'s config (social: D = 6, stress36: D = 12).
    Gated: all lanes usable, the solution inside its box.
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
        f"jacobi {name}", cfg, jac_cfg, dev, sc, pose, 0)
    with torch.no_grad():
        prep = step_pre(cfg, with_pose(sc, pose), make_carry(cfg, batch, device=dev)).prep
        vg = build_value_grad(cfg, prep)
        u_gen, s_gen, _ = lm_solve(vg, prep.u0, prep.lower, prep.upper, lm_cfg,
                                   trace_len=lm_cfg.max_iterations)
        torch.cuda.synchronize()
    if launches["spd_solve"] != ran:
        fail(f"jacobi {name}: spd_solve launched {launches['spd_solve']} times, the loop ran {ran}")
    if launches["propose"] or launches["commit"]:
        fail(f"jacobi {name}: the scaled solve went through propose/commit")
    if not bool(s_jac.usable.all()):
        fail(f"jacobi {name}: {int((~s_jac.usable).sum())} lanes unusable")
    if not bool((torch.isfinite(u_jac) & (u_jac >= prep.lower) & (u_jac <= prep.upper)).all()):
        fail(f"jacobi {name}: a solution left its box")
    delta = (u_jac - u_gen).abs().max(dim=1).values
    emit({
        "phase": "jacobi", "config": name, "batch": batch, "d": int(u_jac.shape[1]),
        "launches_spd_solve": launches["spd_solve"], "launches": launches,
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


# The residual path's (cost, g, JtJ) against the fused path's, and against
# the latent evaluation's on the latent config, scale-normalised per scenario:
# two float32 evaluations of the same fourth-power costs that sum in other
# orders (a (B, R, D) Jacobian contracted by a matrix product against
# per-step accumulation in K2's warps and the latent rows' own sums) and, in
# the people stages, torch's exp/atan2 against CUDA's.
RESIDUAL_VS_FUSED_TOL = 1e-4
LATENT_WEIGHTS = {"pure_angle_weight": 0.5, "curvature_weight": 0.3}
ONE_ROBOT_CEILING_MS = 50.0  # a tick at 20 Hz


def latent_config(cfg):
    return replace_optimizer(cfg, weights=LATENT_WEIGHTS)


def residual_tick(cfg, scen, carry):
    """The tick solved through the reference evaluation (the residual path,
    ResidualValueGrad: D forward-mode passes over the whole residual stack):
    step_pre, lm_solve, step_post. Returns (cmd, aux, carry')."""
    from nav2_social_mpc_controller_tpu_torch.controller.controller import step_post, step_pre
    from nav2_social_mpc_controller_tpu_torch.controller.optimize import (
        ProblemDims, ResidualValueGrad, build_residual_fn, make_lm_config,
    )
    from nav2_social_mpc_controller_tpu_torch.solver.lm import lm_solve

    dims = ProblemDims.from_config(cfg)
    with torch.no_grad():
        ctx = step_pre(cfg, scen, carry)
        prep = ctx.prep
        vg = ResidualValueGrad(build_residual_fn(
            cfg, dims, prep.rows, prep.n_rows, prep.people_proj, prep.people_present,
            prep.costmap), 2 * dims.n_blocks)
        u, stats = lm_solve(vg, prep.u0, prep.lower, prep.upper, make_lm_config(cfg.optimizer))
        return step_post(cfg, ctx, carry, u, stats)


def against_residual_tick(where, got, want):
    """The fault rule of ROADMAP.md section 3 between a tick and the same
    tick solved through the residual path: status and plan cursor equal; a
    lane that stopped by a tolerance on both sides after the same number of
    iterations within 1e-3 in its command. Cap-bound lanes (the iteration
    cap on either side) chatter at float32 and tolerance stops at other
    iteration counts branch apart: both are counted and printed."""
    (cmd, aux), (cmd_r, aux_r) = got, want
    if not torch.equal(aux.status, aux_r.status):
        fail(f"{where}: status differs from the residual-path tick's")
    if not torch.equal(aux.plan_start_index, aux_r.plan_start_index):
        fail(f"{where}: plan cursor differs from the residual-path tick's")
    delta = torch.maximum((cmd.linear_x - cmd_r.linear_x).abs(),
                          (cmd.angular_z - cmd_r.angular_z).abs())
    stopped = (aux.solve.termination != 0) & (aux_r.solve.termination != 0)
    same = aux.solve.iterations == aux_r.solve.iterations
    converged, apart, cap = stopped & same, stopped & ~same, ~stopped
    worst = float(delta[converged].max()) if bool(converged.any()) else 0.0
    if not worst <= 1e-3:
        fail(f"{where}: a lane that stopped by a tolerance after the same number of "
             f"iterations as on the residual-path tick differs by {worst:.3e} > 1e-3")

    def share(mask):
        return {"lanes": int(mask.sum()),
                "delta_max": float(delta[mask].max()) if bool(mask.any()) else 0.0}

    return {"cmd_delta_p50": float(delta.quantile(0.5)), "cmd_delta_max": float(delta.max()),
            "share_within_1e-3": float((delta <= 1e-3).float().mean()),
            "tolerance_stops_same_iterations": share(converged),
            "tolerance_stops_other_iterations": share(apart), "cap_bound": share(cap),
            "status_and_cursor_equal": True}


def phase_latent_evaluation(cfg, dev, sc, pose):
    """One evaluation of the latent config (LatentValueGrad: rollout_sample,
    K2, the latent rows' term) at B = 1024 social problems: its (cost, g,
    JtJ) against the residual path's (ResidualValueGrad) within
    RESIDUAL_VS_FUSED_TOL, and on `cfg` (no latent critic) the residual
    path's against the fused evaluation's; the kernel launches of one latent
    evaluation (rollout_sample and K2 once each); device launches and busy
    ms (torch.profiler) and host ms of the latent and the residual
    evaluation; device ms of the latent, the fused evaluation and the
    latent term alone, each replayed as a CUDA graph."""
    from nav2_social_mpc_controller_tpu_torch import _build
    from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry, step_pre
    from nav2_social_mpc_controller_tpu_torch.controller.optimize import (
        ProblemDims, ResidualValueGrad, build_residual_fn, build_value_grad,
    )
    from nav2_social_mpc_controller_tpu_torch.ops import fused_iter, latent

    lat = latent_config(cfg)
    if fused_iter.can_fuse(lat) or not fused_iter.can_fuse(cfg):
        fail("latent_evaluation: the configs do not sit on the two sides of can_fuse")
    batch = pose.shape[0]
    dims = ProblemDims.from_config(cfg)
    scen = with_pose(sc, pose)
    evals, errs = {}, {}
    with torch.no_grad():
        for name, c in (("fused", cfg), ("latent", lat)):
            prep = step_pre(c, scen, make_carry(c, batch, device=dev)).prep
            args = (c, dims, prep.rows, prep.n_rows, prep.people_proj, prep.people_present,
                    prep.costmap)
            evals[name] = (build_value_grad(c, prep), prep.u0)
            evals[f"residual_{name}"] = (
                ResidualValueGrad(build_residual_fn(*args), 2 * dims.n_blocks), prep.u0)
        if not isinstance(evals["latent"][0], latent.LatentValueGrad):
            fail("latent_evaluation: build_value_grad does not give the latent evaluation")
        for name in ("fused", "latent"):
            vg, u = evals[name]
            ref, _ = evals[f"residual_{name}"]
            errs[name] = [norm_err(a, b_)[0] for a, b_ in zip(ref(u), vg(u))]
            if not max(errs[name]) <= RESIDUAL_VS_FUSED_TOL:
                fail(f"latent_evaluation: the residual path and the {name} evaluation "
                     f"(cost, g, JtJ) differ by {errs[name]} > {RESIDUAL_VS_FUSED_TOL}")
        vg, u = evals["latent"]
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        vg(u)
        torch.cuda.synchronize()
        one = dict(_build.launch_counts)
        if {k: n for k, n in one.items() if n} != {"rollout_sample": 1, "fused_iter": 1}:
            fail(f"latent_evaluation: one latent evaluation launched {one}")
        profiles = {}
        for name in ("latent", "residual_latent"):
            vg_n, u_n = evals[name]
            n_dev, dev_ms, top = count_device_launches(lambda: vg_n(u_n))
            profiles[name] = {"device_launches": n_dev, "device_busy_ms": dev_ms,
                              "host_ms": time_host(lambda: vg_n(u_n), 3 if "residual" in name
                                                   else 20), "top_device_kernels": top}
        term_args = vg.latent_inputs(vg.fused_inputs(u))
        graphs = {"latent": plain_graph(lambda: vg(u)),
                  "fused": plain_graph(lambda: evals["fused"][0](evals["fused"][1])),
                  "latent_term": plain_graph(lambda: latent.latent_cost_g_jtj(*term_args))}
        device_ms = {name: time_cuda(g.replay, 20) for name, g in graphs.items()}
        n_term, term_busy, _ = count_device_launches(graphs["latent_term"].replay)
    emit({
        "phase": "latent_evaluation", "config": "social + pure_angle_weight 0.5 + "
        "curvature_weight 0.3", "batch": batch, "launches_one_evaluation": one,
        "profiles": profiles, "graph_device_ms": device_ms,
        "latent_term": {"device_launches": n_term, "device_busy_ms": term_busy,
                        "share_of_latent_evaluation_device_ms":
                            device_ms["latent_term"] / device_ms["latent"]},
        "residual_vs_latent_norm_err": {"cost": errs["latent"][0], "g": errs["latent"][1],
                                        "jtj": errs["latent"][2], "tol": RESIDUAL_VS_FUSED_TOL},
        "residual_vs_fused_norm_err": {"cost": errs["fused"][0], "g": errs["fused"][1],
                                       "jtj": errs["fused"][2], "tol": RESIDUAL_VS_FUSED_TOL},
    })


def phase_latent_tick(cells, dev):
    """The latent-critic tick (both latent critics on): make_step_batch's
    default launches it as one CUDA graph a tick, its evaluation the latent
    one. On
    each of `cells` (name, latent cfg, scenario batch, per-tick poses), the
    ticks with the carry fed back through the captured and the eager tick
    (capture=False): every leaf bit for bit, the same launch counts, which
    hold the default path's kernels (rollout_sample and K2 once an
    evaluation, the standalone K1 never). Printed: evaluations a tick, ms a
    tick of both in turns, device launches and busy ms of a tick, host
    launches a tick, stage graphs, capture seconds, memory. On the first
    cell its first tick is also solved through the residual path (the
    tick's former evaluation, timed): held to ROADMAP.md's fault rule. Then
    one robot (make_step, B = 1): SINGLE_STEP_SEEDS seeds x 2 ticks bit for
    bit, and its warm tick min/p50/p90 of both in turns; the captured p90
    must stay under ONE_ROBOT_CEILING_MS. Returns the first cell's captured
    launch counts."""
    from nav2_social_mpc_controller_tpu_torch import _build
    from nav2_social_mpc_controller_tpu_torch.controller.controller import (
        make_carry, make_step, make_step_batch,
    )

    path_launches = None
    for name, lat, sc, poses in cells:
        batch = sc.robot.pose.shape[0]
        where = f"latent_tick {name}"

        def fresh():
            return make_carry(lat, batch, device=dev)

        steps, memory = {}, {}
        for kind in ("captured", "eager"):  # the first tick captures the graphs
            steps[kind], memory[kind] = step_memory(
                lambda: make_step_batch(lat, device=dev, capture=kind == "captured"),
                lambda step: run_ticks(step, sc, poses[:1], fresh()))
        if not steps["captured"].captured or steps["eager"].captured:
            fail(f"{where}: make_step_batch does not capture the latent tick on the card")
        steps["captured"].tick.reset_host_launches()
        runs, by_kind = {}, {}
        for kind in ("captured", "eager"):
            _build.reset_launch_counts()
            runs[kind] = run_ticks(steps[kind], sc, poses, fresh())
            by_kind[kind] = dict(_build.launch_counts)
        host = host_launches_per_tick(steps["captured"].tick, len(poses))
        outs, carry = runs["captured"]
        for t, (got, want) in enumerate(zip(outs, runs["eager"][0])):
            same_bits(f"{where} tick {t}", got, want, parts=("cmd", "aux"))
            check_tick_outputs(f"{where} tick {t}", lat, *got)
        same_bits(where, (carry,), (runs["eager"][1],), parts=("carry",))
        if without_loop(by_kind["captured"]) != without_loop(by_kind["eager"]):
            fail(f"{where}: kernel launches {by_kind['captured']} captured, "
                 f"{by_kind['eager']} eager")
        launches = by_kind["captured"]
        check_launches(where, launches, DEFAULT_PATH_KERNELS, ticks=len(poses))
        check_one_sample_per_evaluation(where, launches)
        host_ops = dict(steps["captured"].tick.host_launches)
        if host_ops["graph_replays"] != len(poses):
            fail(f"{where}: {host_ops} over {len(poses)} ticks, not one graph launch a tick")
        loops = loop_record(steps["captured"])
        if launches["fused_iter"] != launches["propose"] + len(poses):
            fail(f"{where}: {launches['fused_iter']} evaluations for {launches['propose']} LM "
                 f"iterations in {len(poses)} ticks (one an iteration and one a tick)")
        if path_launches is None:
            path_launches = launches
        ms = in_turns(steps, ("eager", "captured", "captured", "eager") * 2,
                      lambda step: time_ticks(step, sc, poses, fresh, rounds=1))
        profiles = {kind: profile_last_tick(step, sc, poses, fresh) for kind, step in steps.items()}
        line = {
            "phase": "latent_tick",
            "config": f"{name} + pure_angle_weight 0.5 + curvature_weight 0.3",
            "batch": batch, "ticks": len(poses), "launches": launches,
            "evaluations_per_tick": launches["fused_iter"] / len(poses),
            "captured_bit_equal_to_eager": True,
            "ms_per_tick": {k: host_ms_stats(v) for k, v in ms.items()},
            "device_launches_per_tick": {k: v[0] for k, v in profiles.items()},
            "device_busy_ms_per_tick": {k: v[1] for k, v in profiles.items()},
            "host_launches_per_tick": {"eager": profiles["eager"][0], "captured": host},
            "host_operations": host_ops, **loops,
            **parent_graph_ms(steps["captured"]),
            "stage_device_ms": stage_device_ms(steps["captured"]),
            "capture_s": steps["captured"].tick.capture_seconds, "memory": memory,
            "mean_lm_iterations_per_tick": [float(a.solve.iterations.float().mean())
                                            for _, a in outs],
            "termination_counts": [torch.bincount(a.solve.termination.long(),
                                                  minlength=6).tolist() for _, a in outs],
            "share_with_a_person_in_view": float(
                (outs[0][1].people_proj[:, 1, :, 3] != -1.0).any(dim=1).float().mean()),
        }
        if name == cells[0][0]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cmd_r, aux_r, _ = residual_tick(lat, with_pose(sc, poses[0]), fresh())
            torch.cuda.synchronize()
            line["residual_path_tick"] = {
                "seconds": time.perf_counter() - t0,
                "mean_lm_iterations": float(aux_r.solve.iterations.float().mean()),
                "vs_captured_tick_0": against_residual_tick(where, outs[0], (cmd_r, aux_r))}
        emit(line)
        del steps, runs

    # One robot: make_step of both against each other seed by seed, then
    # its warm tick on the host clock in turns, riding its plan.
    name, lat, _, _ = cells[0]
    sc, poses = make_batch(lat, SINGLE_STEP_SEEDS, dev, n_valid_people=lat.n_agents)
    steps = {"eager": make_step(lat, device=dev, capture=False),
             "captured": make_step(lat, device=dev)}
    if not steps["captured"].captured:
        fail("latent_tick: make_step does not capture the latent tick on the card")
    for i in range(SINGLE_STEP_SEEDS):
        res = {}
        for kind, step in steps.items():
            carry, res[kind] = make_carry(lat, device=dev), []
            for pose in poses[:2]:
                cmd, aux, carry = step(lane(with_pose(sc, pose), i), carry)
                res[kind].append((cmd, aux, carry))
        for t, (got, want) in enumerate(zip(res["captured"], res["eager"])):
            same_bits(f"latent_tick {name} B = 1 seed {i} tick {t}", got, want)
    one = lane(sc, 0)
    n_pts = int(one.path.n)
    steps = {"eager": make_step(lat, device=dev, capture=False),
             "captured": make_step(lat, device=dev)}
    ms = {k: [] for k in steps}
    for kind in ("eager", "captured", "captured", "eager") * 2:
        carry = make_carry(lat, device=dev)
        for k in range(30):
            i = min(k, n_pts - 1)
            scen = one._replace(robot=one.robot._replace(
                pose=torch.cat([one.path.points[i], one.path.yaw[i:i + 1]])))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, carry = steps[kind](scen, carry)
            torch.cuda.synchronize()
            if k >= 5:
                ms[kind].append((time.perf_counter() - t0) * 1e3)
    stats = {k: host_ms_stats(v) for k, v in ms.items()}
    emit({"phase": "latent_tick", "config": f"{name} + pure_angle_weight 0.5 + "
          "curvature_weight 0.3, one robot (make_step, B = 1)",
          "bit_equal_seeds": SINGLE_STEP_SEEDS, "ticks": 2, "host_ms": stats,
          "ceiling_ms": ONE_ROBOT_CEILING_MS, **loop_record(steps["captured"]),
          "capture_s": steps["captured"].tick.capture_seconds,
          "stage_device_ms": stage_device_ms(steps["captured"])})
    if not stats["captured"]["p90"] < ONE_ROBOT_CEILING_MS:
        fail(f"latent_tick: one robot's captured latent tick takes {stats['captured']['p90']:.2f} "
             f"ms at p90, not under {ONE_ROBOT_CEILING_MS} ms")
    return path_launches


WARM_TICKS = 10  # warm ticks of the compacted phase, under bench.py's pose perturbation


def run_logged(step, sc, poses, carry):
    """run_ticks, with each tick's width_log: ([(cmd, aux)], carry, [widths])."""
    outs, logs = [], []
    for pose in poses:
        cmd, aux, carry = step(with_pose(sc, pose), carry)
        outs.append((cmd, aux))
        logs.append(list(step.tick.width_log))
    torch.cuda.synchronize()
    return outs, carry, logs


def phase_compacted_tick(cells, dev, capacity_frac=0.25):
    """The compacted warm-start tick at full width, on each of `cells`
    (name, cfg, scenario batch, per-tick poses): `cfg` with
    warm_start_mode="previous_solution", its ticks with the carry fed back,
    through make_step_batch_compacted's default (one launch of a parent
    graph a tick: chunks per rung of the width ladder, transitions and
    scatters under conditional nodes that compact_continue steers on the
    device), through the eager compacted tick (capture=False) and through
    the captured plain tick (make_step_batch). Every kernel works scenario
    by scenario, so compaction changes no lane: every leaf of the three
    equals bit for bit; the captured compacted tick ran the eager one's
    widths and its kernel launch counts, but for compact_continue's own.
    A captured tick is 36 host launches (17 input copies, one graph launch,
    18 output clones), and its ticks after the first run
    under torch.cuda.set_sync_debug_mode("error"). On the first cell also
    WARM_TICKS ticks from the first pose, perturbed per tick as bench.py
    perturbs it (+1e-6 * t), held likewise. Printed: iterations x width of
    the compacted and the plain solver (from the steps' width_log), mean
    iterations, ms/tick of the three in turns, device launches and busy ms
    of a tick, stage graph device ms, the parent graph's nodes, device ms
    and launch host ms, host launches a tick, capture seconds, peak memory.
    Returns the first cell's captured compacted ticks' launch counts."""
    from nav2_social_mpc_controller_tpu_torch import _build
    from nav2_social_mpc_controller_tpu_torch.controller.controller import (
        make_carry, make_step_batch, make_step_batch_compacted,
    )

    from nav2_social_mpc_controller_tpu_torch.controller.optimize import ProblemDims

    path_launches = None
    for name, cfg, sc, poses in cells:
        batch = sc.robot.pose.shape[0]
        warm = replace_optimizer(cfg, warm_start_mode="previous_solution")
        where = f"compacted_tick {name}"
        nb = ProblemDims.from_config(cfg).n_blocks

        def fresh():
            return make_carry(warm, batch, device=dev)

        makers = {
            "captured": lambda: make_step_batch_compacted(warm, capacity_frac, device=dev),
            "eager": lambda: make_step_batch_compacted(warm, capacity_frac, device=dev,
                                                       capture=False),
            "plain": lambda: make_step_batch(warm, device=dev),
        }
        steps, memory = {}, {}
        for kind, make in makers.items():  # the first tick captures the graphs
            steps[kind], memory[kind] = step_memory(
                make, lambda step: run_ticks(step, sc, poses[:1], fresh()))
        if not steps["captured"].captured or steps["eager"].captured:
            fail(f"{where}: make_step_batch_compacted does not capture its tick on the card")

        def held(sequence, label):
            """Each kind's ticks over `sequence` from a fresh carry, held
            against each other; returns {kind: (outs, launches, widths)}."""
            for step in steps.values():
                if step.captured:
                    step.tick.reset_host_launches()
            res = {}
            for kind, step in steps.items():
                _build.reset_launch_counts()
                outs, carry, logs = run_logged(step, sc, sequence, fresh())
                res[kind] = (outs, carry, dict(_build.launch_counts), logs)
            for other in ("eager", "plain"):
                for t, (got, want) in enumerate(zip(res["captured"][0], res[other][0])):
                    same_bits(f"{where} {label} tick {t}", got, want, parts=("cmd", "aux"),
                              kinds=("captured compacted", other))
                same_bits(f"{where} {label}", (res["captured"][1],), (res[other][1],),
                          parts=("carry",), kinds=("captured compacted", other))
            if without_loop(res["captured"][2]) != without_loop(res["eager"][2]):
                fail(f"{where} {label}: kernel launches {res['captured'][2]} captured, "
                     f"{res['eager'][2]} eager")
            if res["captured"][3] != res["eager"][3]:
                fail(f"{where} {label}: widths {res['captured'][3]} captured, "
                     f"{res['eager'][3]} eager")
            for t, (cmd, aux) in enumerate(res["captured"][0]):
                check_tick_outputs(f"{where} {label} tick {t}", warm, cmd, aux)
            return res

        res = held(poses, "main")
        launches = res["captured"][2]
        # the schedule runs on the device: compact_continue, no lm_continue
        check_launches(where, launches, path_kernels(COMPACTED_PATH_KERNELS, nb, cfg.n_agents),
                       ticks=len(poses))
        check_one_sample_per_evaluation(where, launches)
        host = {kind: host_launches_per_tick(steps[kind].tick, len(poses))
                for kind in ("captured", "plain")}
        host_ops = dict(steps["captured"].tick.host_launches)
        if host["captured"] != 36 or host_ops["graph_replays"] != len(poses):
            fail(f"{where}: {host_ops} over {len(poses)} ticks, not 36 host launches (one "
                 "graph launch) a tick")
        carry = fresh()
        steps["captured"](with_pose(sc, poses[0]), carry)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for pose in poses:
                carry = steps["captured"](with_pose(sc, pose), carry)[2]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        if path_launches is None:
            path_launches = launches

        def work(r):
            return {"compacted": [sum(w) for w in r["captured"][3]],
                    "plain": [sum(w) for w in r["plain"][3]],
                    "widths_run": [sorted(set(w), reverse=True) for w in r["captured"][3]],
                    "mean_lm_iterations": [float(a.solve.iterations.float().mean())
                                           for _, a in r["captured"][0]],
                    "max_lm_iterations": [int(a.solve.iterations.max())
                                          for _, a in r["captured"][0]]}

        order = ("captured", "eager", "plain", "plain", "eager", "captured") * 2
        ms = in_turns(steps, order, lambda step: time_ticks(step, sc, poses, fresh, rounds=1))
        cell = {
            "phase": "compacted_tick", "config": f"{name} + warm_start_mode=previous_solution",
            "batch": batch, "ticks": len(poses), "capacity_frac": capacity_frac,
            "ladder": next(iter(steps["captured"].tick._programs.values())).widths,
            "launches": launches, "bit_equal": {"eager": True, "plain": True},
            "iterations_x_width": work(res),
            "ms_per_tick": {k: host_ms_stats(v) for k, v in ms.items()},
            "host_launches_per_tick": host, "sync_debug_ticks": len(poses),
            "capture_s": steps["captured"].tick.capture_seconds, "memory": memory,
        }
        if name == cells[0][0]:
            perturbed = [(poses[0] + 1e-6 * t).contiguous() for t in range(WARM_TICKS)]
            warm_res = held(perturbed, "warm")
            ms_warm = in_turns(steps, order,
                               lambda step: time_ticks(step, sc, perturbed, fresh, rounds=1))
            cell["warm_ticks"] = {
                "ticks": WARM_TICKS, "iterations_x_width": work(warm_res),
                "ms_per_tick": {k: host_ms_stats(v) for k, v in ms_warm.items()},
                "ms_per_tick_last_5": {k: host_ms_stats(
                    [x for i, x in enumerate(v) if i % WARM_TICKS >= WARM_TICKS - 5])
                    for k, v in ms_warm.items()},
            }
        profiles = {kind: profile_last_tick(step, sc, poses, fresh) for kind, step in steps.items()}
        cell["device_launches_last_tick"] = {k: v[0] for k, v in profiles.items()}
        cell["device_busy_ms_last_tick"] = {k: v[1] for k, v in profiles.items()}
        cell["stage_device_ms"] = stage_device_ms(steps["captured"])
        cell.update(loop_record(steps["captured"]), **parent_graph_ms(steps["captured"]))
        emit(cell)
        del steps, res
    return path_launches


# ---------------------------------------------------------------------------
# the runtime surface: one robot's tick, the controller object, the
# closed-loop simulator, the 20 Hz loop, the CLI, the native generator
# ---------------------------------------------------------------------------

SINGLE_STEP_SEEDS = 8
SINGLE_STEP_TIMED_TICKS = 100


def lane(tree, i):
    """Scenario i of a batched tree, unbatched (views on the device)."""
    return type(tree)(*(lane(x, i) if isinstance(x, tuple) else x[i] for x in tree))


def host_ms_stats(ms):
    return {"ticks": len(ms), "min": float(np.min(ms)), "p50": float(np.percentile(ms, 50)),
            "p90": float(np.percentile(ms, 90)), "mean": float(np.mean(ms))}


def phase_single_step(configs, dev):
    """make_step (one robot, a batch of one) on the card: for each config,
    SINGLE_STEP_SEEDS scenarios of a wide batch (B_WIDE, two ticks with the
    carry fed back) run one by one; command, status, LM iterations,
    termination and the carry must equal the same scenario's lane of the
    wide tick bit for bit (every kernel works scenario by scenario, so a
    launch of one live scenario must compute what a full launch does). Then
    the warm single-robot tick latency on the host clock, from tensors on
    the card and from NumPy (what the controller object pays to hand its
    inputs over every tick), and one profiled tick. Returns the launch
    counts of the single-robot ticks."""
    from nav2_social_mpc_controller_tpu_torch import _build
    from nav2_social_mpc_controller_tpu_torch.controller.controller import (
        make_carry, make_step, make_step_batch,
    )
    from nav2_social_mpc_controller_tpu_torch.core.types import scenario_from_numpy, to_numpy
    from nav2_social_mpc_controller_tpu_torch.solver.lm import DEFAULT_CHECK_EVERY

    launches = {k: 0 for k in _build.launch_counts}
    cells = []
    for name, cfg, n_valid in configs:
        sc, poses = make_batch(cfg, B_WIDE, dev, n_valid_people=n_valid)
        poses = poses[:2]
        step_w = make_step_batch(cfg, device=dev)
        carry_w = make_carry(cfg, B_WIDE, device=dev)
        wide = []
        for pose in poses:
            cmd_w, aux_w, carry_w = step_w(with_pose(sc, pose), carry_w)
            wide.append((cmd_w, aux_w, carry_w))
        step = make_step(cfg, device=dev)
        _build.reset_launch_counts()
        for i in range(SINGLE_STEP_SEEDS):
            carry = make_carry(cfg, device=dev)
            for t, pose in enumerate(poses):
                cmd, aux, carry = step(lane(with_pose(sc, pose), i), carry)
                cmd_w, aux_w, carry_w = wide[t]
                pairs = {
                    "linear_x": (cmd.linear_x, cmd_w.linear_x[i]),
                    "angular_z": (cmd.angular_z, cmd_w.angular_z[i]),
                    "status": (aux.status, aux_w.status[i]),
                    "iterations": (aux.solve.iterations, aux_w.solve.iterations[i]),
                    "termination": (aux.solve.termination, aux_w.solve.termination[i]),
                    "final_cost": (aux.solve.final_cost, aux_w.solve.final_cost[i]),
                    "cmds": (aux.cmds, aux_w.cmds[i]),
                    "people_proj": (aux.people_proj, aux_w.people_proj[i]),
                }
                pairs.update({f"carry.{f}": (x, y[i])
                              for f, x, y in zip(carry._fields, carry, carry_w)})
                if aux.lm_trace is not None:  # the debug tick: its trace too
                    pairs.update({f"lm_trace.{f}": (x, y[i]) for f, x, y in
                                  zip(aux.lm_trace._fields, aux.lm_trace, aux_w.lm_trace)})
                for what, (x, y) in pairs.items():
                    if bits_differ([x], [y]) != 0:
                        fail(f"single_step {name}: seed {i} tick {t}: {what} of the B = 1 tick "
                             f"differs from its lane of the B = {B_WIDE} tick")
        torch.cuda.synchronize()
        got = dict(_build.launch_counts)
        debug = cfg.optimizer.debug_optimizer
        check_launches(f"single_step {name}", got,
                       DEBUG_PATH_KERNELS if debug else DEFAULT_PATH_KERNELS,
                       ticks=SINGLE_STEP_SEEDS * len(poses))
        check_one_sample_per_evaluation(f"single_step {name}", got)
        for k, v in got.items():
            launches[k] += v
        cells.append({"config": name, "seeds": SINGLE_STEP_SEEDS, "ticks": len(poses),
                      "wide_batch": B_WIDE, "bit_equal": True, "trace_compared": debug,
                      "launches": got, **loop_record(step)})

    # Latency of one robot's warm tick (social), the carry fed back, the
    # robot riding its plan; from tensors already on the card, then from
    # NumPy leaves (host -> device copy of the grids every tick).
    name, cfg, n_valid = configs[0]
    sc, _ = make_batch(cfg, 1, dev, n_valid_people=n_valid)
    one = lane(sc, 0)
    one_np = to_numpy(one)
    step = make_step(cfg, device=dev)
    n_pts = int(one.path.n)

    def ride(k):
        i = min(k, n_pts - 1)
        return torch.cat([one.path.points[i], one.path.yaw[i:i + 1]])

    def timed(inputs, n):
        ms, iters = [], []
        carry = make_carry(cfg, device=dev)
        for k in range(n):
            scen = inputs(k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, aux, carry = step(scen, carry)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            iters.append(int(aux.solve.iterations))
        return ms, iters

    def from_tensors(k):
        return one._replace(robot=one.robot._replace(pose=ride(k)))

    def from_numpy(k):
        return one_np._replace(robot=one_np.robot._replace(pose=ride(k).cpu().numpy()))

    timed(from_tensors, 8)  # warm-up
    step.tick.reset_host_launches()
    ms_t, iters_t = timed(from_tensors, SINGLE_STEP_TIMED_TICKS)
    host_t = {k: v / SINGLE_STEP_TIMED_TICKS for k, v in step.tick.host_launches.items()}
    runs_t = step.tick.body_runs / SINGLE_STEP_TIMED_TICKS  # the device's loop counter
    ms_n, _ = timed(from_numpy, SINGLE_STEP_TIMED_TICKS)
    conv = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scenario_from_numpy(one_np, device=dev)
        torch.cuda.synchronize()
        conv.append((time.perf_counter() - t0) * 1e3)
    carry = make_carry(cfg, device=dev)
    for k in range(3):
        _, _, carry = step(from_tensors(k), carry)
    n_dev, dev_ms, top = tick_activity(step, lambda: step(from_tensors(3), carry))
    np_bytes = sum(np.asarray(x).nbytes for x in
                   (one_np.costmap.data, one_np.esdf.distances, one_np.esdf.indexes))
    emit({"phase": "single_step", "cells": cells,
          "latency": {
              "config": name, "captured": step.captured, "host_ms_tensor_input": host_ms_stats(ms_t),
              "host_ms_numpy_input": host_ms_stats(ms_n),
              "numpy_to_device_ms": host_ms_stats(conv), "grid_bytes_copied": int(np_bytes),
              "mean_lm_iterations": float(np.mean(iters_t)),
              "lm_loop_body_runs_per_tick": runs_t,
              "lm_loop_body_iterations": DEFAULT_CHECK_EVERY,
              "host_operations_per_tick": host_t,
              "device_launches_one_tick": n_dev, "device_busy_ms_one_tick": dev_ms,
              "top_device_kernels": top,
              "meets_50_ms": bool(np.percentile(ms_t, 90) <= 50.0),
          }})
    return launches


def straight_plan(cfg, length_m=12.0):
    """tests/test_host_controller.py's plan: max_path_points poses along x."""
    from nav2_social_mpc_controller_tpu_torch.core.types import PathInput

    pts = np.zeros((cfg.max_path_points, 2), np.float32)
    pts[:, 0] = np.linspace(0.0, length_m, cfg.max_path_points)
    return PathInput(points=pts, yaw=np.zeros(cfg.max_path_points, np.float32),
                     n=np.int32(cfg.max_path_points))


def phase_controller(cfg, dev):
    """SocialMPCController on the card over tests/test_host_controller.py's
    protocol: 6 ticks along a 12 m straight plan, the robot teleported
    1.2 m a tick. The plan cursor must be monotone and advance; set_plan
    resets it and keeps the warm start; the windows are checked once.
    Returns the launch counts."""
    from nav2_social_mpc_controller_tpu_torch import _build
    from nav2_social_mpc_controller_tpu_torch.controller import controller as ctl
    from nav2_social_mpc_controller_tpu_torch.core.types import RobotState
    from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario

    checks = []
    real = ctl.validate_scenario_windows
    ctl.validate_scenario_windows = lambda *a: (checks.append(1), real(*a))[1]
    try:
        ctrl = ctl.SocialMPCController(cfg, device=dev)
        ctrl.activate()
        plan = straight_plan(cfg)
        ctrl.set_plan(plan)
        sc = make_scenario(cfg, seed=0, n_valid_people=0)
        pose = np.zeros(3, np.float32)
        starts, ms = [0], []
        _build.reset_launch_counts()
        for _ in range(6):
            sc_t = sc._replace(robot=RobotState(pose=pose, speed=np.array([0.3, 0.0], np.float32)))
            t0 = time.perf_counter()
            cmd, aux = ctrl.compute_velocity_commands(sc_t)
            starts.append(int(aux.plan_start_index))
            ms.append((time.perf_counter() - t0) * 1e3)
            v, w, opt = cmd.linear_x, cmd.angular_z, cfg.optimizer  # bounds in float32
            if not bool((v >= opt.v_min) & (v <= opt.v_max) & (w >= opt.w_min) & (w <= opt.w_max)):
                fail(f"controller: command ({float(v)}, {float(w)}) non-finite or out of bounds")
            pose = pose + np.array([1.2, 0.0, 0.0], np.float32)
        torch.cuda.synchronize()
        launches = dict(_build.launch_counts)
        if not all(b >= a for a, b in zip(starts, starts[1:])) or not starts[-1] > starts[1]:
            fail(f"controller: the plan cursor is not monotone or did not advance: {starts}")
        prev_n = int(ctrl._carry.prev_n)
        ctrl.set_plan(plan)
        if int(ctrl._carry.plan_start) != 0 or int(ctrl._carry.prev_n) != prev_n:
            fail("controller: set_plan did not reset the cursor or lost the warm start")
        if len(checks) != 1:
            fail(f"controller: the windows were checked {len(checks)} times in 6 ticks, not once")
    finally:
        ctl.validate_scenario_windows = real
    check_launches("controller", launches, DEFAULT_PATH_KERNELS, ticks=6)
    emit({"phase": "controller", "cursors": starts, "window_checks": len(checks),
          "host_ms_per_tick": ms, "launches": launches})
    return launches


SIM_TICKS = 40
SIM_LANE_TICKS = 10


def phase_native(cfg, dev):
    """The native (g++) scenario generator: it must be available; a batch
    of B_MAIN social scenarios, timed cold (the build on a fresh checkout
    included) and warm; one tick on it. Returns the NumPy batch."""
    from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry, make_step_batch
    from nav2_social_mpc_controller_tpu_torch.core.types import scenario_from_numpy
    from nav2_social_mpc_controller_tpu_torch.runtime import esdf, scenario_native

    t0 = time.perf_counter()
    ok = scenario_native.native_available() and esdf.native_available()
    build_s = time.perf_counter() - t0
    if not ok:
        fail("native: the g++-built scenario generator or ESDF builder is not available")
    gen_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        sc_np = scenario_native.generate_scenario_batch(cfg, B_MAIN, base_seed=0,
                                                        n_valid_people=cfg.n_agents)
        gen_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    sc = scenario_from_numpy(sc_np, device=dev)
    torch.cuda.synchronize()
    to_dev_ms = (time.perf_counter() - t0) * 1e3
    if sc.esdf.indexes.dtype != torch.int32 or sc.path.n.dtype != torch.int32:
        fail("native: integer leaves did not arrive as int32")
    cmd, aux, _ = make_step_batch(cfg, device=dev)(sc, make_carry(cfg, B_MAIN, device=dev))
    torch.cuda.synchronize()
    if not bool(torch.isfinite(cmd.linear_x).all() & torch.isfinite(cmd.angular_z).all()):
        fail("native: non-finite command on the native batch")
    emit({"phase": "native", "batch": B_MAIN, "build_and_load_s": build_s,
          "generate_ms": gen_ms, "to_device_ms": to_dev_ms,
          "status_ok_share": float((aux.status == 0).float().mean()),
          "usable_share": float(aux.solve.usable.float().mean())})
    return sc_np


def phase_sim(cfg, dev, sc_np):
    """The closed-loop simulator on the card: a campaign of B_MAIN native
    social scenarios for SIM_TICKS ticks, captured (make_simulate's default:
    the whole campaign one launch of a parent graph that loops over the
    ticks on the device, each tick the step's nodes with its LM loops
    nested, the hand-off and the world update) and the reference loop
    (capture=False) in turns (reference, captured, captured, reference,
    twice), after a first call of each (the captured one's seconds hold
    its capture: the step's stages, nested, with no parent graph of the
    step's own): the captured SimResult equal to the reference's bit for bit and
    both launching the same kernels but the loop over ticks' SIM_TICKS + 1
    lm_continue checks; one graph launch a campaign and none by the step;
    a campaign of SIM_TICKS // 2 ticks with the same host launches and the
    first half of the results bit for bit; a campaign under
    torch.cuda.set_sync_debug_mode("error"); finite poses, commands in
    their bounds, the STATUS_OK share; ms per simulated tick of both, the
    people update's share of each (the reference's people update timed
    alone, the captured world graph's device ms) and the host's launches
    per simulated tick; lanes 0 and 1 equal bit for bit to B = 1
    simulations of those scenarios over SIM_LANE_TICKS ticks, and the two
    behavioral scenarios of tests/test_simulator.py. Returns the launch
    counts of the captured campaign."""
    from nav2_social_mpc_controller_tpu_torch import _build
    from nav2_social_mpc_controller_tpu_torch.core.config import benchmark_obstacle_only_config
    from nav2_social_mpc_controller_tpu_torch.core.types import scenario_from_numpy
    from nav2_social_mpc_controller_tpu_torch.runtime.simulator import (
        Simulator, advance_people, advance_world, make_simulate,
    )
    from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario

    opt = cfg.optimizer
    sc = scenario_from_numpy(sc_np, device=dev)
    sims = {"eager": Simulator(cfg, SIM_TICKS, device=dev, capture=False),
            "captured": make_simulate(cfg, SIM_TICKS, device=dev)}
    if sims["eager"].captured or not sims["captured"].captured:
        fail("sim: make_simulate does not capture the campaign on the card")
    first_s = {}
    for kind, sim in sims.items():  # warm: the captured one captures its campaign
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim(sc)
        torch.cuda.synchronize()
        first_s[kind] = time.perf_counter() - t0
    step_capture_s = list(sims["captured"].step.tick.capture_seconds)
    ms, res, launches, host = {k: [] for k in sims}, {}, {}, {}
    for kind in ("eager", "captured", "captured", "eager") * 2:
        sim = sims[kind]
        sim.reset_host_launches()
        sim.step.tick.reset_host_launches()
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[kind] = sim(sc)
        torch.cuda.synchronize()
        ms[kind].append((time.perf_counter() - t0) * 1e3 / SIM_TICKS)
        launches[kind] = dict(_build.launch_counts)
        step_ops = dict(sim.step.tick.host_launches)
        own = dict(sim.host_launches)
        if kind == "eager":
            if step_ops["graph_replays"] != SIM_TICKS:
                fail(f"sim {kind}: the step's host operations {step_ops} over {SIM_TICKS} "
                     "ticks, not one graph launch a tick")
            host[kind] = {"step": host_launches_per_tick(sim.step.tick, SIM_TICKS)}
        else:
            if any(step_ops.values()) or own["graph_replays"] != 1:
                fail(f"sim {kind}: host operations {own}, the step's {step_ops}, not one graph "
                     "launch a campaign and none by the step")
            host[kind] = {"campaign": sum(own.values()) / SIM_TICKS, "per_campaign": own}
    for kind in sims:
        check_launches(f"sim {kind}", launches[kind], DEFAULT_PATH_KERNELS, ticks=SIM_TICKS)
    outer = launches["captured"][LOOP_KERNEL] - launches["eager"][LOOP_KERNEL]
    if without_loop(launches["captured"]) != without_loop(launches["eager"]) or \
            outer != SIM_TICKS + 1:
        fail(f"sim: kernel launches {launches['captured']} captured, {launches['eager']} in the "
             f"reference loop (the loop over ticks' checks: {outer}, not {SIM_TICKS + 1})")
    for field, x, y in zip(res["captured"]._fields, res["captured"], res["eager"]):
        if x.shape != y.shape or x.dtype != y.dtype or not torch.equal(x, y):
            fail(f"sim: {field} of the captured simulation differs from the reference loop's")
    res = res["captured"]
    launches = launches["captured"]

    # A campaign of half the ticks: the same host launches, the first half
    # of the results. Then a campaign of the program itself (the windows
    # are checked by run_batch) with no hidden synchronisation.
    half_ticks = SIM_TICKS // 2
    half = make_simulate(cfg, half_ticks, device=dev)
    half(sc)  # captures
    half.reset_host_launches()
    r_half = half(sc)
    if half.host_launches != host["captured"]["per_campaign"]:
        fail(f"sim: host launches {half.host_launches} in {half_ticks} ticks, "
             f"{host['captured']['per_campaign']} in {SIM_TICKS}")
    for field, x, y in zip(res._fields, r_half, res):
        if field in ("min_people_dist", "goal_dist"):
            continue
        if not torch.equal(x, y[:, :x.shape[1]]):
            fail(f"sim: {field} of a {half_ticks}-tick campaign differs from the first "
                 f"{half_ticks} ticks of the {SIM_TICKS}-tick one")
    prog, = sims["captured"]._programs.values()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            again = prog(sc)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for field, x, y in zip(res._fields, again, res):
        if not torch.equal(x, y):
            fail(f"sim: {field} of a campaign under sync debug mode differs")
    campaign_nodes = prog.parent.node_types()
    del half, r_half, again

    if not bool(torch.isfinite(res.robot_traj).all()):
        fail("sim: a robot pose is not finite")
    v, w = res.cmds[..., 0], res.cmds[..., 1]
    if not bool(((v >= opt.v_min) & (v <= opt.v_max) & (w >= opt.w_min) & (w <= opt.w_max)).all()):
        fail("sim: a command left v in [v_min, v_max], w in [w_min, w_max]")

    # The reference loop's world update launches from the host, one tick of
    # it counted by the profiler; its people update alone on the campaign's
    # final state, timed on the host clock; the captured world graph's
    # device ms (its tick counter wraps, so extra replays stay inside its
    # histories; every run resets it).
    pose, speed = res.robot_traj[:, -1].contiguous(), res.cmds[:, -1].contiguous()
    people = sc.people._replace(state=res.people_traj[:, -1].contiguous())
    final = sc._replace(robot=sc.robot._replace(pose=pose, speed=speed), people=people)
    zero = torch.zeros_like(speed[:, 0])
    n_kernels, n_copies, _, _ = count_kernels_and_copies(
        lambda: advance_world(cfg, final, speed[:, 0], zero, speed[:, 1], 0.05))
    host["eager"]["world_update"] = n_kernels + n_copies
    ppl_ms = []
    for _ in range(SIM_TICKS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        advance_people(cfg, people, pose, speed, sc.esdf, 0.05)
        torch.cuda.synchronize()
        ppl_ms.append((time.perf_counter() - t1) * 1e3)
    loops = loop_record(sims["captured"].step)  # the last captured campaign's
    world_ms = time_cuda(prog.stages[1].graph.replay, 20)
    del sims, prog

    # Lanes 0 and 1 against their own B = 1 simulations.
    for i in (0, 1):
        one = make_simulate(cfg, SIM_LANE_TICKS, device=dev)(lane(sc, i))
        pairs = {"robot_traj": (one.robot_traj, res.robot_traj[i, :SIM_LANE_TICKS + 1]),
                 "people_traj": (one.people_traj, res.people_traj[i, :SIM_LANE_TICKS + 1]),
                 "cmds": (one.cmds, res.cmds[i, :SIM_LANE_TICKS]),
                 "status": (one.status, res.status[i, :SIM_LANE_TICKS])}
        for what, (x, y) in pairs.items():
            if not torch.equal(x, y):
                fail(f"sim: lane {i}'s {what} differs from its B = 1 simulation")

    # tests/test_simulator.py's two scenarios.
    obstacle = benchmark_obstacle_only_config()
    sc_o = make_scenario(obstacle, seed=0, n_valid_people=0, path_kind="straight",
                         with_obstacles=False)
    r_o = make_simulate(obstacle, 40, device=dev)(sc_o)
    goal = torch.tensor(sc_o.path.points[int(sc_o.path.n) - 1])
    closed = float(torch.linalg.norm(torch.tensor(sc_o.robot.pose[0:2]) - goal)
                   - torch.linalg.norm(r_o.robot_traj[-1, 0:2].cpu() - goal))
    if not closed >= 0.5 or not bool((r_o.status == 0).all()):
        fail(f"sim obstacle: closed {closed:.3f} m toward the goal (>= 0.5 needed), "
             f"statuses {r_o.status.tolist()}")
    sc_s = make_scenario(cfg, seed=3, n_valid_people=3, path_kind="straight")
    r_s = make_simulate(cfg, 30, device=dev)(sc_s)
    if not bool(torch.isfinite(r_s.robot_traj).all()) or not float(r_s.min_people_dist) > 0.2:
        fail(f"sim social: minimum people distance {float(r_s.min_people_dist):.3f} m <= 0.2")

    tick_ms = {k: host_ms_stats(v) for k, v in ms.items()}
    emit({"phase": "sim", "batch": sc.robot.pose.shape[0], "ticks": SIM_TICKS,
          "captured_bit_equal_to_reference": True,
          "ms_per_simulated_tick": tick_ms,
          "people_update_ms": host_ms_stats(ppl_ms),
          "world_graph_device_ms": world_ms,
          "people_update_share": {
              "eager": float(np.mean(ppl_ms)) / tick_ms["eager"]["mean"],
              "captured_world_graph": world_ms / tick_ms["captured"]["mean"]},
          "host_launches_per_simulated_tick": {
              "captured": {**host["captured"], "total": host["captured"]["campaign"]},
              "eager": {**host["eager"], "total": host["eager"]["step"]
                        + host["eager"]["world_update"]}},
          "first_campaign_s": first_s, "step_capture_s": step_capture_s,
          "half_campaign_ticks": half_ticks, "sync_debug_campaigns": 1,
          "campaign_parent_graph_nodes": sum(campaign_nodes.values()),
          "campaign_parent_graph_node_types": campaign_nodes,
          "step_loop": loops,
          "status_ok_share": float((res.status == 0).float().mean()),
          "min_people_dist_p50": float(res.min_people_dist.median()),
          "lanes_bit_equal_to_b1": [0, 1], "lane_ticks": SIM_LANE_TICKS,
          "obstacle_progress_m": closed, "social_min_people_dist": float(r_s.min_people_dist),
          "launches": launches})
    return launches


def phase_stream(cfg, dev, seconds=3.0):
    """ControllerLoop at 20 Hz for `seconds`, driving make_step on the card
    from NumPy sensor snapshots (people through a LatestValueCache).
    Overruns are reported, not failed; no tick at all fails. Returns the
    launch counts."""
    from nav2_social_mpc_controller_tpu_torch import _build
    from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry, make_step
    from nav2_social_mpc_controller_tpu_torch.runtime.stream import ControllerLoop, LatestValueCache
    from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario

    sc = make_scenario(cfg, seed=0, n_valid_people=cfg.n_agents)
    step = make_step(cfg, device=dev)
    step(sc, make_carry(cfg, device=dev))  # warm
    people = LatestValueCache(sc.people)
    cmds = []
    _build.reset_launch_counts()
    loop = ControllerLoop(step, make_carry(cfg, device=dev),
                          lambda: sc._replace(people=people.get()[0]),
                          lambda cmd, aux: cmds.append(float(cmd.linear_x)),
                          frequency_hz=20.0).start()
    time.sleep(seconds)
    loop.stop()
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    if loop.ticks == 0:
        fail("stream: the 20 Hz loop made no tick")
    if not all(np.isfinite(cmds)):
        fail("stream: a non-finite command")
    check_launches("stream", launches, DEFAULT_PATH_KERNELS)
    emit({"phase": "stream", "captured": step.captured, "frequency_hz": 20.0,
          "seconds": seconds, "ticks": loop.ticks,
          "missed": loop.missed, "overruns": loop.overruns, "launches": launches,
          **loop_record(step)})
    return launches


# The JSON keys the JAX package's CLI prints (its cmd_step / cmd_sim /
# cmd_bench); the port's CLI prints them and its platform.
CLI_KEYS = {
    "step": {"linear_x", "linear_y", "angular_z", "status", "lm_iterations", "initial_cost",
             "final_cost", "termination", "usable"},
    "sim": {"ticks", "goal_dist_final", "min_people_dist", "mean_v", "max_v", "max_abs_w",
            "status_ok_frac", "robot_final_pose"},
    "bench": {"metric", "value", "unit", "batch", "iters", "batch_latency_ms", "warmup_s",
              "platform"},
}


def phase_cli():
    """`python -m nav2_social_mpc_controller_tpu_torch` in subprocesses, on
    the card: config, step, step --debug-optimizer and sim --ticks 40 side
    by side, then bench --batch B_MAIN --iters 10 alone. Each must exit 0
    and print JSON with the JAX CLI's keys and the CUDA platform."""
    here = os.path.dirname(os.path.abspath(__file__))
    runs = {
        "config": ["config"],
        "step": ["step", "--config", "social"],
        "step_debug": ["step", "--debug-optimizer"],
        "sim": ["sim", "--ticks", "40"],
        "bench": ["bench", "--batch", str(B_MAIN), "--iters", str(BENCH_TICKS)],
        "bench_default": ["bench", "--config", "default", "--batch", str(B_WIDE), "--iters",
                          str(BENCH_TICKS)],
    }
    out = {}

    def start(argv):
        return subprocess.Popen([sys.executable, "-m", "nav2_social_mpc_controller_tpu_torch",
                                 *argv], cwd=here, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    def finish(name, proc, t0):
        try:
            so, se = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail(f"cli {name}: no result within 300 s")
        if proc.returncode != 0:
            fail(f"cli {name}: exit code {proc.returncode}: {se[-2000:]}")
        res = json.loads(so)
        kind = name.split("_")[0]
        if kind != "config":
            missing = CLI_KEYS[kind] - set(res)
            if missing or res.get("platform") != "cuda":
                fail(f"cli {name}: keys {sorted(missing)} missing or platform "
                     f"{res.get('platform')!r} is not cuda")
        elif res.get("optimizer", {}).get("control_horizon") != 18:
            fail("cli config: not the social config")
        out[name] = {"seconds": time.perf_counter() - t0,
                     **({} if kind == "config" else
                        {k: res[k] for k in sorted(res) if k not in ("iterations",)}),
                     **({"iterations_rows": len(res["iterations"])} if "iterations" in res else {})}

    t0 = time.perf_counter()
    benches = ("bench", "bench_default")
    procs = {name: start(argv) for name, argv in runs.items() if name not in benches}
    for name, proc in procs.items():
        finish(name, proc, t0)
    if out["step_debug"].get("iterations_rows", 0) != out["step_debug"]["lm_iterations"]:
        fail("cli step --debug-optimizer: no trace row per LM iteration")
    for name in benches:  # alone, one after the other
        t1 = time.perf_counter()
        finish(name, start(runs[name]), t1)
    if out["bench_default"]["metric"] != "social_mpc_solves_per_s_H5_default":
        fail(f"cli bench --config default: metric {out['bench_default']['metric']}")
    emit({"phase": "cli", "runs": out})


# Scenario data parallelism (parallel/, runtime/campaign.py, the CLI's
# dryrun and multihost).
CAMPAIGN_TICKS = 3  # then resumed for one tick more


def start_cli(argv):
    """Start `python -m nav2_social_mpc_controller_tpu_torch *argv` from the
    checkout; finish_cli waits for it."""
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen([sys.executable, "-m", "nav2_social_mpc_controller_tpu_torch", *argv],
                            cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return argv, proc, time.perf_counter()


def finish_cli(started, timeout):
    """(exit code, stdout, stderr, wall seconds) of a start_cli run; killed
    and failed after `timeout` seconds."""
    argv, proc, t0 = started
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"{' '.join(argv[:3])}: no result within {timeout} s")
    return proc.returncode, out, err, time.perf_counter() - t0


def run_cli(argv, timeout):
    return finish_cli(start_cli(argv), timeout)


def last_json(where, rc, out, err):
    if rc != 0:
        fail(f"{where}: exit code {rc}: {err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def phase_distributed(cfg, dev, sc, poses):
    """make_distributed_step in a world of one (NCCL over a TCP rendezvous
    on a free port) on the social main path's batch, N_TICKS ticks with the
    carry fed back, the launch counts set to 0 just before and read just
    after: command, aux and carry equal to make_step_batch's on the same
    inputs bit for bit, the metrics the local sums and mean. Then ms/tick of
    both, warm, host clock, in turns (plain, distributed, distributed,
    plain, twice): the difference is what the all_reduce and its sync cost.
    Returns (launch counts, the last carry)."""
    import torch.distributed as dist

    from nav2_social_mpc_controller_tpu_torch import _build
    from nav2_social_mpc_controller_tpu_torch.controller.controller import (
        make_carry, make_step_batch,
    )
    from nav2_social_mpc_controller_tpu_torch.core.types import tree_leaves
    from nav2_social_mpc_controller_tpu_torch.parallel import multihost
    from nav2_social_mpc_controller_tpu_torch.parallel.mesh import make_distributed_step
    from nav2_social_mpc_controller_tpu_torch.runtime.campaign import find_free_port

    batch = sc.robot.pose.shape[0]
    backend = multihost.initialize(f"localhost:{find_free_port()}", 1, 0, backend="nccl",
                                   device=dev, timeout_s=120)
    try:
        mesh = multihost.make_global_mesh(dev)
        dstep = make_distributed_step(cfg, mesh)
        step = make_step_batch(cfg, device=dev)

        def run_dist():
            carry, outs = make_carry(cfg, batch, device=dev), []
            for pose in poses:
                cmd, aux, carry, metrics = dstep(with_pose(sc, pose), carry)
                outs.append((cmd, aux, metrics))
            torch.cuda.synchronize()
            return outs, carry

        run_dist()  # warm: the NCCL communicator is made at the first all_reduce
        dstep.tick.reset_host_launches()
        _build.reset_launch_counts()
        outs_d, carry_d = run_dist()
        launches = dict(_build.launch_counts)
        check_launches("distributed", launches, DEFAULT_PATH_KERNELS, ticks=len(poses))
        host_ops = dict(dstep.tick.host_launches)
        if host_ops["graph_replays"] != len(poses):
            fail(f"distributed: the local step's host operations {host_ops} over {len(poses)} "
                 "ticks, not one graph launch a tick")
        loops = loop_record(dstep)
        check_one_sample_per_evaluation("distributed", launches)
        outs_u, carry_u = run_ticks(step, sc, poses, make_carry(cfg, batch, device=dev))
        for t, ((cmd_d, aux_d, m), (cmd_u, aux_u)) in enumerate(zip(outs_d, outs_u)):
            for a, b in zip(tree_leaves((cmd_d, aux_d)), tree_leaves((cmd_u, aux_u))):
                if not torch.equal(a, b):
                    fail(f"distributed tick {t}: an output differs from make_step_batch's")
            check_tick_outputs(f"distributed tick {t}", cfg, cmd_d, aux_d)
            want = {"n_scenarios": batch, "n_usable": int(aux_u.solve.usable.sum()),
                    "n_status_ok": int((aux_u.status == 0).sum()),
                    "total_iterations": int(aux_u.solve.iterations.sum())}
            seen = {k: int(getattr(m, k)) for k in want}
            if seen != want or not torch.equal(m.mean_final_cost, aux_u.solve.final_cost.mean()):
                fail(f"distributed tick {t}: metrics {seen} / {float(m.mean_final_cost)}, local "
                     f"{want} / {float(aux_u.solve.final_cost.mean())}")
        if not all(torch.equal(a, b) for a, b in zip(carry_d, carry_u)):
            fail("distributed: the carry differs from make_step_batch's")

        def per_tick_ms(run):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            return (time.perf_counter() - t0) * 1e3 / len(poses)

        ms = {"plain": [], "distributed": []}
        for _ in range(2):
            for kind in ("plain", "distributed", "distributed", "plain"):
                ms[kind].append(per_tick_ms(
                    run_dist if kind == "distributed"
                    else lambda: run_ticks(step, sc, poses, make_carry(cfg, batch, device=dev))))
    finally:
        dist.destroy_process_group()
    emit({"phase": "distributed", "config": "social", "batch": batch, "ticks": len(poses),
          "world_size": 1, "backend": backend, "bit_equal_to_make_step_batch": True,
          "metrics_last_tick": {k: float(getattr(outs_d[-1][2], k))
                                for k in outs_d[-1][2]._fields},
          "ms_per_tick": ms, "ms_per_tick_median": {k: float(np.median(v)) for k, v in ms.items()},
          "host_operations": host_ops, "host_launches_per_tick": (
              host_ops["graph_replays"] + host_ops["input_copies"] + host_ops["output_clones"])
          / len(poses),
          **loops, "launches": launches})
    return launches, carry_d


def phase_checkpoint(cfg, carry):
    """A carry on the card saved and restored is bit-equal; an .npz in the
    JAX package's layout (leaf_0..leaf_3, written here with NumPy) restores
    to the same tensors."""
    from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry
    from nav2_social_mpc_controller_tpu_torch.utils.checkpoint import restore_carry, save_carry

    like = make_carry(cfg, carry.prev_n.shape[0], device=carry.prev_n.device)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = save_carry(os.path.join(tmp, "carry"), carry)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = restore_carry(path, like)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        np.savez(os.path.join(tmp, "jax.npz"),
                 **{f"leaf_{i}": x.cpu().numpy() for i, x in enumerate(carry)})
        from_npz = restore_carry(os.path.join(tmp, "jax"), like)
        size = os.path.getsize(path)
    for what, got in (("restored", back), ("restored from .npz", from_npz)):
        for f, a, b in zip(carry._fields, got, carry):
            if a.device != b.device or a.dtype != b.dtype or not torch.equal(a, b):
                fail(f"checkpoint: {what} {f} is not the saved carry's")
    emit({"phase": "checkpoint", "batch": int(carry.prev_n.shape[0]), "bytes": size,
          "save_s": save_s, "restore_s": restore_s, "bit_equal": True, "npz_bit_equal": True})


def phase_campaign(cfg, dev):
    """The CLI's campaign in subprocesses on the card: 2 ranks (gloo, both
    on cuda:0) x B_MAIN / 2 scenarios for CAMPAIGN_TICKS ticks checkpointed
    every tick, then resumed for one tick more; the two ranks' final
    snapshots, concatenated in rank order, equal bit for bit one in-process
    run of the same B_MAIN scenarios (rank 0's seeds, then rank 1's) for
    CAMPAIGN_TICKS + 1 uninterrupted ticks with the same pose jitter."""
    from nav2_social_mpc_controller_tpu_torch.controller.controller import (
        make_carry, make_step_batch,
    )
    from nav2_social_mpc_controller_tpu_torch.core.types import scenario_from_numpy
    from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario_batch

    per_rank = B_MAIN // 2
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "carry")
        common = ["multihost", "--processes", "2", "--backend", "gloo", "--per-device-batch",
                  str(per_rank), "--checkpoint", base, "--timeout", "240"]
        for name, extra in (("first", ["--ticks", str(CAMPAIGN_TICKS), "--checkpoint-every", "1"]),
                            ("resumed", ["--ticks", str(CAMPAIGN_TICKS + 1), "--resume"])):
            rc, out, err, wall = run_cli(common + extra, timeout=300)
            s = last_json(f"campaign {name}", rc, out, err)
            runs[name] = {"wall_s": wall, **s}
        s1, s2 = runs["first"], runs["resumed"]
        want = {"global_batch": B_MAIN, "processes": 2, "devices": 2, "n_scenarios": B_MAIN,
                "platform": torch.device(dev).type, "backend": "gloo"}
        for name, s in runs.items():
            if any(s.get(k) != v for k, v in want.items()) or "n_usable" not in s \
                    or "n_status_ok" not in s:
                fail(f"campaign {name}: summary {s} is not {want} with n_usable, n_status_ok")
        if (s1["ticks"], s1["resumed_from_tick"]) != (CAMPAIGN_TICKS, 0) or \
                (s2["ticks"], s2["resumed_from_tick"]) != (1, CAMPAIGN_TICKS):
            fail(f"campaign: ticks / resumed_from_tick {s1['ticks']}/{s1['resumed_from_tick']}, "
                 f"{s2['ticks']}/{s2['resumed_from_tick']}")
        got = [torch.load(f"{base}.proc{r}.pt", weights_only=True) for r in range(2)]

    # One process, the same scenarios, uninterrupted.
    t0 = time.perf_counter()
    parts = [make_scenario_batch(cfg, per_rank, base_seed=s, n_valid_people=cfg.n_agents,
                                 grid_hw=(64, 64)) for s in (0, 100_000)]
    generate_s = time.perf_counter() - t0
    sc = scenario_from_numpy(type(parts[0])(*(
        type(a)(*(np.concatenate([x, y]) for x, y in zip(a, b)))
        for a, b in zip(*parts))), device=dev)
    step = make_step_batch(cfg, device=dev)
    carry = make_carry(cfg, B_MAIN, device=dev)
    for t in range(CAMPAIGN_TICKS + 1):
        eps = float(np.float32(1e-6 * t))
        _, _, carry = step(with_pose(sc, sc.robot.pose + eps), carry)
    torch.cuda.synchronize()
    for i, ref in enumerate(carry):
        if not torch.equal(torch.cat([got[0][f"leaf_{i}"], got[1][f"leaf_{i}"]]), ref.cpu()):
            fail(f"campaign: the resumed ranks' {carry._fields[i]} differs from one "
                 f"uninterrupted {B_MAIN}-scenario process")

    emit({"phase": "campaign", "config": "social", "per_rank_batch": per_rank,
          "runs": {k: {kk: v[kk] for kk in ("wall_s", "elapsed_s", "solves_per_s", "ticks",
                                             "resumed_from_tick", "n_scenarios", "n_usable",
                                             "n_status_ok", "mean_lm_iters", "generate_s")}
                   for k, v in runs.items()},
          "resumed_bit_equal_to_one_process": True, "reference_generate_s": generate_s})


def phase_dryrun(dev):
    """`dryrun --devices 2 --backend gloo` on the card: two ranks, one
    scenario each, bit-equal to one process's make_step_batch. Beside it,
    a campaign of two ranks on the one card with NCCL must fail (NCCL
    refuses two ranks on one card), not be switched to gloo."""
    dryrun = start_cli(["dryrun", "--devices", "2", "--backend", "gloo", "--timeout", "240"])
    nccl = start_cli(["multihost", "--processes", "2", "--backend", "nccl",
                      "--per-device-batch", "8", "--ticks", "1", "--timeout", "120"])
    rc, out, err, wall = finish_cli(dryrun, timeout=300)
    res = last_json("dryrun", rc, out, err)
    if res.get("dryrun") != "ok" or res.get("devices") != 2 or \
            res.get("platform") != torch.device(dev).type:
        fail(f"dryrun: {res}")
    rc, _, err, nccl_wall = finish_cli(nccl, timeout=180)
    if rc == 0:
        fail("multihost: NCCL with two ranks on one card ran (switched or shared?)")
    lines = err.splitlines()
    dup = [ln.strip() for ln in lines if "Duplicate GPU" in ln]
    emit({"phase": "dryrun", "seconds": wall, **res,
          "nccl_two_ranks_one_card": {"exit_code": rc, "seconds": nccl_wall,
                                      "duplicate_gpu_reported": bool(dup),
                                      "error": (dup[0] if dup else err.strip()[-300:])[:300]}})


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
        social = benchmark_social_config()
        phase_lm_sync_sweep([("obstacle", obstacle, 0), ("social", social, social.n_agents),
                             ("social debug", replace_optimizer(social, debug_optimizer=True),
                              social.n_agents)], dev)
        print(smi, flush=True)
        return 0
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}")
    phase_shapes(dev)
    phase_kernel_shapes(dev)
    launches_step_shapes = phase_step_shapes(dev)
    launches_bench = phase_bench(dev)
    social = benchmark_social_config()
    launches, sc, poses = phase_main_path("social", social, dev, B_MAIN, social.n_agents)
    launches_obstacle, sc_obstacle, poses_obstacle = phase_main_path(
        "obstacle", obstacle, dev, B_MAIN, 0)
    omni6 = benchmark_omni_6agents_config()
    _, sc_omni6, poses_omni6 = phase_main_path("omni6", omni6, dev, B_WIDE, omni6.n_agents,
                                               n_ticks=1, compare_cpu=False)
    stress36 = benchmark_stress_h36_config()
    _, sc36, poses36 = phase_main_path("stress36", stress36, dev, B_WIDE, stress36.n_agents,
                                       n_ticks=1, compare_cpu=False)
    phase_graph([("social", social, social.n_agents, sc, poses),
                 ("obstacle", obstacle, 0, sc_obstacle, poses_obstacle),
                 ("omni6", omni6, omni6.n_agents, sc_omni6, poses_omni6),
                 ("stress36", stress36, stress36.n_agents, sc36, poses36)], dev)
    del sc_obstacle, sc_omni6
    launches_debug = phase_debug_tick("social", social, dev, sc, poses)
    phase_debug_tick("stress36", stress36, dev, sc36, poses36)
    launches_jacobi = phase_jacobi("social", social, dev, sc, poses[0])
    phase_jacobi("stress36", stress36, dev, sc36, poses36[0])
    sc_lat, poses_lat = make_batch(social, B_WIDE, dev, n_valid_people=social.n_agents)
    phase_latent_evaluation(social, dev, sc_lat, poses_lat[0])
    launches_latent = phase_latent_tick(
        [("social", latent_config(social), sc_lat, poses_lat),
         ("stress36", latent_config(stress36), sc36, poses36)], dev)
    launches_latent_debug = phase_debug_tick("social latent", latent_config(social), dev,
                                             sc_lat, poses_lat)
    del sc_lat
    launches_compacted = phase_compacted_tick(
        [("social", social, sc, poses), ("stress36", stress36, sc36, poses36)], dev)
    launches_latent_compacted = phase_compacted_tick(
        [("social latent", latent_config(social), sc, poses)], dev)
    phase_timing([("obstacle", obstacle, 0), ("social", social, social.n_agents)], dev)
    launches_single = phase_single_step(
        [("social", social, social.n_agents), ("obstacle", obstacle, 0),
         ("omni6", omni6, omni6.n_agents), ("stress36", stress36, stress36.n_agents),
         ("social latent", latent_config(social), social.n_agents),
         ("social debug", replace_optimizer(social, debug_optimizer=True), social.n_agents)],
        dev)
    launches_controller = phase_controller(social, dev)
    sc_native = phase_native(social, dev)
    launches_sim = phase_sim(social, dev, sc_native)
    del sc_native
    launches_stream = phase_stream(social, dev)
    phase_cli()
    launches_distributed, carry_distributed = phase_distributed(social, dev, sc, poses)
    phase_checkpoint(social, carry_distributed)
    del carry_distributed
    phase_campaign(social, dev)
    phase_dryrun(dev)

    # Every kernel at the social main path's shapes, inputs captured from a
    # real tick. `launches` is the count on the kernel's own paths: three
    # social ticks, three debug ticks and the Jacobi-scaled solve for K7; the
    # standalone K6 and K1 run on no path (an evaluation runs both inside
    # rollout_sample, which is held to them; K1 serves the reference
    # evaluation, the residual path, alone).
    cap = capture_iteration(social, with_pose(sc, poses[0]), make_carry(social, B_MAIN, device=dev))
    res = check_all_kernels(social, cap, reps=200)
    del cap
    res.update(check_general_kernels(dev, reps=200))
    by_path = {"social": launches, "obstacle": launches_obstacle, "debug": launches_debug,
               "jacobi": launches_jacobi, "latent": launches_latent,
               "latent_debug": launches_latent_debug,
               "latent_compacted": launches_latent_compacted,
               "compacted": launches_compacted, "single_step": launches_single,
               "controller": launches_controller, "sim": launches_sim,
               "stream": launches_stream, "distributed": launches_distributed,
               **launches_step_shapes, "bench": launches_bench}
    own_path = {k: "social" for k in res} | {"spd_solve": "debug, jacobi", "bicubic": None,
                                             "rollout_prep": None,
                                             "compact_continue": "compacted"}
    own_path |= {k: "step_shapes, step_shapes_compacted" for k in res if k.endswith("_general")}
    own_path |= {"rollout_prep_general": None, "spd_solve_general": "step_shapes_debug",
                 "sfm_scan_general": "step_shapes, step_shapes_debug, step_shapes_compacted"}
    from nav2_social_mpc_controller_tpu_torch import kernel_shapes

    def span(values):
        return f"{values[0]}..{values[-1]}"

    nb, d = f"NB {span(kernel_shapes.BLOCKS)}", f"even D {span(kernel_shapes.SOLVE_DIMS)}"
    nb_g = f"NB 1..{kernel_shapes.GENERAL_MAX_BLOCKS} at run time (taken past {span(kernel_shapes.BLOCKS)})"
    d_g = (f"even D 2..{2 * kernel_shapes.GENERAL_MAX_BLOCKS} at run time (taken past "
           f"{span(kernel_shapes.SOLVE_DIMS)})")
    instantiated = {"sfm_scan": f"N 1..{kernel_shapes.MAX_TEMPLATED_AGENTS}",
                    "sfm_scan_general": f"N 1..{kernel_shapes.GENERAL_MAX_AGENTS} at run time "
                                        f"(taken past 1..{kernel_shapes.MAX_TEMPLATED_AGENTS})",
                    "rollout_prep": nb,
                    "rollout_sample": nb, "fused_iter": nb, "propose": d, "commit": d,
                    "spd_solve": f"damped step {d}, standalone D "
                                 f"{span(kernel_shapes.SPD_SOLVE_DIMS)}",
                    "rollout_prep_general": nb_g, "rollout_sample_general": nb_g,
                    "fused_iter_general": nb_g, "propose_general": d_g, "commit_general": d_g,
                    "spd_solve_general": f"damped step {d_g}, standalone D "
                                         f"1..{kernel_shapes.GENERAL_MAX_DIM} at run time"}
    emit({"kernels": [
        {"name": k, **KERNEL_INFO[k], "path": own_path[k],
         "instantiated_for": instantiated.get(k, "any shape"),
         "launches": sum(by_path[p][k] for p in own_path[k].split(", ")) if own_path[k] else 0,
         "launches_by_path": {p: n[k] for p, n in by_path.items()}, **v}
        for k, v in res.items()
    ], "launch_floor_ms": launch_floor_ms(200)})
    pads = {str(k): PROFILE_PADS_SEEN.count(k) for k in sorted(set(PROFILE_PADS_SEEN))}
    emit({"phase": "total", "seconds": time.perf_counter() - t_start,
          "profiles": len(PROFILE_PADS_SEEN), "profiles_by_spin_kernels_seen": pads})
    print(smi, flush=True)
    emit({"ok": True, "device": dev_info})
    return 0


if __name__ == "__main__":
    sys.exit(main())
