"""The port's CUDA kernels against their plain PyTorch versions ON THE
CARD, at small shapes chosen for their corner cases (border-clamped and NaN
coordinates, masked steps and shrunk horizons, scenarios with and without
valid people, an agent exactly on the robot, a system that is not positive
definite, frozen done lanes, every termination code, views 4 bytes into
their storage).

These tests need an NVIDIA GPU and nvcc and skip where there is none. They
import only torch, NumPy and the port, so on a machine with a card they run
without the JAX package's test harness:

    python -m pytest tests/test_torch_gpu_kernels.py -q --noconftest -p no:cacheprovider

Tolerances: nvcc contracts a*b+c into FMA in K1/K2 and K2 reduces across a
warp in another order than the plain version, so those agree to float32
rounding of their sums (1e-5 / 1e-4, scale-normalised; with the people
stages' exp/atan2 chains 3e-5, the JAX package's figure for its fused
kernel); K6 sums by warp scans, in another order, and is held to the JAX
package's figures for its rollout kernel (rtol 2e-5, atol 1e-5; 2e-4 on
row/col, which reach 64 cells), its copied controls exact; K3/K4 are written
with round-to-nearest intrinsics and repeat the plain version operation for
operation, and K7 (the damped step, which compiles K3's bodies with and
without Jacobi scaling, and the standalone solve) and the plain versions keep
chol.cuh's order of every sum, so K3, K4 and K7 are held to equality of bits
(NaN in the same places).
K5 (the SFM scan) carries float32 rounding through every step of the
pedestrian dynamics: 1e-4 scale-normalised, its validity column exact; its
branch form of the angle wrap equals the fmodf form bit for bit over every
float32. Its general form (past 32 agents) is held to the same figures at
N = 33..128, on crowds of the scenario generator's density to 64 agents and
spread to one person every two square metres above (the generator packs
everyone into 2.5 m x 3 m); at its limit, on the scenarios whose plain
version another order of its social sums moves by at most 1e-5: in the
others the forces cancel or a branch turns on the last bits, and any two
float32 computations part. The rollout-sample kernel compiles K6's and K1's arithmetic from
their shared headers and is held to equal bits with K6 then K1.
"""

import ctypes
import dataclasses
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from nav2_social_mpc_controller_tpu_torch import _build, kernel_shapes
from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry, step_pre
from nav2_social_mpc_controller_tpu_torch.controller.optimize import ProblemDims, make_lm_config
from nav2_social_mpc_controller_tpu_torch.core import config as C
from nav2_social_mpc_controller_tpu_torch.core.types import scenario_from_numpy
from nav2_social_mpc_controller_tpu_torch.models import sfm as K5
from nav2_social_mpc_controller_tpu_torch.ops import bicubic_cuda as K1
from nav2_social_mpc_controller_tpu_torch.ops import fused_iter as K2
from nav2_social_mpc_controller_tpu_torch.ops import rollout_cuda as K6
from nav2_social_mpc_controller_tpu_torch.solver import cuda_iter as K34
from nav2_social_mpc_controller_tpu_torch.solver import cuda_solve as K7
from nav2_social_mpc_controller_tpu_torch.solver import lm
from nav2_social_mpc_controller_tpu_torch.utils.scenarios import make_scenario_batch

pytestmark = pytest.mark.gpu

LM_CFG = lm.LMConfig(max_iterations=40, fn_tol=1e-5, gradient_tol=1e-8, param_tol=1e-9)


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when a test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    if shutil.which("nvcc") is None:
        _build.find_nvcc()  # raises with the reason when there is no toolkit
    return torch.device("cuda")


def _norm_err(got, ref):
    got = got.double().reshape(got.shape[0], -1)
    ref = ref.double().reshape(ref.shape[0], -1)
    assert torch.equal(torch.isfinite(got), torch.isfinite(ref))
    fin = torch.isfinite(ref)
    diff = torch.where(fin, (got - ref).abs(), torch.zeros_like(ref))
    scale = torch.where(fin, ref.abs(), torch.zeros_like(ref)).max(dim=1).values.clamp(min=1.0)
    return float((diff.max(dim=1).values / scale).max())


@pytest.mark.parametrize("s", [29, 70])
def test_bicubic_kernel_matches_plain(card, s):
    rng = np.random.default_rng(s)
    b, h, w = 5, 64, 48
    win = torch.tensor(np.rint(rng.uniform(0, 254, (b, h, w))).astype(np.float32), device=card)
    row = rng.uniform(-4.0, h + 3.0, (b, s)).astype(np.float32)  # straddles every border
    col = rng.uniform(-4.0, w + 3.0, (b, s)).astype(np.float32)
    row[0, 0], col[0, 1] = 1e9, -1e9  # far outside: clamps to the border cell
    row[1, 0] = np.nan  # NaN in, NaN out
    row, col = torch.tensor(row, device=card), torch.tensor(col, device=card)
    before = _build.launch_counts["bicubic"]
    got = K1.bicubic_linearize(win, row, col)
    torch.cuda.synchronize()
    assert _build.launch_counts["bicubic"] == before + 1
    for g, r in zip(got, K1.bicubic_linearize_plain(win, row, col)):
        assert _norm_err(g, r) <= 1e-5
    assert torch.isnan(got[0][1, 0]) and torch.isfinite(got[0][0]).all()


@pytest.mark.parametrize(
    "name,n_valid,esdf_ok",
    [("benchmark_social_config", 3, True), ("benchmark_omni_6agents_config", 5, True),
     ("benchmark_stress_h36_config", 2, True), ("benchmark_obstacle_only_config", 0, True),
     ("benchmark_social_config", 3, False)],
)
def test_sfm_scan_kernel_matches_plain(card, name, n_valid, esdf_ok):
    """Valid and padded agents, robots near their goal (scan tail beyond the
    rows), a people-free batch and an invalid ESDF; batch 37 leaves the last
    block partly empty."""
    cfg = getattr(C, name)()
    batch = 37
    sc_np = make_scenario_batch(cfg, batch, base_seed=0, n_valid_people=n_valid)
    pose = np.array(sc_np.robot.pose)
    for k in range(1, batch, 3):
        i = int(sc_np.path.n[k]) - 2 - k % 7
        pose[k] = [*sc_np.path.points[k, i], sc_np.path.yaw[k, i]]
    sc = scenario_from_numpy(sc_np._replace(robot=sc_np.robot._replace(pose=pose)), device=card)
    prep = step_pre(cfg, sc, make_carry(cfg, batch, device=card)).prep
    valid = sc.esdf.valid if esdf_ok else torch.zeros_like(sc.esdf.valid)
    args = (sc.people.state, prep.rows, prep.n_rows, sc.esdf.indexes, sc.esdf.origin,
            sc.esdf.resolution, valid)
    kw = dict(maxtime=cfg.trajectorizer.max_time, dt=cfg.trajectorizer.time_step,
              people_desired_vel=cfg.people_desired_vel, people_radius=cfg.people_radius,
              goal_radius=cfg.goal_radius)
    for window in (cfg.esdf_window_cells, 0):
        before = _build.launch_counts["sfm_scan"]
        got = K5.project_people(*args, esdf_window=window, **kw)
        torch.cuda.synchronize()
        assert _build.launch_counts["sfm_scan"] == before + 1
        ref = K5.project_people_plain(*args, esdf_window=window, **kw)
        assert torch.equal(got[..., 3], ref[..., 3])
        assert torch.equal(got[:, 0], sc.people.state)
        assert _norm_err(got, ref) <= 1e-4
        projected = bool((got[:, 1:, :, 3] != -1.0).any())
        assert projected == (n_valid > 0 and esdf_ok)
    assert int(prep.n_rows.min()) < prep.rows.shape[1] - 1


def _sfm_case(cfg, card, batch, n_valid):
    """The SFM scan's arguments and keywords for `batch` scenarios with
    `n_valid` valid people each, every third robot near its goal."""
    sc_np = make_scenario_batch(cfg, batch, base_seed=0, n_valid_people=n_valid)
    pose = np.array(sc_np.robot.pose)
    for k in range(1, batch, 3):
        i = int(sc_np.path.n[k]) - 2 - k % 7
        pose[k] = [*sc_np.path.points[k, i], sc_np.path.yaw[k, i]]
    sc = scenario_from_numpy(sc_np._replace(robot=sc_np.robot._replace(pose=pose)), device=card)
    prep = step_pre(cfg, sc, make_carry(cfg, batch, device=card)).prep
    args = (sc.people.state, prep.rows, prep.n_rows, sc.esdf.indexes, sc.esdf.origin,
            sc.esdf.resolution, sc.esdf.valid)
    kw = dict(maxtime=cfg.trajectorizer.max_time, dt=cfg.trajectorizer.time_step,
              people_desired_vel=cfg.people_desired_vel, people_radius=cfg.people_radius,
              goal_radius=cfg.goal_radius, esdf_window=cfg.esdf_window_cells)
    return args, kw


@pytest.mark.parametrize("name", ["benchmark_social_config", "benchmark_omni_6agents_config",
                                  "benchmark_stress_h36_config"])
def test_sfm_scan_kernel_ignores_batch_position(card, name):
    """At the three people shapes with every person valid: a scenario's rows
    do not depend on its warp or its slot in the warp (a rolled batch of 41
    gives the rolled rows, bit for bit), and the kernel agrees with the plain
    version, its t column exactly."""
    cfg = getattr(C, name)()
    args, kw = _sfm_case(cfg, card, 41, cfg.n_agents)
    got = K5.project_people(*args, **kw)
    perm = torch.roll(torch.arange(41, device=card), 5)
    moved = K5.project_people(*(a.index_select(0, perm).contiguous() for a in args), **kw)
    torch.cuda.synchronize()
    assert _same_bits(moved, got[perm])
    ref = K5.project_people_plain(*args, **kw)
    assert torch.equal(got[..., 3], ref[..., 3])
    assert _norm_err(got, ref) <= 1e-4
    assert bool((got[:, 1:, :, 3] != -1.0).any())


def test_sfm_scan_refuses_more_agents_than_it_is_built_for(card):
    cfg = C.benchmark_social_config()
    args, kw = _sfm_case(cfg, card, 4, 3)
    limit = kernel_shapes.GENERAL_MAX_AGENTS  # what one block's shared memory holds
    many = args[0].repeat(1, -(-(limit + 1) // 3), 1)[:, :limit + 1].contiguous()
    with pytest.raises(ValueError, match=f"1 to {limit} agents"):
        K5.project_people(many, *args[1:], **kw)


@pytest.mark.parametrize("n", [9, 12, 16, 17, 24, 32])
def test_sfm_scan_kernel_at_more_agents(card, n):
    """N agents past the benchmark configs' 3 and 6, every one valid, every
    third robot near its goal, batch 41: a force lane for each 3..8
    sources (N <= 16) or one lane an agent taking all of them (N > 16); the
    plain version within 1e-4, its t column exactly; a scenario moved to
    another block gives the same bits."""
    cfg = dataclasses.replace(C.benchmark_social_config(), n_agents=n)
    args, kw = _sfm_case(cfg, card, 41, n)
    got = K5.project_people(*args, **kw)
    perm = torch.roll(torch.arange(41, device=card), 5)
    moved = K5.project_people(*(a.index_select(0, perm).contiguous() for a in args), **kw)
    torch.cuda.synchronize()
    assert _same_bits(moved, got[perm])
    ref = K5.project_people_plain(*args, **kw)
    assert torch.equal(got[..., 3], ref[..., 3])
    assert _norm_err(got, ref) <= 1e-4
    assert bool((got[:, 1:, :, 3] != -1.0).any())


def _crowd_case(card, n, batch):
    """K5's arguments for `batch` scenarios of the social config with N
    agents, every one valid, every third robot near its goal (_sfm_case);
    past 64 agents the crowd spread about the generator's near edge to one
    person every two square metres (the generator puts everyone in
    2.5 m x 3 m)."""
    args, kw = _sfm_case(dataclasses.replace(C.benchmark_social_config(), n_agents=n), card,
                         batch, n)
    if n > 64:
        k = (n / (7.5 * 0.5)) ** 0.5
        people = args[0].clone()
        valid = people[..., 3] != -1.0
        people[..., 0] = torch.where(valid, 0.5 + (people[..., 0] - 0.5) * k, people[..., 0])
        people[..., 1] = torch.where(valid, people[..., 1] * k, people[..., 1])
        args = (people.contiguous(),) + args[1:]
    return args, kw


def _general_sfm(card, args, kw):
    """K5 through its general form (kernel_shapes.form past N = 32), one
    launch of it counted."""
    before = _build.launch_counts["sfm_scan_general"]
    got = K5.project_people(*args, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts["sfm_scan_general"] == before + 1
    return got


@pytest.mark.parametrize("n", [33, 48, 64, 128])
def test_sfm_scan_general_form_matches_plain(card, n):
    """Past 32 agents K5 runs its general form (N at run time, a few warps
    a scenario), every agent valid, every third robot near its goal, batch 41
    (_crowd_case): the plain version within 1e-4, its t column exactly; a
    scenario moved to another block gives the same bits."""
    args, kw = _crowd_case(card, n, 41)
    assert isinstance(K5.scan_geometry(n, 41), K5.GeneralScanGeometry)
    got = _general_sfm(card, args, kw)
    perm = torch.roll(torch.arange(41, device=card), 5)
    moved = K5.project_people(*(a.index_select(0, perm).contiguous() for a in args), **kw)
    torch.cuda.synchronize()
    assert _same_bits(moved, got[perm])
    ref = K5.project_people_plain(*args, **kw)
    assert torch.equal(got[..., 3], ref[..., 3])
    assert torch.equal(got[:, 0], args[0])
    assert _norm_err(got, ref) <= 1e-4
    assert bool((got[:, 1:, :, 3] != -1.0).any())


@pytest.mark.parametrize("n", [33, 64, 128])
def test_sfm_scan_general_form_bits_do_not_depend_on_the_block(card, n, monkeypatch):
    """K5's general form at a batch of 41 (odd: where a block holds two
    scenarios the last holds one): a scenario rolled by 1 .. 4 places (into
    another slot of another block) gives the same bits, and so does every
    count of threads a scenario (one warp to the whole block; the wrapper's
    choice is general_threads_per_scenario)."""
    args, kw = _crowd_case(card, n, 41)
    got = _general_sfm(card, args, kw)
    for shift in range(1, 5):
        perm = torch.roll(torch.arange(41, device=card), shift)
        moved = K5.project_people(*(a.index_select(0, perm).contiguous() for a in args), **kw)
        torch.cuda.synchronize()
        assert _same_bits(moved, got[perm]), shift
    for threads in (32, 64, 128, 256):
        monkeypatch.setattr(K5, "general_threads_per_scenario", lambda _n, t=threads: t)
        assert K5.scan_geometry(n, 41).threads_per_scenario == threads
        assert _same_bits(_general_sfm(card, args, kw), got), threads
    monkeypatch.undo()


def _order_insensitive(args, kw, ref, monkeypatch):
    """(B,) bool: the scenarios whose plain version (`ref`) moves by at most
    1e-5 when each agent's social forces are added by torch's reduction or
    in the reversed order, not in the list's order."""
    serial = K5.sum_in_list_order
    calm = torch.ones(ref.shape[0], dtype=torch.bool, device=ref.device)
    for fn in (lambda f: f.sum(dim=2), lambda f: serial(f.flip(2))):
        monkeypatch.setattr(K5, "sum_in_list_order", fn)
        other = K5.project_people_plain(*args, **kw)
        monkeypatch.undo()
        calm &= torch.tensor([_norm_err(o[None], r[None]) <= 1e-5 for o, r in zip(other, ref)],
                             device=ref.device)
    return calm


def test_sfm_scan_general_form_at_its_limit(card, monkeypatch):
    """At the most agents one block's shared memory holds (past 48 KB: the
    launch opts in) the general form agrees with the plain version within
    1e-4 on the scenarios insensitive to the order of their sums (at least
    half of 4), its t column exactly on all."""
    n = kernel_shapes.GENERAL_MAX_AGENTS
    args, kw = _crowd_case(card, n, 4)
    assert K5.scan_shared_bytes(K5.scan_geometry(n, 4), n, args[1].shape[1]) > 48 * 1024
    got = _general_sfm(card, args, kw)
    ref = K5.project_people_plain(*args, **kw)
    assert torch.equal(got[..., 3], ref[..., 3])
    calm = _order_insensitive(args, kw, ref, monkeypatch)
    assert int(calm.sum()) >= 2
    assert _norm_err(got[calm], ref[calm]) <= 1e-4


@pytest.mark.parametrize("n", [24, 32])
def test_sfm_scan_general_form_agrees_with_the_templated_form(card, n, monkeypatch):
    """At a templated N the general form (kernel_shapes.SFM_SHAPES emptied
    for the call) adds each agent's forces in the templated form's order:
    both agree with the plain version and with each other within 1e-4, the
    t column exactly."""
    args, kw = _crowd_case(card, n, 41)
    tmpl = K5.project_people(*args, **kw)
    monkeypatch.setattr(kernel_shapes, "SFM_SHAPES", ())
    got = _general_sfm(card, args, kw)
    monkeypatch.undo()
    ref = K5.project_people_plain(*args, **kw)
    assert torch.equal(got[..., 3], tmpl[..., 3]) and torch.equal(got[..., 3], ref[..., 3])
    assert _norm_err(got, tmpl) <= 1e-4 and _norm_err(got, ref) <= 1e-4


def test_sfm_scan_kernel_past_48_kb_of_shared_memory(card):
    """One agent over 99 steps: 32 scenarios a block stage the robot's 99
    steps each, (64 + 32 * 99) float4s, more than the 48 KB a launch takes
    without the kernel's opt-in; the plain version within 1e-4."""
    base = C.benchmark_social_config()
    tr = dataclasses.replace(base.trajectorizer, max_time=100 * base.trajectorizer.time_step)
    cfg = dataclasses.replace(base, n_agents=1, trajectorizer=tr, esdf_window_cells=0,
                              optimizer=dataclasses.replace(base.optimizer,
                                                            obstacle_window_cells=0))
    args, kw = _sfm_case(cfg, card, 67, 1)
    s1 = args[1].shape[1]
    assert K5.scan_shared_bytes(K5.scan_geometry(1, 67), 1, s1) > 48 * 1024
    got = K5.project_people(*args, **kw)
    ref = K5.project_people_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[..., 3], ref[..., 3])
    assert _norm_err(got, ref) <= 1e-4


WRAP_PROBE = r"""
#include "sfm_scan.cu"

__device__ __forceinline__ bool same(float a, float b) {
    return __float_as_uint(a) == __float_as_uint(b) || (a != a && b != b);
}

// Every float32 bit pattern from `start` on, `count` of them: the branch
// form against fmodf's, for the remainder and for the wrap built on it.
__global__ void wrap_sweep(unsigned long long start, unsigned long long count,
                           unsigned long long* differ) {
    unsigned long long n = 0;
    const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
    for (unsigned long long k = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
         k < count; k += stride) {
        const float x = __uint_as_float((unsigned)(start + k));
        n += !same(remainder_two_pi(x), remainder_pos(x, kTwoPi));
        n += !same(wrap_to_pi(x), -(remainder_pos(-x + kPi, kTwoPi) - kPi));
    }
    atomicAdd(differ, n);
}

extern "C" int wrap_sweep_launch(unsigned long long start, unsigned long long count,
                                 unsigned long long* differ) {
    wrap_sweep<<<132 * 16, 256>>>(start, count, differ);
    return (int)cudaGetLastError();
}
"""


def test_wrap_to_pi_branch_form_equals_fmodf_over_every_float(card, tmp_path):
    """K5's angle wrap without fmodf gives fmodf's bits for every float32
    (2^32 patterns, NaN against NaN counted equal), so on (-4 pi, 4 pi), where
    it takes its branches, and beyond, where it calls fmodf."""
    src, so = tmp_path / "wrap_probe.cu", tmp_path / "wrap_probe.so"
    src.write_text(WRAP_PROBE)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
                    "-I", _build.write_shapes_header(str(tmp_path)), "-shared",
                    "-o", str(so), str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(so)).wrap_sweep_launch
    fn.argtypes = [ctypes.c_ulonglong, ctypes.c_ulonglong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    differ = torch.zeros(1, dtype=torch.int64, device=card)
    assert fn(0, 1 << 32, differ.data_ptr()) == 0
    torch.cuda.synchronize()
    assert int(differ) == 0


def _problem(cfg, card, batch=8, n_iters=2, n_valid_people=0):
    """A real tick's problem on the card, advanced a few LM iterations; every
    second robot starts 2-5 poses before its goal, which shrinks h_dyn /
    bl_dyn and masks the trailing steps."""
    sc_np = make_scenario_batch(cfg, batch, base_seed=0, n_valid_people=n_valid_people)
    pose = np.array(sc_np.robot.pose)
    for k in range(1, batch, 2):
        i = int(sc_np.path.n[k]) - 2 - (k // 2) % 4
        pose[k] = [*sc_np.path.points[k, i], sc_np.path.yaw[k, i]]
    sc = scenario_from_numpy(sc_np._replace(robot=sc_np.robot._replace(pose=pose)), device=card)
    dims = ProblemDims.from_config(cfg)
    prep = step_pre(cfg, sc, make_carry(cfg, batch, device=card)).prep
    vg = K2.build_value_grad(
        cfg, dims, prep.rows, prep.n_rows, prep.people_proj, prep.people_present, prep.costmap)
    cost, g, jtj = vg(prep.u0)
    st = lm.LMState(
        u=prep.u0, cost=cost, g=g, jtj=jtj,
        radius=torch.full((batch,), LM_CFG.initial_radius, device=card),
        decrease_factor=torch.full((batch,), 2.0, device=card),
        iters=torch.zeros((batch,), dtype=torch.int32, device=card),
        done=~torch.isfinite(cost),
        term=torch.zeros((batch,), dtype=torch.int32, device=card),
        failed=~torch.isfinite(cost),
    )
    lm_cfg = make_lm_config(cfg.optimizer)
    for _ in range(n_iters):
        st = lm.lm_iteration(vg, prep.lower, prep.upper, lm_cfg, st)
    return prep, vg, st, lm_cfg


@pytest.mark.parametrize("name", ["benchmark_obstacle_only_config", "benchmark_stress_h36_config"])
def test_fused_kernel_matches_plain(card, name):
    cfg = getattr(C, name)()
    prep, vg, st, _ = _problem(cfg, card)
    args = vg.fused_inputs(st.u)
    assert not bool(vg.m_step.all()), "some steps must be masked (near-goal plans)"
    assert not bool(vg.m_social.any())
    before = _build.launch_counts["fused_iter"]
    got = K2.fused_cost_g_jtj(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts["fused_iter"] == before + 1
    for g, r in zip(got, K2.fused_cost_g_jtj_plain(*args)):
        assert _norm_err(g, r) <= 1e-4
    assert torch.equal(got[2], got[2].transpose(1, 2)), "JtJ is written in both triangles"


@pytest.mark.parametrize("people", [False, True], ids=["people_free", "people"])
@pytest.mark.parametrize("nb", [1, 2, 3, 4, 5, 6])
def test_fused_kernel_at_every_block_count(card, nb, people):
    """K2 at NB = 1..6 (the social config in blocks of 4, horizon 4 NB; at
    NB = 1 no velocity-feasibility row and a zero-width vfm, which the
    kernel never reads), with and without its people stages: the plain
    version within 3e-5 (people) or 1e-4, JtJ symmetric."""
    base = C.benchmark_social_config()
    cfg = dataclasses.replace(base, optimizer=dataclasses.replace(
        base.optimizer, control_horizon=4 * nb, parameter_block_length=4))
    prep, vg, st, _ = _problem(cfg, card, batch=24, n_valid_people=3 if people else 0)
    args = vg.fused_inputs(st.u)
    assert args[10].shape[1] == nb and args[24].shape == (24, nb - 1)
    got = K2.fused_cost_g_jtj(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, K2.fused_cost_g_jtj_plain(*args)):
        assert _norm_err(g, r) <= (3e-5 if people else 1e-4)
    assert torch.equal(got[2], got[2].transpose(1, 2))
    assert bool(vg.m_social.any()) == people
    past = kernel_shapes.GENERAL_MAX_BLOCKS + 1
    with pytest.raises(ValueError, match=f"NB from 1 to {past - 1}"):
        bad = list(args)
        bad[10] = args[10].repeat(1, past, 1)[:, :past].contiguous()
        K2.fused_cost_g_jtj(*bad)


@pytest.mark.parametrize("name,tile", [
    ("benchmark_social_config", 1), ("benchmark_omni_6agents_config", 1),
    ("benchmark_stress_h36_config", 1), ("benchmark_stress_h36_config", 7)])
def test_fused_kernel_with_people_matches_plain(card, name, tile):
    """The three people stages: a batch in which the FOV filter leaves some
    scenarios without a person (their stages must not run), padded agent
    slots, near-goal plans, one scenario with an agent exactly on the
    rolled-out robot (the `tiny` branch of the social force), and a first
    block of scenarios with none, some and all of a scenario's live steps
    social. At S = 39 (stress horizon) a lane holds two steps; the agents
    are also tiled to N = 21, a long loop over agents. A scenario moved to
    another block and slot gives the same bits."""
    cfg = getattr(C, name)()
    prep, vg, st, _ = _problem(cfg, card, batch=24, n_valid_people=cfg.n_agents - 1)
    args = list(vg.fused_inputs(st.u))
    if tile > 1:
        args[0] = args[0]._replace(n_agents=cfg.n_agents * tile)
        args[15] = args[15].repeat(1, 1, tile, 1)
    m_step, s = args[16], args[16].shape[1]
    m_social = args[18].clone()
    m_social[0] = False
    m_social[2] = m_step[2]
    m_social[3] = m_step[3] & (torch.arange(s, device=card) % 2 == 0)
    args[18], args[19] = m_social, args[19] & m_social
    assert int(m_social[2].sum()) == s - 1, "every live step of scenario 2 is social"
    assert bool(m_social[3].any()) and bool((m_social[3] != m_step[3]).any())
    present = m_social.any(dim=1)
    assert bool(present.any()) and not bool(present.all())
    k = int(torch.nonzero(present[4:])[0]) + 4
    agents = args[15].clone()  # (B, S, N, 6)
    agents[k, 3, 0, 0], agents[k, 3, 0, 1] = args[2][k, 3], args[3][k, 3]
    agents[k, 3, 0, 3] = 0.0
    args[15] = agents
    got = K2.fused_cost_g_jtj(*args)
    torch.cuda.synchronize()
    ref = K2.fused_cost_g_jtj_plain(*args)
    for g, r in zip(got, ref):
        assert torch.isfinite(r).all()
        assert _norm_err(g, r) <= 3e-5
    perm = torch.roll(torch.arange(len(present), device=card), 5)
    moved = [a.index_select(0, perm) if torch.is_tensor(a) else a for a in args]
    for g, g_moved in zip(got, K2.fused_cost_g_jtj(*moved)):
        assert torch.equal(g_moved, g[perm])
    # the people stages are really on: switching them off changes the cost
    off = list(args)
    off[18], off[19] = torch.zeros_like(args[18]), torch.zeros_like(args[19])
    cost_off = K2.fused_cost_g_jtj(*off)[0]
    assert bool((cost_off[present] < got[0][present]).any())
    assert torch.equal(cost_off[~present], got[0][~present])
    # and the view of the scan's output is taken as it is (no copy)
    assert vg.agents.data_ptr() == prep.people_proj[:, 1:].data_ptr()
    got_view = K2.fused_cost_g_jtj(*vg.fused_inputs(st.u))
    ref_view = K2.fused_cost_g_jtj_plain(*vg.fused_inputs(st.u))
    for g, r in zip(got_view, ref_view):
        assert _norm_err(g, r) <= 3e-5


@pytest.mark.parametrize("nb,s", [(3, 29), (3, 32), (3, 39), (6, 39), (1, 59), (2, 29), (4, 39),
                                  (5, 70)])
def test_rollout_prep_kernel_matches_plain(card, nb, s):
    """K6 against its plain version with a different block map in every
    scenario (h_dyn / bl_dyn shrink near the goal) and one whose first block
    has no step; batch 45 leaves the last block partly empty. S = 32 fills a
    warp's lanes exactly; S = 39 carries the sums into a second chunk. A
    scenario moved to another block and slot gives the same bits."""
    from nav2_social_mpc_controller_tpu_torch.models.motion import block_index_sequence_dynamic

    rng = np.random.default_rng(nb * 100 + s)
    b = 45
    h_dyn = rng.integers(1, 6 * nb + 1, b)
    h_dyn[0] = 6 * nb
    bl_dyn = np.minimum(6, h_dyn)
    block_idx = block_index_sequence_dynamic(
        s, torch.tensor(h_dyn, device=card), torch.tensor(bl_dyn, device=card)).to(torch.int32)
    if nb > 1:
        block_idx[1] = block_idx[1].clamp(min=1)
        assert not bool((block_idx[1] == 0).any())
    assert len({tuple(r) for r in block_idx.tolist()}) >= (3 if nb > 1 else 1)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=card)

    u = t(rng.uniform(-0.8, 0.8, (b, 2 * nb)))
    pose0 = t(np.concatenate([rng.uniform(-5, 5, (b, 2)), rng.uniform(-np.pi, np.pi, (b, 1))], 1))
    origin = t(rng.uniform(-10, 0, (b, 2)))
    res = t(np.full((b,), 0.05))
    args = (u, pose0, block_idx.contiguous(), origin, res, 0.05, 0.25, nb)
    before = _build.launch_counts["rollout_prep"]
    got = K6.rollout_prep(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts["rollout_prep"] == before + 1
    ref = K6.rollout_prep_plain(*args)
    assert set(got) == set(ref)
    assert torch.equal(got["v"], ref["v"]), "the expanded control is a copy"
    for name in ref:
        atol = 2e-4 if name in ("row", "col") else 1e-5
        torch.testing.assert_close(got[name], ref[name], rtol=2e-5, atol=atol, msg=name)
    perm = torch.roll(torch.arange(b, device=card), 7)
    moved = K6.rollout_prep(*(a.index_select(0, perm).contiguous() if torch.is_tensor(a) else a
                              for a in args))
    for name in ref:
        assert torch.equal(moved[name], got[name][perm]), name
    with pytest.raises(ValueError):
        K6.rollout_prep(u, pose0, block_idx.long(), origin, res, 0.05, 0.25, nb)


def _prep_then_sample(win, args):
    """K6 then K1 on the card, as the evaluation ran them before the
    rollout-sample kernel: the reference that kernel is held to."""
    r = K6.rollout_prep(*args)
    val, d_row, d_col = K1.bicubic_linearize(win, r.pop("row"), r.pop("col"))
    return {**r, "val": val, "d_row": d_row, "d_col": d_col}


@pytest.mark.parametrize("name", ["benchmark_obstacle_only_config", "benchmark_social_config",
                                  "benchmark_omni_6agents_config", "benchmark_stress_h36_config"])
def test_rollout_sample_kernel_equals_rollout_prep_then_bicubic(card, name):
    """At the four default ticks' shapes (S, NB) on a real tick's inputs: the
    fused kernel's outputs equal K6's then K1's bit for bit, and an
    evaluation launches it once and K6 / K1 not at all."""
    cfg = getattr(C, name)()
    prep, vg, st, _ = _problem(cfg, card, batch=24, n_valid_people=cfg.n_agents)
    args = vg.prep_inputs(st.u)
    before = dict(_build.launch_counts)
    got = K6.rollout_sample(vg.win, *args)
    torch.cuda.synchronize()
    assert _build.launch_counts["rollout_sample"] == before["rollout_sample"] + 1
    ref = _prep_then_sample(vg.win, args)
    assert set(got) == set(ref)
    for key in ref:
        assert _same_bits(got[key], ref[key]), key
    before = dict(_build.launch_counts)
    vg(st.u)
    torch.cuda.synchronize()
    counts = {k: _build.launch_counts[k] - before[k] for k in before}
    assert counts["rollout_sample"] == 1 and counts["fused_iter"] == 1, counts
    assert counts["rollout_prep"] == 0 and counts["bicubic"] == 0, counts


@pytest.mark.parametrize("nb,s", [(3, 29), (6, 39), (3, 70), (1, 59), (1, 70), (2, 29), (4, 70),
                                  (5, 39), (6, 70)])
def test_rollout_sample_kernel_ragged_batch_and_offset_views(card, nb, s):
    """B = 4101 (the last block partly empty), a different block map in
    most scenarios, sample points that straddle the window's borders, and at
    S = 70 steps past the two chunks a lane keeps in registers: equal
    bits with K6 then K1, for contiguous inputs and for inputs that are views
    4 bytes into their storage; a scenario moved to another warp gives the
    same bits."""
    from nav2_social_mpc_controller_tpu_torch.models.motion import block_index_sequence_dynamic

    rng = np.random.default_rng(nb * 10 + s)
    b, h, w = 4101, 64, 64
    h_dyn = rng.integers(1, 6 * nb + 1, b)
    bl_dyn = np.minimum(6, h_dyn)
    block_idx = block_index_sequence_dynamic(
        s, torch.tensor(h_dyn, device=card), torch.tensor(bl_dyn, device=card)).to(torch.int32)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=card)

    pose0 = rng.uniform(-5, 5, (b, 3))
    origin = pose0[:, :2] - rng.uniform(0.0, 3.4, (b, 2))  # window of 3.2 m: some points leave it
    args = (t(rng.uniform(-0.8, 0.8, (b, 2 * nb))), t(pose0), block_idx.contiguous(), t(origin),
            t(np.full((b,), 0.05)), 0.05, 0.25, nb)
    win = t(np.rint(rng.uniform(0, 254, (b, h, w))))
    got = K6.rollout_sample(win, *args)
    ref = _prep_then_sample(win, args)
    for key in ref:
        assert _same_bits(got[key], ref[key]), key
    assert bool(torch.isfinite(got["val"]).all())

    def offset(x):
        if not torch.is_tensor(x):
            return x
        v = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape)
        return v.copy_(x)

    shifted = K6.rollout_sample(offset(win), *map(offset, args))
    perm = torch.roll(torch.arange(b, device=card), 7)
    moved = K6.rollout_sample(win.index_select(0, perm).contiguous(),
                              *(a.index_select(0, perm).contiguous() if torch.is_tensor(a) else a
                                for a in args))
    torch.cuda.synchronize()
    for key in ref:
        assert _same_bits(shifted[key], got[key]), key
        assert _same_bits(moved[key], got[key][perm]), key
    with pytest.raises(ValueError):
        K6.rollout_sample(win, args[0], args[1], block_idx.long(), *args[3:])


def _general_forms(mp):
    """Every wrapper takes its kernel's general form, at a templated shape
    too, while `mp` (a pytest.MonkeyPatch) holds: kernel_shapes.form reads
    the emptied lists of templated shapes at each call."""
    for name in ("BLOCKS", "SOLVE_DIMS", "SPD_SOLVE_DIMS"):
        mp.setattr(kernel_shapes, name, ())


def _same_bits(got, ref):
    """Every element's bits equal, NaN against NaN counted equal."""
    if got.dtype != ref.dtype or got.shape != ref.shape:
        return False
    if not got.is_floating_point():
        return torch.equal(got, ref)
    nan = torch.isnan(got)
    if not torch.equal(nan, torch.isnan(ref)):
        return False
    return torch.equal(got.view(torch.int32)[~nan], ref.view(torch.int32)[~nan])


def _trust_region_case(card, b, d):
    """Inputs of propose and commit for b scenarios, with the corner cases at
    fixed lanes where the batch has them: lane 1 a system that is not
    positive definite (NaN step, rejected), lane 2 a non-finite cost
    (numeric failure), lane 3 a zero gradient (gradient tolerance), lane 6 a
    radius that collapses below min_radius on a rejected step, lane 11 a
    frozen done lane with a stale code; the last two unknowns unbounded."""
    rng = np.random.default_rng(1000 * d + b)
    a = rng.standard_normal((b, d, d))
    jtj = np.einsum("bij,bkj->bik", a, a) * 10.0 + 1e-3 * np.eye(d)
    big = float(np.finfo(np.float32).max)
    lower, upper = np.full((b, d), -0.7), np.full((b, d), 0.7)
    lower[:, d - 2 :], upper[:, d - 2 :] = -big, big
    u = rng.uniform(-0.5, 0.5, (b, d))
    g = rng.standard_normal((b, d)) * 5.0
    radius = 10.0 ** rng.uniform(-2, 4, b)
    cost = rng.uniform(1.0, 100.0, b)
    new_cost = cost * rng.uniform(0.2, 1.5, b)
    done = np.zeros(b, bool)
    term = np.zeros(b, np.int32)
    if b > 1:
        jtj[1] = -jtj[1]
    if b > 2:
        new_cost[2] = cost[2] = np.inf
    if b > 3:
        g[3] = 1e-12
    if b > 6:
        radius[6] = 1.5e-32  # halved or less on the rejection: below min_radius = 1e-32
        new_cost[6] = cost[6] * 2.0
    if b > 11:
        done[11] = True
        term[11] = K34.TERM_FUNCTION_TOL

    def t(x, dtype=np.float32):
        return torch.tensor(np.asarray(x).astype(dtype), device=card)

    prop_in = tuple(map(t, (u, g, jtj, radius, lower, upper)))
    state = (
        prop_in[0], t(cost), prop_in[1], prop_in[2], prop_in[3],
        t(2.0 ** rng.integers(1, 4, b)), t(rng.integers(0, 30, b), np.int32),
        t(done, bool), t(term, np.int32), t(np.zeros(b, bool), bool),
    )
    return prop_in, state, (t(new_cost), t(g * 0.5 + 1.0), t(jtj * 0.9))


@pytest.mark.parametrize("b", [1, 31, 33, 4099])
@pytest.mark.parametrize("d", [2, 4, 6, 8, 10, 12])
def test_propose_and_commit_kernels_match_plain(card, d, b):
    """K3 and K4 bit for bit against their plain versions, at batches that
    leave a block or a segment partly empty."""
    prop_in, state, evaluated = _trust_region_case(card, b, d)
    before = (_build.launch_counts["propose"], _build.launch_counts["commit"])
    got = K34.propose(LM_CFG, *prop_in)
    ref = K34.propose_plain(LM_CFG, *prop_in)
    torch.cuda.synchronize()
    for x, y in zip(got, ref):
        assert _same_bits(x, y)
    if b > 1:
        assert torch.isnan(got[1][1]).all(), "a negative pivot must flow on as NaN"

    trial = (*ref, *evaluated)
    out = K34.commit(LM_CFG, *state, *trial)
    out_ref = K34.commit_plain(LM_CFG, *state, *trial)
    torch.cuda.synchronize()
    assert (_build.launch_counts["propose"], _build.launch_counts["commit"]) == (
        before[0] + 1, before[1] + 1)
    for x, y in zip(out, out_ref):
        assert _same_bits(x, y)
    if b > 11:
        for k in range(10):  # the done lane passes through bit for bit
            assert torch.equal(out[k][11], state[k][11])
        assert int(out[8][2]) == K34.TERM_NUMERIC_FAILURE
        assert int(out[8][3]) == K34.TERM_GRADIENT_TOL
        assert int(out[8][6]) == K34.TERM_MIN_RADIUS and not bool(out[1][6] != state[1][6])


@pytest.mark.parametrize("d", [2, 4, 6, 8, 10, 12])
def test_propose_and_commit_kernels_take_offset_views(card, d):
    """Inputs that are views 4 bytes into their storage take the kernels'
    scalar loads (K3's at D = 6, K4's JtJ copy): the same bits as the plain
    versions there too."""
    b = 4099
    prop_in, state, evaluated = _trust_region_case(card, b, d)

    def offset(x):
        v = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape)
        return v.copy_(x)

    prop_in = tuple(map(offset, prop_in))
    assert prop_in[2].data_ptr() % 16 != 0
    got = K34.propose(LM_CFG, *prop_in)
    ref = K34.propose_plain(LM_CFG, *prop_in)
    for x, y in zip(got, ref):
        assert _same_bits(x, y)
    state, trial = tuple(map(offset, state)), tuple(map(offset, (*ref, *evaluated)))
    out = K34.commit(LM_CFG, *state, *trial)
    out_ref = K34.commit_plain(LM_CFG, *state, *trial)
    torch.cuda.synchronize()
    for x, y in zip(out, out_ref):
        assert _same_bits(x, y)


@pytest.mark.parametrize("d", [2, 4, 6, 8, 10, 12])
def test_propose_and_commit_kernels_ignore_batch_position(card, d):
    """A scenario's bits do not depend on its block or its segment: a
    permuted batch gives the permuted outputs."""
    b = 301
    prop_in, state, evaluated = _trust_region_case(card, b, d)
    perm = torch.randperm(b, generator=torch.Generator().manual_seed(d)).to(card)

    def permuted(ts):
        return tuple(x.index_select(0, perm).contiguous() for x in ts)

    got = K34.propose(LM_CFG, *prop_in)
    moved = K34.propose(LM_CFG, *permuted(prop_in))
    for x, y in zip(moved, got):
        assert _same_bits(x, y[perm])
    trial = (*got, *evaluated)
    out = K34.commit(LM_CFG, *state, *trial)
    out_moved = K34.commit(LM_CFG, *permuted(state), *permuted(trial))
    torch.cuda.synchronize()
    for x, y in zip(out_moved, out):
        assert _same_bits(x, y[perm])


@pytest.mark.parametrize("d", [2, 4, 6, 8, 10, 12])
def test_propose_kernel_equals_spd_solve_and_projection(card, d):
    """K3 takes bit for bit the step of K7 on the damped system followed by
    the box projection, as the general iteration takes it."""
    prop_in, _, _ = _trust_region_case(card, 257, d)
    u, g, jtj, radius, lower, upper = prop_in
    a, rhs = K34.damped_system(LM_CFG, g, jtj, radius)
    step = K7.spd_solve(a.contiguous(), rhs.contiguous())
    ref = K34.project_step(u, step, g, jtj, lower, upper)
    got = K34.propose(LM_CFG, *prop_in)
    torch.cuda.synchronize()
    for x, y in zip(got, ref):
        assert _same_bits(x, y)


@pytest.mark.parametrize("d", [1, 2, 3, 5, 6, 7, 8, 12, 16])
def test_spd_solve_kernel_matches_plain(card, d):
    rng = np.random.default_rng(100 + d)
    n = 300  # not a multiple of the block size
    m = rng.standard_normal((n, d, d))
    a = np.einsum("bij,bkj->bik", m, m) + 0.5 * np.eye(d)
    a[7] = -a[7]  # not positive definite: NaN, on both sides
    b = rng.standard_normal((n, d))
    a_t = torch.tensor(a.astype(np.float32), device=card)
    b_t = torch.tensor(b.astype(np.float32), device=card)
    got = K7.spd_solve(a_t, b_t)
    ref = K7.spd_solve_plain(a_t, b_t)
    torch.cuda.synchronize()
    assert torch.isnan(got[7]).all() and torch.isnan(ref[7]).all()
    assert _same_bits(got, ref)  # the same arithmetic, operation for operation
    ok = np.arange(n) != 7
    x64 = np.linalg.solve(a[ok], b[ok][..., None])[..., 0]
    # float32 Cholesky of systems with condition numbers up to ~1e3
    np.testing.assert_allclose(got.cpu().numpy()[ok], x64, rtol=2e-3, atol=2e-4)


def test_spd_solve_refuses_other_sizes_on_the_card(card):
    past = kernel_shapes.GENERAL_MAX_DIM + 1
    a = torch.eye(past, device=card).expand(4, past, past).contiguous()
    with pytest.raises(ValueError, match=f"D from 1 to {past - 1}"):
        K7.spd_solve(a, torch.ones((4, past), device=card))
    with pytest.raises(ValueError, match="float32"):
        K7.spd_solve(torch.eye(6, device=card, dtype=torch.float64).expand(4, 6, 6).contiguous(),
                     torch.ones((4, 6), device=card, dtype=torch.float64))


def _damped_case(card, b, d, scaled):
    """propose's inputs of _trust_region_case and, when scaled, the Jacobi
    scale lm_solve forms from JtJ."""
    prop_in, _, _ = _trust_region_case(card, b, d)
    return prop_in, (lm.jacobi_scale(prop_in[2]) if scaled else None)


@pytest.mark.parametrize("scaled", [False, True], ids=["unscaled", "jacobi"])
@pytest.mark.parametrize("b", [1, 31, 33, 4099])
@pytest.mark.parametrize("d", [2, 4, 6, 8, 10, 12])
def test_damped_step_kernel_matches_plain(card, d, b, scaled):
    """K7's damped step bit for bit against damped_step_plain (the general
    iteration's composition), one launch counted under spd_solve, at batches
    that leave a block or a segment partly empty; lane 1 is not positive
    definite and gives NaN."""
    prop_in, jac = _damped_case(card, b, d, scaled)
    before = _build.launch_counts["spd_solve"]
    got = K34.damped_step(LM_CFG, *prop_in, jac)
    ref = K34.damped_step_plain(LM_CFG, *prop_in, jac)
    torch.cuda.synchronize()
    assert _build.launch_counts["spd_solve"] == before + 1
    for x, y in zip(got, ref):
        assert _same_bits(x, y)
    if b > 1:
        assert torch.isnan(got[1][1]).all(), "a negative pivot must flow on as NaN"
        assert bool(torch.isfinite(got[0][0]).all())


@pytest.mark.parametrize("d", [2, 4, 6, 8, 10, 12])
def test_damped_step_kernel_without_scale_is_propose(card, d):
    """Without jac_scale the damped step is K3's function: the same bits as
    propose's kernel."""
    prop_in, _ = _damped_case(card, 4099, d, False)
    got = K34.damped_step(LM_CFG, *prop_in)
    ref = K34.propose(LM_CFG, *prop_in)
    torch.cuda.synchronize()
    for x, y in zip(got, ref):
        assert _same_bits(x, y)


@pytest.mark.parametrize("scaled", [False, True], ids=["unscaled", "jacobi"])
@pytest.mark.parametrize("d", [2, 4, 6, 8, 10, 12])
def test_damped_step_kernel_ignores_batch_position_and_alignment(card, d, scaled):
    """A permuted batch gives the permuted outputs, and views that start 4
    bytes into their storage (the scalar loads at D = 6) give the same bits
    as the plain version."""
    b = 301
    prop_in, jac = _damped_case(card, b, d, scaled)
    args = (*prop_in, jac) if scaled else prop_in
    perm = torch.randperm(b, generator=torch.Generator().manual_seed(d)).to(card)

    def offset(x):
        v = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape)
        return v.copy_(x)

    got = K34.damped_step(LM_CFG, *args)
    moved = K34.damped_step(LM_CFG, *(x.index_select(0, perm).contiguous() for x in args))
    shifted_args = tuple(map(offset, args))
    assert shifted_args[2].data_ptr() % 16 != 0
    shifted = K34.damped_step(LM_CFG, *shifted_args)
    ref = K34.damped_step_plain(LM_CFG, *shifted_args)
    torch.cuda.synchronize()
    for x, y, z, r in zip(got, moved, shifted, ref):
        assert _same_bits(y, x[perm])
        assert _same_bits(z, r) and _same_bits(z, x)


def test_damped_step_refuses_what_the_kernel_does_not_take(card):
    prop_in, _ = _damped_case(card, 8, 6, False)
    with pytest.raises(ValueError, match="float32"):
        K34.damped_step(LM_CFG, *(x.double() for x in prop_in))
    with pytest.raises(ValueError, match="jac_scale"):
        K34.damped_step(LM_CFG, *prop_in, torch.ones((8, 5), device=card))
    small = (prop_in[0][:, :5].contiguous(), prop_in[1][:, :5].contiguous(),
             prop_in[2][:, :5, :5].contiguous(), prop_in[3], prop_in[4][:, :5].contiguous(),
             prop_in[5][:, :5].contiguous())
    with pytest.raises(ValueError, match="every even D"):
        K34.damped_step(LM_CFG, *small)
    past = 2 * kernel_shapes.GENERAL_MAX_BLOCKS + 2  # past the general solve's shared memory
    wide, _ = _damped_case(card, 8, past, False)
    for fn in (K34.damped_step, K34.propose):
        with pytest.raises(ValueError, match="shared memory"):
            fn(LM_CFG, *wide)


@pytest.mark.parametrize("n", [1, 31, 33, 4099])
@pytest.mark.parametrize("d", [1, 2, 3, 5, 6, 7, 8, 12, 16])
def test_spd_solve_kernel_bits_at_every_batch_and_alignment(card, d, n):
    """The standalone solve on the damped step's layouts: bit for bit against
    spd_solve_plain at batches that leave a block or a segment partly empty,
    NaN in the same places for systems that are not positive definite, and
    the same bits from views 4 bytes into their storage."""
    rng = np.random.default_rng(10 * n + d)
    m = rng.standard_normal((n, d, d))
    a = np.einsum("bij,bkj->bik", m, m) + 0.5 * np.eye(d)
    a[::7] = -a[::7]
    a_t = torch.tensor(a.astype(np.float32), device=card)
    b_t = torch.tensor(rng.standard_normal((n, d)).astype(np.float32), device=card)
    got = K7.spd_solve(a_t, b_t)
    ref = K7.spd_solve_plain(a_t, b_t)

    def offset(x):
        v = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape)
        return v.copy_(x)

    shifted = K7.spd_solve(offset(a_t), offset(b_t))
    torch.cuda.synchronize()
    assert _same_bits(got, ref) and _same_bits(shifted, ref)
    assert torch.isnan(got[0]).all()


# ---------------------------------------------------------------------------
# The general forms (NB and D at run time), past the templated lists
# ---------------------------------------------------------------------------


def _social_in_blocks_of_one(nb):
    base = C.benchmark_social_config()
    return dataclasses.replace(base, optimizer=dataclasses.replace(
        base.optimizer, control_horizon=nb, parameter_block_length=1))


@pytest.mark.parametrize("people", [False, True], ids=["people_free", "people"])
@pytest.mark.parametrize("nb", [7, 9, 18])
def test_fused_general_form_matches_plain(card, nb, people):
    """K2's general form at NB past 6 (the social horizon in blocks of 1):
    the plain version within 3e-5 (people) or 1e-4, JtJ symmetric, one
    launch counted under fused_iter_general and none under fused_iter."""
    prep, vg, st, _ = _problem(_social_in_blocks_of_one(nb), card, batch=24,
                               n_valid_people=3 if people else 0)
    args = vg.fused_inputs(st.u)
    assert args[10].shape[1] == nb
    before = dict(_build.launch_counts)
    got = K2.fused_cost_g_jtj(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts["fused_iter_general"] == before["fused_iter_general"] + 1
    assert _build.launch_counts["fused_iter"] == before["fused_iter"]
    for g, r in zip(got, K2.fused_cost_g_jtj_plain(*args)):
        assert _norm_err(g, r) <= (3e-5 if people else 1e-4)
    assert torch.equal(got[2], got[2].transpose(1, 2))


@pytest.mark.parametrize("bad", [float("nan"), float("inf")], ids=["nan", "inf"])
def test_fused_general_form_non_finite_partial(card, bad):
    """K2's general form at NB = 9 with one scenario's obstacle partials
    non-finite at one step (its costmap column gradient NaN or inf there,
    its residual finite): a NaN reaches exactly the JtJ and g entries it
    reaches in the plain version, NaN and inf in the same places; an inf
    the same entries, which are then non-finite; every other scenario
    stays finite and within the tolerance."""
    prep, vg, st, _ = _problem(_social_in_blocks_of_one(9), card, batch=24, n_valid_people=3)
    args = list(vg.fused_inputs(st.u))
    k = 5
    s = int(torch.nonzero(args[16][k])[0])  # a step the obstacle row holds
    dcol = args[14].clone()
    dcol[k, s] = bad
    args[14] = dcol
    got = K2.fused_cost_g_jtj(*args)
    ref = K2.fused_cost_g_jtj_plain(*args)
    torch.cuda.synchronize()
    for name, x, r in zip(("cost", "g", "jtj"), got, ref):
        assert torch.equal(torch.isfinite(x), torch.isfinite(r)), name
        if bad != bad:
            assert torch.equal(torch.isnan(x), torch.isnan(r)), name
            assert torch.equal(torch.isinf(x), torch.isinf(r)), name
        rest = torch.arange(x.shape[0], device=card) != k
        assert bool(torch.isfinite(x[rest]).all()), name
        assert _norm_err(x[rest], r[rest]) <= 3e-5, name
    assert not bool(torch.isfinite(got[2][k]).all())
    assert _same_bits(got[2], got[2].transpose(1, 2).contiguous())


@pytest.mark.parametrize("people", [False, True], ids=["people_free", "people"])
@pytest.mark.parametrize("nb", [3, 6])
def test_fused_general_form_agrees_with_the_templated_form(card, nb, people):
    """At a templated NB the general form (_general_forms) sums in another
    order than the templated K2: the two agree within K2's tolerances."""
    base = C.benchmark_social_config()
    cfg = dataclasses.replace(base, optimizer=dataclasses.replace(
        base.optimizer, control_horizon=4 * nb, parameter_block_length=4))
    prep, vg, st, _ = _problem(cfg, card, batch=24, n_valid_people=3 if people else 0)
    args = vg.fused_inputs(st.u)
    with pytest.MonkeyPatch.context() as mp:
        _general_forms(mp)
        got = K2.fused_cost_g_jtj(*args)
    for g, r in zip(got, K2.fused_cost_g_jtj(*args)):
        assert _norm_err(g, r) <= (3e-5 if people else 1e-4)


@pytest.mark.parametrize("nb,s", [(7, 29), (9, 29), (18, 29), (36, 70), (118, 123)])
def test_rollout_general_forms_match_plain(card, nb, s):
    """K6's general form against its plain version (K6's tolerances, the
    controls exact), rollout_sample's general form bit for bit against K6's
    general form then K1, both counted under their general names; blocks of
    1 with a shrunk horizon in most scenarios."""
    from nav2_social_mpc_controller_tpu_torch.models.motion import block_index_sequence_dynamic

    rng = np.random.default_rng(nb)
    b = 45
    h_dyn = rng.integers(1, nb + 1, b)
    h_dyn[0] = nb
    block_idx = block_index_sequence_dynamic(
        s, torch.tensor(h_dyn, device=card), torch.ones(b, dtype=torch.long, device=card)
    ).to(torch.int32).contiguous()
    assert set(block_idx[0].tolist()) == set(range(min(nb, s)))

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=card)

    pose0 = rng.uniform(-5, 5, (b, 3))
    args = (t(rng.uniform(-0.8, 0.8, (b, 2 * nb))), t(pose0), block_idx,
            t(pose0[:, :2] - rng.uniform(0.0, 3.4, (b, 2))), t(np.full((b,), 0.05)), 0.05, 0.25,
            nb)
    before = dict(_build.launch_counts)
    got = K6.rollout_prep(*args)
    ref = K6.rollout_prep_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got["v"], ref["v"])
    for name in ref:
        atol = 2e-4 if name in ("row", "col") else 1e-5
        torch.testing.assert_close(got[name], ref[name], rtol=2e-5, atol=atol, msg=name)
    win = t(np.rint(rng.uniform(0, 254, (b, 64, 64))))
    sampled = K6.rollout_sample(win, *args)
    want = _prep_then_sample(win, args)
    for key in want:
        assert _same_bits(sampled[key], want[key]), key
    counts = _build.launch_counts
    assert counts["rollout_prep_general"] == before["rollout_prep_general"] + 2
    assert counts["rollout_sample_general"] == before["rollout_sample_general"] + 1
    assert counts["rollout_prep"] == before["rollout_prep"]


@pytest.mark.parametrize("nb,s", [(3, 29), (6, 39), (3, 70)])
def test_rollout_general_forms_agree_with_the_templated_forms(card, nb, s):
    """At a templated NB the general forms run the same scans in the same
    order as the templated kernels: equal within K6's tolerances (their
    bits too, where ptxas contracts alike; reported by chip_smoke.py)."""
    rng = np.random.default_rng(nb + s)
    b = 33
    from nav2_social_mpc_controller_tpu_torch.models.motion import block_index_sequence_dynamic

    block_idx = block_index_sequence_dynamic(
        s, torch.full((b,), 4 * nb, device=card), torch.full((b,), 4, device=card)
    ).to(torch.int32).contiguous()

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=card)

    pose0 = rng.uniform(-5, 5, (b, 3))
    args = (t(rng.uniform(-0.8, 0.8, (b, 2 * nb))), t(pose0), block_idx,
            t(pose0[:, :2] - 1.6), t(np.full((b,), 0.05)), 0.05, 0.25, nb)
    win = t(np.rint(rng.uniform(0, 254, (b, 64, 64))))
    with pytest.MonkeyPatch.context() as mp:
        _general_forms(mp)
        got = K6.rollout_sample(win, *args)
    want = K6.rollout_sample(win, *args)
    torch.cuda.synchronize()
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=2e-5, atol=2e-4, msg=name)


def _general_rollout_case(card, nb, s, b, seed):
    """K6's arguments and a window for b scenarios at NB blocks over S
    steps: blocks of 1 with a shrunk horizon in most scenarios, one whose
    blocks are interleaved in the steps (not contiguous), a -0.0 control,
    and at b > 5 a NaN and an infinite control."""
    from nav2_social_mpc_controller_tpu_torch.models.motion import block_index_sequence_dynamic

    rng = np.random.default_rng(seed)
    h_dyn = rng.integers(1, nb + 1, b)
    h_dyn[0] = nb
    block_idx = block_index_sequence_dynamic(
        s, torch.tensor(h_dyn, device=card), torch.ones(b, dtype=torch.long, device=card)
    ).to(torch.int32)
    if b > 1:
        block_idx[1] = torch.arange(s, device=card) % nb
    u = rng.uniform(-0.8, 0.8, (b, 2 * nb))
    u[0, 0::2][:2] = -0.0
    if b > 5:
        u[4, 2 * int(block_idx[4, -1])] = np.nan
        u[5, 0] = np.inf

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=card)

    pose0 = rng.uniform(-5, 5, (b, 3))
    args = (t(u), t(pose0), block_idx.contiguous(), t(pose0[:, :2] - rng.uniform(0.0, 3.4, (b, 2))),
            t(np.full((b,), 0.05)), 0.05, 0.25, nb)
    return t(np.rint(rng.uniform(0, 254, (b, 64, 64)))), args


@pytest.mark.parametrize("s", [29, 32, 33, 69, 123])
@pytest.mark.parametrize("nb", [7, 9, 12, 18, 36, 118])
def test_rollout_general_forms_at_every_batch(card, nb, s):
    """The redesigned general forms on ragged batches against the warps a
    block (B = 1, 5, 301, 4097; 4097 up to NB = 18): rollout_sample's
    general form bit for bit against K6's general form then K1, K6's within
    its tolerances of the plain version (NaN and inf where it has them), at
    the launch kernel_shapes.rollout_general_geometry gives."""
    for b in (1, 5, 301, 4097) if nb <= 18 else (1, 5, 301):
        win, args = _general_rollout_case(card, nb, s, b, seed=nb * 1000 + s + b)
        got = K6.rollout_sample(win, *args)
        want = _prep_then_sample(win, args)
        prep = K6.rollout_prep(*args)
        ref = K6.rollout_prep_plain(*args)
        torch.cuda.synchronize()
        for key in want:
            assert _same_bits(got[key], want[key]), (b, key)
        for name in ref:
            atol = 2e-4 if name in ("row", "col") else 1e-5
            torch.testing.assert_close(prep[name], ref[name], rtol=2e-5, atol=atol, equal_nan=True,
                                       msg=f"{b} {name}")


@pytest.mark.parametrize("nb,s", [(9, 29), (12, 39), (36, 69), (64, 123)])
def test_rollout_general_bits_do_not_depend_on_the_warps(card, nb, s, monkeypatch):
    """Every count of warps a scenario (1, 2, 4, 8) whose blocks a warp fit
    the register ceilings gives the same bits, both general forms, at
    B = 301."""
    win, args = _general_rollout_case(card, nb, s, 301, seed=nb + s)
    want = (K6.rollout_sample(win, *args), K6.rollout_prep(*args))
    fits = [w for w in kernel_shapes.ROLLOUT_GENERAL_WARPS
            if -(-nb // w) <= kernel_shapes.ROLLOUT_GENERAL_MAX_REGISTER_BLOCKS]
    assert len(fits) >= 2
    for warps in fits:
        monkeypatch.setattr(kernel_shapes, "rollout_general_warps", lambda *_, w=warps: w)
        got = (K6.rollout_sample(win, *args), K6.rollout_prep(*args))
        torch.cuda.synchronize()
        for g, r in zip(got, want):
            for key in r:
                assert _same_bits(g[key], r[key]), (warps, key)


def test_rollout_general_forms_captured_equal_eager(card):
    """Both general forms captured in a CUDA graph and replayed give the
    eager launches' bits (NB = 12, S = 39, B = 301)."""
    win, args = _general_rollout_case(card, 12, 39, 301, seed=3)

    def run():
        return K6.rollout_sample(win, *args), K6.rollout_prep(*args)

    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    graph.replay()
    torch.cuda.synchronize()
    for g, r in zip(captured, eager):
        for key in r:
            assert _same_bits(g[key], r[key]), key


@pytest.mark.parametrize("b", [1, 33, 301])
@pytest.mark.parametrize("d", [14, 18, 24, 36, 64, 128, 236])
def test_propose_and_commit_general_forms_match_plain(card, d, b):
    """K3 and K4's general forms bit for bit against their plain versions,
    every corner case of _trust_region_case, counted under their general
    names; a D past 48 KB of shared memory a system (D = 128, 236) takes the
    kernel's opt-in."""
    prop_in, state, evaluated = _trust_region_case(card, b, d)
    before = dict(_build.launch_counts)
    got = K34.propose(LM_CFG, *prop_in)
    ref = K34.propose_plain(LM_CFG, *prop_in)
    trial = (*ref, *evaluated)
    out = K34.commit(LM_CFG, *state, *trial)
    out_ref = K34.commit_plain(LM_CFG, *state, *trial)
    torch.cuda.synchronize()
    for x, y in zip((*got, *out), (*ref, *out_ref)):
        assert _same_bits(x, y)
    if b > 1:
        assert torch.isnan(got[1][1]).all(), "a negative pivot must flow on as NaN"
    counts = _build.launch_counts
    assert (counts["propose_general"], counts["commit_general"]) == (
        before["propose_general"] + 1, before["commit_general"] + 1)
    assert (counts["propose"], counts["commit"]) == (before["propose"], before["commit"])


@pytest.mark.parametrize("d", [2, 6, 12])
def test_general_solve_forms_at_templated_shapes_equal_plain(card, d):
    """The general forms at a templated D (_general_forms): K3, K4, K7's
    damped step (scaled and not) and its standalone solve, bit for bit
    against the plain versions, as the templated forms are."""
    prop_in, state, evaluated = _trust_region_case(card, 301, d)
    jac = lm.jacobi_scale(prop_in[2])
    prop_ref = K34.propose_plain(LM_CFG, *prop_in)
    trial = (*prop_ref, *evaluated)
    a, rhs = K34.damped_system(LM_CFG, prop_in[1], prop_in[2], prop_in[3])
    before = dict(_build.launch_counts)
    with pytest.MonkeyPatch.context() as mp:
        _general_forms(mp)
        pairs = [(K34.propose(LM_CFG, *prop_in), prop_ref)]
        for scale in (None, jac):
            pairs.append((K34.damped_step(LM_CFG, *prop_in, scale),
                          K34.damped_step_plain(LM_CFG, *prop_in, scale)))
        pairs.append((K34.commit(LM_CFG, *state, *trial),
                      K34.commit_plain(LM_CFG, *state, *trial)))
        pairs.append(((K7.spd_solve(a.contiguous(), rhs.contiguous()),),
                      (K7.spd_solve_plain(a, rhs),)))
    counts = _build.launch_counts
    assert [counts[k] - before[k] for k in ("propose_general", "commit_general",
                                            "spd_solve_general")] == [1, 1, 3]
    torch.cuda.synchronize()
    for got, ref in pairs:
        for x, y in zip(got, ref):
            assert _same_bits(x, y)


@pytest.mark.parametrize("scaled", [False, True], ids=["unscaled", "jacobi"])
@pytest.mark.parametrize("d", [14, 18, 32, 34, 36, 64, 128, 130, 236])
def test_damped_step_general_form_matches_plain(card, d, scaled):
    """K7's damped step past D = 12 bit for bit against damped_step_plain,
    counted under spd_solve_general, on both sides of each form's edges (a
    warp a system to D = 32 at the registers' ceilings 16, 24 and 32, a
    block a system above, its lanes' column groups of 32 and its four
    warps' rows); without the scale it is K3's general form's function, bit
    for bit."""
    prop_in, jac = _damped_case(card, 33, d, scaled)
    before = _build.launch_counts["spd_solve_general"]
    got = K34.damped_step(LM_CFG, *prop_in, jac)
    ref = K34.damped_step_plain(LM_CFG, *prop_in, jac)
    torch.cuda.synchronize()
    assert _build.launch_counts["spd_solve_general"] == before + 1
    for x, y in zip(got, ref):
        assert _same_bits(x, y)
    assert torch.isnan(got[1][1]).all() and bool(torch.isfinite(got[0][0]).all())
    if not scaled:
        for x, y in zip(got, K34.propose(LM_CFG, *prop_in)):
            assert _same_bits(x, y)


@pytest.mark.parametrize("n", [1, 5, 33, 301])
@pytest.mark.parametrize("d", [17, 24, 31, 32, 33, 64, 65, 128, 129, 237])
def test_spd_solve_general_form_bits(card, d, n):
    """K7's standalone solve past D = 16 (a warp a system to D = 32, several
    systems a block; a block a system above) bit for bit against
    spd_solve_plain, NaN for the systems that are not positive definite,
    the same bits from views 4 bytes into their storage."""
    rng = np.random.default_rng(10 * n + d)
    m = rng.standard_normal((n, d, d))
    a = np.einsum("bij,bkj->bik", m, m) + 0.5 * np.eye(d)
    a[::7] = -a[::7]
    a_t = torch.tensor(a.astype(np.float32), device=card)
    b_t = torch.tensor(rng.standard_normal((n, d)).astype(np.float32), device=card)
    before = _build.launch_counts["spd_solve_general"]
    got = K7.spd_solve(a_t, b_t)
    ref = K7.spd_solve_plain(a_t, b_t)

    def offset(x):
        v = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape)
        return v.copy_(x)

    shifted = K7.spd_solve(offset(a_t), offset(b_t))
    torch.cuda.synchronize()
    assert _build.launch_counts["spd_solve_general"] == before + 2
    assert _same_bits(got, ref) and _same_bits(shifted, ref)
    assert torch.isnan(got[0]).all()


@pytest.mark.parametrize("n", [1, 5, 301, 4097])
@pytest.mark.parametrize("d", [18, 32])
def test_general_solve_warp_form_ragged_batches(card, d, n):
    """The warp form (a warp a system, kernel_shapes.general_solve_geometry's
    systems a block) at batches that leave the last block partly empty: the
    damped step, scaled and not, and the standalone solve, bit for bit
    against the plain versions."""
    threads, systems, _ = kernel_shapes.general_solve_geometry(d)
    assert threads == 32 and systems > 1 and (n == 1 or n % systems != 0)
    prop_in, _, _ = _trust_region_case(card, n, d)
    jac = lm.jacobi_scale(prop_in[2])
    before = _build.launch_counts["spd_solve_general"]
    for scale in (None, jac):
        got = K34.damped_step(LM_CFG, *prop_in, scale)
        ref = K34.damped_step_plain(LM_CFG, *prop_in, scale)
        torch.cuda.synchronize()
        for x, y in zip(got, ref):
            assert _same_bits(x, y)
    a, rhs = K34.damped_system(LM_CFG, prop_in[1], prop_in[2], prop_in[3])
    a, rhs = a.contiguous(), rhs.contiguous()
    got = K7.spd_solve(a, rhs)
    torch.cuda.synchronize()
    assert _same_bits(got, K7.spd_solve_plain(a, rhs))
    assert _build.launch_counts["spd_solve_general"] == before + 3
    if n > 1:
        assert torch.isnan(got[1]).all()


@pytest.mark.parametrize("d", [18, 64])
def test_general_solve_captured_equals_eager(card, d):
    """The general damped step (scaled and not) and the standalone solve
    captured in a CUDA graph (after an eager launch, which opts in to the
    shared memory it needs) and replayed give the eager launch's bits."""
    prop_in, _, _ = _trust_region_case(card, 301, d)
    jac = lm.jacobi_scale(prop_in[2])
    a, rhs = K34.damped_system(LM_CFG, prop_in[1], prop_in[2], prop_in[3])
    a, rhs = a.contiguous(), rhs.contiguous()

    def run():
        return (*K34.damped_step(LM_CFG, *prop_in), *K34.damped_step(LM_CFG, *prop_in, jac),
                K7.spd_solve(a, rhs))

    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    graph.replay()
    torch.cuda.synchronize()
    for x, y in zip(captured, eager):
        assert _same_bits(x, y)


def test_debug_and_compacted_steps_equal_the_plain_step_on_the_card(card):
    """The general iteration (K7) takes the steps K3 takes, and compaction
    changes no lane: three ticks, every result bit for bit."""
    from nav2_social_mpc_controller_tpu_torch.controller.controller import (
        make_step_batch,
        make_step_batch_compacted,
    )

    cfg = C.benchmark_social_config()
    opt = dataclasses.replace(cfg.optimizer, warm_start_mode="previous_solution")
    cfg = dataclasses.replace(cfg, optimizer=opt)
    dbg = dataclasses.replace(cfg, optimizer=dataclasses.replace(opt, debug_optimizer=True))
    b = 64
    sc = scenario_from_numpy(make_scenario_batch(cfg, b, base_seed=0, n_valid_people=3), device=card)
    steps = (make_step_batch(cfg, device=card), make_step_batch(dbg, device=card),
             make_step_batch_compacted(cfg, 0.125, device=card))
    carries = [make_carry(cfg, b, device=card) for _ in steps]
    for _ in range(3):
        _build.reset_launch_counts()
        outs = []
        for k, fn in enumerate(steps):
            cmd, aux, carries[k] = fn(sc, carries[k])
            outs.append((cmd, aux))
        torch.cuda.synchronize()
        assert _build.launch_counts["spd_solve"] > 0
        for cmd, aux in outs[1:]:
            assert torch.equal(cmd.linear_x, outs[0][0].linear_x)
            assert torch.equal(cmd.angular_z, outs[0][0].angular_z)
            assert torch.equal(aux.solve.iterations, outs[0][1].solve.iterations)
            assert torch.equal(aux.solve.termination, outs[0][1].solve.termination)
            assert torch.equal(aux.solve.final_cost, outs[0][1].solve.final_cost)
        for other in carries[1:]:
            assert all(torch.equal(x, y) for x, y in zip(other, carries[0]))
    trace = outs[1][1].lm_trace
    assert torch.equal(trace.cost[:, 0], outs[1][1].solve.initial_cost)


def test_step_on_the_card_launches_every_kernel(card):
    from nav2_social_mpc_controller_tpu_torch.controller.controller import make_step_batch

    cfg = C.benchmark_social_config()
    cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer, max_iterations=5))
    sc = scenario_from_numpy(make_scenario_batch(cfg, 4, base_seed=3, n_valid_people=3), device=card)
    _build.reset_launch_counts()
    cmd, aux, _ = make_step_batch(cfg, device=card)(sc, make_carry(cfg, 4, device=card))
    torch.cuda.synchronize()
    # K7 belongs to the general iteration; K6 and K1 run inside the
    # rollout-sample kernel, once per evaluation, as K2 does; compact_continue
    # decides the compacted tick's schedule only; the general forms run past
    # NB = 6 only (NB = 3 here)
    off_path = ("spd_solve", "rollout_prep", "bicubic", "compact_continue") + tuple(
        k for k in _build.launch_counts if k.endswith(_build.GENERAL_SUFFIX))
    default_path = {k: n for k, n in _build.launch_counts.items() if k not in off_path}
    assert all(n > 0 for n in default_path.values()), _build.launch_counts
    assert all(_build.launch_counts[k] == 0 for k in off_path), _build.launch_counts
    assert _build.launch_counts["rollout_sample"] == _build.launch_counts["fused_iter"]
    assert torch.isfinite(cmd.linear_x).all() and bool(aux.solve.usable.all())

    dbg = dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer, debug_optimizer=True))
    _build.reset_launch_counts()
    cmd_d, aux_d, _ = make_step_batch(dbg, device=card)(sc, make_carry(cfg, 4, device=card))
    torch.cuda.synchronize()
    counts = _build.launch_counts
    # the loop stops at the first check (every DEFAULT_CHECK_EVERY-th iteration) that finds all done
    every = lm.DEFAULT_CHECK_EVERY
    ran = min(5, -(-int(aux_d.solve.iterations.max()) // every) * every)
    assert counts["spd_solve"] == ran > 0, counts
    assert counts["propose"] == 0 and counts["commit"] == 0, counts
    assert torch.equal(cmd_d.linear_x, cmd.linear_x) and torch.equal(cmd_d.angular_z, cmd.angular_z)
