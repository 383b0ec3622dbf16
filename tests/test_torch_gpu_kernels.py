"""The port's four CUDA kernels against their plain PyTorch versions ON THE
CARD, at small shapes chosen for their corner cases (border-clamped and NaN
coordinates, masked steps and shrunk horizons, a system that is not positive
definite, frozen done lanes, every termination code).

These tests need an NVIDIA GPU and nvcc and skip where there is none. They
import only torch, NumPy and the port, so on a machine with a card they run
without the JAX package's test harness:

    python -m pytest tests/test_torch_gpu_kernels.py -q --noconftest -p no:cacheprovider

Tolerances: nvcc contracts a*b+c into FMA in K1/K2 and K2 reduces across a
warp in another order than the plain version, so those agree to float32
rounding of their sums (1e-5 / 1e-4, scale-normalised); K3/K4 are written
with round-to-nearest intrinsics and repeat the plain version operation for
operation, so they are held to 1e-6 and their discrete outputs to equality.
K5 (the SFM scan) carries float32 rounding through every step of the
pedestrian dynamics: 1e-4 scale-normalised, its validity column exact.
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from nav2_social_mpc_controller_tpu_torch import _build
from nav2_social_mpc_controller_tpu_torch.controller.controller import make_carry, step_pre
from nav2_social_mpc_controller_tpu_torch.controller.optimize import ProblemDims, make_lm_config
from nav2_social_mpc_controller_tpu_torch.core import config as C
from nav2_social_mpc_controller_tpu_torch.core.types import scenario_from_numpy
from nav2_social_mpc_controller_tpu_torch.models import sfm as K5
from nav2_social_mpc_controller_tpu_torch.ops import bicubic_cuda as K1
from nav2_social_mpc_controller_tpu_torch.ops import fused_iter as K2
from nav2_social_mpc_controller_tpu_torch.solver import cuda_iter as K34
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


def _problem(cfg, card, batch=8, n_iters=2):
    """A real tick's problem on the card, advanced a few LM iterations; every
    second robot starts 2-5 poses before its goal, which shrinks h_dyn /
    bl_dyn and masks the trailing steps."""
    sc_np = make_scenario_batch(cfg, batch, base_seed=0)
    pose = np.array(sc_np.robot.pose)
    for k in range(1, batch, 2):
        i = int(sc_np.path.n[k]) - 2 - (k // 2) % 4
        pose[k] = [*sc_np.path.points[k, i], sc_np.path.yaw[k, i]]
    sc = scenario_from_numpy(sc_np._replace(robot=sc_np.robot._replace(pose=pose)), device=card)
    dims = ProblemDims.from_config(cfg)
    prep = step_pre(cfg, sc, make_carry(cfg, batch, device=card)).prep
    vg = K2.build_value_grad(cfg, dims, prep.rows, prep.n_rows, prep.costmap)
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
    before = _build.launch_counts["fused_iter"]
    got = K2.fused_cost_g_jtj(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts["fused_iter"] == before + 1
    for g, r in zip(got, K2.fused_cost_g_jtj_plain(*args)):
        assert _norm_err(g, r) <= 1e-4
    assert torch.equal(got[2], got[2].transpose(1, 2)), "JtJ is written in both triangles"


@pytest.mark.parametrize("d", [6, 12])
def test_propose_and_commit_kernels_match_plain(card, d):
    rng = np.random.default_rng(d)
    b = 12
    a = rng.standard_normal((b, d, d))
    jtj = np.einsum("bij,bkj->bik", a, a) * 10.0 + 1e-3 * np.eye(d)
    jtj[1] = -jtj[1]  # not positive definite: NaN step, rejected by commit
    big = float(np.finfo(np.float32).max)
    lower, upper = np.full((b, d), -0.7), np.full((b, d), 0.7)
    lower[:, d - 2 :], upper[:, d - 2 :] = -big, big  # an unbounded remainder block

    def t(x, dtype=np.float32):
        return torch.tensor(np.asarray(x).astype(dtype), device=card)

    u = rng.uniform(-0.5, 0.5, (b, d))
    g = rng.standard_normal((b, d)) * 5.0
    g[3] = 1e-12  # gradient tolerance
    radius = 10.0 ** rng.uniform(-2, 4, b)
    radius[6] = 1e-31  # collapses below min_radius on a rejected step
    prop_in = tuple(map(t, (u, g, jtj, radius, lower, upper)))
    got = K34.propose(LM_CFG, *prop_in)
    ref = K34.propose_plain(LM_CFG, *prop_in)
    torch.cuda.synchronize()
    for x, y in zip(got, ref):
        assert _norm_err(x, y) <= 1e-6
    assert torch.isnan(got[1][1]).all(), "a negative pivot must flow on as NaN"

    cost = rng.uniform(1.0, 100.0, b)
    new_cost = cost * rng.uniform(0.2, 1.5, b)
    new_cost[2] = cost[2] = np.inf  # numeric failure
    new_cost[6] = cost[6] * 2.0
    done = np.zeros(b, bool)
    done[0] = True  # frozen lane with a stale code
    term = np.zeros(b, np.int32)
    term[0] = K34.TERM_FUNCTION_TOL
    state = (
        prop_in[0], t(cost), prop_in[1], prop_in[2], prop_in[3],
        t(2.0 ** rng.integers(1, 4, b)), t(rng.integers(0, 30, b), np.int32),
        t(done, bool), t(term, np.int32), t(np.zeros(b, bool), bool),
    )
    trial = (*ref, t(new_cost), t(g * 0.5 + 1.0), t(jtj * 0.9))
    out = K34.commit(LM_CFG, *state, *trial)
    out_ref = K34.commit_plain(LM_CFG, *state, *trial)
    torch.cuda.synchronize()
    for x, y in zip(out, out_ref):
        assert x.dtype == y.dtype
        if x.is_floating_point():
            assert _norm_err(x, y) <= 1e-6
        else:
            assert torch.equal(x, y)
    for k in range(10):  # the done lane passes through bit for bit
        assert torch.equal(out[k][0], state[k][0])
    assert int(out[8][2]) == K34.TERM_NUMERIC_FAILURE and int(out[8][3]) == K34.TERM_GRADIENT_TOL


def test_step_on_the_card_launches_every_kernel(card):
    from nav2_social_mpc_controller_tpu_torch.controller.controller import make_step_batch

    cfg = C.benchmark_obstacle_only_config()
    cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer, max_iterations=5))
    sc = scenario_from_numpy(make_scenario_batch(cfg, 4, base_seed=3), device=card)
    _build.reset_launch_counts()
    cmd, aux, _ = make_step_batch(cfg, device=card)(sc, make_carry(cfg, 4, device=card))
    torch.cuda.synchronize()
    assert all(n > 0 for n in _build.launch_counts.values()), _build.launch_counts
    assert torch.isfinite(cmd.linear_x).all() and bool(aux.solve.usable.all())
