"""The port's seven CUDA kernels against their plain PyTorch versions ON THE
CARD, at small shapes chosen for their corner cases (border-clamped and NaN
coordinates, masked steps and shrunk horizons, scenarios with and without
valid people, an agent exactly on the robot, a system that is not positive
definite, frozen done lanes, every termination code).

These tests need an NVIDIA GPU and nvcc and skip where there is none. They
import only torch, NumPy and the port, so on a machine with a card they run
without the JAX package's test harness:

    python -m pytest tests/test_torch_gpu_kernels.py -q --noconftest -p no:cacheprovider

Tolerances: nvcc contracts a*b+c into FMA in K1/K2 and K2 reduces across a
warp in another order than the plain version, so those agree to float32
rounding of their sums (1e-5 / 1e-4, scale-normalised; with the people
stages' exp/atan2 chains 3e-5, the JAX package's figure for its fused
kernel); K6 sums in the plain version's order and is held to the JAX
package's figures for its rollout kernel (rtol 2e-5, atol 1e-5; 2e-4 on
row/col, which reach 64 cells), its copied controls exact; K3/K4 are written
with round-to-nearest intrinsics and repeat the plain version operation for
operation, so they are held to 1e-6 and their discrete outputs to equality;
K3's step and K7's solution (the Cholesky solve both share, csrc/chol.cuh)
are held to equality of bits.
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


@pytest.mark.parametrize(
    "name", ["benchmark_social_config", "benchmark_omni_6agents_config", "benchmark_stress_h36_config"])
def test_fused_kernel_with_people_matches_plain(card, name):
    """The three people stages: a batch in which the FOV filter leaves some
    scenarios without a person (their stages must not run), padded agent
    slots, near-goal plans, and one scenario with an agent exactly on the
    rolled-out robot (the `tiny` branch of the social force)."""
    cfg = getattr(C, name)()
    prep, vg, st, _ = _problem(cfg, card, batch=24, n_valid_people=cfg.n_agents - 1)
    present = vg.m_social.any(dim=1)
    assert bool(present.any()) and not bool(present.all())
    args = list(vg.fused_inputs(st.u))
    k = int(torch.nonzero(present)[0])
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


@pytest.mark.parametrize("nb,s", [(3, 29), (6, 39)])
def test_rollout_prep_kernel_matches_plain(card, nb, s):
    """K6 against its plain version with a different block map in every
    scenario (h_dyn / bl_dyn shrink near the goal); batch 45 leaves the last
    block partly empty."""
    from nav2_social_mpc_controller_tpu_torch.models.motion import block_index_sequence_dynamic

    rng = np.random.default_rng(nb)
    b = 45
    h_dyn = rng.integers(1, 6 * nb + 1, b)
    h_dyn[0] = 6 * nb
    bl_dyn = np.minimum(6, h_dyn)
    block_idx = block_index_sequence_dynamic(
        s, torch.tensor(h_dyn, device=card), torch.tensor(bl_dyn, device=card)).to(torch.int32)
    assert len({tuple(r) for r in block_idx.tolist()}) >= 3

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
    with pytest.raises(ValueError):
        K6.rollout_prep(u, pose0, block_idx.long(), origin, res, 0.05, 0.25, nb)


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
        assert _norm_err(x, y) == 0.0  # bit-equal: the shared Cholesky of csrc/chol.cuh
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


@pytest.mark.parametrize("d", [6, 12])
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
    assert _norm_err(got, ref) == 0.0  # the same arithmetic, operation for operation
    ok = np.arange(n) != 7
    x64 = np.linalg.solve(a[ok], b[ok][..., None])[..., 0]
    # float32 Cholesky of systems with condition numbers up to ~1e3
    np.testing.assert_allclose(got.cpu().numpy()[ok], x64, rtol=2e-3, atol=2e-4)


def test_spd_solve_refuses_other_sizes_on_the_card(card):
    a = torch.eye(5, device=card).expand(4, 5, 5).contiguous()
    with pytest.raises(ValueError, match="D in"):
        K7.spd_solve(a, torch.ones((4, 5), device=card))
    with pytest.raises(ValueError, match="float32"):
        K7.spd_solve(torch.eye(6, device=card, dtype=torch.float64).expand(4, 6, 6).contiguous(),
                     torch.ones((4, 6), device=card, dtype=torch.float64))


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
    default_path = {k: n for k, n in _build.launch_counts.items() if k != "spd_solve"}
    assert all(n > 0 for n in default_path.values()), _build.launch_counts
    assert _build.launch_counts["spd_solve"] == 0  # K7 belongs to the general iteration
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
