"""Fused LM iteration: analytic residual + Jacobian -> (cost, g, JtJ) without
autodiff, with CUDA kernel K2 (``csrc/fused_iter.cu``) on the card.

Counterpart of the JAX package's ``ops/fused_iter.py``. One evaluation is

  1. the rollout-sample kernel (ops/rollout_cuda.py ``rollout_sample``):
     K6's rollout + analytic sensitivities (the unicycle rollout is linear in
     the per-step integrands, so d(poses)/du is itself a set of prefix sums)
     with K1's costmap value + row/col derivatives at the rollout front
     points, in one launch;
  2. kernel K2 evaluating every critic's residual AND per-step gradient
     (costs/critic_grads.py), chain-contracting them against the
     sensitivities, and accumulating cost, g = J^T r and JtJ = J^T J — J is
     never materialised.

Residual semantics are those of the JAX package's
``controller.optimize.build_residual_fn`` (same masks, same ordering):
social work, agent angle, proxemics, velocity, goal-align, path-follow,
path-align, obstacle, plus the velocity-feasibility rows. The three people
stages are masked per scenario by ``present`` (a valid person after the FOV
filter) and read the projected agents where the SFM scan wrote them.

Layout: batch-major with the step axis innermost — (B, S) per-step arrays and
(B, NB, S) per-block sensitivities — so a warp of K2 reads contiguous memory.
"""

import copy
from typing import NamedTuple

import torch

from nav2_social_mpc_controller_tpu_torch import _build
from nav2_social_mpc_controller_tpu_torch.costs import critic_grads as cg
from nav2_social_mpc_controller_tpu_torch.costs import critics
from nav2_social_mpc_controller_tpu_torch.kernel_shapes import (
    GENERAL_MAX_STEPS,
    SHARED_BYTES_PER_BLOCK,
)
from nav2_social_mpc_controller_tpu_torch.models.motion import (
    block_index_sequence_dynamic,
    dynamic_horizon,
    expand_blocks,
)
from nav2_social_mpc_controller_tpu_torch.ops.rollout_cuda import (
    KERNEL_BLOCKS,
    check_blocks,
    rollout_prep,
    rollout_prep_plain,
    rollout_sample,
)
from nav2_social_mpc_controller_tpu_torch.world.grid import crop_grid_window


def can_fuse(cfg) -> bool:
    """Whether the fused evaluation alone covers the config: exactly the
    benchmark critic set. A config with latent critics (AngleCost /
    CurvatureCost) adds their term to it (ops/latent.py)."""
    w = cfg.optimizer.weights
    return w.pure_angle_weight == 0.0 and w.curvature_weight == 0.0


class FusedStatics(NamedTuple):
    """The configuration constants of one fused evaluation."""

    n_vf: int
    n_agents: int
    social_weight: float
    agent_angle_weight: float
    proxemics_weight: float
    distance_weight: float
    angle_weight: float
    velocity_weight: float
    goal_align_weight: float
    obstacle_weight: float
    velocity_feasibility_weight: float
    desired_linear_vel: float
    front_offset: float

    @staticmethod
    def from_config(cfg, dims) -> "FusedStatics":
        w = cfg.optimizer.weights
        return FusedStatics(
            n_vf=dims.n_vf,
            n_agents=cfg.n_agents,
            social_weight=w.social_weight,
            agent_angle_weight=w.agent_angle_weight,
            proxemics_weight=w.proxemics_weight,
            distance_weight=w.distance_weight,
            angle_weight=w.angle_weight,
            velocity_weight=w.velocity_weight,
            goal_align_weight=w.goal_align_weight,
            obstacle_weight=w.obstacle_weight,
            velocity_feasibility_weight=w.velocity_feasibility_weight,
            desired_linear_vel=cfg.optimizer.desired_linear_vel,
            front_offset=critics.FRONT_OFFSET,
        )


# The u-independent head of the agent-angle critic (closest-moving-agent
# selection, branch resolution, steering target), computed once per solve:
# agent_angle_precompute(pose0 (B, 3), agents_steps (B, S, N, 6)) ->
# (steer (B, S), active (B, S) bool).
agent_angle_precompute = critics.agent_angle_select


def rollout_with_sensitivities(u, pose0, dt: float, block_idx, n_blocks: int):
    """Unicycle prefix-sum rollout AND its analytic Jacobian wrt u, batched
    (the plain rollout prep, in the JAX function's output layout).

      theta_s        = theta0 + dt * cum(w)
      dtheta_s/dw_b  = dt * cum(E_b)
      x_s            = x0 + dt * cum(v * cos(theta_prev))
      dx_s/dv_b      = dt * cum(E_b * cos(theta_prev))
      dx_s/dw_b      = dt * cum(v * -sin(theta_prev) * dtheta_prev/dw_b)

    with E_b[s] = [block_idx[s] == b].

    u (B, NB, 2); pose0 (B, 3); block_idx (B, S). Returns
      poses (B, S+1, 3), vw (B, S, 2), tx, ty, tth (B, S, D) with D = 2*NB in
      u-major order [v0, w0, v1, w1, ...], eb (B, S, NB).
    """
    b, s = block_idx.shape
    eb = (block_idx[:, None, :] == torch.arange(n_blocks, device=u.device)[None, :, None]).to(u.dtype)
    dth = dt * torch.cumsum(eb, dim=2)
    r = rollout_prep_plain(
        u.reshape(b, -1), pose0, block_idx, pose0.new_zeros((b, 2)), pose0.new_ones((b,)),
        dt, 0.0, n_blocks,
    )
    poses = torch.cat(
        [pose0[:, None, :], torch.stack([r["px"], r["py"], r["pth"]], dim=-1)], dim=1
    )
    vw = expand_blocks(u, block_idx)

    def interleave(dv, dw):  # (B, NB, S) x2 -> (B, S, 2*NB)
        return torch.stack([dv, dw], dim=-1).permute(0, 2, 1, 3).reshape(b, s, 2 * n_blocks)

    tx = interleave(r["dxdv"], r["dxdw"])
    ty = interleave(r["dydv"], r["dydw"])
    tth = interleave(torch.zeros_like(dth), dth)
    return poses, vw, tx, ty, tth, eb.permute(0, 2, 1)


# ---------------------------------------------------------------------------
# K2: the fused critic + contraction function, plain and on the card.
# ---------------------------------------------------------------------------


def agent_list(agents):
    """(B, S, N, 6) projected agents -> the per-agent field tuples
    (ax, ay, ayaw, alv, avalid) costs/critic_grads.py takes."""
    return [
        (agents[:, :, k, 0], agents[:, :, k, 1], agents[:, :, k, 2], agents[:, :, k, 4],
         agents[:, :, k, 3] != -1.0)
        for k in range(agents.shape[2])
    ]


def fused_cost_g_jtj_plain(
    statics: FusedStatics,
    u, px, py, pth, v, dxdv, dydv, dxdw, dydw, dth, eb,
    val, drow, dcol, agents,
    m_step, m_vel, m_social, active, steer, refx, refy, scal, vfm,
):
    """Plain PyTorch version of kernel K2 (same arguments as
    ``fused_cost_g_jtj``): builds every residual row and its J row, then
    reduces. Returns (cost (B,), g (B, D), jtj (B, D, D))."""
    st = statics
    b, nb, s = dth.shape
    d = 2 * nb
    zero = torch.zeros_like(px)
    final_x, final_y, goal_yaw, inv_res = (scal[:, k : k + 1] for k in range(4))

    rows_r = []
    rows_j = []

    def add(r, grads, mask):
        gx, gy, gth, gv, _gw = grads
        if mask is not None:
            r = torch.where(mask, r, zero)
            gx, gy, gth, gv = (
                None if t is None else torch.where(mask, t, zero) for t in (gx, gy, gth, gv)
            )
        cv = torch.zeros_like(dth)  # (B, NB, S): columns of the v_b variables
        cw = torch.zeros_like(dth)  # columns of the w_b variables
        if gx is not None:
            cv = cv + gx[:, None] * dxdv + gy[:, None] * dydv
            cw = cw + gx[:, None] * dxdw + gy[:, None] * dydw
        if gth is not None:
            cw = cw + gth[:, None] * dth
        if gv is not None:
            cv = cv + gv[:, None] * eb
        rows_r.append(r)
        rows_j.append(torch.stack([cv, cw], dim=-1).permute(0, 2, 1, 3).reshape(b, s, d))

    # Residual order mirrors build_residual_fn of the JAX package.
    agents_k = agent_list(agents)
    add(*cg.social_work_grad(st.social_weight, px, py, pth, v, agents_k), m_social)
    # `active` is prefolded with the social mask
    add(*cg.agent_angle_grad(st.agent_angle_weight, pth, steer, active), None)
    add(*cg.proxemics_grad(st.proxemics_weight, px, py, agents_k), m_social)
    add(*cg.velocity_grad(st.velocity_weight, st.desired_linear_vel, v, m_vel), None)
    add(*cg.goal_align_grad(st.goal_align_weight, goal_yaw, pth), m_step)
    add(*cg.distance_grad(st.distance_weight, px, py, final_x, final_y), m_step)
    add(*cg.distance_grad(st.angle_weight, px, py, refx, refy), m_step)
    add(
        *cg.obstacle_grad(st.obstacle_weight, val, drow, dcol, pth, inv_res, st.front_offset),
        m_step,
    )

    # Velocity-feasibility rows between consecutive blocks: residuals and
    # Jacobian live directly in u-space.
    wvf = st.velocity_feasibility_weight
    for q in range(st.n_vf):
        dv = u[:, 2 * q + 2] - u[:, 2 * q]
        dw = u[:, 2 * q + 3] - u[:, 2 * q + 1]
        mask = vfm[:, q]
        z = torch.zeros_like(dv)
        r = torch.where(mask, wvf * (dv * dv + dw * dw), z)
        jrow = u.new_zeros((b, d))
        jrow[:, 2 * q] = torch.where(mask, -2.0 * wvf * dv, z)
        jrow[:, 2 * q + 1] = torch.where(mask, -2.0 * wvf * dw, z)
        jrow[:, 2 * q + 2] = torch.where(mask, 2.0 * wvf * dv, z)
        jrow[:, 2 * q + 3] = torch.where(mask, 2.0 * wvf * dw, z)
        rows_r.append(r[:, None])
        rows_j.append(jrow[:, None, :])

    r_all = torch.cat(rows_r, dim=1)  # (B, R)
    j_all = torch.cat(rows_j, dim=1)  # (B, R, D)
    cost = 0.5 * (r_all * r_all).sum(1)
    g = (j_all * r_all[:, :, None]).sum(1)
    jtj = (j_all[:, :, :, None] * j_all[:, :, None, :]).sum(1)
    # Mirror the upper triangle, as the kernel does: exactly symmetric.
    jtj = torch.triu(jtj) + torch.triu(jtj, 1).transpose(1, 2)
    return cost, g, jtj


def _batch_stride(name, t, nb, s, device):
    """Batch stride of a (B, NB, S) float32 tensor on `device` whose inner
    (NB, S) block is contiguous (a slice of a taller stack is fine)."""
    if (
        t.device != device or t.dtype != torch.float32 or t.ndim != 3
        or t.shape[1:] != (nb, s) or t.stride(2) != 1 or t.stride(1) != s
    ):
        raise ValueError(
            f"fused_cost_g_jtj: {name} must be float32 CUDA (B, {nb}, {s}) with a "
            f"contiguous inner block, got {tuple(t.shape)} strides {t.stride()} "
            f"{t.dtype} on {t.device}"
        )
    return t.stride(0)


def _agent_strides(agents, b, s, n, device):
    """(batch, step, agent) strides of the (B, S, N, 6) float32 agents tensor
    on `device`, whose 6 fields must be adjacent; any other stride is taken
    as given (a view into the SFM scan's (B, S+1, N, 6) output is fine)."""
    if (
        agents.device != device or agents.dtype != torch.float32
        or tuple(agents.shape) != (b, s, n, 6) or agents.stride(3) != 1
    ):
        raise ValueError(
            f"fused_cost_g_jtj: agents must be float32 CUDA ({b}, {s}, {n}, 6) with "
            f"adjacent fields, got {tuple(agents.shape)} strides {agents.stride()} "
            f"{agents.dtype} on {agents.device}"
        )
    return agents.stride(0), agents.stride(1), agents.stride(2)


def fused_cost_g_jtj(
    statics: FusedStatics,
    u, px, py, pth, v, dxdv, dydv, dxdw, dydw, dth, eb,
    val, drow, dcol, agents,
    m_step, m_vel, m_social, active, steer, refx, refy, scal, vfm,
):
    """cost, g = J^T r and JtJ = J^T J of the whole critic stack.

    u (B, D); px, py, pth, v, val, drow, dcol, steer, refx, refy (B, S)
    float; dxdv, dydv, dxdw, dydw, dth, eb (B, NB, S); agents (B, S, N, 6),
    the projected people at step i+1; m_step, m_vel, m_social, active (B, S)
    bool (m_vel and active prefolded with the step / social mask); scal
    (B, 4) [final_x, final_y, goal_yaw, 1/resolution]; vfm (B, n_vf) bool.
    Returns (cost (B,), g (B, D), jtj (B, D, D)).

    CUDA tensors launch kernel K2 (float32 only): its templated form at
    NB = 1..6, its general form (``csrc/fused_general.cu``, counted as
    ``fused_iter_general``) above, up to kernel_shapes.GENERAL_MAX_BLOCKS;
    CPU tensors take the plain version."""
    args = (u, px, py, pth, v, dxdv, dydv, dxdw, dydw, dth, eb,
            val, drow, dcol, agents,
            m_step, m_vel, m_social, active, steer, refx, refy, scal, vfm)
    if not u.is_cuda:
        return fused_cost_g_jtj_plain(statics, *args)
    b, nb, s = dth.shape
    d = 2 * nb
    kernel = _build.counter_name("fused_iter", check_blocks("fused_cost_g_jtj", nb))
    if kernel != "fused_iter" and s > GENERAL_MAX_STEPS:
        raise ValueError(
            f"fused_cost_g_jtj: the general form takes S up to {GENERAL_MAX_STEPS} steps (a "
            f"step's 15 sums beside a one-step tile of its staged columns in one block's "
            f"shared memory, {SHARED_BYTES_PER_BLOCK} bytes), got {s}")
    f32 = torch.float32
    spec = [("u", u, f32, (b, d)), ("scal", scal, f32, (b, 4)),
            ("dth", dth, f32, (b, nb, s)), ("eb", eb, f32, (b, nb, s)),
            ("vfm", vfm, torch.bool, (b, statics.n_vf))]
    spec += [(n, t, torch.bool, (b, s)) for n, t in (
        ("m_step", m_step), ("m_vel", m_vel), ("m_social", m_social), ("active", active))]
    spec += [(n, t, f32, (b, s)) for n, t in (
        ("px", px), ("py", py), ("pth", pth), ("v", v), ("val", val), ("drow", drow),
        ("dcol", dcol), ("steer", steer), ("refx", refx), ("refy", refy))]
    for name, t, dtype, shape in spec:
        _build.check_tensor("fused_cost_g_jtj", name, t, dtype, shape, u.device)
    strides = [
        _batch_stride(n, t, nb, s, u.device)
        for n, t in (("dxdv", dxdv), ("dydv", dydv), ("dxdw", dxdw), ("dydw", dydw))
    ]
    agent_strides = _agent_strides(agents, b, s, statics.n_agents, u.device)

    cost = torch.empty((b,), device=u.device, dtype=u.dtype)
    g = torch.empty((b, d), device=u.device, dtype=u.dtype)
    jtj = torch.empty((b, d, d), device=u.device, dtype=u.dtype)
    st = statics
    lib = _build.load()
    with torch.cuda.device(u.device):
        err = getattr(lib, f"social_mpc_{kernel}_f32")(
            u.data_ptr(), px.data_ptr(), py.data_ptr(), pth.data_ptr(), v.data_ptr(),
            dxdv.data_ptr(), dydv.data_ptr(), dxdw.data_ptr(), dydw.data_ptr(),
            *strides,
            dth.data_ptr(), eb.data_ptr(), val.data_ptr(), drow.data_ptr(), dcol.data_ptr(),
            agents.data_ptr(), *agent_strides,
            m_step.data_ptr(), m_vel.data_ptr(), m_social.data_ptr(), active.data_ptr(),
            steer.data_ptr(), refx.data_ptr(), refy.data_ptr(),
            scal.data_ptr(), vfm.data_ptr(),
            cost.data_ptr(), g.data_ptr(), jtj.data_ptr(),
            b, s, nb, st.n_vf, st.n_agents,
            st.social_weight, st.agent_angle_weight, st.proxemics_weight,
            st.distance_weight, st.angle_weight, st.velocity_weight,
            st.goal_align_weight, st.obstacle_weight, st.velocity_feasibility_weight,
            st.desired_linear_vel, st.front_offset,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(err, kernel)
    _build.launch_counts[kernel] += 1
    return cost, g, jtj


# ---------------------------------------------------------------------------
# Batched orchestration: the value_grad of one tick's problems.
# ---------------------------------------------------------------------------


def select_lanes(obj, lanes):
    """A shallow copy of obj with every tensor attribute (all of which carry
    the scenario axis first) gathered at `lanes`, an int64 index tensor."""
    out = copy.copy(obj)
    for name, value in vars(obj).items():
        if isinstance(value, torch.Tensor):
            setattr(out, name, value.index_select(0, lanes))
    return out


class ValueGrad:
    """value_grad(u) -> (cost, g, jtj) for one tick's batch of problems.

    The constructor does the u-INDEPENDENT prep once per tick, outside the LM
    loop: masks, the per-scenario dynamic horizon block map (h_dyn / bl_dyn
    shrink near the goal, optimizer.cpp:248-249), block one-hots and theta
    sensitivities, targets, the agent-angle selection, and the
    obstacle-window crop around pose_0. A call does the u-dependent part: the
    rollout-sample kernel (K6's rollout + sensitivities with K1's costmap
    sample), then K2.

    rows (B, maxsize, 6); n_rows (B,); people_proj (B, maxsize, N, 6), the
    SFM projection; present (B,) bool, whether the scenario has a valid
    person; costmap: core.types.Costmap.
    """

    def __init__(self, cfg, dims, rows, n_rows, people_proj, present, costmap):
        opt = cfg.optimizer
        self.dt = cfg.trajectorizer.time_step
        self.nb = dims.n_blocks
        self.statics = FusedStatics.from_config(cfg, dims)
        s = dims.s
        dtype = rows.dtype
        dev = rows.device

        self.pose0 = rows[:, 0, 0:3].contiguous()
        n_vel, h_dyn, bl_dyn = dynamic_horizon(n_rows, dims.horizon, dims.block_length)
        j = torch.arange(s, device=dev)
        block_idx = block_index_sequence_dynamic(s, h_dyn, bl_dyn)
        self.block_idx = block_idx.to(torch.int32).contiguous()
        self.m_step = (j[None, :] < n_vel[:, None]).contiguous()
        self.m_vel = ((j[None, :] < h_dyn[:, None]) & self.m_step).contiguous()
        self.m_social = (self.m_step & present[:, None]).contiguous()

        last = (n_rows.long() - 1).clamp(0, dims.maxsize - 1)
        last_row = torch.gather(rows, 1, last[:, None, None].expand(-1, 1, rows.shape[-1]))[:, 0]
        self.refx = rows[:, 1:, 0].contiguous()
        self.refy = rows[:, 1:, 1].contiguous()

        # The projected people at step i+1: a view into the scan's output,
        # never copied (K2 takes its strides).
        self.agents = people_proj[:, 1:]
        steer, active = agent_angle_precompute(self.pose0, self.agents)
        self.steer = steer.contiguous()
        self.active = (active & self.m_social).contiguous()

        # Obstacle-window crop (exactness is checked at the call boundary,
        # core/validate.py).
        self.win, self.win_origin = crop_grid_window(
            costmap.data, costmap.origin, costmap.resolution, rows[:, 0, 0:2],
            opt.obstacle_window_cells,
        )
        self.win = self.win.contiguous()
        self.win_origin = self.win_origin.contiguous()
        self.res = costmap.resolution.contiguous()
        self.scal = torch.stack(
            [last_row[:, 0], last_row[:, 1], last_row[:, 2], 1.0 / costmap.resolution], dim=1
        ).contiguous()

        self.eb = (
            block_idx[:, None, :] == torch.arange(self.nb, device=dev)[None, :, None]
        ).to(dtype).contiguous()  # (B, NB, S)
        self.dth = (self.dt * torch.cumsum(self.eb, dim=2)).contiguous()

        vf_step = torch.arange(dims.n_vf, device=dev) + 1
        self.vfm = (
            (vf_step[None, :] < (h_dyn // bl_dyn)[:, None]) & (vf_step[None, :] < n_vel[:, None])
        ).contiguous()

    def select(self, lanes):
        """This value_grad restricted to the scenarios `lanes` (an int64
        index tensor): every per-scenario tensor gathered, the agents view
        included (a gathered copy; K2 takes its strides). Every kernel works
        scenario by scenario, so a gathered lane evaluates to the same bits."""
        return select_lanes(self, lanes)

    def prep_inputs(self, u):
        """K6's argument tuple at decision vector u."""
        return (u, self.pose0, self.block_idx, self.win_origin, self.res, self.dt,
                critics.FRONT_OFFSET, self.nb)

    def bicubic_inputs(self, u):
        """(rollout dict, win, row, col): K1's inputs at u (runs K6)."""
        r = rollout_prep(*self.prep_inputs(u))
        return r, self.win, r["row"], r["col"]

    def fused_inputs(self, u):
        """K2's full argument tuple at u (runs the rollout-sample kernel)."""
        r = rollout_sample(self.win, *self.prep_inputs(u))
        return (
            self.statics, u, r["px"], r["py"], r["pth"], r["v"],
            r["dxdv"], r["dydv"], r["dxdw"], r["dydw"], self.dth, self.eb,
            r["val"], r["d_row"], r["d_col"], self.agents,
            self.m_step, self.m_vel, self.m_social, self.active, self.steer,
            self.refx, self.refy, self.scal, self.vfm,
        )

    def __call__(self, u):
        return fused_cost_g_jtj(*self.fused_inputs(u))


def build_value_grad(cfg, dims, rows, n_rows, people_proj, present, costmap) -> ValueGrad:
    """value_grad(u (B, D)) -> (cost, g, jtj) for lm_solve, closing over one
    tick's scenario data."""
    return ValueGrad(cfg, dims, rows, n_rows, people_proj, present, costmap)
