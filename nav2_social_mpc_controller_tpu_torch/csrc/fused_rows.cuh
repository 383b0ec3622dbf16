// The critics of one fused evaluation, step by step: shared by K2's
// templated form (fused_iter.cu) and its general form (fused_general.cu),
// so that the critics have one source. For every step of a scenario,
// step_rows evaluates each critic's residual and its per-step partials
// (gx, gy, gth, gv) wrt the step's pose and velocity, in the residual order
// and under the masks of the JAX package's build_residual_fn: social work,
// agent angle, proxemics, velocity, goal-align, path-follow distance,
// path-align distance, obstacle. What a kernel does with a row (contract
// it against the step's sensitivities at once, or sum the step's p p^T) is
// its own.
//
// The three people stages read the N projected agents of step i+1 where the
// SFM scan (K5) wrote them (pointer + strides, no copy) and run only for
// steps whose m_social mask is set, so a scenario without a valid person
// costs what it cost without them. The social-work gradient is a 4-tangent
// forward pass (struct Dual4) that repeats ops/dual4.py and
// costs/critic_grads.py operation for operation, with dense tangents where
// Python skips symbolic zeros: 0 * x and x + 0 are exact for finite x, so
// the two differ only for non-finite primals. A social step runs the people
// stages first, before its sensitivities are loaded: the robot's duals
// once, then per agent k = 0..N-1 the force on the robot from the agent and
// the force on the agent's slot from the robot. The two are independent
// chains with no branch between them, so the scheduler interleaves them;
// the force on the robot from an invalid agent is computed and selected
// away (d4_where), as in the reference, because a branch around it would
// serialise the two chains.
//
// The angle wrap is atan2f(sinf(a), cosf(a)), the reference's wrapAngle.

#pragma once

#include <cuda_runtime.h>

namespace fused {

struct FusedArgs {
    const float* u;
    const float* px; const float* py; const float* pth; const float* v;
    const float* dxdv; const float* dydv; const float* dxdw; const float* dydw;
    int bs_dxdv, bs_dydv, bs_dxdw, bs_dydw;
    const float* dth; const float* eb;
    const float* val; const float* drow; const float* dcol;
    const float* agents;  // (B, S, N, 6) view: strides in floats, fields adjacent
    int as_b, as_s, as_n;
    const unsigned char* m_step; const unsigned char* m_vel;
    const unsigned char* m_social; const unsigned char* active;
    const float* steer;
    const float* refx; const float* refy;
    const float* scal;
    const unsigned char* vfm;
    float* cost; float* g; float* jtj;
    int B, S, n_vf, N;
    float w_social, w_agent_angle, w_proxemics;
    float w_distance, w_angle, w_velocity, w_goal_align, w_obstacle, w_vf;
    float desired_vel, front_offset;
};

__device__ __forceinline__ float wrap_angle(float a) {
    return atan2f(sinf(a), cosf(a));
}


// ---------------------------------------------------------------------------
// Forward duals with the tangent basis (d/dx, d/dy, d/dyaw, d/dv): the rules
// of ops/dual4.py in the same operation order.
// ---------------------------------------------------------------------------

struct Dual4 { float p; float t[4]; };

__device__ __forceinline__ Dual4 d4_const(float p) {
    return Dual4{p, {0.0f, 0.0f, 0.0f, 0.0f}};
}

__device__ __forceinline__ Dual4 d4_seed(float p, int k) {
    Dual4 r = d4_const(p);
    r.t[k] = 1.0f;
    return r;
}

__device__ __forceinline__ Dual4 d4_add(const Dual4& a, const Dual4& b) {
    Dual4 r;
    r.p = a.p + b.p;
#pragma unroll
    for (int k = 0; k < 4; ++k) r.t[k] = a.t[k] + b.t[k];
    return r;
}

__device__ __forceinline__ Dual4 d4_sub(const Dual4& a, const Dual4& b) {
    Dual4 r;
    r.p = a.p - b.p;
#pragma unroll
    for (int k = 0; k < 4; ++k) r.t[k] = a.t[k] - b.t[k];
    return r;
}

__device__ __forceinline__ Dual4 d4_mul(const Dual4& a, const Dual4& b) {
    Dual4 r;
    r.p = a.p * b.p;
#pragma unroll
    for (int k = 0; k < 4; ++k) r.t[k] = a.t[k] * b.p + a.p * b.t[k];
    return r;
}

__device__ __forceinline__ Dual4 d4_scale(const Dual4& a, float c) {
    Dual4 r;
    r.p = a.p * c;
#pragma unroll
    for (int k = 0; k < 4; ++k) r.t[k] = a.t[k] * c;
    return r;
}

__device__ __forceinline__ Dual4 d4_neg(const Dual4& a) {
    Dual4 r;
    r.p = -a.p;
#pragma unroll
    for (int k = 0; k < 4; ++k) r.t[k] = -a.t[k];
    return r;
}

// ((-pa * inv) * inv) * tb, left to right as in ops/dual4.py: inv * inv alone
// is never formed, so the 1e-30 floor of the interaction length (inv = 1e30)
// does not overflow by itself.
__device__ __forceinline__ Dual4 d4_div(const Dual4& a, const Dual4& b) {
    const float inv = 1.0f / b.p;
    Dual4 r;
    r.p = a.p * inv;
#pragma unroll
    for (int k = 0; k < 4; ++k) r.t[k] = a.t[k] * inv + ((-a.p * inv) * inv) * b.t[k];
    return r;
}

__device__ __forceinline__ Dual4 d4_exp(const Dual4& a) {
    const float e = expf(a.p);
    Dual4 r;
    r.p = e;
#pragma unroll
    for (int k = 0; k < 4; ++k) r.t[k] = e * a.t[k];
    return r;
}

__device__ __forceinline__ Dual4 d4_sqrt(const Dual4& a) {
    const float root = sqrtf(a.p);
    const float half_inv = 0.5f / root;
    Dual4 r;
    r.p = root;
#pragma unroll
    for (int k = 0; k < 4; ++k) r.t[k] = half_inv * a.t[k];
    return r;
}

// cos and sin of a dual, given s = sinf(a.p) and c = cosf(a.p).
__device__ __forceinline__ Dual4 d4_cos(const Dual4& a, float s, float c) {
    Dual4 r;
    r.p = c;
#pragma unroll
    for (int k = 0; k < 4; ++k) r.t[k] = -s * a.t[k];
    return r;
}

__device__ __forceinline__ Dual4 d4_sin(const Dual4& a, float s, float c) {
    Dual4 r;
    r.p = s;
#pragma unroll
    for (int k = 0; k < 4; ++k) r.t[k] = c * a.t[k];
    return r;
}

// d atan2(y, x) = (x dy - y dx) / (x^2 + y^2)
__device__ __forceinline__ Dual4 d4_atan2(const Dual4& y, const Dual4& x) {
    const float denom = x.p * x.p + y.p * y.p;
    Dual4 r;
    r.p = atan2f(y.p, x.p);
#pragma unroll
    for (int k = 0; k < 4; ++k) r.t[k] = x.p / denom * y.t[k] + (-y.p / denom) * x.t[k];
    return r;
}

// A select, never arithmetic: a NaN tangent on the side not taken is dropped.
// Component by component, so no operand has to be addressable.
__device__ __forceinline__ Dual4 d4_where(bool c, const Dual4& a, const Dual4& b) {
    Dual4 r;
    r.p = c ? a.p : b.p;
#pragma unroll
    for (int k = 0; k < 4; ++k) r.t[k] = c ? a.t[k] : b.t[k];
    return r;
}

// SocialWorkCost constants (costs/critics.py)
constexpr float SW_LAMBDA = 2.0f;
constexpr float SW_GAMMA = 0.35f;
constexpr float SW_NPRIME = 3.0f;
constexpr float SW_N = 2.0f;
constexpr float SW_FORCE_FACTOR_SOCIAL = 2.1f;
constexpr float PROXEMICS_ALPHA = 3.0f;
constexpr float PROXEMICS_INV_D0SQ = 1.0f / (0.5f * 0.5f);

// computeSocialForce for one (me <- other) pair: critic_grads._social_pair_force.
// An agent exactly on the robot (dnorm = 0) has NaN sqrt tangents, which the
// `tiny` selects drop. An interaction vector of exactly zero length takes the
// 1e-30 floor, its direction is (0, 0), and the atan2 tangent divides 0 by 0:
// NaN partials, in the plain version and the JAX package as here.
__device__ __forceinline__ void social_pair_force(
    const Dual4& mx, const Dual4& my, const Dual4& mvx, const Dual4& mvy,
    const Dual4& ox, const Dual4& oy, const Dual4& ovx, const Dual4& ovy,
    Dual4& fx, Dual4& fy) {
    Dual4 dx = d4_sub(mx, ox);
    Dual4 dy = d4_sub(my, oy);
    Dual4 dnorm = d4_sqrt(d4_add(d4_mul(dx, dx), d4_mul(dy, dy)));
    const bool tiny = dnorm.p < 1e-6f;
    const Dual4 eps = d4_const(1e-6f);
    dx = d4_where(tiny, eps, dx);
    dy = d4_where(tiny, d4_const(0.0f), dy);
    dnorm = d4_where(tiny, eps, dnorm);
    const Dual4 ddx = d4_div(dx, dnorm);
    const Dual4 ddy = d4_div(dy, dnorm);

    const Dual4 ix = d4_add(d4_scale(d4_sub(mvx, ovx), SW_LAMBDA), ddx);
    const Dual4 iy = d4_add(d4_scale(d4_sub(mvy, ovy), SW_LAMBDA), ddy);
    Dual4 ilen = d4_sqrt(d4_add(d4_mul(ix, ix), d4_mul(iy, iy)));
    ilen = d4_where(ilen.p > 1e-30f, ilen, d4_const(1e-30f));
    const Dual4 idx = d4_div(ix, ilen);
    const Dual4 idy = d4_div(iy, ilen);

    Dual4 theta = d4_sub(d4_atan2(ddy, ddx), d4_atan2(idy, idx));
    theta.p = wrap_angle(theta.p);  // wrap' = 1

    const Dual4 b = d4_scale(ilen, SW_GAMMA);
    const Dual4 d_over_b = d4_div(dnorm, b);
    const Dual4 bt = d4_mul(b, theta);
    const Dual4 bt3 = d4_scale(bt, SW_NPRIME);
    const Dual4 fvel = d4_neg(d4_exp(d4_neg(d4_add(d_over_b, d4_mul(bt3, bt3)))));
    const float sign = theta.p > 0.0f ? 1.0f : -1.0f;  // no zero case
    const Dual4 bt2 = d4_scale(bt, SW_N);
    const Dual4 e_ang = d4_exp(d4_neg(d4_add(d_over_b, d4_mul(bt2, bt2))));
    const Dual4 fang = d4_scale(d4_scale(e_ang, -1.0f), sign);

    const Dual4 lnx = d4_neg(idy);
    fx = d4_scale(d4_add(d4_mul(fvel, idx), d4_mul(fang, lnx)), SW_FORCE_FACTOR_SOCIAL);
    fy = d4_scale(d4_add(d4_mul(fvel, idy), d4_mul(fang, idx)), SW_FORCE_FACTOR_SOCIAL);
}

struct StageOut { float r, gx, gy, gth, gv; };

// Social work: w * (||SF(robot <- valid agents)||^2 + sum over EVERY slot j
// of ||SF(agent_j <- robot)||^2 + 1e-6) and its partials wrt (x, y, yaw, v):
// critic_grads.social_work_grad. `ag` points at this step's first agent;
// agent k is at ag + k * stride with fields [x, y, yaw, t, lv, .].
__device__ __forceinline__ StageOut social_stage(float weight, float px, float py, float pth,
                                                 float v, const float* ag, int stride, int n) {
    const float s = sinf(pth), c = cosf(pth);
    const Dual4 dpx = d4_seed(px, 0);
    const Dual4 dpy = d4_seed(py, 1);
    const Dual4 dyaw = d4_seed(pth, 2);
    const Dual4 dv = d4_seed(v, 3);
    const Dual4 rvx = d4_mul(dv, d4_cos(dyaw, s, c));
    const Dual4 rvy = d4_mul(dv, d4_sin(dyaw, s, c));

    Dual4 sfx = d4_const(0.0f), sfy = d4_const(0.0f), wp = d4_const(0.0f);
    for (int k = 0; k < n; ++k) {
        const float* q = ag + (size_t)k * stride;
        const float ayaw = q[2], alv = q[4];
        const Dual4 ax = d4_const(q[0]), ay = d4_const(q[1]);
        const Dual4 avx = d4_const(alv * cosf(ayaw)), avy = d4_const(alv * sinf(ayaw));
        // force on the robot from this agent, counted when the agent is valid
        const bool valid = q[3] != -1.0f;
        Dual4 fx, fy;
        social_pair_force(dpx, dpy, rvx, rvy, ax, ay, avx, avy, fx, fy);
        sfx = d4_add(sfx, d4_where(valid, fx, d4_const(0.0f)));
        sfy = d4_add(sfy, d4_where(valid, fy, d4_const(0.0f)));
        // force on this slot (valid or not) from the robot alone
        social_pair_force(ax, ay, avx, avy, dpx, dpy, rvx, rvy, fx, fy);
        wp = d4_add(wp, d4_add(d4_mul(fx, fx), d4_mul(fy, fy)));
    }
    const Dual4 wr = d4_add(d4_mul(sfx, sfx), d4_mul(sfy, sfy));
    const Dual4 total = d4_scale(d4_add(d4_add(wr, wp), d4_const(1e-6f)), weight);
    return StageOut{total.p, total.t[0], total.t[1], total.t[2], total.t[3]};
}

// Proxemics: w * alpha * exp(-min_valid_dist^2 / d0^2); a strict `<` scan
// keeps the first minimum, and no valid agent forces r, gx, gy to 0 (no
// exp(-inf) * 0 is formed).
__device__ __forceinline__ StageOut proxemics_stage(float weight, float px, float py,
                                                    const float* ag, int stride, int n) {
    float best_sq = 0.0f, best_dx = 0.0f, best_dy = 0.0f;
    bool any_valid = false;
    for (int k = 0; k < n; ++k) {
        const float* q = ag + (size_t)k * stride;
        const bool valid = q[3] != -1.0f;
        const float dx = px - q[0], dy = py - q[1];
        const float sq = valid ? dx * dx + dy * dy : __int_as_float(0x7f800000);  // +inf
        if (k == 0 || sq < best_sq) {
            best_sq = sq;
            best_dx = dx;
            best_dy = dy;
        }
        any_valid = any_valid || valid;
    }
    if (!any_valid) return StageOut{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    const float r = weight * PROXEMICS_ALPHA * expf(-best_sq * PROXEMICS_INV_D0SQ);
    const float c = -2.0f * PROXEMICS_INV_D0SQ * r;
    return StageOut{r, c * best_dx, c * best_dy, 0.0f, 0.0f};
}

// Which per-step partials a residual row has; an absent one is skipped,
// never multiplied.
template <bool XY_, bool TH_, bool V_>
struct Partials {
    static constexpr bool XY = XY_, TH = TH_, V = V_;
};

// A scenario's constants the rows read: the path's final point, the goal's
// yaw, 1/resolution.
struct ScenarioConsts {
    float final_x, final_y, goal_yaw, inv_res;
};

__device__ __forceinline__ ScenarioConsts scenario_consts(const FusedArgs& a, int b) {
    return ScenarioConsts{a.scal[4 * b + 0], a.scal[4 * b + 1], a.scal[4 * b + 2],
                          a.scal[4 * b + 3]};
}

// The residual rows of step s of scenario b. A step that neither m_step nor
// m_vel holds has none, and nothing is called. Otherwise the people stages
// run first; then `sensitivities()` is called once (where a caller loads the
// step's sensitivities, so that they are not live during the stages), then
// row(Partials<XY, TH, V>{}, r, gx, gy, gth, gv) once for each row, in the
// residual order.
template <typename Sens, typename Row>
__device__ __forceinline__ void step_rows(const FusedArgs& a, int b, int s,
                                          const ScenarioConsts& c, Sens sensitivities, Row row) {
    const size_t i = (size_t)b * a.S + s;
    const bool m_step = a.m_step[i] != 0;
    const bool m_vel = a.m_vel[i] != 0;
    if (!m_step && !m_vel) return;
    const float px = a.px[i], py = a.py[i], pth = a.pth[i];

    // The people stages' numbers first, before the sensitivities are live.
    // m_social implies m_step, and active implies m_social.
    const bool m_social = a.m_social[i] != 0;
    const bool active = a.active[i] != 0;
    StageOut social{}, prox{};
    if (m_social) {
        const float* ag = a.agents + (size_t)b * a.as_b + (size_t)s * a.as_s;
        social = social_stage(a.w_social, px, py, pth, a.v[i], ag, a.as_n, a.N);
        prox = proxemics_stage(a.w_proxemics, px, py, ag, a.as_n, a.N);
    }

    sensitivities();

    if (m_social) {
        row(Partials<true, true, true>{}, social.r, social.gx, social.gy, social.gth, social.gv);
        if (active) {  // agent angle: w * wrap(yaw - steer)^2
            const float ang = wrap_angle(pth - a.steer[i]);
            row(Partials<false, true, false>{}, a.w_agent_angle * ang * ang, 0.0f, 0.0f,
                2.0f * a.w_agent_angle * ang, 0.0f);
        }
        row(Partials<true, false, false>{}, prox.r, prox.gx, prox.gy, 0.0f, 0.0f);
    }
    if (m_vel) {  // velocity: w * (v_des - v)^2 inside the horizon
        const float diff = a.desired_vel - a.v[i];
        row(Partials<false, false, true>{}, a.w_velocity * diff * diff, 0.0f, 0.0f, 0.0f,
            -2.0f * a.w_velocity * diff);
    }
    if (m_step) {
        {  // goal align: w * wrap(goal_yaw - yaw)^2
            const float w = wrap_angle(c.goal_yaw - pth);
            row(Partials<false, true, false>{}, a.w_goal_align * w * w, 0.0f, 0.0f,
                -2.0f * a.w_goal_align * w, 0.0f);
        }
        {  // path follow: w * ||p - final||^4
            const float dx = px - c.final_x, dy = py - c.final_y;
            const float sq = dx * dx + dy * dy;
            const float k = 4.0f * a.w_distance * sq;
            row(Partials<true, false, false>{}, a.w_distance * sq * sq, k * dx, k * dy, 0.0f,
                0.0f);
        }
        {  // path align: angle_weight * ||p - ref_{i+1}||^4
            const float dx = px - a.refx[i], dy = py - a.refy[i];
            const float sq = dx * dx + dy * dy;
            const float k = 4.0f * a.w_angle * sq;
            row(Partials<true, false, false>{}, a.w_angle * sq * sq, k * dx, k * dy, 0.0f, 0.0f);
        }
        {  // obstacle: w * bicubic(front point), chained through K1's partials
            const float val = a.val[i], drow = a.drow[i], dcol = a.dcol[i];
            const float gx = a.w_obstacle * dcol * c.inv_res;
            const float gy = a.w_obstacle * drow * c.inv_res;
            const float gth = a.w_obstacle *
                (dcol * (-a.front_offset * sinf(pth) * c.inv_res) +
                 drow * (a.front_offset * cosf(pth) * c.inv_res));
            row(Partials<true, true, false>{}, a.w_obstacle * val, gx, gy, gth, 0.0f);
        }
    }
}

}  // namespace fused
