// K2: fused critics + chain contraction -> (cost, g = J^T r, JtJ = J^T J).
//
// Replaces the TPU kernel _fused_kernel of the JAX package's
// ops/fused_iter.py (public wrapper fused_cost_g_jtj). For every scenario it
// evaluates each critic's residual and per-step gradient (social work,
// agent angle, proxemics, velocity, goal-align, path-follow distance,
// path-align distance, obstacle), chain-contracts them against the rollout
// sensitivities column by column, and accumulates cost, g and JtJ; then adds
// the velocity-feasibility rows, whose Jacobian lives directly in u-space.
// The (R, D) Jacobian never exists. Residual order and masks follow the JAX
// package's build_residual_fn.
//
// The three people stages read the N projected agents of step i+1 where the
// SFM scan (K5) wrote them (pointer + strides, no copy) and run only for
// steps whose m_social mask is set, so a scenario without a valid person
// costs what it cost without them. The social-work gradient is a 4-tangent
// forward pass (struct Dual4) that repeats ops/dual4.py and
// costs/critic_grads.py operation for operation, with dense tangents where
// Python skips symbolic zeros: 0 * x and x + 0 are exact for finite x, so
// the two differ only for non-finite primals.
//
// What bounds it. People-free, a step reads (14 + 6*NB) floats and does a
// few hundred multiply-adds on them: bytes. With people, a social step adds
// 2*N pair forces, each a dependent chain of about 450 FP32 and 20 MUFU
// instructions (three atan2f, two expf, two sqrtf and a dozen IEEE
// divisions): the people stages are bound by instruction issue and by how
// much of the chains' latency the SM can hide.
//
// Design: one warp per scenario, four per block; lanes run over rollout steps
// (a lane loops when S > 32), each building its J columns in registers and
// keeping 1 + D + D(D+1)/2 partial sums; a butterfly of warp shuffles reduces
// them and lane 0 writes the outputs, JtJ in both triangles. A social step's
// lane runs the people stages first, inline, before its sensitivities are
// loaded: the robot's duals once, then per agent k = 0..N-1 the force on the
// robot from the agent and the force on the agent's slot from the robot.
// The two are independent chains with no branch between them, so the
// scheduler interleaves them; the force on the robot from an invalid agent is
// computed and selected away (d4_where), as in the reference, because a
// branch around it would serialise the two chains. Batch-major layout with
// the step axis innermost, so a warp's loads are contiguous; a scenario's
// outputs do not depend on its block or slot.
//
// The angle wrap is atan2f(sinf(a), cosf(a)), the reference's wrapAngle.
// nvcc contracts a*b+c into FMA and the warp reduction sums in another
// order than the plain PyTorch version, so the two agree to float32
// rounding of these sums, not bit for bit.

#include <cuda_runtime.h>

#include "kernel_shapes.h"

namespace {

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

template <int NB>
struct Acc {
    static constexpr int D = 2 * NB;
    static constexpr int NJ = D * (D + 1) / 2;
    float cost;
    float g[D];
    float jtj[NJ];  // upper triangle, row-major
};

template <int NB>
struct StepSens {  // one step's rollout sensitivities, per block
    float dxdv[NB], dydv[NB], dxdw[NB], dydw[NB], dth[NB], eb[NB];
};

// Index of (d1 <= d2) in the packed upper triangle of a D x D matrix.
__host__ __device__ constexpr int tri(int d1, int d2, int D) {
    return d1 * D - d1 * (d1 - 1) / 2 + (d2 - d1);
}

// Add one residual row with per-step partials (gx, gy, gth, gv); the flags
// say which partials exist, so an absent one is skipped, never multiplied.
template <int NB, bool XY, bool TH, bool V>
__device__ __forceinline__ void accumulate(Acc<NB>& acc, const StepSens<NB>& t,
                                           float r, float gx, float gy,
                                           float gth, float gv) {
    constexpr int D = 2 * NB;
    float col[D];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
        float cv = 0.0f, cw = 0.0f;
        if (XY) {
            cv = gx * t.dxdv[b] + gy * t.dydv[b];
            cw = gx * t.dxdw[b] + gy * t.dydw[b];
        }
        if (TH) cw += gth * t.dth[b];
        if (V) cv += gv * t.eb[b];
        col[2 * b] = cv;
        col[2 * b + 1] = cw;
    }
    acc.cost += 0.5f * r * r;
#pragma unroll
    for (int d = 0; d < D; ++d) acc.g[d] += r * col[d];
#pragma unroll
    for (int d1 = 0; d1 < D; ++d1) {
#pragma unroll
        for (int d2 = d1; d2 < D; ++d2) acc.jtj[tri(d1, d2, D)] += col[d1] * col[d2];
    }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

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

// Instantiated for every NB of kernel_shapes.h's SOCIAL_MPC_BLOCKS (1..6). At
// NB = 1 there is no velocity-feasibility row (n_vf = 0, vfm never read); a
// partial last block (h = 7, bl = 4: NB = 2, n_vf = 0) reads only the
// n_vf rows its mask has.
template <int NB>
__global__ void fused_kernel(const FusedArgs a) {
    constexpr int D = 2 * NB;
    constexpr int NJ = D * (D + 1) / 2;
    const int b = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (b >= a.B) return;  // uniform across the warp
    const int S = a.S;

    Acc<NB> acc;
    acc.cost = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) acc.g[d] = 0.0f;
#pragma unroll
    for (int k = 0; k < NJ; ++k) acc.jtj[k] = 0.0f;

    const float final_x = a.scal[4 * b + 0];
    const float final_y = a.scal[4 * b + 1];
    const float goal_yaw = a.scal[4 * b + 2];
    const float inv_res = a.scal[4 * b + 3];

    for (int s = lane; s < S; s += 32) {
        const size_t i = (size_t)b * S + s;
        const bool m_step = a.m_step[i] != 0;
        const bool m_vel = a.m_vel[i] != 0;
        if (!m_step && !m_vel) continue;
        const float px = a.px[i], py = a.py[i], pth = a.pth[i];

        // The people stages' numbers first, before the sensitivities are
        // live. m_social implies m_step, and active implies m_social.
        const bool m_social = a.m_social[i] != 0;
        const bool active = a.active[i] != 0;
        StageOut social{}, prox{};
        if (m_social) {
            const float* ag = a.agents + (size_t)b * a.as_b + (size_t)s * a.as_s;
            social = social_stage(a.w_social, px, py, pth, a.v[i], ag, a.as_n, a.N);
            prox = proxemics_stage(a.w_proxemics, px, py, ag, a.as_n, a.N);
        }

        StepSens<NB> t;
#pragma unroll
        for (int k = 0; k < NB; ++k) {
            const size_t o = (size_t)k * S + s;
            t.dxdv[k] = a.dxdv[(size_t)b * a.bs_dxdv + o];
            t.dydv[k] = a.dydv[(size_t)b * a.bs_dydv + o];
            t.dxdw[k] = a.dxdw[(size_t)b * a.bs_dxdw + o];
            t.dydw[k] = a.dydw[(size_t)b * a.bs_dydw + o];
            t.dth[k] = a.dth[(size_t)b * NB * S + o];
            t.eb[k] = a.eb[(size_t)b * NB * S + o];
        }

        if (m_social) {
            accumulate<NB, true, true, true>(
                acc, t, social.r, social.gx, social.gy, social.gth, social.gv);
            if (active) {  // agent angle: w * wrap(yaw - steer)^2
                const float ang = wrap_angle(pth - a.steer[i]);
                accumulate<NB, false, true, false>(
                    acc, t, a.w_agent_angle * ang * ang, 0.0f, 0.0f,
                    2.0f * a.w_agent_angle * ang, 0.0f);
            }
            accumulate<NB, true, false, false>(acc, t, prox.r, prox.gx, prox.gy, 0.0f, 0.0f);
        }
        if (m_vel) {  // velocity: w * (v_des - v)^2 inside the horizon
            const float diff = a.desired_vel - a.v[i];
            accumulate<NB, false, false, true>(
                acc, t, a.w_velocity * diff * diff, 0.0f, 0.0f, 0.0f,
                -2.0f * a.w_velocity * diff);
        }
        if (m_step) {
            {  // goal align: w * wrap(goal_yaw - yaw)^2
                const float w = wrap_angle(goal_yaw - pth);
                accumulate<NB, false, true, false>(
                    acc, t, a.w_goal_align * w * w, 0.0f, 0.0f,
                    -2.0f * a.w_goal_align * w, 0.0f);
            }
            {  // path follow: w * ||p - final||^4
                const float dx = px - final_x, dy = py - final_y;
                const float sq = dx * dx + dy * dy;
                const float c = 4.0f * a.w_distance * sq;
                accumulate<NB, true, false, false>(
                    acc, t, a.w_distance * sq * sq, c * dx, c * dy, 0.0f, 0.0f);
            }
            {  // path align: angle_weight * ||p - ref_{i+1}||^4
                const float dx = px - a.refx[i], dy = py - a.refy[i];
                const float sq = dx * dx + dy * dy;
                const float c = 4.0f * a.w_angle * sq;
                accumulate<NB, true, false, false>(
                    acc, t, a.w_angle * sq * sq, c * dx, c * dy, 0.0f, 0.0f);
            }
            {  // obstacle: w * bicubic(front point), chained through K1's partials
                const float val = a.val[i], drow = a.drow[i], dcol = a.dcol[i];
                const float gx = a.w_obstacle * dcol * inv_res;
                const float gy = a.w_obstacle * drow * inv_res;
                const float gth = a.w_obstacle *
                    (dcol * (-a.front_offset * sinf(pth) * inv_res) +
                     drow * (a.front_offset * cosf(pth) * inv_res));
                accumulate<NB, true, true, false>(
                    acc, t, a.w_obstacle * val, gx, gy, gth, 0.0f);
            }
        }
    }

    acc.cost = warp_sum(acc.cost);
#pragma unroll
    for (int d = 0; d < D; ++d) acc.g[d] = warp_sum(acc.g[d]);
#pragma unroll
    for (int k = 0; k < NJ; ++k) acc.jtj[k] = warp_sum(acc.jtj[k]);
    if (lane != 0) return;

    // Velocity-feasibility rows between consecutive blocks, in u-space.
    float u[D];
#pragma unroll
    for (int d = 0; d < D; ++d) u[d] = a.u[(size_t)b * D + d];
#pragma unroll
    for (int q = 0; q < NB - 1; ++q) {
        if (q < a.n_vf && a.vfm[(size_t)b * a.n_vf + q] != 0) {
            const float dv = u[2 * q + 2] - u[2 * q];
            const float dw = u[2 * q + 3] - u[2 * q + 1];
            const float r = a.w_vf * (dv * dv + dw * dw);
            float c[4];
            c[0] = -2.0f * a.w_vf * dv;
            c[1] = -2.0f * a.w_vf * dw;
            c[2] = 2.0f * a.w_vf * dv;
            c[3] = 2.0f * a.w_vf * dw;
            acc.cost += 0.5f * r * r;
#pragma unroll
            for (int i1 = 0; i1 < 4; ++i1) {
                acc.g[2 * q + i1] += r * c[i1];
#pragma unroll
                for (int i2 = i1; i2 < 4; ++i2)
                    acc.jtj[tri(2 * q + i1, 2 * q + i2, D)] += c[i1] * c[i2];
            }
        }
    }

    a.cost[b] = acc.cost;
#pragma unroll
    for (int d = 0; d < D; ++d) a.g[(size_t)b * D + d] = acc.g[d];
#pragma unroll
    for (int d1 = 0; d1 < D; ++d1) {
#pragma unroll
        for (int d2 = d1; d2 < D; ++d2) {
            const float x = acc.jtj[tri(d1, d2, D)];
            a.jtj[((size_t)b * D + d1) * D + d2] = x;
            a.jtj[((size_t)b * D + d2) * D + d1] = x;
        }
    }
}

}  // namespace

extern "C" int social_mpc_fused_iter_f32(
    const float* u, const float* px, const float* py, const float* pth,
    const float* v, const float* dxdv, const float* dydv, const float* dxdw,
    const float* dydw, int bs_dxdv, int bs_dydv, int bs_dxdw, int bs_dydw,
    const float* dth, const float* eb, const float* val, const float* drow,
    const float* dcol, const float* agents, int as_b, int as_s, int as_n,
    const unsigned char* m_step, const unsigned char* m_vel,
    const unsigned char* m_social, const unsigned char* active,
    const float* steer, const float* refx, const float* refy, const float* scal,
    const unsigned char* vfm, float* cost, float* g, float* jtj, int B, int S,
    int NB, int n_vf, int N, float w_social, float w_agent_angle,
    float w_proxemics, float w_distance, float w_angle, float w_velocity,
    float w_goal_align, float w_obstacle, float w_vf, float desired_vel,
    float front_offset, cudaStream_t stream) {
    FusedArgs a{u, px, py, pth, v, dxdv, dydv, dxdw, dydw,
                bs_dxdv, bs_dydv, bs_dxdw, bs_dydw, dth, eb, val, drow, dcol,
                agents, as_b, as_s, as_n, m_step, m_vel, m_social, active, steer,
                refx, refy, scal, vfm, cost, g, jtj, B, S, n_vf, N,
                w_social, w_agent_angle, w_proxemics,
                w_distance, w_angle, w_velocity, w_goal_align, w_obstacle, w_vf,
                desired_vel, front_offset};
    if (B <= 0) return (int)cudaGetLastError();
    const int threads = 128;  // 4 warps = 4 scenarios per block
    const int blocks = (B * 32 + threads - 1) / threads;
#define FUSED_CASE(NB_) \
    case NB_: fused_kernel<NB_><<<blocks, threads, 0, stream>>>(a); break;
    switch (NB) {
        SOCIAL_MPC_BLOCKS(FUSED_CASE)
        default: return (int)cudaErrorInvalidValue;
    }
#undef FUSED_CASE
    return (int)cudaGetLastError();
}
