// K2: fused critics + chain contraction -> (cost, g = J^T r, JtJ = J^T J).
//
// Replaces the TPU kernel _fused_kernel of the JAX package's
// ops/fused_iter.py (public wrapper fused_cost_g_jtj). For every scenario it
// evaluates each people-free critic's residual and per-step gradient
// (velocity, goal-align, path-follow distance, path-align distance,
// obstacle), chain-contracts them against the rollout sensitivities column
// by column, and accumulates cost, g and JtJ; then adds the
// velocity-feasibility rows, whose Jacobian lives directly in u-space. The
// (R, D) Jacobian never exists. Residual order and masks follow the JAX
// package's build_residual_fn. The three people stages (social work,
// agent angle, proxemics) are not in this kernel yet.
//
// Design: one warp per scenario, lanes over rollout steps (a lane loops when
// S > 32). Each lane builds its step's J columns in registers and keeps
// 1 + D + D(D+1)/2 partial sums; a butterfly of warp shuffles reduces them
// and lane 0 writes the outputs, JtJ in both triangles. Batch-major layout
// with the step axis innermost, so a warp's loads are contiguous. The kernel
// is bound by bytes: it reads (11 + 6*NB) floats per step and does a few
// hundred multiply-adds on them.
//
// The angle wrap is atan2f(sinf(a), cosf(a)), the reference's wrapAngle.
// nvcc contracts a*b+c into FMA and the warp reduction sums in another
// order than the plain PyTorch version, so the two agree to float32
// rounding of these sums, not bit for bit.

#include <cuda_runtime.h>

namespace {

struct FusedArgs {
    const float* u;
    const float* px; const float* py; const float* pth; const float* v;
    const float* dxdv; const float* dydv; const float* dxdw; const float* dydw;
    int bs_dxdv, bs_dydv, bs_dxdw, bs_dydw;
    const float* dth; const float* eb;
    const float* val; const float* drow; const float* dcol;
    const unsigned char* m_step; const unsigned char* m_vel;
    const float* refx; const float* refy;
    const float* scal;
    const unsigned char* vfm;
    float* cost; float* g; float* jtj;
    int B, S, n_vf;
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
        const float px = a.px[i], py = a.py[i], pth = a.pth[i];

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
    const float* dcol, const unsigned char* m_step, const unsigned char* m_vel,
    const float* refx, const float* refy, const float* scal,
    const unsigned char* vfm, float* cost, float* g, float* jtj, int B, int S,
    int NB, int n_vf, float w_distance, float w_angle, float w_velocity,
    float w_goal_align, float w_obstacle, float w_vf, float desired_vel,
    float front_offset, cudaStream_t stream) {
    FusedArgs a{u, px, py, pth, v, dxdv, dydv, dxdw, dydw,
                bs_dxdv, bs_dydv, bs_dxdw, bs_dydw, dth, eb, val, drow, dcol,
                m_step, m_vel, refx, refy, scal, vfm, cost, g, jtj, B, S, n_vf,
                w_distance, w_angle, w_velocity, w_goal_align, w_obstacle, w_vf,
                desired_vel, front_offset};
    if (B <= 0) return (int)cudaGetLastError();
    const int threads = 128;  // 4 warps = 4 scenarios per block
    const int blocks = (B * 32 + threads - 1) / threads;
    switch (NB) {
        case 3: fused_kernel<3><<<blocks, threads, 0, stream>>>(a); break;
        case 6: fused_kernel<6><<<blocks, threads, 0, stream>>>(a); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
