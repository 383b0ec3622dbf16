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
// The critics, step by step (their residuals, partials, masks and order,
// the people stages' forward duals), are fused_rows.cuh's, which K2's
// general form (fused_general.cu, NB past 6) compiles too.
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
// lane runs the people stages first (fused_rows.cuh), before its
// sensitivities are loaded. Batch-major layout with
// the step axis innermost, so a warp's loads are contiguous; a scenario's
// outputs do not depend on its block or slot.
//
// nvcc contracts a*b+c into FMA and the warp reduction sums in another
// order than the plain PyTorch version, so the two agree to float32
// rounding of these sums, not bit for bit.

#include <cuda_runtime.h>

#include "fused_rows.cuh"
#include "kernel_shapes.h"

namespace {

using fused::FusedArgs;

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

    const fused::ScenarioConsts c = fused::scenario_consts(a, b);

    for (int s = lane; s < S; s += 32) {
        StepSens<NB> t;
        fused::step_rows(
            a, b, s, c,
            [&]() {
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
            },
            [&](auto p, float r, float gx, float gy, float gth, float gv) {
                using P = decltype(p);
                accumulate<NB, P::XY, P::TH, P::V>(acc, t, r, gx, gy, gth, gv);
            });
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
