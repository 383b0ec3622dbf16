// K2's general form: (cost, g = J^T r, JtJ = J^T J) at any NB from 1 to
// kernel_shapes.h's SOCIAL_MPC_GENERAL_MAX_BLOCKS, NB a run-time argument.
// The wrapper (ops/fused_iter.py) takes it where the templated form
// (fused_iter.cu, NB = 1..6) has no instantiation: a config in finer blocks
// or over a longer horizon than the benchmark's.
//
// Replaces, past NB = 6, the TPU kernel _fused_kernel of the JAX package's
// ops/fused_iter.py, which loops over any number of blocks. Same function,
// same critics: the rows of a step are fused_rows.cuh's, the templated
// form's own source.
//
// Why another design. The templated form keeps 1 + D + D(D+1)/2 partial sums
// a lane in registers, unrolled over D (91 at D = 12, 703 at D = 36): past
// NB = 6 they do not fit. But a row's Jacobian entry for column i is a
// step's partials p = (gx, gy, gth, gv) contracted with that step's
// sensitivities e_i: for block b the v-column is e = (dxdv_b, dydv_b, -,
// eb_b), the w-column e = (dxdw_b, dydw_b, dth_b, -). So
//
//   JtJ[i][j] = sum_s e_i(s)^T M_s e_j(s),   g[i] = sum_s e_i(s)^T q_s,
//
// with M_s = sum p p^T (10 numbers) and q_s = sum r p (4) over the step's
// rows, which do not depend on NB.
//
// Design: a block per scenario (a warp up to D = 32, 128 threads above), two
// phases.
//   1. Threads over steps run the critics (the people stages included)
//      exactly as the templated form does, and write each step's M_s, q_s
//      and cost into shared memory (15 floats a step, structure of arrays);
//      an absent partial is never multiplied, as there.
//   2. Threads over the entries of JtJ's upper triangle (then g's and the
//      cost) sum over the steps, four steps in flight, reading the
//      sensitivities from device memory (a scenario's are a few KB,
//      L1-resident); a v-column never reads M's
//      theta row, a w-column never its v row, so a non-finite partial
//      reaches exactly the columns it reaches in the templated form. Then
//      the velocity-feasibility rows in u-space, in the templated form's
//      order, and JtJ in both triangles.
//
// What bounds it. Phase 1 as the templated form: bytes people-free,
// instruction issue on the people stages. Phase 2 does ~30 FP32 operations
// a step for each of the D(D+1)/2 entries (about 0.6 MFLOP a scenario at
// D = 36, S = 29) against 6 NB S + 15 S floats: operations, far below the
// card's FP32 rate at the main path's batches. A simple kernel that is
// right: no tensor cores, no tiling of the steps.
//
// Numerics: the sums run in another order than the templated form's (a
// step's rows summed into M_s first, then over steps) and than the plain
// version's, so the three agree to float32 rounding of these sums.

#include <cuda_runtime.h>

#include "damped_step.cuh"
#include "fused_rows.cuh"
#include "kernel_shapes.h"

namespace {

using fused::FusedArgs;

// A scenario's threads, as the general solve's (damped_step.cuh:
// general_threads): one warp up to D = 32 (one round of phase 1 at S <= 32,
// more blocks resident for the people stages), 128 above (phase 2's
// D(D+1)/2 entries).
constexpr int GENERAL_THREADS = 128;  // the most threads a scenario's block has
constexpr int SUMS = 15;  // per step: M (10), q (4), cost
// M_s's entries in shared memory, rows x, y, th, v of the symmetric 4 x 4
enum { XX, XY, XT, XV, YY, YT, YV, TT, TV, VV, QX, QY, QT, QV, COST };

// One column's sensitivity rows of scenario b: x, y and the third component
// (dth for a w-column, eb for a v-column), each indexed by step.
struct Column {
    const float* x;
    const float* y;
    const float* third;
    bool w;
};

__device__ __forceinline__ Column column(const FusedArgs& a, int b, int NB, int i) {
    const int blk = i >> 1, S = a.S;
    const size_t o = (size_t)blk * S;
    const size_t oe = ((size_t)b * NB + blk) * S;
    if (i & 1)
        return Column{a.dxdw + (size_t)b * a.bs_dxdw + o, a.dydw + (size_t)b * a.bs_dydw + o,
                      a.dth + oe, true};
    return Column{a.dxdv + (size_t)b * a.bs_dxdv + o, a.dydv + (size_t)b * a.bs_dydv + o,
                  a.eb + oe, false};
}

// Row i of the packed upper triangle of a D x D matrix starts at
// triangle_offset(i); triangle_row(w) is the row of packed entry w.
__device__ __forceinline__ int triangle_offset(int i, int D) { return i * D - i * (i - 1) / 2; }

__device__ __forceinline__ int triangle_row(int w, int D) {
    const float n = 2.0f * D + 1.0f;
    int i = (int)(0.5f * (n - sqrtf(n * n - 8.0f * w)));
    i = max(0, min(i, D - 1));
    while (i > 0 && triangle_offset(i, D) > w) --i;
    while (i < D - 1 && triangle_offset(i + 1, D) <= w) ++i;
    return i;
}

__global__ void __launch_bounds__(GENERAL_THREADS) fused_general_kernel(const FusedArgs a,
                                                                        int NB) {
    extern __shared__ float sums[];  // (SUMS, S)
    const int b = blockIdx.x;
    const int S = a.S, D = 2 * NB, t = threadIdx.x, G = blockDim.x;
    const fused::ScenarioConsts c = fused::scenario_consts(a, b);

    // Phase 1: each step's M_s, q_s and cost.
    for (int s = t; s < S; s += G) {
        float m[SUMS];
#pragma unroll
        for (int k = 0; k < SUMS; ++k) m[k] = 0.0f;
        fused::step_rows(
            a, b, s, c, [] {},
            [&](auto p, float r, float gx, float gy, float gth, float gv) {
                using P = decltype(p);
                m[COST] += 0.5f * r * r;
                if (P::XY) {
                    m[XX] += gx * gx;
                    m[XY] += gx * gy;
                    m[YY] += gy * gy;
                    m[QX] += r * gx;
                    m[QY] += r * gy;
                }
                if (P::XY && P::TH) {
                    m[XT] += gx * gth;
                    m[YT] += gy * gth;
                }
                if (P::XY && P::V) {
                    m[XV] += gx * gv;
                    m[YV] += gy * gv;
                }
                if (P::TH) {
                    m[TT] += gth * gth;
                    m[QT] += r * gth;
                }
                if (P::TH && P::V) m[TV] += gth * gv;
                if (P::V) {
                    m[VV] += gv * gv;
                    m[QV] += r * gv;
                }
            });
#pragma unroll
        for (int k = 0; k < SUMS; ++k) sums[k * S + s] = m[k];
    }
    __syncthreads();

    const float* u = a.u + (size_t)b * D;
    const int n_vf = min(a.n_vf, NB - 1);
    auto vf_row = [&](int q, float& r, float (&cq)[4]) {  // velocity-feasibility row q
        const float dv = u[2 * q + 2] - u[2 * q];
        const float dw = u[2 * q + 3] - u[2 * q + 1];
        r = a.w_vf * (dv * dv + dw * dw);
        cq[0] = -2.0f * a.w_vf * dv;
        cq[1] = -2.0f * a.w_vf * dw;
        cq[2] = 2.0f * a.w_vf * dv;
        cq[3] = 2.0f * a.w_vf * dw;
    };
    auto vf_on = [&](int q) { return a.vfm[(size_t)b * a.n_vf + q] != 0; };

    // Phase 2: one item a thread, in turn: the entries (i, j), i <= j, of
    // JtJ's upper triangle row by row (neighbouring threads share row i's
    // column, whose loads the warp then broadcasts), then g[i], then the
    // cost.
    const int NJ = D * (D + 1) / 2;
    for (int w = t; w < NJ + D + 1; w += G) {
        if (w < NJ) {
            const int i = triangle_row(w, D), j = i + w - triangle_offset(i, D);
            const Column e = column(a, b, NB, i), f = column(a, b, NB, j);
            // M's entries that e^T M f reads: f's third component meets M's
            // column th (w) or v, e's third component M's row th or v.
            const int fx3 = f.w ? XT : XV, fy3 = f.w ? YT : YV;
            const int ex3 = e.w ? XT : XV, ey3 = e.w ? YT : YV;
            const int e3f3 = e.w ? (f.w ? TT : TV) : (f.w ? TV : VV);
            float sum = 0.0f;
#pragma unroll 4
            for (int s = 0; s < S; ++s) {
                const float fx = __ldg(f.x + s), fy = __ldg(f.y + s), f3 = __ldg(f.third + s);
                const float* m = sums + s;
                const float mfx = m[XX * S] * fx + m[XY * S] * fy + m[fx3 * S] * f3;
                const float mfy = m[XY * S] * fx + m[YY * S] * fy + m[fy3 * S] * f3;
                const float mf3 = m[ex3 * S] * fx + m[ey3 * S] * fy + m[e3f3 * S] * f3;
                sum += __ldg(e.x + s) * mfx + __ldg(e.y + s) * mfy + __ldg(e.third + s) * mf3;
            }
            for (int q = 0; q < n_vf; ++q) {
                if (i >= 2 * q && j <= 2 * q + 3 && vf_on(q)) {
                    float r, cq[4];
                    vf_row(q, r, cq);
                    sum += cq[i - 2 * q] * cq[j - 2 * q];
                }
            }
            a.jtj[((size_t)b * D + i) * D + j] = sum;
            a.jtj[((size_t)b * D + j) * D + i] = sum;
        } else if (w < NJ + D) {
            const int i = w - NJ;
            const Column e = column(a, b, NB, i);
            const int q3 = e.w ? QT : QV;
            float sum = 0.0f;
#pragma unroll 4
            for (int s = 0; s < S; ++s)
                sum += __ldg(e.x + s) * sums[QX * S + s] + __ldg(e.y + s) * sums[QY * S + s] +
                       __ldg(e.third + s) * sums[q3 * S + s];
            for (int q = 0; q < n_vf; ++q) {
                if (i >= 2 * q && i <= 2 * q + 3 && vf_on(q)) {
                    float r, cq[4];
                    vf_row(q, r, cq);
                    sum += r * cq[i - 2 * q];
                }
            }
            a.g[(size_t)b * D + i] = sum;
        } else {
            float sum = 0.0f;
            for (int s = 0; s < S; ++s) sum += sums[COST * S + s];
            for (int q = 0; q < n_vf; ++q) {
                if (vf_on(q)) {
                    float r, cq[4];
                    vf_row(q, r, cq);
                    sum += 0.5f * r * r;
                }
            }
            a.cost[b] = sum;
        }
    }
}

}  // namespace

// social_mpc_fused_iter_f32's arguments; NB from 1 to
// SOCIAL_MPC_GENERAL_MAX_BLOCKS, S up to SOCIAL_MPC_GENERAL_MAX_STEPS.
extern "C" int social_mpc_fused_iter_general_f32(
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
    if (NB < 1 || NB > SOCIAL_MPC_GENERAL_MAX_BLOCKS || S > SOCIAL_MPC_GENERAL_MAX_STEPS)
        return (int)cudaErrorInvalidValue;
    FusedArgs a{u, px, py, pth, v, dxdv, dydv, dxdw, dydw,
                bs_dxdv, bs_dydv, bs_dxdw, bs_dydw, dth, eb, val, drow, dcol,
                agents, as_b, as_s, as_n, m_step, m_vel, m_social, active, steer,
                refx, refy, scal, vfm, cost, g, jtj, B, S, n_vf, N,
                w_social, w_agent_angle, w_proxemics,
                w_distance, w_angle, w_velocity, w_goal_align, w_obstacle, w_vf,
                desired_vel, front_offset};
    if (B <= 0 || S <= 0) return (int)cudaGetLastError();
    const size_t shared = (size_t)SUMS * S * sizeof(float);
    static int opted = 0;  // past 48 KB the opt-in of damped_step.cuh
    const int err = social_mpc::general_opt_in(fused_general_kernel, shared, opted);
    if (err != 0) return err;
    fused_general_kernel<<<B, social_mpc::general_threads(2 * NB), shared, stream>>>(a, NB);
    return (int)cudaGetLastError();
}
