// Variant `phase1_and_g` of csrc/fused_general.cu, timed by tools/torch_kernel_variants.py: a
// diagnostic, not a design: `column_major_stage` without its JtJ tiles (phase 2), so its time
// is the critics' phase, g summed apart and the cost; its JtJ is left unwritten.

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
// Design (since the first general form, whose second phase formed M_s e_j
// again for every entry of JtJ and ran one warp a block): blocks of
// GENERAL_BLOCK threads, a warp a scenario up to D = 32 (four scenarios a
// block where they fit in 48 KB of shared memory, so that an SM is not held
// to 32 of them), 128 threads a scenario above. Two phases.
//   1. Threads over steps run the critics (the people stages included)
//      exactly as the templated form does, and write each step's M_s, q_s
//      and cost into shared memory (15 floats a step, structure of arrays);
//      an absent partial is never multiplied, as there.
//   2. JtJ by tiles of 2 x 2 entries, the v- and w-columns of block bi
//      against those of block bj >= bi, up to TILES_A_THREAD tiles a thread
//      at a time. For a tile of steps at a time the scenario stages, once
//      for all of its threads, each column pair's sensitivities e_v, e_w
//      and P_v = M_s f_v, P_w = M_s f_w (the x, y, theta and v rows, each
//      formed from the column's own three components by the first general
//      form's expressions), so an entry costs three FMAs a step from shared
//      memory, summed in step order. A v-column never reads M's theta row
//      and a w-column never its v row, and an entry reads P's theta row for
//      a w-row and its v row for a v-row: a non-finite partial reaches
//      exactly the entries it reaches in the templated form. No step is
//      skipped: a zero sensitivity times a non-finite M is NaN on both
//      sides. Where every step fits one tile (the main path's shapes) the
//      staging is done once; past it, once for each pass of tiles. Then
//      g, the cost and the velocity-feasibility rows in u-space, in the
//      templated form's order, and JtJ in both triangles.
//
// What bounds it. Phase 1 as the templated form: bytes people-free,
// instruction issue on the people stages. Phase 2: 3 D(D+1)/2 FMAs a step
// (about 0.5 MFLOP a scenario at D = 36, S = 29), from shared memory, no
// tensor cores (no TF32: the port bans it, and at D <= 36 an mma tile would
// be mostly padding).
//
// Numerics: each entry's sum runs over the steps in order, each step's
// term formed as in the first general form; the sums run in another order
// than the templated form's (a step's rows summed into M_s first, then over
// steps) and than the plain version's, so the three agree to float32
// rounding of these sums.

#include <cuda_runtime.h>

#include "damped_step.cuh"
#include "fused_rows.cuh"
#include "kernel_shapes.h"

namespace {

using fused::FusedArgs;

// The launch: GENERAL_BLOCK threads a block, scenario_threads(D) a scenario
// (a warp up to D = 32: one round of phase 1 at S <= 32), as many scenarios
// a block as that leaves if they fit in 48 KB, else one; a step tile of at
// most STEP_TILE steps, fewer only where a long rollout's sums leave no
// room (kernel_shapes.fused_general_geometry is the same rule).
constexpr int GENERAL_BLOCK = 128;
constexpr int STEP_TILE = SOCIAL_MPC_FUSED_GENERAL_STEP_TILE;
constexpr int TILES_A_THREAD = 4;
constexpr int SUMS = 15;  // per step: M (10), q (4), cost
// M_s's entries in shared memory, rows x, y, th, v of the symmetric 4 x 4
enum { XX, XY, XT, XV, YY, YT, YV, TT, TV, VV, QX, QY, QT, QV, COST };

__host__ __device__ __forceinline__ int scenario_threads(int D) { return D <= 32 ? 32 : 128; }

// One scenario's shared memory: the staged tile, four float4s a column pair
// and step (e_v, e_w, P_v, P_w), then the step sums (15 floats a step,
// padded to 16 bytes).
__host__ __device__ __forceinline__ size_t scenario_bytes(int S, int NB, int tile) {
    return (size_t)64 * NB * tile + (((size_t)4 * SUMS * S + 15) / 16) * 16;
}

struct Launch {
    int threads, scenarios, tile;
    size_t shared;  // a block's
};

__host__ __forceinline__ Launch general_launch(int S, int NB) {
    const int T = scenario_threads(2 * NB);
    int tile = S < STEP_TILE ? S : STEP_TILE;
    while (tile > 1 && scenario_bytes(S, NB, tile) > SOCIAL_MPC_SHARED_BYTES_PER_BLOCK) --tile;
    int spb = GENERAL_BLOCK / T;
    if ((size_t)spb * scenario_bytes(S, NB, tile) > 48 * 1024) spb = 1;
    return Launch{spb * T, spb, tile, (size_t)spb * scenario_bytes(S, NB, tile)};
}

// The T threads of a scenario meet: its warp, or its block (one scenario).
__device__ __forceinline__ void scenario_sync(int T) {
    if (T == 32) __syncwarp();
    else __syncthreads();
}

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

// Row i of the packed upper triangle of an n x n matrix starts at
// triangle_offset(i); triangle_row(w) is the row of packed entry w.
__device__ __forceinline__ int triangle_offset(int i, int n) { return i * n - i * (i - 1) / 2; }

__device__ __forceinline__ int triangle_row(int w, int n) {
    const float m = 2.0f * n + 1.0f;
    int i = (int)(0.5f * (m - sqrtf(m * m - 8.0f * w)));
    i = max(0, min(i, n - 1));
    while (i > 0 && triangle_offset(i, n) > w) --i;
    while (i < n - 1 && triangle_offset(i + 1, n) <= w) ++i;
    return i;
}

// e^T P for an entry: its row's e (x, y, third) against P's x and y rows
// and the row P's third component meets (theta for a w-row, v for a v-row).
__device__ __forceinline__ float term(const float4& e, float px, float py, float p3) {
    return e.x * px + e.y * py + e.z * p3;
}

__global__ void __launch_bounds__(GENERAL_BLOCK) fused_general_kernel(const FusedArgs a, int NB,
                                                                      int tile) {
    extern __shared__ float4 shared4[];
    const int S = a.S, D = 2 * NB, T = scenario_threads(D), spb = blockDim.x / T;
    const int slot = threadIdx.x / T, t = threadIdx.x - slot * T;
    const int b = blockIdx.x * spb + slot;
    if (b >= a.B) return;  // a whole scenario's threads
    float4* stage = reinterpret_cast<float4*>(reinterpret_cast<char*>(shared4) +
                                              (size_t)slot * scenario_bytes(S, NB, tile));
    float* sums = reinterpret_cast<float*>(stage + (size_t)4 * NB * tile);  // (SUMS, S)
    const fused::ScenarioConsts c = fused::scenario_consts(a, b);

    // Phase 1: each step's M_s, q_s and cost.
    for (int s = t; s < S; s += T) {
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
    scenario_sync(T);

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

    // (phase 2 left out: JtJ is not written)
    // g[i], then the cost: one item a thread.
    for (int w = t; w < D + 1; w += T) {
        if (w < D) {
            const int i = w;
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
    const Launch l = general_launch(S, NB);
    if (l.shared > SOCIAL_MPC_SHARED_BYTES_PER_BLOCK) return (int)cudaErrorInvalidValue;
    static int opted = 0;  // past 48 KB the opt-in of damped_step.cuh
    const int err = social_mpc::general_opt_in(fused_general_kernel, l.shared, opted);
    if (err != 0) return err;
    const int blocks = (B + l.scenarios - 1) / l.scenarios;
    fused_general_kernel<<<blocks, l.threads, l.shared, stream>>>(a, NB, l.tile);
    return (int)cudaGetLastError();
}
