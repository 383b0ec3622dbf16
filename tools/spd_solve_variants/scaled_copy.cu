// Variant `scaled_copy` of csrc/spd_solve.cu, timed by tools/torch_kernel_variants.py:
// as the checkout, but with the Jacobi scale the damped step first forms the
// scaled, damped system as a second copy (D = 6: a second D x D array in
// registers; D = 12: a second row per lane, its D scales taken by shuffles
// up front), then solves it.

// K7 (spd_solve): the damped solve of the general Levenberg-Marquardt
// iteration (debug trace, Jacobi scaling; solver/lm.py), with two entries:
//
//   social_mpc_damped_step_f32: the whole damped step of one iteration in one
//       launch: the damped (optionally Jacobi-scaled) system, its Cholesky
//       solve, the map-back of the step, the box projection and the model
//       cost change; (u, g, JtJ, radius, lower, upper[, jac_scale]) ->
//       (u_new, delta, model_change). Without jac_scale it is K3's function.
//   social_mpc_spd_solve_f32: N independent D x D symmetric-positive-definite
//       solves, a (N, D, D), b (N, D) -> x (N, D), for a caller that forms
//       its own system (a caller's linear_solve built on it).
//
// Replaces the TPU kernel _cholesky_solve_kernel of the JAX package's
// solver/pallas_solve.py with exactly its arithmetic: an unrolled Cholesky
// A = L L^T, forward and back substitution, reciprocal diagonals and no
// pivot guard (chol.cuh), so a system that is not positive definite gives
// NaN for the iteration to reject.
//
// Why one launch: on the TPU, XLA fused the solve's neighbours into one
// program and the kernel could stay a bare solve. On the H100 each
// neighbour is a launch of its own: the damped system, the map-back and the
// projection with its serial sums make ~100 (D = 6) to ~330 (D = 12)
// PyTorch launches an iteration around one solve, each costing the card a
// launch and the host its dispatch, for work of a few hundred bytes per
// scenario. Far below the card's balance of bytes to operations the rule is
// to fuse and keep intermediates out of device memory: the damped step reads
// u, g, JtJ, radius, the box (and the scale) once and writes the step's three
// results, nothing else.
//
// Design: damped_step.cuh's bodies, shared with K3 (tr_iter.cu), on the
// layouts measured for K3: at D = 6 one thread per scenario in 32-thread
// blocks (B = 4096 gives all 132 SMs work), the matrix read as float4 and the
// vectors as float2 where aligned; at D = 12 a 16-lane segment per scenario,
// lane i holding row i. Templated on the Jacobi scaling (JAC), which forms
// each scaled entry where the factorisation reads it, so JtJ is held once.
// The standalone solve runs on the same layouts (the parent's one thread per
// system in 128-thread blocks filled 32 SMs at B = 4096 and read its systems
// D * D floats apart).
//
// Numerics: chol.cuh's order of every operation and its round-to-nearest
// intrinsics, IEEE division and sqrtf: both entries repeat their plain
// versions (solver/cuda_iter.py: damped_step_plain, solver/cuda_solve.py:
// spd_solve_plain) bit for bit.

#include <cuda_runtime.h>

#include "damped_step.cuh"

namespace {

using social_mpc::DampedStepArgs;
using social_mpc::ROWS_BLOCK;
using social_mpc::ROWS_SCEN;
using social_mpc::THREAD_BLOCK;

template <int D>
__device__ __forceinline__ void thread_scaled_copy(const DampedStepArgs& p, int b) {
    using namespace social_mpc;
    const size_t o = (size_t)b * D;
    const bool vec = aligned(p.jtj, 16) && aligned(p.u, 8) && aligned(p.g, 8) &&
                     aligned(p.lower, 8) && aligned(p.upper, 8) && aligned(p.u_new, 8) &&
                     aligned(p.delta, 8) && aligned(p.jac_scale, 8);
    float jtj[D][D], a[D][D];
    float g[D], u[D], lo[D], hi[D], s[D];
    load_matrix<D>(p.jtj + (size_t)b * D * D, vec, jtj);
    load_vector<D>(p.g + o, vec, g);
    load_vector<D>(p.u + o, vec, u);
    load_vector<D>(p.lower + o, vec, lo);
    load_vector<D>(p.upper + o, vec, hi);
    load_vector<D>(p.jac_scale + o, vec, s);
    const float inv_radius = 1.0f / p.radius[b];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) {
            const float e = mul(jtj[i][j], mul(s[i], s[j]));
            a[i][j] = i != j ? e
                             : add(e, mul(clamp_keep_nan(e, p.min_diagonal, p.max_diagonal),
                                          inv_radius));
        }
    float rhs[D], x[D];
#pragma unroll
    for (int i = 0; i < D; ++i) rhs[i] = -mul(s[i], g[i]);
    chol_solve<D>([&](int i, int j) { return a[i][j]; }, rhs, x);
    float un[D], delta[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
        un[i] = clamp_keep_nan(add(u[i], mul(s[i], x[i])), lo[i], hi[i]);
        delta[i] = sub(un[i], u[i]);
    }
    store_vector<D>(p.u_new + o, vec, un);
    store_vector<D>(p.delta + o, vec, delta);
    p.model_change[b] = model_change<D>(jtj, g, delta);
}

template <int D>
__device__ __forceinline__ void rows_scaled_copy(const DampedStepArgs& p) {
    using namespace social_mpc;
    constexpr int W = ROWS_W;
    const RowsLane l = rows_lane<D>(p.B);
    const int r = l.r;
    const float gi = __ldg(p.g + l.v), ui = __ldg(p.u + l.v), lo = __ldg(p.lower + l.v),
                hi = __ldg(p.upper + l.v), si = __ldg(p.jac_scale + l.v);
    const float inv_radius = 1.0f / p.radius[l.b];
    float row[D], sc[D];
#pragma unroll
    for (int j = 0; j < D; ++j) row[j] = __ldg(p.jtj + l.v * D + j);
#pragma unroll
    for (int j = 0; j < D; ++j) sc[j] = mul(row[j], mul(si, __shfl_sync(FULL_MASK, si, j, W)));
    float ajj = sc[0];
#pragma unroll
    for (int j = 1; j < D; ++j) ajj = r == j ? sc[j] : ajj;
    const float damped = add(ajj, mul(clamp_keep_nan(ajj, p.min_diagonal, p.max_diagonal), inv_radius));
    const float x = mul(si, rows_chol_solve<D>([&](int j) { return r == j ? damped : sc[j]; },
                                               -mul(si, gi), r));
    const float un = clamp_keep_nan(add(ui, x), lo, hi);
    const float delta = sub(un, ui);
    if (l.writes) {
        p.u_new[l.v] = un;
        p.delta[l.v] = delta;
    }
    float jd = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
        const float q = mul(row[j], __shfl_sync(FULL_MASK, delta, j, W));
        jd = j == 0 ? q : add(jd, q);
    }
    const float dg_r = mul(delta, gi), dad_r = mul(delta, jd);
    float dg = __shfl_sync(FULL_MASK, dg_r, 0, W), dad = 0.0f;
#pragma unroll
    for (int k = 1; k < D; ++k) dg = add(dg, __shfl_sync(FULL_MASK, dg_r, k, W));
#pragma unroll
    for (int k = 0; k < D; ++k) dad = add(dad, __shfl_sync(FULL_MASK, dad_r, k, W));
    if (l.first) p.model_change[l.b] = sub(-dg, mul(0.5f, dad));
}

template <int D, bool JAC>
__global__ void __launch_bounds__(THREAD_BLOCK) damped_step_thread_kernel(const DampedStepArgs p) {
    const int b = blockIdx.x * THREAD_BLOCK + threadIdx.x;
    if (b >= p.B) return;
    if constexpr (JAC) thread_scaled_copy<D>(p, b);
    else social_mpc::damped_step_thread<D, JAC>(p, b);
}

template <int D, bool JAC>
__global__ void __launch_bounds__(ROWS_BLOCK) damped_step_rows_kernel(const DampedStepArgs p) {
    if constexpr (JAC) rows_scaled_copy<D>(p);
    else social_mpc::damped_step_rows<D, JAC>(p);
}

template <int D>
__global__ void __launch_bounds__(THREAD_BLOCK)
spd_solve_thread_kernel(const float* __restrict__ a_in, const float* __restrict__ b_in,
                        float* __restrict__ x_out, int N) {
    const int n = blockIdx.x * THREAD_BLOCK + threadIdx.x;
    if (n >= N) return;
    const bool vec = social_mpc::aligned(a_in, 16) && social_mpc::aligned(b_in, 8) &&
                     social_mpc::aligned(x_out, 8);
    float a[D][D], rhs[D], x[D];
    social_mpc::load_matrix<D>(a_in + (size_t)n * D * D, vec, a);
    social_mpc::load_vector<D>(b_in + (size_t)n * D, vec, rhs);
    social_mpc::chol_solve<D>([&](int i, int j) { return a[i][j]; }, rhs, x);
    social_mpc::store_vector<D>(x_out + (size_t)n * D, vec, x);
}

template <int D>
__global__ void __launch_bounds__(ROWS_BLOCK)
spd_solve_rows_kernel(const float* __restrict__ a_in, const float* __restrict__ b_in,
                      float* __restrict__ x_out, int N) {
    const social_mpc::RowsLane l = social_mpc::rows_lane<D>(N);
    float row[D];
#pragma unroll
    for (int j = 0; j < D; ++j) row[j] = __ldg(a_in + l.v * D + j);
    const float x = social_mpc::rows_chol_solve<D>([&](int j) { return row[j]; },
                                                   __ldg(b_in + l.v), l.r);
    if (l.writes) x_out[l.v] = x;
}

template <int D, bool JAC>
void launch_damped_step(const DampedStepArgs& p, cudaStream_t stream) {
    if constexpr (D == 6)
        damped_step_thread_kernel<D, JAC>
            <<<(p.B + THREAD_BLOCK - 1) / THREAD_BLOCK, THREAD_BLOCK, 0, stream>>>(p);
    else
        damped_step_rows_kernel<D, JAC>
            <<<(p.B + ROWS_SCEN - 1) / ROWS_SCEN, ROWS_BLOCK, 0, stream>>>(p);
}

}  // namespace

extern "C" int social_mpc_damped_step_f32(const float* u, const float* g, const float* jtj,
                                          const float* radius, const float* lower,
                                          const float* upper, const float* jac_scale,
                                          float* u_new, float* delta, float* model_change,
                                          int B, int D, float min_diagonal, float max_diagonal,
                                          cudaStream_t stream) {
    if (D != 6 && D != 12) return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaGetLastError();
    const DampedStepArgs p{u, g, jtj, radius, lower, upper, jac_scale, u_new, delta,
                           model_change, B, min_diagonal, max_diagonal};
    const bool jac = jac_scale != nullptr;
    if (D == 6) {
        if (jac) launch_damped_step<6, true>(p, stream);
        else launch_damped_step<6, false>(p, stream);
    } else {
        if (jac) launch_damped_step<12, true>(p, stream);
        else launch_damped_step<12, false>(p, stream);
    }
    return (int)cudaGetLastError();
}

extern "C" int social_mpc_spd_solve_f32(const float* a, const float* b, float* x,
                                        int N, int D, cudaStream_t stream) {
    if (N <= 0) return (int)cudaGetLastError();
    switch (D) {
        case 6:
            spd_solve_thread_kernel<6>
                <<<(N + THREAD_BLOCK - 1) / THREAD_BLOCK, THREAD_BLOCK, 0, stream>>>(a, b, x, N);
            break;
        case 12:
            spd_solve_rows_kernel<12>
                <<<(N + ROWS_SCEN - 1) / ROWS_SCEN, ROWS_BLOCK, 0, stream>>>(a, b, x, N);
            break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
