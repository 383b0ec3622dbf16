// K3 (propose) and K4 (commit): the non-evaluation half of one
// Levenberg-Marquardt trust-region iteration.
//
// Replace the TPU kernels _propose_kernel and _commit_kernel of the JAX
// package's solver/pallas_iter.py, with exactly their arithmetic (the Ceres
// rules of levenberg_marquardt_strategy.cc / trust_region_minimizer.cc):
//
//   propose: clamp diag(JtJ) to [min_diagonal, max_diagonal], factor the
//            damped system A = JtJ + diag/radius by Cholesky, solve
//            A x = -g, project u + x onto the box, and evaluate the model
//            cost change with the projected step.
//   commit:  rho, accept/reject, radius and decrease-factor updates, the
//            three tolerance stops and the termination code; a lane that is
//            already done passes through bit for bit.
//
// Both kernels move a few hundred bytes per scenario against a few hundred
// operations, so their bound is bytes; at these sizes what they actually pay
// is latency: the serial chains of the solve and the round trips to device
// memory, a few microseconds above the cost of an empty launch. The design
// spreads a batch over the card's 132 SMs with coalesced accesses and keeps
// the chains short:
//
//   propose: damped_step.cuh's bodies without Jacobi scaling (K7's damped
//            step, spd_solve.cu, compiles the same bodies with and without
//            it): up to D = 6 one thread per scenario in 32-thread blocks,
//            JtJ read as float4; above, a segment of 8 (D = 8) or 16 lanes
//            per scenario, lane i holding row i of the system.
//   commit:  decide, then copy. A block covers COMMIT_G scenarios. One thread
//            per scenario computes every scalar from u, u_new, delta and g
//            staged through shared memory and leaves its accept flag there;
//            after one barrier the whole block copies the contiguous spans
//            of u, g and JtJ that its scenarios own, each element from the
//            source its scenario's flag selects (float4 where the spans are
//            16-byte aligned). The copy is where the bytes are.
//
// Both are instantiated for every even D of kernel_shapes.h's
// SOCIAL_MPC_SOLVE_DIMS (2..12). Past those, each has a general form that
// takes D at run time (every even D up to SOCIAL_MPC_GENERAL_MAX_DIM, the
// D = 2 NB of a config in more blocks): propose's is K7's general damped
// step without the scale (spd_solve.cu's social_mpc_damped_step_general_f32,
// damped_step.cuh's general body: a warp a system up to D = 32, a block a
// system above, right-looking); commit's is the same decide-then-copy, its staged vectors
// in dynamic shared memory and its loops over D at run time.
//
// Numerics: every product, sum and difference is written with the
// round-to-nearest intrinsics (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc
// never contracts into FMA, and division and sqrtf are IEEE (no fast math):
// the kernels repeat the plain PyTorch version operation for operation
// (damped_step.cuh says how the row-parallel solve keeps chol.cuh's order).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "damped_step.cuh"
#include "kernel_shapes.h"

namespace {

using social_mpc::add;
using social_mpc::aligned;
using social_mpc::mul;
using social_mpc::sub;

constexpr int COMMIT_THREADS = 128;
constexpr int COMMIT_G = 8;  // scenarios per commit block: B = 1024 gives 128 blocks

// propose up to D = 6: damped_step.cuh's thread layout, without scaling.
template <int D>
__global__ void __launch_bounds__(social_mpc::THREAD_BLOCK)
propose_thread_kernel(const social_mpc::DampedStepArgs p) {
    const int b = blockIdx.x * social_mpc::THREAD_BLOCK + threadIdx.x;
    if (b >= p.B) return;
    social_mpc::damped_step_thread<D, false>(p, b);
}

// propose above D = 6: damped_step.cuh's row segments, without scaling.
template <int D>
__global__ void __launch_bounds__(social_mpc::ROWS_BLOCK)
propose_rows_kernel(const social_mpc::DampedStepArgs p) {
    social_mpc::damped_step_rows<D, false>(p);
}

template <int D>
void launch_propose(const social_mpc::DampedStepArgs& p, cudaStream_t stream) {
    using namespace social_mpc;
    if constexpr (D <= THREAD_MAX_D)
        propose_thread_kernel<D>
            <<<(p.B + THREAD_BLOCK - 1) / THREAD_BLOCK, THREAD_BLOCK, 0, stream>>>(p);
    else
        propose_rows_kernel<D>
            <<<(p.B + rows_scenarios<D>() - 1) / rows_scenarios<D>(), ROWS_BLOCK, 0, stream>>>(p);
}

struct CommitArgs {
    // state at the iteration's start
    const float* u; const float* cost; const float* g; const float* jtj;
    const float* radius; const float* decrease; const int* iters;
    const unsigned char* done; const int* term; const unsigned char* failed;
    // the trial step and its evaluation
    const float* u_new; const float* delta; const float* model_change;
    const float* new_cost; const float* g_new; const float* jtj_new;
    // updated state
    float* u_o; float* cost_o; float* g_o; float* jtj_o; float* radius_o;
    float* decrease_o; int* iters_o; unsigned char* done_o; int* term_o;
    unsigned char* failed_o;
    int B;
    float gradient_tol, fn_tol, param_tol, min_relative_decrease, max_radius,
        min_radius, one_third;
};

// Every scalar of commit for scenario b, whose u, u_new, g and delta are at
// the given (shared-memory) addresses: writes the scalar outputs and returns
// whether the step is accepted.
// D is a template argument of the templated kernel (its loops unrolled)
// and a run-time one of the general kernel; the arithmetic is the same.
__device__ __forceinline__ bool commit_decide(const CommitArgs& a, int b, int D, const float* u,
                                              const float* u_new, const float* g,
                                              const float* delta) {
    const float cost = a.cost[b];
    const float radius = a.radius[b];
    const float decrease = a.decrease[b];
    const bool done = a.done[b] != 0;
    const bool failed = a.failed[b] != 0;
    const float mc = a.model_change[b];
    const float new_cost = a.new_cost[b];

    float g_max = 0.0f;
    bool g_nan = false;
    bool delta_finite = true;
    float step_sq = 0.0f, u_sq = 0.0f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
        const float gi = fabsf(g[i]);
        g_nan = g_nan || isnan(gi);
        g_max = fmaxf(g_max, gi);
        const float di = delta[i];
        const float ui = u[i];
        delta_finite = delta_finite && isfinite(di);
        step_sq = i == 0 ? mul(di, di) : add(step_sq, mul(di, di));
        u_sq = i == 0 ? mul(ui, ui) : add(u_sq, mul(ui, ui));
    }
    // max() of the plain version propagates NaN; NaN <= tol is false.
    bool grad_ok = !g_nan && g_max <= a.gradient_tol;

    const float actual_change = sub(cost, new_cost);
    const float rho = actual_change / mc;
    const bool step_valid = (mc > 0.0f) && isfinite(new_cost) && delta_finite;
    const bool active = !done;
    const bool accept = active && step_valid && (rho > a.min_relative_decrease);

    const float shrink = sub(mul(2.0f, rho), 1.0f);
    const float cube = mul(mul(shrink, shrink), shrink);
    const float one_minus = sub(1.0f, cube);
    // max(1/3, x) keeping NaN as the plain version does (unused when rejected)
    const float grow = one_minus != one_minus ? one_minus
                                              : (one_minus > a.one_third ? one_minus : a.one_third);
    const float racc = radius / grow;
    const float radius_acc = racc != racc ? racc : (racc < a.max_radius ? racc : a.max_radius);
    const float radius_rej = radius / decrease;
    const float radius_out = active ? (accept ? radius_acc : radius_rej) : radius;
    const float decrease_out = active ? (accept ? 2.0f : mul(decrease, 2.0f)) : decrease;
    const float cost_out = accept ? new_cost : cost;

    bool u_finite = true;
#pragma unroll
    for (int i = 0; i < D; ++i) u_finite = u_finite && isfinite(accept ? u_new[i] : u[i]);

    const bool fn_conv = accept && (fabsf(actual_change) <= mul(a.fn_tol, cost));
    const float step_norm = sqrtf(step_sq);
    const bool param_conv =
        accept && (step_norm <= mul(a.param_tol, add(sqrtf(u_sq), a.param_tol)));
    const bool radius_dead = active && (radius_out < a.min_radius);
    const bool numeric_failed = active && (!isfinite(cost_out) || !u_finite);
    grad_ok = active && grad_ok;

    // TERM_* codes of solver/cuda_iter.py
    const int term_new = numeric_failed ? 5
                         : grad_ok      ? 3
                         : fn_conv      ? 1
                         : param_conv   ? 2
                         : radius_dead  ? 4
                                        : 0;
    const bool newly_done = numeric_failed || grad_ok || fn_conv || param_conv || radius_dead;

    a.cost_o[b] = cost_out;
    a.radius_o[b] = radius_out;
    a.decrease_o[b] = decrease_out;
    a.iters_o[b] = a.iters[b] + (active ? 1 : 0);
    a.done_o[b] = (done || newly_done) ? 1 : 0;
    a.term_o[b] = done ? a.term[b] : term_new;
    a.failed_o[b] = (failed || numeric_failed) ? 1 : 0;
    return accept;
}

// Both phases of commit for the block's scenarios, staged through s_u,
// s_un, s_g, s_d (G D floats each) and s_acc. D is a template argument of
// the templated kernel (a constant here once inlined, its loops unrolled)
// and a run-time one of the general kernel; the arithmetic is the same.
__device__ __forceinline__ void commit_block(const CommitArgs& a, int D, float* s_u, float* s_un,
                                             float* s_g, float* s_d, bool* s_acc) {
    constexpr int G = COMMIT_G;
    const int DD = D * D;  // a multiple of 4 at even D: a float4 never straddles two scenarios
    const int t = threadIdx.x;
    const int b0 = blockIdx.x * G;
    const int n = min(G, a.B - b0);

    // Phase 1, decide: stage the vectors the scalars need, coalesced (a
    // thread's stride-D reads of them are free of bank conflicts at G = 8).
    const size_t v0 = (size_t)b0 * D;
    for (int k = t; k < n * D; k += COMMIT_THREADS) {
        s_u[k] = a.u[v0 + k];
        s_un[k] = a.u_new[v0 + k];
        s_g[k] = a.g[v0 + k];
        s_d[k] = a.delta[v0 + k];
    }
    __syncthreads();
    if (t < n) s_acc[t] = commit_decide(a, b0 + t, D, s_u + t * D, s_un + t * D, s_g + t * D,
                                        s_d + t * D);
    __syncthreads();

    // Phase 2, copy: the block's spans of u, g and JtJ, each element read
    // from the source its scenario's flag selects.
    for (int k = t; k < n * D; k += COMMIT_THREADS) {
        const bool acc = s_acc[k / D];
        a.u_o[v0 + k] = acc ? s_un[k] : s_u[k];
        a.g_o[v0 + k] = acc ? __ldg(a.g_new + v0 + k) : s_g[k];
    }
    const size_t m0 = (size_t)b0 * DD;
    if (aligned(a.jtj, 16) && aligned(a.jtj_new, 16) && aligned(a.jtj_o, 16)) {
        const float4* old4 = reinterpret_cast<const float4*>(a.jtj + m0);
        const float4* new4 = reinterpret_cast<const float4*>(a.jtj_new + m0);
        float4* out4 = reinterpret_cast<float4*>(a.jtj_o + m0);
        for (int q = t; q < n * (DD / 4); q += COMMIT_THREADS)
            out4[q] = __ldg((s_acc[q / (DD / 4)] ? new4 : old4) + q);
    } else {
        for (int k = t; k < n * DD; k += COMMIT_THREADS)
            a.jtj_o[m0 + k] = __ldg((s_acc[k / DD] ? a.jtj_new : a.jtj) + m0 + k);
    }
}

template <int D>
__global__ void __launch_bounds__(COMMIT_THREADS) commit_kernel(const CommitArgs a) {
    constexpr int G = COMMIT_G;
    static_assert((D * D) % 4 == 0, "a float4 of JtJ must not straddle two scenarios");
    __shared__ float s_u[G * D], s_un[G * D], s_g[G * D], s_d[G * D];
    __shared__ bool s_acc[G];
    commit_block(a, D, s_u, s_un, s_g, s_d, s_acc);
}

// The general form: D at run time (every even D, up to
// SOCIAL_MPC_GENERAL_MAX_DIM), the staged vectors in dynamic shared memory
// (4 G D floats, 30 KB at D = 236).
__global__ void __launch_bounds__(COMMIT_THREADS) commit_general_kernel(const CommitArgs a, int D) {
    constexpr int G = COMMIT_G;
    extern __shared__ float staged[];
    __shared__ bool s_acc[G];
    commit_block(a, D, staged, staged + G * D, staged + 2 * G * D, staged + 3 * G * D, s_acc);
}

}  // namespace

extern "C" int social_mpc_propose_f32(const float* u, const float* g,
                                      const float* jtj, const float* radius,
                                      const float* lower, const float* upper,
                                      float* u_new, float* delta,
                                      float* model_change, int B, int D,
                                      float min_diagonal, float max_diagonal,
                                      cudaStream_t stream) {
    using namespace social_mpc;
    if (B <= 0) return (int)cudaGetLastError();
    const DampedStepArgs p{u, g, jtj, radius, lower, upper, nullptr, u_new, delta, model_change,
                           B, min_diagonal, max_diagonal};
#define PROPOSE_CASE(D_) \
    case D_: launch_propose<D_>(p, stream); break;
    switch (D) {
        SOCIAL_MPC_SOLVE_DIMS(PROPOSE_CASE)
        default: return (int)cudaErrorInvalidValue;
    }
#undef PROPOSE_CASE
    return (int)cudaGetLastError();
}

extern "C" int social_mpc_commit_f32(
    const float* u, const float* cost, const float* g, const float* jtj,
    const float* radius, const float* decrease, const int* iters,
    const unsigned char* done, const int* term, const unsigned char* failed,
    const float* u_new, const float* delta, const float* model_change,
    const float* new_cost, const float* g_new, const float* jtj_new,
    float* u_o, float* cost_o, float* g_o, float* jtj_o, float* radius_o,
    float* decrease_o, int* iters_o, unsigned char* done_o, int* term_o,
    unsigned char* failed_o, int B, int D, float gradient_tol, float fn_tol,
    float param_tol, float min_relative_decrease, float max_radius,
    float min_radius, float one_third, cudaStream_t stream) {
    CommitArgs a{u, cost, g, jtj, radius, decrease, iters, done, term, failed,
                 u_new, delta, model_change, new_cost, g_new, jtj_new,
                 u_o, cost_o, g_o, jtj_o, radius_o, decrease_o, iters_o, done_o,
                 term_o, failed_o, B,
                 gradient_tol, fn_tol, param_tol, min_relative_decrease,
                 max_radius, min_radius, one_third};
    if (B <= 0) return (int)cudaGetLastError();
    const int blocks = (B + COMMIT_G - 1) / COMMIT_G;
#define COMMIT_CASE(D_) \
    case D_: commit_kernel<D_><<<blocks, COMMIT_THREADS, 0, stream>>>(a); break;
    switch (D) {
        SOCIAL_MPC_SOLVE_DIMS(COMMIT_CASE)
        default: return (int)cudaErrorInvalidValue;
    }
#undef COMMIT_CASE
    return (int)cudaGetLastError();
}

// The general form, every even D up to SOCIAL_MPC_GENERAL_MAX_DIM (the
// wrapper takes it past SOCIAL_MPC_SOLVE_DIMS); the same arguments.
extern "C" int social_mpc_commit_general_f32(
    const float* u, const float* cost, const float* g, const float* jtj,
    const float* radius, const float* decrease, const int* iters,
    const unsigned char* done, const int* term, const unsigned char* failed,
    const float* u_new, const float* delta, const float* model_change,
    const float* new_cost, const float* g_new, const float* jtj_new,
    float* u_o, float* cost_o, float* g_o, float* jtj_o, float* radius_o,
    float* decrease_o, int* iters_o, unsigned char* done_o, int* term_o,
    unsigned char* failed_o, int B, int D, float gradient_tol, float fn_tol,
    float param_tol, float min_relative_decrease, float max_radius,
    float min_radius, float one_third, cudaStream_t stream) {
    if (D < 2 || D > SOCIAL_MPC_GENERAL_MAX_DIM || D % 2 != 0) return (int)cudaErrorInvalidValue;
    CommitArgs a{u, cost, g, jtj, radius, decrease, iters, done, term, failed,
                 u_new, delta, model_change, new_cost, g_new, jtj_new,
                 u_o, cost_o, g_o, jtj_o, radius_o, decrease_o, iters_o, done_o,
                 term_o, failed_o, B,
                 gradient_tol, fn_tol, param_tol, min_relative_decrease,
                 max_radius, min_radius, one_third};
    if (B <= 0) return (int)cudaGetLastError();
    const int blocks = (B + COMMIT_G - 1) / COMMIT_G;
    const size_t bytes = (size_t)4 * COMMIT_G * D * sizeof(float);
    commit_general_kernel<<<blocks, COMMIT_THREADS, bytes, stream>>>(a, D);
    return (int)cudaGetLastError();
}
