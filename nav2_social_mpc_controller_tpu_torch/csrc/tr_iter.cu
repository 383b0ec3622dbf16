// K3 (propose) and K4 (commit): the non-evaluation half of one
// Levenberg-Marquardt trust-region iteration.
//
// Replace the TPU kernels _propose_kernel and _commit_kernel of the JAX
// package's solver/pallas_iter.py, with exactly their arithmetic (the Ceres
// rules of levenberg_marquardt_strategy.cc / trust_region_minimizer.cc):
//
//   propose: clamp diag(JtJ) to [min_diagonal, max_diagonal], factor the
//            damped system A = JtJ + diag/radius by an unrolled Cholesky,
//            solve A x = -g, project u + x onto the box, and evaluate the
//            model cost change with the projected step.
//   commit:  rho, accept/reject, radius and decrease-factor updates, the
//            three tolerance stops and the termination code; a lane that is
//            already done passes through bit for bit.
//
// Design: one thread per scenario, the D x D system unrolled in registers
// (template on D in {6, 12}). Both kernels are bound by bytes — a few
// hundred bytes per scenario against a few hundred operations — and at these
// sizes by launch latency.
//
// Every product, sum and difference is written with the round-to-nearest
// intrinsics (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc never contracts
// into FMA, and division and sqrtf are IEEE (no fast math): the kernels
// repeat the plain PyTorch version operation for operation. The Cholesky
// solve itself is chol.cuh's, shared with K7 (spd_solve.cu). A non-positive
// pivot gives sqrt(<0) = NaN or 1/0 = inf, which flows into a non-finite
// step that commit rejects; the box projection uses comparisons, not
// fminf/fmaxf, so that NaN is kept.

#include <cuda_runtime.h>
#include <math.h>

#include "chol.cuh"

namespace {

using social_mpc::add;
using social_mpc::mul;
using social_mpc::sub;

// clamp that propagates NaN (as torch.clamp / jnp.clip do)
__device__ __forceinline__ float clamp_keep_nan(float x, float lo, float hi) {
    float y = x < lo ? lo : x;
    return y > hi ? hi : y;
}

template <int D>
__global__ void propose_kernel(const float* __restrict__ u_in,
                               const float* __restrict__ g_in,
                               const float* __restrict__ jtj_in,
                               const float* __restrict__ radius_in,
                               const float* __restrict__ lower,
                               const float* __restrict__ upper,
                               float* __restrict__ u_new_out,
                               float* __restrict__ delta_out,
                               float* __restrict__ mc_out, int B,
                               float min_diagonal, float max_diagonal) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    float jtj[D][D];
    float g[D], u[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
        g[i] = g_in[(size_t)b * D + i];
        u[i] = u_in[(size_t)b * D + i];
#pragma unroll
        for (int j = 0; j < D; ++j) jtj[i][j] = jtj_in[((size_t)b * D + i) * D + j];
    }
    const float inv_radius = 1.0f / radius_in[b];

    // Damped system A = JtJ + clamp(diag)/radius, solved for the step x.
    float neg_g[D];
#pragma unroll
    for (int i = 0; i < D; ++i) neg_g[i] = -g[i];
    float x[D];
    social_mpc::chol_solve<D>(
        [&](int i, int j) {
            if (i != j) return jtj[i][j];
            const float diag = clamp_keep_nan(jtj[j][j], min_diagonal, max_diagonal);
            return add(jtj[j][j], mul(diag, inv_radius));
        },
        neg_g, x);

    float delta[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
        const float un = clamp_keep_nan(add(u[i], x[i]), lower[(size_t)b * D + i],
                                        upper[(size_t)b * D + i]);
        delta[i] = sub(un, u[i]);
        u_new_out[(size_t)b * D + i] = un;
        delta_out[(size_t)b * D + i] = delta[i];
    }

    // model_change = -<delta, g> - 0.5 <delta, JtJ delta> (undamped JtJ)
    float dg = mul(delta[0], g[0]);
#pragma unroll
    for (int i = 1; i < D; ++i) dg = add(dg, mul(delta[i], g[i]));
    float dad = 0.0f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
        float row = mul(jtj[i][0], delta[0]);
#pragma unroll
        for (int j = 1; j < D; ++j) row = add(row, mul(jtj[i][j], delta[j]));
        dad = add(dad, mul(delta[i], row));
    }
    mc_out[b] = sub(-dg, mul(0.5f, dad));
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

template <int D>
__global__ void commit_kernel(const CommitArgs a) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= a.B) return;
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
        const float gi = fabsf(a.g[(size_t)b * D + i]);
        g_nan = g_nan || isnan(gi);
        g_max = fmaxf(g_max, gi);
        const float di = a.delta[(size_t)b * D + i];
        const float ui = a.u[(size_t)b * D + i];
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
    for (int i = 0; i < D; ++i) {
        const size_t k = (size_t)b * D + i;
        const float uo = accept ? a.u_new[k] : a.u[k];
        u_finite = u_finite && isfinite(uo);
        a.u_o[k] = uo;
        a.g_o[k] = accept ? a.g_new[k] : a.g[k];
    }
#pragma unroll
    for (int i = 0; i < D * D; ++i) {
        const size_t k = (size_t)b * D * D + i;
        a.jtj_o[k] = accept ? a.jtj_new[k] : a.jtj[k];
    }

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
}

}  // namespace

extern "C" int social_mpc_propose_f32(const float* u, const float* g,
                                      const float* jtj, const float* radius,
                                      const float* lower, const float* upper,
                                      float* u_new, float* delta,
                                      float* model_change, int B, int D,
                                      float min_diagonal, float max_diagonal,
                                      cudaStream_t stream) {
    if (B <= 0) return (int)cudaGetLastError();
    const int threads = 128;
    const int blocks = (B + threads - 1) / threads;
#define LAUNCH_PROPOSE(DD)                                                     \
    propose_kernel<DD><<<blocks, threads, 0, stream>>>(                        \
        u, g, jtj, radius, lower, upper, u_new, delta, model_change, B,        \
        min_diagonal, max_diagonal)
    switch (D) {
        case 6: LAUNCH_PROPOSE(6); break;
        case 12: LAUNCH_PROPOSE(12); break;
        default: return (int)cudaErrorInvalidValue;
    }
#undef LAUNCH_PROPOSE
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
    const int threads = 128;
    const int blocks = (B + threads - 1) / threads;
    switch (D) {
        case 6: commit_kernel<6><<<blocks, threads, 0, stream>>>(a); break;
        case 12: commit_kernel<12><<<blocks, threads, 0, stream>>>(a); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
