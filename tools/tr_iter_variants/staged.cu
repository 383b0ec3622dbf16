// Variant `staged` of csrc/tr_iter.cu, timed by tools/torch_kernel_variants.py:
// the parent's thread per scenario, 32 scenarios a block, every load and store
// through padded shared memory (K3 and K4).

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
// Both kernels are bound by bytes — a few hundred bytes per scenario against
// a few hundred operations — and at these sizes by latency, so the design is
// about spreading a batch over the card's 132 SMs with coalesced accesses:
//
//   propose: a segment of W lanes per scenario (W = 8 at D = 6, four
//            scenarios a warp; W = 16 at D = 12, two), lane i holding row i
//            of the system. The block stages its scenarios' JtJ into shared
//            memory with coalesced loads, rows padded to D + 1 floats so that
//            the segments' row reads are free of bank conflicts. The
//            factorisation, both substitutions and the model change run
//            lane-parallel over rows; the lanes exchange entries by
//            __shfl_sync within their segment.
//   commit:  decide, then copy. A block covers COMMIT_G scenarios. One thread
//            per scenario computes every scalar from u, u_new, delta and g
//            staged through shared memory and leaves its accept flag there;
//            after one barrier the whole block copies the contiguous spans
//            of u, g and JtJ that its scenarios own, each element from the
//            source its scenario's flag selects (float4 where the spans are
//            16-byte aligned). The copy is where the bytes are.
//
// Numerics: every product, sum and difference is written with the
// round-to-nearest intrinsics (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc
// never contracts into FMA, and division and sqrtf are IEEE (no fast math):
// the kernels repeat the plain PyTorch version operation for operation.
// Parallelising propose over rows never reorders a sum: each entry of L, y
// and x sums over k in the serial order of chol.cuh (which K7, spd_solve.cu,
// runs serially), and the sums over rows of the model change are gathered to
// every lane and added in row order. A non-positive pivot gives sqrt(<0) =
// NaN or 1/0 = inf, which flows into a non-finite step that commit rejects;
// the box projection uses comparisons, not fminf/fmaxf, so that NaN is kept.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "chol.cuh"

namespace {

using social_mpc::add;
using social_mpc::mul;
using social_mpc::sub;

constexpr unsigned FULL = 0xffffffffu;
constexpr int PROPOSE_THREADS = 128;
constexpr int COMMIT_THREADS = 128;
constexpr int COMMIT_G = 8;  // scenarios per commit block: B = 1024 gives 128 blocks

// clamp that propagates NaN (as torch.clamp / jnp.clip do)
__device__ __forceinline__ float clamp_keep_nan(float x, float lo, float hi) {
    float y = x < lo ? lo : x;
    return y > hi ? hi : y;
}

__device__ __forceinline__ bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

constexpr int SB = 32;  // scenarios (= threads) per block

template <int D>
__global__ void __launch_bounds__(SB)
propose_kernel(const float* __restrict__ u_in, const float* __restrict__ g_in,
               const float* __restrict__ jtj_in, const float* __restrict__ radius_in,
               const float* __restrict__ lower, const float* __restrict__ upper,
               float* __restrict__ u_new_out, float* __restrict__ delta_out,
               float* __restrict__ mc_out, int B, float min_diagonal, float max_diagonal) {
    constexpr int DD = D * D, PM = DD + 1, PV = D + 1;
    __shared__ float s_jtj[SB * PM];
    __shared__ float s_g[SB * PV], s_u[SB * PV], s_lo[SB * PV], s_hi[SB * PV];
    const int t = threadIdx.x;
    const int b0 = blockIdx.x * SB;
    const int n = min(SB, B - b0);
    for (int k = t; k < n * DD; k += SB) s_jtj[k + k / DD] = __ldg(jtj_in + (size_t)b0 * DD + k);
    for (int k = t; k < n * D; k += SB) {
        const size_t gk = (size_t)b0 * D + k;
        const int sk = k + k / D;
        s_g[sk] = __ldg(g_in + gk);
        s_u[sk] = __ldg(u_in + gk);
        s_lo[sk] = __ldg(lower + gk);
        s_hi[sk] = __ldg(upper + gk);
    }
    __syncthreads();
    if (t < n) {
        const float* J = s_jtj + t * PM;
        float* uu = s_u + t * PV;
        float* gg = s_g + t * PV;
        float* lo = s_lo + t * PV;
        float* hi = s_hi + t * PV;
        const float inv_radius = 1.0f / radius_in[b0 + t];
        float neg_g[D];
#pragma unroll
        for (int i = 0; i < D; ++i) neg_g[i] = -gg[i];
        float x[D];
        social_mpc::chol_solve<D>(
            [&](int i, int j) {
                if (i != j) return J[i * D + j];
                const float diag = clamp_keep_nan(J[j * D + j], min_diagonal, max_diagonal);
                return add(J[j * D + j], mul(diag, inv_radius));
            },
            neg_g, x);
        float delta[D];
#pragma unroll
        for (int i = 0; i < D; ++i) {
            const float un = clamp_keep_nan(add(uu[i], x[i]), lo[i], hi[i]);
            delta[i] = sub(un, uu[i]);
            lo[i] = un;  // the outputs replace the bounds in shared memory
            hi[i] = delta[i];
        }
        float dg = mul(delta[0], gg[0]);
#pragma unroll
        for (int i = 1; i < D; ++i) dg = add(dg, mul(delta[i], gg[i]));
        float dad = 0.0f;
#pragma unroll
        for (int i = 0; i < D; ++i) {
            float row = mul(J[i * D], delta[0]);
#pragma unroll
            for (int j = 1; j < D; ++j) row = add(row, mul(J[i * D + j], delta[j]));
            dad = add(dad, mul(delta[i], row));
        }
        mc_out[b0 + t] = sub(-dg, mul(0.5f, dad));
    }
    __syncthreads();
    for (int k = t; k < n * D; k += SB) {
        const size_t gk = (size_t)b0 * D + k;
        const int sk = k + k / D;
        u_new_out[gk] = s_lo[sk];
        delta_out[gk] = s_hi[sk];
    }
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
template <int D>
__device__ __forceinline__ bool commit_decide(const CommitArgs& a, int b, const float* u,
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

template <int D>
__global__ void __launch_bounds__(SB) commit_kernel(const CommitArgs a) {
    constexpr int DD = D * D, PM = DD + 1, PV = D + 1;
    __shared__ float s_jtj[SB * PM], s_jn[SB * PM];
    __shared__ float s_u[SB * PV], s_un[SB * PV], s_g[SB * PV], s_gn[SB * PV], s_d[SB * PV];
    const int t = threadIdx.x;
    const int b0 = blockIdx.x * SB;
    const int n = min(SB, a.B - b0);
    const size_t m0 = (size_t)b0 * DD, v0 = (size_t)b0 * D;
    for (int k = t; k < n * DD; k += SB) {
        s_jtj[k + k / DD] = __ldg(a.jtj + m0 + k);
        s_jn[k + k / DD] = __ldg(a.jtj_new + m0 + k);
    }
    for (int k = t; k < n * D; k += SB) {
        const int sk = k + k / D;
        s_u[sk] = __ldg(a.u + v0 + k);
        s_un[sk] = __ldg(a.u_new + v0 + k);
        s_g[sk] = __ldg(a.g + v0 + k);
        s_gn[sk] = __ldg(a.g_new + v0 + k);
        s_d[sk] = __ldg(a.delta + v0 + k);
    }
    __syncthreads();
    if (t < n) {
        const bool acc = commit_decide<D>(a, b0 + t, s_u + t * PV, s_un + t * PV, s_g + t * PV,
                                          s_d + t * PV);
        if (acc) {
#pragma unroll
            for (int i = 0; i < D; ++i) {
                s_u[t * PV + i] = s_un[t * PV + i];
                s_g[t * PV + i] = s_gn[t * PV + i];
            }
#pragma unroll
            for (int k = 0; k < DD; ++k) s_jtj[t * PM + k] = s_jn[t * PM + k];
        }
    }
    __syncthreads();
    for (int k = t; k < n * DD; k += SB) a.jtj_o[m0 + k] = s_jtj[k + k / DD];
    for (int k = t; k < n * D; k += SB) {
        const int sk = k + k / D;
        a.u_o[v0 + k] = s_u[sk];
        a.g_o[v0 + k] = s_g[sk];
    }
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
#define LAUNCH_PROPOSE(DD)                                                     \
    propose_kernel<DD><<<(B + SB - 1) / SB, SB, 0, stream>>>(                        \
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
    const int blocks = (B + SB - 1) / SB;
    switch (D) {
        case 6: commit_kernel<6><<<blocks, SB, 0, stream>>>(a); break;
        case 12: commit_kernel<12><<<blocks, SB, 0, stream>>>(a); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
