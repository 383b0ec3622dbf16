// Variant `k4pre` of csrc/tr_iter.cu, timed by tools/torch_kernel_variants.py:
// hybrid, and commit's deciding threads load their nine scalars before the
// staging loads.

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
//   propose, D = 6:  one thread per scenario in 32-thread blocks (B = 1024
//            gives 32 SMs work, B = 4096 all of them), the system in
//            registers; JtJ read as float4 (a scenario's 144 bytes are
//            16-byte aligned) and the vectors as float2, all at once.
//   propose, D = 12: a segment of 16 lanes per scenario, lane i holding row
//            i of the system (loaded straight from device memory), so the
//            D^2-long serial chain of one thread and its 255 registers become
//            row-parallel work. The factorisation, both substitutions and
//            the model change run lane-parallel; the lanes exchange entries
//            by __shfl_sync within their segment.
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
// the kernels repeat the plain PyTorch version operation for operation. The
// D = 6 solve is chol.cuh's, shared with K7 (spd_solve.cu). Parallelising the
// D = 12 solve over rows never reorders a sum: each entry of L, y and x sums
// over k in chol.cuh's serial order, and the sums over rows of the model
// change are gathered to every lane and added in row order. A non-positive
// pivot gives sqrt(<0) = NaN or 1/0 = inf, which flows into a non-finite
// step that commit rejects; the box projection uses comparisons, not
// fminf/fmaxf, so that NaN is kept.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "chol.cuh"

namespace {

using social_mpc::add;
using social_mpc::mul;
using social_mpc::sub;

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREAD_BLOCK = 32;  // propose at D = 6: scenarios (threads) per block
constexpr int ROWS_BLOCK = 128;   // propose at D = 12: threads per block
constexpr int COMMIT_THREADS = 128;
constexpr int COMMIT_G = 8;  // scenarios per commit block: B = 1024 gives 128 blocks

// clamp that propagates NaN (as torch.clamp / jnp.clip do)
__device__ __forceinline__ float clamp_keep_nan(float x, float lo, float hi) {
    float y = x < lo ? lo : x;
    return y > hi ? hi : y;
}

__device__ __forceinline__ bool aligned(const void* p, uintptr_t bytes) {
    return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// model_change = -<delta, g> - 0.5 <delta, JtJ delta> (undamped JtJ), the
// sums in row order.
template <int D>
__device__ __forceinline__ float model_change(const float (&jtj)[D][D], const float (&g)[D],
                                              const float (&delta)[D]) {
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
    return sub(-dg, mul(0.5f, dad));
}

// One thread per scenario, the system in registers (D even, D * D a multiple
// of 4): every per-scenario span read and written with the widest aligned
// vectors, all loads issued before the solve.
template <int D>
__global__ void __launch_bounds__(THREAD_BLOCK)
propose_thread_kernel(const float* __restrict__ u_in, const float* __restrict__ g_in,
                      const float* __restrict__ jtj_in, const float* __restrict__ radius_in,
                      const float* __restrict__ lower, const float* __restrict__ upper,
                      float* __restrict__ u_new_out, float* __restrict__ delta_out,
                      float* __restrict__ mc_out, int B, float min_diagonal, float max_diagonal) {
    static_assert(D % 2 == 0 && (D * D) % 4 == 0, "vector widths");
    constexpr int DD = D * D;
    const int b = blockIdx.x * THREAD_BLOCK + threadIdx.x;
    if (b >= B) return;
    float jtj[D][D];
    float g[D], u[D], lo[D], hi[D];
    const bool vec = aligned(jtj_in, 16) && aligned(u_in, 8) && aligned(g_in, 8) &&
                     aligned(lower, 8) && aligned(upper, 8) && aligned(u_new_out, 8) &&
                     aligned(delta_out, 8);
    if (vec) {
        const float4* m4 = reinterpret_cast<const float4*>(jtj_in + (size_t)b * DD);
#pragma unroll
        for (int q = 0; q < DD / 4; ++q) {
            const float4 x = __ldg(m4 + q);
            jtj[(4 * q) / D][(4 * q) % D] = x.x;
            jtj[(4 * q + 1) / D][(4 * q + 1) % D] = x.y;
            jtj[(4 * q + 2) / D][(4 * q + 2) % D] = x.z;
            jtj[(4 * q + 3) / D][(4 * q + 3) % D] = x.w;
        }
#pragma unroll
        for (int q = 0; q < D / 2; ++q) {
            const size_t o = (size_t)b * (D / 2) + q;
            const float2 gg = __ldg(reinterpret_cast<const float2*>(g_in) + o);
            const float2 uu = __ldg(reinterpret_cast<const float2*>(u_in) + o);
            const float2 ll = __ldg(reinterpret_cast<const float2*>(lower) + o);
            const float2 hh = __ldg(reinterpret_cast<const float2*>(upper) + o);
            g[2 * q] = gg.x; g[2 * q + 1] = gg.y;
            u[2 * q] = uu.x; u[2 * q + 1] = uu.y;
            lo[2 * q] = ll.x; lo[2 * q + 1] = ll.y;
            hi[2 * q] = hh.x; hi[2 * q + 1] = hh.y;
        }
    } else {
#pragma unroll
        for (int i = 0; i < D; ++i) {
            const size_t o = (size_t)b * D + i;
            g[i] = __ldg(g_in + o);
            u[i] = __ldg(u_in + o);
            lo[i] = __ldg(lower + o);
            hi[i] = __ldg(upper + o);
#pragma unroll
            for (int j = 0; j < D; ++j) jtj[i][j] = __ldg(jtj_in + o * D + j);
        }
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

    float un[D], delta[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
        un[i] = clamp_keep_nan(add(u[i], x[i]), lo[i], hi[i]);
        delta[i] = sub(un[i], u[i]);
    }
    if (vec) {
#pragma unroll
        for (int q = 0; q < D / 2; ++q) {
            const size_t o = (size_t)b * (D / 2) + q;
            reinterpret_cast<float2*>(u_new_out)[o] = make_float2(un[2 * q], un[2 * q + 1]);
            reinterpret_cast<float2*>(delta_out)[o] = make_float2(delta[2 * q], delta[2 * q + 1]);
        }
    } else {
#pragma unroll
        for (int i = 0; i < D; ++i) {
            u_new_out[(size_t)b * D + i] = un[i];
            delta_out[(size_t)b * D + i] = delta[i];
        }
    }
    mc_out[b] = model_change<D>(jtj, g, delta);
}

// A segment of W lanes per scenario, lane r holding row r of the system:
// W a power of two >= D, so that a segment never straddles a warp.
template <int D>
struct RowsLayout {
    static constexpr int W = D <= 8 ? 8 : 16;
    static constexpr int SCEN = ROWS_BLOCK / W;  // scenarios per block
};

template <int D>
__global__ void __launch_bounds__(ROWS_BLOCK)
propose_rows_kernel(const float* __restrict__ u_in, const float* __restrict__ g_in,
                    const float* __restrict__ jtj_in, const float* __restrict__ radius_in,
                    const float* __restrict__ lower, const float* __restrict__ upper,
                    float* __restrict__ u_new_out, float* __restrict__ delta_out,
                    float* __restrict__ mc_out, int B, float min_diagonal, float max_diagonal) {
    using L = RowsLayout<D>;
    constexpr int W = L::W;
    const int b0 = blockIdx.x * L::SCEN;
    const int n = min(L::SCEN, B - b0);
    // Segment `seg` solves scenario b0 + seg; lane i of it holds row i. Lanes
    // past D, and segments past the batch, mirror the last row / scenario so
    // that every lane takes part in the shuffles; they write nothing.
    const int seg = threadIdx.x / W;
    const int i = threadIdx.x % W;
    const bool writes = seg < n && i < D;
    const size_t b = (size_t)b0 + min(seg, n - 1);
    const int r = min(i, D - 1);
    const size_t v = b * D + r;
    const float gi = __ldg(g_in + v), ui = __ldg(u_in + v), lo = __ldg(lower + v),
                hi = __ldg(upper + v);
    const float inv_radius = 1.0f / radius_in[b];
    float row[D];  // row r of the undamped JtJ
    const float* src = jtj_in + v * D;
    if (D % 4 == 0 && aligned(jtj_in, 16)) {
#pragma unroll
        for (int q = 0; q < D / 4; ++q) {
            const float4 x = __ldg(reinterpret_cast<const float4*>(src) + q);
            row[4 * q] = x.x; row[4 * q + 1] = x.y; row[4 * q + 2] = x.z; row[4 * q + 3] = x.w;
        }
    } else {
#pragma unroll
        for (int j = 0; j < D; ++j) row[j] = __ldg(src + j);
    }
    float ajj = row[0];
#pragma unroll
    for (int j = 1; j < D; ++j) ajj = r == j ? row[j] : ajj;
    const float damped = add(ajj, mul(clamp_keep_nan(ajj, min_diagonal, max_diagonal), inv_radius));

    // Cholesky A = L L^T (chol.cuh's order): at column j, lane r > j computes
    // L[r][j] = (a(r,j) - sum_k<j L[r][k] L[j][k]) * inv_diag[j] and lane j
    // the pivot from the same sum; L[j][k] comes from lane j by shuffle.
    float el[D];    // el[k] = L[r][k], k <= r
    float colL[D];  // colL[k] = L[k][r], k > r: column r, for the back substitution
    float inv[D];   // inv_diag[k] of every row
#pragma unroll
    for (int k = 0; k < D; ++k) el[k] = colL[k] = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
        float t = r == j ? damped : row[j];
#pragma unroll
        for (int k = 0; k < j; ++k) t = sub(t, mul(el[k], __shfl_sync(FULL, el[k], j, W)));
        float ljj = 0.0f, invj = 0.0f;
        if (r == j) {
            ljj = sqrtf(t);
            invj = 1.0f / ljj;
        }
        invj = __shfl_sync(FULL, invj, j, W);
        inv[j] = invj;
        if (r == j) el[j] = ljj;
        else if (r > j) el[j] = mul(t, invj);
#pragma unroll
        for (int k = j + 1; k < D; ++k) {
            const float lkj = __shfl_sync(FULL, el[j], k, W);
            if (r == j) colL[k] = lkj;
        }
    }

    // Forward substitution L y = -g: y[k] = (-g[k] - sum_m<k L[k][m] y[m]) * inv_diag[k].
    float s = -gi, y = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
        const float yk = __shfl_sync(FULL, mul(s, inv[k]), k, W);
        if (r == k) y = yk;
        if (r > k) s = sub(s, mul(el[k], yk));
    }
    // Back substitution L^T x = y, x[k] = (y[k] - sum_m>k L[m][k] x[m]) * inv_diag[k],
    // the sum in ascending m: serial, one row after the other.
    float xs[D];
    float x = 0.0f;
#pragma unroll
    for (int k = D - 1; k >= 0; --k) {
        float t = y;
#pragma unroll
        for (int m = k + 1; m < D; ++m) t = sub(t, mul(colL[m], xs[m]));
        xs[k] = __shfl_sync(FULL, mul(t, inv[k]), k, W);
        if (r == k) x = xs[k];
    }

    const float un = clamp_keep_nan(add(ui, x), lo, hi);
    const float delta = sub(un, ui);
    if (writes) {
        u_new_out[v] = un;
        delta_out[v] = delta;
    }

    // The model change: lane r computes its row's products, the sums over
    // rows run in row order.
    float jd = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
        const float p = mul(row[j], __shfl_sync(FULL, delta, j, W));
        jd = j == 0 ? p : add(jd, p);
    }
    const float dg_r = mul(delta, gi), dad_r = mul(delta, jd);
    float dg = __shfl_sync(FULL, dg_r, 0, W), dad = 0.0f;
#pragma unroll
    for (int k = 1; k < D; ++k) dg = add(dg, __shfl_sync(FULL, dg_r, k, W));
#pragma unroll
    for (int k = 0; k < D; ++k) dad = add(dad, __shfl_sync(FULL, dad_r, k, W));
    if (writes && i == 0) mc_out[b] = sub(-dg, mul(0.5f, dad));
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
struct CommitScalars {
    float cost, radius, decrease, mc, new_cost;
    int iters, term;
    bool done, failed;
};

__device__ __forceinline__ CommitScalars load_scalars(const CommitArgs& a, int b) {
    return {__ldg(a.cost + b), __ldg(a.radius + b), __ldg(a.decrease + b),
            __ldg(a.model_change + b), __ldg(a.new_cost + b), __ldg(a.iters + b),
            __ldg(a.term + b), a.done[b] != 0, a.failed[b] != 0};
}

template <int D>
__device__ __forceinline__ bool commit_decide(const CommitArgs& a, int b, const CommitScalars& sc,
                                              const float* u, const float* u_new, const float* g,
                                              const float* delta) {
    const float cost = sc.cost;
    const float radius = sc.radius;
    const float decrease = sc.decrease;
    const bool done = sc.done;
    const bool failed = sc.failed;
    const float mc = sc.mc;
    const float new_cost = sc.new_cost;

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
    a.iters_o[b] = sc.iters + (active ? 1 : 0);
    a.done_o[b] = (done || newly_done) ? 1 : 0;
    a.term_o[b] = done ? sc.term : term_new;
    a.failed_o[b] = (failed || numeric_failed) ? 1 : 0;
    return accept;
}

template <int D>
__global__ void __launch_bounds__(COMMIT_THREADS) commit_kernel(const CommitArgs a) {
    constexpr int G = COMMIT_G, DD = D * D;
    static_assert(DD % 4 == 0, "a float4 of JtJ must not straddle two scenarios");
    __shared__ float s_u[G * D], s_un[G * D], s_g[G * D], s_d[G * D];
    __shared__ bool s_acc[G];
    const int t = threadIdx.x;
    const int b0 = blockIdx.x * G;
    const int n = min(G, a.B - b0);

    // Phase 1, decide: stage the vectors the scalars need, coalesced (a
    // thread's stride-D reads of them are free of bank conflicts at G = 8).
    CommitScalars sc{};
    if (t < n) sc = load_scalars(a, b0 + t);
    const size_t v0 = (size_t)b0 * D;
    for (int k = t; k < n * D; k += COMMIT_THREADS) {
        s_u[k] = a.u[v0 + k];
        s_un[k] = a.u_new[v0 + k];
        s_g[k] = a.g[v0 + k];
        s_d[k] = a.delta[v0 + k];
    }
    __syncthreads();
    if (t < n) s_acc[t] = commit_decide<D>(a, b0 + t, sc, s_u + t * D, s_un + t * D, s_g + t * D,
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

}  // namespace

extern "C" int social_mpc_propose_f32(const float* u, const float* g,
                                      const float* jtj, const float* radius,
                                      const float* lower, const float* upper,
                                      float* u_new, float* delta,
                                      float* model_change, int B, int D,
                                      float min_diagonal, float max_diagonal,
                                      cudaStream_t stream) {
    if (B <= 0) return (int)cudaGetLastError();
    switch (D) {
        case 6:
            propose_thread_kernel<6><<<(B + THREAD_BLOCK - 1) / THREAD_BLOCK, THREAD_BLOCK, 0,
                                       stream>>>(u, g, jtj, radius, lower, upper, u_new, delta,
                                                 model_change, B, min_diagonal, max_diagonal);
            break;
        case 12:
            propose_rows_kernel<12><<<(B + RowsLayout<12>::SCEN - 1) / RowsLayout<12>::SCEN,
                                      ROWS_BLOCK, 0, stream>>>(u, g, jtj, radius, lower, upper,
                                                               u_new, delta, model_change, B,
                                                               min_diagonal, max_diagonal);
            break;
        default: return (int)cudaErrorInvalidValue;
    }
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
    switch (D) {
        case 6: commit_kernel<6><<<blocks, COMMIT_THREADS, 0, stream>>>(a); break;
        case 12: commit_kernel<12><<<blocks, COMMIT_THREADS, 0, stream>>>(a); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
