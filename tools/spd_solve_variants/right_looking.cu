// Variant `right_looking` of csrc/spd_solve.cu, timed by tools/torch_kernel_variants.py:
// as the checkout, but the block form (D > 32) right-looking: two barriers a column
// (the column below the pivot scaled and the rows' running sums updated, then
// every thread's share of the trailing triangle, rows cyclic over 32 slots and
// each row's columns over blockDim / 32 phases, in chunks of 8 whose loads go
// before their stores; the next pivot by the thread that updates its entry),
// and warp 0's back substitution on products formed as each x_m is known, in
// the unused upper triangle (row k's contiguous), its chain's loads a chunk ahead.

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
// layouts measured for K3: up to D = 6 one thread per scenario in 32-thread
// blocks (B = 4096 gives all 132 SMs work), the matrix read as float4 and the
// vectors as float2 where aligned; above, a segment of 8 (D <= 8) or 16 lanes
// per scenario, lane i holding row i. The damped step is instantiated for
// every even D of kernel_shapes.h's SOCIAL_MPC_SOLVE_DIMS (2..12), the
// standalone solve for every D of SOCIAL_MPC_SPD_SOLVE_DIMS (1..16).
// Templated on the Jacobi scaling (JAC), which forms each scaled entry where
// the factorisation reads it, so JtJ is held once.
// The standalone solve runs on the same layouts (the parent's one thread per
// system in 128-thread blocks filled 32 SMs at B = 4096 and read its systems
// D * D floats apart).
//
// The general form (damped_step.cuh, D at run time) takes every D past
// those lists up to kernel_shapes.h's SOCIAL_MPC_GENERAL_MAX_DIM: a config
// in more than 6 blocks, a caller's own larger system. Up to D = 32 a warp
// a system, several systems a block, the right-looking factor in
// registers and no block barrier; above, a block a system, the
// right-looking factor in shared memory, a thread a row (or a share of
// one), two barriers a column. (The first general form,
// left-looking, a block a system and back substitution on one thread, is
// kept as tools/spd_solve_variants/left_looking.cu.)
//
// Numerics: chol.cuh's order of every operation and its round-to-nearest
// intrinsics, IEEE division and sqrtf: both entries repeat their plain
// versions (solver/cuda_iter.py: damped_step_plain, solver/cuda_solve.py:
// spd_solve_plain) bit for bit.

#include <cuda_runtime.h>

#include "damped_step.cuh"
#include "kernel_shapes.h"

static_assert(social_mpc::GENERAL_LANE_SPAN * 32 >= SOCIAL_MPC_GENERAL_MAX_DIM,
              "the block form's back substitution: a warp's lanes cover a row");


namespace right_looking {

using namespace social_mpc;

constexpr int CHUNK = 8;  // as measured

__device__ __forceinline__ void block_chol_solve(const GeneralSystem& m) {
    const int t = threadIdx.x, G = blockDim.x, lane = t & 31, D = m.D, ld = m.ld;
    // The trailing triangle's rows are cyclic over 32 slots and each row's
    // columns over T = G / 32 phases: thread t takes rows slot, slot + 32,
    // ... (slot = t / T) at columns k + 1 + phase, + T, ... (phase = t % T).
    const int T = G >> 5, phase = t % T, slot = t / T;
    float* L = m.L;
    if (t == 0) {  // the first pivot
        const float ljj = sqrtf(L[0]);
        m.inv[0] = 1.0f / ljj;
        m.y[0] = mul(m.s[0], m.inv[0]);
    }
    __syncthreads();
    for (int k = 0; k < D - 1; ++k) {
        const float invk = m.inv[k], yk = m.y[k];
        // column k scaled and each row's running sum s_i -= L_ik y_k: the
        // rows below k cyclic over the block's threads
        for (int i = k + 1 + t; i < D; i += G) {
            const float aik = L[(size_t)i * ld + k], si = m.s[i];
            const float lik = mul(aik, invk);
            L[(size_t)i * ld + k] = lik;
            m.s[i] = sub(si, mul(lik, yk));
        }
        __syncthreads();
        // the trailing triangle: L_ij -= L_ik L_jk for j in (k, i]
        for (int i = slot; i < D; i += 32) {
            if (i <= k) continue;
            float* li = L + (size_t)i * ld;
            const float lik = li[k];
            for (int j0 = k + 1 + phase; j0 <= i; j0 += CHUNK * T) {
                float lij[CHUNK], ljk[CHUNK];
#pragma unroll
                for (int c = 0; c < CHUNK; ++c) {
                    const int j = j0 + c * T;
                    lij[c] = j <= i ? li[j] : 0.0f;
                    ljk[c] = j <= i ? L[(size_t)j * ld + k] : 0.0f;
                }
#pragma unroll
                for (int c = 0; c < CHUNK; ++c) {
                    const int j = j0 + c * T;
                    if (j <= i) li[j] = sub(lij[c], mul(lik, ljk[c]));
                }
            }
            if (i == k + 1 && phase == 0) {  // the next pivot: this row's only entry
                const float ljj = sqrtf(li[i]);
                const float inv = 1.0f / ljj;
                m.inv[i] = inv;
                m.y[i] = mul(m.s[i], inv);
            }
        }
        __syncthreads();
    }
    // Back substitution by warp 0: x_k = (y_k - sum_m>k P_km) * inv_k, the
    // sum in ascending m, where P_km = L_mk x_m was written at (k, m), above
    // the diagonal, when x_m became known. Every lane runs the chain (its
    // loads are broadcasts, a chunk ahead of the subtractions), then the
    // lanes form x_k's products.
    if (t < 32) {
        for (int k = D - 1; k >= 0; --k) {
            const float* pk = L + (size_t)k * ld;
            float v = m.y[k];
            // whole chunks, the next chunk's loads before this one's subtractions
            const int n_chunks = (D - 1 - k) / CHUNK;
            int q = k + 1;
            float cur[CHUNK];
#pragma unroll
            for (int c = 0; c < CHUNK; ++c) cur[c] = n_chunks > 0 ? pk[q + c] : 0.0f;
            for (int f = 0; f < n_chunks; ++f, q += CHUNK) {
                const bool more = f + 1 < n_chunks;
                float nxt[CHUNK];
#pragma unroll
                for (int c = 0; c < CHUNK; ++c)
                    nxt[c] = more ? pk[q + CHUNK + c] : 0.0f;
#pragma unroll
                for (int c = 0; c < CHUNK; ++c) v = sub(v, cur[c]);
#pragma unroll
                for (int c = 0; c < CHUNK; ++c) cur[c] = nxt[c];
            }
            // the rest, fewer than a chunk
#pragma unroll
            for (int c = 0; c < CHUNK; ++c) cur[c] = q + c < D ? pk[q + c] : 0.0f;
#pragma unroll
            for (int c = 0; c < CHUNK; ++c)
                if (q + c < D) v = sub(v, cur[c]);
            const float xk = mul(v, m.inv[k]);
            if (lane == 0) m.x[k] = xk;
            // x_k's products L_kj x_k, j < k, at (j, k): row k's loads first
            float lkj[GENERAL_LANE_SPAN];
#pragma unroll
            for (int c = 0; c < GENERAL_LANE_SPAN; ++c) {
                const int j = lane + 32 * c;
                lkj[c] = j < k ? pk[j] : 0.0f;
            }
#pragma unroll
            for (int c = 0; c < GENERAL_LANE_SPAN; ++c) {
                const int j = lane + 32 * c;
                if (j < k) L[(size_t)j * ld + k] = mul(lkj[c], xk);
            }
            __syncwarp();
        }
    }
    __syncthreads();
}

template <bool JAC>
__device__ __forceinline__ void damped_step_block(const DampedStepArgs& p, int D, float* shared) {
    const int b = blockIdx.x, t = threadIdx.x, G = blockDim.x;
    const GeneralSystem m(shared, D);
    const size_t o = (size_t)b * D;
    const float* jtj = p.jtj + o * D;
    const float inv_radius = 1.0f / p.radius[b];
    for (int r = t; r < D; r += G) m.w[r] = JAC ? __ldg(p.jac_scale + o + r) : 1.0f;
    __syncthreads();
    // The damped (scaled) system's lower triangle.
    block_load_lower(m, jtj, [&](int i, int j, float e) {
        if (JAC) e = mul(e, mul(m.w[i], m.w[j]));
        if (i == j) e = add(e, mul(clamp_keep_nan(e, p.min_diagonal, p.max_diagonal), inv_radius));
        return e;
    });
    for (int r = t; r < D; r += G) {
        const float gr = __ldg(p.g + o + r);
        m.s[r] = JAC ? -mul(m.w[r], gr) : -gr;
    }
    __syncthreads();
    right_looking::block_chol_solve(m);

    // Map back, project, and keep delta (in y) for the model change.
    for (int r = t; r < D; r += G) {
        const float step = JAC ? mul(m.w[r], m.x[r]) : m.x[r];
        const float ur = __ldg(p.u + o + r);
        const float un = clamp_keep_nan(add(ur, step), __ldg(p.lower + o + r),
                                        __ldg(p.upper + o + r));
        const float delta = sub(un, ur);
        p.u_new[o + r] = un;
        p.delta[o + r] = delta;
        m.y[r] = delta;
    }
    __syncthreads();
    // The model change: each row's products, then the sums over rows in
    // row order (tcol: delta_r g_r, s: delta_r (JtJ delta)_r).
    for (int r = t; r < D; r += G) {
        const float* row = jtj + (size_t)r * D;
        float jd = mul(__ldg(row), m.y[0]);
#pragma unroll 8
        for (int j = 1; j < D; ++j) jd = add(jd, mul(__ldg(row + j), m.y[j]));
        m.tcol[r] = mul(m.y[r], __ldg(p.g + o + r));
        m.s[r] = mul(m.y[r], jd);
    }
    __syncthreads();
    if (t == 0) {  // the two sums' chains side by side (dad from +0, as the plain sum)
        float dg = m.tcol[0], dad = add(0.0f, m.s[0]);
#pragma unroll 8
        for (int k = 1; k < D; ++k) {
            dg = add(dg, m.tcol[k]);
            dad = add(dad, m.s[k]);
        }
        p.model_change[b] = sub(-dg, mul(0.5f, dad));
    }
}

}  // namespace right_looking

namespace {

using social_mpc::DampedStepArgs;
using social_mpc::ROWS_BLOCK;
using social_mpc::rows_scenarios;
using social_mpc::THREAD_BLOCK;
using social_mpc::THREAD_MAX_D;

template <int D, bool JAC>
__global__ void __launch_bounds__(THREAD_BLOCK) damped_step_thread_kernel(const DampedStepArgs p) {
    const int b = blockIdx.x * THREAD_BLOCK + threadIdx.x;
    if (b >= p.B) return;
    social_mpc::damped_step_thread<D, JAC>(p, b);
}

template <int D, bool JAC>
__global__ void __launch_bounds__(ROWS_BLOCK) damped_step_rows_kernel(const DampedStepArgs p) {
    social_mpc::damped_step_rows<D, JAC>(p);
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
    if constexpr (D <= THREAD_MAX_D)
        damped_step_thread_kernel<D, JAC>
            <<<(p.B + THREAD_BLOCK - 1) / THREAD_BLOCK, THREAD_BLOCK, 0, stream>>>(p);
    else
        damped_step_rows_kernel<D, JAC>
            <<<(p.B + rows_scenarios<D>() - 1) / rows_scenarios<D>(), ROWS_BLOCK, 0, stream>>>(p);
}

template <int D>
void launch_spd_solve(const float* a, const float* b, float* x, int N, cudaStream_t stream) {
    if constexpr (D <= THREAD_MAX_D)
        spd_solve_thread_kernel<D>
            <<<(N + THREAD_BLOCK - 1) / THREAD_BLOCK, THREAD_BLOCK, 0, stream>>>(a, b, x, N);
    else
        spd_solve_rows_kernel<D>
            <<<(N + rows_scenarios<D>() - 1) / rows_scenarios<D>(), ROWS_BLOCK, 0, stream>>>(
                a, b, x, N);
}

// The general form (damped_step.cuh), D at run time: a warp a system to
// D = 32 (CAP: the registers' ceiling, the multiple of 4 from 16 at or
// above D), several systems a block, no shared memory; a block a system
// above.
template <int CAP, bool JAC>
__global__ void damped_step_general_warp_kernel(const DampedStepArgs p, int D) {
    social_mpc::damped_step_warp<CAP, JAC>(p, D);
}

template <bool JAC>
__global__ void __launch_bounds__(1024)
damped_step_general_block_kernel(const DampedStepArgs p, int D) {
    extern __shared__ float shared[];
    right_looking::damped_step_block<JAC>(p, D, shared);
}

template <int CAP>
__global__ void spd_solve_general_warp_kernel(const float* __restrict__ a_in,
                                              const float* __restrict__ b_in,
                                              float* __restrict__ x_out, int N, int D) {
    social_mpc::spd_solve_warp<CAP>(a_in, b_in, x_out, N, D);
}

__global__ void __launch_bounds__(1024)
spd_solve_general_block_kernel(const float* __restrict__ a_in, const float* __restrict__ b_in,
                       float* __restrict__ x_out, int D) {
    extern __shared__ float shared[];
    const social_mpc::GeneralSystem m(shared, D);
    const int t = threadIdx.x, G = blockDim.x;
    const size_t o = (size_t)blockIdx.x * D;
    social_mpc::block_load_lower(m, a_in + o * D, [](int, int, float e) { return e; });
    for (int r = t; r < D; r += G) m.s[r] = __ldg(b_in + o + r);
    __syncthreads();
    right_looking::block_chol_solve(m);
    for (int r = t; r < D; r += G) x_out[o + r] = m.x[r];
}

// Launch `kernel` on `n` systems at the wrapper's geometry, opting in to
// more than 48 KB of shared memory once (`opted`: the kernel's own).
template <typename Kernel, typename... Args>
int launch_general(Kernel kernel, int& opted, int n, int threads, int systems, int shared,
                   cudaStream_t stream, Args... args) {
    const int err = social_mpc::general_opt_in(kernel, (size_t)shared, opted);
    if (err != 0) return err;
    kernel<<<(n + systems - 1) / systems, systems * threads, shared, stream>>>(args...);
    return (int)cudaGetLastError();
}

template <int CAP, bool JAC>
int launch_damped_step_warp(const DampedStepArgs& p, int D, int threads, int systems, int shared,
                            cudaStream_t stream) {
    static int opted = 0;
    return launch_general(damped_step_general_warp_kernel<CAP, JAC>, opted, p.B, threads, systems,
                          shared, stream, p, D);
}

template <bool JAC>
int launch_damped_step_general(const DampedStepArgs& p, int D, int threads, int systems,
                               int shared, cudaStream_t stream) {
    if (D <= 16) return launch_damped_step_warp<16, JAC>(p, D, threads, systems, shared, stream);
    if (D <= 20) return launch_damped_step_warp<20, JAC>(p, D, threads, systems, shared, stream);
    if (D <= 24) return launch_damped_step_warp<24, JAC>(p, D, threads, systems, shared, stream);
    if (D <= 28) return launch_damped_step_warp<28, JAC>(p, D, threads, systems, shared, stream);
    if (D <= 32) return launch_damped_step_warp<32, JAC>(p, D, threads, systems, shared, stream);
    static int opted = 0;
    return launch_general(damped_step_general_block_kernel<JAC>, opted, p.B, threads, 1, shared,
                          stream, p, D);
}

template <int CAP>
int launch_spd_solve_warp(const float* a, const float* b, float* x, int N, int D, int threads,
                          int systems, int shared, cudaStream_t stream) {
    static int opted = 0;
    return launch_general(spd_solve_general_warp_kernel<CAP>, opted, N, threads, systems, shared,
                          stream, a, b, x, N, D);
}

}  // namespace

extern "C" int social_mpc_damped_step_f32(const float* u, const float* g, const float* jtj,
                                          const float* radius, const float* lower,
                                          const float* upper, const float* jac_scale,
                                          float* u_new, float* delta, float* model_change,
                                          int B, int D, float min_diagonal, float max_diagonal,
                                          cudaStream_t stream) {
    const DampedStepArgs p{u, g, jtj, radius, lower, upper, jac_scale, u_new, delta,
                           model_change, B, min_diagonal, max_diagonal};
    const bool jac = jac_scale != nullptr;
#define DAMPED_STEP_CASE(D_)                                 \
    case D_:                                                 \
        if (B <= 0) break;                                   \
        if (jac) launch_damped_step<D_, true>(p, stream);    \
        else launch_damped_step<D_, false>(p, stream);       \
        break;
    switch (D) {
        SOCIAL_MPC_SOLVE_DIMS(DAMPED_STEP_CASE)
        default: return (int)cudaErrorInvalidValue;
    }
#undef DAMPED_STEP_CASE
    return (int)cudaGetLastError();
}

extern "C" int social_mpc_spd_solve_f32(const float* a, const float* b, float* x,
                                        int N, int D, cudaStream_t stream) {
    if (N <= 0) return (int)cudaGetLastError();
#define SPD_SOLVE_CASE(D_) \
    case D_: launch_spd_solve<D_>(a, b, x, N, stream); break;
    switch (D) {
        SOCIAL_MPC_SPD_SOLVE_DIMS(SPD_SOLVE_CASE)
        default: return (int)cudaErrorInvalidValue;
    }
#undef SPD_SOLVE_CASE
    return (int)cudaGetLastError();
}

// The general forms: the damped step at every even D up to
// SOCIAL_MPC_GENERAL_MAX_DIM, the standalone solve at every D up to it (the
// wrappers take them past the templated lists), at the wrapper's launch
// geometry (kernel_shapes.general_solve_geometry: threads a system,
// systems a block, shared bytes a block).
extern "C" int social_mpc_damped_step_general_f32(
    const float* u, const float* g, const float* jtj, const float* radius, const float* lower,
    const float* upper, const float* jac_scale, float* u_new, float* delta, float* model_change,
    int B, int D, float min_diagonal, float max_diagonal, int threads, int systems, int shared,
    cudaStream_t stream) {
    if (D < 1 || D > SOCIAL_MPC_GENERAL_MAX_DIM || D % 2 != 0 ||
        !social_mpc::general_geometry_ok(D, threads, systems, shared))
        return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaGetLastError();
    const DampedStepArgs p{u, g, jtj, radius, lower, upper, jac_scale, u_new, delta,
                           model_change, B, min_diagonal, max_diagonal};
    return jac_scale != nullptr
               ? launch_damped_step_general<true>(p, D, threads, systems, shared, stream)
               : launch_damped_step_general<false>(p, D, threads, systems, shared, stream);
}

extern "C" int social_mpc_spd_solve_general_f32(const float* a, const float* b, float* x,
                                                int N, int D, int threads, int systems,
                                                int shared, cudaStream_t stream) {
    if (D < 1 || D > SOCIAL_MPC_GENERAL_MAX_DIM ||
        !social_mpc::general_geometry_ok(D, threads, systems, shared))
        return (int)cudaErrorInvalidValue;
    if (N <= 0) return (int)cudaGetLastError();
    if (D <= 16) return launch_spd_solve_warp<16>(a, b, x, N, D, threads, systems, shared, stream);
    if (D <= 20) return launch_spd_solve_warp<20>(a, b, x, N, D, threads, systems, shared, stream);
    if (D <= 24) return launch_spd_solve_warp<24>(a, b, x, N, D, threads, systems, shared, stream);
    if (D <= 28) return launch_spd_solve_warp<28>(a, b, x, N, D, threads, systems, shared, stream);
    if (D <= 32) return launch_spd_solve_warp<32>(a, b, x, N, D, threads, systems, shared, stream);
    static int opted = 0;
    return launch_general(spd_solve_general_block_kernel, opted, N, threads, 1, shared, stream,
                          a, b, x, D);
}
