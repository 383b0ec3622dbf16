// Variant `ceiling32` of csrc/spd_solve.cu, timed by tools/torch_kernel_variants.py:
// as the checkout, but the warp form's registers unrolled to one ceiling,
// 32, at every D up to 32 (the checkout: the multiple of 4 from 16 at or above D).

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
// registers and no block barrier; above, a block a system, a thread a row,
// the left-looking factor in shared memory with its sums' and the back
// substitution's loads a chunk ahead. (The first general form, a block of
// 128 threads a system, is kept as tools/spd_solve_variants/left_looking.cu,
// the right-looking block form as right_looking.cu.)
//
// Numerics: chol.cuh's order of every operation and its round-to-nearest
// intrinsics, IEEE division and sqrtf: both entries repeat their plain
// versions (solver/cuda_iter.py: damped_step_plain, solver/cuda_solve.py:
// spd_solve_plain) bit for bit.

#include <cuda_runtime.h>

#include "damped_step.cuh"
#include "kernel_shapes.h"

static_assert(social_mpc::GENERAL_LANE_SPAN * 32 >= SOCIAL_MPC_GENERAL_MAX_DIM,
              "the block form: a warp's lanes cover a row");

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
// above. Up to CAP = 20 the warp form keeps to 64 registers (4 blocks of
// 256 threads an SM), so that a batch of 4,096 systems is resident at once
// (a few bytes of spill at CAP = 20); above, the spill would cost more.
constexpr int GENERAL_WARP_BLOCK = 32 * social_mpc::GENERAL_WARP_MAX_SYSTEMS;

template <int CAP, bool JAC>
__global__ void __launch_bounds__(GENERAL_WARP_BLOCK, CAP <= 20 ? 4 : 1)
damped_step_general_warp_kernel(const DampedStepArgs p, int D) {
    social_mpc::damped_step_warp<CAP, JAC>(p, D);
}

template <bool JAC>
__global__ void __launch_bounds__(1024)
damped_step_general_block_kernel(const DampedStepArgs p, int D) {
    extern __shared__ float shared[];
    social_mpc::damped_step_block<JAC>(p, D, shared);
}

template <int CAP>
__global__ void __launch_bounds__(GENERAL_WARP_BLOCK, CAP <= 20 ? 4 : 1)
spd_solve_general_warp_kernel(const float* __restrict__ a_in, const float* __restrict__ b_in,
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
    social_mpc::block_chol_solve(m);
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
    if (D <= 32) return launch_spd_solve_warp<32>(a, b, x, N, D, threads, systems, shared, stream);
    static int opted = 0;
    return launch_general(spd_solve_general_block_kernel, opted, N, threads, 1, shared, stream,
                          a, b, x, D);
}
