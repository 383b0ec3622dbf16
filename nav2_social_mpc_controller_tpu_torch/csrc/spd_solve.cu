// K7 (spd_solve): N independent D x D symmetric-positive-definite solves,
// a (N, D, D), b (N, D) -> x (N, D), the damped normal equations of the
// general Levenberg-Marquardt iteration (debug trace, Jacobi scaling, a
// caller's own linear_solve falling back on the default).
//
// Replaces the TPU kernel _cholesky_solve_kernel of the JAX package's
// solver/pallas_solve.py with exactly its arithmetic: an unrolled Cholesky
// A = L L^T, forward and back substitution, reciprocal diagonals and no
// pivot guard (chol.cuh, shared with K3), so a system that is not positive
// definite gives NaN for the iteration to reject.
//
// Design: one thread per system on the natural row-major (N, D, D) layout,
// the factor held in registers (template on D in {6, 12}); each entry of the
// lower triangle is read from global memory once, where the factorisation
// first needs it. The kernel is bound by bytes ((D*D + 2*D) * 4 per system
// against ~D^3/3 operations) and, at the batch sizes of a control tick, by
// launch latency; neighbouring threads read D*D floats apart, which a later
// version can stage through shared memory.

#include <cuda_runtime.h>

#include "chol.cuh"

namespace {

template <int D>
__global__ void spd_solve_kernel(const float* __restrict__ a_in,
                                 const float* __restrict__ b_in,
                                 float* __restrict__ x_out, int N) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    const float* a = a_in + (size_t)n * D * D;
    float rhs[D];
#pragma unroll
    for (int i = 0; i < D; ++i) rhs[i] = b_in[(size_t)n * D + i];
    float x[D];
    social_mpc::chol_solve<D>([&](int i, int j) { return a[i * D + j]; }, rhs, x);
#pragma unroll
    for (int i = 0; i < D; ++i) x_out[(size_t)n * D + i] = x[i];
}

}  // namespace

extern "C" int social_mpc_spd_solve_f32(const float* a, const float* b, float* x,
                                        int N, int D, cudaStream_t stream) {
    if (N <= 0) return (int)cudaGetLastError();
    const int threads = 128;
    const int blocks = (N + threads - 1) / threads;
    switch (D) {
        case 6: spd_solve_kernel<6><<<blocks, threads, 0, stream>>>(a, b, x, N); break;
        case 12: spd_solve_kernel<12><<<blocks, threads, 0, stream>>>(a, b, x, N); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
