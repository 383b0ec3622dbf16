// The unrolled Cholesky solve of K3 and K7 in the thread layout, D <= 6
// (damped_step.cuh, whose rows layout for larger D repeats this order of
// operations one row per lane, and whose general form for any D one row per
// thread in shared memory) and the
// rounding helpers of K3, K4 and K7: A = L L^T, forward substitution
// L y = rhs, back substitution L^T x = y, with reciprocal diagonals.
//
// Every product, sum and difference is written with the round-to-nearest
// intrinsics (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc never contracts
// into FMA, and division and sqrtf are IEEE (no fast math): the kernels
// repeat their plain PyTorch versions (solver/cuda_solve.py: chol_solve)
// operation for operation. There is NO pivot guard: a
// non-positive pivot gives sqrt(<0) = NaN or 1/0 = inf, which flows on into
// a non-finite solution for the caller to reject.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace social_mpc {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// Solve A x = rhs for one D x D system held in registers. `a(i, j)` yields
// the entry of A at row i >= column j (only the lower triangle is read, each
// entry once), so a caller can damp the diagonal or read straight from
// global memory.
template <int D, typename Entry>
__device__ __forceinline__ void chol_solve(const Entry& a, const float (&rhs)[D],
                                           float (&x)[D]) {
    float el[D][D];
    float inv_diag[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
        float s = a(j, j);
#pragma unroll
        for (int k = 0; k < j; ++k) s = sub(s, mul(el[j][k], el[j][k]));
        const float ljj = sqrtf(s);
        el[j][j] = ljj;
        inv_diag[j] = 1.0f / ljj;
#pragma unroll
        for (int i = j + 1; i < D; ++i) {
            float t = a(i, j);
#pragma unroll
            for (int k = 0; k < j; ++k) t = sub(t, mul(el[i][k], el[j][k]));
            el[i][j] = mul(t, inv_diag[j]);
        }
    }
    float y[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
        float s = rhs[i];
#pragma unroll
        for (int k = 0; k < i; ++k) s = sub(s, mul(el[i][k], y[k]));
        y[i] = mul(s, inv_diag[i]);
    }
#pragma unroll
    for (int i = D - 1; i >= 0; --i) {
        float s = y[i];
#pragma unroll
        for (int k = i + 1; k < D; ++k) s = sub(s, mul(el[k][i], x[k]));
        x[i] = mul(s, inv_diag[i]);
    }
}

}  // namespace social_mpc
