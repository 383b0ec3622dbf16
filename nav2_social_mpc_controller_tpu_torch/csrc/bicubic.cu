// K1: batched Catmull-Rom bicubic sample with analytic derivatives.
//
// Replaces the two TPU kernels of the JAX package's ops/bicubic_pallas.py
// (_packed_kernel and _linearize_kernel): value, d/drow and d/dcol of each
// scenario's costmap window at its S rollout front points. Semantics are
// those of ceres::BiCubicInterpolator over a border-clamped Grid2D
// (obstacle_cost_function.hpp:137-167): the 4x4 taps are read at
// clamp(floor(coord) + d - 1), so clamped duplicate taps accumulate, and
// floor() carries no derivative.
//
// Design: one thread per (scenario, sample) reads its 16 taps straight from
// the f32 window. The stencil-matrix product, the bf16 split and the lane
// packing of the TPU kernels were devices of that machine and have no
// counterpart here. The kernel is bound by bytes, and by few of them: the
// S samples of a scenario lie along one rollout, so together they touch a
// few dozen distinct window cells, not the H*W window (48 multiply-adds per
// sample are nothing beside even that). Neighbouring threads are
// neighbouring samples of one scenario and share most of their taps in L1.
//
// nvcc contracts a*b+c into FMA; the plain PyTorch version rounds each
// product, so the two agree to float32 rounding of a 16-term sum, not bit
// for bit.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void tap_weights(float x, float w[4], float dw[4]) {
    const float x2 = x * x;
    const float x3 = x2 * x;
    w[0] = 0.5f * (-x3 + 2.0f * x2 - x);
    w[1] = 0.5f * (3.0f * x3 - 5.0f * x2 + 2.0f);
    w[2] = 0.5f * (-3.0f * x3 + 4.0f * x2 + x);
    w[3] = 0.5f * (x3 - x2);
    dw[0] = 0.5f * (-3.0f * x2 + 4.0f * x - 1.0f);
    dw[1] = 0.5f * (9.0f * x2 - 10.0f * x);
    dw[2] = 0.5f * (-9.0f * x2 + 8.0f * x + 1.0f);
    dw[3] = 0.5f * (3.0f * x2 - 2.0f * x);
}

// floor(coord) as an int that is safe to offset: clamped to [-2, n + 1],
// which leaves every clamped tap index unchanged (all four taps of a cell
// at or beyond those limits clamp to the same border cell). NaN maps to -2;
// its weights are NaN, so the outputs are NaN as in the plain version.
__device__ __forceinline__ int base_cell(float f, int n) {
    float c = fminf(fmaxf(f, -2.0f), (float)(n + 1));
    return (int)c;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void bicubic_kernel(const float* __restrict__ win,
                               const float* __restrict__ row,
                               const float* __restrict__ col,
                               float* __restrict__ val,
                               float* __restrict__ drow,
                               float* __restrict__ dcol,
                               int total, int S, int H, int W) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= total) return;
    const int b = i / S;
    const float r = row[i];
    const float c = col[i];
    const float r0 = floorf(r);
    const float c0 = floorf(c);
    float wr[4], dwr[4], wc[4], dwc[4];
    tap_weights(r - r0, wr, dwr);
    tap_weights(c - c0, wc, dwc);
    const int ri = base_cell(r0, H);
    const int ci = base_cell(c0, W);
    int cc[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) cc[d] = clampi(ci + d - 1, 0, W - 1);

    const float* g = win + (size_t)b * H * W;
    float v = 0.0f, dr = 0.0f, dc = 0.0f;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
        const float* grow = g + (size_t)clampi(ri + a - 1, 0, H - 1) * W;
        float t = 0.0f, tc = 0.0f;
#pragma unroll
        for (int d = 0; d < 4; ++d) {
            const float tap = grow[cc[d]];
            t += tap * wc[d];
            tc += tap * dwc[d];
        }
        v += wr[a] * t;
        dr += dwr[a] * t;
        dc += wr[a] * tc;
    }
    val[i] = v;
    drow[i] = dr;
    dcol[i] = dc;
}

}  // namespace

extern "C" int social_mpc_bicubic_f32(const float* win, const float* row,
                                      const float* col, float* val, float* drow,
                                      float* dcol, int B, int S, int H, int W,
                                      cudaStream_t stream) {
    const int total = B * S;
    if (total > 0) {
        const int threads = 128;
        const int blocks = (total + threads - 1) / threads;
        bicubic_kernel<<<blocks, threads, 0, stream>>>(win, row, col, val, drow,
                                                       dcol, total, S, H, W);
    }
    return (int)cudaGetLastError();
}
