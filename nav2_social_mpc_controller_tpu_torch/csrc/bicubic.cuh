// The Catmull-Rom sample of K1: value, d/drow and d/dcol of one scenario's
// costmap window at one (row, col). Shared by the standalone K1
// (bicubic.cu) and the rollout-sample kernel (rollout_sample.cu), which
// takes the sample in the epilogue of K6's rollout, so that the two compile
// the same arithmetic from one source.
//
// Semantics are those of ceres::BiCubicInterpolator over a border-clamped
// Grid2D (obstacle_cost_function.hpp:137-167): the 4x4 taps are read at
// clamp(floor(coord) + d - 1), so clamped duplicate taps accumulate, and
// floor() carries no derivative. nvcc contracts a*b+c into FMA; the plain
// PyTorch version rounds each product, so the two agree to float32 rounding
// of a 16-term sum, not bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace catmull_rom {

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

// (value, d/drow, d/dcol) of the H x W window g at (r, c): the sum runs
// over the columns of each tap row, then over the rows.
__device__ __forceinline__ void sample(const float* __restrict__ g, int H, int W, float r,
                                       float c, float& val, float& drow, float& dcol) {
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
    val = v;
    drow = dr;
    dcol = dc;
}

}  // namespace catmull_rom
