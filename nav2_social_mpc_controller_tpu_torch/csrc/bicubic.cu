// K1: batched Catmull-Rom bicubic sample with analytic derivatives.
//
// Replaces the two TPU kernels of the JAX package's ops/bicubic_pallas.py
// (_packed_kernel and _linearize_kernel): value, d/drow and d/dcol of each
// scenario's costmap window at its S sample points. The sample itself is
// bicubic.cuh's, shared with the rollout-sample kernel (rollout_sample.cu),
// which runs it in the epilogue of K6's rollout on every fused evaluation;
// this standalone launch serves the residual path (the differentiable
// costmap sample of world/grid.py), whose sample points are no rollout's.
//
// Design: one thread per (scenario, sample) reads its 16 taps straight from
// the f32 window. The stencil-matrix product, the bf16 split and the lane
// packing of the TPU kernels were devices of that machine and have no
// counterpart here. The kernel is bound by bytes, and by few of them: the
// S samples of a scenario lie along one rollout, so together they touch a
// few dozen distinct window cells, not the H*W window (48 multiply-adds per
// sample are nothing beside even that). Neighbouring threads are
// neighbouring samples of one scenario and share most of their taps in L1.

#include <cuda_runtime.h>

#include "bicubic.cuh"

namespace {

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
    catmull_rom::sample(win + (size_t)b * H * W, H, W, row[i], col[i], val[i], drow[i],
                        dcol[i]);
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
