// K6: rollout prep — the u-dependent prep of one fused LM evaluation.
//
// Replaces the TPU kernel _rollout_kernel of the JAX package's
// ops/rollout_pallas.py (public wrapper rollout_prep_pallas). Outputs: six
// (B, S) planes [px, py, pth, v, row, col] and one (B, 4*NB, S) stack
// [dxdv | dydv | dxdw | dydw]. Its body (design and arithmetic) is
// rollout.cuh's; on the evaluation path it runs inside the rollout-sample
// kernel (rollout_sample.cu), which samples the costmap at (row, col)
// instead of storing them. This standalone launch is the reference that
// kernel is held to, bit for bit, with K1 (bicubic.cu) after it.

#include <cuda_runtime.h>

#include "rollout.cuh"

namespace {

template <int NB>
__global__ void __launch_bounds__(rollout::WARPS * 32) rollout_prep_kernel(
    const float* __restrict__ u, const float* __restrict__ pose0,
    const int* __restrict__ block_idx, const float* __restrict__ win_origin,
    const float* __restrict__ resolution, float* __restrict__ planes,
    float* __restrict__ sens, int B, int S, float dt, float front) {
    const int b = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (b >= B) return;  // uniform across the warp
    const size_t plane = (size_t)B * S;
    float* out = planes + (size_t)b * S;
    rollout::rollout_warp<NB>(
        u, pose0, block_idx, win_origin, resolution, sens, b, lane, S, dt, front,
        [&](int s, float px, float py, float th, float v, float row, float col) {
            out[0 * plane + s] = px;
            out[1 * plane + s] = py;
            out[2 * plane + s] = th;
            out[3 * plane + s] = v;
            out[4 * plane + s] = row;
            out[5 * plane + s] = col;
        });
}

}  // namespace

extern "C" int social_mpc_rollout_prep_f32(
    const float* u, const float* pose0, const int* block_idx,
    const float* win_origin, const float* resolution, float* planes,
    float* sens, int B, int S, int NB, float dt, float front,
    cudaStream_t stream) {
    if (B <= 0 || S <= 0) return (int)cudaGetLastError();
    const int blocks = (B + rollout::WARPS - 1) / rollout::WARPS;
    const int threads = rollout::WARPS * 32;
    switch (NB) {
        case 3:
            rollout_prep_kernel<3><<<blocks, threads, 0, stream>>>(
                u, pose0, block_idx, win_origin, resolution, planes, sens, B, S, dt, front);
            break;
        case 6:
            rollout_prep_kernel<6><<<blocks, threads, 0, stream>>>(
                u, pose0, block_idx, win_origin, resolution, planes, sens, B, S, dt, front);
            break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
