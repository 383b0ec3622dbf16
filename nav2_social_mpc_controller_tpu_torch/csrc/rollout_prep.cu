// K6: rollout prep — the u-dependent prep of one fused LM evaluation.
//
// Replaces the TPU kernel _rollout_kernel of the JAX package's
// ops/rollout_pallas.py (public wrapper rollout_prep_pallas). Outputs: six
// (B, S) planes [px, py, pth, v, row, col] and one (B, 4*NB, S) stack
// [dxdv | dydv | dxdw | dydw]. Its body (design and arithmetic) is
// rollout.cuh's; on the evaluation path it runs inside the rollout-sample
// kernel (rollout_sample.cu), which samples the costmap at (row, col)
// instead of storing them. This standalone launch is the reference that
// kernel is held to, bit for bit, with K1 (bicubic.cu) after it; its general
// form (NB at run time, past the templated NB = 1..6) is the reference of
// the rollout-sample kernel's general form.

#include <cuda_runtime.h>

#include "kernel_shapes.h"
#include "rollout.cuh"

namespace {

// The body of both forms: the rollout of scenario b, its blocks in `blocks`.
template <typename Blocks>
__device__ __forceinline__ void rollout_prep_body(
    Blocks& blocks, const float* __restrict__ pose0, const int* __restrict__ block_idx,
    const float* __restrict__ win_origin, const float* __restrict__ resolution,
    float* __restrict__ planes, float* __restrict__ sens, int b, int lane, int B, int S,
    float dt, float front) {
    const size_t plane = (size_t)B * S;
    float* out = planes + (size_t)b * S;
    rollout::rollout_warp(
        blocks, pose0, block_idx, win_origin, resolution, sens, b, lane, S, dt, front,
        [&](int s, float px, float py, float th, float v, float row, float col) {
            out[0 * plane + s] = px;
            out[1 * plane + s] = py;
            out[2 * plane + s] = th;
            out[3 * plane + s] = v;
            out[4 * plane + s] = row;
            out[5 * plane + s] = col;
        });
}

// Instantiated for every NB of kernel_shapes.h's SOCIAL_MPC_BLOCKS (1..6).
template <int NB>
__global__ void __launch_bounds__(rollout::WARPS * 32) rollout_prep_kernel(
    const float* __restrict__ u, const float* __restrict__ pose0,
    const int* __restrict__ block_idx, const float* __restrict__ win_origin,
    const float* __restrict__ resolution, float* __restrict__ planes,
    float* __restrict__ sens, int B, int S, float dt, float front) {
    const int b = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (b >= B) return;  // uniform across the warp
    rollout::RegisterBlocks<NB> blocks(u, b);
    rollout_prep_body(blocks, pose0, block_idx, win_origin, resolution, planes, sens, b, lane,
                      B, S, dt, front);
}

// The general form: NB at run time, W warps a scenario (kernel_shapes.py:
// rollout_general_geometry), each warp's share of the blocks' carries in
// registers (CEIL blocks); a warp stores the poses of its own chunks of 32
// steps.
template <int CEIL, bool ONE>
__global__ void __launch_bounds__(rollout::GENERAL_MAX_THREADS) rollout_prep_general_kernel(
    const float* __restrict__ u, const float* __restrict__ pose0,
    const int* __restrict__ block_idx, const float* __restrict__ win_origin,
    const float* __restrict__ resolution, float* __restrict__ planes,
    float* __restrict__ sens, int B, int S, int NB, float dt, float front, int warps) {
    const int gw = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int b = gw / warps, w = gw - b * warps;
    const int lane = threadIdx.x & 31;
    if (b >= B) return;  // uniform across the warp
    rollout::GeneralCarries<CEIL> carries;
    const size_t plane = (size_t)B * S;
    float* out = planes + (size_t)b * S;
    rollout::rollout_general_warp<CEIL, ONE>(
        carries, u, pose0, block_idx, win_origin, resolution, sens, b, lane, S, NB, w, warps,
        dt, front, [&](int s, float px, float py, float th, float v, float row, float col) {
            out[0 * plane + s] = px;
            out[1 * plane + s] = py;
            out[2 * plane + s] = th;
            out[3 * plane + s] = v;
            out[4 * plane + s] = row;
            out[5 * plane + s] = col;
        });
}

// The general kernel at register ceiling CEIL for S steps; at S <= 32 the
// one-chunk form, which keeps no carries (its ceiling is moot).
template <int CEIL>
auto general_kernel(int S) {
    return S <= 32 ? rollout_prep_general_kernel<4, true>
                   : rollout_prep_general_kernel<CEIL, false>;
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
#define ROLLOUT_PREP_CASE(NB_)                                                               \
    case NB_:                                                                                \
        rollout_prep_kernel<NB_><<<blocks, threads, 0, stream>>>(                            \
            u, pose0, block_idx, win_origin, resolution, planes, sens, B, S, dt, front);     \
        break;
    switch (NB) {
        SOCIAL_MPC_BLOCKS(ROLLOUT_PREP_CASE)
        default: return (int)cudaErrorInvalidValue;
    }
#undef ROLLOUT_PREP_CASE
    return (int)cudaGetLastError();
}

// NB from 1 to SOCIAL_MPC_GENERAL_MAX_BLOCKS (the wrapper takes it past
// SOCIAL_MPC_BLOCKS), at the wrapper's launch geometry
// (kernel_shapes.rollout_general_geometry: warps a scenario, blocks a warp).
extern "C" int social_mpc_rollout_prep_general_f32(
    const float* u, const float* pose0, const int* block_idx,
    const float* win_origin, const float* resolution, float* planes,
    float* sens, int B, int S, int NB, float dt, float front, int warps, int share,
    cudaStream_t stream) {
    if (NB < 1 || NB > SOCIAL_MPC_GENERAL_MAX_BLOCKS ||
        !rollout::general_geometry_ok(NB, warps, share))
        return (int)cudaErrorInvalidValue;
    if (B <= 0 || S <= 0) return (int)cudaGetLastError();
    const int threads = rollout::general_threads(warps);
    const int blocks = (int)(((long long)B * warps * 32 + threads - 1) / threads);
    // The kernel: unrolled to the register ceiling at or above the blocks a
    // warp; at one chunk without carries.
    const auto kernel = share <= 4   ? general_kernel<4>(S)
                        : share <= 8 ? general_kernel<8>(S)
                                     : general_kernel<rollout::GENERAL_MAX_REGISTER_BLOCKS>(S);
    kernel<<<blocks, threads, 0, stream>>>(
        u, pose0, block_idx, win_origin, resolution, planes, sens, B, S, NB, dt, front, warps);
    return (int)cudaGetLastError();
}
