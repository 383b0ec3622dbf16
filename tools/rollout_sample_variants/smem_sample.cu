// Variant `smem_sample` of csrc/rollout_sample.cu, timed by tools/torch_kernel_variants.py:
// each lane keeps its steps' front points in shared memory and samples them after the
// rollout, one step at a time (any S).

// Rollout sample: K6's rollout with K1's costmap sample as its epilogue, the
// u-dependent prep of one fused LM evaluation in one launch.
//
// Replaces, on the evaluation path, the TPU kernels _rollout_kernel of the
// JAX package's ops/rollout_pallas.py and _packed_kernel of
// ops/bicubic_pallas.py, which ran one after the other. Outputs: seven
// (B, S) planes [px, py, pth, v, val, d_row, d_col] and the (B, 4*NB, S)
// sensitivity stack; the sample coordinates (row, col) stay on the chip,
// since nothing after the sample reads them.
//
// What bounds it: as K6, bytes, and few of them; standalone, K1 spent most
// of its time on its own launch and on reading back the (row, col) that K6
// had just written. Design: rollout.cuh's warp per scenario, lane s on step
// s; each lane keeps its steps' front points (row, col) in shared memory and,
// once the rollout is done, takes the Catmull-Rom sample at each
// (bicubic.cuh), its 16 taps read from the scenario's window. Sampling after
// the rollout rather than inside its chunk loop keeps the sample's registers
// apart from the scans' and loads the taps of every chunk together. Both
// parts compile from the headers the standalone kernels compile from, so the
// outputs equal, bit for bit, those of rollout_prep.cu then bicubic.cu.

#include <cuda_runtime.h>

#include "bicubic.cuh"
#include "rollout.cuh"

namespace {

template <int NB>
__global__ void __launch_bounds__(rollout::WARPS * 32) rollout_sample_kernel(
    const float* __restrict__ u, const float* __restrict__ pose0,
    const int* __restrict__ block_idx, const float* __restrict__ win_origin,
    const float* __restrict__ resolution, const float* __restrict__ win,
    float* __restrict__ planes, float* __restrict__ sens, int B, int S, int H, int W,
    float dt, float front) {
    const int b = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (b >= B) return;  // uniform across the warp
    const size_t plane = (size_t)B * S;
    float* out = planes + (size_t)b * S;
    // The warp's (row, col) of every step, kept until the rollout is done.
    extern __shared__ float2 coords_sh[];
    float2* coords = coords_sh + (size_t)(threadIdx.x >> 5) * S;
    rollout::rollout_warp<NB>(
        u, pose0, block_idx, win_origin, resolution, sens, b, lane, S, dt, front,
        [&](int s, float px, float py, float th, float v, float row, float col) {
            out[0 * plane + s] = px;
            out[1 * plane + s] = py;
            out[2 * plane + s] = th;
            out[3 * plane + s] = v;
            coords[s] = make_float2(row, col);
        });
    // Each lane samples the steps it rolled out (it reads only what it wrote).
    const float* g = win + (size_t)b * H * W;
    for (int s = lane; s < S; s += 32) {
        const float2 rc = coords[s];
        float val, drow, dcol;
        catmull_rom::sample(g, H, W, rc.x, rc.y, val, drow, dcol);
        out[4 * plane + s] = val;
        out[5 * plane + s] = drow;
        out[6 * plane + s] = dcol;
    }
}

}  // namespace

extern "C" int social_mpc_rollout_sample_f32(
    const float* u, const float* pose0, const int* block_idx,
    const float* win_origin, const float* resolution, const float* win, float* planes,
    float* sens, int B, int S, int NB, int H, int W, float dt, float front,
    cudaStream_t stream) {
    if (B <= 0 || S <= 0) return (int)cudaGetLastError();
    const int blocks = (B + rollout::WARPS - 1) / rollout::WARPS;
    const int threads = rollout::WARPS * 32;
    const size_t shmem = (size_t)rollout::WARPS * S * sizeof(float2);
    if (shmem > 48 * 1024) return (int)cudaErrorInvalidValue;
    switch (NB) {
        case 3:
            rollout_sample_kernel<3><<<blocks, threads, shmem, stream>>>(
                u, pose0, block_idx, win_origin, resolution, win, planes, sens, B, S, H, W,
                dt, front);
            break;
        case 6:
            rollout_sample_kernel<6><<<blocks, threads, shmem, stream>>>(
                u, pose0, block_idx, win_origin, resolution, win, planes, sens, B, S, H, W,
                dt, front);
            break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
