// Variant `park_always` of csrc/rollout_sample.cu, timed by tools/torch_kernel_variants.py:
// the checkout's kernel with one instantiation for every S, the one that parks the front
// points of chunks past the second in the output planes.

// Rollout sample: K6's rollout with K1's costmap sample as its epilogue, the
// u-dependent prep of one fused LM evaluation in one launch.
//
// Replaces, on the evaluation path, the TPU kernels _rollout_kernel of the
// JAX package's ops/rollout_pallas.py and _packed_kernel of
// ops/bicubic_pallas.py, which ran one after the other. Outputs: seven
// (B, S) planes [px, py, pth, v, val, d_row, d_col] and the (B, 4*NB, S)
// sensitivity stack; the sample coordinates (row, col) are not written out,
// since nothing after the sample reads them.
//
// What bounds it: as K6, bytes, and few of them; standalone, K1 spent most
// of its time on its own launch and on reading back the (row, col) that K6
// had just written. Design: rollout.cuh's warp per scenario, lane s on step
// s; each lane keeps its steps' front points (row, col) and, once the
// rollout is done, takes the Catmull-Rom sample at each (bicubic.cuh), its
// 16 taps read from the scenario's window. Sampling after the rollout rather
// than inside its chunk loop keeps the sample's registers apart from the
// scans' and loads the taps of the chunks together. Both
// parts compile from the headers the standalone kernels compile from, so the
// outputs equal, bit for bit, those of rollout_prep.cu then bicubic.cu.

#include <cuda_runtime.h>

#include "bicubic.cuh"
#include "rollout.cuh"

namespace {

// LONG: S > 64, the instantiation that parks the steps past the first two
// chunks; the other keeps no code for them (and fewer registers).
template <int NB, bool LONG>
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
    // The lane's front point (row, col) in each of the first two chunks of 32
    // steps, kept in registers until the rollout is done; a longer rollout
    // parks the rest in the val / d_row planes, which the sample overwrites.
    float row0 = 0.0f, col0 = 0.0f, row1 = 0.0f, col1 = 0.0f;
    rollout::rollout_warp<NB>(
        u, pose0, block_idx, win_origin, resolution, sens, b, lane, S, dt, front,
        [&](int s, float px, float py, float th, float v, float row, float col) {
            out[0 * plane + s] = px;
            out[1 * plane + s] = py;
            out[2 * plane + s] = th;
            out[3 * plane + s] = v;
            if (s < 32) {
                row0 = row;
                col0 = col;
            } else if (!LONG || s < 64) {
                row1 = row;
                col1 = col;
            } else {
                out[4 * plane + s] = row;
                out[5 * plane + s] = col;
            }
        });
    // Each lane samples the steps it rolled out, the first two chunks' taps
    // loaded together.
    const float* g = win + (size_t)b * H * W;
    auto sample_at = [&](int s, float row, float col) {
        float val, drow, dcol;
        catmull_rom::sample(g, H, W, row, col, val, drow, dcol);
        out[4 * plane + s] = val;
        out[5 * plane + s] = drow;
        out[6 * plane + s] = dcol;
    };
    if (lane < S) sample_at(lane, row0, col0);
    if (lane + 32 < S) sample_at(lane + 32, row1, col1);
    if (LONG) {
        for (int s = lane + 64; s < S; s += 32) {
            sample_at(s, out[4 * plane + s], out[5 * plane + s]);
        }
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
    const bool long_rollout = S > 64;
#define ROLLOUT_SAMPLE(NB_, LONG_)                                                         \
    rollout_sample_kernel<NB_, LONG_><<<blocks, threads, 0, stream>>>(                      \
        u, pose0, block_idx, win_origin, resolution, win, planes, sens, B, S, H, W, dt, front)
    (void)long_rollout;  // every S takes the instantiation that parks chunks past two
    switch (NB * 2 + 1) {
        case 6: ROLLOUT_SAMPLE(3, false); break;
        case 7: ROLLOUT_SAMPLE(3, true); break;
        case 12: ROLLOUT_SAMPLE(6, false); break;
        case 13: ROLLOUT_SAMPLE(6, true); break;
        default: return (int)cudaErrorInvalidValue;
    }
#undef ROLLOUT_SAMPLE
    return (int)cudaGetLastError();
}
