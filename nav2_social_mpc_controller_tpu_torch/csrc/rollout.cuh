// K6's body: the rollout of one scenario by one warp, shared by the
// standalone rollout prep (rollout_prep.cu) and the rollout-sample kernel
// (rollout_sample.cu), so that the two compile the same arithmetic from one
// source. What each kernel stores of a step's pose is its epilogue's.
//
// For every scenario it expands the block-constant controls over the S
// rollout steps, integrates the unicycle model (theta, then x/y with theta
// from BEFORE the step's own update), accumulates the position
// sensitivities d{x,y}/dv_b and d{x,y}/dw_b into the (B, 4*NB, S) stack
// [dxdv | dydv | dxdw | dydw], and turns each pose's front point into the
// (row, col) sample coordinates of the obstacle window.
//
// What bounds it: bytes. It writes (6 + 4*NB) floats per step and reads
// almost nothing; per step it does one sincosf and a few dozen FP32
// operations. A thread per scenario walking its steps in order would store
// each output row at a stride of S floats across the warp (every store
// touching 32 sectors) and run S sincosf back to back.
//
// Design: one warp per scenario, lane s on step s (steps past 32 run as
// further chunks of 32 that start from the sums carried out of the last lane
// of the chunk before). Every running sum is an inclusive warp scan
// (__shfl_up_sync, 5 rounds): of w for the heading, of v cos / v sin of the
// previous heading for the position, and of the 4*NB sensitivity
// integrands. The previous heading's cos/sin are the neighbouring lane's
// (the start heading's on step 0), so a step costs one sincosf, run in
// parallel across the lanes. dtheta_prev/dw_b = dt * (steps of block b
// before s) is an exact integer count from __ballot_sync and __popc. The
// step's control is a copy of u[block_idx[s]], picked by comparisons, never
// a product-sum. Lane s stores element s of every output row, so a warp's
// store of a row covers S contiguous floats.
//
// Two forms of the same body. The templated kernels (NB = 1..6) keep each
// block's carried sums and its control in registers, every loop over the
// blocks unrolled. The general kernels take NB at run time (7 up to
// kernel_shapes.h's SOCIAL_MPC_GENERAL_MAX_BLOCKS): the pose, cos and sin of
// a chunk's steps stay in the lanes' registers as before, and each block's
// four scans run in turn with its own carry, which the warp keeps in its
// slice of shared memory (5 NB floats). The scans, their operands and their
// order are the same, so the two forms compute the same bits wherever the
// compiler contracts the same products.
//
// The scans add in a tree order, the plain version's torch.cumsum serially:
// the two differ by that rounding, by FMA contraction and by CUDA's sincosf.
// Each scenario is summed by its own warp in a fixed order, so its outputs
// do not depend on where in the batch it sits.

#pragma once

#include <cuda_runtime.h>

namespace rollout {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int WARPS = 4;  // scenarios (warps) per block

// Inclusive prefix sum over the warp's lanes.
__device__ __forceinline__ float warp_scan(float x, int lane) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(FULL_MASK, x, off);
        if (lane >= off) x += y;
    }
    return x;
}

__device__ __forceinline__ float last_lane(float x) {
    return __shfl_sync(FULL_MASK, x, 31);
}

// The per-block sums a warp carries from one chunk of 32 steps to the next,
// and each block's controls. RegisterBlocks<NB> (the templated kernels, NB
// known) holds them in registers, every loop over the blocks unrolled;
// SharedBlocks (the general kernels, NB at run time) holds the sums in the
// warp's slice of shared memory, which lane 0 writes and every lane reads
// after __syncwarp, and reads a step's control straight from u. Both give
// the scans the same operands in the same order.
template <int NB>
struct RegisterBlocks {
    float uv[NB], uw[NB];
    float s_dxdv[NB], s_dydv[NB], s_dxdw[NB], s_dydw[NB];
    int count_[NB];
    __device__ __forceinline__ RegisterBlocks(const float* __restrict__ u, int b) {
#pragma unroll
        for (int k = 0; k < NB; ++k) {
            uv[k] = u[(size_t)b * 2 * NB + 2 * k];
            uw[k] = u[(size_t)b * 2 * NB + 2 * k + 1];
            s_dxdv[k] = s_dydv[k] = s_dxdw[k] = s_dydw[k] = 0.0f;
            count_[k] = 0;
        }
    }
    static constexpr int kNB = NB;
    __device__ __forceinline__ int n() const { return NB; }
    // The step's control, a copy of u[blk] picked by comparisons (0 off the
    // steps).
    __device__ __forceinline__ void control(int blk, bool, float& v, float& w) const {
        v = 0.0f;
        w = 0.0f;
#pragma unroll
        for (int k = 0; k < NB; ++k) {
            if (k == blk) {
                v = uv[k];
                w = uw[k];
            }
        }
    }
    __device__ __forceinline__ void sums(int k, float& dxdv, float& dydv, float& dxdw,
                                         float& dydw, int& count) const {
        dxdv = s_dxdv[k];
        dydv = s_dydv[k];
        dxdw = s_dxdw[k];
        dydw = s_dydw[k];
        count = count_[k];
    }
    __device__ __forceinline__ void carry(int k, float dxdv, float dydv, float dxdw, float dydw,
                                          int count, int) {
        s_dxdv[k] = dxdv;
        s_dydv[k] = dydv;
        s_dxdw[k] = dxdw;
        s_dydw[k] = dydw;
        count_[k] = count;
    }
};

// Shared memory of one warp's SharedBlocks: 4 sums and a count per block.
__host__ __device__ constexpr size_t shared_blocks_bytes(int nb) {
    return (size_t)5 * nb * sizeof(float);
}

struct SharedBlocks {
    static constexpr int kNB = 0;  // NB at run time
    const float* ub;  // u of the scenario
    float* sum;                    // (4, NB) sums, then NB counts
    int nb;
    __device__ __forceinline__ SharedBlocks(const float* __restrict__ u, int b, int nb_,
                                            float* slice, int lane)
        : ub(u + (size_t)b * 2 * nb_), sum(slice), nb(nb_) {
        for (int k = lane; k < 4 * nb; k += 32) sum[k] = 0.0f;
        for (int k = lane; k < nb; k += 32) reinterpret_cast<int*>(sum + 4 * nb)[k] = 0;
        __syncwarp();
    }
    __device__ __forceinline__ int n() const { return nb; }
    __device__ __forceinline__ void control(int blk, bool on, float& v, float& w) const {
        v = on ? ub[2 * blk] : 0.0f;
        w = on ? ub[2 * blk + 1] : 0.0f;
    }
    __device__ __forceinline__ void sums(int k, float& dxdv, float& dydv, float& dxdw,
                                         float& dydw, int& count) const {
        dxdv = sum[k];
        dydv = sum[nb + k];
        dxdw = sum[2 * nb + k];
        dydw = sum[3 * nb + k];
        count = reinterpret_cast<const int*>(sum + 4 * nb)[k];
    }
    __device__ __forceinline__ void carry(int k, float dxdv, float dydv, float dxdw, float dydw,
                                          int count, int lane) {
        if (lane == 0) {
            sum[k] = dxdv;
            sum[nb + k] = dydv;
            sum[2 * nb + k] = dxdw;
            sum[3 * nb + k] = dydw;
            reinterpret_cast<int*>(sum + 4 * nb)[k] = count;
        }
        __syncwarp();
    }
};

// The rollout of scenario b by the calling warp (every lane calls it), its
// blocks' controls and sums in `blocks` (RegisterBlocks<NB> or
// SharedBlocks). The lane on step s < S writes the step's sensitivities and
// calls emit(s, px, py, theta, v, row, col) once.
template <typename Blocks, typename Emit>
__device__ __forceinline__ void rollout_warp(
    Blocks& blocks, const float* __restrict__ pose0,
    const int* __restrict__ block_idx, const float* __restrict__ win_origin,
    const float* __restrict__ resolution, float* __restrict__ sens, int b, int lane, int S,
    float dt, float front, Emit emit) {
    const int NB = Blocks::kNB > 0 ? Blocks::kNB : blocks.n();
    const float x0 = pose0[3 * b + 0], y0 = pose0[3 * b + 1], th0 = pose0[3 * b + 2];
    const float ox = win_origin[2 * b + 0], oy = win_origin[2 * b + 1];
    const float res = resolution[b];
    const int* bi = block_idx + (size_t)b * S;
    float* sb = sens + (size_t)b * 4 * NB * S;
    const unsigned below = (1u << lane) - 1u;

    // Sums carried out of the chunks before this one.
    float sum_w = 0.0f, sum_x = 0.0f, sum_y = 0.0f;
    float cos_last, sin_last;  // heading before the chunk's first step
    sincosf(th0, &sin_last, &cos_last);

    for (int s0 = 0; s0 < S; s0 += 32) {
        const int s = s0 + lane;
        const bool on = s < S;
        const int blk = on ? bi[s] : -1;
        float v, w;
        blocks.control(blk, on, v, w);
        const float cum_w = sum_w + warp_scan(w, lane);
        const float th = th0 + dt * cum_w;
        float sin_th, cos_th;
        sincosf(th, &sin_th, &cos_th);
        float cosp = __shfl_up_sync(FULL_MASK, cos_th, 1);
        float sinp = __shfl_up_sync(FULL_MASK, sin_th, 1);
        if (lane == 0) {
            cosp = cos_last;
            sinp = sin_last;
        }
        const float vc = v * cosp;
        const float vs = v * sinp;
        const float cum_x = sum_x + warp_scan(vc, lane);
        const float cum_y = sum_y + warp_scan(vs, lane);
#pragma unroll
        for (int k = 0; k < NB; ++k) {
            float s_dxdv, s_dydv, s_dxdw, s_dydw;
            int count;
            blocks.sums(k, s_dxdv, s_dydv, s_dxdw, s_dydw, count);
            const bool mine = blk == k;
            const unsigned in_k = __ballot_sync(FULL_MASK, mine);
            const float dth_prev = dt * (float)(count + __popc(in_k & below));
            const float c_dxdv = s_dxdv + warp_scan(mine ? cosp : 0.0f, lane);
            const float c_dydv = s_dydv + warp_scan(mine ? sinp : 0.0f, lane);
            const float c_dxdw = s_dxdw + warp_scan((-vs) * dth_prev, lane);
            const float c_dydw = s_dydw + warp_scan(vc * dth_prev, lane);
            if (on) {
                sb[(size_t)(0 * NB + k) * S + s] = dt * c_dxdv;
                sb[(size_t)(1 * NB + k) * S + s] = dt * c_dydv;
                sb[(size_t)(2 * NB + k) * S + s] = dt * c_dxdw;
                sb[(size_t)(3 * NB + k) * S + s] = dt * c_dydw;
            }
            blocks.carry(k, last_lane(c_dxdv), last_lane(c_dydv), last_lane(c_dxdw),
                         last_lane(c_dydw), count + __popc(in_k), lane);
        }
        const float px = x0 + dt * cum_x;
        const float py = y0 + dt * cum_y;
        if (on) {
            const float fx = px + front * cos_th;
            const float fy = py + front * sin_th;
            emit(s, px, py, th, v, (fy - oy) / res, (fx - ox) / res);
        }
        sum_w = last_lane(cum_w);
        sum_x = last_lane(cum_x);
        sum_y = last_lane(cum_y);
        cos_last = last_lane(cos_th);
        sin_last = last_lane(sin_th);
    }
}

// The templated form's entry: scenario b's blocks in registers, NB known.
template <int NB, typename Emit>
__device__ __forceinline__ void rollout_warp(
    const float* __restrict__ u, const float* __restrict__ pose0,
    const int* __restrict__ block_idx, const float* __restrict__ win_origin,
    const float* __restrict__ resolution, float* __restrict__ sens, int b, int lane, int S,
    float dt, float front, Emit emit) {
    RegisterBlocks<NB> blocks(u, b);
    rollout_warp(blocks, pose0, block_idx, win_origin, resolution, sens, b, lane, S, dt, front,
                 emit);
}

}  // namespace rollout
