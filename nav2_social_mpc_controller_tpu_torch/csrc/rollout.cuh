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

// The rollout of scenario b by the calling warp (every lane calls it). The
// lane on step s < S writes the step's sensitivities and calls
// emit(s, px, py, theta, v, row, col) once.
template <int NB, typename Emit>
__device__ __forceinline__ void rollout_warp(
    const float* __restrict__ u, const float* __restrict__ pose0,
    const int* __restrict__ block_idx, const float* __restrict__ win_origin,
    const float* __restrict__ resolution, float* __restrict__ sens, int b, int lane, int S,
    float dt, float front, Emit emit) {
    constexpr int D = 2 * NB;
    const float x0 = pose0[3 * b + 0], y0 = pose0[3 * b + 1], th0 = pose0[3 * b + 2];
    const float ox = win_origin[2 * b + 0], oy = win_origin[2 * b + 1];
    const float res = resolution[b];
    const int* bi = block_idx + (size_t)b * S;
    float uv[NB], uw[NB];
#pragma unroll
    for (int k = 0; k < NB; ++k) {
        uv[k] = u[(size_t)b * D + 2 * k];
        uw[k] = u[(size_t)b * D + 2 * k + 1];
    }
    float* sb = sens + (size_t)b * 4 * NB * S;
    const unsigned below = (1u << lane) - 1u;

    // Sums carried out of the chunks before this one.
    float sum_w = 0.0f, sum_x = 0.0f, sum_y = 0.0f;
    float s_dxdv[NB], s_dydv[NB], s_dxdw[NB], s_dydw[NB];
    int count[NB];
#pragma unroll
    for (int k = 0; k < NB; ++k) {
        s_dxdv[k] = s_dydv[k] = s_dxdw[k] = s_dydw[k] = 0.0f;
        count[k] = 0;
    }
    float cos_last, sin_last;  // heading before the chunk's first step
    sincosf(th0, &sin_last, &cos_last);

    for (int s0 = 0; s0 < S; s0 += 32) {
        const int s = s0 + lane;
        const bool on = s < S;
        const int blk = on ? bi[s] : -1;
        float v = 0.0f, w = 0.0f;
#pragma unroll
        for (int k = 0; k < NB; ++k) {
            if (k == blk) {
                v = uv[k];
                w = uw[k];
            }
        }
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
            const bool mine = blk == k;
            const unsigned in_k = __ballot_sync(FULL_MASK, mine);
            const float dth_prev = dt * (float)(count[k] + __popc(in_k & below));
            const float c_dxdv = s_dxdv[k] + warp_scan(mine ? cosp : 0.0f, lane);
            const float c_dydv = s_dydv[k] + warp_scan(mine ? sinp : 0.0f, lane);
            const float c_dxdw = s_dxdw[k] + warp_scan((-vs) * dth_prev, lane);
            const float c_dydw = s_dydw[k] + warp_scan(vc * dth_prev, lane);
            if (on) {
                sb[(size_t)(0 * NB + k) * S + s] = dt * c_dxdv;
                sb[(size_t)(1 * NB + k) * S + s] = dt * c_dydv;
                sb[(size_t)(2 * NB + k) * S + s] = dt * c_dxdw;
                sb[(size_t)(3 * NB + k) * S + s] = dt * c_dydw;
            }
            s_dxdv[k] = last_lane(c_dxdv);
            s_dydv[k] = last_lane(c_dydv);
            s_dxdw[k] = last_lane(c_dxdw);
            s_dydw[k] = last_lane(c_dydw);
            count[k] += __popc(in_k);
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

}  // namespace rollout
