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
// Two forms of the same scans. The templated kernels (NB = 1..6) keep each
// block's carried sums and its control in registers, every loop over the
// blocks unrolled, one warp a scenario. The general kernels take NB at run
// time (7 up to kernel_shapes.h's SOCIAL_MPC_GENERAL_MAX_BLOCKS) and spread
// a scenario's blocks over W warps (rollout_general_warp): warp w takes
// blocks w, w + W, ... and runs the chunk's pose, cos and sin scans itself,
// so the warps of a scenario never wait on each other. A warp's carries sit
// in registers, unrolled to a ceiling of 4, 8 or 16 blocks a warp
// (GeneralCarries; eight warps take every NB up to the limit). A (block,
// chunk) pair with no step of the block adds exact zeros and skips its scans
// (see rollout_general_warp). The scans, their operands and their order are
// the same, so both forms compute the same bits wherever the compiler
// contracts the same products.
//
// The scans add in a tree order, the plain version's torch.cumsum serially:
// the two differ by that rounding, by FMA contraction and by CUDA's sincosf.
// Each scenario is summed by its own warp in a fixed order, so its outputs
// do not depend on where in the batch it sits.

#pragma once

#include <cuda_runtime.h>

#include "kernel_shapes.h"

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
// and each block's controls, of the templated kernels (NB known): in
// registers, every loop over the blocks unrolled.
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

// The rollout of scenario b by the calling warp (every lane calls it), its
// blocks' controls and sums in `blocks` (RegisterBlocks<NB>). The lane on
// step s < S writes the step's sensitivities and calls emit(s, px, py,
// theta, v, row, col) once.
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


// ---- The general form: NB at run time, a scenario's blocks over W warps ----

// The most blocks a warp takes (kernel_shapes.py: ROLLOUT_GENERAL_CEILINGS),
// its carries in registers.
constexpr int GENERAL_MAX_REGISTER_BLOCKS = SOCIAL_MPC_ROLLOUT_GENERAL_MAX_REGISTER_BLOCKS;
// The most warps a scenario and threads a block (kernel_shapes.py:
// ROLLOUT_GENERAL_WARPS): a block holds four warps, or one scenario's eight.
constexpr int GENERAL_MAX_THREADS = 256;
static_assert(SOCIAL_MPC_GENERAL_MAX_BLOCKS <=
                  GENERAL_MAX_THREADS / 32 * GENERAL_MAX_REGISTER_BLOCKS,
              "the most warps a scenario must hold every NB in registers");

__host__ __device__ constexpr int general_threads(int warps) {
    return 32 * (warps > WARPS ? warps : WARPS);
}

// Is (warps a scenario, blocks a warp) the launch
// kernel_shapes.rollout_general_geometry gives for NB blocks?
inline bool general_geometry_ok(int nb, int warps, int share) {
    if (warps != 1 && warps != 2 && warps != 4 && warps != 8) return false;
    return share == (nb + warps - 1) / warps && share <= GENERAL_MAX_REGISTER_BLOCKS;
}

// The sums a warp carries from one chunk of 32 steps to the next for its
// blocks j = 0, 1, ... (block w + j W), in registers, every loop over j
// unrolled to CEIL; the values are uniform across the warp.
template <int CEIL>
struct GeneralCarries {
    float dxdv[CEIL], dydv[CEIL], dxdw[CEIL], dydw[CEIL];
    int count[CEIL];
    __device__ __forceinline__ GeneralCarries() {
#pragma unroll
        for (int j = 0; j < CEIL; ++j) {
            dxdv[j] = dydv[j] = dxdw[j] = dydw[j] = 0.0f;
            count[j] = 0;
        }
    }
    __device__ __forceinline__ void get(int j, float& a, float& b, float& c, float& d,
                                        int& n) const {
        a = dxdv[j];
        b = dydv[j];
        c = dxdw[j];
        d = dydw[j];
        n = count[j];
    }
    __device__ __forceinline__ void set(int j, float a, float b, float c, float d, int n) {
        dxdv[j] = a;
        dydv[j] = b;
        dxdw[j] = c;
        dydw[j] = d;
        count[j] = n;
    }
};

// Warp w of the W that roll out scenario b (every lane calls it): the
// chunk's pose, cos and sin scans as rollout_warp runs them, then the
// sensitivities of blocks w, w + W, ... below NB (at most CEIL of them,
// carries in `carries`). ONE: S <= 32, one chunk, whose sums start from
// +0.0 and carry nothing out (no carry is read or written, no scan
// skipped). Chunk c's poses are this warp's to emit when
// c % W == W - 1 - w (the last warp, which holds the fewest blocks, emits
// the first chunk), after the chunk's pose scans and before its blocks'
// scans; the lane on step s < S of such a chunk calls emit(s, px, py,
// theta, v, row, col) once.
//
// The scans of block k in a chunk with no step of block k add exact zeros,
// so they are skipped with the same bits: the dx/dv and dy/dv integrands are
// a selected +0.0, and +0.0 added to a carry gives the carry, which is never
// -0.0 (it starts at +0.0, and x + (-x) and (+0.0) + (-0.0) round to +0.0);
// the rows are then dt * carry. Before block k's first step (its count 0)
// the dx/dw and dy/dw integrands are -/+ v sin/cos times dt * 0: signed zeros
// too, and skipped alike, but only where every lane's v cos and v sin is
// finite (a non-finite one times 0 is NaN, which the scans carry). The test
// is the chunk's ballot of blk == k and the carried count, uniform across
// the warp; it does not assume that a block's steps are contiguous.
template <int CEIL, bool ONE, typename Emit>
__device__ __forceinline__ void rollout_general_warp(
    GeneralCarries<CEIL>& carries, const float* __restrict__ u, const float* __restrict__ pose0,
    const int* __restrict__ block_idx, const float* __restrict__ win_origin,
    const float* __restrict__ resolution, float* __restrict__ sens, int b, int lane, int S,
    int NB, int w, int W, float dt, float front, Emit emit) {
    const float* ub = u + (size_t)b * 2 * NB;
    const float x0 = pose0[3 * b + 0], y0 = pose0[3 * b + 1], th0 = pose0[3 * b + 2];
    const float ox = win_origin[2 * b + 0], oy = win_origin[2 * b + 1];
    const float res = resolution[b];
    const int* bi = block_idx + (size_t)b * S;
    float* sb = sens + (size_t)b * 4 * NB * S;
    const unsigned below = (1u << lane) - 1u;
    // This warp's chunks are c = own, own + W, ...; the positions are summed
    // up to the last of them.
    const int chunks = ONE ? 1 : (S + 31) >> 5;
    const int mine_n = (NB - w + W - 1) / W;  // this warp's blocks, at most CEIL
    const int own = W - 1 - w;
    const int last_own = chunks - 1 < own ? -1 : chunks - 1 - (chunks - 1 - own) % W;

    float sum_w = 0.0f, sum_x = 0.0f, sum_y = 0.0f;
    float cos_last, sin_last;  // heading before the chunk's first step
    sincosf(th0, &sin_last, &cos_last);

    for (int c = 0; c < chunks; ++c) {
        const int s0 = c << 5;
        const int s = s0 + lane;
        const bool on = s < S;
        const bool more = !ONE && c + 1 < chunks;  // a later chunk reads the carries
        const int blk = on ? bi[s] : -1;
        const float v = on ? ub[2 * blk] : 0.0f;
        const float wv = on ? ub[2 * blk + 1] : 0.0f;
        const float cum_w = sum_w + warp_scan(wv, lane);
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
        const bool xy = c <= last_own;
        float cum_x = 0.0f, cum_y = 0.0f;
        if (xy) {
            cum_x = sum_x + warp_scan(vc, lane);
            cum_y = sum_y + warp_scan(vs, lane);
        }
        if (c % W == own) {
            const float px = x0 + dt * cum_x;
            const float py = y0 + dt * cum_y;
            if (on) {
                const float fx = px + front * cos_th;
                const float fy = py + front * sin_th;
                emit(s, px, py, th, v, (fy - oy) / res, (fx - ox) / res);
            }
        }
        if constexpr (ONE) {
            // One chunk: every sum starts from +0.0 and nothing is carried.
            for (int k = w; k < NB; k += W) {
                const bool mine = blk == k;
                const unsigned in_k = __ballot_sync(FULL_MASK, mine);
                const float dth_prev = dt * (float)__popc(in_k & below);
                const float c_dxdv = 0.0f + warp_scan(mine ? cosp : 0.0f, lane);
                const float c_dydv = 0.0f + warp_scan(mine ? sinp : 0.0f, lane);
                const float c_dxdw = 0.0f + warp_scan((-vs) * dth_prev, lane);
                const float c_dydw = 0.0f + warp_scan(vc * dth_prev, lane);
                if (on) {
                    sb[(size_t)(0 * NB + k) * S + s] = dt * c_dxdv;
                    sb[(size_t)(1 * NB + k) * S + s] = dt * c_dydv;
                    sb[(size_t)(2 * NB + k) * S + s] = dt * c_dxdw;
                    sb[(size_t)(3 * NB + k) * S + s] = dt * c_dydw;
                }
            }
        } else {
            const bool finite = __all_sync(FULL_MASK, isfinite(vc) && isfinite(vs));
#pragma unroll
            for (int j = 0; j < CEIL; ++j) {
                if (j >= mine_n) continue;  // uniform across the warp
                const int k = w + j * W;
                float c_dxdv, c_dydv, c_dxdw, c_dydw;
                int count;
                carries.get(j, c_dxdv, c_dydv, c_dxdw, c_dydw, count);
                const bool mine = blk == k;
                const unsigned in_k = __ballot_sync(FULL_MASK, mine);
                const bool v_scans = in_k != 0u;
                const bool w_scans = v_scans || count != 0 || !finite;
                if (v_scans) {
                    c_dxdv = c_dxdv + warp_scan(mine ? cosp : 0.0f, lane);
                    c_dydv = c_dydv + warp_scan(mine ? sinp : 0.0f, lane);
                }
                if (w_scans) {
                    const float dth_prev = dt * (float)(count + __popc(in_k & below));
                    c_dxdw = c_dxdw + warp_scan((-vs) * dth_prev, lane);
                    c_dydw = c_dydw + warp_scan(vc * dth_prev, lane);
                }
                if (on) {
                    sb[(size_t)(0 * NB + k) * S + s] = dt * c_dxdv;
                    sb[(size_t)(1 * NB + k) * S + s] = dt * c_dydv;
                    sb[(size_t)(2 * NB + k) * S + s] = dt * c_dxdw;
                    sb[(size_t)(3 * NB + k) * S + s] = dt * c_dydw;
                }
                if (more) {
                    if (v_scans) {
                        c_dxdv = last_lane(c_dxdv);
                        c_dydv = last_lane(c_dydv);
                    }
                    if (w_scans) {
                        c_dxdw = last_lane(c_dxdw);
                        c_dydw = last_lane(c_dydw);
                    }
                    carries.set(j, c_dxdv, c_dydv, c_dxdw, c_dydw, count + __popc(in_k));
                }
            }
        }
        if (more) {
            sum_w = last_lane(cum_w);
            if (xy) {
                sum_x = last_lane(cum_x);
                sum_y = last_lane(cum_y);
            }
            cos_last = last_lane(cos_th);
            sin_last = last_lane(sin_th);
        }
    }
}

}  // namespace rollout
