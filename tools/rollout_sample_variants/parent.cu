// Variant `parent` of csrc/rollout_sample.cu, timed by tools/torch_kernel_variants.py: the
// design before the general form spread a scenario's blocks over warps: one
// warp a scenario, each block's carried sums in the warp's slice of shared memory, every
// scan run; its rollout.cuh inlined, its general entry without the launch geometry.

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
// outputs equal, bit for bit, those of rollout_prep.cu then bicubic.cu; the
// general form (NB at run time, rollout.cuh) those of rollout_prep.cu's
// general form then bicubic.cu.

#include <cuda_runtime.h>

#include "bicubic.cuh"
#include "kernel_shapes.h"
// ---- the parent's rollout.cuh, inlined ----
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
// ---- end of rollout.cuh ----

namespace {

// The body of both forms: scenario b, its blocks in `blocks`. LONG: S > 64,
// the form that parks the steps past the first two chunks; the other keeps
// no code for them (and fewer registers).
template <bool LONG, typename Blocks>
__device__ __forceinline__ void rollout_sample_body(
    Blocks& blocks, const float* __restrict__ pose0, const int* __restrict__ block_idx,
    const float* __restrict__ win_origin, const float* __restrict__ resolution,
    const float* __restrict__ win, float* __restrict__ planes, float* __restrict__ sens, int b,
    int lane, int B, int S, int H, int W, float dt, float front) {
    const size_t plane = (size_t)B * S;
    float* out = planes + (size_t)b * S;
    // The lane's front point (row, col) in each of the first two chunks of 32
    // steps, kept in registers until the rollout is done; a longer rollout
    // parks the rest in the val / d_row planes, which the sample overwrites.
    float row0 = 0.0f, col0 = 0.0f, row1 = 0.0f, col1 = 0.0f;
    rollout::rollout_warp(
        blocks, pose0, block_idx, win_origin, resolution, sens, b, lane, S, dt, front,
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

// Instantiated for every NB of kernel_shapes.h's SOCIAL_MPC_BLOCKS (1..6),
// each in two forms (LONG or not).
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
    rollout::RegisterBlocks<NB> blocks(u, b);
    rollout_sample_body<LONG>(blocks, pose0, block_idx, win_origin, resolution, win, planes,
                              sens, b, lane, B, S, H, W, dt, front);
}

// The general form: NB at run time (rollout.cuh's SharedBlocks), any S (the
// LONG body, which at S <= 64 parks nothing).
__global__ void __launch_bounds__(rollout::WARPS * 32) rollout_sample_general_kernel(
    const float* __restrict__ u, const float* __restrict__ pose0,
    const int* __restrict__ block_idx, const float* __restrict__ win_origin,
    const float* __restrict__ resolution, const float* __restrict__ win,
    float* __restrict__ planes, float* __restrict__ sens, int B, int S, int NB, int H, int W,
    float dt, float front) {
    extern __shared__ float shared[];
    const int b = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (b >= B) return;  // uniform across the warp
    rollout::SharedBlocks blocks(u, b, NB, shared + (threadIdx.x >> 5) * 5 * NB, lane);
    rollout_sample_body<true>(blocks, pose0, block_idx, win_origin, resolution, win, planes,
                              sens, b, lane, B, S, H, W, dt, front);
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
#define ROLLOUT_SAMPLE_CASES(NB_)                  \
    case 2 * NB_: ROLLOUT_SAMPLE(NB_, false); break; \
    case 2 * NB_ + 1: ROLLOUT_SAMPLE(NB_, true); break;
    switch (NB * 2 + (long_rollout ? 1 : 0)) {
        SOCIAL_MPC_BLOCKS(ROLLOUT_SAMPLE_CASES)
        default: return (int)cudaErrorInvalidValue;
    }
#undef ROLLOUT_SAMPLE_CASES
#undef ROLLOUT_SAMPLE
    return (int)cudaGetLastError();
}

// NB from 1 to SOCIAL_MPC_GENERAL_MAX_BLOCKS (the wrapper takes it past
// SOCIAL_MPC_BLOCKS).
extern "C" int social_mpc_rollout_sample_general_f32(
    const float* u, const float* pose0, const int* block_idx,
    const float* win_origin, const float* resolution, const float* win, float* planes,
    float* sens, int B, int S, int NB, int H, int W, float dt, float front,
    cudaStream_t stream) {
    if (NB < 1 || NB > SOCIAL_MPC_GENERAL_MAX_BLOCKS) return (int)cudaErrorInvalidValue;
    if (B <= 0 || S <= 0) return (int)cudaGetLastError();
    const int blocks = (B + rollout::WARPS - 1) / rollout::WARPS;
    const int threads = rollout::WARPS * 32;
    const size_t shared = rollout::WARPS * rollout::shared_blocks_bytes(NB);
    rollout_sample_general_kernel<<<blocks, threads, shared, stream>>>(
        u, pose0, block_idx, win_origin, resolution, win, planes, sens, B, S, NB, H, W, dt,
        front);
    return (int)cudaGetLastError();
}
