// K6: rollout prep — the u-dependent prep of one fused LM evaluation.
//
// Replaces the TPU kernel _rollout_kernel of the JAX package's
// ops/rollout_pallas.py (public wrapper rollout_prep_pallas). For every
// scenario it expands the block-constant controls over the S rollout steps,
// integrates the unicycle model (theta, then x/y with theta from BEFORE the
// step's own update), accumulates the position sensitivities d{x,y}/dv_b and
// d{x,y}/dw_b, and turns each pose's front point into the (row, col) sample
// coordinates of the obstacle window. Outputs: six (B, S) planes
// [px, py, pth, v, row, col] and one (B, 4*NB, S) stack
// [dxdv | dydv | dxdw | dydw].
//
// The TPU kernel forms its prefix sums as products with 0/1 triangular
// matrices; that is its route to a scan and is not carried over. Design: one
// thread per scenario walks the S steps in order and carries the 3 + 4*NB
// running sums in registers (NB is a template parameter so they stay there).
// A sum is multiplied by dt where it is written, as the plain version
// multiplies its cumsum, and the serial order is the order of a CPU cumsum,
// so kernel and plain version differ by FMA contraction and by CUDA's
// sinf/cosf only. cos/sin of the new heading serve the front point of this
// step and the position integrand of the next, so each is computed once.
// The step's control is a copy u[block_idx[s]], never a product-sum: u sits
// in registers and is picked by comparisons, and the next step's block index
// is loaded a step ahead, so no step waits on two dependent global loads.
// dtheta_prev/dw_b = dt * (steps so far in block b) is an exact integer
// count times dt.
//
// Bound: bytes — it writes (6 + 4*NB) floats per step and reads almost
// nothing; at one thread per scenario it is latency-bound well above that
// (S serial steps of sincosf), which is where K1-K4 sit too.

#include <cuda_runtime.h>

namespace {

template <int NB>
__global__ void rollout_prep_kernel(
    const float* __restrict__ u, const float* __restrict__ pose0,
    const int* __restrict__ block_idx, const float* __restrict__ win_origin,
    const float* __restrict__ resolution, float* __restrict__ planes,
    float* __restrict__ sens, int B, int S, float dt, float front) {
    constexpr int D = 2 * NB;
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;

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

    const size_t plane = (size_t)B * S;
    float* out = planes + (size_t)b * S;
    float* sb = sens + (size_t)b * 4 * NB * S;

    float sum_w = 0.0f, sum_x = 0.0f, sum_y = 0.0f;
    float s_dxdv[NB], s_dydv[NB], s_dxdw[NB], s_dydw[NB], count[NB];
#pragma unroll
    for (int k = 0; k < NB; ++k) {
        s_dxdv[k] = s_dydv[k] = s_dxdw[k] = s_dydw[k] = 0.0f;
        count[k] = 0.0f;
    }
    float cosp = cosf(th0), sinp = sinf(th0);  // heading before the step

    int blk_next = bi[0];
    for (int s = 0; s < S; ++s) {
        const int blk = blk_next;
        if (s + 1 < S) blk_next = bi[s + 1];
        float v = 0.0f, w = 0.0f;
#pragma unroll
        for (int k = 0; k < NB; ++k) {
            if (k == blk) {
                v = uv[k];
                w = uw[k];
            }
        }
        const float vc = v * cosp;
        const float vs = v * sinp;
        sum_x += vc;
        sum_y += vs;
#pragma unroll
        for (int k = 0; k < NB; ++k) {
            const float dth_prev = dt * count[k];
            if (k == blk) {
                s_dxdv[k] += cosp;
                s_dydv[k] += sinp;
                count[k] += 1.0f;
            }
            s_dxdw[k] += (-vs) * dth_prev;
            s_dydw[k] += vc * dth_prev;
            sb[(size_t)(0 * NB + k) * S + s] = dt * s_dxdv[k];
            sb[(size_t)(1 * NB + k) * S + s] = dt * s_dydv[k];
            sb[(size_t)(2 * NB + k) * S + s] = dt * s_dxdw[k];
            sb[(size_t)(3 * NB + k) * S + s] = dt * s_dydw[k];
        }
        sum_w += w;
        const float th = th0 + dt * sum_w;
        const float px = x0 + dt * sum_x;
        const float py = y0 + dt * sum_y;
        cosp = cosf(th);
        sinp = sinf(th);
        const float fx = px + front * cosp;
        const float fy = py + front * sinp;
        out[0 * plane + s] = px;
        out[1 * plane + s] = py;
        out[2 * plane + s] = th;
        out[3 * plane + s] = v;
        out[4 * plane + s] = (fy - oy) / res;  // row
        out[5 * plane + s] = (fx - ox) / res;  // col
    }
}

}  // namespace

extern "C" int social_mpc_rollout_prep_f32(
    const float* u, const float* pose0, const int* block_idx,
    const float* win_origin, const float* resolution, float* planes,
    float* sens, int B, int S, int NB, float dt, float front,
    cudaStream_t stream) {
    if (B <= 0 || S <= 0) return (int)cudaGetLastError();
    const int threads = 32;  // few scenarios per block: spread them over the SMs
    const int blocks = (B + threads - 1) / threads;
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
