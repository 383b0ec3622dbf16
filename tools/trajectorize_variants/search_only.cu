// Variant `search_only` of csrc/trajectorize.cu, timed by tools/torch_kernel_variants.py: a
// diagnostic, not a design: the parent's kernel with the law and the integrator replaced by
// a fixed pose update (x + 0.01 a step), so its time is the search's (and the goal test's).

// The trajectorizer: the pure-pursuit rollout that turns each scenario's
// windowed plan into its reference trajectory, max_steps steps in one launch.
//
// No TPU kernel stands behind it: it replaces the JAX package's jitted
// lax.scan (controller/trajectorizer.py: trajectorize, the scan at :123),
// which the port ran as a Python loop of max_steps steps of ~83 small ATen
// launches each (controller/trajectorizer.py: trajectorize_plain, the plain
// version this kernel is held to).
//
// Per step and scenario: the backward lookahead search over the P waypoints
// (the largest valid index within lookahead_dist, else the largest index
// among the minimisers of the masked distance, P - 1 when none is valid),
// the waypoint in the robot frame, the control law (pure pursuit with
// rotate-in-place, or omnidirectional), one Euler step of the integrator,
// and the done mask: the step count runs while the goal is farther than
// 0.2 m.
//
// What bounds it: operations, and of them the serial chain of each step.
// A step reads the plan (L1-resident after the first step) and writes six
// floats; its work is P hypotf and compares, three warp reductions, then
// one chain of cosf, sinf, atan2f (two more sincos in the omnidirectional
// law) and hypotf that the next step depends on.
//
// Design: one warp per scenario, WARPS scenarios a block. Lane l searches
// waypoints l, l + 32, ... (4 each at P = 128) and the warp reduces them
// with shuffles; the rest of the step is uniform across the warp, computed
// by every lane alike, so no lane waits for a broadcast. The lane whose
// number is the step's within a chunk of 32 keeps that step's pose and
// command in registers, and the warp writes a chunk of 32 steps with one
// store instruction per component. At B = 4096 that is 4,096 warps over
// 132 SMs; at B = 1 one warp in place of the plain loop's ~2,500 launches.
//
// Numerics: the kernel repeats the plain PyTorch loop operation for
// operation. Every product, sum and difference is its own rounded operation
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, which nvcc never contracts
// into FMA), as each ATen launch rounds its result; cosf, sinf, atan2f and
// hypotf are CUDA's IEEE-mode functions that ATen's kernels call (no fast
// math); the thresholds are the float32 values ATen compares with (a
// Python float rounded to float32); every term of the integrator is
// computed, the zero vy terms of the unicycle law included, since their
// signed zeros can reach the result. The reductions are exact (max of
// indices, min of floats) and a NaN distance behaves as in torch.min: it
// makes the masked minimum NaN, so no index is a minimiser.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int WARPS = 4;  // scenarios (warps) per block
// The thresholds as ATen compares with them: the Python float of
// controller/trajectorizer.py rounded to float32.
constexpr float HALF_PI = (float)(3.14159265358979323846 / 2.0);
constexpr float MIN_POINT_DIST2 = (float)0.001;
constexpr float MIN_CLAMP = (float)1e-30;
constexpr float GOAL_DIST_THRESHOLD = (float)0.2;

struct Law {
    float lookahead, v_des, w_max, dt;
    int omni;
};

__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = max(x, __shfl_xor_sync(FULL_MASK, x, off));
    return x;
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = fminf(x, __shfl_xor_sync(FULL_MASK, x, off));
    return x;
}

// The distance torch.hypot(rx - px, ry - py) of waypoint i.
__device__ __forceinline__ float waypoint_dist(const float* pts, int i, float rx, float ry) {
    return hypotf(__fsub_rn(rx, pts[2 * i]), __fsub_rn(ry, pts[2 * i + 1]));
}

// _lookahead_point: the index of the waypoint the law steers to.
__device__ __forceinline__ int lookahead_index(const float* pts, int P, int n, float rx,
                                               float ry, float lookahead, int lane) {
    int within = -1;
    float least = INFINITY;
    bool nan = false;
    for (int i = lane; i < P; i += 32) {
        const float d = waypoint_dist(pts, i, rx, ry);
        const bool valid = i < n;
        if (valid && d <= lookahead) within = i;  // i grows: the lane's largest
        const float masked = valid ? d : INFINITY;
        if (isnan(masked)) nan = true;
        else least = fminf(least, masked);
    }
    within = warp_max(within);
    if (within >= 0) return within;
    // The largest index whose masked distance equals the minimum; none when
    // a NaN made the minimum NaN (index -1, clamped to 0 as the plain
    // version clamps it). Uniform branch: every lane takes it or none.
    if (__any_sync(FULL_MASK, nan)) return 0;
    least = warp_min(least);
    int at = -1;
    for (int i = lane; i < P; i += 32) {
        const float masked = i < n ? waypoint_dist(pts, i, rx, ry) : INFINITY;
        if (masked == least) at = i;
    }
    return max(warp_max(at), 0);
}

__global__ void __launch_bounds__(WARPS * 32)
trajectorize_kernel(const float* __restrict__ points, const int* __restrict__ n_points,
                    const float* __restrict__ pose0, float* __restrict__ poses,
                    float* __restrict__ cmds, int* __restrict__ n_steps,
                    bool* __restrict__ ok, int B, int P, int S, Law law) {
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (b >= B) return;  // a whole warp leaves together
    const float* pts = points + (size_t)b * P * 2;
    const int n = n_points[b];
    const int last = min(max(n - 1, 0), P - 1);
    const float goal_x = pts[2 * last], goal_y = pts[2 * last + 1];
    float rx = pose0[3 * b], ry = pose0[3 * b + 1], rth = pose0[3 * b + 2];
    float* pb = poses + (size_t)b * (S + 1) * 3;
    float* cb = cmds + (size_t)b * S * 3;
    if (lane == 0) {
        pb[0] = rx;
        pb[1] = ry;
        pb[2] = rth;
        ok[b] = n >= 2;
    }
    bool done = n < 2;
    int steps = 0;
    float keep[6];  // this lane's step of the current chunk: pose, then command

    for (int t = 0; t < S; ++t) {
        const int wp = lookahead_index(pts, P, n, rx, ry, law.lookahead, lane);
        const float wpx = pts[2 * wp], wpy = pts[2 * wp + 1];

        // a fixed pose update in place of the law and the integrator; the
        // search's index is kept as the command so that it is computed
        float vx = (float)wp + 0.0f * wpx + 0.0f * wpy, vy = 0.0f, wz = 0.0f;
        float nx = __fadd_rn(rx, 0.01f), ny = ry, nth = rth;
        if (done) {  // hold the pose, emit a zero command
            nx = rx;
            ny = ry;
            nth = rth;
            vx = vy = wz = 0.0f;
        }
        const float goal_dist = hypotf(__fsub_rn(nx, goal_x), __fsub_rn(ny, goal_y));
        steps += done ? 0 : 1;
        done = done || goal_dist <= GOAL_DIST_THRESHOLD;
        rx = nx;
        ry = ny;
        rth = nth;

        const int slot = t & 31;
        if (lane == slot) {
            keep[0] = nx;
            keep[1] = ny;
            keep[2] = nth;
            keep[3] = vx;
            keep[4] = vy;
            keep[5] = wz;
        }
        if (slot == 31 || t == S - 1) {  // write the chunk: lane l holds step t - slot + l
            const int row = t - slot + lane;
            if (lane <= slot) {
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                    pb[3 * (row + 1) + k] = keep[k];
                    cb[3 * row + k] = keep[3 + k];
                }
            }
        }
    }
    if (lane == 0) n_steps[b] = steps;
}

}  // namespace

// points (B, P, 2), n (B,) int32, pose0 (B, 3) -> poses (B, S + 1, 3),
// cmds (B, S, 3), n_steps (B,) int32, ok (B,) bool; all contiguous.
extern "C" int social_mpc_trajectorize_f32(const float* points, const int* n,
                                           const float* pose0, float* poses, float* cmds,
                                           int* n_steps, bool* ok, int B, int P, int S,
                                           float lookahead_dist, float desired_linear_vel,
                                           float max_angular_vel, float time_step,
                                           int omnidirectional, cudaStream_t stream) {
    if (B > 0) {
        const Law law{lookahead_dist, desired_linear_vel, max_angular_vel, time_step,
                      omnidirectional};
        const int warps = B < WARPS ? B : WARPS;
        trajectorize_kernel<<<(B + WARPS - 1) / WARPS, warps * 32, 0, stream>>>(
            points, n, pose0, poses, cmds, n_steps, ok, B, P, S, law);
    }
    return (int)cudaGetLastError();
}
