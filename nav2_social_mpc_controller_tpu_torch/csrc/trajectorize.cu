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
// A step writes six floats; its work is a hypotf and a few selects per
// valid waypoint, a warp reduction, then one chain of atan2f (two more
// sincos in the omnidirectional law) and hypotf that the next step depends
// on.
//
// Design: L lanes a scenario (16 or 32: kernel_shapes.trajectorize_lanes,
// from B), 32 / L scenarios a warp, four warps a block. Lane l of a
// scenario holds waypoints l, l + L, ... in registers, loaded once before
// the steps (P <= 128; past that the scenario's plan is copied into shared
// memory where it fits, else read from device memory). Each step's search
// is one pass without branches: a lane forms the largest index within the
// lookahead, the least masked distance and the largest index at it, and a
// NaN flag, by selects; a round of waypoints wholly past the valid ones (n,
// the most of the warp's scenarios) takes no distance (a masked +inf is a
// minimiser only where the least is +inf, and then needs no distance).
// Then log2(L) shuffle rounds take the largest index within; only where a
// scenario of the warp has none do log2(L) more take the least (distance,
// index) pair, ties going to the larger index, a NaN entering as (-inf, 0).
// The heading's cosf / sinf are taken before the search, off its chain. The
// rest of the step is uniform across the scenario's lanes, computed by
// each alike, so no lane waits for a broadcast. The lane whose number is
// the step's within a chunk of L steps keeps that step's pose and command
// in registers, and the lanes write a chunk of L steps together. Once every
// scenario of a warp is done, its poses and commands are constant: the warp
// writes the rest of them without stepping.
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
// indices, min of floats, equality), so the search's index is
// _lookahead_point's; a NaN distance behaves as in torch.min: it makes the
// masked minimum NaN, so no index is a minimiser.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int THREADS = 128;  // four warps a block
// Waypoints a scenario keeps in its lanes' registers: 128 / L a lane.
constexpr int REGISTER_POINTS = 128;
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

// One waypoint's part of the search, waypoint i (ascending within a lane):
// within the lookahead, and the least masked distance with the largest
// index at it. Past n the masked distance is +inf.
__device__ __forceinline__ void search_point(int i, int n, float x, float y, float rx, float ry,
                                             float lookahead, int& within, float& least,
                                             int& at, bool& nan) {
    // without branches: the distance taken on every lane of a round that
    // holds a valid waypoint, masked to +inf past n
    const bool valid = i < n;
    const float d = hypotf(__fsub_rn(rx, x), __fsub_rn(ry, y));
    const float m = valid ? d : INFINITY;  // NaN where a valid distance is NaN
    within = valid && d <= lookahead ? i : within;
    nan = nan || isnan(m);
    at = m <= least ? i : at;  // a NaN compares false
    least = fminf(least, m);   // and leaves the least
}

// _lookahead_point from the lanes' parts: the largest index within over the
// scenario's L lanes; where a scenario of the warp has none, the least
// (distance, index) too, ties to the larger index, a NaN as (-inf, 0). The
// index the law steers to.
template <int L>
__device__ __forceinline__ int reduce_search(int within, float least, int at, bool nan) {
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1)
        within = max(within, __shfl_xor_sync(FULL_MASK, within, off));
    if (!__any_sync(FULL_MASK, within < 0)) return within;
    float key = nan ? -INFINITY : least;
    int idx = nan ? 0 : at;
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) {
        const float k2 = __shfl_xor_sync(FULL_MASK, key, off);
        const int i2 = __shfl_xor_sync(FULL_MASK, idx, off);
        if (k2 < key || (k2 == key && i2 > idx)) {
            key = k2;
            idx = i2;
        }
    }
    return within >= 0 ? within : max(idx, 0);
}

// REG: P <= REGISTER_POINTS, the waypoints in registers; otherwise read
// through `spts`, the scenario's plan in shared memory (`shared` set) or in
// device memory.
template <int L, bool REG>
__global__ void __launch_bounds__(THREADS)
trajectorize_kernel(const float* __restrict__ points, const int* __restrict__ n_points,
                    const float* __restrict__ pose0, float* __restrict__ poses,
                    float* __restrict__ cmds, int* __restrict__ n_steps,
                    bool* __restrict__ ok, int B, int P, int S, Law law, int shared) {
    extern __shared__ float2 plan_smem[];
    const int lane = threadIdx.x & 31;
    const int sub = lane & (L - 1);  // the lane's place among its scenario's L
    const int first = (blockIdx.x * THREADS + (threadIdx.x & ~31)) / L;
    if (first >= B) return;  // a whole warp leaves together
    const int scen = (blockIdx.x * THREADS + threadIdx.x) / L;
    const bool active = scen < B;  // the lanes past B step scenario B - 1 and write nothing
    const int b = active ? scen : B - 1;
    const float* pts = points + (size_t)b * P * 2;
    const int n = n_points[b];
    const int last = min(max(n - 1, 0), P - 1);
    const float goal_x = pts[2 * last], goal_y = pts[2 * last + 1];
    float rx = pose0[3 * b], ry = pose0[3 * b + 1], rth = pose0[3 * b + 2];
    float* pb = poses + (size_t)b * (S + 1) * 3;
    float* cb = cmds + (size_t)b * S * 3;
    if (active && sub == 0) {
        pb[0] = rx;
        pb[1] = ry;
        pb[2] = rth;
        ok[b] = n >= 2;
    }

    constexpr int K = REG ? REGISTER_POINTS / L : 1;
    float wx[K], wy[K];
    const float2* spts = reinterpret_cast<const float2*>(pts);
    if (REG) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
            const int i = sub + j * L;
            wx[j] = i < P ? pts[2 * i] : 0.0f;
            wy[j] = i < P ? pts[2 * i + 1] : 0.0f;
        }
    } else if (shared) {
        float2* mine = plan_smem + (size_t)(threadIdx.x / L) * P;
        for (int i = sub; i < P; i += L) mine[i] = spts[i];
        __syncwarp();
        spts = mine;
    }

    // the most valid waypoints of the warp's scenarios
    int nmax = min(n, P);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) nmax = max(nmax, __shfl_xor_sync(FULL_MASK, nmax, off));
    bool done = n < 2;
    int steps = 0;
    float keep[6];  // this lane's step of the current chunk: pose, then command
    int t = 0;
    for (; t < S; ++t) {
        if (__all_sync(FULL_MASK, done)) break;  // uniform across the warp
        const float c = cosf(rth), s = sinf(rth);

        int within = -1, at = -1;
        float least = INFINITY;
        bool nan = false;
        if (REG) {
#pragma unroll
            for (int j = 0; j < K; ++j) {
                const int i = sub + j * L;
                if (j * L < nmax) {  // uniform: a round wholly past n takes no distance
                    int at_j = at;
                    search_point(i, min(n, P), wx[j], wy[j], rx, ry, law.lookahead, within,
                                 least, at_j, nan);
                    at = i < P ? at_j : at;  // lanes past P hold no waypoint
                } else if (i < P && least == INFINITY) {
                    at = i;
                }
            }
        } else {
            for (int i = sub; i < P; i += L) {
                const float2 q = spts[i];
                search_point(i, n, q.x, q.y, rx, ry, law.lookahead, within, least, at, nan);
            }
        }
        const int wp = reduce_search<L>(within, least, at, nan);
        const float wpx = pts[2 * wp], wpy = pts[2 * wp + 1];

        // the waypoint in the robot frame
        const float ex = __fsub_rn(wpx, rx), ey = __fsub_rn(wpy, ry);
        const float dx = __fadd_rn(__fmul_rn(ex, c), __fmul_rn(ey, s));
        const float dy = __fadd_rn(__fmul_rn(-ex, s), __fmul_rn(ey, c));
        const float dtheta = atan2f(dy, dx);

        float vx, vy, wz;
        if (law.omni) {
            vx = __fmul_rn(law.v_des, cosf(dtheta));
            vy = __fmul_rn(law.v_des, sinf(dtheta));
            wz = 0.0f;
        } else {
            const float dist2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
            const float curvature = dist2 > MIN_POINT_DIST2
                ? __fdiv_rn(__fmul_rn(2.0f, dy), fmaxf(dist2, MIN_CLAMP)) : 0.0f;
            const bool rotate = fabsf(dtheta) > HALF_PI;
            vx = rotate ? 0.0f : __fadd_rn(0.0f, law.v_des);
            wz = rotate ? __fmul_rn(law.w_max, dtheta > 0.0f ? 1.0f : -1.0f)
                        : __fmul_rn(law.v_des, curvature);
            vy = 0.0f;
        }

        // integrate_step, every term
        float nx = __fadd_rn(rx, __fmul_rn(__fsub_rn(__fmul_rn(vx, c), __fmul_rn(vy, s)), law.dt));
        float ny = __fadd_rn(ry, __fmul_rn(__fadd_rn(__fmul_rn(vx, s), __fmul_rn(vy, c)), law.dt));
        float nth = __fadd_rn(rth, __fmul_rn(wz, law.dt));
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

        const int slot = t & (L - 1);
        if (sub == slot) {
            keep[0] = nx;
            keep[1] = ny;
            keep[2] = nth;
            keep[3] = vx;
            keep[4] = vy;
            keep[5] = wz;
        }
        if (slot == L - 1 || t == S - 1) {  // write the chunk: lane l holds step t - slot + l
            const int row = t - slot + sub;
            if (active && sub <= slot) {
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                    pb[3 * (row + 1) + k] = keep[k];
                    cb[3 * row + k] = keep[3 + k];
                }
            }
        }
    }
    if (t < S && active) {
        // Every scenario of the warp is done from step t on: the chunk's
        // steps so far, then the held pose and a zero command to the end.
        const int slot = t & (L - 1);
        if (sub < slot) {
            const int row = t - slot + sub;
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                pb[3 * (row + 1) + k] = keep[k];
                cb[3 * row + k] = keep[3 + k];
            }
        }
        for (int row = t + sub; row < S; row += L) {
            pb[3 * (row + 1) + 0] = rx;
            pb[3 * (row + 1) + 1] = ry;
            pb[3 * (row + 1) + 2] = rth;
            cb[3 * row + 0] = 0.0f;
            cb[3 * row + 1] = 0.0f;
            cb[3 * row + 2] = 0.0f;
        }
    }
    if (active && sub == 0) n_steps[b] = steps;
}

template <int L>
int launch(const float* points, const int* n, const float* pose0, float* poses, float* cmds,
           int* n_steps, bool* ok, int B, int P, int S, const Law& law, cudaStream_t stream) {
    const long long threads_needed = (long long)B * L;
    const int threads = threads_needed < THREADS ? (int)((threads_needed + 31) / 32 * 32) : THREADS;
    const int blocks = (int)((threads_needed + THREADS - 1) / THREADS);
    if (P <= REGISTER_POINTS) {
        trajectorize_kernel<L, true><<<blocks, threads, 0, stream>>>(
            points, n, pose0, poses, cmds, n_steps, ok, B, P, S, law, 0);
    } else {
        // The plans of a block's scenarios in shared memory where they fit
        // in the 48 KB a launch takes without an opt-in.
        const size_t bytes = (size_t)(THREADS / L) * P * sizeof(float2);
        const bool shared = bytes <= 48 * 1024;
        trajectorize_kernel<L, false><<<blocks, threads, shared ? bytes : 0, stream>>>(
            points, n, pose0, poses, cmds, n_steps, ok, B, P, S, law, shared ? 1 : 0);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// points (B, P, 2), n (B,) int32, pose0 (B, 3) -> poses (B, S + 1, 3),
// cmds (B, S, 3), n_steps (B,) int32, ok (B,) bool; all contiguous; lanes a
// scenario 16 or 32 (kernel_shapes.trajectorize_lanes).
extern "C" int social_mpc_trajectorize_f32(const float* points, const int* n,
                                           const float* pose0, float* poses, float* cmds,
                                           int* n_steps, bool* ok, int B, int P, int S,
                                           float lookahead_dist, float desired_linear_vel,
                                           float max_angular_vel, float time_step,
                                           int omnidirectional, int lanes, cudaStream_t stream) {
    if (lanes != 16 && lanes != 32) return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaGetLastError();
    const Law law{lookahead_dist, desired_linear_vel, max_angular_vel, time_step,
                  omnidirectional};
    if (lanes == 16)
        return launch<16>(points, n, pose0, poses, cmds, n_steps, ok, B, P, S, law, stream);
    return launch<32>(points, n, pose0, poses, cmds, n_steps, ok, B, P, S, law, stream);
}
