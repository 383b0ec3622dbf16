// K5: the Social Force Model people-projection scan, whole horizon in one
// launch.
//
// Replaces the TPU kernel _sfm_scan_kernel of the JAX package's
// models/sfm_pallas.py: the forward simulation of N pedestrians along the
// robot's reference rows (Optimizer::project_people, optimizer.cpp:554-671),
// S steps of computeForces (sfm.hpp:462-485) + updatePosition (:525-573),
// with each agent's nearest obstacle refreshed from the ESDF index grid at
// every step. Same masks, same freeze logic and the same reference quirks as
// the plain version in models/sfm.py: invalid agents and steps beyond the
// robot's rows are emitted as zero / t = -1 padding rows, an invalid ESDF
// projects nobody, the stored obstacle entry is subtracted from the position
// twice (sfm.hpp:210).
//
// What bounds it: the chain of S dependent steps, not bytes (a few KB per
// scenario). A step of an agent is ~1,100 instructions (compiled SASS): N
// pair forces of ~380 each (two atan2f, two expf, two normalisations with
// IEEE divisions, each division and square root a short dependent sequence
// closed by a branch to its slow path), then ~700 for the desired and
// obstacle forces, the update, the heading with its angle wraps and the
// nearest-obstacle lookup. A warp issues them in order and waits on nearly
// every one: one thread per agent took ~9,000 clocks a step on an H100.
//
// Design: a block per group of scenarios: F FORCE warps, an OBSTACLE warp
// and a DESIRE warp. A force warp puts its scenarios' agents on parallel
// lanes: an agent owns LPA = ceil(N / SPL) lanes, and its lane t computes
// the forces on it from sources t*SPL .. t*SPL + SPL - 1 of its list (the
// other agents in ascending order, then the robot), so a step's chain holds
// SPL pair forces, not N. Every lane of the agent gathers the N forces by
// shuffles and adds them in the list's order, which is the serial loop's
// order (a skipped source adds +0, which changes no sum that starts at +0),
// then moves the agent; the sources' states come by shuffles from their
// agents' lanes and the robot's positions and velocities from shared memory,
// staged once before the scan. The two agent warps, a lane for each agent of
// the block, compute the rest while the force warps compute the social
// forces: the obstacle warp the obstacle force, and once the agents have
// moved the nearest-obstacle lookup for the next step's; the desire warp the
// desired force, and once the agents have moved the goal test, then the
// heading (atan2f, two angle wraps, a division) and the output row. They
// exchange a float4 per agent through shared memory at two named barriers
// of the block a step (arrive by the producers, sync by the consumers). The
// agent warps serve F force warps (F = 3 at N = 3, 5 at N = 6) because their
// instructions are as many for 27 agents as for 9: a warp pair per force
// warp was as fast alone and 1.8x slower at B = 4096; one agent warp for
// everything made its cycle, not the force warps', the step's (10 % slower
// at social B = 4096). Every quantity is computed by the operations, in the
// order, of the serial scan. The launch geometry (SPL, and the scenarios per
// warp and per block that follow from it) is chosen by the wrapper
// (models/sfm.py: scan_geometry) and held here against N. N runs from 1 to
// 32 (kernel_shapes.h): past 16 agents an agent has one force lane, which
// takes its N sources in a loop, and a block holds one scenario; at N = 33
// a scenario's force lanes no longer fit one warp.
//
// The lookup is one read of the index grid, with the query cell clamped into
// the agent's window exactly as the JAX package's table lookup clamps it
// (window = 0: no window, the whole grid); the TPU kernel's packed-u16
// obstacle tables and masked max-reduce replaced a gather that machine does
// badly. A block whose scenarios hold no valid agent (every block of a
// people-free batch) writes its rows, the inputs and the padding, with all
// of its threads and leaves before the scan.
//
// atan2f, sinf, cosf, expf, sqrtf and division are the IEEE versions (no
// fast math). nvcc contracts a*b+c into FMA and the plain version does not,
// so the two agree to float32 rounding carried through S steps, not bit for
// bit; the t column (validity) is exact.

#include <cuda_runtime.h>
#include <math.h>

#include "kernel_shapes.h"

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float kEpsDir = 1e-6f;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

struct SfmArgs {
    const float* people;             // (B, N, 6) [x, y, yaw, t, lv, av]
    const float* rows;               // (B, S1, 6) robot reference rows
    const int* n_rows;               // (B,)
    const int* indexes;              // (B, H, W) flat x + y*W of the nearest obstacle
    const float* origin;             // (B, 2)
    const float* resolution;         // (B,)
    const unsigned char* esdf_valid; // (B,)
    float* out;                      // (B, S1, N, 6)
    int B, N, S1, H, W, window;
    float maxtime, dt;
    float lam, gamma, n_sfm, n_prime, f_social;
    float f_desired, relax, f_obstacle, sigma_obstacle;
    float people_desired, people_radius, goal_radius;
};

__device__ __forceinline__ float norm2(float x, float y) { return sqrtf(x * x + y * y); }

// normalize with the coincident guard: a zero-length vector becomes (eps, 0)
__device__ __forceinline__ void safe_dir(float x, float y, float& ox, float& oy, float& on) {
    float n = norm2(x, y);
    const bool tiny = n < kEpsDir;
    x = tiny ? kEpsDir : x;
    y = tiny ? 0.0f : y;
    n = tiny ? kEpsDir : n;
    ox = x / n;
    oy = y / n;
    on = n;
}

// remainder with the sign of the (positive) divisor
__device__ __forceinline__ float remainder_pos(float a, float b) {
    float m = fmodf(a, b);
    if (m != 0.0f && m < 0.0f) m += b;
    return m;
}

// remainder_pos(x, kTwoPi), bit for bit, without fmodf's loop where
// |x| < 2 kTwoPi: every argument the scan wraps is a difference of two
// atan2f results or of two wrapped yaws, except on a first step from an
// unwrapped input yaw. In that range fmodf(x, kTwoPi) is x, x - kTwoPi or
// x + kTwoPi, each exact (the last two by Sterbenz's lemma), and the sign
// fix adds kTwoPi with the rounding fmodf's caller gives it. NaN and larger
// |x| take fmodf.
__device__ __forceinline__ float remainder_two_pi(float x) {
    if (!(fabsf(x) < 2.0f * kTwoPi)) return remainder_pos(x, kTwoPi);
    if (x >= kTwoPi) return x - kTwoPi;
    if (x >= 0.0f) return x;
    if (x > -kTwoPi) return x + kTwoPi;
    const float m = x + kTwoPi;  // fmodf's value, <= 0 (-0.0 at x = -kTwoPi)
    return m < 0.0f ? m + kTwoPi : -0.0f;
}

// wrap to (-pi, pi], the reference's while-loops (sfm.hpp:252-260)
__device__ __forceinline__ float wrap_to_pi(float a) {
    return -(remainder_two_pi(-a + kPi) - kPi);
}

// computeSocialForce (sfm.hpp:237-281): force on entity j from entity k
__device__ __forceinline__ void pair_social(const SfmArgs& a, float pxj, float pyj,
                                            float vxj, float vyj, float pxk, float pyk,
                                            float vxk, float vyk, float& fx, float& fy) {
    float ddx, ddy, dn, idx, idy, ilen;
    safe_dir(pxk - pxj, pyk - pyj, ddx, ddy, dn);
    safe_dir(a.lam * (vxj - vxk) + ddx, a.lam * (vyj - vyk) + ddy, idx, idy, ilen);
    const float theta = wrap_to_pi(atan2f(ddy, ddx) - atan2f(idy, idx));
    const float b = a.gamma * ilen;
    const float tv = a.n_prime * b * theta;
    const float ta = a.n_sfm * b * theta;
    const float fv = -expf(-dn / b - tv * tv);
    const float sgn = theta > 0.0f ? 1.0f : (theta < 0.0f ? -1.0f : 0.0f);
    const float fa = -sgn * expf(-dn / b - ta * ta);
    fx = a.f_social * (fv * idx + fa * (-idy));
    fy = a.f_social * (fv * idy + fa * idx);
}

// floor((q - origin) / res) as a cell index clamped to [-1, n]: -1 and n
// stand for every out-of-range cell (NaN counts as out of range).
__device__ __forceinline__ int cell_of(float q, float origin, float res, int n) {
    float c = floorf((q - origin) / res);
    c = c != c ? -1.0f : fminf(fmaxf(c, -1.0f), (float)n);
    return (int)c;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// Where one agent's nearest-obstacle lookups read: its scenario's index
// grid and frame, and the corner of the agent's window.
struct Esdf {
    const int* grid;
    float ox, oy, res;
    int start_col, start_row;
    bool ok;
};

// Optimizer::computeObstacle (optimizer.cpp:688-727): query minus the world
// corner of its nearest obstacle cell, and whether the query is on the grid.
__device__ __forceinline__ void lookup(const SfmArgs& a, const Esdf& e, float qx, float qy,
                                       float& ex, float& ey, bool& inb) {
    const int xcell = cell_of(qx, e.ox, e.res, a.W);
    const int ycell = cell_of(qy, e.oy, e.res, a.H);
    inb = xcell >= 0 && xcell < a.W && ycell >= 0 && ycell < a.H;
    int xc = clampi(xcell, 0, a.W - 1);
    int yc = clampi(ycell, 0, a.H - 1);
    if (a.window > 0) {
        xc = e.start_col + clampi(xc - e.start_col, 0, a.window - 1);
        yc = e.start_row + clampi(yc - e.start_row, 0, a.window - 1);
    }
    const int idx = clampi(e.grid[(size_t)yc * a.W + xc], 0, a.H * a.W - 1);
    ex = qx - ((float)(idx % a.W) * e.res + e.ox);
    ey = qy - ((float)(idx / a.W) * e.res + e.oy);
}

// One agent along the scan, as the agent warps hold it.
struct Agent {
    float px, py, vx, vy, yaw, lv, av;
    float gx, gy;    // constant-velocity-model goal (optimizer.cpp:587-591)
    float oex, oey;  // stored nearest-obstacle entry
    bool has_goal, ohas;
};

// desired force (sfm.hpp:188-203); both cases divide their numerator by the
// relaxation time
__device__ __forceinline__ void desired_force(const SfmArgs& a, const Agent& g, float& fdx,
                                              float& fdy) {
    const float dx = g.gx - g.px, dy = g.gy - g.py;
    const float dist = norm2(dx, dy);
    const bool pursuing = g.has_goal && dist > a.goal_radius;
    const float den = fmaxf(dist, kEpsDir);
    fdx = (pursuing ? a.f_desired * (dx / den * a.people_desired - g.vx) : -g.vx) / a.relax;
    fdy = (pursuing ? a.f_desired * (dy / den * a.people_desired - g.vy) : -g.vy) / a.relax;
}

// obstacle force (sfm.hpp:205-235): minDiff = pos - stored entry
__device__ __forceinline__ void obstacle_force(const SfmArgs& a, const Agent& g, float& fox,
                                               float& foy) {
    fox = 0.0f;
    foy = 0.0f;
    if (g.ohas) {
        const float mdx = g.px - g.oex, mdy = g.py - g.oey;
        const float odist = norm2(mdx, mdy) - a.people_radius;
        float odx, ody, on;
        safe_dir(mdx, mdy, odx, ody, on);
        const float amp = a.f_obstacle * expf(-odist / a.sigma_obstacle);
        fox = amp * odx;
        foy = amp * ody;
    }
}

// updatePosition's velocity and position (sfm.hpp:525-573) under the
// desired, social and obstacle forces
__device__ __forceinline__ void move(const SfmArgs& a, float fdx, float fdy, float sx, float sy,
                                     float fox, float foy, float& px, float& py, float& vx,
                                     float& vy) {
    float nvx = vx + (fdx + sx + fox) * a.dt;
    float nvy = vy + (fdy + sy + foy) * a.dt;
    const float speed = norm2(nvx, nvy);
    if (speed > a.people_desired) {
        const float sden = fmaxf(speed, kEpsDir);
        nvx = nvx / sden * a.people_desired;
        nvy = nvy / sden * a.people_desired;
    }
    px = px + nvx * a.dt;
    py = py + nvy * a.dt;
    vx = nvx;
    vy = nvy;
}

// After a move to (npx, npy): the goal test
__device__ __forceinline__ void goal_test(const SfmArgs& a, Agent& g, float npx, float npy) {
    if (g.has_goal && norm2(g.gx - npx, g.gy - npy) <= a.goal_radius) g.has_goal = false;
}

// After a move to (npx, npy): the nearest obstacle at the new position
// (optimizer.cpp:641-645)
__device__ __forceinline__ void nearest_obstacle(const SfmArgs& a, const Esdf& e, Agent& g,
                                                 float npx, float npy) {
    bool inb;
    lookup(a, e, npx, npy, g.oex, g.oey, inb);
    g.ohas = inb && e.ok;
}

// After a move to velocity (nvx, nvy): yaw, angular velocity and speed,
// which only the output rows read
__device__ __forceinline__ void heading(const SfmArgs& a, Agent& g, float nvx, float nvy) {
    const float new_yaw = wrap_to_pi(atan2f(nvy, nvx));
    g.av = wrap_to_pi(new_yaw - g.yaw) / a.dt;
    g.yaw = new_yaw;
    g.lv = norm2(nvx, nvy);
}

template <int N, int SPL>
struct Geometry {
    static constexpr int LPA = (N + SPL - 1) / SPL;  // force-warp lanes per agent
    static constexpr int LPS = N * LPA;              // force-warp lanes per scenario
    static constexpr int SPW = 32 / LPS;             // scenarios per force warp
    static constexpr int F = 32 / (N * SPW);         // force warps per block
    static constexpr int SPG = F * SPW;              // scenarios per block
};

// Named barriers of the block (every thread takes part), in their
// non-aligned form: a warp may reach one just after code in which its lanes
// diverged.
__device__ __forceinline__ void bar_sync(int id) {
    asm volatile("barrier.sync %0, %1;" ::"r"(id), "r"((int)blockDim.x) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
    asm volatile("barrier.arrive %0, %1;" ::"r"(id), "r"((int)blockDim.x) : "memory");
}

// Whether any agent of the block's scenarios is valid: the same answer in
// every warp of the block.
template <int N, int SPG>
__device__ __forceinline__ bool any_valid(const SfmArgs& a, int b0, int lane) {
    const int b = b0 + lane / N;
    const bool valid = lane < SPG * N && b < a.B && a.esdf_valid[b] != 0
                       && a.people[((size_t)b * N + lane % N) * 6 + 3] != -1.0f;
    return __any_sync(FULL_MASK, valid);
}

// A force warp, for the SPW scenarios from b0: lane t of agent j computes
// the social forces on j from sources t*SPL .. t*SPL + SPL - 1 of its list,
// gathers the N forces, and moves the agent under them and the agent warps'
// desired and obstacle forces. Every lane of an agent holds its position and
// velocity.
template <int N, int SPL>
__device__ __forceinline__ void force_warp(const SfmArgs& a, int b0, int lane, int steps,
                                           float4* robot, float4* state, const float4* force,
                                           int bar_force, int bar_state) {
    constexpr int LPA = Geometry<N, SPL>::LPA;
    constexpr int LPS = Geometry<N, SPL>::LPS;
    constexpr int SPW = Geometry<N, SPL>::SPW;
    // The lanes past SPW * LPS shadow agents of the last scenario slot: they
    // take part in the shuffles and write nothing.
    const int slot = min(lane / LPS, SPW - 1);
    const int r = lane - (lane / LPS) * LPS;
    const int j = r / LPA;      // agent
    const int t = r - j * LPA;  // the agent's lane
    const bool live = lane < SPW * LPS && b0 + slot < a.B;
    const int b = min(b0 + slot, a.B - 1);
    const int base = slot * LPS;  // the scenario's first lane
    const float* p = a.people + ((size_t)b * N + j) * 6;
    const bool valid0 = live && p[3] != -1.0f && a.esdf_valid[b] != 0;
    const int n_rows = a.n_rows[b];

    // The robot's position and velocity at every step of the warp's
    // scenarios, staged once.
    for (int q = lane; q < SPW * steps; q += 32) {
        const int sq = q / steps;
        const int i = q - sq * steps;
        const float* rr = a.rows + ((size_t)min(b0 + sq, a.B - 1) * a.S1 + i) * 6;
        const float r_yaw = rr[2], r_lv = rr[4];
        robot[q] = make_float4(rr[0], rr[1], r_lv * cosf(r_yaw), r_lv * sinf(r_yaw));
    }
    __syncwarp();
    const float4* my_robot = robot + slot * steps;

    float px = p[0], py = p[1];
    const float yaw = p[2], lv = p[4];
    float vx = lv * cosf(yaw), vy = lv * sinf(yaw);

    // This lane's sources: source m of agent j is agent m (m < j), agent
    // m + 1 (j <= m < N - 1) or the robot (m = N - 1); a force counts when
    // its source is the robot or a valid agent. With one lane an agent
    // (LPA = 1, N > 16) the lane takes its N sources one after the other in
    // a loop that is not unrolled: unrolled, N pair forces of ~380
    // instructions each would make the kernel N times longer, for no
    // parallelism, and its arrays of N sources would not fit in registers.
    constexpr int NQ = LPA == 1 ? 1 : SPL;  // the unrolled sources' arrays
    int src[NQ];
    bool is_robot[NQ], use[NQ];
    if constexpr (LPA > 1) {
#pragma unroll
        for (int q = 0; q < SPL; ++q) {
            const int m = t * SPL + q;
            const bool is_agent = m < N - 1;
            src[q] = is_agent ? base + (m < j ? m : m + 1) * LPA : lane;
            is_robot[q] = m == N - 1;
            const bool k_valid = __shfl_sync(FULL_MASK, (int)valid0, src[q]) != 0;
            use[q] = is_robot[q] || (is_agent && k_valid);
        }
    }
    const unsigned valid_lanes = __ballot_sync(FULL_MASK, valid0);
    float4* my_state = state + slot * N + j;
    const float4* my_force = force + slot * N + j;
    const bool writer = live && t == 0;

    for (int i = 0; i < steps; ++i) {
        const float4 rb = my_robot[i];
        // the social force on the agent: its N sources in the list's order
        float sx = 0.0f, sy = 0.0f;
        if constexpr (LPA == 1) {
#pragma unroll 1
            for (int m = 0; m < N; ++m) {
                const bool is_agent = m < N - 1;
                const int k = is_agent ? base + (m < j ? m : m + 1) : lane;
                const bool counts = !is_agent || ((valid_lanes >> k) & 1u) != 0;
                const float kx = __shfl_sync(FULL_MASK, px, k);
                const float ky = __shfl_sync(FULL_MASK, py, k);
                const float kvx = __shfl_sync(FULL_MASK, vx, k);
                const float kvy = __shfl_sync(FULL_MASK, vy, k);
                float f_x, f_y;
                pair_social(a, px, py, vx, vy, is_agent ? kx : rb.x, is_agent ? ky : rb.y,
                            is_agent ? kvx : rb.z, is_agent ? kvy : rb.w, f_x, f_y);
                sx += counts ? f_x : 0.0f;
                sy += counts ? f_y : 0.0f;
            }
        } else {
            float fx[SPL], fy[SPL];
#pragma unroll
            for (int q = 0; q < SPL; ++q) {
                const float kx = __shfl_sync(FULL_MASK, px, src[q]);
                const float ky = __shfl_sync(FULL_MASK, py, src[q]);
                const float kvx = __shfl_sync(FULL_MASK, vx, src[q]);
                const float kvy = __shfl_sync(FULL_MASK, vy, src[q]);
                float f_x, f_y;
                pair_social(a, px, py, vx, vy, is_robot[q] ? rb.x : kx, is_robot[q] ? rb.y : ky,
                            is_robot[q] ? rb.z : kvx, is_robot[q] ? rb.w : kvy, f_x, f_y);
                fx[q] = use[q] ? f_x : 0.0f;
                fy[q] = use[q] ? f_y : 0.0f;
            }
#pragma unroll
            for (int m = 0; m < N; ++m) {
                const int from = base + j * LPA + m / SPL;
                sx += __shfl_sync(FULL_MASK, fx[m % SPL], from);
                sy += __shfl_sync(FULL_MASK, fy[m % SPL], from);
            }
        }
        bar_sync(bar_force);  // the agent warps' forces of this step are in
        const float4 f = *my_force;
        if (valid0 && i < n_rows - 1) move(a, f.x, f.y, sx, sy, f.z, f.w, px, py, vx, vy);
        if (writer) *my_state = make_float4(px, py, vx, vy);
        bar_arrive(bar_state);
    }
}

// An agent warp, a lane for each agent of the block. The obstacle warp: the
// obstacle force of each step, then, once the force warps have moved the
// agents, the nearest obstacle at the new position. The desire warp: the
// desired force, then the goal test at the new position; the heading and
// the output row of a step while the force warps compute the next step's
// social forces.
template <int N, int SPL, bool OBSTACLE>
__device__ __forceinline__ void agent_warp(const SfmArgs& a, int b0, int lane, int steps,
                                           const float4* state, float4* force, int bar_force,
                                           int bar_state) {
    constexpr int SPG = Geometry<N, SPL>::SPG;
    const int slot = min(lane / N, SPG - 1);
    const int j = lane - (lane / N) * N;
    const bool live = lane < SPG * N && b0 + slot < a.B;
    const int b = min(b0 + slot, a.B - 1);
    const float* p = a.people + ((size_t)b * N + j) * 6;
    const bool esdf_ok = a.esdf_valid[b] != 0;
    const bool valid0 = live && p[3] != -1.0f && esdf_ok;
    const int n_rows = a.n_rows[b];
    float* out = a.out + (size_t)b * a.S1 * N * 6 + (size_t)j * 6;

    Agent g;
    g.px = p[0];
    g.py = p[1];
    g.yaw = p[2];
    g.lv = p[4];
    g.av = p[5];
    g.vx = g.lv * cosf(g.yaw);
    g.vy = g.lv * sinf(g.yaw);
    g.gx = g.px + a.maxtime * g.vx;
    g.gy = g.py + a.maxtime * g.vy;
    g.has_goal = valid0;
    Esdf e;
    e.grid = a.indexes + (size_t)b * a.H * a.W;
    e.ox = a.origin[2 * b];
    e.oy = a.origin[2 * b + 1];
    e.res = a.resolution[b];
    e.ok = esdf_ok;
    e.start_col = 0;
    e.start_row = 0;
    if (a.window > 0) {
        // unclamped floor of the start cell, as the window crop takes it
        const float cx = fminf(fmaxf(floorf((g.px - e.ox) / e.res), -1.0e9f), 1.0e9f);
        const float cy = fminf(fmaxf(floorf((g.py - e.oy) / e.res), -1.0e9f), 1.0e9f);
        const int half = a.window / 2;
        e.start_col = clampi((cx != cx ? 0 : (int)cx) - half, 0, a.W - a.window);
        e.start_row = clampi((cy != cy ? 0 : (int)cy) - half, 0, a.H - a.window);
    }
    bool inb;
    lookup(a, e, g.px, g.py, g.oex, g.oey, inb);
    g.ohas = inb && esdf_ok;

    // the obstacle warp writes (fox, foy), the desire warp (fdx, fdy)
    float2* my_force = reinterpret_cast<float2*>(force + slot * N + j) + (OBSTACLE ? 1 : 0);
    const float4* my_state = state + slot * N + j;
    // Row i of the output: the agent after step i - 1 (act: it moved then).
    auto emit = [&](int i, bool act) {
        if (act) heading(a, g, g.vx, g.vy);
        if (live) {
            float* o = out + (size_t)i * N * 6;
            o[0] = act ? g.px : 0.0f;
            o[1] = act ? g.py : 0.0f;
            o[2] = act ? g.yaw : 0.0f;
            o[3] = act ? (float)i * a.dt : -1.0f;
            o[4] = act ? g.lv : 0.0f;
            o[5] = act ? g.av : 0.0f;
        }
    };
    bool moved = false;  // whether the step before this one moved the agent
    for (int i = 0; i < steps; ++i) {
        float fx, fy;
        if (OBSTACLE) obstacle_force(a, g, fx, fy);
        else desired_force(a, g, fx, fy);
        if (live) *my_force = make_float2(fx, fy);
        bar_arrive(bar_force);
        if (!OBSTACLE && i > 0) emit(i, moved);
        bar_sync(bar_state);  // the force warps have moved the agents
        const float4 st = *my_state;
        moved = valid0 && i < n_rows - 1;
        if (moved) {
            if (OBSTACLE) nearest_obstacle(a, e, g, st.x, st.y);
            else goal_test(a, g, st.x, st.y);
        }
        g.px = st.x;
        g.py = st.y;
        g.vx = st.z;
        g.vy = st.w;
    }
    if (!OBSTACLE && steps > 0) emit(steps, moved);
}

template <int N, int SPL>
__global__ void sfm_scan_kernel(const SfmArgs a) {
    constexpr int SPW = Geometry<N, SPL>::SPW;
    constexpr int F = Geometry<N, SPL>::F;
    constexpr int SPG = Geometry<N, SPL>::SPG;
    extern __shared__ float4 sh[];
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int b0 = blockIdx.x * SPG;
    if (b0 >= a.B) return;  // uniform across the block
    const bool is_force_warp = w < F;  // then the obstacle warp, then the desire warp

    // No valid agent in the block's scenarios: row 0 is the input verbatim,
    // every later row padding, written by all of the block's threads.
    if (!any_valid<N, SPG>(a, b0, lane)) {
        const int row = N * 6;
        const size_t total = (size_t)min(SPG, a.B - b0) * a.S1 * row;
        float* out = a.out + (size_t)b0 * a.S1 * row;
        for (size_t k = threadIdx.x; k < total; k += blockDim.x) {
            const int in_row = (int)(k % row);
            const size_t sr = k / row;  // scenario * S1 + step
            const int step = (int)(sr % a.S1);
            const size_t b = b0 + sr / a.S1;
            out[k] = step == 0 ? a.people[b * row + in_row] : (in_row % 6 == 3 ? -1.0f : 0.0f);
        }
        return;
    }

    const int steps = a.S1 - 1;
    float4* state = sh;                // per agent: (px, py, vx, vy) after the step
    float4* force = state + SPG * N;   // per agent: (fdx, fdy, fox, foy) of the step
    float4* robot = force + SPG * N;   // per force warp: (x, y, vx, vy)
    const int bar_force = 1, bar_state = 2;
    if (is_force_warp) {
        force_warp<N, SPL>(a, b0 + w * SPW, lane, steps, robot + (size_t)w * SPW * steps,
                           state + w * SPW * N, force + w * SPW * N, bar_force, bar_state);
    } else {
        if (w == F && lane < SPG * N && b0 + lane / N < a.B) {  // slot 0: the input verbatim
            const float* p = a.people + ((size_t)(b0 + lane / N) * N + lane % N) * 6;
            float* out = a.out + (size_t)(b0 + lane / N) * a.S1 * N * 6 + (size_t)(lane % N) * 6;
#pragma unroll
            for (int c = 0; c < 6; ++c) out[c] = p[c];
        }
        if (w == F) {
            agent_warp<N, SPL, true>(a, b0, lane, steps, state, force, bar_force, bar_state);
        } else {
            agent_warp<N, SPL, false>(a, b0, lane, steps, state, force, bar_force, bar_state);
        }
    }
}

// Dynamic shared memory above the 48 KB every launch may take needs the
// kernel's opt-in; the card's limit a block (227 KB on an H100) is the
// ceiling. At N = 1 (32 scenarios a block) a rollout past 94 steps needs it.
constexpr size_t kDefaultSharedBytes = 48 * 1024;

template <int N, int SPL>
int launch(const SfmArgs& a, int blocks, cudaStream_t stream) {
    constexpr int SPW = Geometry<N, SPL>::SPW;
    constexpr int F = Geometry<N, SPL>::F;
    constexpr int SPG = Geometry<N, SPL>::SPG;
    static_assert(SPW >= 1 && F >= 1, "a scenario must fit in one warp");
    if ((long long)blocks * SPG < a.B) return (int)cudaErrorInvalidValue;
    const int steps = a.S1 > 1 ? a.S1 - 1 : 0;
    const size_t shmem = (size_t)(2 * SPG * N + F * SPW * steps) * sizeof(float4);
    if (shmem > kDefaultSharedBytes) {
        static int opted = 0;  // this instantiation's opt-in, made once (before any capture)
        if (opted == 0) {
            int dev = 0, limit = 0;
            cudaError_t e = cudaGetDevice(&dev);
            if (e == cudaSuccess)
                e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
            if (e == cudaSuccess)
                e = cudaFuncSetAttribute(sfm_scan_kernel<N, SPL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
            if (e != cudaSuccess) {
                cudaGetLastError();
                return (int)e;
            }
            opted = limit;
        }
        if (shmem > (size_t)opted) return (int)cudaErrorInvalidValue;
    }
    sfm_scan_kernel<N, SPL><<<blocks, (F + 2) * 32, shmem, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// `spl` (sources per lane) and `blocks` are the wrapper's launch geometry
// (models/sfm.py: scan_geometry); the kernel is instantiated for the
// (N, spl) pairs of kernel_shapes.h's SOCIAL_MPC_SFM_SHAPES, N = 1..32.
extern "C" int social_mpc_sfm_scan_f32(
    const float* people, const float* rows, const int* n_rows, const int* indexes,
    const float* origin, const float* resolution, const unsigned char* esdf_valid,
    float* out, int B, int N, int S1, int H, int W, int window, int spl, int blocks,
    float maxtime, float dt, float lam, float gamma, float n_sfm, float n_prime,
    float f_social, float f_desired, float relax, float f_obstacle, float sigma_obstacle,
    float people_desired, float people_radius, float goal_radius, cudaStream_t stream) {
    if (B <= 0 || N <= 0) return (int)cudaGetLastError();
    SfmArgs a{people, rows, n_rows, indexes, origin, resolution, esdf_valid, out,
              B, N, S1, H, W, window, maxtime, dt, lam, gamma, n_sfm, n_prime, f_social,
              f_desired, relax, f_obstacle, sigma_obstacle, people_desired, people_radius,
              goal_radius};
#define SFM_CASE(N_, SPL_) \
    case N_ * 64 + SPL_: return launch<N_, SPL_>(a, blocks, stream);
    switch (N * 64 + spl) {
        SOCIAL_MPC_SFM_SHAPES(SFM_CASE)
        default: return (int)cudaErrorInvalidValue;
    }
#undef SFM_CASE
}
