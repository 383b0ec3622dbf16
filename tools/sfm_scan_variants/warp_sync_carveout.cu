// Variant `warp_sync_carveout` of csrc/sfm_scan.cu, timed by tools/torch_kernel_variants.py:
// `warp_sync` requesting the largest shared-memory carveout (cudaFuncAttributePreferredSharedMemoryCarveout) at every launch
// (a test of whether the default carveout caps the blocks resident on an SM).

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
// What bounds it: the chain of S dependent steps, and the instructions
// issued along it, not bytes (a few KB per scenario). A step of an agent is
// N pair forces of ~190 instructions each (two atan2f, two expf, two
// normalisations with IEEE divisions), then the update (its own atan2f, two
// angle wraps, more divisions) and the nearest-obstacle lookup, a dependent
// load from an index grid that does not fit in L2.
//
// Design: the agents of a scenario live in one warp, several scenarios a
// warp, and a step's pair forces run on parallel lanes. An agent owns
// LPA = ceil(N / SPL) lanes; its lane t computes the forces on it from
// sources t*SPL .. t*SPL + SPL - 1 of its list (the other agents in
// ascending order, then the robot), so a step's chain holds SPL pair forces,
// not N. Every lane of the agent then gathers the N forces by shuffles and
// adds them in the list's order, which is the serial loop's order (a skipped
// source adds +0, which changes no sum that starts at +0). All of the
// agent's lanes run the same update, so each holds the agent's state and the
// next step needs no broadcast; the sources' states come by shuffles from
// their agents' lanes. The robot's positions and velocities are staged in
// shared memory once, before the scan, by the whole warp. The warp's
// shuffles are its only synchronisation: no barrier on the step. The lookup
// after a step's update feeds the obstacle force of the NEXT step, so its
// load overlaps that step's pair forces. The launch geometry (SPL, and the
// scenarios per warp that follow from it) is chosen by the wrapper
// (models/sfm.py: scan_geometry) and held here against N.
//
// The lookup is one read of the index grid, with the query cell clamped into
// the agent's window exactly as the JAX package's table lookup clamps it
// (window = 0: no window, the whole grid); the TPU kernel's packed-u16
// obstacle tables and masked max-reduce replaced a gather that machine does
// badly. A warp in which no agent is valid (every warp of a people-free
// batch) writes its padding rows and leaves before the scan.
//
// atan2f, sinf, cosf, expf, sqrtf and division are the IEEE versions (no
// fast math). nvcc contracts a*b+c into FMA and the plain version does not,
// so the two agree to float32 rounding carried through S steps, not bit for
// bit; the t column (validity) is exact.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int WARPS = 4;  // warps per block
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

// One agent along the scan.
struct Agent {
    float px, py, vx, vy, yaw, lv, av;
    float gx, gy;    // constant-velocity-model goal (optimizer.cpp:587-591)
    float oex, oey;  // stored nearest-obstacle entry
    bool has_goal, ohas;
};

// One active step of an agent on which the social force (sx, sy) acts: the
// desired and obstacle forces, updatePosition (sfm.hpp:525-573), the new
// yaw, angular velocity and goal state, and the nearest obstacle at the new
// position (optimizer.cpp:641-645).
__device__ __forceinline__ void agent_step(const SfmArgs& a, const Esdf& e, float sx, float sy,
                                           Agent& g) {
    // desired force (sfm.hpp:188-203)
    const float dx = g.gx - g.px, dy = g.gy - g.py;
    const float dist = norm2(dx, dy);
    const bool pursuing = g.has_goal && dist > a.goal_radius;
    const float den = fmaxf(dist, kEpsDir);
    const float fdx = pursuing
        ? a.f_desired * (dx / den * a.people_desired - g.vx) / a.relax : -g.vx / a.relax;
    const float fdy = pursuing
        ? a.f_desired * (dy / den * a.people_desired - g.vy) / a.relax : -g.vy / a.relax;

    // obstacle force (sfm.hpp:205-235): minDiff = pos - stored entry
    float fox = 0.0f, foy = 0.0f;
    if (g.ohas) {
        const float mdx = g.px - g.oex, mdy = g.py - g.oey;
        const float odist = norm2(mdx, mdy) - a.people_radius;
        float odx, ody, on;
        safe_dir(mdx, mdy, odx, ody, on);
        const float amp = a.f_obstacle * expf(-odist / a.sigma_obstacle);
        fox = amp * odx;
        foy = amp * ody;
    }

    float nvx = g.vx + (fdx + sx + fox) * a.dt;
    float nvy = g.vy + (fdy + sy + foy) * a.dt;
    const float speed = norm2(nvx, nvy);
    if (speed > a.people_desired) {
        const float sden = fmaxf(speed, kEpsDir);
        nvx = nvx / sden * a.people_desired;
        nvy = nvy / sden * a.people_desired;
    }
    const float npx = g.px + nvx * a.dt;
    const float npy = g.py + nvy * a.dt;
    const float new_yaw = wrap_to_pi(atan2f(nvy, nvx));
    g.av = wrap_to_pi(new_yaw - g.yaw) / a.dt;
    g.yaw = new_yaw;
    g.lv = norm2(nvx, nvy);
    if (g.has_goal && norm2(g.gx - npx, g.gy - npy) <= a.goal_radius) g.has_goal = false;
    bool inb;
    lookup(a, e, npx, npy, g.oex, g.oey, inb);
    g.ohas = inb && e.ok;
    g.px = npx;
    g.py = npy;
    g.vx = nvx;
    g.vy = nvy;
}

template <int N, int SPL>
struct Geometry {
    static constexpr int LPA = (N + SPL - 1) / SPL;  // lanes per agent
    static constexpr int LPS = N * LPA;              // lanes per scenario
    static constexpr int SPW = 32 / LPS;             // scenarios per warp
};

template <int N, int SPL>
__global__ void __launch_bounds__(WARPS * 32) sfm_scan_kernel(const SfmArgs a) {
    constexpr int LPA = Geometry<N, SPL>::LPA;
    constexpr int LPS = Geometry<N, SPL>::LPS;
    constexpr int SPW = Geometry<N, SPL>::SPW;
    extern __shared__ float4 robot_sh[];  // per warp: SPW x steps robot (x, y, vx, vy)
    const int lane = threadIdx.x & 31;
    const int b0 = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * SPW;
    if (b0 >= a.B) return;  // uniform across the warp
    const int steps = a.S1 - 1;
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
    const bool esdf_ok = a.esdf_valid[b] != 0;
    const bool valid0 = live && p[3] != -1.0f && esdf_ok;
    const int n_rows = a.n_rows[b];
    const bool writer = live && t == 0;
    float* out = a.out + (size_t)b * a.S1 * N * 6 + (size_t)j * 6;
    if (writer) {
#pragma unroll
        for (int c = 0; c < 6; ++c) out[c] = p[c];  // slot 0: the input verbatim
    }

    // No valid agent in this warp: every later row is padding.
    if (!__any_sync(FULL_MASK, valid0)) {
        if (writer) {
            for (int i = 1; i < a.S1; ++i) {
                float* o = out + (size_t)i * N * 6;
                o[0] = 0.0f; o[1] = 0.0f; o[2] = 0.0f; o[3] = -1.0f; o[4] = 0.0f; o[5] = 0.0f;
            }
        }
        return;
    }

    // The robot's position and velocity at every step of the warp's
    // scenarios, staged once.
    float4* robot = robot_sh + (size_t)(threadIdx.x >> 5) * SPW * steps;
    for (int q = lane; q < SPW * steps; q += 32) {
        const int sq = q / steps;
        const int i = q - sq * steps;
        const float* rr = a.rows + ((size_t)min(b0 + sq, a.B - 1) * a.S1 + i) * 6;
        const float r_yaw = rr[2], r_lv = rr[4];
        robot[q] = make_float4(rr[0], rr[1], r_lv * cosf(r_yaw), r_lv * sinf(r_yaw));
    }
    __syncwarp();
    const float4* my_robot = robot + slot * steps;

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

    // This lane's sources: source m of agent j is agent m (m < j), agent
    // m + 1 (j <= m < N - 1) or the robot (m = N - 1); a force counts when
    // its source is the robot or a valid agent.
    int src[SPL];
    bool is_robot[SPL], use[SPL];
#pragma unroll
    for (int q = 0; q < SPL; ++q) {
        const int m = t * SPL + q;
        const bool is_agent = m < N - 1;
        src[q] = is_agent ? base + (m < j ? m : m + 1) * LPA : lane;
        is_robot[q] = m == N - 1;
        const bool k_valid = __shfl_sync(FULL_MASK, (int)valid0, src[q]) != 0;
        use[q] = is_robot[q] || (is_agent && k_valid);
    }

    for (int i = 0; i < steps; ++i) {
        const float4 rb = my_robot[i];
        float fx[SPL], fy[SPL];
#pragma unroll
        for (int q = 0; q < SPL; ++q) {
            const float kx = __shfl_sync(FULL_MASK, g.px, src[q]);
            const float ky = __shfl_sync(FULL_MASK, g.py, src[q]);
            const float kvx = __shfl_sync(FULL_MASK, g.vx, src[q]);
            const float kvy = __shfl_sync(FULL_MASK, g.vy, src[q]);
            float f_x, f_y;
            pair_social(a, g.px, g.py, g.vx, g.vy, is_robot[q] ? rb.x : kx,
                        is_robot[q] ? rb.y : ky, is_robot[q] ? rb.z : kvx,
                        is_robot[q] ? rb.w : kvy, f_x, f_y);
            fx[q] = use[q] ? f_x : 0.0f;
            fy[q] = use[q] ? f_y : 0.0f;
        }
        // the social force on the agent: its N sources in the list's order
        float sx = 0.0f, sy = 0.0f;
#pragma unroll
        for (int m = 0; m < N; ++m) {
            const int from = base + j * LPA + m / SPL;
            sx += __shfl_sync(FULL_MASK, fx[m % SPL], from);
            sy += __shfl_sync(FULL_MASK, fy[m % SPL], from);
        }
        const bool act = valid0 && (i < n_rows - 1);
        if (act) agent_step(a, e, sx, sy, g);

        if (writer) {
            float* o = out + (size_t)(i + 1) * N * 6;
            o[0] = act ? g.px : 0.0f;
            o[1] = act ? g.py : 0.0f;
            o[2] = act ? g.yaw : 0.0f;
            o[3] = act ? (float)(i + 1) * a.dt : -1.0f;
            o[4] = act ? g.lv : 0.0f;
            o[5] = act ? g.av : 0.0f;
        }
    }
}

template <int N, int SPL>
int launch(const SfmArgs& a, int blocks, cudaStream_t stream) {
    constexpr int SPW = Geometry<N, SPL>::SPW;
    static_assert(SPW >= 1, "a scenario must fit in one warp");
    blocks = (a.B + WARPS * SPW - 1) / (WARPS * SPW);  // its own geometry
    const size_t shmem = (size_t)WARPS * SPW * (a.S1 > 1 ? a.S1 - 1 : 0) * sizeof(float4);
    if (shmem > 48 * 1024) return (int)cudaErrorInvalidValue;
    cudaFuncSetAttribute(sfm_scan_kernel<N, SPL>, cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)cudaSharedmemCarveoutMaxShared);
    sfm_scan_kernel<N, SPL><<<blocks, WARPS * 32, shmem, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// `spl` (sources per lane) and `blocks` are the wrapper's launch geometry
// (models/sfm.py: scan_geometry); the kernel is instantiated for the
// (N, spl) pairs it gives at N = 1..8.
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
    switch (N * 64 + spl) {
        case 1 * 64 + 1: return launch<1, 1>(a, blocks, stream);
        case 2 * 64 + 1: return launch<2, 1>(a, blocks, stream);
        case 3 * 64 + 1: return launch<3, 1>(a, blocks, stream);
        case 4 * 64 + 1: return launch<4, 1>(a, blocks, stream);
        case 5 * 64 + 1: return launch<5, 1>(a, blocks, stream);
        case 6 * 64 + 2: return launch<6, 2>(a, blocks, stream);
        case 7 * 64 + 2: return launch<7, 2>(a, blocks, stream);
        case 8 * 64 + 2: return launch<8, 2>(a, blocks, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
