// Variant `thread_per_agent` of csrc/sfm_scan.cu, timed by tools/torch_kernel_variants.py:
// the design before the warp-synchronous scan (one thread per (scenario, agent), the
// agents exchanging state through shared memory between two barriers a step, the
// wrap by fmodf), behind the current entry point (its geometry arguments unused).

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
// Design: one thread per (scenario, agent); a block holds a few scenarios.
// The agents of a scenario meet only in the pairwise social force, so each
// thread keeps its own agent in registers and publishes position and
// velocity to shared memory once per step, between two barriers. The TPU
// kernel's packed-u16 obstacle tables and masked max-reduce replaced a
// gather that machine does badly; here the lookup is one read of the index
// grid, with the query cell clamped into the agent's window exactly as the
// table lookup clamps it (window = 0: no window, the whole grid). A block in
// which no agent is valid (every block of a people-free batch) writes its
// padding rows and leaves before the scan.
//
// The work is operations, not bytes: S * N * N pair forces of ~100
// operations with two atan2f and two expf each, against a few KB per
// scenario. atan2f, sinf, cosf, expf, sqrtf and division are the IEEE
// versions (no fast math). nvcc contracts a*b+c into FMA and the plain
// version does not, so the two agree to float32 rounding carried through S
// steps, not bit for bit; the t column (validity) is exact.

#include <cuda_runtime.h>
#include <math.h>

namespace {

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

// wrap to (-pi, pi], the reference's while-loops (sfm.hpp:252-260)
__device__ __forceinline__ float wrap_to_pi(float a) {
    return -(remainder_pos(-a + kPi, kTwoPi) - kPi);
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

// Optimizer::computeObstacle (optimizer.cpp:688-727): query minus the world
// corner of its nearest obstacle cell, and whether the query is on the grid.
__device__ __forceinline__ void lookup(const SfmArgs& a, const int* grid, float ox, float oy,
                                       float res, int start_col, int start_row, float qx,
                                       float qy, float& ex, float& ey, bool& inb) {
    const int xcell = cell_of(qx, ox, res, a.W);
    const int ycell = cell_of(qy, oy, res, a.H);
    inb = xcell >= 0 && xcell < a.W && ycell >= 0 && ycell < a.H;
    int xc = clampi(xcell, 0, a.W - 1);
    int yc = clampi(ycell, 0, a.H - 1);
    if (a.window > 0) {
        xc = start_col + clampi(xc - start_col, 0, a.window - 1);
        yc = start_row + clampi(yc - start_row, 0, a.window - 1);
    }
    const int idx = clampi(grid[(size_t)yc * a.W + xc], 0, a.H * a.W - 1);
    ex = qx - ((float)(idx % a.W) * res + ox);
    ey = qy - ((float)(idx / a.W) * res + oy);
}

__global__ void sfm_scan_kernel(const SfmArgs a) {
    extern __shared__ float sh[];
    const int N = a.N;
    const int j = threadIdx.x;
    const int ls = threadIdx.y;
    const int b = blockIdx.x * blockDim.y + ls;
    const bool live = b < a.B;
    const int per = blockDim.y * N;
    float* spx = sh + ls * N;
    float* spy = spx + per;
    float* svx = spy + per;
    float* svy = svx + per;
    float* svalid = svy + per;

    float px = 0.0f, py = 0.0f, yaw = 0.0f, lv = 0.0f, av = 0.0f;
    bool valid0 = false, esdf_ok = false;
    int n_rows = 0;
    const float* robot = nullptr;
    float* out = nullptr;
    if (live) {
        const float* p = a.people + ((size_t)b * N + j) * 6;
        out = a.out + (size_t)b * a.S1 * N * 6 + (size_t)j * 6;
        robot = a.rows + (size_t)b * a.S1 * 6;
        px = p[0]; py = p[1]; yaw = p[2]; lv = p[4]; av = p[5];
        esdf_ok = a.esdf_valid[b] != 0;
        valid0 = (p[3] != -1.0f) && esdf_ok;
        n_rows = a.n_rows[b];
#pragma unroll
        for (int c = 0; c < 6; ++c) out[c] = p[c];  // slot 0: the input verbatim
    }

    // No valid agent in this block: every later row is padding.
    if (!__syncthreads_or(valid0 ? 1 : 0)) {
        if (live) {
            for (int i = 1; i < a.S1; ++i) {
                float* o = out + (size_t)i * N * 6;
                o[0] = 0.0f; o[1] = 0.0f; o[2] = 0.0f; o[3] = -1.0f; o[4] = 0.0f; o[5] = 0.0f;
            }
        }
        return;
    }

    float vx = 0.0f, vy = 0.0f, gx = 0.0f, gy = 0.0f, oex = 0.0f, oey = 0.0f;
    float ox = 0.0f, oy = 0.0f, res = 1.0f;
    bool has_goal = valid0, ohas = false;
    int start_col = 0, start_row = 0;
    const int* grid = nullptr;
    if (live) {
        vx = lv * cosf(yaw);
        vy = lv * sinf(yaw);
        // constant-velocity-model goal (optimizer.cpp:587-591)
        gx = px + a.maxtime * vx;
        gy = py + a.maxtime * vy;
        ox = a.origin[2 * b];
        oy = a.origin[2 * b + 1];
        res = a.resolution[b];
        grid = a.indexes + (size_t)b * a.H * a.W;
        if (a.window > 0) {
            // unclamped floor of the start cell, as the window crop takes it
            const float cx = fminf(fmaxf(floorf((px - ox) / res), -1.0e9f), 1.0e9f);
            const float cy = fminf(fmaxf(floorf((py - oy) / res), -1.0e9f), 1.0e9f);
            const int half = a.window / 2;
            start_col = clampi((cx != cx ? 0 : (int)cx) - half, 0, a.W - a.window);
            start_row = clampi((cy != cy ? 0 : (int)cy) - half, 0, a.H - a.window);
        }
        bool inb;
        lookup(a, grid, ox, oy, res, start_col, start_row, px, py, oex, oey, inb);
        ohas = inb && esdf_ok;
    }
    spx[j] = px; spy[j] = py; svx[j] = vx; svy[j] = vy;
    svalid[j] = valid0 ? 1.0f : 0.0f;
    __syncthreads();

    for (int i = 0; i + 1 < a.S1; ++i) {
        const bool act = valid0 && (i < n_rows - 1);
        float npx = px, npy = py, nvx = vx, nvy = vy;
        if (valid0) {
            const float* r = robot + (size_t)i * 6;
            const float r_yaw = r[2], r_lv = r[4];

            // social force from the other people, then from the robot
            float sx = 0.0f, sy = 0.0f, fx, fy;
            for (int k = 0; k < N; ++k) {
                if (k == j || svalid[k] == 0.0f) continue;
                pair_social(a, px, py, vx, vy, spx[k], spy[k], svx[k], svy[k], fx, fy);
                sx += fx;
                sy += fy;
            }
            pair_social(a, px, py, vx, vy, r[0], r[1], r_lv * cosf(r_yaw), r_lv * sinf(r_yaw),
                        fx, fy);
            sx += fx;
            sy += fy;

            // desired force (sfm.hpp:188-203)
            const float dx = gx - px, dy = gy - py;
            const float dist = norm2(dx, dy);
            const bool pursuing = has_goal && dist > a.goal_radius;
            const float den = fmaxf(dist, kEpsDir);
            const float fdx = pursuing
                ? a.f_desired * (dx / den * a.people_desired - vx) / a.relax : -vx / a.relax;
            const float fdy = pursuing
                ? a.f_desired * (dy / den * a.people_desired - vy) / a.relax : -vy / a.relax;

            // obstacle force (sfm.hpp:205-235): minDiff = pos - stored entry
            float fox = 0.0f, foy = 0.0f;
            if (ohas) {
                const float mdx = px - oex, mdy = py - oey;
                const float odist = norm2(mdx, mdy) - a.people_radius;
                float odx, ody, on;
                safe_dir(mdx, mdy, odx, ody, on);
                const float amp = a.f_obstacle * expf(-odist / a.sigma_obstacle);
                fox = amp * odx;
                foy = amp * ody;
            }

            // updatePosition (sfm.hpp:525-573)
            nvx = vx + (fdx + sx + fox) * a.dt;
            nvy = vy + (fdy + sy + foy) * a.dt;
            const float speed = norm2(nvx, nvy);
            if (speed > a.people_desired) {
                const float sden = fmaxf(speed, kEpsDir);
                nvx = nvx / sden * a.people_desired;
                nvy = nvy / sden * a.people_desired;
            }
            npx = px + nvx * a.dt;
            npy = py + nvy * a.dt;
            if (act) {
                const float new_yaw = wrap_to_pi(atan2f(nvy, nvx));
                av = wrap_to_pi(new_yaw - yaw) / a.dt;
                yaw = new_yaw;
                lv = norm2(nvx, nvy);
                if (has_goal && norm2(gx - npx, gy - npy) <= a.goal_radius) has_goal = false;
                bool inb;
                lookup(a, grid, ox, oy, res, start_col, start_row, npx, npy, oex, oey, inb);
                ohas = inb && esdf_ok;
                px = npx; py = npy; vx = nvx; vy = nvy;
            }
        }
        __syncthreads();  // every thread has read this step's shared state
        spx[j] = px; spy[j] = py; svx[j] = vx; svy[j] = vy;
        __syncthreads();

        if (live) {
            float* o = out + (size_t)(i + 1) * N * 6;
            o[0] = act ? px : 0.0f;
            o[1] = act ? py : 0.0f;
            o[2] = act ? yaw : 0.0f;
            o[3] = act ? (float)(i + 1) * a.dt : -1.0f;
            o[4] = act ? lv : 0.0f;
            o[5] = act ? av : 0.0f;
        }
    }
}

}  // namespace

extern "C" int social_mpc_sfm_scan_f32(
    const float* people, const float* rows, const int* n_rows, const int* indexes,
    const float* origin, const float* resolution, const unsigned char* esdf_valid,
    float* out, int B, int N, int S1, int H, int W, int window, int spl, int blocks_given,
    float maxtime, float dt,
    float lam, float gamma, float n_sfm, float n_prime, float f_social, float f_desired,
    float relax, float f_obstacle, float sigma_obstacle, float people_desired,
    float people_radius, float goal_radius, cudaStream_t stream) {
    if (B <= 0 || N <= 0) return (int)cudaGetLastError();
    if (N > 1024) return (int)cudaErrorInvalidValue;
    SfmArgs a{people, rows, n_rows, indexes, origin, resolution, esdf_valid, out,
              B, N, S1, H, W, window, maxtime, dt, lam, gamma, n_sfm, n_prime, f_social,
              f_desired, relax, f_obstacle, sigma_obstacle, people_desired, people_radius,
              goal_radius};
    const int spb = N >= 64 ? 1 : 64 / N;  // scenarios per block
    const dim3 threads(N, spb);
    const int blocks = (B + spb - 1) / spb;
    const size_t shmem = (size_t)5 * spb * N * sizeof(float);
    sfm_scan_kernel<<<blocks, threads, shmem, stream>>>(a);
    return (int)cudaGetLastError();
}
