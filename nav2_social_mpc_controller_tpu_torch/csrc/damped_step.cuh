// The damped step of one Levenberg-Marquardt iteration, shared by K3
// (propose, tr_iter.cu) and K7 (spd_solve.cu): clamp diag(JtJ) to
// [min_diagonal, max_diagonal], factor the damped system
// A = JtJ + clamp(diag)/radius by Cholesky, solve A x = -g, project u + x
// onto the box [lower, upper] and evaluate the model cost change
// -<delta, g> - 0.5 <delta, JtJ delta> with the projected delta.
//
// With JAC = true the step is taken in Ceres' Jacobi column scaling, as the
// general iteration's plain composition takes it (solver/cuda_iter.py:
// damped_system, then the solve, jac_scale * step and project_step): the
// factorisation reads the scaled entry mul(jtj_ij, mul(s_i, s_j)) where it
// needs it (no second copy of JtJ), the right-hand side is -(s_i g_i), the
// step is mapped back as s_i x_i, and the projection and the model change
// use the UNSCALED JtJ and g. With JAC = false the bodies are K3's.
//
// Two layouts, measured for K3 at D = 6 and 12 (PERF.md) and kept for K7:
//
//   D <= 6 (thread): one thread per scenario in 32-thread blocks (B = 4096
//           gives all 132 SMs work), the system in registers; JtJ read as
//           float4 (a scenario's 4 D^2 bytes are 16-byte aligned at every
//           even D: 16 at D = 2, 64 at D = 4, 144 at D = 6) and the vectors as
//           float2, with scalar loads where a pointer is not aligned or D is
//           odd (K7's standalone solve).
//   D > 6 (rows): a segment of W lanes per scenario, lane i holding row i of
//           the system (read straight from device memory), so that the
//           D^2-long serial chain of one thread becomes row-parallel work;
//           the lanes exchange entries by __shfl_sync within their segment.
//           W is the smallest power of two that gives every row a lane: 8 up
//           to D = 8 (no lane idle at D = 8, 16 scenarios a 128-thread
//           block), 16 up to D = 16. The solve never reorders a sum, so the
//           bits do not depend on W.
//
// Numerics: every product, sum and difference is written with chol.cuh's
// round-to-nearest helpers, which nvcc never contracts into FMA, and
// division and sqrtf are IEEE, so the bits do not depend on how a kernel
// around these bodies is compiled. The row-parallel solve never reorders a
// sum: each entry of L, y and x sums over k in chol.cuh's serial order, and
// the sums over rows of the model change are gathered to every lane and
// added in row order. There is no pivot guard: a non-positive pivot gives
// NaN or inf, which flows into a non-finite step for commit to reject. The
// clamps use comparisons, not fminf/fmaxf, so that NaN is kept as
// torch.clamp and torch.maximum keep it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "chol.cuh"

namespace social_mpc {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int THREAD_MAX_D = 6;   // the thread layout up to this D, the rows above
constexpr int THREAD_BLOCK = 32;  // thread layout: scenarios (threads) per block
constexpr int ROWS_BLOCK = 128;   // rows layout: threads per block

// rows layout: lanes per scenario, one per row (a power of two for the
// shuffles' width), and scenarios per block
template <int D>
__host__ __device__ constexpr int rows_width() {
    static_assert(D <= 16, "the rows layout holds a row per lane of a 16-lane segment");
    return D <= 8 ? 8 : 16;
}
template <int D>
__host__ __device__ constexpr int rows_scenarios() { return ROWS_BLOCK / rows_width<D>(); }

// clamp that propagates NaN (as torch.clamp / jnp.clip do)
__device__ __forceinline__ float clamp_keep_nan(float x, float lo, float hi) {
    float y = x < lo ? lo : x;
    return y > hi ? hi : y;
}

__device__ __forceinline__ bool aligned(const void* p, uintptr_t bytes) {
    return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// The D * D floats at m (one scenario's matrix), as float4 when vec4 (and D
// is even: the scenarios of an odd D sit at no common 16-byte alignment).
template <int D>
__device__ __forceinline__ void load_matrix(const float* __restrict__ m, bool vec4,
                                            float (&out)[D][D]) {
    if constexpr ((D * D) % 4 != 0) vec4 = false;
    if (vec4) {
        const float4* m4 = reinterpret_cast<const float4*>(m);
#pragma unroll
        for (int q = 0; q < D * D / 4; ++q) {
            const float4 x = __ldg(m4 + q);
            out[(4 * q) / D][(4 * q) % D] = x.x;
            out[(4 * q + 1) / D][(4 * q + 1) % D] = x.y;
            out[(4 * q + 2) / D][(4 * q + 2) % D] = x.z;
            out[(4 * q + 3) / D][(4 * q + 3) % D] = x.w;
        }
    } else {
#pragma unroll
        for (int i = 0; i < D; ++i)
#pragma unroll
            for (int j = 0; j < D; ++j) out[i][j] = __ldg(m + i * D + j);
    }
}

// The D floats at v (one scenario's vector), as float2 when vec2 (and D is
// even).
template <int D>
__device__ __forceinline__ void load_vector(const float* __restrict__ v, bool vec2,
                                            float (&out)[D]) {
    if constexpr (D % 2 != 0) vec2 = false;
    if (vec2) {
#pragma unroll
        for (int q = 0; q < D / 2; ++q) {
            const float2 x = __ldg(reinterpret_cast<const float2*>(v) + q);
            out[2 * q] = x.x;
            out[2 * q + 1] = x.y;
        }
    } else {
#pragma unroll
        for (int i = 0; i < D; ++i) out[i] = __ldg(v + i);
    }
}

template <int D>
__device__ __forceinline__ void store_vector(float* __restrict__ v, bool vec2,
                                             const float (&in)[D]) {
    if constexpr (D % 2 != 0) vec2 = false;
    if (vec2) {
#pragma unroll
        for (int q = 0; q < D / 2; ++q)
            reinterpret_cast<float2*>(v)[q] = make_float2(in[2 * q], in[2 * q + 1]);
    } else {
#pragma unroll
        for (int i = 0; i < D; ++i) v[i] = in[i];
    }
}

// model_change = -<delta, g> - 0.5 <delta, JtJ delta> (undamped JtJ), the
// sums in row order.
template <int D>
__device__ __forceinline__ float model_change(const float (&jtj)[D][D], const float (&g)[D],
                                              const float (&delta)[D]) {
    float dg = mul(delta[0], g[0]);
#pragma unroll
    for (int i = 1; i < D; ++i) dg = add(dg, mul(delta[i], g[i]));
    float dad = 0.0f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
        float row = mul(jtj[i][0], delta[0]);
#pragma unroll
        for (int j = 1; j < D; ++j) row = add(row, mul(jtj[i][j], delta[j]));
        dad = add(dad, mul(delta[i], row));
    }
    return sub(-dg, mul(0.5f, dad));
}

struct DampedStepArgs {
    const float* u; const float* g; const float* jtj; const float* radius;
    const float* lower; const float* upper;
    const float* jac_scale;  // (B, D), read only when JAC
    float* u_new; float* delta; float* model_change;
    int B;
    float min_diagonal, max_diagonal;
};

// Thread layout: the whole step of scenario b on one thread.
template <int D, bool JAC>
__device__ __forceinline__ void damped_step_thread(const DampedStepArgs& p, int b) {
    constexpr int DD = D * D;
    const size_t o = (size_t)b * D;
    const bool vec = aligned(p.jtj, 16) && aligned(p.u, 8) && aligned(p.g, 8) &&
                     aligned(p.lower, 8) && aligned(p.upper, 8) && aligned(p.u_new, 8) &&
                     aligned(p.delta, 8) && (!JAC || aligned(p.jac_scale, 8));
    float jtj[D][D];
    float g[D], u[D], lo[D], hi[D], s[D] = {};
    load_matrix<D>(p.jtj + (size_t)b * DD, vec, jtj);
    load_vector<D>(p.g + o, vec, g);
    load_vector<D>(p.u + o, vec, u);
    load_vector<D>(p.lower + o, vec, lo);
    load_vector<D>(p.upper + o, vec, hi);
    if constexpr (JAC) load_vector<D>(p.jac_scale + o, vec, s);
    const float inv_radius = 1.0f / p.radius[b];

    // The damped (scaled) system, entry by entry where the factorisation
    // reads it, solved for the step x.
    float rhs[D];
#pragma unroll
    for (int i = 0; i < D; ++i) rhs[i] = JAC ? -mul(s[i], g[i]) : -g[i];
    float x[D];
    chol_solve<D>(
        [&](int i, int j) {
            const float e = JAC ? mul(jtj[i][j], mul(s[i], s[j])) : jtj[i][j];
            if (i != j) return e;
            return add(e, mul(clamp_keep_nan(e, p.min_diagonal, p.max_diagonal), inv_radius));
        },
        rhs, x);

    float un[D], delta[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
        const float step = JAC ? mul(s[i], x[i]) : x[i];
        un[i] = clamp_keep_nan(add(u[i], step), lo[i], hi[i]);
        delta[i] = sub(un[i], u[i]);
    }
    store_vector<D>(p.u_new + o, vec, un);
    store_vector<D>(p.delta + o, vec, delta);
    p.model_change[b] = model_change<D>(jtj, g, delta);
}

// Rows layout: where lane i of a rows_width<D>()-lane segment sits. Segment `seg`
// of the block solves scenario b; lane i holds row r. Lanes past D, and
// segments past the batch, mirror the last row / scenario so that every lane
// takes part in the shuffles; they write nothing.
struct RowsLane {
    size_t b;  // scenario
    int r;     // row
    size_t v;  // b * D + r
    bool writes;
    bool first;  // lane 0 of a writing segment: stores the scenario's scalars
};

template <int D>
__device__ __forceinline__ RowsLane rows_lane(int B) {
    constexpr int W = rows_width<D>(), SCEN = rows_scenarios<D>();
    const int b0 = blockIdx.x * SCEN;
    const int n = min(SCEN, B - b0);
    const int seg = threadIdx.x / W;
    const int i = threadIdx.x % W;
    RowsLane l;
    l.b = (size_t)b0 + min(seg, n - 1);
    l.r = min(i, D - 1);
    l.v = l.b * D + l.r;
    l.writes = seg < n && i < D;
    l.first = l.writes && i == 0;
    return l;
}

// The Cholesky solve of one system by its segment, chol.cuh's order: lane r
// gives `a(j)`, the entry at (r, j) (every lane calls it for every column
// j, so it may shuffle), and its row's right-hand side; returns x[r].
template <int D, typename Entry>
__device__ __forceinline__ float rows_chol_solve(const Entry& a, float rhs, int r) {
    constexpr int W = rows_width<D>();
    // Cholesky A = L L^T: at column j, lane r > j computes
    // L[r][j] = (a(r,j) - sum_k<j L[r][k] L[j][k]) * inv_diag[j] and lane j
    // the pivot from the same sum; L[j][k] comes from lane j by shuffle.
    float el[D];    // el[k] = L[r][k], k <= r
    float colL[D];  // colL[k] = L[k][r], k > r: column r, for the back substitution
    float inv[D];   // inv_diag[k] of every row
#pragma unroll
    for (int k = 0; k < D; ++k) el[k] = colL[k] = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
        float t = a(j);
#pragma unroll
        for (int k = 0; k < j; ++k) t = sub(t, mul(el[k], __shfl_sync(FULL_MASK, el[k], j, W)));
        float ljj = 0.0f, invj = 0.0f;
        if (r == j) {
            ljj = sqrtf(t);
            invj = 1.0f / ljj;
        }
        invj = __shfl_sync(FULL_MASK, invj, j, W);
        inv[j] = invj;
        if (r == j) el[j] = ljj;
        else if (r > j) el[j] = mul(t, invj);
#pragma unroll
        for (int k = j + 1; k < D; ++k) {
            const float lkj = __shfl_sync(FULL_MASK, el[j], k, W);
            if (r == j) colL[k] = lkj;
        }
    }

    // Forward substitution L y = rhs: y[k] = (rhs[k] - sum_m<k L[k][m] y[m]) * inv_diag[k].
    float s = rhs, y = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
        const float yk = __shfl_sync(FULL_MASK, mul(s, inv[k]), k, W);
        if (r == k) y = yk;
        if (r > k) s = sub(s, mul(el[k], yk));
    }
    // Back substitution L^T x = y, x[k] = (y[k] - sum_m>k L[m][k] x[m]) * inv_diag[k],
    // the sum in ascending m: serial, one row after the other.
    float xs[D];
    float x = 0.0f;
#pragma unroll
    for (int k = D - 1; k >= 0; --k) {
        float t = y;
#pragma unroll
        for (int m = k + 1; m < D; ++m) t = sub(t, mul(colL[m], xs[m]));
        xs[k] = __shfl_sync(FULL_MASK, mul(t, inv[k]), k, W);
        if (r == k) x = xs[k];
    }
    return x;
}

// Rows layout: the whole step, row r of scenario b on this lane.
template <int D, bool JAC>
__device__ __forceinline__ void damped_step_rows(const DampedStepArgs& p) {
    constexpr int W = rows_width<D>();
    const RowsLane l = rows_lane<D>(p.B);
    const int r = l.r;
    const float gi = __ldg(p.g + l.v), ui = __ldg(p.u + l.v), lo = __ldg(p.lower + l.v),
                hi = __ldg(p.upper + l.v);
    const float si = JAC ? __ldg(p.jac_scale + l.v) : 1.0f;
    const float inv_radius = 1.0f / p.radius[l.b];
    float row[D];  // row r of the undamped, unscaled JtJ: the segment reads its D rows as one span
#pragma unroll
    for (int j = 0; j < D; ++j) row[j] = __ldg(p.jtj + l.v * D + j);
    float ajj = row[0];
#pragma unroll
    for (int j = 1; j < D; ++j) ajj = r == j ? row[j] : ajj;
    if (JAC) ajj = mul(ajj, mul(si, si));
    const float damped = add(ajj, mul(clamp_keep_nan(ajj, p.min_diagonal, p.max_diagonal), inv_radius));

    float x = rows_chol_solve<D>(
        [&](int j) {
            if constexpr (JAC) {
                const float sj = __shfl_sync(FULL_MASK, si, j, W);  // every lane, every column
                return r == j ? damped : mul(row[j], mul(si, sj));
            } else {
                return r == j ? damped : row[j];
            }
        },
        JAC ? -mul(si, gi) : -gi, r);
    if (JAC) x = mul(si, x);

    const float un = clamp_keep_nan(add(ui, x), lo, hi);
    const float delta = sub(un, ui);
    if (l.writes) {
        p.u_new[l.v] = un;
        p.delta[l.v] = delta;
    }

    // The model change: lane r computes its row's products, the sums over
    // rows run in row order.
    float jd = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
        const float q = mul(row[j], __shfl_sync(FULL_MASK, delta, j, W));
        jd = j == 0 ? q : add(jd, q);
    }
    const float dg_r = mul(delta, gi), dad_r = mul(delta, jd);
    float dg = __shfl_sync(FULL_MASK, dg_r, 0, W), dad = 0.0f;
#pragma unroll
    for (int k = 1; k < D; ++k) dg = add(dg, __shfl_sync(FULL_MASK, dg_r, k, W));
#pragma unroll
    for (int k = 0; k < D; ++k) dad = add(dad, __shfl_sync(FULL_MASK, dad_r, k, W));
    if (l.first) p.model_change[l.b] = sub(-dg, mul(0.5f, dad));
}

// ---------------------------------------------------------------------------
// The general form: D at run time, past the templated layouts' lists
// (kernel_shapes.h: K3 / K4 / K7's damped step at every even D from 14, the
// standalone solve from 17, both up to SOCIAL_MPC_GENERAL_MAX_DIM). The
// block of one system keeps it in shared memory: the lower triangle of the
// damped system, factored in place into L (D rows of D | 1 floats, an odd
// stride, so a column's entries sit in distinct banks), and six vectors of
// D. A warp (one 32-thread block) per system up to D = 32, a row per lane;
// a block of 128 threads above, each thread owning rows r, r + 128, ....
//
// Every entry is formed in chol.cuh's order: at column j, the owner of row
// i >= j sums its entry over k < j serially (the pivot row with the same
// sum), the block meets at a barrier, and every thread takes the pivot's
// sqrtf and reciprocal itself; forward substitution is row-parallel in
// ascending k, one barrier a column; back substitution, whose sums run in
// ascending m over rows whose x is known only one after the other, is one
// thread's serial chain. The sums are unrolled by four, so that a chain's
// loads from shared memory are in flight together; no chain is reordered.
// So the bits equal chol.cuh's and the plain version's at every D, as the
// templated layouts' do.
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int general_ld(int d) { return d | 1; }
__host__ __device__ constexpr size_t general_solve_shared_bytes(int d) {
    return sizeof(float) * ((size_t)d * general_ld(d) + 6 * (size_t)d);
}
// threads of one system's block: a warp up to D = 32, 128 above
__host__ __device__ constexpr int general_threads(int d) { return d <= 32 ? 32 : 128; }

// One system's shared memory.
struct GeneralSystem {
    int D, ld;
    float* L;     // D x ld: A's lower triangle, then its factor
    float* inv;   // reciprocal diagonal of L
    float* s;     // right-hand side, then forward substitution's running sums
    float* y;     // L y = rhs
    float* x;     // L^T x = y
    float* tcol;  // a column's sums before the pivot is known
    float* w;     // the caller's own vector (the Jacobi scale)

    __device__ __forceinline__ GeneralSystem(float* shared, int d) : D(d), ld(general_ld(d)) {
        L = shared;
        inv = L + (size_t)d * ld;
        s = inv + d;
        y = s + d;
        x = y + d;
        tcol = x + d;
        w = tcol + d;
    }
};

// Solve A x = rhs by the calling block (every thread calls it). On entry the
// lower triangle of m.L holds A and m.s the right-hand side, visible to the
// whole block; on exit m.x holds the solution, visible to the whole block.
__device__ __forceinline__ void general_chol_solve(const GeneralSystem& m) {
    const int t = threadIdx.x, G = blockDim.x, D = m.D, ld = m.ld;
    for (int j = 0; j < D; ++j) {
        const float* lj = m.L + (size_t)j * ld;
        for (int i = j + t; i < D; i += G) {
            const float* li = m.L + (size_t)i * ld;
            float v = li[j];
#pragma unroll 4
            for (int k = 0; k < j; ++k) v = sub(v, mul(li[k], lj[k]));
            m.tcol[i] = v;
        }
        __syncthreads();
        const float ljj = sqrtf(m.tcol[j]);
        const float invj = 1.0f / ljj;
        for (int i = j + t; i < D; i += G) m.L[(size_t)i * ld + j] = i == j ? ljj : mul(m.tcol[i], invj);
        if (t == 0) m.inv[j] = invj;
        __syncthreads();
    }
    // Forward substitution: y[k] = s[k] * inv[k], then every later row
    // subtracts L[r][k] y[k] from its running sum.
    for (int k = 0; k < D; ++k) {
        const float yk = mul(m.s[k], m.inv[k]);
        if (t == 0) m.y[k] = yk;
        for (int r = k + 1 + t; r < D; r += G) m.s[r] = sub(m.s[r], mul(m.L[(size_t)r * ld + k], yk));
        __syncthreads();
    }
    // Back substitution, x[k] = (y[k] - sum_m>k L[m][k] x[m]) * inv[k], the
    // sum in ascending m.
    if (t == 0) {
        for (int k = D - 1; k >= 0; --k) {
            float v = m.y[k];
#pragma unroll 4
            for (int q = k + 1; q < D; ++q) v = sub(v, mul(m.L[(size_t)q * ld + k], m.x[q]));
            m.x[k] = mul(v, m.inv[k]);
        }
    }
    __syncthreads();
}

// The whole damped step of scenario blockIdx.x, D at run time, by the
// calling block (`shared`: general_solve_shared_bytes(D)).
template <bool JAC>
__device__ __forceinline__ void damped_step_general(const DampedStepArgs& p, int D,
                                                    float* shared) {
    const int b = blockIdx.x, t = threadIdx.x, G = blockDim.x;
    const GeneralSystem m(shared, D);
    const size_t o = (size_t)b * D;
    const float* jtj = p.jtj + o * D;
    const float inv_radius = 1.0f / p.radius[b];
    for (int r = t; r < D; r += G) m.w[r] = JAC ? __ldg(p.jac_scale + o + r) : 1.0f;
    __syncthreads();
    // The damped (scaled) system's lower triangle, read coalesced.
    for (int k = t; k < D * D; k += G) {
        const int i = k / D, j = k - i * D;
        if (j > i) continue;
        float e = __ldg(jtj + k);
        if (JAC) e = mul(e, mul(m.w[i], m.w[j]));
        if (i == j) e = add(e, mul(clamp_keep_nan(e, p.min_diagonal, p.max_diagonal), inv_radius));
        m.L[(size_t)i * m.ld + j] = e;
    }
    for (int r = t; r < D; r += G) {
        const float gr = __ldg(p.g + o + r);
        m.s[r] = JAC ? -mul(m.w[r], gr) : -gr;
    }
    __syncthreads();
    general_chol_solve(m);

    // Map back, project, and keep delta (in y) for the model change.
    for (int r = t; r < D; r += G) {
        const float step = JAC ? mul(m.w[r], m.x[r]) : m.x[r];
        const float ur = __ldg(p.u + o + r);
        const float un = clamp_keep_nan(add(ur, step), __ldg(p.lower + o + r),
                                        __ldg(p.upper + o + r));
        const float delta = sub(un, ur);
        p.u_new[o + r] = un;
        p.delta[o + r] = delta;
        m.y[r] = delta;
    }
    __syncthreads();
    // The model change: each row's products, then the sums over rows in
    // row order (tcol: delta_r g_r, s: delta_r (JtJ delta)_r).
    for (int r = t; r < D; r += G) {
        const float* row = jtj + (size_t)r * D;
        float jd = mul(__ldg(row), m.y[0]);
#pragma unroll 4
        for (int j = 1; j < D; ++j) jd = add(jd, mul(__ldg(row + j), m.y[j]));
        m.tcol[r] = mul(m.y[r], __ldg(p.g + o + r));
        m.s[r] = mul(m.y[r], jd);
    }
    __syncthreads();
    if (t == 0) {
        float dg = m.tcol[0], dad = 0.0f;
        for (int k = 1; k < D; ++k) dg = add(dg, m.tcol[k]);
        for (int k = 0; k < D; ++k) dad = add(dad, m.s[k]);
        p.model_change[b] = sub(-dg, mul(0.5f, dad));
    }
}

// Dynamic shared memory above the 48 KB every launch may take needs the
// kernel's opt-in (once, before any capture: a tick's eager warm-up launches
// first; a caller's standalone solve launches outside captures); the
// card's limit a block is the ceiling. Returns a cudaError_t.
template <typename Kernel>
__host__ int general_opt_in(Kernel kernel, size_t bytes, int& opted) {
    if (opted == 0) opted = 48 * 1024;
    if (bytes <= (size_t)opted) return 0;
    int dev = 0, limit = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return (int)e;
    }
    opted = limit;
    return bytes <= (size_t)opted ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace social_mpc
