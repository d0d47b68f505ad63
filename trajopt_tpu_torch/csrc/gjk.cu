// K2: batched exact-simplex GJK distance from the origin to conv(u).
//
// Replaces trajopt_tpu/ops/pallas_gjk.py::_gjk_exact_kernel (problems on the
// 128 TPU lanes, every subset solve specialised at trace time) and computes
// what its plain version, ops/geometry.py::origin_simplex_dist, computes:
// per-problem scaling by max|u|, simplex GJK with up to 4 slots whose
// distance subalgorithm solves all 15 vertex subsets in closed form
// (adjugate up to 3x3, Cramer for 4x4), the -1e-6 feasibility test, the
// tot > 0.5 degeneracy guard, the monotone best iterate, and the certified
// lower bound lb = min(lb_best, dist).
//
// Bound on the card: the input is N * m * 12 bytes and a round is ~1000
// flops, so at the solver's shapes the card could finish in well under a
// microsecond; what costs is the latency of each round's dependent chain.
// Design: one group of 16 lanes per problem, two problems a warp.
//  - The group reads its problem's vertices once; lane l owns vertices
//    j = l, l + 16, ... and keeps them, divided by max|u| (a group max), in
//    registers for m <= 64 (up to 4 a lane).  For m > 64 a lane walks its
//    vertices in device memory (L1) and divides again wherever it needs
//    one: any m works.  Both use the same IEEE division (no fast math), so
//    a scaled vertex has the same bits everywhere, as the `stale` test
//    needs.
//  - The simplex (4 slots and the active mask) is the same in every lane
//    of the group.  Lane s (1..15) solves vertex subset s; a group argmin
//    over (score, s), ties to the lowest s, picks what a serial loop with
//    a strict < picks, and the winner's point is broadcast by shuffle.
//    Lane 0 stands for "no feasible subset" (v = 0, score +inf), and a lane
//    whose subset holds an inactive slot skips its solve.
//  - Support: each lane scores its own vertices, then a group argmin over
//    (score, j), ties to the lowest j (torch.argmin's first occurrence).
//  - A converged problem stops; the reference keeps iterating on a frozen
//    state, which recomputes the same values.

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr float kFeasTol = 1e-6f;
constexpr float kEps = 1e-12f;
constexpr int kGroup = 16;               // lanes per problem
constexpr int kGroupsPerBlock = 8;       // 128 threads

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ float det4(const float a[4][4]) {
#define M2(r0, r1, c0, c1) (a[r0][c0] * a[r1][c1] - a[r0][c1] * a[r1][c0])
    return M2(0, 1, 0, 1) * M2(2, 3, 2, 3) - M2(0, 1, 0, 2) * M2(2, 3, 1, 3) +
           M2(0, 1, 0, 3) * M2(2, 3, 1, 2) + M2(0, 1, 1, 2) * M2(2, 3, 0, 3) -
           M2(0, 1, 1, 3) * M2(2, 3, 0, 2) + M2(0, 1, 2, 3) * M2(2, 3, 0, 1);
#undef M2
}

// Group argmin over (val, j): ties go to the lower j.
__device__ __forceinline__ void group_argmin(unsigned mask, float& val, int& j) {
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(mask, val, off);
        const int oj = __shfl_xor_sync(mask, j, off);
        if (ov < val || (ov == val && oj < j)) {
            val = ov;
            j = oj;
        }
    }
}

__device__ __forceinline__ void pick_slot(const float w[4][3], int id, float out[3]) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
        out[c] = id == 0 ? w[0][c] : id == 1 ? w[1][c] : id == 2 ? w[2][c] : w[3][c];
}

// Min-norm point of conv(w[active]) (geometry._min_norm_simplex), one subset
// per lane.  Every lane of the group returns the winner: v, n2 and the
// subset's slot mask.
__device__ __forceinline__ void min_norm_simplex(unsigned mask, int lane,
                                                 const float w[4][3], int active,
                                                 float v[3], float& n2, int& sub) {
    const int s = lane;                      // this lane's subset, as a slot mask
    const int k = __popc(s);
    // lane 0 (the empty subset) and every subset with an inactive slot is
    // infeasible: score +inf and v = 0, so lane 0 wins when no subset is
    // feasible, as the serial loop keeps v = 0 and n2 = +inf
    float vx = 0.f, vy = 0.f, vz = 0.f, score = INFINITY;
    if (k > 0 && (s & ~active) == 0) {
        // the subset's slots in ascending order
        const int id0 = __ffs(s) - 1;
        const int s1 = s & (s - 1);
        const int id1 = __ffs(s1) - 1;
        const int s2 = s1 & (s1 - 1);
        const int id2 = __ffs(s2) - 1;
        float a[3], b[3], c[3], d[3];
        pick_slot(w, id0, a);
        pick_slot(w, id1, b);
        pick_slot(w, id2, c);
        pick_slot(w, 3, d);
        float x0 = 1.f, x1 = 0.f, x2 = 0.f, x3 = 0.f, ssum = 1.f;
        if (k == 2) {
            const float gii = dot3(a, a), gij = dot3(a, b), gjj = dot3(b, b);
            x0 = gjj - gij;
            x1 = gii - gij;
            ssum = x0 + x1;
        } else if (k == 3) {
            const float a_ = dot3(a, a), b_ = dot3(a, b), c_ = dot3(a, c);
            const float d_ = dot3(b, b), e_ = dot3(b, c), f_ = dot3(c, c);
            const float adj11 = d_ * f_ - e_ * e_;
            const float adj12 = c_ * e_ - b_ * f_;
            const float adj13 = b_ * e_ - c_ * d_;
            const float adj22 = a_ * f_ - c_ * c_;
            const float adj23 = b_ * c_ - a_ * e_;
            const float adj33 = a_ * d_ - b_ * b_;
            x0 = adj11 + adj12 + adj13;
            x1 = adj12 + adj22 + adj23;
            x2 = adj13 + adj23 + adj33;
            ssum = x0 + x1 + x2;
        } else if (k == 4) {
            float g[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) g[i][j] = dot3(w[i], w[j]);
            float xs[4];
#pragma unroll
            for (int col = 0; col < 4; ++col) {
                float m[4][4];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int cc = 0; cc < 4; ++cc) m[r][cc] = (cc == col) ? 1.f : g[r][cc];
                xs[col] = det4(m);
            }
            x0 = xs[0];
            x1 = xs[1];
            x2 = xs[2];
            x3 = xs[3];
            ssum = x0 + x1 + x2 + x3;
        }
        const bool ok_sum = ssum > 1e-12f;
        const float inv = 1.f / (ok_sum ? ssum : 1.f);
        bool feas = ok_sum;
        float tot = 0.f;
        auto take = [&](float xt, const float pt[3]) {
            const float lam = xt * inv;
            feas = feas && isfinite(lam) && lam >= -kFeasTol;
            const float lp = fmaxf(lam, 0.f);
            tot = tot + lp;
            vx = vx + lp * pt[0];
            vy = vy + lp * pt[1];
            vz = vz + lp * pt[2];
        };
        take(x0, a);
        if (k > 1) take(x1, b);
        if (k > 2) take(x2, c);
        if (k > 3) take(x3, d);
        feas = feas && tot > 0.5f;
        const float den = fmaxf(tot, 0.5f);
        vx = vx / den;
        vy = vy / den;
        vz = vz / den;
        if (feas) score = vx * vx + vy * vy + vz * vz;
    }

    int win = s;
    group_argmin(mask, score, win);
    const int src = (threadIdx.x & kGroup) + win;
    v[0] = __shfl_sync(mask, vx, src);
    v[1] = __shfl_sync(mask, vy, src);
    v[2] = __shfl_sync(mask, vz, src);
    n2 = score;
    sub = win;
}

// VPL > 0: vertex j = lane + 16 t (t < VPL) kept scaled in registers;
// VPL == 0: any m, read from device memory and divided where needed.
template <int VPL>
__global__ void __launch_bounds__(kGroup * kGroupsPerBlock)
gjk_exact_kernel(const float* __restrict__ u, float* __restrict__ dist,
                 float* __restrict__ lb, float* __restrict__ vout, int n, int m,
                 int iters) {
    const int lane = threadIdx.x & (kGroup - 1);
    const int p = blockIdx.x * kGroupsPerBlock + threadIdx.x / kGroup;
    if (p >= n) return;                      // the whole group leaves together
    const unsigned mask = 0xFFFFu << (threadIdx.x & kGroup);
    const float* up = u + static_cast<size_t>(p) * m * 3;
    constexpr int R = VPL > 0 ? VPL : 1;

    float vx[R], vy[R], vz[R];
    float mx = 0.f;
    if constexpr (VPL > 0) {
#pragma unroll
        for (int t = 0; t < R; ++t) {
            const int j = lane + kGroup * t;
            vx[t] = j < m ? up[3 * j] : 0.f;
            vy[t] = j < m ? up[3 * j + 1] : 0.f;
            vz[t] = j < m ? up[3 * j + 2] : 0.f;
            mx = fmaxf(mx, fmaxf(fabsf(vx[t]), fmaxf(fabsf(vy[t]), fabsf(vz[t]))));
        }
    } else {
        for (int j = lane; j < m; j += kGroup)
            mx = fmaxf(mx, fmaxf(fabsf(up[3 * j]), fmaxf(fabsf(up[3 * j + 1]), fabsf(up[3 * j + 2]))));
    }
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(mask, mx, off));
    const float scale = fmaxf(mx, 1e-30f);
    if constexpr (VPL > 0) {
#pragma unroll
        for (int t = 0; t < R; ++t) {
            vx[t] = vx[t] / scale;
            vy[t] = vy[t] / scale;
            vz[t] = vz[t] / scale;
        }
    }
    // group argmin of f(vertex) over all vertices, ties to the lowest j
    // (each lane meets its own in ascending j); returns the value and the
    // winner's scaled coordinates
    auto argmin_vertex = [&](auto f, float out[3]) {
        float best = INFINITY, bx = 0.f, by = 0.f, bz = 0.f;
        int bj = INT_MAX;
        auto consider = [&](int j, float x, float y, float z) {
            const float val = f(x, y, z);
            if (bj == INT_MAX || val < best) {
                best = val;
                bj = j;
                bx = x;
                by = y;
                bz = z;
            }
        };
        if constexpr (VPL > 0) {
#pragma unroll
            for (int t = 0; t < VPL; ++t) {
                const int j = lane + kGroup * t;
                if (j < m) consider(j, vx[t], vy[t], vz[t]);
            }
        } else {
            for (int j = lane; j < m; j += kGroup)
                consider(j, up[3 * j] / scale, up[3 * j + 1] / scale, up[3 * j + 2] / scale);
        }
        group_argmin(mask, best, bj);
        const int src = (threadIdx.x & kGroup) + (bj & (kGroup - 1));
        out[0] = __shfl_sync(mask, bx, src);
        out[1] = __shfl_sync(mask, by, src);
        out[2] = __shfl_sync(mask, bz, src);
        return best;
    };

    // nearest vertex starts the simplex
    float w0[3];
    argmin_vertex([](float x, float y, float z) { return x * x + y * y + z * z; }, w0);
    float w[4][3];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < 3; ++c) w[q][c] = w0[c];
    int active = 1;
    const float tol = 100.f * FLT_EPSILON;
    float lb_best = -INFINITY;
    float vb[3] = {0.f, 0.f, 0.f};
    float n2b = INFINITY;
    float v[3], n2;
    int sub;

    for (int it = 0; it < iters; ++it) {
        min_norm_simplex(mask, lane, w, active, v, n2, sub);
        if (n2 < n2b) {
            vb[0] = v[0];
            vb[1] = v[1];
            vb[2] = v[2];
            n2b = n2;
        }
        const float vn = sqrtf(fmaxf(n2, kEps));
        float ws[3];
        const float smin = argmin_vertex(
            [&](float x, float y, float z) { return x * v[0] + y * v[1] + z * v[2]; }, ws);
        lb_best = fmaxf(lb_best, smin / vn);
        bool stale = false;
#pragma unroll
        for (int q = 0; q < 4; ++q)
            stale = stale || (((active >> q) & 1) && w[q][0] == ws[0] && w[q][1] == ws[1] &&
                              w[q][2] == ws[2]);
        if (smin >= n2 - tol * fmaxf(n2, 1.f) || sub == 15 || stale) break;
        const int free_slot = __ffs(~sub & 15) - 1;        // first slot outside the subset
        active = sub | (1 << free_slot);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            if (q == free_slot) {
                w[q][0] = ws[0];
                w[q][1] = ws[1];
                w[q][2] = ws[2];
            }
        }
    }
    min_norm_simplex(mask, lane, w, active, v, n2, sub);
    if (!(n2 < n2b)) {
        v[0] = vb[0];
        v[1] = vb[1];
        v[2] = vb[2];
        n2 = n2b;
    }
    if (lane == 0) {
        const float d = sqrtf(fmaxf(n2, 0.f)) * scale;
        dist[p] = d;
        lb[p] = fminf(lb_best * scale, d);
        vout[3 * p] = v[0] * scale;
        vout[3 * p + 1] = v[1] * scale;
        vout[3 * p + 2] = v[2] * scale;
    }
}

}  // namespace

extern "C" int trajopt_gjk_exact(const float* u, float* dist, float* lb,
                                 float* v, int n, int m, int iters,
                                 void* stream) {
    if (n > 0) {
        const int blocks = (n + kGroupsPerBlock - 1) / kGroupsPerBlock;
        const int threads = kGroup * kGroupsPerBlock;
        cudaStream_t s = static_cast<cudaStream_t>(stream);
        if (m <= 16)
            gjk_exact_kernel<1><<<blocks, threads, 0, s>>>(u, dist, lb, v, n, m, iters);
        else if (m <= 32)
            gjk_exact_kernel<2><<<blocks, threads, 0, s>>>(u, dist, lb, v, n, m, iters);
        else if (m <= 64)
            gjk_exact_kernel<4><<<blocks, threads, 0, s>>>(u, dist, lb, v, n, m, iters);
        else
            gjk_exact_kernel<0><<<blocks, threads, 0, s>>>(u, dist, lb, v, n, m, iters);
    }
    return static_cast<int>(cudaGetLastError());
}
