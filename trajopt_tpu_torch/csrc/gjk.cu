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
// Bound on the card: arithmetic latency of one thread's dependent chain
// (~15 small solves per iteration, <= 16 iterations); the input is
// N * m * 12 bytes, read a few times from L1.  Design: one thread per
// problem, simplex, Gram matrix and best iterate in registers (all subset
// loops unroll at compile time), and the loop stops once a problem has
// converged: the reference keeps iterating on a frozen state, which
// recomputes the same values.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr float kFeasTol = 1e-6f;
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float det4(const float a[4][4]) {
#define M2(r0, r1, c0, c1) (a[r0][c0] * a[r1][c1] - a[r0][c1] * a[r1][c0])
    return M2(0, 1, 0, 1) * M2(2, 3, 2, 3) - M2(0, 1, 0, 2) * M2(2, 3, 1, 3) +
           M2(0, 1, 0, 3) * M2(2, 3, 1, 2) + M2(0, 1, 1, 2) * M2(2, 3, 0, 3) -
           M2(0, 1, 1, 3) * M2(2, 3, 0, 2) + M2(0, 1, 2, 3) * M2(2, 3, 0, 1);
#undef M2
}

// Min-norm point of conv(w[active]) (geometry._min_norm_simplex).
__device__ __forceinline__ void min_norm_simplex(const float w[4][3],
                                                 const bool active[4],
                                                 float v[3], float& n2,
                                                 bool sub[4]) {
    float g[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            g[i][j] = w[i][0] * w[j][0] + w[i][1] * w[j][1] + w[i][2] * w[j][2];

    float best_n2 = INFINITY;
    float bv[3] = {0.f, 0.f, 0.f};
    bool bsub[4] = {false, false, false, false};
#pragma unroll
    for (int s = 1; s < 16; ++s) {
        int ids[4] = {0, 0, 0, 0};
        int k = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
            if ((s >> i) & 1) ids[k++] = i;
        float xs[4] = {0.f, 0.f, 0.f, 0.f};
        float ssum;
        if (k == 1) {
            xs[0] = 1.f;
            ssum = 1.f;
        } else if (k == 2) {
            const int i = ids[0], j = ids[1];
            xs[0] = g[j][j] - g[i][j];
            xs[1] = g[i][i] - g[i][j];
            ssum = xs[0] + xs[1];
        } else if (k == 3) {
            const int i = ids[0], j = ids[1], l = ids[2];
            const float a_ = g[i][i], b_ = g[i][j], c_ = g[i][l];
            const float d_ = g[j][j], e_ = g[j][l], f_ = g[l][l];
            const float adj11 = d_ * f_ - e_ * e_;
            const float adj12 = c_ * e_ - b_ * f_;
            const float adj13 = b_ * e_ - c_ * d_;
            const float adj22 = a_ * f_ - c_ * c_;
            const float adj23 = b_ * c_ - a_ * e_;
            const float adj33 = a_ * d_ - b_ * b_;
            xs[0] = adj11 + adj12 + adj13;
            xs[1] = adj12 + adj22 + adj23;
            xs[2] = adj13 + adj23 + adj33;
            ssum = xs[0] + xs[1] + xs[2];
        } else {
#pragma unroll
            for (int col = 0; col < 4; ++col) {
                float a[4][4];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c) a[r][c] = (c == col) ? 1.f : g[r][c];
                xs[col] = det4(a);
            }
            ssum = xs[0] + xs[1] + xs[2] + xs[3];
        }
        bool feas = true;
#pragma unroll
        for (int t = 0; t < 4; ++t)
            if (t < k) feas = feas && active[ids[t]];
        const bool ok_sum = ssum > 1e-12f;
        const float inv = 1.f / (ok_sum ? ssum : 1.f);
        feas = feas && ok_sum;
        float vx = 0.f, vy = 0.f, vz = 0.f, tot = 0.f;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            if (t < k) {
                const float lam = xs[t] * inv;
                feas = feas && isfinite(lam) && lam >= -kFeasTol;
                const float lp = fmaxf(lam, 0.f);
                tot = tot + lp;
                vx = vx + lp * w[ids[t]][0];
                vy = vy + lp * w[ids[t]][1];
                vz = vz + lp * w[ids[t]][2];
            }
        }
        feas = feas && tot > 0.5f;
        const float den = fmaxf(tot, 0.5f);
        vx = vx / den;
        vy = vy / den;
        vz = vz / den;
        const float nn = vx * vx + vy * vy + vz * vz;
        const float score = feas ? nn : INFINITY;
        if (score < best_n2) {
            best_n2 = score;
            bv[0] = vx;
            bv[1] = vy;
            bv[2] = vz;
#pragma unroll
            for (int i = 0; i < 4; ++i) bsub[i] = (s >> i) & 1;
        }
    }
    v[0] = bv[0];
    v[1] = bv[1];
    v[2] = bv[2];
    n2 = best_n2;
#pragma unroll
    for (int i = 0; i < 4; ++i) sub[i] = bsub[i];
}

__global__ void gjk_exact_kernel(const float* __restrict__ u,
                                 float* __restrict__ dist,
                                 float* __restrict__ lb,
                                 float* __restrict__ vout, int n, int m,
                                 int iters) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    const float* up = u + static_cast<size_t>(p) * m * 3;

    float scale = 0.f;
    for (int j = 0; j < 3 * m; ++j) scale = fmaxf(scale, fabsf(up[j]));
    scale = fmaxf(scale, 1e-30f);

    // nearest vertex starts the simplex; us_j = u_j / scale is recomputed
    // from the input wherever it is needed (same IEEE division, same bits)
    int i0 = 0;
    float best = INFINITY;
    for (int j = 0; j < m; ++j) {
        const float x = up[3 * j] / scale, y = up[3 * j + 1] / scale,
                    z = up[3 * j + 2] / scale;
        const float nn = x * x + y * y + z * z;
        if (nn < best) {
            best = nn;
            i0 = j;
        }
    }
    float w[4][3];
    bool active[4] = {true, false, false, false};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        w[q][0] = up[3 * i0] / scale;
        w[q][1] = up[3 * i0 + 1] / scale;
        w[q][2] = up[3 * i0 + 2] / scale;
    }
    const float tol = 100.f * FLT_EPSILON;
    float lb_best = -INFINITY;
    float vb[3] = {0.f, 0.f, 0.f};
    float n2b = INFINITY;
    float v[3], n2;
    bool sub[4];

    for (int it = 0; it < iters; ++it) {
        min_norm_simplex(w, active, v, n2, sub);
        if (n2 < n2b) {
            vb[0] = v[0];
            vb[1] = v[1];
            vb[2] = v[2];
            n2b = n2;
        }
        const float vn = sqrtf(fmaxf(n2, kEps));
        float smin = INFINITY;
        int s = 0;
        for (int j = 0; j < m; ++j) {
            const float sc = (up[3 * j] / scale) * v[0] +
                             (up[3 * j + 1] / scale) * v[1] +
                             (up[3 * j + 2] / scale) * v[2];
            if (sc < smin) {
                smin = sc;
                s = j;
            }
        }
        lb_best = fmaxf(lb_best, smin / vn);
        const float sx = up[3 * s] / scale, sy = up[3 * s + 1] / scale,
                    sz = up[3 * s + 2] / scale;
        bool stale = false;
#pragma unroll
        for (int q = 0; q < 4; ++q)
            stale = stale || (active[q] && w[q][0] == sx && w[q][1] == sy && w[q][2] == sz);
        const bool full = sub[0] && sub[1] && sub[2] && sub[3];
        if (smin >= n2 - tol * fmaxf(n2, 1.f) || full || stale) break;
        int free_slot = 0;
        for (int q = 3; q >= 0; --q)
            if (!sub[q]) free_slot = q;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            active[q] = sub[q] || q == free_slot;
            if (q == free_slot) {
                w[q][0] = sx;
                w[q][1] = sy;
                w[q][2] = sz;
            }
        }
    }
    min_norm_simplex(w, active, v, n2, sub);
    if (!(n2 < n2b)) {
        v[0] = vb[0];
        v[1] = vb[1];
        v[2] = vb[2];
        n2 = n2b;
    }
    const float d = sqrtf(fmaxf(n2, 0.f)) * scale;
    dist[p] = d;
    lb[p] = fminf(lb_best * scale, d);
    vout[3 * p] = v[0] * scale;
    vout[3 * p + 1] = v[1] * scale;
    vout[3 * p + 2] = v[2] * scale;
}

}  // namespace

extern "C" int trajopt_gjk_exact(const float* u, float* dist, float* lb,
                                 float* v, int n, int m, int iters,
                                 void* stream) {
    if (n > 0) {
        const int threads = 128;
        const int blocks = (n + threads - 1) / threads;
        gjk_exact_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
            u, dist, lb, v, n, m, iters);
    }
    return static_cast<int>(cudaGetLastError());
}
