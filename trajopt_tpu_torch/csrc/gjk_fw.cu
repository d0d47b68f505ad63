// K5: batched Frank-Wolfe GJK distance from the origin to conv(u), with a
// certified lower bound.
//
// Replaces trajopt_tpu/ops/pallas_gjk.py::_gjk_kernel (problems on the 128
// TPU lanes, vertices on sublanes, every step a sublane reduction) and
// computes what its plain version, ops/geometry.py::gjk_fw_plain, computes:
// start at the first vertex of least norm; each of `iters` rounds takes the
// FW vertex s = first argmin of u.v and the away vertex a = first argmax of
// u.v over the vertices with weight > 1e-10, and keeps whichever of the FW
// and pairwise updates gives the smaller |w.u|^2; lb = min(max_k min_j
// u_j.v_k/|v_k|, dist), dist = |v|.  No per-problem scaling (unlike K2).
//
// Design: one warp per problem.  Vertex j lives on lane j % 32, at most two
// vertices a lane (m <= 64; the wrapper raises above), coordinates and
// weights in registers.  Every reduction over the vertex axis (the three
// coordinates of v, the argmin, the argmax, the two f sums) is a butterfly of
// __shfl_xor_sync, so every lane ends with the same value; argmin and argmax
// compare (value, index) pairs and break ties to the lower index, the
// reference's first_hit_onehot rule.  One thread per problem (K2's design)
// would hold 36 weights and 108 coordinates at m = 36 and spill.
//
// Bound on the card: at the cross-check shape [64512, 36, 3] x 32 rounds the
// work Frank-Wolfe needs is ~0.8 G operations, 9m + 60 a round (0.012 ms at
// the float32 peak), and the input 28 MB (0.009 ms at 3.35 TB/s).  This
// kernel also rebuilds v and both trial points as full vertex sums, and it
// is bound by the latency of its chain of 11 dependent 5-step shuffle
// reductions per round, hidden only by the warps resident on each SM.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kEps = 1e-12f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
    return x;
}

// (value, index) with the smaller value, ties to the lower index
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(kFull, v, o);
        const int oi = __shfl_xor_sync(kFull, i, o);
        if (ov < v || (ov == v && oi < i)) {
            v = ov;
            i = oi;
        }
    }
}

// (value, index) with the larger value, ties to the lower index
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(kFull, v, o);
        const int oi = __shfl_xor_sync(kFull, i, o);
        if (ov > v || (ov == v && oi < i)) {
            v = ov;
            i = oi;
        }
    }
}

// value held for vertex j (lane j % 32, register 0 for j < 32 else 1)
__device__ __forceinline__ float from_vertex(float r0, float r1, int j) {
    const float a = __shfl_sync(kFull, r0, j & 31);
    const float b = __shfl_sync(kFull, r1, j & 31);
    return j < 32 ? a : b;
}

__global__ void gjk_fw_kernel(const float* __restrict__ u,
                              float* __restrict__ dist,
                              float* __restrict__ lb,
                              float* __restrict__ vout, int n, int m,
                              int iters) {
    const int lane = threadIdx.x & 31;
    const int p = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (p >= n) return;  // whole warps leave together
    const float* up = u + static_cast<size_t>(p) * m * 3;

    const int j0 = lane, j1 = lane + 32;
    const bool ok0 = j0 < m, ok1 = j1 < m;
    float x0 = 0.f, y0 = 0.f, z0 = 0.f, x1 = 0.f, y1 = 0.f, z1 = 0.f;
    if (ok0) {
        x0 = up[3 * j0];
        y0 = up[3 * j0 + 1];
        z0 = up[3 * j0 + 2];
    }
    if (ok1) {
        x1 = up[3 * j1];
        y1 = up[3 * j1 + 1];
        z1 = up[3 * j1 + 2];
    }

    // start at the first vertex of least norm
    float nv = ok0 ? x0 * x0 + y0 * y0 + z0 * z0 : INFINITY;
    int ni = j0;
    const float nv1 = ok1 ? x1 * x1 + y1 * y1 + z1 * z1 : INFINITY;
    if (nv1 < nv) {
        nv = nv1;
        ni = j1;
    }
    warp_argmin(nv, ni);
    float w0 = (j0 == ni) ? 1.f : 0.f;
    float w1 = (j1 == ni) ? 1.f : 0.f;

    float lb_best = -INFINITY;
    for (int it = 0; it < iters; ++it) {
        const float vx = warp_sum(w0 * x0 + w1 * x1);
        const float vy = warp_sum(w0 * y0 + w1 * y1);
        const float vz = warp_sum(w0 * z0 + w1 * z1);
        const float vn = sqrtf(fmaxf(vx * vx + vy * vy + vz * vz, kEps));
        const float sc0 = x0 * vx + y0 * vy + z0 * vz;
        const float sc1 = x1 * vx + y1 * vy + z1 * vz;

        // FW vertex: first argmin of the scores
        float smin = ok0 ? sc0 : INFINITY;
        int s = j0;
        if (ok1 && sc1 < smin) {
            smin = sc1;
            s = j1;
        }
        warp_argmin(smin, s);
        lb_best = fmaxf(lb_best, smin / vn);

        // away vertex: first argmax of the scores over the support
        float amax = (ok0 && w0 > 1e-10f) ? sc0 : -INFINITY;
        int a = j0;
        const float a1 = (ok1 && w1 > 1e-10f) ? sc1 : -INFINITY;
        if (a1 > amax) {
            amax = a1;
            a = j1;
        }
        warp_argmax(amax, a);

        const float sx = from_vertex(x0, x1, s), sy = from_vertex(y0, y1, s),
                    sz = from_vertex(z0, z1, s);
        const float ax = from_vertex(x0, x1, a), ay = from_vertex(y0, y1, a),
                    az = from_vertex(z0, z1, a);
        const float g_max = from_vertex(w0, w1, a);

        // FW step toward s
        const float dx = sx - vx, dy = sy - vy, dz = sz - vz;
        const float dd = fmaxf(dx * dx + dy * dy + dz * dz, kEps);
        const float g_fw = fminf(fmaxf(-(vx * dx + vy * dy + vz * dz) / dd, 0.f), 1.f);
        // pairwise step: mass from a to s
        const float px = sx - ax, py = sy - ay, pz = sz - az;
        const float pp = fmaxf(px * px + py * py + pz * pz, kEps);
        const float g_pw = fminf(fmaxf(-(vx * px + vy * py + vz * pz) / pp, 0.f), g_max);

        const float e_s0 = (j0 == s) ? 1.f : 0.f, e_s1 = (j1 == s) ? 1.f : 0.f;
        const float e_a0 = (j0 == a) ? 1.f : 0.f, e_a1 = (j1 == a) ? 1.f : 0.f;
        const float fw0 = w0 + g_fw * (e_s0 - w0), fw1 = w1 + g_fw * (e_s1 - w1);
        const float pw0 = w0 + g_pw * (e_s0 - e_a0), pw1 = w1 + g_pw * (e_s1 - e_a1);

        const float fx = warp_sum(fw0 * x0 + fw1 * x1);
        const float fy = warp_sum(fw0 * y0 + fw1 * y1);
        const float fz = warp_sum(fw0 * z0 + fw1 * z1);
        const float qx = warp_sum(pw0 * x0 + pw1 * x1);
        const float qy = warp_sum(pw0 * y0 + pw1 * y1);
        const float qz = warp_sum(pw0 * z0 + pw1 * z1);
        const bool use_pw = qx * qx + qy * qy + qz * qz < fx * fx + fy * fy + fz * fz;
        w0 = use_pw ? pw0 : fw0;
        w1 = use_pw ? pw1 : fw1;
    }

    const float vx = warp_sum(w0 * x0 + w1 * x1);
    const float vy = warp_sum(w0 * y0 + w1 * y1);
    const float vz = warp_sum(w0 * z0 + w1 * z1);
    if (lane == 0) {
        const float d = sqrtf(fmaxf(vx * vx + vy * vy + vz * vz, 0.f));
        dist[p] = d;
        lb[p] = fminf(lb_best, d);
        vout[3 * p] = vx;
        vout[3 * p + 1] = vy;
        vout[3 * p + 2] = vz;
    }
}

}  // namespace

extern "C" int trajopt_gjk_fw(const float* u, float* dist, float* lb, float* v,
                              int n, int m, int iters, void* stream) {
    if (n > 0) {
        const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
        gjk_fw_kernel<<<blocks, 32 * kWarpsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
            u, dist, lb, v, n, m, iters);
    }
    return static_cast<int>(cudaGetLastError());
}
