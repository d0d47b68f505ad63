// K5: batched Frank-Wolfe GJK distance from the origin to conv(u), with a
// certified lower bound.
//
// Replaces trajopt_tpu/ops/pallas_gjk.py::_gjk_kernel (problems on the 128
// TPU lanes, vertices on sublanes, every step a sublane reduction, any m)
// and computes what its plain version, ops/geometry.py::gjk_fw_plain,
// computes: start at the first vertex of least norm; each of `iters` rounds
// takes the FW vertex s = first argmin of u.v and the away vertex a = first
// argmax of u.v over the vertices with weight > 1e-10, and keeps whichever
// of the FW and pairwise updates gives the smaller squared norm; lb =
// min(max_k min_j u_j.v_k/|v_k|, dist), dist = |v|.  No per-problem scaling
// (unlike K2).
//
// Bound on the card: at the cross-check shape [64512, 36, 3] x 32 rounds the
// work Frank-Wolfe needs is ~0.8 G operations, 9m + 60 a round (0.012 ms at
// the float32 peak), and the input 28 MB (0.009 ms at 3.35 TB/s).  What the
// kernel pays is instruction issue: a round costs each lane ~19 instructions
// a vertex slot (score, first argmin, first argmax over the support, weight
// update, its share of the next v) and ~150-180 of scalar work (v's norm,
// two line searches with IEEE divisions, lb), which every lane of a group
// repeats.  So a problem costs about 19 m + G x 170 a round, and on a full
// card the fewest lanes whose registers hold the vertices win; on a card
// that a small batch leaves idle, a round's serial chain (VPL slots long)
// sets the time, and more lanes a problem win (PERF.md).
//
// Design (the route is ops/cuda_gjk.py::fw_route(m, n)):
//  - m <= 64, "registers": a group of G lanes per problem (G = 1, 4 or 8,
//    by m and the batch; 32/G problems a warp), vertex j on lane j % G,
//    slot j / G; each lane keeps its VPL vertices and their weights in
//    registers (VPL and G are template parameters, every slot loop is
//    unrolled, so no vertex is indexed at run time).  A block stages its
//    problems, one contiguous range of floats, in shared memory with
//    coalesced loads and keeps that copy: u_s and u_a are read from it by
//    index, so no lane selects a vertex out of its registers.  A padding slot holds a copy of
//    vertex 0 with weight 0, so the slot loops test nothing.
//  - m > 64: one warp per problem, the vertices and weights walked in a
//    rolled loop: staged in shared memory for m <= 512 ("shared"), read
//    from device memory with the weights in a scratch array above
//    ("device").  Same arithmetic, same order of operations within a lane.
//  - A round: v = sum_j w_j u_j, a lane's partial sum reduced by one
//    butterfly over the group (v stays a vertex sum, at plain's rounding);
//    each lane scores its vertices, keeping its first argmin and its first
//    argmax over the support in ascending j; for G > 1 one butterfly each
//    over a 64-bit key (order-preserving bits of the score, -0 taken as +0,
//    << 32 | j) gives the group's first argmin s and first argmax a, and
//    g_max = w_a is one shuffle from a's lane (3 log2(G) + 4 log2(G) + 1
//    shuffles a round; none at G = 1; the one-warp kernel this replaces
//    issued 79).  The trial points are v + g_fw (u_s - v) and v + g_pw (u_s
//    - u_a) in closed form, which is what the reference's f_of(w_fw) and
//    f_of(w_pw) are; round 1 (w = e_i, a = i, v = u_i exactly) makes them
//    bit-equal, so it takes the FW step as the reference does.  The weight
//    update feeds the next round's partial sum.
//  - IEEE sqrtf and division (no fast math), float32 only; support
//    threshold 1e-10, the 1e-12 clamps, g_fw in [0, 1], g_pw in [0, g_max].

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kEps = 1e-12f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;              // threads a block (64 for G = 1)
constexpr int kWarps = kThreads / 32;      // problems a block for m > 64

// G = 1 holds up to 36 vertices a thread: 64-thread blocks keep a block's
// staged problems under 48 KB of shared memory
template <int G>
constexpr int kRegThreads = G == 1 ? 64 : kThreads;

// order-preserving bits of x, with -0 as +0 (they compare equal, so ties
// go to the lower index as in a float compare)
__device__ __forceinline__ unsigned order_bits(float x) {
    const unsigned b = __float_as_uint(__fadd_rn(x, 0.f));
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(unsigned b) {
    return __uint_as_float((b & 0x80000000u) ? (b & 0x7fffffffu) : ~b);
}

// key of (value, index): the smaller key has the smaller value, ties the
// lower index
__device__ __forceinline__ unsigned long long key(float x, int j) {
    return (static_cast<unsigned long long>(order_bits(x)) << 32) | static_cast<unsigned>(j);
}

template <int G>
__device__ __forceinline__ unsigned long long group_min(unsigned long long k) {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
        const unsigned long long other = __shfl_xor_sync(kFull, k, o);
        k = other < k ? other : k;
    }
    return k;
}

template <int G>
__device__ __forceinline__ void group_sum3(float& x, float& y, float& z) {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
        x += __shfl_xor_sync(kFull, x, o);
        y += __shfl_xor_sync(kFull, y, o);
        z += __shfl_xor_sync(kFull, z, o);
    }
}

// A round's weight update, as three numbers a lane applies to each of its
// vertices j: w <- w - g w, then + add_s where j = s and + add_a where j =
// a.  FW, w + g_fw (e_s - w): g = g_fw, add_s = g_fw, add_a = 0; pairwise,
// w + g_pw (e_s - e_a): g = 0 (w - 0 w is w exactly), add_s = g_pw, add_a =
// -g_pw, bit for bit the reference's (where s = a, g_pw is 0).
struct Update {
    float g, add_s, add_a;
};

// The two line searches from v, the FW vertex s and the away vertex a
// (coordinates read from U) and g_max = w_a, and the step of the smaller
// squared norm; the same in every lane of the group.
__device__ __forceinline__ Update line_searches(const float* U, int s, int a, float g_max,
                                                float vx, float vy, float vz) {
    const float sx = U[3 * s], sy = U[3 * s + 1], sz = U[3 * s + 2];
    const float ax = U[3 * a], ay = U[3 * a + 1], az = U[3 * a + 2];
    // FW step toward s
    const float dx = sx - vx, dy = sy - vy, dz = sz - vz;
    const float dd = fmaxf(dx * dx + dy * dy + dz * dz, kEps);
    const float g_fw = fminf(fmaxf(-(vx * dx + vy * dy + vz * dz) / dd, 0.f), 1.f);
    // pairwise step: mass from a to s
    const float px = sx - ax, py = sy - ay, pz = sz - az;
    const float pp = fmaxf(px * px + py * py + pz * pz, kEps);
    const float g_pw = fminf(fmaxf(-(vx * px + vy * py + vz * pz) / pp, 0.f), g_max);
    // the two trial points in closed form
    const float fx = vx + g_fw * dx, fy = vy + g_fw * dy, fz = vz + g_fw * dz;
    const float qx = vx + g_pw * px, qy = vy + g_pw * py, qz = vz + g_pw * pz;
    const bool use_pw = qx * qx + qy * qy + qz * qz < fx * fx + fy * fy + fz * fz;
    return use_pw ? Update{0.f, g_pw, -g_pw} : Update{g_fw, g_fw, 0.f};
}

__device__ __forceinline__ float new_weight(float w, int j, int s, int a, const Update& up) {
    float wn = fmaf(-up.g, w, w);
    if (j == s) wn += up.add_s;
    if (j == a) wn += up.add_a;
    return wn;
}

// m <= 64: G lanes a problem, VPL vertices a lane in registers
template <int G, int VPL>
__global__ void __launch_bounds__(kRegThreads<G>)
gjk_fw_reg_kernel(const float* __restrict__ u, float* __restrict__ dist, float* __restrict__ lb,
                  float* __restrict__ vout, int n, int m, int iters) {
    extern __shared__ float su[];          // the block's problems, [P][m][3]
    constexpr int T = kRegThreads<G>;
    constexpr int P = T / G;
    const int tid = threadIdx.x;
    const int count = P * m * 3;
    const size_t base = static_cast<size_t>(blockIdx.x) * count;
    const size_t total = static_cast<size_t>(n) * m * 3;
    const int have = static_cast<int>(min(static_cast<size_t>(count), total - base));
    for (int e = tid; e < have; e += T) su[e] = u[base + e];
    for (int e = have + tid; e < count; e += T) su[e] = 0.f;
    __syncthreads();

    const int lane = tid & (G - 1);
    const int q = tid / G;
    const int p = blockIdx.x * P + q;      // past n: zeros, computed and dropped
    const float* U = su + q * m * 3;
    const int src_base = (tid & 31) & ~(G - 1);

    // a padding slot (j >= m) holds a copy of vertex 0 with weight 0: its
    // scores tie with vertex 0's, whose lower index wins every argmin, and
    // with no weight it is never in the support nor in v
    float x[VPL], y[VPL], z[VPL], w[VPL];
#pragma unroll
    for (int t = 0; t < VPL; ++t) {
        const int j = lane + G * t < m ? lane + G * t : 0;
        x[t] = U[3 * j];
        y[t] = U[3 * j + 1];
        z[t] = U[3 * j + 2];
    }

    // start at the first vertex of least norm
    float best = INFINITY;
    int bj = lane;
#pragma unroll
    for (int t = 0; t < VPL; ++t) {
        const float n2 = x[t] * x[t] + y[t] * y[t] + z[t] * z[t];
        if (n2 < best) {
            best = n2;
            bj = lane + G * t;
        }
    }
    const int i0 = G == 1 ? bj : static_cast<int>(group_min<G>(key(best, bj)) & 0xffffffffu);
    float px = 0.f, py = 0.f, pz = 0.f;    // this lane's share of v
#pragma unroll
    for (int t = 0; t < VPL; ++t) {
        w[t] = lane + G * t == i0 ? 1.f : 0.f;
        px += w[t] * x[t];
        py += w[t] * y[t];
        pz += w[t] * z[t];
    }

    float lb_best = -INFINITY;
    for (int it = 0; it < iters; ++it) {
        float vx = px, vy = py, vz = pz;
        group_sum3<G>(vx, vy, vz);
        const float vn = sqrtf(fmaxf(vx * vx + vy * vy + vz * vz, kEps));
        float smin = INFINITY, amax = -INFINITY, wmax = 0.f;
        int jmin = lane, jmax = lane;
#pragma unroll
        for (int t = 0; t < VPL; ++t) {
            const float sc = x[t] * vx + y[t] * vy + z[t] * vz;
            if (sc < smin) {
                smin = sc;
                jmin = lane + G * t;
            }
            if (w[t] > 1e-10f && sc > amax) {
                amax = sc;
                jmax = lane + G * t;
                wmax = w[t];
            }
        }
        int s = jmin, a = jmax;
        float g_max = wmax;
        if constexpr (G > 1) {
            const unsigned long long kmin = group_min<G>(key(smin, jmin));
            const unsigned long long kmax = group_min<G>(key(-amax, jmax));
            s = static_cast<int>(kmin & 0xffffffffu);
            a = static_cast<int>(kmax & 0xffffffffu);
            smin = from_order_bits(static_cast<unsigned>(kmin >> 32));
            g_max = __shfl_sync(kFull, wmax, src_base + (a & (G - 1)));
        }
        lb_best = fmaxf(lb_best, smin / vn);
        const Update up = line_searches(U, s, a, g_max, vx, vy, vz);
        px = py = pz = 0.f;
#pragma unroll
        for (int t = 0; t < VPL; ++t) {
            w[t] = new_weight(w[t], lane + G * t, s, a, up);
            px += w[t] * x[t];
            py += w[t] * y[t];
            pz += w[t] * z[t];
        }
    }

    group_sum3<G>(px, py, pz);
    if (lane == 0 && p < n) {
        const float d = sqrtf(fmaxf(px * px + py * py + pz * pz, 0.f));
        dist[p] = d;
        lb[p] = fminf(lb_best, d);
        vout[3 * p] = px;
        vout[3 * p + 1] = py;
        vout[3 * p + 2] = pz;
    }
}

// m > 64: one warp a problem, vertices and weights walked in a rolled loop,
// in shared memory (kStage, m <= 512) or in device memory (u and scratch)
template <bool kStage>
__global__ void __launch_bounds__(kThreads)
gjk_fw_warp_kernel(const float* __restrict__ u, float* __restrict__ dist, float* __restrict__ lb,
                   float* __restrict__ vout, float* __restrict__ scratch, int n, int m, int iters) {
    extern __shared__ float sw[];          // kStage: per warp [m][3] vertices, then [m] weights
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int p = blockIdx.x * kWarps + warp;
    if (p >= n) return;                    // whole warps leave together
    const float* up = u + static_cast<size_t>(p) * m * 3;
    const float* U;
    float* W;
    if constexpr (kStage) {
        float* mine = sw + static_cast<size_t>(warp) * m * 4;
        for (int e = lane; e < 3 * m; e += 32) mine[e] = up[e];
        __syncwarp();
        U = mine;
        W = mine + 3 * m;
    } else {
        U = up;
        W = scratch + static_cast<size_t>(p) * m;
    }

    float best = INFINITY;
    int bj = lane;
    for (int j = lane; j < m; j += 32) {
        const float x = U[3 * j], y = U[3 * j + 1], z = U[3 * j + 2];
        const float n2 = x * x + y * y + z * z;
        if (n2 < best) {
            best = n2;
            bj = j;
        }
    }
    const int i0 = static_cast<int>(group_min<32>(key(best, bj)) & 0xffffffffu);
    float px = 0.f, py = 0.f, pz = 0.f;
    for (int j = lane; j < m; j += 32) {
        const float wj = j == i0 ? 1.f : 0.f;
        W[j] = wj;
        px += wj * U[3 * j];
        py += wj * U[3 * j + 1];
        pz += wj * U[3 * j + 2];
    }

    float lb_best = -INFINITY;
    for (int it = 0; it < iters; ++it) {
        float vx = px, vy = py, vz = pz;
        group_sum3<32>(vx, vy, vz);
        const float vn = sqrtf(fmaxf(vx * vx + vy * vy + vz * vz, kEps));
        float smin = INFINITY, amax = -INFINITY, wmax = 0.f;
        int jmin = lane, jmax = lane;
        for (int j = lane; j < m; j += 32) {
            const float sc = U[3 * j] * vx + U[3 * j + 1] * vy + U[3 * j + 2] * vz;
            const float wj = W[j];
            if (sc < smin) {
                smin = sc;
                jmin = j;
            }
            if (wj > 1e-10f && sc > amax) {
                amax = sc;
                jmax = j;
                wmax = wj;
            }
        }
        const unsigned long long kmin = group_min<32>(key(smin, jmin));
        const unsigned long long kmax = group_min<32>(key(-amax, jmax));
        const int s = static_cast<int>(kmin & 0xffffffffu);
        const int a = static_cast<int>(kmax & 0xffffffffu);
        lb_best = fmaxf(lb_best, from_order_bits(static_cast<unsigned>(kmin >> 32)) / vn);
        const float g_max = __shfl_sync(kFull, wmax, a & 31);
        const Update up = line_searches(U, s, a, g_max, vx, vy, vz);
        px = py = pz = 0.f;
        for (int j = lane; j < m; j += 32) {
            const float wj = new_weight(W[j], j, s, a, up);
            W[j] = wj;
            px += wj * U[3 * j];
            py += wj * U[3 * j + 1];
            pz += wj * U[3 * j + 2];
        }
    }

    group_sum3<32>(px, py, pz);
    if (lane == 0) {
        const float d = sqrtf(fmaxf(px * px + py * py + pz * pz, 0.f));
        dist[p] = d;
        lb[p] = fminf(lb_best, d);
        vout[3 * p] = px;
        vout[3 * p + 1] = py;
        vout[3 * p + 2] = pz;
    }
}

template <int G, int VPL>
bool launch_reg(int g, int vpl, const float* u, float* dist, float* lb, float* v, int n, int m,
                int iters, cudaStream_t s) {
    if (g != G || vpl != VPL) return false;
    constexpr int P = kRegThreads<G> / G;
    const int blocks = (n + P - 1) / P;
    const size_t smem = static_cast<size_t>(P) * m * 3 * sizeof(float);
    gjk_fw_reg_kernel<G, VPL><<<blocks, kRegThreads<G>, smem, s>>>(u, dist, lb, v, n, m, iters);
    return true;
}

}  // namespace

// The register tier's builds, (G, VPL): cuda_gjk.FW_VPL lists the same.
#define TRAJOPT_FW_BUILDS(X)                                                              \
    X(1, 1) X(1, 2) X(1, 3) X(1, 4) X(1, 6) X(1, 9) X(1, 12) X(1, 18) X(1, 24) X(1, 36) \
    X(2, 18)                                                                            \
    X(4, 1) X(4, 2) X(4, 3) X(4, 6) X(4, 9) X(4, 12) X(4, 16)                          \
    X(8, 1) X(8, 2) X(8, 3) X(8, 5) X(8, 8)

// tier 0 "registers" (g, vpl as fw_route gives them, or the G sweep's),
// 1 "shared", 2 "device" (scratch: n * m floats).  An unbuilt (g, vpl) or a
// tier that does not hold m returns cudaErrorInvalidValue.
extern "C" int trajopt_gjk_fw(const float* u, float* dist, float* lb, float* v, float* scratch,
                              int n, int m, int iters, int tier, int g, int vpl, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n <= 0) return static_cast<int>(cudaGetLastError());
    if (tier == 0) {
        if (g * vpl < m) return static_cast<int>(cudaErrorInvalidValue);
        bool ok = false;
#define TRAJOPT_FW_TRY(G, VPL) ok = ok || launch_reg<G, VPL>(g, vpl, u, dist, lb, v, n, m, iters, s);
        TRAJOPT_FW_BUILDS(TRAJOPT_FW_TRY)
#undef TRAJOPT_FW_TRY
        if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    } else if (tier == 1 || tier == 2) {
        const int blocks = (n + kWarps - 1) / kWarps;
        if (tier == 1) {
            const size_t smem = static_cast<size_t>(kWarps) * m * 4 * sizeof(float);
            if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
            gjk_fw_warp_kernel<true><<<blocks, kThreads, smem, s>>>(u, dist, lb, v, nullptr, n, m,
                                                                    iters);
        } else {
            gjk_fw_warp_kernel<false><<<blocks, kThreads, 0, s>>>(u, dist, lb, v, scratch, n, m,
                                                                  iters);
        }
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
