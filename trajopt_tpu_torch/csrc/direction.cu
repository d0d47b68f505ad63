// dir_grad_hess, dir_assemble, dir_schur and dir_finish: the glue of the
// single-UAV step's direction phase (solver/admm.py::spline_direction), in
// four launches around K3, K3+K4 and K4 (csrc/chol.cu), which stay launches
// of their own:
//
//   dir_grad_hess  per-piece gradient g [P,19] and Hessian h [P,19,19]
//   mod_chol       K3's GMW shift e [P,19] of each h           (chol.cu)
//   dir_assemble   h + diag(e) scattered into the reduced system: a, its
//                  ridged copy, the right-hand sides [gs b], gt and htt
//   factor_solve   K3+K4 on the ridged a: its factor, A^-1 gs and A^-1 b
//   dir_schur      the Schur scalars, gnorm, the Newton step and the
//                  refinement residual r_s = a ds + b dt + gs, r_t
//   chol_solve     K4: A^-1 r_s                                  (chol.cu)
//   dir_finish     the Schur correction, wolfe, the steepest-descent
//                  fallback and the spread into the [T,3] direction
//
// These kernels replace no TPU kernel.  They fuse what the JAX package leaves
// to XLA around its Pallas K3 and K4: trajopt_tpu/solver/admm.py:271
// (`spline_direction`), trajopt_tpu/ops/gradients.py:167
// (`analytic_spline_gh`) and trajopt_tpu/ops/kkt.py:151-185 (the reduced
// system and its Schur complement).  In PyTorch the same code is some
// hundreds of small kernels an iteration.  Their plain versions are the
// slices of that code in ops/cuda_direction.py.
//
// Bound on the card: latency.  The data is a few kilobytes (four to seven
// 19 x 19 blocks, one reduced system of at most 64 x 64, a [T,3] direction)
// and the arithmetic a few hundred thousand operations, so what counts is
// the number of launches and the length of each one's dependent chain.
// dir_grad_hess takes one block a piece (the pieces are independent until
// the reduced system couples them): a thread an entry of the 19 x 19 block
// or of the gradient, the sums over subdivisions, planes and bound terms
// looped in registers from a few KB of shared memory.  The plane axis is
// contracted first (e2 c c^T summed over the planes), as the plain code
// does.  The three kernels on the reduced system are one block of 64
// threads, a thread a reduced coordinate, with warp-shuffle sums.
//
// Why K3, K3+K4 and K4 stay launches of their own: the benchmark finds each
// kernel's executions in a trace by its name (mod_chol_kernel,
// factor_solve_kernel, chol_solve_kernel) and reads its share of its
// roofline from them.  In a single-UAV solve the direction phase is the only
// caller of the three, so folding them into these kernels would leave those
// shares with nothing to read.  No kernel here has a name that contains
// theirs.
//
// Rounding: the elementwise terms are evaluated in the plain code's order
// with __fadd_rn, __fmul_rn and __fdiv_rn (so the compiler fuses none of
// them into a multiply-add), and only the sums take another order.  The
// torch.maximum and torch.clamp of the plain code propagate NaN, and so do
// their stand-ins here.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kN = 6;                       // control points a piece
constexpr int kCp = 3 * kN;                 // their coordinates
constexpr int kLoc = kCp + 1;               // and the piece time
constexpr int kVel = kN - 1;                // velocity control points a segment
constexpr int kAcc = kN - 2;                // acceleration control points
constexpr int kGhThreads = 384;             // 361 Hessian entries, 19 gradient entries
constexpr int kRed = 64;                    // threads of the reduced-system kernels
constexpr int kMaxNs = kRed;                // the reduced system they take
constexpr int kMaxShare = 8;                // pieces that may share a stored row
constexpr int kPair = 9;                    // floats a bound term keeps (`bound_pair`)

struct GhParams {
    int res, planes;
    float lam, mu, margin, vel_limit, acc_limit;
};

// torch.maximum and torch.clamp(min=): NaN in, NaN out
__device__ __forceinline__ float nan_max(float a, float b) {
    return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float nan_clamp_min(float a, float lo) {
    return a != a ? a : fmaxf(a, lo);
}

// gradients._barrier_d12: (b'(d), b''(d)) of the barrier, zero outside act
__device__ __forceinline__ void barrier_d12(float d, float margin, bool act, float& b1,
                                            float& b2) {
    const float ds = act ? d : margin;
    const float ln = logf(__fdiv_rn(ds, margin));
    const float dm = __fsub_rn(ds, margin);
    const float dm2 = __fmul_rn(dm, dm);
    const float v1 = __fsub_rn(__fmul_rn(__fmul_rn(-2.f, dm), ln), __fdiv_rn(dm2, ds));
    const float v2 = __fadd_rn(__fsub_rn(__fmul_rn(-2.f, ln), __fdiv_rn(__fmul_rn(4.f, dm), ds)),
                               __fdiv_rn(dm2, __fmul_rn(ds, ds)));
    b1 = act ? v1 : 0.f;
    b2 = act ? v2 : 0.f;
}

// One velocity or acceleration term of `analytic_spline_gh.bound_terms`: the
// segment's control point a of basis ``lb`` [6] and scale s (1 / (w t) or
// 1 / (w^2 t^2)); f and g_tt are 1 and 2 for a velocity, 2 and 6 for an
// acceleration.  ``out``: the gradient's coefficient -e1 s, the Hessian's
// cA, cB and cT, the unit vector u, and the term's parts of g_t and h_tt.
__device__ void bound_pair(const float* lb, const float* cp, float s, float f, float g_tt,
                           float limit, float t, float lw, float margin, float* out) {
    float v[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < kN; ++i) acc = fmaf(lb[i], cp[3 * i + d], acc);
        v[d] = acc;
    }
    const float vn_raw = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(v[0], v[0]), __fmul_rn(v[1], v[1])),
                                         __fmul_rn(v[2], v[2])));
    const float dv_raw = __fsub_rn(limit, __fmul_rn(vn_raw, s));
    const bool act = dv_raw > 0.f && dv_raw < margin;
    const float vn = act ? nan_clamp_min(vn_raw, 1e-30f) : 1.f;
    const float dv = __fsub_rn(limit, __fmul_rn(vn, s));
    float b1, b2;
    barrier_d12(dv, margin, act, b1, b2);
    const float e1 = __fmul_rn(lw, b1), e2 = __fmul_rn(lw, b2);
    out[0] = __fmul_rn(-e1, s);
    out[1] = __fadd_rn(__fmul_rn(__fmul_rn(e2, s), s), __fdiv_rn(__fmul_rn(e1, s), vn));
    out[2] = __fdiv_rn(__fmul_rn(-e1, s), vn);
    out[3] = __fdiv_rn(__fadd_rn(__fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(-e2, f), vn), s), s),
                                 __fmul_rn(__fmul_rn(e1, f), s)),
                       t);
#pragma unroll
    for (int d = 0; d < 3; ++d) out[4 + d] = __fdiv_rn(v[d], vn);
    out[7] = __fdiv_rn(__fmul_rn(__fmul_rn(__fmul_rn(e1, f), vn), s), t);
    const float q = __fdiv_rn(__fmul_rn(__fmul_rn(f, vn), s), t);
    out[8] = __fsub_rn(__fmul_rn(e2, __fmul_rn(q, q)),
                       __fdiv_rn(__fmul_rn(__fmul_rn(__fmul_rn(e1, g_tt), vn), s),
                                 __fmul_rn(t, t)));
}

// The bound terms' part of H_cp[(i,d),(q,e)]: sum cA (b_i u_d)(b_q u_e),
// plus sum cB b_i b_q where d == e.
__device__ __forceinline__ float bound_hess(const float* pairs, const float* basis, int n, int i,
                                            int d, int q, int e) {
    float sa = 0.f, sb = 0.f;
    for (int k = 0; k < n; ++k) {
        const float* o = pairs + k * kPair;
        const float* b = basis + k * kN;
        sa = fmaf(o[1], __fmul_rn(__fmul_rn(b[i], o[4 + d]), __fmul_rn(b[q], o[4 + e])), sa);
        sb = fmaf(o[2], __fmul_rn(b[i], b[q]), sb);
    }
    return __fadd_rn(sa, d == e ? sb : 0.f);
}

// sum over the terms of coef(o) u_d b_i (coef: o[0] for the gradient, o[3]
// for H_ct)
__device__ __forceinline__ float bound_vec(const float* pairs, const float* basis, int n, int i,
                                           int d, int coef) {
    float s = 0.f;
    for (int k = 0; k < n; ++k) {
        const float* o = pairs + k * kPair;
        s = fmaf(__fmul_rn(o[coef], o[4 + d]), basis[k * kN + i], s);
    }
    return s;
}

__device__ __forceinline__ float bound_sum(const float* pairs, int n, int slot) {
    float s = 0.f;
    for (int k = 0; k < n; ++k) s = __fadd_rn(s, pairs[k * kPair + slot]);
    return s;
}

// One block a piece (blockIdx.x).
__global__ void __launch_bounds__(kGhThreads)
dir_grad_hess_kernel(const float* __restrict__ spline, const long long* __restrict__ piece_idx,
                     const float* __restrict__ seg_basis, const float* __restrict__ seg_weight,
                     const float* __restrict__ convert, const float* __restrict__ plane_c,
                     const float* __restrict__ plane_d, const unsigned char* __restrict__ plane_mask,
                     const float* __restrict__ piece_time, const float* __restrict__ p_slack,
                     const float* __restrict__ t_slack, const float* __restrict__ p_lambda,
                     const float* __restrict__ t_lambda, float* __restrict__ g_out,
                     float* __restrict__ h_out, GhParams prm) {
    extern __shared__ __align__(16) float sm[];
    const int p = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
    const int R = prm.res, K = prm.planes;
    float* cp = sm;                          // [6,3] the piece's stored rows
    float* conv = cp + kCp;                  // [6,6]
    float* w = conv + kN * kN;               // [R]
    float* B = w + R;                        // [R,6,6] subdivision bases
    float* vb = B + R * kN * kN;             // [R,5,6] velocity bases
    float* ab = vb + R * kVel * kN;          // [R,4,6] acceleration bases
    float* hull = ab + R * kAcc * kN;        // [R,6,3]
    float* ec = hull + R * kCp;              // [R,6,3]  sum_k e1 c
    float* ecc = ec + R * kCp;               // [R,6,3,3] sum_k e2 c c^T
    float* vpair = ecc + R * kN * 9;         // [R*5, kPair]
    float* apair = vpair + R * kVel * kPair; // [R*4, kPair]

    const float t = piece_time[0];
    const long long* idx = piece_idx + static_cast<size_t>(p) * kN;
    for (int k = tid; k < kCp; k += nt) cp[k] = spline[idx[k / 3] * 3 + k % 3];
    for (int k = tid; k < kN * kN; k += nt) conv[k] = convert[static_cast<size_t>(p) * kN * kN + k];
    for (int k = tid; k < R; k += nt) w[k] = seg_weight[k];
    for (int k = tid; k < R * kN * kN; k += nt) B[k] = seg_basis[static_cast<size_t>(p) * R * kN * kN + k];
    __syncthreads();
    for (int k = tid; k < R * kVel * kN; k += nt) {
        const int r = k / (kVel * kN), a = (k / kN) % kVel, i = k % kN;
        const float* br = B + r * kN * kN;
        vb[k] = __fmul_rn(static_cast<float>(kN - 1), __fsub_rn(br[(a + 1) * kN + i], br[a * kN + i]));
    }
    for (int k = tid; k < R * kCp; k += nt) {
        const int r = k / kCp, j = (k / 3) % kN, d = k % 3;
        const float* row = B + (r * kN + j) * kN;
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < kN; ++i) s = fmaf(row[i], cp[3 * i + d], s);
        hull[k] = s;
    }
    __syncthreads();
    for (int k = tid; k < R * kAcc * kN; k += nt) {
        const int r = k / (kAcc * kN), a = (k / kN) % kAcc, i = k % kN;
        const float* vr = vb + r * kVel * kN;
        ab[k] = __fmul_rn(static_cast<float>(kN - 2), __fsub_rn(vr[(a + 1) * kN + i], vr[a * kN + i]));
    }
    __syncthreads();

    // the plane terms, contracted over the planes, one (subdivision, control
    // point) a thread; then the bound terms, one (subdivision, point) a thread
    const int n_plane = R * kN, n_vel = R * kVel, n_acc = R * kAcc;
    for (int item = tid; item < n_plane + n_vel + n_acc; item += nt) {
        if (item < n_plane) {
            const int r = item / kN;
            const float* hj = hull + item * 3;
            const float lw = __fmul_rn(prm.lam, w[r]);
            float e[3] = {0.f, 0.f, 0.f}, cc[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
            for (int k = 0; k < K; ++k) {
                const size_t q = (static_cast<size_t>(p) * R + r) * K + k;
                const float c[3] = {plane_c[3 * q], plane_c[3 * q + 1], plane_c[3 * q + 2]};
                const float dist = __fadd_rn(fmaf(hj[2], c[2], fmaf(hj[1], c[1], __fmul_rn(hj[0], c[0]))),
                                             plane_d[q]);
                if (!(plane_mask[q] && dist > 0.f && dist < prm.margin)) continue;   // adds 0
                float b1, b2;
                barrier_d12(dist, prm.margin, true, b1, b2);
                const float e1 = __fmul_rn(lw, b1), e2 = __fmul_rn(lw, b2);
#pragma unroll
                for (int d = 0; d < 3; ++d) {
                    e[d] = fmaf(e1, c[d], e[d]);
#pragma unroll
                    for (int f = 0; f < 3; ++f) cc[3 * d + f] = fmaf(e2, __fmul_rn(c[d], c[f]), cc[3 * d + f]);
                }
            }
#pragma unroll
            for (int d = 0; d < 3; ++d) ec[item * 3 + d] = e[d];
#pragma unroll
            for (int f = 0; f < 9; ++f) ecc[item * 9 + f] = cc[f];
        } else if (item < n_plane + n_vel) {
            const int k = item - n_plane, r = k / kVel;
            const float s = __frcp_rn(__fmul_rn(w[r], t));
            bound_pair(vb + k * kN, cp, s, 1.f, 2.f, prm.vel_limit, t, __fmul_rn(prm.lam, w[r]),
                       prm.margin, vpair + k * kPair);
        } else {
            const int k = item - n_plane - n_vel, r = k / kAcc;
            const float s = __frcp_rn(__fmul_rn(__fmul_rn(__fmul_rn(w[r], w[r]), t), t));
            bound_pair(ab + k * kN, cp, s, 2.f, 6.f, prm.acc_limit, t, __fmul_rn(prm.lam, w[r]),
                       prm.margin, apair + k * kPair);
        }
    }
    __syncthreads();

    const size_t piece = static_cast<size_t>(p);
    if (tid < kLoc * kLoc) {
        const int row = tid / kLoc, col = tid % kLoc;
        float v;
        if (row < kCp && col < kCp) {
            const int i = row / 3, d = row % 3, q = col / 3, e = col % 3;
            float pl = 0.f;
            for (int rj = 0; rj < n_plane; ++rj) {
                const float* br = B + rj * kN;
                pl = fmaf(__fmul_rn(br[i], br[q]), ecc[rj * 9 + 3 * d + e], pl);
            }
            const float hv = bound_hess(vpair, vb, n_vel, i, d, q, e);
            const float ha = bound_hess(apair, ab, n_acc, i, d, q, e);
            float al = 0.f;
            if (d == e) {
#pragma unroll
                for (int j = 0; j < kN; ++j) al = fmaf(conv[j * kN + i], conv[j * kN + q], al);
            }
            v = __fadd_rn(__fadd_rn(__fadd_rn(pl, hv), ha), __fmul_rn(prm.mu, al));
        } else if (row == kCp && col == kCp) {
            v = __fadd_rn(__fadd_rn(bound_sum(vpair, n_vel, 8), bound_sum(apair, n_acc, 8)), prm.mu);
        } else {
            const int k = row < kCp ? row : col, i = k / 3, d = k % 3;
            v = __fadd_rn(bound_vec(vpair, vb, n_vel, i, d, 3), bound_vec(apair, ab, n_acc, i, d, 3));
        }
        h_out[piece * kLoc * kLoc + tid] = v;
    } else if (tid < kLoc * kLoc + kLoc) {
        const int k = tid - kLoc * kLoc;
        float v;
        if (k < kCp) {
            const int i = k / 3, d = k % 3;
            float gp = 0.f;
            for (int rj = 0; rj < n_plane; ++rj) gp = fmaf(B[rj * kN + i], ec[rj * 3 + d], gp);
            const float gv = bound_vec(vpair, vb, n_vel, i, d, 0);
            const float ga = bound_vec(apair, ab, n_acc, i, d, 0);
            // the AL terms: convert^T (mu (convert cp - p_slack) + p_lambda)
            float gal = 0.f;
            for (int j = 0; j < kN; ++j) {
                float c = 0.f;
#pragma unroll
                for (int q = 0; q < kN; ++q) c = fmaf(conv[j * kN + q], cp[3 * q + d], c);
                const size_t at = piece * kCp + 3 * j + d;
                const float delta = __fsub_rn(c, p_slack[at]);
                gal = fmaf(conv[j * kN + i], __fadd_rn(__fmul_rn(prm.mu, delta), p_lambda[at]), gal);
            }
            v = __fadd_rn(__fadd_rn(__fadd_rn(gp, gv), ga), gal);
        } else {
            const float gt = __fadd_rn(bound_sum(vpair, n_vel, 7), bound_sum(apair, n_acc, 7));
            v = __fadd_rn(__fadd_rn(gt, __fmul_rn(prm.mu, __fsub_rn(t, t_slack[p]))), t_lambda[p]);
        }
        g_out[piece * kLoc + k] = v;
    }
}

// The sum over the block's kRed threads, the same bits on every thread: a
// butterfly in each warp, then the two warps' sums in order.  Every thread
// of the block calls it; ``scratch`` holds two floats.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
    __syncthreads();   // the scratch of the last sum has been read
    if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
    __syncthreads();
    return __fadd_rn(scratch[0], scratch[1]);
}

// h + diag(e) at (p, k, l), as psd_repair_gmw adds it
__device__ __forceinline__ float repaired(const float* h, const float* e, int p, int k, int l) {
    return __fadd_rn(h[(p * kLoc + k) * kLoc + l], __fmul_rn(e[p * kLoc + k], k == l ? 1.f : 0.f));
}

// One block of kRed threads, thread u the reduced coordinate u.
__global__ void __launch_bounds__(kRed)
dir_assemble_kernel(const float* __restrict__ g, const float* __restrict__ h,
                    const float* __restrict__ e, const long long* __restrict__ piece_idx,
                    float* __restrict__ a_out, float* __restrict__ ar_out,
                    float* __restrict__ rhs_out, float* __restrict__ scal_out, int pieces,
                    int ns) {
    __shared__ int who[kMaxNs][kMaxShare];   // (piece, local coordinate) of coordinate u
    __shared__ int count[kMaxNs];
    __shared__ float a[kMaxNs][kMaxNs + 1];
    __shared__ float scratch[2];
    const int u = threadIdx.x;
    if (u < ns) {
        // free_coord_indices inverted: stored row u / 3 + 2, coordinate u % 3
        const long long row = u / 3 + 2;
        int n = 0;
        for (int p = 0; p < pieces; ++p)
            for (int j = 0; j < kN; ++j)
                if (piece_idx[p * kN + j] == row && n < kMaxShare) who[u][n++] = p * kLoc + 3 * j + u % 3;
        count[u] = n;
    }
    __syncthreads();
    // index_add_ into zeros, the pieces in order
    for (int r = 0; r < ns; ++r) {
        if (u < ns) {
            float s = 0.f;
            for (int x = 0; x < count[r]; ++x) {
                const int pr = who[r][x] / kLoc, kr = who[r][x] % kLoc;
                for (int y = 0; y < count[u]; ++y)
                    if (who[u][y] / kLoc == pr) s = __fadd_rn(s, repaired(h, e, pr, kr, who[u][y] % kLoc));
            }
            a[r][u] = s;
        }
    }
    float b = 0.f, gs = 0.f;
    if (u < ns) {
        for (int y = 0; y < count[u]; ++y) {
            const int p = who[u][y] / kLoc, k = who[u][y] % kLoc;
            b = __fadd_rn(b, repaired(h, e, p, k, kCp));
            gs = __fadd_rn(gs, g[p * kLoc + k]);
        }
        rhs_out[2 * u] = gs;
        rhs_out[2 * u + 1] = b;
    }
    __syncthreads();
    // local_solve's relative ridge 1e-6 tr(a) / ns
    const float tr = block_sum(u < ns ? a[u][u] : 0.f, scratch);
    const float ridge = __fdiv_rn(__fmul_rn(1e-6f, tr), static_cast<float>(ns));
    for (int r = 0; r < ns; ++r) {
        if (u < ns) {
            const float v = a[r][u];
            a_out[r * ns + u] = v;
            ar_out[r * ns + u] = __fadd_rn(v, __fmul_rn(ridge, r == u ? 1.f : 0.f));
        }
    }
    if (u == 0) {
        float gt = 0.f, htt = 0.f;
        for (int p = 0; p < pieces; ++p) {
            gt = __fadd_rn(gt, g[p * kLoc + kCp]);
            htt = __fadd_rn(htt, repaired(h, e, p, kCp, kCp));
        }
        scal_out[0] = gt;
        scal_out[1] = htt;
    }
}

// local_solve's Schur scalars, finish_direction and correct_direction's
// residual.  a: [ns,ns] with row stride lda; gs, b: [ns] with stride sv;
// x: [ns,2] = [A^-1 gs, A^-1 b]; scal_out: schur_s, dt, r_t, gnorm.
__global__ void __launch_bounds__(kRed)
dir_schur_kernel(const float* __restrict__ a, int lda, const float* __restrict__ gs_in,
                 const float* __restrict__ b_in, int sv, const float* __restrict__ gt_in,
                 const float* __restrict__ htt_in, const float* __restrict__ x,
                 float* __restrict__ ds_out, float* __restrict__ rs_out,
                 float* __restrict__ scal_out, int ns) {
    __shared__ float ds_s[kMaxNs];
    __shared__ float scratch[2];
    const int u = threadIdx.x;
    const bool on = u < ns;
    const float gs = on ? gs_in[u * sv] : 0.f, b = on ? b_in[u * sv] : 0.f;
    const float xg = on ? x[2 * u] : 0.f, xb = on ? x[2 * u + 1] : 0.f;
    const float gt = gt_in[0], htt = htt_in[0];
    const float schur_s = __fsub_rn(htt, block_sum(__fmul_rn(b, xb), scratch));
    const float schur_r = __fsub_rn(gt, block_sum(__fmul_rn(b, xg), scratch));
    const float gnorm = sqrtf(__fadd_rn(block_sum(__fmul_rn(gs, gs), scratch), __fmul_rn(gt, gt)));
    const float s = nan_max(schur_s, __fmul_rn(1e-5f, nan_clamp_min(fabsf(schur_s), 1.f)));
    const float dt = __fdiv_rn(-schur_r, s);
    const float ds = __fsub_rn(-xg, __fmul_rn(dt, xb));
    if (on) ds_s[u] = ds;
    __syncthreads();
    if (on) {
        float acc = 0.f;
        for (int v = 0; v < ns; ++v) acc = fmaf(a[u * lda + v], ds_s[v], acc);
        ds_out[u] = ds;
        rs_out[u] = __fadd_rn(__fadd_rn(acc, __fmul_rn(b, dt)), gs);
    }
    const float bds = block_sum(on ? __fmul_rn(b, ds) : 0.f, scratch);
    if (u == 0) {
        scal_out[0] = schur_s;
        scal_out[1] = dt;
        scal_out[2] = __fadd_rn(__fadd_rn(bds, __fmul_rn(htt, dt)), gt);
        scal_out[3] = gnorm;
    }
}

// The Schur correction of the refinement, wolfe, the NaN-proof
// steepest-descent fallback and spread_direction.  gs, b: [ns] with stride
// sv; ainv_b: [ns] with stride sx; out: t_direction, wolfe, gnorm; bad: 1
// where the fallback was taken.
__global__ void __launch_bounds__(kRed)
dir_finish_kernel(const float* __restrict__ gs_in, const float* __restrict__ b_in, int sv,
                  const float* __restrict__ gt_in, const float* __restrict__ ainv_b, int sx,
                  const float* __restrict__ schur_s_in, const float* __restrict__ dt_in,
                  const float* __restrict__ rt_in, const float* __restrict__ gnorm_in,
                  const float* __restrict__ ds_in, const float* __restrict__ ainv_rs,
                  float* __restrict__ dir_out, float* __restrict__ out, int* __restrict__ bad_out,
                  int ns, int rows) {
    __shared__ float ds_s[kMaxNs];
    __shared__ float scratch[2];
    const int u = threadIdx.x;
    const bool on = u < ns;
    const float gs = on ? gs_in[u * sv] : 0.f, b = on ? b_in[u * sv] : 0.f;
    const float xb = on ? ainv_b[u * sx] : 0.f, xr = on ? ainv_rs[u] : 0.f;
    const float gt = gt_in[0], schur_s = schur_s_in[0];
    const float s_safe = nan_max(schur_s, __fmul_rn(1e-5f, nan_clamp_min(fabsf(schur_s), 1.f)));
    const float bx = block_sum(__fmul_rn(b, xr), scratch);
    const float cdt = __fdiv_rn(-__fsub_rn(rt_in[0], bx), s_safe);
    const float ds = on ? __fadd_rn(ds_in[u], __fsub_rn(-xr, __fmul_rn(cdt, xb))) : 0.f;
    const float dt = __fadd_rn(dt_in[0], cdt);
    const float dg = block_sum(__fmul_rn(ds, gs), scratch);
    const float wolfe = -__fadd_rn(dg, __fmul_rn(dt, gt));
    const bool all_finite = __syncthreads_and(!on || isfinite(ds));
    const bool bad = !(isfinite(wolfe) && all_finite && isfinite(dt)) || !(wolfe > 0.f);
    const float gg = __fadd_rn(block_sum(__fmul_rn(gs, gs), scratch), __fmul_rn(gt, gt));
    if (on) ds_s[u] = bad ? -gs : ds;
    __syncthreads();
    for (int k = u; k < 3 * rows; k += kRed) {
        const int v = k - 6;   // rows 2 .. T-3 hold the free coordinates
        dir_out[k] = v >= 0 && v < ns ? ds_s[v] : 0.f;
    }
    if (u == 0) {
        out[0] = bad ? -gt : dt;
        out[1] = bad ? gg : wolfe;
        out[2] = gnorm_in[0];
        bad_out[0] = bad ? 1 : 0;
    }
}

}  // namespace

// spline [T,3]; piece_idx [P,6] (int64); seg_basis [P,R,6,6]; seg_weight [R];
// convert [P,6,6]; plane_c [P,R,K,3], plane_d [P,R,K], plane_mask [P,R,K]
// (bool); piece_time []; p_slack, p_lambda [P,6,3]; t_slack, t_lambda [P];
// g [P,19], h [P,19,19] out.
extern "C" int trajopt_dir_grad_hess(const float* spline, const long long* piece_idx,
                                     const float* seg_basis, const float* seg_weight,
                                     const float* convert, const float* plane_c,
                                     const float* plane_d, const unsigned char* plane_mask,
                                     const float* piece_time, const float* p_slack,
                                     const float* t_slack, const float* p_lambda,
                                     const float* t_lambda, float* g, float* h, int pieces,
                                     int res, int planes, float lam, float mu, float margin,
                                     float vel_limit, float acc_limit, void* stream) {
    if (pieces < 1 || res < 1 || planes < 0) return static_cast<int>(cudaErrorInvalidValue);
    const size_t shared = (kCp + kN * kN + static_cast<size_t>(res) *
                           (1 + kN * kN + kVel * kN + kAcc * kN + 2 * kCp + kN * 9 +
                            (kVel + kAcc) * kPair)) * sizeof(float);
    if (shared > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            dir_grad_hess_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const GhParams prm{res, planes, lam, mu, margin, vel_limit, acc_limit};
    dir_grad_hess_kernel<<<pieces, kGhThreads, shared, static_cast<cudaStream_t>(stream)>>>(
        spline, piece_idx, seg_basis, seg_weight, convert, plane_c, plane_d, plane_mask, piece_time,
        p_slack, t_slack, p_lambda, t_lambda, g, h, prm);
    return static_cast<int>(cudaGetLastError());
}

// g [P,19], h [P,19,19], e [P,19]; a, a_ridged [ns,ns], rhs [ns,2] ([gs b]),
// scal [2] (gt, htt) out.
extern "C" int trajopt_dir_assemble(const float* g, const float* h, const float* e,
                                    const long long* piece_idx, float* a, float* a_ridged,
                                    float* rhs, float* scal, int pieces, int ns, void* stream) {
    if (pieces < 1 || pieces > kMaxShare || ns < 1 || ns > kMaxNs)
        return static_cast<int>(cudaErrorInvalidValue);
    dir_assemble_kernel<<<1, kRed, 0, static_cast<cudaStream_t>(stream)>>>(
        g, h, e, piece_idx, a, a_ridged, rhs, scal, pieces, ns);
    return static_cast<int>(cudaGetLastError());
}

// a [ns,ns] (row stride lda); gs, b [ns] (stride sv); gt, htt []; x [ns,2];
// ds, r_s [ns], scal [4] (schur_s, dt, r_t, gnorm) out.
extern "C" int trajopt_dir_schur(const float* a, int lda, const float* gs, const float* b, int sv,
                                 const float* gt, const float* htt, const float* x, float* ds,
                                 float* r_s, float* scal, int ns, void* stream) {
    if (ns < 1 || ns > kMaxNs || lda < ns || sv < 1) return static_cast<int>(cudaErrorInvalidValue);
    dir_schur_kernel<<<1, kRed, 0, static_cast<cudaStream_t>(stream)>>>(a, lda, gs, b, sv, gt, htt,
                                                                        x, ds, r_s, scal, ns);
    return static_cast<int>(cudaGetLastError());
}

// gs, b [ns] (stride sv); gt []; ainv_b [ns] (stride sx); schur_s, dt, r_t,
// gnorm []; ds, ainv_rs [ns]; direction [rows,3], out [3] (t_direction,
// wolfe, gnorm), bad [] (int32) out.
extern "C" int trajopt_dir_finish(const float* gs, const float* b, int sv, const float* gt,
                                  const float* ainv_b, int sx, const float* schur_s,
                                  const float* dt, const float* r_t, const float* gnorm,
                                  const float* ds, const float* ainv_rs, float* direction,
                                  float* out, int* bad, int ns, int rows, void* stream) {
    if (ns < 1 || ns > kMaxNs || 3 * (rows - 4) != ns || sv < 1 || sx < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    dir_finish_kernel<<<1, kRed, 0, static_cast<cudaStream_t>(stream)>>>(
        gs, b, sv, gt, ainv_b, sx, schur_s, dt, r_t, gnorm, ds, ainv_rs, direction, out, bad, ns,
        rows);
    return static_cast<int>(cudaGetLastError());
}
