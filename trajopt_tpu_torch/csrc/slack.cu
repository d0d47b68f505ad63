// slack_step: the whole slack phase of one ADMM step in one launch, for
// every piece of every robot (solver/admm.py::slack_update; its plain
// version is solver/admm.py::slack_update_plain).
//
// It replaces no TPU kernel.  The JAX package leaves this phase to XLA
// (trajopt_tpu/solver/admm.py:501, `slack_update`; the Hessian by
// `vmap(jacfwd(grad))` at :523), which fuses it; in PyTorch the same code
// is some hundreds of small kernels, a staged Armijo ladder and a
// conditional graph node an iteration.  This kernel does it all:
//
//   1. the converted spline control points c = convert[p] @ spline[piece_idx[p]];
//   2. the closed-form gradient and Hessian of the piece's slack energy
//      E = a(t) q + kt t^1.1 + mu/2 |c - p|^2 + lambda.(c - p)
//          + mu/2 (T - t)^2 + lambda_t (T - t),
//      a(t) = ks/2 t^-n (n = 2 der - 1), q = sum_d p_d^T M p_d:
//        g_p = 2a M p - mu (c - p) - lambda
//        g_t = a' q + 1.1 kt t^0.1 - mu (T - t) - lambda_t
//        H_pp = (2a M + mu I) x I_3, H_pt = 2a' M p,
//        H_tt = a'' q + 0.11 kt t^-0.9 + mu;
//   3. the freeze mask (the first piece's coordinates 0-5 and the last
//      piece's 12-17 get a zero gradient and identity rows);
//   4. K3's GMW repair and factorization and K4's solve, by the same
//      device code as the fused factor_solve (csrc/chol_device.cuh);
//   5. steepest descent where the Newton direction is not finite or
//      wolfe = -d.g <= 0, and the step clamp that keeps t > 0;
//   6. the Armijo ladder 0.8^k step, k < max_line_search: each piece takes
//      its first rung with E(s) <= E(0) - 1e-4 wolfe s (NaN counting as
//      +inf), the last rung unconditionally; the batch-global staged ladder
//      of the plain version picks the same rung for every piece;
//   7. the dual ascent, and the consensus residual of each robot.
//
// Bound on the card: latency.  A piece is 19 unknowns and a few hundred
// bytes in and out; a call at 4 to 4096 pieces moves at most a few hundred
// KB and does some thousand operations a piece, while the factorization
// and the solve are 19 and 38 dependent steps and the ladder a dependent
// search.  What the design removes is the chain of launches and the graph
// nodes between them: one block a robot, one warp a piece (a loop over the
// pieces past kMaxWarps), so the robot's residual is a reduction inside
// the block; lane i holds row i of the Hessian and entry i of the vectors
// (K3's layout), the Hessian is written straight into K3's staged block,
// and the ladder tries 32 rungs at once, one a lane, each lane evaluating
// its trial energy in full from the piece's vectors in shared memory;
// `__ballot_sync` and `__ffs` find the first accepted rung, so 64 rungs
// take at most two passes and no stage needs a conditional node.  Nothing
// between the inputs and the outputs goes through device memory.
//
// The trial energies are evaluated directly, in the order of terms of
// `energies.slack_energy`, and the trial point, the Armijo test and the
// updates with the rounding of their separate PyTorch operations
// (__fmul_rn and __fadd_rn keep the compiler from fusing them), so that
// the accepted rung is the plain version's wherever the Armijo margin
// exceeds float32 rounding.

#include "chol_device.cuh"

namespace {

constexpr int kN = 6;                 // control points a piece
constexpr int kCp = 3 * kN;           // their coordinates
constexpr int kLoc = kCp + 1;         // and the time
constexpr int kLd = kLoc | 1;         // the staged block's row stride
constexpr int kCols = 20;             // K3's padded width for m = 19 (cuda_chol.route)
constexpr int kMaxWarps = 16;         // pieces of a robot worked on at once
constexpr int kVec = 20;              // floats a vector of the piece takes in shared memory
constexpr int kWarpFloats = stage_floats(kLoc) + 4 * kVec;
constexpr int kHead = kN * kN + 2 * kMaxWarps;   // M, then the warps' residual sums
constexpr float kArmijo = 1e-4f;
constexpr float kShrink = 0.8f;

struct Weights {
    float ks, kt, mu, mu_half, power, nf;
    int rungs;
};

__device__ __forceinline__ float warp_sum(float v) {
    // a butterfly: every lane ends with the same bits
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    return v;
}

// Free (not pinned) local coordinate ``k`` of piece ``p`` of ``pieces``.
__device__ __forceinline__ bool free_coord(int k, int p, int pieces) {
    return !((p == 0 && k < 6) || (p == pieces - 1 && k >= 12 && k < kCp));
}

// The piece's slack energy at p0 + s d (``direct``: at p0) and time t, in
// the order of terms of energies.slack_energy.  ``v``: the piece's p0, d,
// c and lambda, kVec floats each.
__device__ float energy(const float* M, const float* v, float s, bool direct, float t, float T,
                        float lt, const Weights& w) {
    const float* p0 = v;
    const float* d = v + kVec;
    const float* c = v + 2 * kVec;
    const float* lam = v + 3 * kVec;
    float p[kCp];
#pragma unroll
    for (int k = 0; k < kCp; ++k) p[k] = direct ? p0[k] : __fadd_rn(p0[k], __fmul_rn(s, d[k]));
    float quad = 0.f;
#pragma unroll
    for (int dd = 0; dd < 3; ++dd) {
#pragma unroll
        for (int i = 0; i < kN; ++i) {
            float mp = 0.f;
#pragma unroll
            for (int j = 0; j < kN; ++j) mp = fmaf(M[i * kN + j], p[3 * j + dd], mp);
            quad = fmaf(p[3 * i + dd], mp, quad);
        }
    }
    float sq = 0.f, sl = 0.f;
#pragma unroll
    for (int k = 0; k < kCp; ++k) {
        const float delta = __fsub_rn(c[k], p[k]);
        sq = fmaf(delta, delta, sq);
        sl = fmaf(lam[k], delta, sl);
    }
    const float td = __fsub_rn(T, t);
    const float smooth = __fmul_rn(__fmul_rn(__fdiv_rn(w.ks, powf(t, w.power)), 0.5f), quad);
    float e = __fadd_rn(smooth, __fmul_rn(w.kt, powf(t, 1.1f)));
    e = __fadd_rn(e, __fmul_rn(w.mu_half, sq));
    e = __fadd_rn(e, sl);
    e = __fadd_rn(e, __fmul_rn(__fmul_rn(w.mu_half, td), td));
    return __fadd_rn(e, __fmul_rn(lt, td));
}

// One block a robot (blockIdx.x), one warp a piece.
__global__ void __launch_bounds__(32 * kMaxWarps)
slack_step_kernel(const float* __restrict__ spline, int rows, const long long* __restrict__ piece_idx,
                  const float* __restrict__ convert, const float* __restrict__ m_dyn,
                  const float* __restrict__ piece_time, const float* __restrict__ p_slack,
                  const float* __restrict__ t_slack, const float* __restrict__ p_lambda,
                  const float* __restrict__ t_lambda, float* __restrict__ p_out,
                  float* __restrict__ t_out, float* __restrict__ pl_out, float* __restrict__ tl_out,
                  float* __restrict__ residual, int* __restrict__ rung_out, int pieces, Weights w) {
    extern __shared__ __align__(16) float shared_floats[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
    const int robot = blockIdx.x;
    float* M = shared_floats;
    float* sums = shared_floats + kN * kN;
    float* block = shared_floats + kHead + warp * kWarpFloats;
    float* vec = block + stage_floats(kLoc);
    for (int t = threadIdx.x; t < kN * kN; t += blockDim.x) M[t] = m_dyn[t];
    __syncthreads();

    const bool is_cp = lane < kCp, is_row = lane < kLoc;
    const int j = is_cp ? lane / 3 : 0, dd = is_cp ? lane - 3 * j : 0;
    const float T = piece_time[robot];
    const float* sp = spline + static_cast<size_t>(robot) * rows * 3;
    float acc_p = 0.f, acc_t = 0.f;
    for (int p = warp; p < pieces; p += warps) {
        const size_t i = static_cast<size_t>(robot) * pieces + p;
        const float t0 = t_slack[i], lt = t_lambda[i];
        float p0 = 0.f, lam = 0.f, c = 0.f;
        if (is_cp) {
            p0 = p_slack[i * kCp + lane];
            lam = p_lambda[i * kCp + lane];
            const float* conv = convert + (static_cast<size_t>(p) * kN + j) * kN;
            const long long* idx = piece_idx + static_cast<size_t>(p) * kN;
#pragma unroll
            for (int q = 0; q < kN; ++q) c = fmaf(conv[q], sp[idx[q] * 3 + dd], c);
        }
        // (M p)_jd, q = sum_d p_d^T M p_d, and a(t) with its derivatives
        float mp = 0.f;
#pragma unroll
        for (int q = 0; q < kN; ++q) mp = fmaf(M[j * kN + q], __shfl_sync(kFull, p0, 3 * q + dd), mp);
        const float quad = warp_sum(is_cp ? p0 * mp : 0.f);
        const float a = 0.5f * w.ks / powf(t0, w.power);
        const float a1 = -w.power * a / t0;
        const float a2 = w.power * (w.power + 1.f) * a / (t0 * t0);
        const bool free_row = free_coord(lane, p, pieces);
        const float keep = free_row ? 1.f : 0.f;
        float g = 0.f;
        if (is_cp) g = 2.f * a * mp - w.mu * (c - p0) - lam;
        else if (is_row) g = a1 * quad + 1.1f * w.kt * powf(t0, 0.1f) - w.mu * (T - t0) - lt;
        g = is_row ? g * keep : 0.f;

        // the Hessian, frozen rows and columns replaced by the identity's
        if (is_cp) {
            for (int col = 0; col < kCp; ++col) {
                const int jc = col / 3;
                float h = col - 3 * jc == dd ? 2.f * a * M[j * kN + jc] + (col == lane ? w.mu : 0.f)
                                             : 0.f;
                if (!(free_row && free_coord(col, p, pieces))) h = col == lane ? 1.f : 0.f;
                block[lane * kLd + col] = h;
            }
            const float hpt = free_row ? 2.f * a1 * mp : 0.f;
            block[lane * kLd + kCp] = hpt;
            block[kCp * kLd + lane] = hpt;
        } else if (is_row) {
            block[kCp * kLd + kCp] = a2 * quad + 0.11f * w.kt * powf(t0, -0.9f) + w.mu;
        }
        __syncwarp();

        // K3's GMW factor into the staged block, then K4's substitutions
        float e[1];
        factor_staged<kCols, 1>(block, e, kLoc, kLd, lane, 1, w.nf, true);
        __syncwarp();
        float b[1] = {g};
        substitute<1>(block, b, kLoc, kLd, lane);
        float dir = is_row ? -b[0] * keep : 0.f;
        float wolfe = -warp_sum(dir * g);
        const bool finite = __all_sync(kFull, !is_row || fabsf(dir) < INFINITY);
        if (!(finite && wolfe > 0.f)) {          // the same on every lane
            dir = is_row ? -g : 0.f;
            wolfe = warp_sum(g * g);
        }
        const float d_t = __shfl_sync(kFull, dir, kCp);
        float step = 1.f;
        if (__fadd_rn(t0, d_t) <= 0.f) step = __fdiv_rn(__fmul_rn(-0.95f, t0), d_t);

        // the ladder, 32 rungs a pass
        if (is_cp) {
            vec[lane] = p0;
            vec[2 * kVec + lane] = c;
            vec[3 * kVec + lane] = lam;
        }
        if (is_row) vec[kVec + lane] = dir;
        __syncwarp();
        const float e0 = energy(M, vec, 0.f, true, t0, T, lt, w);
        const float slope = __fmul_rn(kArmijo, wolfe);
        int rung = w.rungs - 1;
        for (int base = 0; base < w.rungs; base += 32) {
            const int r = base + lane;
            bool ok = false;
            if (r < w.rungs) {
                const float s = __fmul_rn(powf(kShrink, static_cast<float>(r)), step);
                float trial = energy(M, vec, s, false, __fadd_rn(t0, __fmul_rn(s, d_t)), T, lt, w);
                if (trial != trial) trial = INFINITY;   // NaN
                ok = r == w.rungs - 1 || __fsub_rn(e0, __fmul_rn(slope, s)) >= trial;
            }
            const unsigned hits = __ballot_sync(kFull, ok);
            if (hits != 0u) {
                rung = base + __ffs(hits) - 1;
                break;
            }
        }

        // the step, the dual ascent and the residual's sums
        const float s = __fmul_rn(powf(kShrink, static_cast<float>(rung)), step);
        float gap2 = 0.f;
        if (is_cp) {
            const float pn = __fadd_rn(p0, __fmul_rn(s, dir));
            const float gap = __fsub_rn(c, pn);
            p_out[i * kCp + lane] = pn;
            pl_out[i * kCp + lane] = __fadd_rn(lam, __fmul_rn(w.mu, gap));
            gap2 = gap * gap;
        } else if (lane == kCp) {
            const float tn = __fadd_rn(t0, __fmul_rn(s, d_t));
            const float gap = __fsub_rn(T, tn);
            t_out[i] = tn;
            tl_out[i] = __fadd_rn(lt, __fmul_rn(w.mu, gap));
            acc_t += gap * gap;
        }
        const float piece_gap2 = warp_sum(gap2);
        if (lane == 0) {
            acc_p += piece_gap2;
            rung_out[i] = rung;
        }
        __syncwarp();   // the block and the vectors are the next piece's
    }
    acc_t = __shfl_sync(kFull, acc_t, kCp);
    if (lane == 0) {
        sums[warp] = acc_p;
        sums[kMaxWarps + warp] = acc_t;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        float sp2 = 0.f, st2 = 0.f;
        for (int v = 0; v < warps; ++v) {
            sp2 += sums[v];
            st2 += sums[kMaxWarps + v];
        }
        residual[robot] = sqrtf(sp2 + st2);
    }
}

}  // namespace

// spline [robots, rows, 3]; piece_idx [pieces, 6] (int64); convert [pieces,
// 6, 6]; m_dyn [6, 6]; piece_time [robots]; p_slack, p_lambda [robots,
// pieces, 6, 3]; t_slack, t_lambda [robots, pieces]; outputs of the same
// shapes, residual [robots] and rungs [robots, pieces] (int32).
extern "C" int trajopt_slack_step(const float* spline, int rows, const long long* piece_idx,
                                  const float* convert, const float* m_dyn, const float* piece_time,
                                  const float* p_slack, const float* t_slack, const float* p_lambda,
                                  const float* t_lambda, float* p_out, float* t_out, float* pl_out,
                                  float* tl_out, float* residual, int* rungs, int robots,
                                  int pieces, int n_rungs, float ks, float kt, float mu,
                                  float mu_half, int power, float nf, void* stream) {
    if (pieces < 1 || n_rungs < 1 || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (robots > 0) {
        const int warps = pieces < kMaxWarps ? pieces : kMaxWarps;
        const size_t shared = (kHead + warps * kWarpFloats) * sizeof(float);
        const Weights w{ks, kt, mu, mu_half, static_cast<float>(power), nf, n_rungs};
        slack_step_kernel<<<robots, 32 * warps, shared, static_cast<cudaStream_t>(stream)>>>(
            spline, rows, piece_idx, convert, m_dyn, piece_time, p_slack, t_slack, p_lambda,
            t_lambda, p_out, t_out, pl_out, tl_out, residual, rungs, pieces, w);
    }
    return static_cast<int>(cudaGetLastError());
}
