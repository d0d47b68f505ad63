// Device code of K3 and K4 (csrc/chol.cu), shared with the kernels that run
// a modified Cholesky factorization and solve inside a larger fused step
// (csrc/slack.cu).  The design is chol.cu's (its note at the top): one warp
// per block, lane i holding row i of the trailing matrix in registers, the
// block staged in shared memory with row stride m | 1.  Each includer gets
// its own copy (an anonymous namespace), so nothing here is a symbol of the
// kernel library.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr float kEps = 1.19e-7f;

// max over the warp of v >= 0: non-negative floats order as their bits
__device__ __forceinline__ float warp_max_nonneg(float v) {
    return __uint_as_float(__reduce_max_sync(kFull, __float_as_uint(v)));
}

__host__ __device__ constexpr int stage_floats(int m) {
    return (m * (m | 1) + 3) & ~3;
}

// IEEE a / b.  A zero numerator sends the hardware's division to its slow
// path (about 0.1 us, more than a whole column step), and the blocks here
// are full of structural zeros (banded KKT systems, identity rows of pinned
// coordinates, zero right-hand sides, the padding); 0 / b = 0 * b bit for
// bit for a finite non-zero b, so that case takes a multiplication.
__device__ __forceinline__ float divide(float a, float b) {
    const bool zero = a == 0.f && b != 0.f && fabsf(b) < INFINITY;
    const float num = zero ? 1.f : a;
    float q;
#ifdef __CUDA_ARCH__
    // as an instruction of its own, so that the compiler keeps it out of a
    // branch on ``zero`` and can start the reciprocal of b before a arrives
    asm volatile("div.rn.f32 %0, %1, %2;" : "=f"(q) : "f"(num), "f"(b));
#else
    q = num / b;
#endif
    return zero ? a * b : q;
}

// Coalesced copy between a contiguous m x m block in device memory and its
// staged copy with row stride ld, by ``threads`` threads of which this one is
// ``tid``: coming in, asynchronous copies with one wait for all of them;
// going out, kBatch shared loads ahead of their stores.  The row of flat
// index t is
// (t * ceil(2^18 / m)) >> 18, exact for t < m * m with m <= 64, so the loop
// has no division.
constexpr int kBatch = 8;

template <bool TO_SHARED>
__device__ __forceinline__ void copy_block(float* g, float* s, int m, int ld, int tid,
                                           int threads) {
    const unsigned recip = ((1u << 18) + m - 1) / m;
    const int n = m * m;
    if (TO_SHARED) {
        // asynchronous copies: all in flight at once, one wait for the lot
        for (int t = tid; t < n; t += threads) {
            const int r = static_cast<int>((static_cast<unsigned>(t) * recip) >> 18);
            __pipeline_memcpy_async(s + r * ld + (t - r * m), g + t, sizeof(float));
        }
        __pipeline_commit();
        __pipeline_wait_prior(0);
        return;
    }
    for (int t0 = tid; t0 < n; t0 += threads * kBatch) {
        float v[kBatch];
        int at[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int t = t0 + threads * u;
            const int r = static_cast<int>((static_cast<unsigned>(t) * recip) >> 18);
            at[u] = r * ld + (t - r * m);
            if (t < n) v[u] = TO_SHARED ? g[t] : s[at[u]];
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int t = t0 + threads * u;
            if (t < n) {
                if (TO_SHARED) s[at[u]] = v[u];
                else g[t] = v[u];
            }
        }
    }
}

// Lane's rows from the staged block: a[r][k] = block[max(row,k)][min(row,k)],
// zeros in the padding.  With SCAN, also this lane's share of the GMW scan
// over the raw block: gam = max |diagonal|, off = max |off-diagonal|.
template <int COLS, int NR, bool SCAN>
__device__ __forceinline__ void take_rows(const float* s, int m, int ld, int lane,
                                          float (&a)[NR][COLS], float& gam, float& off) {
    // every load is unconditional (padding reads entry (0, 0) and is masked
    // after), so that they all go out together
#pragma unroll
    for (int r = 0; r < NR; ++r) {
        const int row = lane + 32 * r;
        const bool valid = row < m;
        const int rc = valid ? row : 0;
#pragma unroll
        for (int k = 0; k < COLS; ++k) {
            const int kc = k < m ? k : 0;
            const bool real = valid && k < m;
            const float raw = s[rc * ld + kc];
            const float mirrored = s[kc * ld + rc];
            a[r][k] = real ? (k <= row ? raw : mirrored) : 0.f;
            if (SCAN) {
                const float mag = real ? fabsf(raw) : 0.f;
                gam = fmaxf(gam, k == row ? mag : 0.f);
                off = fmaxf(off, k == row ? 0.f : mag);
            }
        }
    }
}

// The m column steps, as a rolled loop over a sliding window: going into
// step j, a[r][t] is entry (row, j + t) of the trailing matrix, so the
// pivot column is always register 0 and the update writes each entry one
// register to the left.  Column j of L (zeros above the diagonal included)
// goes to the staged block when there is one; e[r] is the boost of the
// lane's row.  Steps j_begin .. j_end - 1, updating W registers of the
// window (those past W hold no live column by then).
constexpr int kGroup = 8;   // shuffles started together ahead of their multiply-adds

template <int COLS, int NR, int W>
__device__ __forceinline__ void factor_steps(float (&a)[NR][COLS], float (&e)[NR], float* block,
                                             int m, int ld, int lane, bool gmw, float beta2,
                                             float delta, int j_begin, int j_end) {
    for (int j = j_begin; j < j_end && j < m; ++j) {
        float head = a[0][0];
        if (NR == 2 && j >= 32) head = a[1][0];
        const float dorig = __shfl_sync(kFull, head, j);
        float dnew = dorig;
        if (gmw) {
            float theta = 0.f;
#pragma unroll
            for (int r = 0; r < NR; ++r)
                theta = fmaxf(theta, lane + 32 * r > j ? fabsf(a[r][0]) : 0.f);
            theta = warp_max_nonneg(theta);
            // max(|d|, theta^2 / beta2, delta), with the division taken off
            // the chain where it cannot win: theta^2 <= beta2 floor / 2
            // leaves the quotient below the floor whatever the rounding
            const float floor = fmaxf(fabsf(dorig), delta);
            const float t2 = theta * theta;
            dnew = t2 > 0.5f * beta2 * floor ? fmaxf(floor, t2 / beta2) : floor;
        }
        const float piv = sqrtf(dnew);   // plain Cholesky: NaN on a non-PD pivot
        float c[NR];
#pragma unroll
        for (int r = 0; r < NR; ++r) {
            const int row = lane + 32 * r;
            const bool below = row > j && row < m;
            const float q = divide(a[r][0], piv);
            c[r] = below ? q : 0.f;
            if (row == j) e[r] = gmw ? dnew - dorig : 0.f;
            if (block != nullptr && row < m)
                block[row * ld + j] = row > j ? c[r] : (row == j ? piv : 0.f);
        }
        // a[i][k] -= c_i c_k, shifted one register left; rows <= j have c = 0
#pragma unroll
        for (int t0 = 1; t0 < W; t0 += kGroup) {
            float ck[kGroup];
#pragma unroll
            for (int u = 0; u < kGroup; ++u) {
                if (t0 + u >= W) continue;
                // columns k >= m are padding: whatever lane k mod 32 holds
                // lands in registers that no real column ever reads
                const int k = j + t0 + u;
                float from = c[0];
                if (NR == 2 && k >= 32) from = c[1];
                ck[u] = __shfl_sync(kFull, from, k);
            }
#pragma unroll
            for (int u = 0; u < kGroup; ++u) {
                const int t = t0 + u;
                if (t < W) {
#pragma unroll
                    for (int r = 0; r < NR; ++r) a[r][t - 1] = fmaf(-c[r], ck[u], a[r][t]);
                }
            }
        }
#pragma unroll
        for (int r = 0; r < NR; ++r) a[r][W - 1] = 0.f;
    }
}

// All m steps.  From step j on only m - j <= COLS - j registers of the
// window are live, so the later steps run the same loop at half and at a
// quarter of the width.
template <int COLS, int NR>
__device__ __forceinline__ void factor(float (&a)[NR][COLS], float (&e)[NR], float* block, int m,
                                       int ld, int lane, bool gmw, float beta2, float delta) {
    constexpr int HALF = (COLS + 1) / 2, QUARTER = (COLS + 3) / 4;
    factor_steps<COLS, NR, COLS>(a, e, block, m, ld, lane, gmw, beta2, delta, 0, COLS - HALF);
    factor_steps<COLS, NR, HALF>(a, e, block, m, ld, lane, gmw, beta2, delta, COLS - HALF,
                                 COLS - QUARTER);
    factor_steps<COLS, NR, QUARTER>(a, e, block, m, ld, lane, gmw, beta2, delta, COLS - QUARTER,
                                    COLS);
}

// Forward then backward substitution of one right-hand side, L read from
// the staged block (its loads do not depend on b, so they run ahead of the
// chain); b[r] is the lane's entry going in and of the solution coming out.
// A step: b_j by a shuffle from lane j, one division, one multiply-add.
template <int NR>
__device__ __forceinline__ void substitute(const float* block, float (&b)[NR], int m, int ld,
                                           int lane) {
#pragma unroll 4
    for (int j = 0; j < m; ++j) {                // L y = b
        const float d = block[j * ld + j];
        float lij[NR];
#pragma unroll
        for (int r = 0; r < NR; ++r) {
            const int row = lane + 32 * r;
            lij[r] = (row > j && row < m) ? block[row * ld + j] : 0.f;
        }
        float from = b[0];
        if (NR == 2 && j >= 32) from = b[1];
        const float y = divide(__shfl_sync(kFull, from, j), d);
#pragma unroll
        for (int r = 0; r < NR; ++r) {
            const int row = lane + 32 * r;
            if (row > j) b[r] = fmaf(-lij[r], y, b[r]);
            else if (row == j) b[r] = y;
        }
    }
#pragma unroll 4
    for (int j = m - 1; j >= 0; --j) {           // L^T x = y
        const float d = block[j * ld + j];
        float lji[NR];
#pragma unroll
        for (int r = 0; r < NR; ++r) {
            const int row = lane + 32 * r;
            lji[r] = row < j ? block[j * ld + row] : 0.f;
        }
        float from = b[0];
        if (NR == 2 && j >= 32) from = b[1];
        const float x = divide(__shfl_sync(kFull, from, j), d);
#pragma unroll
        for (int r = 0; r < NR; ++r) {
            const int row = lane + 32 * r;
            if (row < j) b[r] = fmaf(-lji[r], x, b[r]);
            else if (row == j) b[r] = x;
        }
    }
}

// The lane's entries of column col of rhs [m, nrhs] (zeros past the end).
template <int NR>
__device__ __forceinline__ void load_rhs(const float* __restrict__ rhs, float (&b)[NR], int m,
                                         int nrhs, int col, int lane) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
        const int row = lane + 32 * r;
        b[r] = (row < m && col < nrhs) ? rhs[row * nrhs + col] : 0.f;
    }
}

// Columns col, col + stride, ... of rhs through `substitute`.  ``first``
// holds column col, loaded by the caller before it waited for the block, so
// that the two latencies overlap.
template <int NR>
__device__ __forceinline__ void solve_columns(const float* block, const float* __restrict__ rhs,
                                              float (&first)[NR], float* __restrict__ x, int m,
                                              int ld, int nrhs, int col, int stride, int lane) {
    for (; col < nrhs; col += stride) {
        substitute<NR>(block, first, m, ld, lane);
#pragma unroll
        for (int r = 0; r < NR; ++r)
            if (lane + 32 * r < m) x[(lane + 32 * r) * nrhs + col] = first[r];
        load_rhs<NR>(rhs, first, m, nrhs, col + stride, lane);
    }
}

// Scan and factor the staged block (one warp); shared by K3 and the fused
// kernel.  With ``keep`` the staged block holds L afterwards.
template <int COLS, int NR>
__device__ __forceinline__ void factor_staged(float* block, float (&e)[NR], int m, int ld,
                                              int lane, int gmw, float nf, bool keep) {
    float a[NR][COLS];
    float gam = 0.f, off = 0.f, beta2 = 0.f, delta = 0.f;
    if (gmw) {
        take_rows<COLS, NR, true>(block, m, ld, lane, a, gam, off);
        gam = warp_max_nonneg(gam);
        off = warp_max_nonneg(off);
        beta2 = fmaxf(fmaxf(gam, off / nf), kEps);
        delta = kEps * fmaxf(gam + off, 1.f);
    } else {
        take_rows<COLS, NR, false>(block, m, ld, lane, a, gam, off);
    }
    __syncwarp();   // every lane has its rows before L overwrites the block
#pragma unroll
    for (int r = 0; r < NR; ++r) e[r] = 0.f;
    factor<COLS, NR>(a, e, keep ? block : nullptr, m, ld, lane, gmw != 0, beta2, delta);
}

template <int NR>
__device__ __forceinline__ void write_boosts(float* __restrict__ eout, const float (&e)[NR], int m,
                                             int lane) {
#pragma unroll
    for (int r = 0; r < NR; ++r)
        if (lane + 32 * r < m) eout[lane + 32 * r] = e[r];
}

}  // namespace
