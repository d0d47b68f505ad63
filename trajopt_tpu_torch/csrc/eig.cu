// K6: batched eigenvalues of symmetric m x m blocks (m <= 32), ascending.
//
// Replaces XLA's `jnp.linalg.eigvalsh` in trajopt_tpu/ops/gradients.py:414
// (`psd_repair`, the shift of psd_method="eigh"); the JAX package has no
// Pallas kernel for it.  The port's plain version is `torch.linalg.eigvalsh`
// (ops/cuda_eig.py), which on the card waits on the host for its error
// check and so cannot run inside a CUDA graph: this kernel never reads
// anything back, so the fused drivers capture it.
//
// Bound on the card: latency.  The solver's blocks are 19 x 19, 4 to 4096
// of them a call (76 KB to 5.9 MB), and a block needs a few Jacobi sweeps
// of n - 1 = 19 rounds (3 for the spline Hessians at the start, 0 to 5 for
// the slack ones; `testing.eig_kernel_model` counts them), each round's
// rotations formed from the last round's result: a call waits on that
// dependent chain of up to ~100 rounds a block, not on bytes or operations.
// With one warp a block, each lane would apply all n / 2 row rotations to
// its column one after another, then all column rotations to its row: ~80
// dependent shared-memory accesses a lane a round, and four warp barriers.
//
// What this design does about it: one CUDA block a matrix, and one thread
// for each 2 x 2 pair-block off the diagonal, so that a round is one barrier
// and, for each thread, 4 entries and 2 rotations loaded, a two-sided
// rotation in registers (16 multiply-adds, no loop over rotations) and 4
// entries stored, at addresses fixed for the whole call; the rotations of
// the next round are formed in the same round by the threads that hold
// their entries.
//
// Algorithm: parallel cyclic Jacobi in the ring order of Brent and Luk.  The
// block (its lower triangle, as `torch.linalg.eigvalsh` reads it) is padded
// to an even order n >= 6 (n = 2 for m <= 2) with zero rows and columns,
// which no rotation then touches.  Its n indices sit in n slots; in each
// round the indices in slots 2k and 2k + 1 (the top and the bottom of pair
// k) meet, and then every index but the one in slot 0 moves one place
// round the ring top 1 -> top 2 -> ... -> top n/2-1 -> bottom n/2-1 -> ... ->
// bottom 0 -> top 1, so that each pair of indices meets once in a sweep of
// n - 1 rounds and every index is back in its slot after it.  Pair k's
// rotation is the stable 2 x 2 symmetric Schur rotation of (a_pp, a_qq,
// a_pq), p its top, q its bottom: d = a_qq - a_pp, e = 2 a_pq,
// t = sign(d) e / (|d| + sqrt(d^2 + e^2)) (= sign(tau) / (|tau| +
// sqrt(1 + tau^2)) for tau = d / e), c = 1 / sqrt(1 + t^2) (rounded once),
// s = t c, with the closed forms a_pp - t a_pq, a_qq + t a_pq and a zero
// a_pq, which keep every off-diagonal entry a combination of off-diagonal
// entries and the convergence quadratic in float32; an |a_pq| <= 2^-60 (of
// a block scaled to a largest entry in [0.5, 1)) is set to zero with no
// rotation, which also keeps d^2 + e^2 clear of underflow.
//
// Layout: the start is staged as an upper triangle at its natural indices
// (row stride 33); from there each thread takes its pair-block's entries.
// Then shared memory holds the entries off the diagonal blocks by slot,
// one plane for each of the four entries (top/bottom row, top/bottom
// column) of each pair-block (k, l), k < l, double-buffered by round.
// Thread (k, l) reads its four entries from its own place in the planes
// (without bank conflicts), applies rotation k to the rows, then rotation l
// to the columns, and stores each entry where its indices sit in the next
// round, addresses it computed once.  Each pair of the next round comes
// from two pairs of this round, so its a_pq is one entry of one thread (for
// n >= 6): that thread forms the next rotation from it and this round's
// closed-form diagonals and publishes it (double-buffered by round); one
// thread a pair stores the zero its a_pq becomes.  The diagonal lives in
// the published closed forms between the start and the end.  Every load
// of the start is issued before the first is used (2, 4, 6 or 9 a thread,
// a template parameter: 6 at m = 19).
//
// Stopping: before the first sweep and after each, off^2 = 2 sum_{i<j}
// a_ij^2 <= eps^2 |A|_F^2 (eps = 2^-23, |A|_F of the scaled start), or
// after kMaxSweeps sweeps; the sums are block reductions in a fixed order,
// so every thread takes the same decision and a block gives the same bits
// in every launch.  The block is first scaled by a power of two near
// 1 / max|a_ij|, which is exact and keeps the squares from overflowing or
// underflowing at any scale.  Last, each thread ranks one diagonal entry
// among the others (ties by index) and writes it there: ascending, as the
// plain version returns them.  A block with a non-finite entry gives NaN
// for every eigenvalue.
//
// Launch: one CUDA block a matrix at every call shape, of (n/2)(n/2 - 1)/2
// threads rounded up to whole warps (64 for the solver's m = 19, 128 for
// m = 32), 8.5 KB of static shared memory and 38-48 registers a thread, so
// that an SM holds ~20 matrices: [4,19,19] to [256,19,19] run every matrix
// at once (a call takes the latency of its slowest block), [1024,4,19,19]
// and [4096,19,19] fill every SM in two waves.
//
// The last kernel here is a latency probe, by which chip_smoke.py measures
// the least time a round of this design takes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxM = 32;
constexpr int kMaxPairs = kMaxM / 2;
constexpr int kMaxBlocks = kMaxPairs * (kMaxPairs - 1) / 2;   // 120 pair-blocks at m = 32
constexpr int kMaxThreads = 128;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kLd = kMaxM + 1;       // row stride of the start's upper triangle
constexpr int kMaxSweeps = 15;
constexpr float kEps = 1.1920929e-7f;
constexpr float kTiny = 8.6736174e-19f;  // 2^-60

struct Stage {
    float x[2][4][kMaxBlocks];       // by round parity, entry (row bit, column bit), pair-block
    float4 rot[2][kMaxPairs];        // by round parity and pair: (c, s, new a_pp, new a_qq)
    float a[kMaxM * kLd];            // a[i * kLd + j] = A_ij for i <= j at the start; the
                                     // diagonal also at the end
    float red[2][kMaxWarps];         // the sweeps' block sums, by sweep parity
    float start[3][kMaxWarps];       // the start's max|a_ij|, off^2 and diagonal^2 by warp
};

// the order n of a block of order m: even, and >= 6 so that no pair-block
// holds two pairs of the next round
__host__ __device__ __forceinline__ int padded(int m) {
    return m <= 2 ? 2 : max(6, m + (m & 1));
}

// the slot where the index in slot s of a round sits in the next (h pairs)
__device__ __forceinline__ int next_slot(int s, int h) {
    const int k = s >> 1;
    if (h == 1 || s == 0) return s;
    if ((s & 1) == 0) return k < h - 1 ? s + 2 : s + 1;
    return k > 0 ? s - 2 : 2;
}

// pair-block (k, l), k < l, in row-major order of the upper triangle
__device__ __forceinline__ int block_id(int k, int l, int h) {
    return k * h - k * (k + 1) / 2 + (l - k - 1);
}

// where entry (slot s, slot t) of two different pairs lives in a set of planes
__device__ __forceinline__ int plane_offset(int s, int t, int h) {
    const int lo = min(s, t), hi = max(s, t);
    return ((lo & 1) * 2 + (hi & 1)) * kMaxBlocks + block_id(lo >> 1, hi >> 1, h);
}

// (c, s, new a_pp, new a_qq) of the rotation that zeroes a_pq
__device__ __forceinline__ float4 rotation(float app, float aqq, float apq) {
    if (!(fabsf(apq) > kTiny)) return make_float4(1.f, 0.f, app, aqq);
    const float d = aqq - app, e = 2.f * apq;
    const float t = (d >= 0.f ? e : -e) / (fabsf(d) + sqrtf(fmaf(d, d, e * e)));
    const float c = __frsqrt_rn(fmaf(t, t, 1.f));
    return make_float4(c, t * c, fmaf(-t, apq, app), fmaf(t, apq, aqq));
}

// rows (top k, bottom k) by rotation k, then columns (top l, bottom l) by
// rotation l: x00 = A(top k, top l), x01 = A(top k, bottom l), and so on
__device__ __forceinline__ void rotate_block(float4 rk, float4 rl, float& x00, float& x01,
                                             float& x10, float& x11) {
    const float y00 = fmaf(rk.x, x00, -rk.y * x10), y01 = fmaf(rk.x, x01, -rk.y * x11);
    const float y10 = fmaf(rk.y, x00, rk.x * x10), y11 = fmaf(rk.y, x01, rk.x * x11);
    x00 = fmaf(rl.x, y00, -rl.y * y01);
    x01 = fmaf(rl.y, y00, rl.x * y01);
    x10 = fmaf(rl.x, y10, -rl.y * y11);
    x11 = fmaf(rl.y, y10, rl.x * y11);
}

// the sum of v over the CUDA block, the same bits in every thread (a
// butterfly in each warp, then the warps' sums in order); one barrier
__device__ __forceinline__ float block_sum(float v, float* slots) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = v;
    __syncthreads();
    float s = 0.f;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += slots[w];
    return s;
}

// What a thread does for one pair-block in every round, worked out once.
struct BlockPlan {
    int id;          // pair-block (k, l), or -1
    int k, l;
    int dst[4];      // where entries 00, 01, 10, 11 go in the next round's planes
    int own;         // the entry that is the a_pq of the next round's pair `next`, or -1
    int next;
    bool swap;       // that entry's column index is the next pair's top
};

__device__ __forceinline__ void plan_block(BlockPlan& b, int id, int h) {
    b.id = id;
    b.k = b.l = b.next = 0;
    b.own = -1;
    b.swap = false;
    for (int e = 0; e < 4; ++e) b.dst[e] = 0;
    if (id < 0) return;
    int rem = id;
    while (rem >= h - 1 - b.k) {
        rem -= h - 1 - b.k;
        ++b.k;
    }
    b.l = b.k + 1 + rem;
    for (int e = 0; e < 4; ++e) {
        const int s = next_slot(2 * b.k + (e >> 1), h), t = next_slot(2 * b.l + (e & 1), h);
        if ((s >> 1) == (t >> 1)) {
            b.own = e;
            b.next = s >> 1;
            b.swap = (t & 1) == 0;
        } else {
            b.dst[e] = plane_offset(s, t, h);
        }
    }
}

// 2^e for |e| <= 126, exactly
__device__ __forceinline__ float pow2(int e) {
    return __int_as_float((127 + e) << 23);
}

template <int kLoads>   // entries of the start a thread loads
__global__ void __launch_bounds__(kMaxThreads)
eigvalsh_kernel(const float* __restrict__ hin, float* __restrict__ w, int m) {
    __shared__ Stage st;
    const int tid = threadIdx.x, nt = blockDim.x;
    const int n = padded(m), h = n / 2, blocks = h * (h - 1) / 2;
    const float* src = hin + static_cast<size_t>(blockIdx.x) * m * m;
    float* dst = w + static_cast<size_t>(blockIdx.x) * m;

    // every entry loaded at once (the loads in flight together), the block
    // non-finite if any is; each entry of the lower triangle (i >= j) goes to
    // the upper one, at[j * kLd + i]
    const int mm = m * m, warp = tid >> 5, warps = nt >> 5;
    const float inv_m = 1.f / static_cast<float>(m);
    float v[kLoads];
    int at[kLoads];                  // -1 above the diagonal and past the block
    unsigned diag = 0;               // the loads on the diagonal, by bit
    bool finite = true;
    float amax = 0.f;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
        const int idx = tid + u * nt;
        // row i of entry idx, exactly: (idx + 0.5) / m is >= 1 / 64 from an integer
        const int i = static_cast<int>((idx + 0.5f) * inv_m), j = idx - i * m;
        v[u] = idx < mm ? src[idx] : 0.f;
        finite = finite && fabsf(v[u]) < INFINITY;   // false for NaN and +-inf
        at[u] = idx < mm && i >= j ? j * kLd + i : -1;
        diag |= (i == j ? 1u : 0u) << u;
        amax = fmaxf(amax, at[u] >= 0 ? fabsf(v[u]) : 0.f);
    }
    // non-negative floats order as their bits
    amax = __uint_as_float(__reduce_max_sync(kFull, __float_as_uint(amax)));
    if ((tid & 31) == 0) st.start[0][warp] = amax;
    if (!__syncthreads_and(finite)) {
        if (tid < m) dst[tid] = __int_as_float(0x7fc00000);
        return;
    }
#pragma unroll
    for (int wi = 0; wi < kMaxWarps; ++wi)
        if (wi < warps) amax = fmaxf(amax, st.start[0][wi]);
    int expo = 0;
    if (amax > 0.f) frexpf(amax, &expo);
    expo = max(-100, min(100, expo));          // a normal scale at any amax
    const float scale = pow2(-expo);           // amax * scale in [0.5, 1) mostly
    // the scaled entries, the padding zero; off^2 and the diagonal's squares
    float diag2 = 0.f, off2 = 0.f;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
        const float x = at[u] >= 0 ? v[u] * scale : 0.f;
        if (at[u] >= 0) st.a[at[u]] = x;
        const bool d = (diag >> u) & 1u;
        diag2 = fmaf(d ? x : 0.f, x, diag2);
        off2 = fmaf(d ? 0.f : x, x, off2);
    }
    for (int p = m; p < n; ++p)
        for (int j = tid; j <= p; j += nt) st.a[j * kLd + p] = 0.f;
    for (int o = 16; o > 0; o >>= 1) {
        off2 += __shfl_xor_sync(kFull, off2, o);
        diag2 += __shfl_xor_sync(kFull, diag2, o);
    }
    if ((tid & 31) == 0) {
        st.start[1][warp] = off2;
        st.start[2][warp] = diag2;
    }
    __syncthreads();
    off2 = diag2 = 0.f;
#pragma unroll
    for (int wi = 0; wi < kMaxWarps; ++wi) {
        if (wi < warps) {
            off2 += st.start[1][wi];
            diag2 += st.start[2][wi];
        }
    }
    off2 *= 2.f;
    const float tol2 = kEps * kEps * (diag2 + off2);

    if (off2 > tol2) {
        // round 0's rotations, and each pair-block's entries into its planes
        // (slot = index at the start)
        if (tid < h)
            st.rot[0][tid] = rotation(st.a[2 * tid * (kLd + 1)], st.a[(2 * tid + 1) * (kLd + 1)],
                                      st.a[2 * tid * (kLd + 1) + 1]);
        BlockPlan b;
        plan_block(b, tid < blocks ? tid : -1, h);
        if (b.id >= 0) {
            const float* row0 = st.a + 2 * b.k * kLd + 2 * b.l;
            st.x[0][0][b.id] = row0[0];
            st.x[0][1][b.id] = row0[1];
            st.x[0][2][b.id] = row0[kLd];
            st.x[0][3][b.id] = row0[kLd + 1];
        }
        // where the zero that pair tid's a_pq becomes sits next round
        const int zero = tid < h && h > 1
                             ? plane_offset(next_slot(2 * tid, h), next_slot(2 * tid + 1, h), h)
                             : -1;
        __syncthreads();
        int g = 0;                                    // rounds run
        for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
            float part = 0.f;                         // off^2 / 2 after the sweep
            for (int r = 0; r < n - 1; ++r, ++g) {
                const bool last = r == n - 2;
                const float* cur = &st.x[g & 1][0][0];
                float* nxt = &st.x[(g + 1) & 1][0][0];
                if (b.id >= 0) {
                    const float4 rk = st.rot[g & 1][b.k], rl = st.rot[g & 1][b.l];
                    float x00 = cur[b.id], x01 = cur[kMaxBlocks + b.id],
                          x10 = cur[2 * kMaxBlocks + b.id], x11 = cur[3 * kMaxBlocks + b.id];
                    rotate_block(rk, rl, x00, x01, x10, x11);
                    if (last) part += x00 * x00 + x01 * x01 + x10 * x10 + x11 * x11;
                    if (b.own >= 0) {
                        const int e = b.own;
                        const float v = e == 0 ? x00 : e == 1 ? x01 : e == 2 ? x10 : x11;
                        const float drow = e < 2 ? rk.z : rk.w, dcol = (e & 1) ? rl.w : rl.z;
                        st.rot[(g + 1) & 1][b.next] =
                            rotation(b.swap ? dcol : drow, b.swap ? drow : dcol, v);
                    }
                    if (b.own != 0) nxt[b.dst[0]] = x00;
                    if (b.own != 1) nxt[b.dst[1]] = x01;
                    if (b.own != 2) nxt[b.dst[2]] = x10;
                    if (b.own != 3) nxt[b.dst[3]] = x11;
                }
                if (zero >= 0) nxt[zero] = 0.f;
                if (!last) __syncthreads();
            }
            if (2.f * block_sum(part, st.red[sweep & 1]) <= tol2) break;
        }
        if (tid < h) {                                // the last round's closed forms
            const float4 fin = st.rot[(g - 1) & 1][tid];
            st.a[next_slot(2 * tid, h) * (kLd + 1)] = fin.z;
            st.a[next_slot(2 * tid + 1, h) * (kLd + 1)] = fin.w;
        }
        __syncthreads();
    }

    if (tid < m) {
        const float d = st.a[tid * (kLd + 1)];
        int rank = 0;
#pragma unroll 4
        for (int j = 0; j < m; ++j) {
            const float e = st.a[j * (kLd + 1)];
            rank += (e < d || (e == d && j < tid)) ? 1 : 0;
        }
        dst[rank] = d * pow2(expo);            // exact, as the scaling was
    }
}

// One CUDA block of 64 threads (K6's at m = 19) running `steps` dependent
// rounds shaped like K6's on fixed data, with nothing else: a barrier, each
// of 45 threads loads 4 entries and 2 rotations from shared memory (without
// bank conflicts) and rotates its block, 10 of them form a rotation from the
// result, each stores its entries.  The rotation's a_pq is offset by 2 so
// that it never falls to the skip below 2^-60 (the blocks stay on the unit
// sphere, being only rotated).  0 steps is an empty kernel.
__global__ void eig_probe_kernel(float* out, int steps) {
    constexpr int kThreads = 64, kBlocks = 45, kPairs = 10;
    __shared__ float a[4 * kThreads];
    __shared__ float4 rot[2][kPairs];
    const int tid = threadIdx.x;
    const int k = tid % kPairs, l = (k + 1 + tid / kPairs) % kPairs;
    for (int i = tid; i < 4 * kThreads; i += kThreads) a[i] = 1.f + 1e-3f * i;
    if (tid < kPairs) rot[0][tid] = make_float4(0.8f, 0.6f, 1.f, 1.f);
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
        if (tid < kBlocks) {
            const float4 rk = rot[s & 1][k], rl = rot[s & 1][l];
            float x00 = a[tid], x01 = a[kThreads + tid], x10 = a[2 * kThreads + tid],
                  x11 = a[3 * kThreads + tid];
            rotate_block(rk, rl, x00, x01, x10, x11);
            if (tid < kPairs) rot[(s + 1) & 1][tid] = rotation(x00, x11, x01 + 2.f);
            a[tid] = x00;
            a[kThreads + tid] = x01;
            a[2 * kThreads + tid] = x10;
            a[3 * kThreads + tid] = x11;
        }
        __syncthreads();
    }
    out[tid] = a[tid];
}

}  // namespace

extern "C" int trajopt_eigvalsh(const float* h, float* w, int batch, int m, void* stream) {
    if (batch <= 0) return static_cast<int>(cudaGetLastError());
    if (m < 1 || m > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
    const int half = padded(m) / 2, blocks = half * (half - 1) / 2;
    const int threads = blocks <= 32 ? 32 : (blocks + 31) / 32 * 32;
    const int loads = (m * m + threads - 1) / threads;   // at most 9 for m <= 32
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (loads <= 2) eigvalsh_kernel<2><<<batch, threads, 0, s>>>(h, w, m);
    else if (loads <= 4) eigvalsh_kernel<4><<<batch, threads, 0, s>>>(h, w, m);
    else if (loads <= 6) eigvalsh_kernel<6><<<batch, threads, 0, s>>>(h, w, m);
    else eigvalsh_kernel<9><<<batch, threads, 0, s>>>(h, w, m);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int trajopt_eig_probe(float* out, int steps, void* stream) {
    eig_probe_kernel<<<1, 64, 0, static_cast<cudaStream_t>(stream)>>>(out, steps);
    return static_cast<int>(cudaGetLastError());
}
