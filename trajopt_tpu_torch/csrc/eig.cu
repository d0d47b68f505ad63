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
// of them a call (76 KB to 5.9 MB), and the work a block needs is a few
// Jacobi sweeps of (4/3) m^3 operations each, so neither bytes nor
// operations are what a call waits for: one warp runs about 6-8 sweeps of
// m rounds, each round a chain of shared-memory loads, a division and a
// square root, and four warp barriers.  A simple kernel that is right
// comes first here; making it fast is later work.
//
// Algorithm: parallel cyclic Jacobi, one warp per block.  The block (its
// lower triangle, mirrored, as `torch.linalg.eigvalsh` reads it) is staged
// in shared memory with row stride 33, so that rows and columns are both
// read without bank conflicts, and padded to an even order n with a zero
// row and column (which no rotation then touches).  A sweep is n - 1
// rounds of n / 2 disjoint rotations in round-robin order (the circle
// method, as in Brent and Luk's parallel Jacobi: index 0 fixed, the others
// turning), so that each pair (p, q) meets once a sweep.  In a round, lane k
// < n / 2 forms pair k's stable 2 x 2 symmetric Schur rotation:
// tau = (a_qq - a_pp) / (2 a_pq), t = sign(tau) / (|tau| + sqrt(1 + tau^2)),
// c = 1 / sqrt(1 + t^2), s = t c; then every lane j applies all row
// rotations to column j, then every lane i all column rotations to row i
// (the rotations are disjoint, so the order within a pass does not
// matter), and last the pair lanes set a_pp - t a_pq, a_qq + t a_pq and
// a_pq = 0, which keeps every off-diagonal entry a combination of
// off-diagonal entries and the convergence quadratic in float32.
//
// Stopping: before each sweep the warp sums the off-diagonal squares and
// stops when they are <= eps^2 |A|_F^2 (eps = 2^-23), a warp-uniform vote,
// or after kMaxSweeps sweeps.  The block is first scaled by a power of two
// near 1 / max|a_ij|, which is exact and keeps the squares from
// overflowing or underflowing at any scale.  Last, each lane ranks its
// diagonal entry among the others (ties by index) and writes it there:
// ascending, as the plain version returns them.  A block with a non-finite
// entry gives NaN for every eigenvalue.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxM = 32;
constexpr int kLd = kMaxM + 1;       // row stride of the staged block
constexpr int kWarps = 4;            // blocks of the batch per CUDA block
constexpr int kMaxSweeps = 15;
constexpr float kEps = 1.1920929e-7f;

struct WarpStage {
    float a[kMaxM * kLd];
    float c[kMaxM / 2], s[kMaxM / 2], dp[kMaxM / 2], dq[kMaxM / 2];
    int p[kMaxM / 2], q[kMaxM / 2];
};

__device__ __forceinline__ float warp_sum(float v) {
    // a butterfly: every lane ends with the same sum, bit for bit
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
    return v;
}

// pair k of round r of the circle method on n indices (0 <= r < n - 1)
__device__ __forceinline__ void round_pair(int n, int r, int k, int& p, int& q) {
    if (k == 0) {
        p = 0;
        q = 1 + r;
        return;
    }
    int x = r + k, y = r - k;
    if (x >= n - 1) x -= n - 1;
    if (y < 0) y += n - 1;
    p = 1 + min(x, y);
    q = 1 + max(x, y);
}

__global__ void __launch_bounds__(32 * kWarps)
eigvalsh_kernel(const float* __restrict__ h, float* __restrict__ w, int batch, int m) {
    __shared__ WarpStage stage[kWarps];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int b = blockIdx.x * kWarps + warp;
    if (b >= batch) return;                      // the whole warp leaves together
    WarpStage& st = stage[warp];
    float* a = st.a;
    const int n = m + (m & 1);
    const float* src = h + static_cast<size_t>(b) * m * m;
    float* dst = w + static_cast<size_t>(b) * m;

    bool finite = true;
    for (int idx = lane; idx < m * m; idx += 32) {
        const int i = idx / m, j = idx - i * m;
        const float v = src[idx];
        finite = finite && fabsf(v) < INFINITY;   // false for NaN and +-inf
        a[i * kLd + j] = v;
    }
    if (!__all_sync(kFull, finite)) {
        if (lane < m) dst[lane] = __int_as_float(0x7fc00000);
        return;
    }
    __syncwarp();
    // mirror the lower triangle (reads below the diagonal, writes above it)
    // and zero the padding row and column
    float amax = 0.f;
    if (lane < n) {
        for (int j = 0; j < n; ++j) {
            float v;
            if (lane >= m || j >= m) {
                v = 0.f;
                a[lane * kLd + j] = v;
            } else if (j > lane) {
                v = a[j * kLd + lane];
                a[lane * kLd + j] = v;
            } else {
                v = a[lane * kLd + j];
            }
            amax = fmaxf(amax, fabsf(v));
        }
    }
    amax = warp_max(amax);
    int expo = 0;
    if (amax > 0.f) frexpf(amax, &expo);
    expo = max(-100, min(100, expo));          // a normal scale at any amax
    const float scale = ldexpf(1.f, -expo);    // amax * scale in [0.5, 1) mostly
    float fro2 = 0.f;
    __syncwarp();
    if (lane < n) {
        for (int j = 0; j < n; ++j) {
            const float v = a[lane * kLd + j] * scale;
            a[lane * kLd + j] = v;
            fro2 += v * v;
        }
    }
    fro2 = warp_sum(fro2);
    const float tol2 = kEps * kEps * fro2;
    __syncwarp();

    for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
        float off2 = 0.f;
        if (lane < n) {
            for (int j = 0; j < n; ++j) {
                const float v = a[lane * kLd + j];
                off2 += j == lane ? 0.f : v * v;
            }
        }
        off2 = warp_sum(off2);
        if (__all_sync(kFull, off2 <= tol2)) break;
        for (int r = 0; r < n - 1; ++r) {
            if (lane < n / 2) {
                int p, q;
                round_pair(n, r, lane, p, q);
                const float app = a[p * kLd + p], aqq = a[q * kLd + q], apq = a[p * kLd + q];
                float c = 1.f, s = 0.f, t = 0.f;
                if (apq != 0.f) {
                    const float tau = (aqq - app) / (2.f * apq);
                    t = (tau >= 0.f ? 1.f : -1.f) / (fabsf(tau) + hypotf(1.f, tau));
                    c = 1.f / sqrtf(1.f + t * t);
                    s = t * c;
                }
                st.p[lane] = p;
                st.q[lane] = q;
                st.c[lane] = c;
                st.s[lane] = s;
                st.dp[lane] = app - t * apq;
                st.dq[lane] = aqq + t * apq;
            }
            __syncwarp();
            if (lane < n) {                      // rows p and q, column ``lane``
                for (int k = 0; k < n / 2; ++k) {
                    const int p = st.p[k], q = st.q[k];
                    const float c = st.c[k], s = st.s[k];
                    const float x = a[p * kLd + lane], y = a[q * kLd + lane];
                    a[p * kLd + lane] = c * x - s * y;
                    a[q * kLd + lane] = s * x + c * y;
                }
            }
            __syncwarp();
            if (lane < n) {                      // columns p and q, row ``lane``
                for (int k = 0; k < n / 2; ++k) {
                    const int p = st.p[k], q = st.q[k];
                    const float c = st.c[k], s = st.s[k];
                    const float x = a[lane * kLd + p], y = a[lane * kLd + q];
                    a[lane * kLd + p] = c * x - s * y;
                    a[lane * kLd + q] = s * x + c * y;
                }
            }
            __syncwarp();
            if (lane < n / 2) {
                const int p = st.p[lane], q = st.q[lane];
                a[p * kLd + p] = st.dp[lane];
                a[q * kLd + q] = st.dq[lane];
                a[p * kLd + q] = 0.f;
                a[q * kLd + p] = 0.f;
            }
            __syncwarp();
        }
    }

    if (lane < m) {
        const float d = a[lane * kLd + lane];
        int rank = 0;
        for (int j = 0; j < m; ++j) {
            const float e = a[j * kLd + j];
            rank += (e < d || (e == d && j < lane)) ? 1 : 0;
        }
        dst[rank] = ldexpf(d, expo);
    }
}

}  // namespace

extern "C" int trajopt_eigvalsh(const float* h, float* w, int batch, int m, void* stream) {
    if (batch <= 0) return static_cast<int>(cudaGetLastError());
    if (m < 1 || m > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = (batch + kWarps - 1) / kWarps;
    eigvalsh_kernel<<<blocks, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(h, w, batch, m);
    return static_cast<int>(cudaGetLastError());
}
