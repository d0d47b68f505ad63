// K3: batched GMW81 modified Cholesky (or plain Cholesky) of m x m blocks.
// K4: batched forward + backward substitution for L L^T x = b.
//
// K3 replaces trajopt_tpu/ops/pallas_chol.py::_chol_kernel and K4 its
// _solve_kernel (blocks on the 128 TPU lanes, the m-step recurrence
// unrolled as [m, 128] vector ops).  Plain versions: ops/smallchol.py
// (mod_cholesky, cholesky, cho_solve).
//
// Bound on the card: latency.  The solver's blocks are 19 x 19 (a few per
// robot) and the reduced KKT is at most 64 x 64, so a factorization is m
// dependent column steps of a few hundred flops each, and there are few
// blocks.  Design: one warp per block (m <= 64, so <= 16 KB of shared
// memory), the matrix in shared memory, each column step a warp-wide max
// (GMW pivot rule) plus a right-looking update of the lower trailing
// triangle; warp-synchronous, so no block barriers.  K4 runs one warp per
// (matrix, right-hand side) with column-oriented substitution.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxM = 64;

__device__ __forceinline__ float warp_max(float v) {
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, off));
    return v;
}

__global__ void mod_chol_kernel(const float* __restrict__ h, float* __restrict__ lout,
                                float* __restrict__ eout, int m, int gmw, float nf) {
    __shared__ float a[kMaxM * kMaxM];
    __shared__ float col[kMaxM];
    const int lane = threadIdx.x;
    const size_t base = static_cast<size_t>(blockIdx.x) * m * m;
    const float* hb = h + base;
    float* lb = lout + base;
    float* eb = eout + static_cast<size_t>(blockIdx.x) * m;
    for (int t = lane; t < m * m; t += 32) {
        a[t] = hb[t];
        lb[t] = 0.f;
    }
    __syncwarp();

    const float eps = 1.19e-7f;
    float beta2 = 0.f, delta = 0.f;
    if (gmw) {
        float gam = 0.f, off = 0.f;
        for (int t = lane; t < m * m; t += 32) {
            const float v = fabsf(a[t]);
            if (t / m == t % m) gam = fmaxf(gam, v);
            else off = fmaxf(off, v);
        }
        gam = warp_max(gam);
        off = warp_max(off);
        beta2 = fmaxf(fmaxf(gam, off / nf), eps);
        delta = eps * fmaxf(gam + off, 1.f);
    }

    for (int j = 0; j < m; ++j) {
        const float dorig = a[j * m + j];
        float dnew = dorig;
        if (gmw) {
            float theta = 0.f;
            for (int i = j + 1 + lane; i < m; i += 32) theta = fmaxf(theta, fabsf(a[i * m + j]));
            theta = warp_max(theta);
            dnew = fmaxf(fmaxf(fabsf(dorig), theta * theta / beta2), delta);
        }
        const float piv = sqrtf(dnew);   // plain Cholesky: NaN on a non-PD pivot
        if (lane == 0) {
            eb[j] = gmw ? dnew - dorig : 0.f;
            lb[j * m + j] = piv;
        }
        for (int i = j + 1 + lane; i < m; i += 32) {
            const float c = a[i * m + j] / piv;
            col[i] = c;
            lb[i * m + j] = c;
        }
        __syncwarp();
        // lower trailing triangle: a[i][k] -= col[i] col[k], j < k <= i
        const int r = m - j - 1;
        for (int t = lane; t < r * r; t += 32) {
            const int i = j + 1 + t / r, k = j + 1 + t % r;
            if (k <= i) a[i * m + k] -= col[i] * col[k];
        }
        __syncwarp();
    }
}

__global__ void chol_solve_kernel(const float* __restrict__ l, const float* __restrict__ rhs,
                                  float* __restrict__ x, int m, int nrhs) {
    __shared__ float lm[kMaxM * kMaxM];
    __shared__ float r[kMaxM];
    const int lane = threadIdx.x;
    const int b = blockIdx.x, c = blockIdx.y;
    const float* lbk = l + static_cast<size_t>(b) * m * m;
    for (int t = lane; t < m * m; t += 32) lm[t] = lbk[t];
    for (int i = lane; i < m; i += 32) r[i] = rhs[(static_cast<size_t>(b) * m + i) * nrhs + c];
    __syncwarp();
    for (int i = 0; i < m; ++i) {              // L y = b
        const float yi = r[i] / lm[i * m + i];
        __syncwarp();
        if (lane == 0) r[i] = yi;
        for (int t = i + 1 + lane; t < m; t += 32) r[t] -= lm[t * m + i] * yi;
        __syncwarp();
    }
    for (int i = m - 1; i >= 0; --i) {         // L^T x = y
        const float xi = r[i] / lm[i * m + i];
        __syncwarp();
        if (lane == 0) r[i] = xi;
        for (int t = lane; t < i; t += 32) r[t] -= lm[i * m + t] * xi;
        __syncwarp();
    }
    for (int i = lane; i < m; i += 32) x[(static_cast<size_t>(b) * m + i) * nrhs + c] = r[i];
}

}  // namespace

extern "C" int trajopt_mod_chol(const float* h, float* l, float* e, int batch, int m,
                                int gmw, float nf, void* stream) {
    if (m > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
    if (batch > 0 && m > 0)
        mod_chol_kernel<<<batch, 32, 0, static_cast<cudaStream_t>(stream)>>>(h, l, e, m, gmw, nf);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int trajopt_chol_solve(const float* l, const float* rhs, float* x, int batch,
                                  int m, int nrhs, void* stream) {
    if (m > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
    if (batch > 0 && m > 0 && nrhs > 0) {
        dim3 grid(batch, nrhs);
        chol_solve_kernel<<<grid, 32, 0, static_cast<cudaStream_t>(stream)>>>(l, rhs, x, m, nrhs);
    }
    return static_cast<int>(cudaGetLastError());
}
