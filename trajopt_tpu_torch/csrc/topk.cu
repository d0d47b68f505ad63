// K1: batched smallest-k selection (values + int64 indices), ascending.
//
// Replaces trajopt_tpu/ops/pallas_topk.py::_select_kernel (k rounds of
// min-extraction over an [n, 128] VMEM tile, rows on lanes).  Semantics are
// those of `lax.top_k` on the negated row, i.e. of a stable ascending sort:
// distinct indices, ties to the lowest index, +inf after every finite value,
// NaN after +inf.
//
// Bound on the card: each row is read once from device memory (n floats),
// then the k rounds are a chain of block-wide reductions, so a row costs
// about k reduction latencies; rows run in parallel, one block each.
// Design: every element maps to a distinct 64-bit key (order-preserving
// float bits << 32 | index).  Each thread keeps the smallest key of its own
// strided slice that lies above the last pick; a round reduces those
// candidates over the block, and only the thread that owned the pick
// rescans its slice.  Nothing is written to the input, so an index can
// never repeat (the TPU kernel wrote +inf over taken entries and could
// repeat an index once a row ran out of finite values).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using u64 = unsigned long long;  // the type __shfl_down_sync is overloaded on
constexpr u64 kNone = ~0ull;

__device__ __forceinline__ uint32_t float_key(float x) {
    if (x != x) return 0xFFFFFFFFu;          // NaN sorts after +inf
    x = x + 0.0f;                            // -0.0 and +0.0 compare equal
    uint32_t u = __float_as_uint(x);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ u64 local_successor(
        const float* __restrict__ xr, int n, u64 after, bool has_after) {
    u64 best = kNone;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        u64 key = (static_cast<u64>(float_key(xr[i])) << 32) |
                       static_cast<uint32_t>(i);
        if ((!has_after || key > after) && key < best) best = key;
    }
    return best;
}

__device__ __forceinline__ u64 warp_min(u64 v) {
    for (int off = 16; off > 0; off >>= 1) {
        u64 o = __shfl_down_sync(0xFFFFFFFFu, v, off);
        v = o < v ? o : v;
    }
    return v;
}

__global__ void smallest_k_kernel(const float* __restrict__ x,
                                  float* __restrict__ vals,
                                  int64_t* __restrict__ idx, int n, int k) {
    __shared__ u64 warp_best[32];
    __shared__ u64 pick;
    const float* xr = x + static_cast<size_t>(blockIdx.x) * n;
    float* vr = vals + static_cast<size_t>(blockIdx.x) * k;
    int64_t* ir = idx + static_cast<size_t>(blockIdx.x) * k;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_warps = (blockDim.x + 31) >> 5;

    u64 mine = local_successor(xr, n, 0, false);
    for (int j = 0; j < k; ++j) {
        u64 w = warp_min(mine);
        if (lane == 0) warp_best[warp] = w;
        __syncthreads();
        if (warp == 0) {
            u64 b = lane < n_warps ? warp_best[lane] : kNone;
            b = warp_min(b);
            if (lane == 0) pick = b;
        }
        __syncthreads();
        const u64 b = pick;
        if (threadIdx.x == 0) {
            if (b == kNone) {                 // k > live entries: cannot occur for k <= n
                vr[j] = __int_as_float(0x7F800000);
                ir[j] = n - 1;
            } else {
                const int i = static_cast<int>(b & 0xFFFFFFFFu);
                vr[j] = xr[i];
                ir[j] = i;
            }
        }
        if (b != kNone && mine == b) mine = local_successor(xr, n, b, true);
    }
}

}  // namespace

extern "C" int trajopt_smallest_k(const float* x, float* vals, int64_t* idx,
                                  int rows, int n, int k, void* stream) {
    if (rows > 0 && k > 0) {
        int threads = ((n + 31) / 32) * 32;
        threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
        smallest_k_kernel<<<rows, threads, 0, static_cast<cudaStream_t>(stream)>>>(
            x, vals, idx, n, k);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trajopt_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
