// K1: batched smallest-k selection (values + int64 indices), ascending.
//
// Replaces trajopt_tpu/ops/pallas_topk.py::_select_kernel (k rounds of
// min-extraction over an [n, 128] VMEM tile, rows on lanes).  Semantics are
// those of a stable ascending sort: distinct indices, ties to the lowest
// index, -0.0 tied with +0.0 (ordered by index, each output keeping the
// input's own float), +inf after every finite value, NaN after +inf.
//
// Every element maps to a 32-bit order-preserving key (float_key) and, with
// its index, to a distinct 64-bit composite key (key << 32 | index).
//
// Bound on the card: each row is read once (n floats) and k values and
// indices are written, a few microseconds of bytes at the solver's shapes;
// what costs is latency, so each route keeps its dependent chain short.
// Three routes, chosen by shape in ops/cuda_topk.py::route:
//  - "warp"   (n <= 256, k <= 32): one warp per row, four rows a block.
//    Each lane holds its ceil(n/32) composite keys in registers, sorted; a
//    round is two warp min-reductions (redux.sync) on the lanes' heads and
//    the winning lane advances in its registers.  No block barrier, no
//    re-read.  A round costs ~0.1 us, so a larger k takes the radix route.
//  - "radix"  (other rows, k <= 1024): one block per row.  The row is loaded
//    once into dynamic shared memory (kept in device memory when it does not
//    fit); up to four MSB-first passes of 8 bits with a 256-bin shared
//    histogram (warp-aggregated atomics; a warp with no key of the current
//    prefix skips them) find the k-th key T and how many keys lie below
//    it, stopping early once the k-th key's bin is taken whole; one gather
//    pass takes every key < T and the first keys == T in index order (a
//    block exclusive scan over contiguous per-thread chunks); the k
//    composites are ordered by counting ranks.
//  - "rounds" (k > 1024): k rounds of block-wide argmin, each
//    round taking the lexicographic successor of the last pick (the first
//    design of this kernel).  The solver never calls it; it keeps any
//    k <= n working.
// Nothing is written to the input, so an index never repeats (the TPU kernel
// wrote +inf over taken entries and could repeat an index once a row ran
// out of finite values).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using u64 = unsigned long long;  // the type the shuffles are overloaded on
constexpr u64 kNone = ~0ull;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarpRowsPerBlock = 4;

__device__ __forceinline__ uint32_t float_key(float x) {
    if (x != x) return 0xFFFFFFFFu;          // NaN sorts after +inf
    x = x + 0.0f;                            // -0.0 and +0.0 compare equal
    uint32_t u = __float_as_uint(x);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ u64 composite(float x, int i) {
    return (static_cast<u64>(float_key(x)) << 32) | static_cast<uint32_t>(i);
}

// ---------------------------------------------------------------- warp route

template <int S>
__global__ void __launch_bounds__(32 * kWarpRowsPerBlock)
smallest_k_warp_kernel(const float* __restrict__ x, float* __restrict__ vals,
                       int64_t* __restrict__ idx, int rows, int n, int k) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarpRowsPerBlock + (threadIdx.x >> 5);
    if (row >= rows) return;                 // the whole warp leaves together
    const float* xr = x + static_cast<size_t>(row) * n;
    float* vr = vals + static_cast<size_t>(row) * k;
    int64_t* ir = idx + static_cast<size_t>(row) * k;

    // element s * 32 + lane sits in slot s; padding keys sort after NaN
    u64 key[S];
    float val[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const int i = s * 32 + lane;
        val[s] = i < n ? xr[i] : 0.f;
        key[s] = i < n ? composite(val[s], i) : kNone;
    }
#pragma unroll
    for (int p = 0; p < S; ++p) {            // odd-even transposition sort
#pragma unroll
        for (int s = p & 1; s + 1 < S; s += 2) {
            if (key[s + 1] < key[s]) {
                const u64 tk = key[s];
                key[s] = key[s + 1];
                key[s + 1] = tk;
                const float tv = val[s];
                val[s] = val[s + 1];
                val[s + 1] = tv;
            }
        }
    }
    for (int j = 0; j < k; ++j) {
        // lexicographic min of the heads: the least key, then the least
        // index among the heads that hold it (indices are distinct)
        const uint32_t hi = static_cast<uint32_t>(key[0] >> 32);
        const uint32_t lo = static_cast<uint32_t>(key[0]);
        const uint32_t min_hi = __reduce_min_sync(kFull, hi);
        const uint32_t min_lo = __reduce_min_sync(kFull, hi == min_hi ? lo : 0xFFFFFFFFu);
        if (hi == min_hi && lo == min_lo) {
            vr[j] = val[0];
            ir[j] = lo;
#pragma unroll
            for (int s = 0; s + 1 < S; ++s) {
                key[s] = key[s + 1];
                val[s] = val[s + 1];
            }
            key[S - 1] = kNone;
        }
    }
}

// --------------------------------------------------------------- radix route

constexpr int kRadixMaxThreads = 1024;

// Dynamic shared memory of the radix route, in this order: two 256-bin
// histograms, the pass state, 32 warp sums, the k composites, then the row
// when it fits.
constexpr int kHistBytes = 2 * 256 * 4;
constexpr int kStateBytes = 16;
constexpr int kWarpSumBytes = 32 * 8;
constexpr int kRadixFixedBytes = kHistBytes + kStateBytes + kWarpSumBytes;

__device__ __forceinline__ u64 warp_inclusive_scan(u64 v, int lane) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const u64 o = __shfl_up_sync(kFull, v, off);
        if (lane >= off) v += o;
    }
    return v;
}

__global__ void __launch_bounds__(kRadixMaxThreads)
smallest_k_radix_kernel(const float* __restrict__ x, float* __restrict__ vals,
                        int64_t* __restrict__ idx, int n, int k, int row_in_smem) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint32_t* hist = reinterpret_cast<uint32_t*>(smem);
    uint32_t* state = hist + 512;
    u64* warp_sum = reinterpret_cast<u64*>(smem + kHistBytes + kStateBytes);
    u64* buf = warp_sum + 32;
    float* srow = reinterpret_cast<float*>(buf + k);

    const int tid = threadIdx.x, nt = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5;
    const float* xr = x + static_cast<size_t>(blockIdx.x) * n;
    float* vr = vals + static_cast<size_t>(blockIdx.x) * k;
    int64_t* ir = idx + static_cast<size_t>(blockIdx.x) * k;

    for (int b = tid; b < 512; b += nt) hist[b] = 0;
    const float* row = xr;
    if (row_in_smem) {
        for (int i = tid; i < n; i += nt) srow[i] = xr[i];
        row = srow;
    }
    __syncthreads();

    // MSB-first digit passes: after pass p the top 8(p+1) bits of the k-th
    // key T are in `prefix` (the bits `known` covers), and `need` is T's
    // rank among the keys that share them.  When the chosen bin holds
    // exactly `need` keys, every key of it is taken and the passes stop.
    uint32_t prefix = 0, need = static_cast<uint32_t>(k), known = 0;
    for (int p = 0; p < 4; ++p) {
        const int shift = 24 - 8 * p;
        uint32_t* h = hist + (p & 1) * 256;
        for (int base = 0; base < n; base += nt) {     // uniform trip count
            const int i = base + tid;
            uint32_t digit = 256;                      // no bin
            if (i < n) {
                const uint32_t key = float_key(row[i]);
                if (((key ^ prefix) & known) == 0) digit = (key >> shift) & 255u;
            }
            // past the first pass most warps hold no key of the prefix
            if (__ballot_sync(kFull, digit < 256) == 0) continue;
            const unsigned peers = __match_any_sync(kFull, digit);
            if (digit < 256 && lane == __ffs(peers) - 1) atomicAdd(&h[digit], __popc(peers));
        }
        // the other histogram was read by the previous pass's pick, which
        // finished before that pass's last barrier
        if (p > 0)
            for (int b = tid; b < 256; b += nt) hist[((p + 1) & 1) * 256 + b] = 0;
        __syncthreads();
        if (warp == 0) {                         // pick the digit holding rank `need`
            uint32_t c[8], sum = 0;
#pragma unroll
            for (int b = 0; b < 8; ++b) {
                c[b] = h[lane * 8 + b];
                sum += c[b];
            }
            const uint32_t incl = static_cast<uint32_t>(warp_inclusive_scan(sum, lane));
            uint32_t below = incl - sum;
            if (below < need && need <= incl) {
                uint32_t d = 0, count = 0;
                bool found = false;
#pragma unroll
                for (int b = 0; b < 8; ++b) {
                    if (!found) {
                        if (below + c[b] >= need) {
                            d = lane * 8 + b;
                            count = c[b];
                            found = true;
                        } else {
                            below += c[b];
                        }
                    }
                }
                state[0] = prefix | (d << shift);
                state[1] = need - below;
                state[2] = count == need - below;      // the bin is taken whole
            }
        }
        __syncthreads();
        prefix = state[0];
        need = state[1];
        known = 0xFFFFFFFFu << shift;
        if (state[2]) break;                           // uniform
    }

    // gather: the lt = k - need keys whose known bits lie below T's, then the
    // first `need` keys that share them, in index order; thread t owns the
    // contiguous chunk t
    const uint32_t kt = prefix;
    const uint32_t lt = static_cast<uint32_t>(k) - need;
    const int chunk = (n + nt - 1) / nt;
    const int lo = min(n, tid * chunk), hi = min(n, lo + chunk);
    uint32_t c_lt = 0, c_eq = 0;
    for (int i = lo; i < hi; ++i) {
        const uint32_t key = float_key(row[i]) & known;
        c_lt += key < kt;
        c_eq += key == kt;
    }
    const u64 mine = (static_cast<u64>(c_lt) << 32) | c_eq;
    const u64 incl = warp_inclusive_scan(mine, lane);
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        const u64 w = lane < (nt >> 5) ? warp_sum[lane] : 0;
        warp_sum[lane] = warp_inclusive_scan(w, lane) - w;
    }
    __syncthreads();
    const u64 excl = incl - mine + warp_sum[warp];
    uint32_t pos_lt = static_cast<uint32_t>(excl >> 32);
    uint32_t pos_eq = static_cast<uint32_t>(excl);
    if (c_lt > 0 || (c_eq > 0 && pos_eq < need)) {
        for (int i = lo; i < hi; ++i) {
            const float f = row[i];
            const uint32_t key = float_key(f) & known;
            if (key < kt) {
                buf[pos_lt++] = composite(f, i);
            } else if (key == kt) {
                if (pos_eq < need) buf[lt + pos_eq] = composite(f, i);
                ++pos_eq;
            }
        }
    }
    __syncthreads();

    // order the k distinct composites: element e's rank is the number of
    // composites below it, counted by a group of g threads
    int g = 1;
    while (g < 32 && 2 * g * k <= nt) g *= 2;
    const int per_pass = nt / g;
    for (int e0 = 0; e0 < k; e0 += per_pass) {      // uniform trip count
        const int e = e0 + tid / g, part = tid & (g - 1);
        const u64 me = e < k ? buf[e] : 0;
        uint32_t rank = 0;
        if (e < k)
            for (int j = part; j < k; j += g) rank += buf[j] < me;
        for (int off = g >> 1; off > 0; off >>= 1) rank += __shfl_xor_sync(kFull, rank, off);
        if (e < k && part == 0) {
            const uint32_t i = static_cast<uint32_t>(me);
            vr[rank] = row[i];
            ir[rank] = i;
        }
    }
}

// -------------------------------------------------------------- rounds route

__device__ __forceinline__ u64 local_successor(
        const float* __restrict__ xr, int n, u64 after, bool has_after) {
    u64 best = kNone;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const u64 key = composite(xr[i], i);
        if ((!has_after || key > after) && key < best) best = key;
    }
    return best;
}

__device__ __forceinline__ u64 warp_min(u64 v) {
    for (int off = 16; off > 0; off >>= 1) {
        u64 o = __shfl_down_sync(kFull, v, off);
        v = o < v ? o : v;
    }
    return v;
}

__global__ void smallest_k_rounds_kernel(const float* __restrict__ x,
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
        const u64 b = pick;                   // k <= n: never kNone
        if (threadIdx.x == 0) {
            const int i = static_cast<int>(b & 0xFFFFFFFFu);
            vr[j] = xr[i];
            ir[j] = i;
        }
        if (mine == b) mine = local_successor(xr, n, b, true);
    }
}

}  // namespace

// Each entry takes rows of n float32 (0 < k <= n) and writes k values and
// int64 indices per row; ops/cuda_topk.py::route picks the entry.

extern "C" int trajopt_smallest_k_warp(const float* x, float* vals, int64_t* idx,
                                       int rows, int n, int k, void* stream) {
    if (n > 256) return static_cast<int>(cudaErrorInvalidValue);
    if (rows > 0 && k > 0) {
        const dim3 grid((rows + kWarpRowsPerBlock - 1) / kWarpRowsPerBlock);
        const dim3 block(32 * kWarpRowsPerBlock);
        cudaStream_t s = static_cast<cudaStream_t>(stream);
        if (n <= 32)
            smallest_k_warp_kernel<1><<<grid, block, 0, s>>>(x, vals, idx, rows, n, k);
        else if (n <= 64)
            smallest_k_warp_kernel<2><<<grid, block, 0, s>>>(x, vals, idx, rows, n, k);
        else if (n <= 128)
            smallest_k_warp_kernel<4><<<grid, block, 0, s>>>(x, vals, idx, rows, n, k);
        else
            smallest_k_warp_kernel<8><<<grid, block, 0, s>>>(x, vals, idx, rows, n, k);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int trajopt_smallest_k_radix(const float* x, float* vals, int64_t* idx,
                                        int rows, int n, int k, void* stream) {
    static int smem_cap = -1;
    if (smem_cap < 0) {                       // opt in to the card's full 227 KB once
        int dev = 0, cap = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(smallest_k_radix_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
        if (err != cudaSuccess) return static_cast<int>(err);
        smem_cap = cap;
    }
    if (rows > 0 && k > 0) {
        const size_t fixed = kRadixFixedBytes + static_cast<size_t>(k) * 8;
        if (fixed > static_cast<size_t>(smem_cap)) return static_cast<int>(cudaErrorInvalidValue);
        const size_t with_row = fixed + static_cast<size_t>(n) * 4;
        const int row_in_smem = with_row <= static_cast<size_t>(smem_cap);
        int threads = ((n + 3) / 4 + 31) / 32 * 32;   // about four keys a thread
        threads = threads < 128 ? 128 : (threads > kRadixMaxThreads ? kRadixMaxThreads : threads);
        smallest_k_radix_kernel<<<rows, threads, row_in_smem ? with_row : fixed,
                                  static_cast<cudaStream_t>(stream)>>>(
            x, vals, idx, n, k, row_in_smem);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int trajopt_smallest_k_rounds(const float* x, float* vals, int64_t* idx,
                                         int rows, int n, int k, void* stream) {
    if (rows > 0 && k > 0) {
        int threads = ((n + 31) / 32) * 32;
        threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
        smallest_k_rounds_kernel<<<rows, threads, 0, static_cast<cudaStream_t>(stream)>>>(
            x, vals, idx, n, k);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trajopt_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
