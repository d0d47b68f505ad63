// K3: batched GMW81 modified Cholesky (or plain Cholesky) of m x m blocks.
// K4: batched forward + backward substitution for L L^T x = b.
// Fused: K3 then K4 in one launch, the factor never leaving the registers.
//
// K3 replaces trajopt_tpu/ops/pallas_chol.py::_chol_kernel and K4 its
// _solve_kernel (blocks on the 128 TPU lanes, the m-step recurrence
// unrolled as [m, 128] vector ops).  Plain versions: ops/smallchol.py
// (mod_cholesky, cholesky, cho_solve).
//
// Bound on the card: latency.  The solver's blocks are 19 x 19 (a few per
// robot) and the reduced KKT is at most 64 x 64, in batches of 1 to a few
// hundred, so a call moves a few hundred KB at most and a factorization is
// m dependent column steps (pivot, square root, division, update), a solve
// 2m (division, update).  Neither bytes nor flops matter; what the design
// shortens is the dependent chain of one step and the number of launches.
// `wgmma` and TMA have nothing to do here: the tensor cores want 64-row
// tiles of a product with no dependence between its steps, while every
// column step here waits for the last one's square root and division, in
// float32, on a block smaller than one tile; and TMA's descriptor and
// barrier round trip costs more than the 1.4 KB (19 x 19) to 16 KB
// (64 x 64) block it would fetch, which one coalesced pass of a warp
// brings in.
//
// Design: one warp per factorization, up to four warps (blocks of the batch,
// or right-hand sides of one block) per CUDA block. K3: lane i holds row i
// of the trailing matrix in registers (two rows a lane, i and i + 32, for 32
// < m <= 64), both triangles kept up to date, so that the pivot column is
// one register of every lane. The row is a sliding window: going into step
// j, register t holds entry (i, j + t), and the update writes each entry one
// register to the left. Every step therefore runs the same instructions on
// the same registers, and the m steps are a rolled loop whose body (one
// shuffle and one fused multiply-add per register of the padded width COLS,
// a template parameter that `cuda_chol.route` picks from m) stays in the
// instruction cache. (Unrolling the m steps over fixed registers instead was
// built and measured: each instruction then runs once, and at m = 33 it was
// slower than the first design, as a warp waiting on instruction fetch would
// be; it also took over seven minutes to compile. Two more variants were
// measured without a gain: deferring a step's trailing update so that it
// overlaps the next step's chain, and, for two rows a lane, broadcasting c
// through shared memory, 3% slower at m = 33 and 8% faster at m = 60.)
//
// A column step is: the pivot by one shuffle from lane j, the GMW theta by
// one warp reduction (`__reduce_max_sync` on the bit patterns of |a_ij| >=
// 0), IEEE sqrtf and one IEEE division a lane, the scaled column c broadcast
// by shuffles, and the multiply-adds: no shared memory and no barrier on the
// chain. The update keeps the right-looking order a[i][k] -= c_i c_k of the
// first design, so the factor is bit-equal to it.
//
// Two divisions leave the chain where they can: the GMW quotient
// theta^2 / beta2 is only formed when it can exceed the pivot's floor
// (a warp-uniform test with a factor 2 of margin, so the result is the
// same bit for bit), and a zero numerator, which sends the hardware's IEEE
// division to its slow path, multiplies instead (`divide`, whose division
// is an instruction of its own: left to the compiler, the test for zero
// became a branch around the division, and the reciprocal of the divisor
// then started only after the numerator had arrived).  From step j on only
// m - j registers of the window are live, so the later steps run the same
// loop at half and at a quarter of the width (a gain of 10-15% from m = 24
// up, none at m = 19).
//
// K4: the matrix is loaded once into the staged shared copy and each of
// its right-hand sides gets a warp of its own (up to four; warp w takes
// columns w, w + 4, ...), each lane holding its entry of b in a register.
// L stays in shared memory: the loads of a step (L_jj, and L_ij or L_ji
// for the lane's row) do not depend on b, and the chain is one shuffle
// (b_j from lane j), one IEEE division and one multiply-add a step.
// Forward substitution is column-oriented (b_i -= L_ij y_j), and so is the
// backward one (b_i -= L_ji x_j, the lanes reading row j of L), so neither
// needs a transposed copy or a warp sum.  The fused kernel has the same
// warps: they copy the block together, warp 0 runs K3's steps, which leave
// L in the staged block, and after a barrier every warp substitutes its
// right-hand side: one launch, and L never goes through device memory in
// between.
//
// Device memory is touched once each way and coalesced: a block is copied
// into shared memory by asynchronous copies, all in flight at once (row
// stride m | 1, so that neither row nor column accesses meet bank
// conflicts), each lane takes its row from there by unconditional loads (the
// mirrored lower triangle: like the plain version, the recurrence reads
// only the lower triangle; the GMW scan reads every entry), and L goes
// back from the same buffer, zeros in the upper triangle included, or is
// not written at all when the caller wants only e (the PSD repair) or only
// x (the slack Newton step).  The staging is sized by m (1.4 KB a warp at
// m = 19, 16.3 KB at m = 64).
//
// The last kernel here is a latency probe: one warp running `steps`
// dependent steps shaped like K3's or K4's (0 steps: an empty kernel), by
// which chip_smoke.py measures the floor a latency-bound design can reach.

#include "chol_device.cuh"

namespace {

constexpr int kMaxM = 64;
constexpr int kWarps = 4;            // matrices per CUDA block, at most
constexpr int kSharedCap = 48 * 1024;

// K3: one warp per matrix, blockDim.x / 32 matrices per CUDA block.
template <int COLS, int NR>
__global__ void __launch_bounds__(32 * kWarps)
mod_chol_kernel(const float* __restrict__ h, float* __restrict__ lout, float* __restrict__ eout,
                int batch, int m, int gmw, float nf) {
    extern __shared__ __align__(16) float shared_floats[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int mat = blockIdx.x * (blockDim.x >> 5) + warp;
    if (mat >= batch) return;
    const int ld = m | 1;
    float* block = shared_floats + warp * stage_floats(m);
    const size_t base = static_cast<size_t>(mat) * m * m;
    copy_block<true>(const_cast<float*>(h) + base, block, m, ld, lane, 32);
    __syncwarp();
    float e[NR];
    factor_staged<COLS, NR>(block, e, m, ld, lane, gmw, nf, lout != nullptr);
    write_boosts<NR>(eout + static_cast<size_t>(mat) * m, e, m, lane);
    if (lout != nullptr) {
        __syncwarp();
        copy_block<false>(lout + base, block, m, ld, lane, 32);
    }
}

// K4 and the fused kernel: ``wpm`` warps per matrix, one right-hand side
// each at a time (warp w takes columns w, w + wpm, ...; two right-hand sides
// interleaved in one warp were measured at 1.75x the time of one: each IEEE
// division ends in a branch to its slow path, which keeps the compiler from
// overlapping two of them), blockDim.x / (32 wpm) matrices per CUDA block.  The warps of
// a matrix copy it together; block-wide barriers order the copy, the
// factorization (warp 0 of the matrix) and the substitutions, so no warp
// leaves before the last barrier.
struct Place {
    int mat, w, lane, tid, threads;
    float* block;
    bool active;
};

// Orders the warps of a matrix: alone, a warp only needs its own lanes.
__device__ __forceinline__ void matrix_barrier(int wpm) {
    if (wpm == 1) __syncwarp();
    else __syncthreads();
}

__device__ __forceinline__ Place place(float* shared_floats, int batch, int m, int wpm) {
    const int warp = threadIdx.x >> 5;
    const int local = warp / wpm;
    Place p;
    p.mat = blockIdx.x * ((blockDim.x >> 5) / wpm) + local;
    p.w = warp - local * wpm;
    p.lane = threadIdx.x & 31;
    p.tid = p.w * 32 + p.lane;
    p.threads = 32 * wpm;
    p.block = shared_floats + local * stage_floats(m);
    p.active = p.mat < batch;
    return p;
}

template <int NR>
__global__ void __launch_bounds__(32 * kWarps)
chol_solve_kernel(const float* __restrict__ l, const float* __restrict__ rhs,
                  float* __restrict__ x, int batch, int m, int nrhs, int wpm) {
    extern __shared__ __align__(16) float shared_floats[];
    const Place p = place(shared_floats, batch, m, wpm);
    const int ld = m | 1;
    const size_t vec = static_cast<size_t>(p.mat) * m * nrhs;
    float first[NR];
    if (p.active) {
        load_rhs<NR>(rhs + vec, first, m, nrhs, p.w, p.lane);
        copy_block<true>(const_cast<float*>(l) + static_cast<size_t>(p.mat) * m * m, p.block, m,
                         ld, p.tid, p.threads);
    }
    matrix_barrier(wpm);
    if (p.active)
        solve_columns<NR>(p.block, rhs + vec, first, x + vec, m, ld, nrhs, p.w, wpm, p.lane);
}

template <int COLS, int NR>
__global__ void __launch_bounds__(32 * kWarps)
factor_solve_kernel(const float* __restrict__ h, const float* __restrict__ rhs,
                    float* __restrict__ lout, float* __restrict__ eout, float* __restrict__ x,
                    int batch, int m, int nrhs, int wpm, int gmw, float nf) {
    extern __shared__ __align__(16) float shared_floats[];
    const Place p = place(shared_floats, batch, m, wpm);
    const int ld = m | 1;
    const size_t base = static_cast<size_t>(p.mat) * m * m;
    const size_t vec = static_cast<size_t>(p.mat) * m * nrhs;
    float first[NR];
    if (p.active) {
        load_rhs<NR>(rhs + vec, first, m, nrhs, p.w, p.lane);
        copy_block<true>(const_cast<float*>(h) + base, p.block, m, ld, p.tid, p.threads);
    }
    matrix_barrier(wpm);
    if (p.active && p.w == 0) {
        float e[NR];
        factor_staged<COLS, NR>(p.block, e, m, ld, p.lane, gmw, nf, true);
        write_boosts<NR>(eout + static_cast<size_t>(p.mat) * m, e, m, p.lane);
    }
    matrix_barrier(wpm);
    if (p.active) {
        solve_columns<NR>(p.block, rhs + vec, first, x + vec, m, ld, nrhs, p.w, wpm, p.lane);
        if (lout != nullptr) copy_block<false>(lout + base, p.block, m, ld, p.tid, p.threads);
    }
}

// One warp, `steps` dependent steps: kind 3 a K3 column step (warp max,
// division, square root, division, shuffle, multiply-add), kind 4 a K4
// substitution step (division, shuffle, multiply-add).
__global__ void chol_probe_kernel(float* out, int steps, int kind) {
    float x = 1.f + 1e-3f * threadIdx.x;
    const float d = 1.0001f + out[32];
    for (int s = 0; s < steps; ++s) {
        float c;
        if (kind == 3) {
            const float theta = warp_max_nonneg(fabsf(x));
            const float piv = sqrtf(fmaxf(theta * theta / d, 1e-3f));
            c = x / piv;
        } else {
            c = x / d;
        }
        const float y = __shfl_sync(kFull, c, s & 31);
        x = fmaf(-0.5f * c, y, 1.5f);
    }
    out[threadIdx.x] = x;
}

struct Launch {
    dim3 grid, block;
    size_t shared;
    int wpm;
};

// ``wpm`` warps per matrix (one per right-hand side, at most kWarps) and as
// many matrices per CUDA block as fit kWarps warps and the shared memory.
Launch launch_shape(int batch, int m, int nrhs) {
    const int wpm = nrhs < kWarps ? nrhs : kWarps;
    const size_t per_matrix = stage_floats(m) * sizeof(float);
    int mats = static_cast<int>(kSharedCap / per_matrix);
    mats = mats > kWarps / wpm ? kWarps / wpm : mats;
    return {dim3((batch + mats - 1) / mats), dim3(32 * wpm * mats), mats * per_matrix, wpm};
}

}  // namespace

// The tier (padded width) comes from the caller (`cuda_chol.route`); a
// width that is not built is refused.
#define TRAJOPT_TIERS(CALL)                                      \
    switch (cols) {                                              \
        case 8: CALL(8, 1); break;                               \
        case 16: CALL(16, 1); break;                             \
        case 20: CALL(20, 1); break;                             \
        case 24: CALL(24, 1); break;                             \
        case 32: CALL(32, 1); break;                             \
        case 36: CALL(36, 2); break;                             \
        case 44: CALL(44, 2); break;                             \
        case 52: CALL(52, 2); break;                             \
        case 64: CALL(64, 2); break;                             \
        default: return static_cast<int>(cudaErrorInvalidValue); \
    }

extern "C" int trajopt_mod_chol(const float* h, float* l, float* e, int batch, int m, int cols,
                                int gmw, float nf, void* stream) {
    if (m > kMaxM || m > cols) return static_cast<int>(cudaErrorInvalidValue);
    if (batch > 0 && m > 0) {
        const Launch at = launch_shape(batch, m, 1);
        cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(COLS, NR) \
    mod_chol_kernel<COLS, NR><<<at.grid, at.block, at.shared, st>>>(h, l, e, batch, m, gmw, nf)
        TRAJOPT_TIERS(CALL)
#undef CALL
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int trajopt_chol_solve(const float* l, const float* rhs, float* x, int batch, int m,
                                  int nrhs, void* stream) {
    if (m > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
    if (batch > 0 && m > 0 && nrhs > 0) {
        const Launch at = launch_shape(batch, m, nrhs);
        cudaStream_t st = static_cast<cudaStream_t>(stream);
        if (m <= 32)
            chol_solve_kernel<1><<<at.grid, at.block, at.shared, st>>>(l, rhs, x, batch, m, nrhs,
                                                                   at.wpm);
        else
            chol_solve_kernel<2><<<at.grid, at.block, at.shared, st>>>(l, rhs, x, batch, m, nrhs,
                                                                   at.wpm);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int trajopt_factor_solve(const float* h, const float* rhs, float* l, float* e, float* x,
                                    int batch, int m, int cols, int nrhs, int gmw, float nf,
                                    void* stream) {
    if (m > kMaxM || m > cols) return static_cast<int>(cudaErrorInvalidValue);
    if (batch > 0 && m > 0 && nrhs > 0) {
        const Launch at = launch_shape(batch, m, nrhs);
        cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(COLS, NR)                                                      \
    factor_solve_kernel<COLS, NR><<<at.grid, at.block, at.shared, st>>>(    \
        h, rhs, l, e, x, batch, m, nrhs, at.wpm, gmw, nf)
        TRAJOPT_TIERS(CALL)
#undef CALL
    }
    return static_cast<int>(cudaGetLastError());
}

// out: at least 33 floats, out[32] == 0 (read so that the divisor is not a
// compile-time constant).
extern "C" int trajopt_chol_probe(float* out, int steps, int kind, void* stream) {
    chol_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(out, steps, kind);
    return static_cast<int>(cudaGetLastError());
}
