// Blocked bitonic sort of (int64 key, int32 index) pairs for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel metafast_tpu/ops/psort.py:99 _tile_kernel
// (launched by _tile_pass, :110-135) together with the XLA exchange stages
// it alternates with (_xla_exchange, :142-165), driven as in
// sort_arrays_blocked (:183-204).  It computes the same network, not the
// VMEM roll layout: for each span s = 2..n and distance d = s/2..1, element
// i (i & d == 0) meets i + d, ascending iff i & s == 0.
//
//   * Tile pass: one block sorts a tile of T = 2^log_tile elements in
//     dynamic shared memory (12 B each: T = 4096 is 48 KB, the default
//     limit, so no opt-in attribute is needed), running every stage of a
//     run of spans whose distance is below T, with a __syncthreads()
//     between stages.  The first pass runs spans 2..T and writes the
//     index (its own position) beside each key.
//   * Global pass: one launch per stage with d >= T, one thread per pair.
//     After each span's global stages a tile pass runs its distances
//     T/2..1.
//
// Equal keys: for d < 2^log_block they stay (the JAX tile); for
// d >= 2^log_block they swap in an ascending window (the JAX exchange,
// keep_a = lt == dir_up).  log_block is the caller's logical block, never T.
//
// Bound: device memory bandwidth.  Each global pass reads and writes all n
// pairs (24 B each); at n = 2^27 and T = 2^12 that is 120 global passes
// plus 16 tile passes.  Fusing several global stages per pass (as the JAX
// exchange fused three) and a larger T are what would cut that traffic.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLogTile = 12;
constexpr int kTileThreads = 1024;
constexpr int kGlobalThreads = 256;

// a sits at the lower index, b at the upper
__device__ __forceinline__ bool swap_pair(int64_t a, int64_t b, bool up,
                                          bool keep_ties) {
    if (up) return keep_ties ? a > b : a >= b;
    return a < b;
}

// the p-th pair's lower index: a zero bit inserted at position log_d
__device__ __forceinline__ int64_t pair_low(int64_t p, int log_d) {
    const int64_t low = p & ((int64_t(1) << log_d) - 1);
    return ((p - low) << 1) | low;
}

// Runs spans log_span_lo..log_span_hi, each at distances
// min(span, T)/2 .. 1, on the tile of block blockIdx.x.  keys_in may equal
// keys_out (each block reads its whole tile before it writes).
__global__ void __launch_bounds__(kTileThreads)
tile_pass(const int64_t* keys_in, const int32_t* idx_in, int64_t* keys_out,
          int32_t* idx_out, int log_tile, int log_span_lo, int log_span_hi,
          int log_block, int init_index) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int T = 1 << log_tile;
    int64_t* sk = reinterpret_cast<int64_t*>(smem);
    int32_t* si = reinterpret_cast<int32_t*>(sk + T);
    const int64_t base = (int64_t)blockIdx.x << log_tile;
    for (int j = threadIdx.x; j < T; j += blockDim.x) {
        sk[j] = keys_in[base + j];
        si[j] = init_index ? (int32_t)(base + j) : idx_in[base + j];
    }
    __syncthreads();
    for (int ls = log_span_lo; ls <= log_span_hi; ++ls) {
        const int64_t span = int64_t(1) << ls;
        const int ld_top = (ls < log_tile ? ls : log_tile) - 1;
        for (int ld = ld_top; ld >= 0; --ld) {
            const bool keep_ties = ld < log_block;
            for (int p = threadIdx.x; p < T / 2; p += blockDim.x) {
                const int i = (int)pair_low(p, ld);
                const int j = i + (1 << ld);
                const int64_t a = sk[i];
                const int64_t b = sk[j];
                if (swap_pair(a, b, ((base + i) & span) == 0, keep_ties)) {
                    sk[i] = b;
                    sk[j] = a;
                    const int32_t t = si[i];
                    si[i] = si[j];
                    si[j] = t;
                }
            }
            __syncthreads();
        }
    }
    for (int j = threadIdx.x; j < T; j += blockDim.x) {
        keys_out[base + j] = sk[j];
        idx_out[base + j] = si[j];
    }
}

// One stage (span 2^log_span, distance 2^log_d) over the whole array.
__global__ void __launch_bounds__(kGlobalThreads)
global_pass(int64_t* __restrict__ keys, int32_t* __restrict__ idx,
            int64_t n_pairs, int log_d, int log_span, int log_block) {
    const int64_t p = (int64_t)blockIdx.x * kGlobalThreads + threadIdx.x;
    if (p >= n_pairs) return;
    const int64_t i = pair_low(p, log_d);
    const int64_t j = i + (int64_t(1) << log_d);
    const int64_t a = keys[i];
    const int64_t b = keys[j];
    if (swap_pair(a, b, ((i >> log_span) & 1) == 0, log_d < log_block)) {
        keys[i] = b;
        keys[j] = a;
        const int32_t t = idx[i];
        idx[i] = idx[j];
        idx[j] = t;
    }
}

}  // namespace

// Sort keys_in (n int64, n a power of two in [2, 2^31]) into keys_out and
// write each output's source position into idx_out (int32), on `stream`.
// keys_in is not modified.  Returns the first launch error (0 = launched).
extern "C" int psort_launch(const void* keys_in, void* keys_out,
                            void* idx_out, int64_t n, int log_block,
                            void* stream) {
    if (n < 2 || (n & (n - 1)) || n > (int64_t(1) << 31)) {
        return (int)cudaErrorInvalidValue;
    }
    int log_n = 0;
    while ((int64_t(1) << log_n) < n) ++log_n;
    const int log_tile = log_n < kLogTile ? log_n : kLogTile;
    const int T = 1 << log_tile;
    const int threads = T / 2 < kTileThreads ? T / 2 : kTileThreads;
    const size_t smem = (size_t)T * (sizeof(int64_t) + sizeof(int32_t));
    const dim3 tiles((unsigned)(n >> log_tile));
    const dim3 pair_blocks((unsigned)((n / 2 + kGlobalThreads - 1) /
                                      kGlobalThreads));
    cudaStream_t s = (cudaStream_t)stream;
    int64_t* k = (int64_t*)keys_out;
    int32_t* x = (int32_t*)idx_out;
    tile_pass<<<tiles, threads, smem, s>>>((const int64_t*)keys_in, nullptr,
                                           k, x, log_tile, 1, log_tile,
                                           log_block, 1);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    for (int ls = log_tile + 1; ls <= log_n; ++ls) {
        for (int ld = ls - 1; ld >= log_tile; --ld) {
            global_pass<<<pair_blocks, kGlobalThreads, 0, s>>>(
                k, x, n / 2, ld, ls, log_block);
            err = cudaGetLastError();
            if (err != cudaSuccess) return (int)err;
        }
        tile_pass<<<tiles, threads, smem, s>>>(k, x, k, x, log_tile, ls, ls,
                                               log_block, 0);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
}
