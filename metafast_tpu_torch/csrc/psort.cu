// Blocked bitonic sort of (int64 key, int32 index) pairs for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel metafast_tpu/ops/psort.py:99 _tile_kernel
// (launched by _tile_pass, :110-135) together with the XLA exchange stages
// it alternates with (_xla_exchange, :142-165), driven as in
// sort_arrays_blocked (:183-204).  It computes the same network, not the
// VMEM roll layout: for each span s = 2..n and distance d = s/2..1, element
// i (i & d == 0) meets i + d, ascending iff i & s == 0.
//
// The pass plan lives in Python (ops/psort.py _plan); this file has one
// entry point per pass kind and no loop over passes:
//
//   * Tile pass (psort_tile_pass): one block holds a tile of T = 2^log_tile
//     elements (T up to 2^14) in dynamic shared memory and runs every stage
//     of spans ls_lo..ls_hi whose distance is below T.  The distances of a
//     span are cut into register groups of R consecutive bits from the
//     top down (the last group takes the remainder).  For a group,
//     each thread loads the 2^g elements whose indices differ only in the
//     group's bits, runs the g stages in registers with no barrier, and
//     stores them back: one shared-memory round trip and one
//     __syncthreads() per group, not per stage.  The first group reads
//     device memory and the last writes it, so each of them makes only
//     half a shared-memory round trip.  Shared memory is padded (one key
//     slot per 16 keys, one index slot per 32 indices) so that the strided
//     set loads of the low groups spread over the banks.
//   * Global pass (psort_global_pass): one launch runs up to R consecutive
//     stages of one span whose distances are all >= T.  Each thread loads
//     its 2^g elements from device memory, runs the stages in registers and
//     writes them back; neighbouring threads take neighbouring low index
//     bits, so each load and store of a warp covers 256 contiguous bytes of
//     keys (128 of indices).
//
// Equal keys: for d < 2^log_block they stay (the JAX tile); for
// d >= 2^log_block they swap in an ascending window (the JAX exchange,
// keep_a = lt == dir_up).  log_block is the caller's logical block, never T,
// and is taken per stage, so it may change inside a register group.
//
// Bound: device memory bandwidth.  Every pass reads and writes all n pairs
// (24 B each); at n = 2^27, T = 2^14 and R = 4 the plan has 28 global and
// 14 tile passes for the 378 stages.  The global passes run near the
// card's bandwidth; the tile passes, one block an SM, are bound by their
// shared-memory traffic and compare-exchange instructions (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxFuse = 5;
constexpr int kMaxLogTile = 14;
constexpr int kTileThreads = 512;
constexpr int kGlobalThreads = 256;

// padded shared-memory slots
__device__ __forceinline__ int key_slot(int i) { return i + (i >> 4); }
__device__ __forceinline__ int idx_slot(int i) { return i + (i >> 5); }

__host__ __device__ constexpr size_t tile_smem_bytes(int T) {
    return (size_t)(T + (T >> 4)) * sizeof(int64_t) +
           (size_t)(T + (T >> 5)) * sizeof(int32_t);
}

// The g = G stages of distance bits lo + G - 1 .. lo on one thread's 2^G
// elements; element j sits at offset j << lo from the set's first index.
// `up` is the set's direction (the span bit lies above every group bit).
template <int G>
__device__ __forceinline__ void run_group(int64_t (&k)[1 << G],
                                          int32_t (&x)[1 << G], int lo,
                                          bool up, int log_block) {
#pragma unroll
    for (int q = G - 1; q >= 0; --q) {
        const bool keep_ties = lo + q < log_block;
#pragma unroll
        for (int j = 0; j < (1 << G); ++j) {
            if (j & (1 << q)) continue;
            const int m = j | (1 << q);
            const int64_t a = k[j];
            const int64_t b = k[m];
            const bool swap = up ? (keep_ties ? a > b : a >= b) : a < b;
            k[j] = swap ? b : a;
            k[m] = swap ? a : b;
            const int32_t xa = x[j];
            const int32_t xb = x[m];
            x[j] = swap ? xb : xa;
            x[m] = swap ? xa : xb;
        }
    }
}

// first index of set w: G zero bits inserted at bit lo
__device__ __forceinline__ int64_t set_base(int64_t w, int lo, int G) {
    const int64_t low = w & ((int64_t(1) << lo) - 1);
    return ((w >> lo) << (lo + G)) | low;
}

// One register group on the shared-memory tile of the block at `base`.
// kFromDevice: the pass's first group; its sets come from device memory
// (keys_in, and idx_in or each element's own position) and fill the tile.
// kToDevice: the pass's last group (lowest bit 0); its 2^G neighbouring
// elements go to keys_out / idx_out in 16-byte stores.  Otherwise the
// sets come from the tile and go back to it.  The bits of b and j << lo
// are disjoint, so a slot is key_slot(b) plus an offset that depends on j
// and lo alone, the same for every set.
template <int G, bool kFromDevice, bool kToDevice>
__device__ void tile_group(int64_t* sk, int32_t* si, const int64_t* keys_in,
                           const int32_t* idx_in, int64_t* keys_out,
                           int32_t* idx_out, int T, int lo, int log_span,
                           int64_t base, int log_block) {
    for (int w = threadIdx.x; w < (T >> G); w += blockDim.x) {
        const int b = (int)set_base(w, lo, G);
        int64_t k[1 << G];
        int32_t x[1 << G];
        const int kb = key_slot(b), xb = idx_slot(b);
#pragma unroll
        for (int j = 0; j < (1 << G); ++j) {
            const int i = b + (j << lo);
            if (kFromDevice) {
                k[j] = keys_in[base + i];
                x[j] = idx_in ? idx_in[base + i] : (int32_t)(base + i);
            } else {
                k[j] = sk[kb + (j << lo) + ((j << lo) >> 4)];
                x[j] = si[xb + (j << lo) + ((j << lo) >> 5)];
            }
        }
        run_group<G>(k, x, lo, (((base + b) >> log_span) & 1) == 0,
                     log_block);
        if (kToDevice) {
            if (G >= 2) {
#pragma unroll
                for (int j = 0; j < (1 << G); j += 2)
                    reinterpret_cast<longlong2*>(keys_out + base + b)[j / 2] =
                        make_longlong2(k[j], k[j + 1]);
#pragma unroll
                for (int j = 0; j < (1 << G); j += 4)
                    reinterpret_cast<int4*>(idx_out + base + b)[j / 4] =
                        make_int4(x[j], x[(j + 1) % (1 << G)],
                                  x[(j + 2) % (1 << G)],
                                  x[(j + 3) % (1 << G)]);
                continue;
            }
#pragma unroll
            for (int j = 0; j < (1 << G); ++j) {
                keys_out[base + b + j] = k[j];
                idx_out[base + b + j] = x[j];
            }
        } else {
#pragma unroll
            for (int j = 0; j < (1 << G); ++j) {
                sk[kb + (j << lo) + ((j << lo) >> 4)] = k[j];
                si[xb + (j << lo) + ((j << lo) >> 5)] = x[j];
            }
        }
    }
}

template <int R, bool kFromDevice, bool kToDevice>
__device__ __forceinline__ void tile_group_g(int g, int64_t* sk, int32_t* si,
                                             const int64_t* keys_in,
                                             const int32_t* idx_in,
                                             int64_t* keys_out,
                                             int32_t* idx_out, int T, int lo,
                                             int log_span, int64_t base,
                                             int log_block) {
    switch (g) {
#define PSORT_GROUP(G)                                                    \
    tile_group<(G <= R ? G : 1), kFromDevice, kToDevice>(                \
        sk, si, keys_in, idx_in, keys_out, idx_out, T, lo, log_span, base, \
        log_block);                                                        \
    break;
        case 1: PSORT_GROUP(1)
        case 2: PSORT_GROUP(2)
        case 3: PSORT_GROUP(3)
        case 4: PSORT_GROUP(4)
        default: PSORT_GROUP(R)
#undef PSORT_GROUP
    }
}

// Runs spans ls_lo..ls_hi, each at distances min(span, T)/2 .. 1, on the
// tile of block blockIdx.x, in register groups of at most R bits.  keys_in
// may equal keys_out (each block reads its whole tile before it writes);
// idx_in == nullptr takes each element's own position as its index.
//
// Filling the tile: when the first group's sets are coalesced (its lowest
// bit is 5 or more, so a warp's 32 sets are 32 neighbouring elements),
// that group reads device memory itself, 2^g independent loads a thread in
// flight, and saves one shared-memory round trip; otherwise a thread
// starts 8 loads before it stores any.  The last group (bits g-1..0)
// writes device memory itself and saves another.
template <int R>
__global__ void __launch_bounds__(kTileThreads)
tile_pass(const int64_t* keys_in, const int32_t* idx_in, int64_t* keys_out,
          int32_t* idx_out, int log_tile, int ls_lo, int ls_hi,
          int log_block) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int T = 1 << log_tile;
    int64_t* sk = reinterpret_cast<int64_t*>(smem);
    int32_t* si = reinterpret_cast<int32_t*>(sk + T + (T >> 4));
    const int64_t base = (int64_t)blockIdx.x << log_tile;
    const int first_bits = ls_lo < log_tile ? ls_lo : log_tile;
    bool from_device = first_bits - R >= 5;
    if (!from_device) {
        constexpr int kBatch = 8;
        for (int j0 = threadIdx.x; j0 < T; j0 += kBatch * blockDim.x) {
            int64_t kv[kBatch];
            int32_t xv[kBatch];
#pragma unroll
            for (int c = 0; c < kBatch; ++c) {
                const int j = j0 + c * blockDim.x;
                if (j < T) {
                    kv[c] = keys_in[base + j];
                    xv[c] = idx_in ? idx_in[base + j] : (int32_t)(base + j);
                }
            }
#pragma unroll
            for (int c = 0; c < kBatch; ++c) {
                const int j = j0 + c * blockDim.x;
                if (j < T) {
                    sk[key_slot(j)] = kv[c];
                    si[idx_slot(j)] = xv[c];
                }
            }
        }
        __syncthreads();
    }
    for (int ls = ls_lo; ls <= ls_hi; ++ls) {
        const int bits = ls < log_tile ? ls : log_tile;
        for (int hi = bits; hi > 0; hi -= R) {
            const int g = hi < R ? hi : R;
            // the first group's lowest bit is >= 5, the last group's is 0
            if (from_device) {
                tile_group_g<R, true, false>(g, sk, si, keys_in, idx_in,
                                             keys_out, idx_out, T, hi - g,
                                             ls, base, log_block);
                from_device = false;
            } else if (ls == ls_hi && hi == g) {
                tile_group_g<R, false, true>(g, sk, si, keys_in, idx_in,
                                             keys_out, idx_out, T, 0, ls,
                                             base, log_block);
                return;
            } else {
                tile_group_g<R, false, false>(g, sk, si, keys_in, idx_in,
                                              keys_out, idx_out, T, hi - g,
                                              ls, base, log_block);
            }
            __syncthreads();
        }
    }
}

// The G stages of distance bits lo + G - 1 .. lo of span 2^log_span over the
// whole array, in place: thread w owns set w.
template <int G>
__global__ void __launch_bounds__(kGlobalThreads)
global_pass(int64_t* __restrict__ keys, int32_t* __restrict__ idx,
            int64_t sets, int lo, int log_span, int log_block) {
    const int64_t w = (int64_t)blockIdx.x * kGlobalThreads + threadIdx.x;
    if (w >= sets) return;
    const int64_t b = set_base(w, lo, G);
    int64_t k[1 << G];
    int32_t x[1 << G];
#pragma unroll
    for (int j = 0; j < (1 << G); ++j) {
        k[j] = keys[b + ((int64_t)j << lo)];
        x[j] = idx[b + ((int64_t)j << lo)];
    }
    run_group<G>(k, x, lo, ((b >> log_span) & 1) == 0, log_block);
#pragma unroll
    for (int j = 0; j < (1 << G); ++j) {
        keys[b + ((int64_t)j << lo)] = k[j];
        idx[b + ((int64_t)j << lo)] = x[j];
    }
}

template <int R>
cudaError_t launch_tile(const int64_t* keys_in, const int32_t* idx_in,
                        int64_t* keys_out, int32_t* idx_out, int64_t n,
                        int log_tile, int ls_lo, int ls_hi, int log_block,
                        cudaStream_t s) {
    const int T = 1 << log_tile;
    const size_t smem = tile_smem_bytes(T);
    cudaError_t err = cudaFuncSetAttribute(
        tile_pass<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(tile_pass<R>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    // 32 elements a thread: 512 threads at T = 2^14 (one block an SM),
    // 256 at 2^13 (two blocks an SM share its shared memory)
    const int threads = T / 32 < 32 ? 32
                        : (T / 32 > kTileThreads ? kTileThreads : T / 32);
    tile_pass<R><<<(unsigned)(n >> log_tile), threads, smem, s>>>(
        keys_in, idx_in, keys_out, idx_out, log_tile, ls_lo, ls_hi,
        log_block);
    return cudaGetLastError();
}

template <int G>
cudaError_t launch_global(int64_t* keys, int32_t* idx, int64_t n, int lo,
                          int log_span, int log_block, cudaStream_t s) {
    const int64_t sets = n >> G;
    const int64_t blocks = (sets + kGlobalThreads - 1) / kGlobalThreads;
    global_pass<G><<<(unsigned)blocks, kGlobalThreads, 0, s>>>(
        keys, idx, sets, lo, log_span, log_block);
    return cudaGetLastError();
}

bool valid_n(int64_t n) {
    return n >= 2 && !(n & (n - 1)) && n <= (int64_t(1) << 31);
}

}  // namespace

// Tile pass over n keys (n a power of two in [2, 2^31], n >= 2^log_tile):
// spans 2^ls_lo..2^ls_hi at their distances below 2^log_tile, register
// groups of at most `fuse` bits.  init_index != 0 reads keys_in and writes
// each key's position as its index (the plan's first pass); otherwise
// idx_out is read and written in place.  Returns the launch error (0 =
// launched), cudaErrorInvalidValue for arguments outside these ranges.
extern "C" int psort_tile_pass(const void* keys_in, void* keys_out,
                               void* idx_out, int64_t n, int log_tile,
                               int ls_lo, int ls_hi, int log_block, int fuse,
                               int init_index, void* stream) {
    if (!valid_n(n) || log_tile < 1 || log_tile > kMaxLogTile ||
        (int64_t(1) << log_tile) > n || ls_lo < 1 || ls_hi < ls_lo ||
        ls_hi > 31 || fuse < 1 || fuse > kMaxFuse) {
        return (int)cudaErrorInvalidValue;
    }
    const int64_t* ki = (const int64_t*)keys_in;
    int64_t* ko = (int64_t*)keys_out;
    int32_t* xo = (int32_t*)idx_out;
    const int32_t* xi = init_index ? nullptr : xo;
    cudaStream_t s = (cudaStream_t)stream;
    switch (fuse) {
        case 1: return (int)launch_tile<1>(ki, xi, ko, xo, n, log_tile, ls_lo, ls_hi, log_block, s);
        case 2: return (int)launch_tile<2>(ki, xi, ko, xo, n, log_tile, ls_lo, ls_hi, log_block, s);
        case 3: return (int)launch_tile<3>(ki, xi, ko, xo, n, log_tile, ls_lo, ls_hi, log_block, s);
        case 4: return (int)launch_tile<4>(ki, xi, ko, xo, n, log_tile, ls_lo, ls_hi, log_block, s);
        default: return (int)launch_tile<5>(ki, xi, ko, xo, n, log_tile, ls_lo, ls_hi, log_block, s);
    }
}

// Global pass over n pairs in place: the stages of span 2^log_span at
// distances 2^ld_hi .. 2^ld_lo (1 <= ld_hi - ld_lo + 1 <= 5, ld_hi <
// log_span).  Returns the launch error (0 = launched).
extern "C" int psort_global_pass(void* keys, void* idx, int64_t n,
                                 int log_span, int ld_hi, int ld_lo,
                                 int log_block, void* stream) {
    const int g = ld_hi - ld_lo + 1;
    if (!valid_n(n) || ld_lo < 0 || g < 1 || g > kMaxFuse ||
        ld_hi >= log_span || (int64_t(1) << log_span) > n) {
        return (int)cudaErrorInvalidValue;
    }
    int64_t* k = (int64_t*)keys;
    int32_t* x = (int32_t*)idx;
    cudaStream_t s = (cudaStream_t)stream;
    switch (g) {
        case 1: return (int)launch_global<1>(k, x, n, ld_lo, log_span, log_block, s);
        case 2: return (int)launch_global<2>(k, x, n, ld_lo, log_span, log_block, s);
        case 3: return (int)launch_global<3>(k, x, n, ld_lo, log_span, log_block, s);
        case 4: return (int)launch_global<4>(k, x, n, ld_lo, log_span, log_block, s);
        default: return (int)launch_global<5>(k, x, n, ld_lo, log_span, log_block, s);
    }
}
