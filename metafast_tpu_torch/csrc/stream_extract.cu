// Canonical k-mer stream extraction for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   metafast_tpu/ops/stream_extract.py:389 _kernel3 (stream3_extract_pallas,
//     :398) -- the compact 3-stream layout, w1/w2 given as arrays;
//   metafast_tpu/ops/stream_extract.py:122 _kernel (stream_extract_pallas,
//     :136) -- the overlapping-column layout, w1/w2 are the next rows of
//     the same 256-row column.
// Both compute metafast_tpu/ops/stream_extract.py:66 _window_math; this
// kernel computes the same values, not the Pallas block structure.
//
// Input: u32 words [C, 256], 16 2-bit codes each (code j at bits 2j), and a
// validity mask word per stream word (bit r: the window starting at code r
// lies inside one read).  Output: int64 [16, C, 256], phase-major: the
// canonical key min(fw, rc) of the window at phase r of every word, or
// INT64_MAX where mask bit r is 0.
//
// One thread per stream word, all math in 64-bit registers:
//   forward: F = rev2(w0):rev2(w1) holds codes 0..31 most-significant
//     first; the window at phase r is the top 2k bits of
//     (F << 2r) | (rev2(w2) >> (32 - 2r));
//   reverse complement: L = w1:w0 holds codes 0..31 little-endian; the
//     complement of (L >> 2r) | (w2 << (64 - 2r)), masked to 2k bits, is
//     the reverse complement (the packing order performs the reversal).
//
// Bound: it reads 16 B per word (12 B for the column layout, whose w1/w2
// come from the same cached lines) and writes 16 keys of 8 B = 128 B, so it
// is write-bandwidth-bound at ~8 B written per B read.  Stores are
// phase-major so that each of the 16 stores of a warp covers 32 adjacent
// int64 (256 contiguous bytes).  One 2^27-code slab of 150 bp reads is
// ~7.2 M words -> ~115 M keys -> ~0.92 GB written.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 256;     // column height of both layouts
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rev2(uint32_t x) {
    x = ((x & 0x33333333u) << 2) | ((x >> 2) & 0x33333333u);
    x = ((x & 0x0F0F0F0Fu) << 4) | ((x >> 4) & 0x0F0F0F0Fu);
    x = ((x & 0x00FF00FFu) << 8) | ((x >> 8) & 0x00FF00FFu);
    return (x << 16) | (x >> 16);
}

template <bool kStream3>
__global__ void __launch_bounds__(kThreads)
stream_extract_kernel(const uint32_t* __restrict__ w0,
                      const uint32_t* __restrict__ w1,
                      const uint32_t* __restrict__ w2,
                      const uint32_t* __restrict__ vm,
                      int64_t n_words, int k,
                      int64_t* __restrict__ out) {
    const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (t >= n_words) return;
    const uint32_t a = w0[t];
    uint32_t b, c;
    if (kStream3) {
        b = w1[t];
        c = w2[t];
    } else {
        const int64_t col = t & ~(int64_t)(kRows - 1);
        const int row = (int)(t & (kRows - 1));
        b = w0[col + ((row + 1) & (kRows - 1))];
        c = w0[col + ((row + 2) & (kRows - 1))];
    }
    const uint32_t m = vm[t];
    const uint64_t F = ((uint64_t)rev2(a) << 32) | rev2(b);
    const uint32_t r2 = rev2(c);
    const uint64_t L = ((uint64_t)b << 32) | a;
    const uint64_t mask = (1ull << (2 * k)) - 1ull;
    const int s_down = 64 - 2 * k;
#pragma unroll
    for (int r = 0; r < 16; r++) {
        const uint64_t top =
            r ? (F << (2 * r)) | (uint64_t)(r2 >> (32 - 2 * r)) : F;
        const uint64_t fw = top >> s_down;
        const uint64_t x =
            r ? (L >> (2 * r)) | ((uint64_t)c << (64 - 2 * r)) : L;
        const uint64_t rc = ~x & mask;
        const uint64_t can = fw < rc ? fw : rc;
        out[(int64_t)r * n_words + t] =
            ((m >> r) & 1u) ? (int64_t)can : INT64_MAX;
    }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
// stream3 != 0: w1, w2 are arrays like w0; otherwise they are ignored and
// read from the next rows of w0's column.  n_words = C * 256.
extern "C" int stream_extract_launch(const void* w0, const void* w1,
                                     const void* w2, const void* vm,
                                     int64_t n_words, int k, int stream3,
                                     void* out, void* stream) {
    if (n_words <= 0) return (int)cudaSuccess;
    const dim3 grid((unsigned)((n_words + kThreads - 1) / kThreads));
    cudaStream_t s = (cudaStream_t)stream;
    const uint32_t* p0 = (const uint32_t*)w0;
    const uint32_t* pv = (const uint32_t*)vm;
    int64_t* po = (int64_t*)out;
    if (stream3) {
        stream_extract_kernel<true><<<grid, kThreads, 0, s>>>(
            p0, (const uint32_t*)w1, (const uint32_t*)w2, pv, n_words, k, po);
    } else {
        stream_extract_kernel<false><<<grid, kThreads, 0, s>>>(
            p0, nullptr, nullptr, pv, n_words, k, po);
    }
    return (int)cudaGetLastError();
}
