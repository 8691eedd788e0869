// Block-wide helpers shared by the entropy kernels (hist_literals.cu,
// pack_bits.cu): the symbol index of a bin, and an exclusive scan across a
// thread block built from warp shuffles.
#ifndef SZT_BLOCK_SCAN_CUH
#define SZT_BLOCK_SCAN_CUH

#include <cstdint>

namespace szt_cuda {

constexpr int kThreads = 256;          // block size of every entropy kernel
constexpr int kWarps = kThreads / 32;
constexpr int kSentinel = -1;

// bin -> symbol index, for the bins of a quantizer of radius r (n_sym = 2r,
// bins in [0, n_sym)): 0 -> bin 0, 1 -> SENTINEL, b + 1 -> bin b in
// [1, n_sym), n_sym + 1 (the invalid bucket) -> anything else. Histogram
// and code tables hold n_sym + 2 entries.
__device__ __forceinline__ int sym_index(int b, int n_sym) {
    if (b == 0) return 0;
    if (b == kSentinel) return 1;
    return (b > 0 && b < n_sym) ? b + 1 : n_sym + 1;
}

// Exclusive scan of one value per thread across a block of kThreads
// threads; `total` receives the block's sum. Every thread must call it.
// `ws` is kWarps elements of shared scratch.
template <typename T>
__device__ __forceinline__ T block_exclusive_scan(T v, T* ws, T& total) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    T x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        T y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) ws[warp] = x;
    __syncthreads();
    if (warp == 0) {
        T s = lane < kWarps ? ws[lane] : T(0);
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            T y = __shfl_up_sync(0xffffffffu, s, o);
            if (lane >= o) s += y;
        }
        if (lane < kWarps) ws[lane] = s;
    }
    __syncthreads();
    T excl = (warp ? ws[warp - 1] : T(0)) + x - v;
    total = ws[kWarps - 1];
    __syncthreads();  // ws is reused by the next call
    return excl;
}

// In-place exclusive scan of counts[0..n) by one block of kThreads threads;
// counts[n] receives the total. Each thread owns one contiguous run.
template <typename T>
__global__ void scan_block_counts(T* counts, int n) {
    __shared__ T ws[kWarps];
    const int per = (n + kThreads - 1) / kThreads;
    const int lo = threadIdx.x * per;
    const int hi = min(n, lo + per);
    T local = 0;
    for (int i = lo; i < hi; ++i) local += counts[i];
    T total;
    T run = block_exclusive_scan<T>(local, ws, total);
    for (int i = lo; i < hi; ++i) {
        T c = counts[i];
        counts[i] = run;
        run += c;
    }
    if (threadIdx.x == 0) counts[n] = total;
}

}  // namespace szt_cuda

#endif
