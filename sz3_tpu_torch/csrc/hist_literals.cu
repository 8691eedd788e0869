// Histogram and literal slots of the stream-order bins.
//
// Replaces the Pallas kernel sz3_tpu/ops/entropy_device.py::_hist_kernel
// (entry hist_and_literals). Contract: the exact histogram of
// sym_index(bins) over the whole symbol range of the quantizer (n_sym + 2
// entries, block_scan.cuh), and the stream slots of the bin==0 symbols, in
// stream order. The TPU kernel counts only a 16380-bin window around radius
// (its one-hot histogram is an MXU tile) and sends every other symbol to a
// TRASH bucket, which makes the host take over; here every symbol is counted.
//
// What bounds it on the card: bytes moved. Each symbol is read twice from
// device memory (4 B each: once to count, once to place the literals); the
// histogram and the slots are small. The hot part of the histogram lives in
// shared memory: bin 0, SENTINEL and the window [win_lo, win_lo + kWin)
// around radius (16382 x int32, dynamic, above the 48 KB static limit), so
// nearly all per-symbol increments stay on the SM; each block flushes only
// its nonzero slots with global atomics. Symbols outside the window (rare:
// rough fields, tight bounds) are counted with global atomics directly.
//
// The slots must come out in stream order: an atomic append would order
// them differently from run to run and change the archive bytes. So the
// compaction preserves order: every block owns one contiguous run of the
// stream and counts its zeros (pass 1), one block scans the per-block counts
// into offsets (pass 2), and each block with zeros walks its run again tile
// by tile, placing each zero at its offset plus its rank from a block scan
// (pass 3). Blocks whose run has no zero (nearly all) exit at once in pass 3.
// No float arithmetic.

#include <cuda_runtime.h>

#include "block_scan.cuh"

using namespace szt_cuda;

namespace {

__global__ void hist_count_kernel(const int* __restrict__ bins, long long n, int n_sym,
                                  int win_lo, long long per_block, int* __restrict__ hist,
                                  int* __restrict__ counts) {
    extern __shared__ int sh_hist[];
    __shared__ int ws[kWarps];
    for (int i = threadIdx.x; i < kShared; i += kThreads) sh_hist[i] = 0;
    __syncthreads();
    // shared slot of symbol index idx: idx itself for bin 0 and SENTINEL,
    // 2 + (idx - win_lo) inside the window; no slot elsewhere (global atomics)
    const int win_hi = min(win_lo + kWin, n_sym + 1);
    const long long lo = blockIdx.x * per_block;
    const long long hi = min(n, lo + per_block);
    int zeros = 0;
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
        const int b = bins[i];
        const int idx = sym_index(b, n_sym);
        if (idx < 2)
            atomicAdd(&sh_hist[idx], 1);
        else if (idx >= win_lo && idx < win_hi)
            atomicAdd(&sh_hist[2 + idx - win_lo], 1);
        else
            atomicAdd(&hist[idx], 1);
        zeros += (b == 0);
    }
    __syncthreads();
    for (int s = threadIdx.x; s < kShared; s += kThreads) {
        const int v = sh_hist[s];
        if (v) atomicAdd(&hist[s < 2 ? s : win_lo + s - 2], v);
    }
    int total;
    block_exclusive_scan<int>(zeros, ws, total);
    if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

__global__ void literal_slots_kernel(const int* __restrict__ bins, long long n,
                                     long long per_block, const int* __restrict__ offsets,
                                     int* __restrict__ slots) {
    __shared__ int ws[kWarps];
    int base = offsets[blockIdx.x];
    if (offsets[blockIdx.x + 1] == base) return;  // no zero in this run
    const long long lo = blockIdx.x * per_block;
    const long long hi = min(n, lo + per_block);
    for (long long t = lo; t < hi; t += kThreads) {
        const long long i = t + threadIdx.x;
        const int z = (i < hi && bins[i] == 0) ? 1 : 0;
        int total;
        const int rank = block_exclusive_scan<int>(z, ws, total);
        if (z) slots[base + rank] = static_cast<int>(i);
        base += total;
    }
}

}  // namespace

// Passes 1 and 2: histogram into `hist` (n_sym + 2 entries, zeroed by the
// caller), and offsets[0..blocks] = exclusive per-block zero counts plus the
// total. win_lo >= 2 is the first symbol index of the shared window.
extern "C" int szt_hist_count(const int* bins, long long n, int n_sym, int win_lo,
                              long long per_block, int blocks, int* hist, int* offsets,
                              void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int smem = kShared * static_cast<int>(sizeof(int));
    cudaError_t e = cudaFuncSetAttribute(hist_count_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    hist_count_kernel<<<blocks, kThreads, smem, s>>>(bins, n, n_sym, win_lo, per_block, hist,
                                                     offsets);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    scan_block_counts<int><<<1, kThreads, 0, s>>>(offsets, blocks);
    return static_cast<int>(cudaGetLastError());
}

// Pass 3: slots[offsets[b] + rank] = stream index of each zero of block b.
extern "C" int szt_literal_slots(const int* bins, long long n, long long per_block,
                                 int blocks, const int* offsets, int* slots, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    literal_slots_kernel<<<blocks, kThreads, 0, s>>>(bins, n, per_block, offsets, slots);
    return static_cast<int>(cudaGetLastError());
}
