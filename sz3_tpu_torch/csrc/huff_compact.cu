// Compaction of the decode windows' owned symbol runs into the dense stream.
//
// Replaces the Pallas kernel sz3_tpu/ops/entropy_decode.py::_compact_kernel
// (entry _compact). Contract (ops/entropy_decode.py::compact_windows):
//   dense[off[w] : off[w] + nout[w]] = syms[w, nskip[w] : nskip[w] + nout[w]]
// for every window w, where off is the exclusive scan of nout (taken by the
// caller in int64: a 512^3 field has more symbols than a window has bits).
//
// The TPU kernel shifts each run into place inside a VMEM accumulator with
// lane and sublane rotates and writes whole 128 x 128 granules by DMA,
// because it can neither gather nor store at an unaligned offset. Here one
// warp copies one window's run: lane j takes elements j, j + 32, ..., so both
// the reads (one row of syms) and the writes (one stretch of dense) are
// coalesced, whatever the offsets.
//
// What bounds it on the card: bytes moved. 4 B per symbol are read and 4 B
// written, plus 16 B per window of offsets and counts; a run holds some 200
// symbols, so a warp makes about six passes over it.
// No float arithmetic.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void huff_compact_kernel(const int* __restrict__ syms, int cap, long long nwin,
                                    const int* __restrict__ nskip, const int* __restrict__ nout,
                                    const long long* __restrict__ off, int* __restrict__ dense) {
    const long long w = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
    if (w >= nwin) return;
    const int lane = threadIdx.x & 31;
    const int n = nout[w];
    const int* __restrict__ src = syms + w * cap + nskip[w];
    int* __restrict__ dst = dense + off[w];
    for (int j = lane; j < n; j += 32) dst[j] = src[j];
}

}  // namespace

// syms: (nwin, cap); nskip, nout, off: nwin entries. The caller guarantees
// nskip[w] + nout[w] <= cap and off[w] + nout[w] <= the length of dense.
extern "C" int szt_huff_compact(const int* syms, int cap, long long nwin, const int* nskip,
                                const int* nout, const long long* off, int* dense,
                                void* stream) {
    const long long blocks = (nwin + kWarps - 1) / kWarps;
    if (blocks <= 0 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    huff_compact_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(syms, cap, nwin, nskip, nout, off,
                                                               dense);
    return static_cast<int>(cudaGetLastError());
}
