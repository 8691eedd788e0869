// Huffman code lookup and bit packing of the stream-order bins.
//
// Replaces two Pallas kernels of sz3_tpu/ops/entropy_device.py:
// _pack_kernel (K2, packs 1024-symbol segments and reports their bit
// counts) and _splice_kernel (K3, ORs each segment into the global word
// stream at its exclusive-prefix offset). Contract: the final word stream of
// pack_bits there: the MSB-first concatenation of each symbol's code, stream
// bit 0 at the MSB of word 0. The per-segment bit counts that pack_bits also
// returns have no caller, and are dropped. The TPU kernel holds a code in one
// i32 lane and stops at 32 bits; here a code has up to 64 bits, which covers
// every Huffman tree of a stream shorter than 2^31 symbols (a tree deeper
// than 64 levels needs Fibonacci-growing counts that sum past 2^44).
//
// On the card one device-wide exclusive scan of the code lengths gives every
// symbol its global bit offset, so the segment/splice split disappears:
//   pass 1: each block sums the code lengths of its contiguous run;
//   pass 2: one block scans the per-block sums into int64 offsets (512^3
//           symbols x 32 bits exceeds 2^31) and writes the total;
//   pass 3: each block walks its run tile by tile, takes the in-tile
//           exclusive scan of the lengths, and ORs each code into the words
//           with atomicOr: a code of more than 32 bits as two pieces (its top
//           len-32 bits, then its low 32), each piece into at most two
//           32-bit words, so a code touches at most three words. The words
//           are zeroed by the caller; the bit ranges are disjoint, so the
//           order of the ORs does not matter and the result is deterministic.
//
// What bounds it on the card: bytes moved. 4 B per symbol are read twice
// (passes 1 and 3), about 0.5-1 B per symbol are written, and the code
// tables (12 B per symbol of the quantizer's range, 768 KB at radius 32768)
// stay in L2. Neighbouring symbols share words, so the atomics contend a few
// ways; the design accepts that for now.
// No float arithmetic.

#include <cuda_runtime.h>

#include "block_scan.cuh"

using namespace szt_cuda;

namespace {

__global__ void pack_sum_kernel(const int* __restrict__ bins, long long n, int n_sym,
                                const int* __restrict__ tl, long long per_block,
                                long long* __restrict__ sums) {
    __shared__ long long ws[kWarps];
    const long long lo = blockIdx.x * per_block;
    const long long hi = min(n, lo + per_block);
    long long bits = 0;
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads)
        bits += __ldg(&tl[sym_index(bins[i], n_sym)]);
    long long total;
    block_exclusive_scan<long long>(bits, ws, total);
    if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// OR the right-aligned code `code` of `len` bits (1..32) into the words at
// stream bit `off`; it spans at most two words.
__device__ __forceinline__ void put_bits(unsigned* __restrict__ words, long long words_cap,
                                         long long off, unsigned code, int len) {
    const long long w = off >> 5;
    const int end = static_cast<int>(off & 31) + len;  // 1..63
    if (end <= 32) {
        if (w < words_cap) atomicOr(&words[w], code << (32 - end));
    } else if (w + 1 < words_cap) {
        atomicOr(&words[w], code >> (end - 32));
        atomicOr(&words[w + 1], code << (64 - end));
    }
}

__global__ void pack_write_kernel(const int* __restrict__ bins, long long n, int n_sym,
                                  const unsigned long long* __restrict__ tc,
                                  const int* __restrict__ tl, long long per_block,
                                  const long long* __restrict__ offsets, long long words_cap,
                                  unsigned* __restrict__ words) {
    __shared__ long long ws[kWarps];
    long long base = offsets[blockIdx.x];
    const long long lo = blockIdx.x * per_block;
    const long long hi = min(n, lo + per_block);
    for (long long t = lo; t < hi; t += kThreads) {
        const long long i = t + threadIdx.x;
        int len = 0;
        unsigned long long code = 0;
        if (i < hi) {
            const int idx = sym_index(bins[i], n_sym);
            len = __ldg(&tl[idx]);
            code = __ldg(&tc[idx]);
            if (len < 64) code &= (1ull << len) - 1ull;
        }
        long long total;
        long long off = base + block_exclusive_scan<long long>(len, ws, total);
        if (len > 32) {
            put_bits(words, words_cap, off, static_cast<unsigned>(code >> 32), len - 32);
            off += len - 32;
            len = 32;
        }
        if (len > 0) put_bits(words, words_cap, off, static_cast<unsigned>(code), len);
        base += total;
    }
}

}  // namespace

// words[0..words_cap) must be zero. The tables tc (right-aligned codes of up
// to 64 bits) and tl (their lengths) hold n_sym + 2 entries, indexed by
// symbol index. offsets has blocks+1 int64 entries; on return
// offsets[blocks] holds the total bit count (the caller checks it against
// the histogram's).
extern "C" int szt_pack_bits(const int* bins, long long n, int n_sym, const long long* tc,
                             const int* tl, long long per_block, int blocks,
                             long long* offsets, long long words_cap, int* words,
                             void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    pack_sum_kernel<<<blocks, kThreads, 0, s>>>(bins, n, n_sym, tl, per_block, offsets);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    scan_block_counts<long long><<<1, kThreads, 0, s>>>(offsets, blocks);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    pack_write_kernel<<<blocks, kThreads, 0, s>>>(
        bins, n, n_sym, reinterpret_cast<const unsigned long long*>(tc), tl, per_block, offsets,
        words_cap, reinterpret_cast<unsigned*>(words));
    return static_cast<int>(cudaGetLastError());
}
