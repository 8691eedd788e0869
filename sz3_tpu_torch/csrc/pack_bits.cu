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
//   pass 0: the two code tables become one table of 16-byte entries (code,
//           masked to its length, and length), so a symbol costs one gather;
//   pass 1: each block sums the code lengths of its contiguous run;
//   pass 2: one block scans the per-block sums into int64 offsets (512^3
//           symbols x 32 bits exceeds 2^31) and writes the total;
//   pass 3: each block walks its run in tiles of 2048 symbols. A thread owns
//           8 consecutive symbols (two 16-byte loads), so the block scans
//           one value per thread, the thread's bits, once per tile. The
//           thread then joins its codes in a 64-bit register and puts whole
//           32-bit words into a tile buffer in shared memory at its bit
//           offset: plain stores for the words it fills alone, a shared
//           atomicOr for its first and last word, which a neighbour shares.
//           The block then writes the tile's words with coalesced plain
//           stores; only the tile's first and last word, which the tile
//           before or after may share, are ORed into device memory. The
//           words are zeroed by the caller; bit ranges are disjoint, so the
//           result does not depend on any order.
//
// What bounds it on the card: bytes moved. 4 B per symbol are read twice
// (passes 1 and 3), about 0.5-1 B per symbol are written, and the code
// table (16 B per symbol of the quantizer's range, 1 MB at radius 32768)
// stays in L2, its hot entries around the radius in L1. The bound counts the
// bins once: a single pass that looks back over the tiles' totals would
// read them once.
// No float arithmetic.

#include <cuda_runtime.h>

#include "block_scan.cuh"

using namespace szt_cuda;

namespace {

constexpr int kPerThread = 8;                   // symbols a thread owns in a tile
constexpr int kTile = kThreads * kPerThread;
constexpr int kBufWords = kTile * 2 + 1;        // 64 bits a symbol, and a shared first word

typedef unsigned long long u64;

struct __align__(16) CodeEntry {
    u64 code;                                   // right-aligned, bits above len clear
    int len;                                    // 0..64
    int unused;
};

__global__ void pack_table_kernel(const u64* __restrict__ tc, const int* __restrict__ tl,
                                  int entries, CodeEntry* __restrict__ table) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= entries) return;
    const int len = min(max(tl[i], 0), 64);
    u64 code = tc[i];
    if (len < 64) code &= (1ull << len) - 1ull;
    table[i] = CodeEntry{code, len, 0};
}

// The bins [i0, i0 + kPerThread) of the run that ends at hi, as symbol
// indices; -1 past the run's end.
__device__ __forceinline__ void load_indices(const int* __restrict__ bins, long long i0,
                                             long long hi, int n_sym, bool aligned,
                                             int (&idx)[kPerThread]) {
    if (aligned && i0 + kPerThread <= hi) {
        const int4* p = reinterpret_cast<const int4*>(bins + i0);
#pragma unroll
        for (int q = 0; q < kPerThread / 4; ++q) {
            const int4 v = __ldg(p + q);
            idx[4 * q] = sym_index(v.x, n_sym);
            idx[4 * q + 1] = sym_index(v.y, n_sym);
            idx[4 * q + 2] = sym_index(v.z, n_sym);
            idx[4 * q + 3] = sym_index(v.w, n_sym);
        }
    } else {
#pragma unroll
        for (int e = 0; e < kPerThread; ++e)
            idx[e] = i0 + e < hi ? sym_index(bins[i0 + e], n_sym) : -1;
    }
}

__global__ void pack_sum_kernel(const int* __restrict__ bins, long long n, int n_sym,
                                const CodeEntry* __restrict__ table, long long per_block,
                                long long* __restrict__ sums) {
    __shared__ long long ws[kWarps];
    const bool aligned = (reinterpret_cast<u64>(bins) & 15) == 0;
    const long long lo = blockIdx.x * per_block;
    const long long hi = min(n, lo + per_block);
    long long bits = 0;
    for (long long i0 = lo + threadIdx.x * kPerThread; i0 < hi; i0 += kTile) {
        int idx[kPerThread];
        load_indices(bins, i0, hi, n_sym, aligned, idx);
#pragma unroll
        for (int e = 0; e < kPerThread; ++e)
            if (idx[e] >= 0) bits += __ldg(&table[idx[e]].len);
    }
    long long total;
    block_exclusive_scan<long long>(bits, ws, total);
    if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

__global__ void pack_write_kernel(const int* __restrict__ bins, long long n, int n_sym,
                                  const CodeEntry* __restrict__ table, long long per_block,
                                  const long long* __restrict__ offsets, long long words_cap,
                                  unsigned* __restrict__ words) {
    __shared__ unsigned buf[kBufWords];
    __shared__ int ws[kWarps];
    for (int i = threadIdx.x; i < kBufWords; i += kThreads) buf[i] = 0u;
    const bool aligned = (reinterpret_cast<u64>(bins) & 15) == 0;
    long long base = offsets[blockIdx.x];               // stream bit of the tile's first code
    const long long lo = blockIdx.x * per_block;
    const long long hi = min(n, lo + per_block);
    for (long long tile = lo; tile < hi; tile += kTile) {
        int idx[kPerThread];
        load_indices(bins, tile + threadIdx.x * kPerThread, hi, n_sym, aligned, idx);
        u64 code[kPerThread];
        int len[kPerThread];
        int mine = 0;
#pragma unroll
        for (int e = 0; e < kPerThread; ++e) {
            code[e] = 0;
            len[e] = 0;
            if (idx[e] >= 0) {
                const int4 v = __ldg(reinterpret_cast<const int4*>(table + idx[e]));
                code[e] = (static_cast<u64>(static_cast<unsigned>(v.y)) << 32) |
                          static_cast<unsigned>(v.x);
                len[e] = v.z;
            }
            mine += len[e];
        }
        int total;                                      // at most 2048 x 64 bits
        const int before = block_exclusive_scan<int>(mine, ws, total);

        // the thread's bits start at bit `at` of the buffer, whose word 0 is
        // the stream word that holds bit `base`
        const int at = static_cast<int>(base & 31) + before;
        int wi = at >> 5;
        int fill = at & 31;                             // bits of word wi taken so far
        bool shared_word = fill != 0;                   // word wi began with a neighbour's bits
        u64 acc = 0;                                    // word wi and the next, left-aligned
        auto put = [&](unsigned piece, int bits) {      // 1..32 bits, right-aligned
            acc |= static_cast<u64>(piece) << (64 - fill - bits);
            fill += bits;
            if (fill >= 32) {
                const unsigned word = static_cast<unsigned>(acc >> 32);
                if (shared_word)
                    atomicOr(&buf[wi], word);
                else
                    buf[wi] = word;
                shared_word = false;
                ++wi;
                acc <<= 32;
                fill -= 32;
            }
        };
#pragma unroll
        for (int e = 0; e < kPerThread; ++e) {
            if (len[e] > 32) {
                put(static_cast<unsigned>(code[e] >> 32), len[e] - 32);
                put(static_cast<unsigned>(code[e]), 32);
            } else if (len[e] > 0) {
                put(static_cast<unsigned>(code[e]), len[e]);
            }
        }
        if (acc != 0) atomicOr(&buf[wi], static_cast<unsigned>(acc >> 32));
        __syncthreads();

        // the tile's words to device memory; the buffer is left zeroed. The
        // next tile's scan synchronises before any thread writes it again.
        const long long first = base >> 5;
        const int nw = (static_cast<int>(base & 31) + total + 31) >> 5;
        for (int i = threadIdx.x; i < nw; i += kThreads) {
            const unsigned word = buf[i];
            buf[i] = 0u;
            if (first + i >= words_cap) continue;       // tables that contradict total_bits
            if (i == 0 || i == nw - 1) {
                if (word) atomicOr(&words[first + i], word);
            } else {
                words[first + i] = word;
            }
        }
        base += total;
    }
}

}  // namespace

// words[0..words_cap) must be zero. The tables tc (right-aligned codes of up
// to 64 bits) and tl (their lengths) hold n_sym + 2 entries, indexed by
// symbol index; table is scratch for as many 16-byte entries. per_block is a
// multiple of 2048. offsets has blocks+1 int64 entries; on return
// offsets[blocks] holds the total bit count (the caller checks it against
// the histogram's).
extern "C" int szt_pack_bits(const int* bins, long long n, int n_sym, const long long* tc,
                             const int* tl, void* table, long long per_block, int blocks,
                             long long* offsets, long long words_cap, int* words,
                             void* stream) {
    if (per_block <= 0 || per_block % kTile || (reinterpret_cast<u64>(table) & 15))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    CodeEntry* entries = static_cast<CodeEntry*>(table);
    pack_table_kernel<<<(n_sym + 2 + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        reinterpret_cast<const u64*>(tc), tl, n_sym + 2, entries);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    pack_sum_kernel<<<blocks, kThreads, 0, s>>>(bins, n, n_sym, entries, per_block, offsets);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    scan_block_counts<long long><<<1, kThreads, 0, s>>>(offsets, blocks);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    pack_write_kernel<<<blocks, kThreads, 0, s>>>(bins, n, n_sym, entries, per_block, offsets,
                                                  words_cap, reinterpret_cast<unsigned*>(words));
    return static_cast<int>(cudaGetLastError());
}
