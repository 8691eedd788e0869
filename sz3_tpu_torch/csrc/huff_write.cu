// The write phase of the Huffman decode: every window's owned symbols to
// their place in the dense stream.
//
// Replaces the Pallas kernel sz3_tpu/ops/entropy_decode.py::_compact_kernel
// (entry _compact), whose function is
//   dense[off[w] + j] = the j-th symbol that starts in window w, j < nout[w],
// with off the exclusive scan of nout (taken by the caller in int64: a 512^3
// field has more symbols than a window has bits). The TPU kernel copies the
// symbols out of per-window rows that its scan kernel stored. Here there are
// no rows: the windows' entries are proven by the time this kernel runs
// (ops/entropy_decode.py::decode_stream), so window w is decoded again, from
// absolute bit 1024 w + entry[w] - run_bits for exactly nout[w] symbols, and
// each symbol goes straight to dense. The count, not a bit position, ends
// the walk: the zero bits that pad the stream's last byte would decode to
// symbols the stream does not hold, and the caller has taken them off the
// last window's count.
//
// What bounds it on the card: bytes, chiefly the 4 bytes written per symbol
// (the stream read once is a twelfth of that at 5.5 bits per symbol), as
// long as the walk (huff_walk.cuh: stream staged in shared memory, bit
// buffer in registers, a second table for the longer codes) keeps up. A
// short code takes two shared-memory lookups, its length and its symbol.
// (A form with both in one 32-bit entry, for symbols below 2^24, read 5 %
// faster on a 16.8-million-symbol field and 5 % slower on one eight times
// the size, same card, same call: it was not kept.)
// A warp's 32 runs lie some 740 bytes apart in dense, so its stores cannot
// coalesce across lanes, and what a store costs is the 32-byte sectors it
// leaves partly written. On a synthetic 16.8-million-symbol stream (NVIDIA
// H100 80GB HBM3, 700 W) the kernel took 0.42 ms storing symbol by symbol,
// 0.19 ms storing 16 bytes at a time, 0.10 ms a whole sector at a time and
// 0.11 ms two sectors at a time; the count phase, which walks the same bits
// and stores nothing, took 0.045 ms. So a thread gathers kBatch = 8 symbols
// in registers and stores them as two 16-byte words, back to back, once its
// cursor is 32-byte aligned. A buffer in shared memory from which a warp
// would store whole 128-byte lines writes the same sectors with more work
// per symbol, and to keep all 32 lanes busy it has to hold the warp's whole
// span (some 5,900 symbols, 24 KB a warp); it was not built. Bits that are
// no code (never on a proven chain) are written as symbol 0 and the walk
// stays put.
// No float arithmetic.

#include <cuda_runtime.h>

#include "huff_walk.cuh"

using namespace szt_huff;

namespace {

// Symbols a thread gathers before it stores them: one 32-byte sector.
constexpr int kBatch = 8;

struct WriteArgs {
    const unsigned* words;
    long long nwords;
    long long nwin;
    long long count;
    int run_bits;
    const int* entry;
    const int* nout;
    const long long* off;
    const int* root;        // CodeTables::root
    const int* l1_sym;      // the short codes' symbols by prefix
};

template <bool Long>
__global__ void huff_write_kernel(WriteArgs a, CodeTables tab, int* __restrict__ dense) {
    __shared__ unsigned s_words[kSpanSlots];
    __shared__ unsigned s_root[kL1Size];
    __shared__ int s_sym[kL1Size];
    for (int i = threadIdx.x; i < kL1Size; i += kThreads) {
        s_root[i] = static_cast<unsigned>(a.root[i]);
        s_sym[i] = a.l1_sym[i];
    }
    tab.root = s_root;
    const long long w0 = static_cast<long long>(blockIdx.x) * kThreads;
    const int nb = static_cast<int>(a.nwin - w0 < kThreads ? a.nwin - w0 : kThreads);
    WordSource src{a.words, a.nwords, nullptr, 0, 0};
    stage_span(src, s_words, w0 * kWWords, nb * kWWords + kTailWords);
    __syncthreads();
    const long long w = w0 + threadIdx.x;
    if (w >= a.nwin) return;
    int n = a.nout[w];
    const long long d = a.off[w];
    if (n <= 0 || d < 0 || d >= a.count) return;
    if (d + n > a.count) n = static_cast<int>(a.count - d);
    long long bit = w * kWBits + a.entry[w] - a.run_bits;
    if (bit < 0) bit = 0;
    BitReader<Long> r(src, bit);

    auto next = [&]() -> int {
        const u64 bits = r.peek();
        const unsigned i1 = static_cast<unsigned>(bits >> (64 - kL1Bits));
        const unsigned e = s_root[i1];
        int len = static_cast<int>(e & 0xffu);
        int sym = 0;
        if (CodeTables::is_short(len))
            sym = s_sym[i1];
        else
            len = tab.long_symbol(e, bits, sym);
        // the lanes that took the long-code branch are back with the others
        // here; bits that are no code give symbol 0 and the walk stays put
        if (len > 0) r.skip(len);
        return len > 0 ? sym : 0;
    };

    int* __restrict__ out = dense + d;
    int j = 0;
    // up to the first cursor that is a multiple of kBatch symbols one by
    // one, then whole sectors, then the rest one by one
    const int head = min(n, static_cast<int>((kBatch - (d & (kBatch - 1))) & (kBatch - 1)));
    for (; j < head; ++j) out[j] = next();
    for (; j + kBatch <= n; j += kBatch) {
        int q[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) q[k] = next();
        *reinterpret_cast<int4*>(out + j) = make_int4(q[0], q[1], q[2], q[3]);
        *reinterpret_cast<int4*>(out + j + 4) = make_int4(q[4], q[5], q[6], q[7]);
    }
    for (; j < n; ++j) out[j] = next();
}

}  // namespace

// words: the stream's bytes as nwords 32-bit words. entry, nout, off: one
// entry per window of the nwin windows (entry relative to the start of a
// runway of run_bits bits, as szt_huff_scan records it). dense: count
// symbols, 32-byte aligned; a run that would pass its end is cut there.
// root, sub_len: the code tables by prefix (huff_walk.cuh, CodeTables);
// l1_sym, sub_sym: their symbols. deep_key/deep_sym/deep_len: ndeep entries
// sorted by key. long_codes: nonzero when a code exceeds 32 bits.
extern "C" int szt_huff_write(const void* words, long long nwords, long long nwin,
                              int run_bits, const int* entry, const int* nout,
                              const long long* off, long long count, int long_codes,
                              const int* root, const int* l1_sym, const unsigned char* sub_len,
                              const int* sub_sym, const long long* deep_key, int ndeep,
                              const int* deep_sym, const int* deep_len, int* dense,
                              void* stream) {
    const long long blocks = (nwin + kThreads - 1) / kThreads;
    if (blocks <= 0 || blocks > 0x7fffffffLL || !runway_ok(run_bits))
        return static_cast<int>(cudaErrorInvalidValue);
    if (reinterpret_cast<unsigned long long>(dense) & 31)
        return static_cast<int>(cudaErrorMisalignedAddress);
    const WriteArgs a{static_cast<const unsigned*>(words), nwords, nwin, count, run_bits, entry,
                      nout, off, root, l1_sym};
    const CodeTables tab{nullptr, sub_len, sub_sym, DeepCodes{deep_key, deep_sym, deep_len, ndeep}};
    const unsigned grid = static_cast<unsigned>(blocks);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (long_codes)
        huff_write_kernel<true><<<grid, kThreads, 0, s>>>(a, tab, dense);
    else
        huff_write_kernel<false><<<grid, kThreads, 0, s>>>(a, tab, dense);
    return static_cast<int>(cudaGetLastError());
}
