// Speculative Huffman decode of 1024-bit stream windows: the count phase.
//
// Replaces the Pallas kernel sz3_tpu/ops/entropy_decode.py::_scan_kernel
// (entry _scan). Contract (ops/entropy_decode.py::scan_windows): window w
// covers stream bits [1024 w, min(1024 (w + 1), total_bits)) and its runway
// the run_bits bits before (the runway). Item t decodes window idx[t] from the
// runway-relative bit starts[t] and records, at entry idx[t] of the outputs:
// entry = first symbol boundary >= run_bits, exit = first boundary >= the
// window's end, nskip = symbols that started in the runway, nout = symbols
// that started in the window. A start at or past the window's end is done at
// once with entry = exit = start. exit stays -1 when the walk meets bits
// that are no code (never with a complete Huffman code). In a chained launch
// (the rescans) one thread walks a run of consecutive listed windows, each
// from the exit of the one before, and on into unlisted windows for as long
// as its exit is not the entry they recorded (a stretch of windows can agree
// with each other on a lattice that is not the stream's): the counterpart of
// the TPU package's host repair of stragglers, kept on the card.
//
// The TPU kernel also stores every window's symbols in a row, because it
// cannot afford to decode twice. Here no symbol is stored: once the chain of
// windows is proven, huff_write.cu walks each window again from its proven
// entry and writes the symbols where they belong. That drops the rows (a
// buffer of (runway + 1024) / shortest code symbols per window, three
// times the stream's bytes and more) and the compaction that read them.
//
// What bounds it on the card: the latency of the walk, not bytes. A symbol
// is a chain of dependent steps and a window holds some 200 of them, while
// the bytes are the stream read once and 24 bytes per window. The design
// (huff_walk.cuh) shortens the chain: the block's stream words are staged
// in shared memory with coalesced loads, the next bits live in registers
// (one register when no code exceeds 32 bits, which the caller says once per
// launch), only the code lengths are looked up, all the short codes that lie
// whole in the 11 bits of a lookup are taken in one step (1.7 symbols a step
// at 5.5 bits a symbol), and a code longer than the 11-bit direct table costs
// one more load, not a search. One thread per
// window gives tens of thousands of independent walks to hide what latency
// remains. A chained launch reads the stream from device memory instead:
// its walks are few and run through windows that are not its block's, and
// its time is that of its longest chain.
// No float arithmetic.

#include <cuda_runtime.h>

#include "huff_walk.cuh"

using namespace szt_huff;

namespace {

// Walk on from the runway-relative bit `pos` while a symbol starts before
// `limit`, adding the symbols to n. Where the short codes that lie whole in
// the next 11 bits all start before `limit`, they are taken in one step.
// False when the walk met bits that are no code. The long-code branch has no
// way out of the loop of its own: lanes that take it join the others again
// right after it, and the test for "no code" comes after that (an exit from
// inside the branch kept a warp's lanes apart for the rest of the walk, and
// the first pass took 3.5 times as long).
template <bool Long>
__device__ __forceinline__ bool count_until(const CodeTables& tab, BitReader<Long>& r, int limit,
                                            int& pos, int& n) {
    int len = 1;
    while (pos < limit) {
        const u64 bits = r.peek();
        const unsigned e = tab.root[static_cast<unsigned>(bits >> (64 - kL1Bits))];
        len = static_cast<int>(e & 0xffu);
        int symbols = 1;
        if (CodeTables::is_short(len)) {
            const int group_bits = static_cast<int>((e >> 8) & 0xffu);
            if (pos + group_bits <= limit) {            // every one of them starts before limit
                len = group_bits;
                symbols = static_cast<int>(e >> 16);
            }
        } else {
            len = tab.long_length(e, bits);
        }
        if (len == 0) break;
        n += symbols;
        pos += len;
        r.skip(len);
    }
    return len > 0;
}

// Walk window w from the runway-relative bit `pos`, record its entry of the
// outputs, and return its exit (-1 when the walk did not end).
template <bool Long>
__device__ int scan_window(const CodeTables& tab, const WordSource& src, long long total_bits,
                           int run_bits, long long w, int pos, int* __restrict__ entry_out,
                           int* __restrict__ exit_out, int* __restrict__ nskip_out,
                           int* __restrict__ nout_out) {
    const long long base = w * kWBits - run_bits;       // absolute bit of the runway's start
    const long long left = total_bits - w * kWBits;     // stream bits from the window's start
    const int end = run_bits + static_cast<int>(left < kWBits ? left : kWBits);
    if (w == 0 && pos < run_bits) pos = run_bits;       // window 0 has no runway
    int entry = -1, exit_bit = -1, nskip = 0, nout = 0;

    if (pos >= end) {
        entry = exit_bit = pos;
    } else {
        // the symbols that start in the runway, then those that start in the
        // window; every code has a bit or more, so both walks end
        BitReader<Long> r(src, base + pos);
        if (count_until<Long>(tab, r, run_bits, pos, nskip)) {
            const int first = pos;
            const bool ended = count_until<Long>(tab, r, end, pos, nout);
            if (nskip + nout > 0) entry = first;        // bits that are no code: no entry
            if (ended) exit_bit = pos;
        }
    }
    entry_out[w] = entry;
    exit_out[w] = exit_bit;
    nskip_out[w] = nskip;
    nout_out[w] = nout;
    return exit_bit;
}

template <bool Long>
__global__ void huff_scan_kernel(CodeTables tab, const unsigned* __restrict__ words,
                                 long long nwords, long long total_bits, long long n,
                                 long long nwin, bool chain, int run_bits,
                                 const int* __restrict__ idx,
                                 const int* __restrict__ starts, const int* __restrict__ root,
                                 int* __restrict__ entry_out, int* __restrict__ exit_out,
                                 int* __restrict__ nskip_out, int* __restrict__ nout_out) {
    __shared__ unsigned s_words[kSpanSlots];
    __shared__ unsigned s_root[kL1Size];
    for (int i = threadIdx.x; i < kL1Size; i += kThreads)
        s_root[i] = static_cast<unsigned>(root[i]);
    tab.root = s_root;
    const long long first = static_cast<long long>(blockIdx.x) * kThreads;
    long long t = first + threadIdx.x;
    // the block stages its span when its items are consecutive windows (the
    // first pass lists every window in order); a chained launch never does
    const long long w0 = idx[first];
    const int in_order = t >= n || idx[t] == w0 + threadIdx.x;
    const int staged = __syncthreads_and(in_order) && !chain;
    WordSource src{words, nwords, nullptr, 0, 0};
    if (staged) {
        const int nb = static_cast<int>(n - first < kThreads ? n - first : kThreads);
        stage_span(src, s_words, w0 * kWWords - run_bits / 32,
                   run_bits / 32 + nb * kWWords + kTailWords);
    }
    __syncthreads();
    if (t >= n) return;
    long long w = idx[t];
    // chained: idx ascends, so window w - 1 is listed exactly when it is the
    // item before this one. A listed window whose predecessor is listed
    // belongs to the thread that walks the predecessor.
    if (chain && t > 0 && idx[t - 1] == w - 1) return;
    int pos = starts[t];
    for (;;) {
        const int exit_bit = scan_window<Long>(tab, src, total_bits, run_bits, w, pos, entry_out,
                                               exit_out, nskip_out, nout_out);
        if (!chain || w + 1 >= nwin) break;
        // item t is the last listed window at or before w
        const bool from_listed = idx[t] == w;
        ++w;
        if (t + 1 < n && idx[t + 1] == w) {             // the next window is listed too
            if (!from_listed) break;                    // the first of another thread's run
            ++t;
            pos = exit_bit >= 0 ? exit_bit - kWBits : starts[t];
        } else if (exit_bit >= 0 && exit_bit - kWBits != entry_out[w]) {
            pos = exit_bit - kWBits;                    // the chain is still open: walk on
        } else {
            break;
        }
    }
}

}  // namespace

// words: the stream's bytes as nwords 32-bit words, the stream's total_bits
// followed by zero bytes. run_bits: the runway, a multiple of 32 up to
// kMaxRunBits. idx/starts: n items. chain: nonzero for a chained launch, in
// which idx ascends: a thread then walks on from its window into the next
// one, from its fresh exit, while that window is listed too or its recorded
// entry is not that exit; a listed window whose predecessor is listed is
// left to the predecessor's thread, so every window has one writer. root, sub_len: the code lengths by prefix (huff_walk.cuh,
// CodeTables). deep_key/deep_len: ndeep entries sorted by key. long_codes:
// nonzero when a code exceeds 32 bits. entry/exit/nskip/nout: one entry per
// window of the nwin windows.
extern "C" int szt_huff_scan(const void* words, long long nwords, long long total_bits,
                             long long n, long long nwin, int chain, int run_bits,
                             const int* idx, const int* starts, const int* root,
                             const unsigned char* sub_len, const long long* deep_key, int ndeep,
                             const int* deep_len, int long_codes, int* entry, int* exit_bit,
                             int* nskip, int* nout, void* stream) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks <= 0 || blocks > 0x7fffffffLL || !runway_ok(run_bits))
        return static_cast<int>(cudaErrorInvalidValue);
    const CodeTables tab{nullptr, sub_len, nullptr, DeepCodes{deep_key, nullptr, deep_len, ndeep}};
    const unsigned grid = static_cast<unsigned>(blocks);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned* w = static_cast<const unsigned*>(words);
    if (long_codes)
        huff_scan_kernel<true><<<grid, kThreads, 0, s>>>(tab, w, nwords, total_bits, n, nwin,
                                                         chain != 0, run_bits, idx, starts, root,
                                                         entry, exit_bit, nskip, nout);
    else
        huff_scan_kernel<false><<<grid, kThreads, 0, s>>>(tab, w, nwords, total_bits, n, nwin,
                                                          chain != 0, run_bits, idx, starts, root,
                                                          entry, exit_bit, nskip, nout);
    return static_cast<int>(cudaGetLastError());
}
