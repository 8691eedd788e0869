// Speculative Huffman decode of 1024-bit stream windows.
//
// Replaces the Pallas kernel sz3_tpu/ops/entropy_decode.py::_scan_kernel
// (entry _scan). Contract (ops/entropy_decode.py::scan_windows): window w
// covers stream bits [1024 w, min(1024 (w + 1), total_bits)) and its runway
// the 64 bits before. Item t decodes window idx[t] from the runway-relative
// bit starts[t] and records, at row idx[t] of the outputs: entry = first
// symbol boundary >= 64, exit = first boundary >= the window's end, nskip =
// symbols that started in the runway, nout = symbols that started in the
// window, and all nskip + nout symbols at syms[w, :]. A start at or past the
// window's end is done at once with entry = exit = start. exit stays -1 when
// the walk meets bits that are no code (never with a complete Huffman code)
// or runs out of row. In a chained launch (the rescans) one thread walks a
// run of consecutive listed windows, each from the exit of the one before,
// and on into unlisted windows for as long as its exit is not the entry they
// recorded (a stretch of windows can agree with each other on a lattice that
// is not the stream's): the counterpart of the TPU package's host repair of
// stragglers, kept on the card.
//
// The TPU kernel holds each window's words in a shift-register tile, steps
// all windows in lockstep and searches the deep codes through lane gathers,
// because its vector unit cannot gather. Here one thread owns one window
// and gathers freely: the next 64 stream bits are three big-endian 32-bit
// words from global memory (the stream arrives as bytes; __byte_perm turns
// each word) joined by funnel shifts; an 11-bit direct table in shared
// memory resolves the short codes, and a longer code is the predecessor of
// those 64 bits among the sorted left-aligned deep codewords, by binary
// search (compared as signed values of bits ^ 2^63, the form the table
// arrives in). Codes of up to 64 bits decode.
//
// What bounds it on the card: latency, not bytes. Each symbol is a chain of
// dependent loads (stream words, table entry), and the threads of a warp
// walk windows 128 bytes apart and write rows `cap` ints apart, so neither
// reads nor writes coalesce. The design accepts that: one thread per window
// gives tens of thousands of independent walks, which is what hides the
// latency. Decoding twice (count, then write at the final offsets) would
// drop the per-window rows; that is later work.
// No float arithmetic.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWBits = 1024;
constexpr int kRunBits = 64;
constexpr int kL1Bits = 11;
constexpr int kL1Size = 1 << kL1Bits;

__device__ __forceinline__ unsigned be_word(const unsigned* __restrict__ words, long long i) {
    return __byte_perm(__ldg(&words[i]), 0u, 0x0123);
}

// The 64 stream bits that start at absolute bit `bit` (MSB first).
__device__ __forceinline__ unsigned long long peek64(const unsigned* __restrict__ words,
                                                     long long bit) {
    const long long wi = bit >> 5;
    const unsigned sh = static_cast<unsigned>(bit & 31);
    const unsigned w0 = be_word(words, wi);
    const unsigned w1 = be_word(words, wi + 1);
    const unsigned w2 = be_word(words, wi + 2);
    const unsigned hi = __funnelshift_l(w1, w0, sh);
    const unsigned lo = __funnelshift_l(w2, w1, sh);
    return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// Everything one walk reads.
struct ScanArgs {
    const unsigned* words;
    long long nwords;
    long long total_bits;
    const long long* deep_key;
    int ndeep;
    const int* deep_sym;
    const int* deep_len;
    int cap;
};

// Walk window w from the runway-relative bit `pos`, write its row of the
// outputs, and return its exit (-1 when the walk did not end).
__device__ int scan_window(const ScanArgs& a, const int* s_sym, const unsigned char* s_len,
                           long long w, int pos, int* __restrict__ syms,
                           int* __restrict__ entry_out, int* __restrict__ exit_out,
                           int* __restrict__ nskip_out, int* __restrict__ nout_out) {
    const long long base = w * kWBits - kRunBits;       // absolute bit of the runway's start
    const long long left = a.total_bits - w * kWBits;   // stream bits from the window's start
    const int end = kRunBits + static_cast<int>(left < kWBits ? left : kWBits);
    if (w == 0 && pos < kRunBits) pos = kRunBits;       // window 0 has no runway
    int entry = -1, exit_bit = -1, nskip = 0, nout = 0;
    int* __restrict__ row = syms + w * a.cap;

    if (pos >= end) {
        entry = exit_bit = pos;
    } else {
        for (int step = 0; step < a.cap; ++step) {
            const long long bit = base + pos;
            if ((bit >> 5) + 2 >= a.nwords) break;      // never: the caller pads the stream
            const unsigned long long bits = peek64(a.words, bit);
            const unsigned i1 = static_cast<unsigned>(bits >> (64 - kL1Bits));
            int len = s_len[i1];
            int sym = s_sym[i1];
            if (len == 0) {                             // a deep code: predecessor search
                const long long key = static_cast<long long>(bits ^ 0x8000000000000000ull);
                int lo = 0, hi = a.ndeep;
                while (lo < hi) {
                    const int mid = (lo + hi) >> 1;
                    if (__ldg(&a.deep_key[mid]) <= key) lo = mid + 1; else hi = mid;
                }
                if (lo == 0) break;                     // no code starts with these bits
                sym = __ldg(&a.deep_sym[lo - 1]);
                len = __ldg(&a.deep_len[lo - 1]);
                if (len <= 0) break;
            }
            row[step] = sym;
            const int newpos = pos + len;
            if (pos < kRunBits) {
                ++nskip;
                if (newpos >= kRunBits) entry = newpos;
            } else {
                if (entry < 0) entry = pos;
                ++nout;
            }
            pos = newpos;
            if (newpos >= end) {
                exit_bit = newpos;
                break;
            }
        }
    }
    entry_out[w] = entry;
    exit_out[w] = exit_bit;
    nskip_out[w] = nskip;
    nout_out[w] = nout;
    return exit_bit;
}

__global__ void huff_scan_kernel(ScanArgs a, long long n, long long nwin,
                                 const unsigned char* __restrict__ listed,
                                 const int* __restrict__ idx, const int* __restrict__ starts,
                                 const int* __restrict__ l1_sym, const int* __restrict__ l1_len,
                                 int* __restrict__ syms, int* __restrict__ entry_out,
                                 int* __restrict__ exit_out, int* __restrict__ nskip_out,
                                 int* __restrict__ nout_out) {
    __shared__ int s_sym[kL1Size];
    __shared__ unsigned char s_len[kL1Size];
    for (int i = threadIdx.x; i < kL1Size; i += kThreads) {
        s_sym[i] = l1_sym[i];
        s_len[i] = static_cast<unsigned char>(l1_len[i]);
    }
    __syncthreads();
    long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (t >= n) return;
    long long w = idx[t];
    // chained: a listed window whose predecessor is listed belongs to the
    // thread that walks the predecessor
    if (listed != nullptr && w > 0 && listed[w - 1]) return;
    int pos = starts[t];
    for (;;) {
        const int exit_bit = scan_window(a, s_sym, s_len, w, pos, syms, entry_out, exit_out,
                                         nskip_out, nout_out);
        if (listed == nullptr || w + 1 >= nwin) break;
        const bool from_listed = listed[w];
        ++w;
        if (listed[w]) {
            if (!from_listed) break;                    // the first of another thread's run
            ++t;                                        // the next item of idx
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
// followed by at least 16 zero bytes. idx/starts: n items. listed: null, or
// one byte per window of the nwin windows, nonzero for the windows of idx,
// which then ascends: the launch is chained. A thread then walks on from
// its window into the next one, from its fresh exit, while that window is
// listed too or its recorded entry is not that exit; a listed window whose
// predecessor is listed is left to the predecessor's thread, so every
// window has one writer. l1_sym/l1_len: 2048 entries (length 0 marks a deep
// code). deep_key/deep_sym/deep_len: ndeep entries sorted by key. syms:
// (nwin, cap); entry/exit/nskip/nout: one entry per window.
extern "C" int szt_huff_scan(const void* words, long long nwords, long long total_bits,
                             long long n, long long nwin, const unsigned char* listed,
                             const int* idx, const int* starts, const int* l1_sym,
                             const int* l1_len, const long long* deep_key, int ndeep,
                             const int* deep_sym, const int* deep_len, int cap, int* syms,
                             int* entry, int* exit_bit, int* nskip, int* nout, void* stream) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks <= 0 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const ScanArgs a{static_cast<const unsigned*>(words), nwords, total_bits, deep_key, ndeep,
                     deep_sym, deep_len, cap};
    huff_scan_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        a, n, nwin, listed, idx, starts, l1_sym, l1_len, syms, entry, exit_bit, nskip, nout);
    return static_cast<int>(cudaGetLastError());
}
