// The Huffman walk shared by the two decode kernels (huff_scan.cu counts a
// window's symbols, huff_write.cu writes them): where the stream's words
// come from, the bit buffer a thread walks with, and the code lookup.
//
// A block serves up to kThreads consecutive 1024-bit windows, one thread
// each. Read straight from device memory, the threads of a warp would touch
// addresses 128 bytes apart and every symbol would wait for its own loads.
// So the block first copies its windows' words (with the runway before the
// first and a tail after the last) into shared memory with coalesced loads,
// turning each big-endian word as it goes. Windows lie 32 words apart, which
// would put all threads of a warp on one bank: the copy skips one word after
// every 32 (word j sits at j + j / 32), and the threads of a warp then read
// 32 different banks. A walk that leaves the staged span (a chained rescan,
// a start the caller made up) reads device memory instead, word by word.
//
// A thread keeps the next stream bits in registers (BitReader) and takes a
// new word only when 32 bits are used up, so a symbol costs shift -> table
// lookup -> add; the word load is off that chain. Codes longer than the
// 11-bit direct table take one more load from a second table (CodeTables).
// No float arithmetic.
#ifndef SZT_HUFF_WALK_CUH
#define SZT_HUFF_WALK_CUH

#include <cuda_runtime.h>

namespace szt_huff {

constexpr int kThreads = 128;               // windows of one block
constexpr int kWBits = 1024;
constexpr int kWWords = kWBits / 32;
// The runway (how many bits before its window a speculative walk starts) is
// the caller's: a launch argument, a whole number of words up to this many.
constexpr int kMaxRunBits = 256;
constexpr int kMaxRunWords = kMaxRunBits / 32;
// a walk ends at most 63 bits past its window and has read at most 192 bits
// (win, nxt, pending) past where it stands
constexpr int kTailWords = 8;
constexpr int kSpanWords = kMaxRunWords + kThreads * kWWords + kTailWords;
constexpr int kSpanSlots = kSpanWords + kSpanWords / 32 + 1;
constexpr int kL1Bits = 11;
constexpr int kL1Size = 1 << kL1Bits;

__host__ __device__ inline bool runway_ok(int run_bits) {
    return run_bits > 0 && run_bits <= kMaxRunBits && run_bits % 32 == 0;
}

typedef unsigned long long u64;

// The stream's 32-bit words, MSB first: from the block's staged span where
// it covers them, else from device memory; zero outside the stream.
struct WordSource {
    const unsigned* global;                 // the stream as it arrived (bytes, big-endian)
    long long nwords;
    const unsigned* staged;                 // shared memory, words already turned
    long long lo, hi;                       // stream words [lo, hi) are staged

    __device__ __forceinline__ unsigned operator()(long long i) const {
        if (i >= lo && i < hi) {
            const int j = static_cast<int>(i - lo);
            return staged[j + (j >> 5)];
        }
        if (i < 0 || i >= nwords) return 0u;
        return __byte_perm(__ldg(&global[i]), 0u, 0x0123);
    }
};

// Block-wide: stage the stream words [first, first + count) into `slots`
// (kSpanSlots words of shared memory). The caller synchronises afterwards.
__device__ __forceinline__ void stage_span(WordSource& src, unsigned* slots, long long first,
                                           int count) {
    for (int j = threadIdx.x; j < count; j += kThreads) {
        const long long i = first + j;
        slots[j + (j >> 5)] =
            (i < 0 || i >= src.nwords) ? 0u : __byte_perm(__ldg(&src.global[i]), 0u, 0x0123);
    }
    src.staged = slots;
    src.lo = first;
    src.hi = first + count;
}

// Long: codes may exceed 32 bits, so the lookup wants a 64-bit peek. The
// reader then keeps the 64 bits at its position in `win`, up to 64 more in
// `nxt`, and one more word in `pending`. Otherwise one register holds the
// next 32 to 64 bits, which is all a code of up to 32 bits needs (the bits
// below are zero, and the search among the deep codewords, whose own low 32
// bits are zero then, finds the same predecessor). Either way `pending` is
// loaded when the word before it was used, long before it is needed.
template <bool Long>
struct BitReader {
    const WordSource& src;
    long long wi;                           // stream word held in `pending`
    u64 win;                                // the bits at the reader's position, left-aligned
    u64 nxt;                                // Long: the bits after win, left-aligned
    int navail;                             // valid bits of nxt (Long) or of win, 32 or more
    unsigned pending;

    __device__ __forceinline__ BitReader(const WordSource& s, long long bit) : src(s) {
        const long long w = bit >> 5;
        const int sh = static_cast<int>(bit & 31);
        const u64 a = (static_cast<u64>(src(w)) << 32) | src(w + 1);
        if (Long) {
            const u64 b = (static_cast<u64>(src(w + 2)) << 32) | src(w + 3);
            win = sh ? (a << sh) | (b >> (64 - sh)) : a;
            nxt = b << sh;
            wi = w + 4;
        } else {
            win = a << sh;
            nxt = 0;
            wi = w + 2;
        }
        navail = 64 - sh;
        pending = src(wi);
    }

    // the next bits, left-aligned: 64 of them when Long, else at least 32
    __device__ __forceinline__ u64 peek() const { return win; }

    // advance by len bits, 1 <= len <= 32
    __device__ __forceinline__ void skip32(int len) {
        if (Long) {
            win = (win << len) | (nxt >> (64 - len));
            nxt <<= len;
        } else {
            win <<= len;
        }
        navail -= len;
        if (navail < 32) {
            const u64 more = static_cast<u64>(pending) << (32 - navail);
            if (Long) nxt |= more; else win |= more;
            navail += 32;
            pending = src(++wi);
        }
    }

    // advance by len bits: 1 <= len <= 64 when Long, else <= 32
    __device__ __forceinline__ void skip(int len) {
        if (Long && len > 32) {
            skip32(32);
            len -= 32;
        }
        skip32(len);
    }
};

// The codes longer than kL1Bits: left-aligned codewords sorted as signed
// values of bits ^ 2^63 (the form the table arrives in), with their symbols
// and lengths. A prefix-free code's left-aligned codewords partition the
// 64-bit space, so the code that the bits start with is their predecessor.
struct DeepCodes {
    const long long* key;
    const int* sym;
    const int* len;
    int n;

    // index of the code that `bits` start with, -1 when none does
    __device__ __forceinline__ int find(u64 bits) const {
        const long long k = static_cast<long long>(bits ^ 0x8000000000000000ull);
        int lo = 0, hi = n;
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (__ldg(&key[mid]) <= k) lo = mid + 1; else hi = mid;
        }
        return lo - 1;
    }
};

// The code lookup. `root` (shared memory, by 11-bit prefix): the low byte is
// the length of the short code under the prefix (1..11), or 0x80 | m where
// the prefix starts longer codes that a second table resolves by their next
// m bits, or 0 where only the search among the deep codes does. The upper 24
// bits are that second table's offset for a long prefix. For a short code
// they hold the bits and the number of all the short codes that lie whole
// within the 11 bits (the count phase may take them in one step). A
// second-table entry of length 0 sends the lookup on to the search. One lane
// that meets a long code holds up its whole warp, and rare symbols are
// spread over all windows, so the second table (one load) matters more than
// its share of the symbols suggests: the search is a dozen dependent loads.
struct CodeTables {
    const unsigned* root;
    const unsigned char* sub_len;           // second tables: code lengths
    const int* sub_sym;                     // their symbols
    DeepCodes deep;

    static __device__ __forceinline__ bool is_short(int low) {
        return static_cast<unsigned>(low - 1) < static_cast<unsigned>(kL1Bits);
    }

    __device__ __forceinline__ int sub_index(unsigned entry, u64 bits) const {
        return static_cast<int>(entry >> 8) +
               static_cast<int>((bits << kL1Bits) >> (64 - (entry & 0x7fu)));
    }

    // length of the long code that `bits` start with, whose root entry is
    // `entry`; 0 when none does
    __device__ __forceinline__ int long_length(unsigned entry, u64 bits) const {
        if (entry & 0x80u) {
            const int len = __ldg(&sub_len[sub_index(entry, bits)]);
            if (len) return len;
        }
        const int at = deep.find(bits);
        if (at < 0) return 0;
        const int len = __ldg(&deep.len[at]);
        return len > 0 ? len : 0;
    }

    // the same, with the code's symbol
    __device__ __forceinline__ int long_symbol(unsigned entry, u64 bits, int& sym) const {
        if (entry & 0x80u) {
            const int i = sub_index(entry, bits);
            sym = __ldg(&sub_sym[i]);
            const int len = __ldg(&sub_len[i]);
            if (len) return len;
        }
        const int at = deep.find(bits);
        if (at < 0) return 0;
        sym = __ldg(&deep.sym[at]);
        const int len = __ldg(&deep.len[at]);
        return len > 0 ? len : 0;
    }
};

}  // namespace szt_huff

#endif
