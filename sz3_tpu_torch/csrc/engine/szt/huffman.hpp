// Huffman codec for quantization-bin streams.
//
// Stream format and tree construction are bit-compatible with the reference
// encoder (encoder/HuffmanEncoder.hpp): same deterministic tree (leaves seeded
// in symbol order into a binary min-heap with the reference's exact sift
// semantics, HuffmanEncoder.hpp:440-470,539-557), same serialized tree
// (preorder-padded L/R/C/t arrays behind [offset][nodeCount BE][stateNum/2 BE]
// [endian byte], HuffmanEncoder.hpp:108-125,563-628), and same MSB-first
// bitstream behind a size_t length prefix (HuffmanEncoder.hpp:140-218).
#ifndef SZT_HUFFMAN_HPP
#define SZT_HUFFMAN_HPP

#include <algorithm>
#include <cstdint>
#include <tuple>
#include <vector>

#include "common.hpp"

namespace szt {

inline void be32(uint8_t* p, uint32_t v) {
    p[0] = uint8_t(v >> 24); p[1] = uint8_t(v >> 16);
    p[2] = uint8_t(v >> 8);  p[3] = uint8_t(v);
}
inline uint32_t rd_be32(const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
           (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

template <class T>
class Huffman {
  public:
    // ---- encode side -------------------------------------------------------

    // Build the code table from the data. `state_hint` mirrors the reference's
    // stateNum argument; the effective alphabet is [min(bins), max(bins)].
    void build(const T* bins, size_t n) {
        if (n == 0) throw std::runtime_error("huffman: empty input");
        // fast path: quant-bin domains are small non-negative ints, so one
        // histogram pass replaces the min/max scan + shifted histogram
        if (build_onepass(bins, n)) return;
        T lo = bins[0], hi = bins[0];
        for (size_t i = 0; i < n; i++) {
            lo = std::min(lo, bins[i]);
            hi = std::max(hi, bins[i]);
        }
        offset_ = lo;
        state_num_ = static_cast<uint32_t>(int64_t(hi) - int64_t(lo) + 2);
        // 4-way split histogram: consecutive increments of the same bucket
        // would stall on store-to-load forwarding in a single table
        std::vector<size_t> freq(state_num_, 0);
        if (size_t(state_num_) * 4 <= (1u << 22)) {
            std::vector<size_t> sub(size_t(state_num_) * 4, 0);
            size_t* f0 = sub.data();
            size_t* f1 = f0 + state_num_;
            size_t* f2 = f1 + state_num_;
            size_t* f3 = f2 + state_num_;
            size_t i = 0;
            for (; i + 4 <= n; i += 4) {
                f0[size_t(int64_t(bins[i]) - int64_t(lo))]++;
                f1[size_t(int64_t(bins[i + 1]) - int64_t(lo))]++;
                f2[size_t(int64_t(bins[i + 2]) - int64_t(lo))]++;
                f3[size_t(int64_t(bins[i + 3]) - int64_t(lo))]++;
            }
            for (; i < n; i++) f0[size_t(int64_t(bins[i]) - int64_t(lo))]++;
            for (size_t s = 0; s < state_num_; s++) freq[s] = f0[s] + f1[s] + f2[s] + f3[s];
        } else {
            for (size_t i = 0; i < n; i++) freq[size_t(int64_t(bins[i]) - int64_t(lo))]++;
        }
        build_from_freq(freq);
    }

    // One-pass histogram over [0, 2^18); falls back (returns false) the
    // moment a value leaves that window. Produces the identical tree: the
    // frequency vector handed to build_from_freq matches the two-pass one.
    bool build_onepass(const T* bins, size_t n) {
        static constexpr uint32_t W = 1u << 18;
        // not worth the 2 MB zero-fill + tail scans for small streams
        // (selection/coefficient side channels, tuner trials)
        if (n < (size_t(1) << 16)) return false;
        std::vector<size_t> table(W, 0);
        size_t i = 0;
        for (; i + 4 <= n; i += 4) {
            uint32_t a = uint32_t(bins[i]), b = uint32_t(bins[i + 1]);
            uint32_t c = uint32_t(bins[i + 2]), d = uint32_t(bins[i + 3]);
            if ((a | b | c | d) >= W) return false;
            table[a]++; table[b]++; table[c]++; table[d]++;
        }
        for (; i < n; i++) {
            uint32_t v = uint32_t(bins[i]);
            if (v >= W) return false;
            table[v]++;
        }
        uint32_t lo = 0, hi = W - 1;
        while (!table[lo]) lo++;
        while (!table[hi]) hi--;
        if (hi + 2 > W) return false;  // keep the +1 sentinel slot in range
        offset_ = T(lo);
        state_num_ = hi - lo + 2;
        std::vector<size_t> freq(table.begin() + lo, table.begin() + lo + state_num_);
        build_from_freq(freq);
        return true;
    }

    // Build directly from an externally-computed histogram (device path):
    // offset/freq must follow the reference convention (offset = min symbol,
    // freq covers [offset, max+1] with a trailing zero sentinel slot).
    void build_hist(T offset, const std::vector<size_t>& freq) {
        offset_ = offset;
        build_from_freq(freq);
    }

    // Export right-aligned 32-bit codes + lengths for the device bit-packer.
    // Returns false when any code exceeds 32 bits (caller falls back to the
    // host encoder, which supports the full 128-bit format).
    bool export_codes32(uint32_t* codes, uint8_t* lens) const {
        for (uint32_t s = 0; s < state_num_; s++) {
            int len = code_len_[s];
            if (len > 32) return false;
            lens[s] = uint8_t(len);
            codes[s] = len ? uint32_t(code_hi_[s] >> (64 - len)) : 0;
        }
        return true;
    }

    void build_from_freq(const std::vector<size_t>& freq) {
        state_num_ = uint32_t(freq.size());
        pool_freq_.clear(); pool_sym_.clear(); pool_leaf_.clear();
        pool_l_.clear(); pool_r_.clear();
        heap_.assign(1, -1);  // heap_[0] unused; root at index 1

        // Leaves enter the heap in symbol order so ties resolve exactly like
        // the reference's fixed iteration (HuffmanEncoder.hpp:539-547).
        for (uint32_t s = 0; s < state_num_; s++)
            if (freq[s]) heap_push(new_leaf(T(s), freq[s]));
        while (heap_.size() > 2) {
            int l = heap_pop();
            int r = heap_pop();
            heap_push(new_inner(l, r));
        }
        root_ = heap_.size() == 2 ? heap_[1] : -1;
        if (root_ < 0) throw std::runtime_error("huffman: no symbols");

        code_hi_.assign(state_num_, 0);
        code_lo_.assign(state_num_, 0);
        code_len_.assign(state_num_, 0);
        assign_codes(root_, 0, 0, 0);
        // full binary tree: #nodes = 2*#leaves - 1 (= reference nodeCount,
        // HuffmanEncoder.hpp:102-104)
        node_count_ = uint32_t(pool_freq_.size());
    }

    // Serialized tree: [offset(T)][nodeCount BE u32][stateNum/2 BE u32]
    // [endian byte][L[]][R[]][C[]][t[]] with preorder node numbering.
    void save(Sink& out) const {
        out.put(offset_);
        size_t p = out.skip(8);
        be32(out.at(p), node_count_);
        be32(out.at(p) + 4, state_num_ / 2);
        if (node_count_ <= 256) save_padded<uint8_t>(out);
        else if (node_count_ <= 65536) save_padded<uint16_t>(out);
        else save_padded<uint32_t>(out);
    }

    // MSB-first concatenation of per-symbol codes behind a u64 LE byte-length
    // prefix (matches HuffmanEncoder.hpp:140-218 output bytes).
    void encode(const T* bins, size_t n, Sink& out) const {
        size_t size_pos = out.skip(sizeof(size_t));
        uint64_t acc = 0;  // bits accumulate from MSB side
        int nbits = 0;
        size_t start = out.size();
        for (size_t i = 0; i < n; i++) {
            uint32_t s = uint32_t(int64_t(bins[i]) - int64_t(offset_));
            int len = code_len_[s];
            uint64_t w0 = code_hi_[s];  // MSB-aligned first 64 bits
            int take0 = len <= 64 ? len : 64;
            // fold w0's top take0 bits into acc
            int room = 64 - nbits;
            if (take0 <= room) {
                acc |= (take0 ? (w0 >> nbits) : 0);
                nbits += take0;
            } else {
                acc |= w0 >> nbits;
                flush64(out, acc);
                acc = take0 - room ? (w0 << room) : 0;
                nbits = take0 - room;
            }
            if (nbits == 64) { flush64(out, acc); acc = 0; nbits = 0; }
            if (len > 64) {
                uint64_t w1 = code_lo_[s];
                int take1 = len - 64;
                room = 64 - nbits;
                if (take1 <= room) {
                    acc |= w1 >> nbits;
                    nbits += take1;
                } else {
                    acc |= w1 >> nbits;
                    flush64(out, acc);
                    acc = w1 << room;
                    nbits = take1 - room;
                }
                if (nbits == 64) { flush64(out, acc); acc = 0; nbits = 0; }
            }
        }
        if (nbits > 0) {
            uint8_t tail[8];
            for (int b = 0; b < 8; b++) tail[b] = uint8_t(acc >> (56 - 8 * b));
            out.raw(tail, size_t((nbits + 7) / 8));
        }
        out.patch(size_pos, size_t(out.size() - start));
    }

    // ---- decode side -------------------------------------------------------

    void load(Source& in) {
        offset_ = in.template get<T>();
        uint8_t hdr[8];
        in.raw(hdr, 8);
        node_count_ = rd_be32(hdr);
        state_num_ = rd_be32(hdr + 4) * 2;
        in.advance(1);  // endian byte
        // the tree's four arrays must be in the stream before they are sized
        size_t idx = node_count_ <= 256 ? 1 : node_count_ <= 65536 ? 2 : 4;
        if (node_count_ == 0 || node_count_ > in.remaining() / (2 * idx + sizeof(T) + 1))
            throw std::runtime_error("huffman: bad node count");
        if (node_count_ <= 256) load_padded<uint8_t>(in);
        else if (node_count_ <= 65536) load_padded<uint16_t>(in);
        else load_padded<uint32_t>(in);
        build_decode_table();
    }

    void decode(Source& in, size_t count, T* out) const {
        size_t enc_len = in.template get<size_t>();
        const uint8_t* bytes = in.cursor();
        in.advance(enc_len);
        if (pool_leaf_[root_]) {  // constant stream (HuffmanEncoder.hpp:233-237)
            T v = T(int64_t(pool_sym_[root_]) + int64_t(offset_));
            std::fill(out, out + count, v);
            return;
        }
        // Bit reader over the stream; table-accelerated where codes fit in
        // TABLE_BITS, falling back to a bitwise tree walk for long codes.
        // Hot loop peeks via one unaligned 64-bit big-endian load; the last
        // 8 stream bytes go through the bounds-checked slow peek.
        size_t nbytes = enc_len;
        uint64_t bitpos = 0;
        const uint64_t total_bits = uint64_t(nbytes) * 8;
        const uint64_t safe_bits = nbytes >= 8 ? (uint64_t(nbytes) - 8) * 8 : 0;
        const DecEntry* tbl = table_.data();
        size_t k = 0;
        // hot loop: up to two symbols per table hit (the lookup chain through
        // bitpos is the latency bottleneck; short codes pack in pairs)
        while (k + 1 < count && bitpos < safe_bits) {
            uint64_t w;
            std::memcpy(&w, bytes + (bitpos >> 3), 8);
            w = __builtin_bswap64(w);
            uint32_t peeked = uint32_t(w >> (64 - TABLE_BITS - int(bitpos & 7))) &
                              ((1u << TABLE_BITS) - 1);
            const DecEntry& e = tbl[peeked];
            if (e.n == 2) {
                out[k++] = e.v0;
                out[k++] = e.v1;
                bitpos += e.len;
            } else if (e.n == 1) {
                out[k++] = e.v0;
                bitpos += e.d1;
            } else {
                bitpos = slow_one(bytes, bitpos, total_bits, e, out[k++]);
            }
        }
        for (; k < count; k++) {
            uint32_t peeked = peek_bits(bytes, nbytes, bitpos, total_bits);
            const DecEntry& e = tbl[peeked];
            if (e.n) {
                out[k] = e.v0;
                bitpos += e.d1;
            } else {
                // bounds-checked walk from the root (codes near the stream
                // tail may be longer than the zero-padded peek window)
                int node = root_;
                uint64_t bp = bitpos;
                while (!pool_leaf_[node]) {
                    int bit = bp < total_bits ? (bytes[bp >> 3] >> (7 - (bp & 7))) & 1 : 0;
                    node = bit ? pool_r_[node] : pool_l_[node];
                    bp++;
                }
                out[k] = T(int64_t(pool_sym_[node]) + int64_t(offset_));
                bitpos = bp;
            }
        }
    }

    uint32_t state_num() const { return state_num_; }
    T offset() const { return offset_; }
    bool constant_stream() const { return pool_leaf_[root_] != 0; }
    T constant_symbol() const {
        return T(int64_t(pool_sym_[root_]) + int64_t(offset_));
    }

    // After load(): the encode-side code arrays are only populated by
    // build_from_freq, so recover per-symbol (code, len) by walking the
    // reconstructed tree. Codes are right-aligned in CodeT (uint32_t or
    // uint64_t); returns false if any code is longer than CodeT (the caller
    // picks the width its decode kernel takes).
    // Sizing by max leaf symbol + 1 (the serialized stateNum/2*2 round-trip
    // can shrink an odd stateNum by one).
    template <class CodeT>
    bool export_loaded_codes(std::vector<CodeT>& codes,
                             std::vector<uint8_t>& lens) const {
        constexpr int kMaxLen = int(8 * sizeof(CodeT));
        int64_t maxs = -1;
        for (uint32_t i = 0; i < node_count_; i++)
            if (pool_leaf_[i]) maxs = std::max(maxs, int64_t(pool_sym_[i]));
        if (maxs > int64_t(state_num_)) throw std::runtime_error("huffman: symbol past stateNum");
        codes.assign(size_t(maxs + 1), 0);
        lens.assign(size_t(maxs + 1), 0);
        // iterative DFS: (node, code, len)
        std::vector<std::tuple<int, CodeT, int>> st;
        st.emplace_back(root_, CodeT(0), 0);
        bool ok = true;
        while (!st.empty()) {
            auto [node, code, len] = st.back();
            st.pop_back();
            if (pool_leaf_[node]) {
                if (len > kMaxLen) { ok = false; continue; }
                // each symbol one leaf, so the exported code is complete
                if (int64_t(pool_sym_[node]) < 0 || lens[size_t(pool_sym_[node])] != 0)
                    throw std::runtime_error("huffman: negative or repeated symbol");
                codes[size_t(pool_sym_[node])] = code;
                lens[size_t(pool_sym_[node])] = uint8_t(len);
                continue;
            }
            if (len >= kMaxLen) { ok = false; continue; }
            st.emplace_back(pool_l_[node], CodeT(code << 1), len + 1);
            st.emplace_back(pool_r_[node], CodeT((code << 1) | CodeT(1)), len + 1);
        }
        return ok;
    }

  private:
    // node pool; creation order mirrors the reference pool so heap ties and
    // preorder serialization agree byte-for-byte.
    std::vector<size_t> pool_freq_;
    std::vector<T> pool_sym_;
    std::vector<uint8_t> pool_leaf_;
    std::vector<int> pool_l_, pool_r_;
    std::vector<int> heap_;
    int root_ = -1;

    std::vector<uint64_t> code_hi_, code_lo_;
    std::vector<uint8_t> code_len_;
    uint32_t node_count_ = 0;
    uint32_t state_num_ = 0;
    T offset_ = 0;

    // Lookups chain through bitpos, so decode speed is bound by table-access
    // latency: 11-bit prefixes x 12 bytes = 24 KB stays cache-resident, and
    // each entry carries up to TWO decoded symbols (offset pre-applied).
    static constexpr int TABLE_BITS = 11;
    struct DecEntry {
        T v0;          // first decoded value (offset applied) when n >= 1,
                       // else the subtree node to continue from (-1: root)
        T v1;          // second decoded value when n == 2
        uint8_t n;     // symbols decoded by this prefix (0 = slow path)
        uint8_t d1;    // bit length of the first symbol
        uint8_t len;   // total bit length of the n symbols
        uint8_t pad_{};
    };
    static_assert(sizeof(DecEntry) == 12, "DecEntry must stay 12 bytes");
    std::vector<DecEntry> table_;

    // slow path: tree-walk one symbol starting from e (long code / tail);
    // bounded by the stream end (reads past it decode as 0-bits) and by the
    // node count (a malformed cyclic tree throws instead of spinning)
    uint64_t slow_one(const uint8_t* bytes, uint64_t bitpos, uint64_t total_bits,
                      const DecEntry& e, T& out) const {
        int node = int(e.v0) >= 0 ? int(e.v0) : root_;
        uint64_t bp = int(e.v0) >= 0 ? bitpos + TABLE_BITS : bitpos;
        uint32_t steps = 0;
        while (!pool_leaf_[node]) {
            int bit = bp < total_bits ? (bytes[bp >> 3] >> (7 - (bp & 7))) & 1 : 0;
            node = bit ? pool_r_[node] : pool_l_[node];
            bp++;
            if (++steps > node_count_) throw std::runtime_error("huffman: malformed code walk");
        }
        out = T(int64_t(pool_sym_[node]) + int64_t(offset_));
        return bp;
    }

    int new_leaf(T sym, size_t freq) {
        pool_freq_.push_back(freq);
        pool_sym_.push_back(sym);
        pool_leaf_.push_back(1);
        pool_l_.push_back(-1);
        pool_r_.push_back(-1);
        return int(pool_freq_.size()) - 1;
    }
    int new_inner(int l, int r) {
        pool_freq_.push_back(pool_freq_[l] + pool_freq_[r]);
        pool_sym_.push_back(T(0));
        pool_leaf_.push_back(0);
        pool_l_.push_back(l);
        pool_r_.push_back(r);
        return int(pool_freq_.size()) - 1;
    }

    // Binary min-heap with the reference's exact comparison/tie semantics
    // (qinsert/qremove, HuffmanEncoder.hpp:440-470).
    void heap_push(int n) {
        size_t i = heap_.size();
        heap_.push_back(-1);
        while (size_t j = i >> 1) {
            if (pool_freq_[heap_[j]] <= pool_freq_[n]) break;
            heap_[i] = heap_[j];
            i = j;
        }
        heap_[i] = n;
    }
    int heap_pop() {
        int qend = int(heap_.size());
        if (qend < 2) return -1;
        int n = heap_[1];
        qend--;
        heap_[1] = heap_[qend];
        heap_.pop_back();
        size_t i = 1;
        while (true) {
            size_t l = i << 1;
            if (l >= size_t(qend)) break;
            if (l + 1 < size_t(qend) && pool_freq_[heap_[l + 1]] < pool_freq_[heap_[l]]) l++;
            if (pool_freq_[heap_[i]] > pool_freq_[heap_[l]]) {
                std::swap(heap_[i], heap_[l]);
                i = l;
            } else {
                break;
            }
        }
        return n;
    }

    // Depth-first 0/1 assignment; codes stored MSB-aligned in two u64 words
    // exactly like build_code (HuffmanEncoder.hpp:478-508).
    void assign_codes(int node, int len, uint64_t w0, uint64_t w1) {
        if (pool_leaf_[node]) {
            uint32_t s = uint32_t(pool_sym_[node]);
            if (len <= 64) {
                code_hi_[s] = len ? (w0 << (64 - len)) : 0;
                code_lo_[s] = 0;
            } else {
                code_hi_[s] = w0;
                code_lo_[s] = w1 << (128 - len);
            }
            code_len_[s] = uint8_t(len);
            return;
        }
        if ((len >> 6) == 0) {  // bits still fit the first word
            assign_codes(pool_l_[node], len + 1, w0 << 1, 0);
            assign_codes(pool_r_[node], len + 1, (w0 << 1) | 1, 0);
        } else {  // first word frozen (MSB-complete at len 64); grow second
            uint64_t t = (len % 64 != 0) ? (w1 << 1) : w1;
            assign_codes(pool_l_[node], len + 1, w0, t);
            assign_codes(pool_r_[node], len + 1, w0, t | 1);
        }
    }

    static void flush64(Sink& out, uint64_t acc) {
        uint8_t b[8];
        for (int i = 0; i < 8; i++) b[i] = uint8_t(acc >> (56 - 8 * i));
        out.raw(b, 8);
    }

    template <class IdxT>
    void save_padded(Sink& out) const {
        std::vector<IdxT> L(node_count_, 0), R(node_count_, 0);
        std::vector<T> C(node_count_, T(0));
        std::vector<uint8_t> t(node_count_, 0);
        uint32_t next = 0;
        pad_preorder<IdxT>(root_, 0, next, L, R, C, t);
        out.put<uint8_t>(0);  // endian byte: little (HuffmanEncoder.hpp:617)
        out.put_n(L.data(), node_count_);
        out.put_n(R.data(), node_count_);
        out.put_n(C.data(), node_count_);
        out.put_n(t.data(), node_count_);
    }

    template <class IdxT>
    void pad_preorder(int node, uint32_t slot, uint32_t& next, std::vector<IdxT>& L,
                      std::vector<IdxT>& R, std::vector<T>& C, std::vector<uint8_t>& t) const {
        C[slot] = pool_sym_[node];
        t[slot] = pool_leaf_[node];
        if (pool_l_[node] >= 0) {
            uint32_t child = ++next;
            L[slot] = IdxT(child);
            pad_preorder<IdxT>(pool_l_[node], child, next, L, R, C, t);
        }
        if (pool_r_[node] >= 0) {
            uint32_t child = ++next;
            R[slot] = IdxT(child);
            pad_preorder<IdxT>(pool_r_[node], child, next, L, R, C, t);
        }
    }

    template <class IdxT>
    void load_padded(Source& in) {
        std::vector<IdxT> L(node_count_), R(node_count_);
        std::vector<T> C(node_count_);
        std::vector<uint8_t> t(node_count_);
        in.get_n(L.data(), node_count_);
        in.get_n(R.data(), node_count_);
        in.get_n(C.data(), node_count_);
        in.get_n(t.data(), node_count_);
        pool_freq_.assign(node_count_, 0);
        pool_sym_.assign(C.begin(), C.end());
        pool_leaf_.assign(t.begin(), t.end());
        pool_l_.assign(node_count_, -1);
        pool_r_.assign(node_count_, -1);
        // preorder numbering: a child's index is past its parent's, and no
        // node has two parents, so the nodes form a tree and every walk ends
        std::vector<uint8_t> has_parent(node_count_, 0);
        for (uint32_t i = 0; i < node_count_; i++) {
            if (!t[i]) {
                // internal nodes need two in-range children (index 0 is the
                // root and can never be a child in the padded format)
                if (uint32_t(L[i]) <= i || uint32_t(R[i]) <= i || L[i] == R[i] ||
                    uint32_t(L[i]) >= node_count_ || uint32_t(R[i]) >= node_count_ ||
                    has_parent[L[i]]++ || has_parent[R[i]]++)
                    throw std::runtime_error("huffman: malformed serialized tree");
                pool_l_[i] = int(L[i]);
                pool_r_[i] = int(R[i]);
            }
        }
        root_ = 0;
    }

    void build_decode_table() {
        table_.assign(size_t(1) << TABLE_BITS, DecEntry{});
        if (pool_leaf_[root_]) return;  // constant stream never consults the table
        const int64_t off64 = int64_t(offset_);
        for (uint32_t p = 0; p < (1u << TABLE_BITS); p++) {
            DecEntry e{};
            int node = root_;
            int pos = 0;
            while (!pool_leaf_[node] && pos < TABLE_BITS) {
                int bit = (p >> (TABLE_BITS - 1 - pos)) & 1;
                node = bit ? pool_r_[node] : pool_l_[node];
                pos++;
            }
            if (!pool_leaf_[node]) {
                e.n = 0;
                e.v0 = T(node);  // resume the walk here after TABLE_BITS bits
                table_[p] = e;
                continue;
            }
            e.v0 = T(int64_t(pool_sym_[node]) + off64);
            e.d1 = uint8_t(pos);
            e.len = uint8_t(pos);
            e.n = 1;
            int node2 = root_;
            int pos2 = pos;
            while (!pool_leaf_[node2] && pos2 < TABLE_BITS) {
                int bit = (p >> (TABLE_BITS - 1 - pos2)) & 1;
                node2 = bit ? pool_r_[node2] : pool_l_[node2];
                pos2++;
            }
            if (pool_leaf_[node2] && pos2 > pos) {
                e.v1 = T(int64_t(pool_sym_[node2]) + off64);
                e.len = uint8_t(pos2);
                e.n = 2;
            }
            table_[p] = e;
        }
    }

    static uint32_t peek_bits(const uint8_t* bytes, size_t nbytes, uint64_t bitpos,
                              uint64_t total_bits) {
        uint64_t byte = bitpos >> 3;
        uint64_t w = 0;
        // gather up to 4 bytes (TABLE_BITS <= 24 guaranteed), zero-pad at end
        for (int i = 0; i < 4; i++)
            w = (w << 8) | (byte + i < nbytes ? bytes[byte + i] : 0);
        int drop = int(bitpos & 7);
        return uint32_t((w >> (32 - TABLE_BITS - drop)) & ((1u << TABLE_BITS) - 1));
    }
};

}  // namespace szt
#endif
