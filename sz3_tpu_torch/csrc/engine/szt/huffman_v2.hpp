// Canonical-construction Huffman coder used by ALGO_BIOMD streams.
//
// Byte/bit format contract (reference encoder/HuffmanEncoderV2.hpp):
//  - build: min-heap merge with freq ties broken by smaller node index
//    (HuffmanEncoderV2.hpp:42-47,189-200); leaves inserted in increasing
//    symbol order; code bits assigned LSB-first along the DFS (50-86).
//  - encode stream: [bit-length(int64 BE) ^ 0x1234abcd][LSB-first packed
//    codes] (340-428); degenerate single-symbol stream stores only
//    [count ^ 0x1234abcd] (341-345); fixed-length mode (n==0) packs raw
//    mbft-bit symbols (359-372).
//  - tree serialization "DFS order": byte0 = usemp<<7 | (n==1)<<6 | mbft,
//    then offset (LE, sizeof(T) bytes), n (int64 BE), maxval (int64 BE),
//    then a preorder bitstream: 0 = internal, 1 = leaf + mbft symbol bits
//    (saveAsDFSOrder 844-893 / loadAsDFSOrder 1037-1129; the root's own
//    0-bit is skipped on load by starting at bit index 1).
#ifndef SZT_HUFFMAN_V2_HPP
#define SZT_HUFFMAN_V2_HPP

#include <algorithm>
#include <cstdint>
#include <map>
#include <vector>

#include "common.hpp"

namespace szt {

inline void put_i64_be(Sink& out, uint64_t v) {
    for (int i = 7; i >= 0; i--) out.put<uint8_t>(uint8_t(v >> (8 * i)));
}

inline uint64_t get_i64_be(Source& in) {
    uint64_t v = 0;
    for (int i = 0; i < 8; i++) v = (v << 8) | in.template get<uint8_t>();
    return v;
}

// LSB-first bit packer (reference HuffmanEncoderV2.hpp:689-736).
class BitSinkLSB {
  public:
    explicit BitSinkLSB(Sink& out) : out_(out) {}

    inline void bit(uint32_t v) {
        mask_ |= (v & 1u) << index_;
        if (++index_ == 8) flush_byte();
    }
    inline void bits(uint64_t val, int len) {
        while (len > 0) {
            int take = std::min(len, 8 - int(index_));
            mask_ |= uint8_t((val & ((1u << take) - 1)) << index_);
            val >>= take;
            len -= take;
            index_ += take;
            if (index_ == 8) flush_byte();
        }
    }
    // flush trailing partial byte (writeBytesClearMask)
    void close() {
        if (index_ > 0) {
            out_.put<uint8_t>(mask_);
            mask_ = index_ = 0;
        }
    }

  private:
    void flush_byte() {
        out_.put<uint8_t>(mask_);
        mask_ = 0;
        index_ = 0;
    }
    Sink& out_;
    uint8_t mask_ = 0;
    uint8_t index_ = 0;
};

// Reads past the end of the source's `len` bytes give zero bits.
class BitSourceLSB {
  public:
    BitSourceLSB(const uint8_t* p, size_t len) : p_(p), len_(len) {}

    inline uint32_t bit() {
        uint32_t v = (pos_ >> 3) < len_ ? (p_[pos_ >> 3] >> (pos_ & 7)) & 1 : 0;
        pos_++;
        return v;
    }
    inline uint64_t bits(int len) {
        uint64_t v = 0;
        for (int i = 0; i < len; i++) v |= uint64_t(bit()) << i;
        return v;
    }
    size_t bit_pos() const { return pos_; }
    size_t bytes_consumed() const { return (pos_ + 7) >> 3; }

  private:
    const uint8_t* p_;
    size_t len_;
    size_t pos_ = 0;
};

// T is the bin type (int32 on every reference path).
template <class T>
class HuffmanV2 {
  public:
    // stateNum > 0 pins the symbol domain to [0, stateNum) the way
    // SZGenericCompressor drives it; stateNum == 0 scans min/max
    // (reference HuffmanEncoderV2.hpp:222-243).
    void build(const T* bins, size_t n, int64_t state_num) {
        reset();
        T minval, maxval_in;
        if (state_num == 0) {
            if (n == 0) throw std::runtime_error("huffv2: empty input without stateNum");
            minval = maxval_in = bins[0];
            for (size_t i = 1; i < n; i++) {
                minval = std::min(minval, bins[i]);
                maxval_in = std::max(maxval_in, bins[i]);
            }
        } else {
            minval = 0;
            maxval_in = T(state_num - 1);
        }
        offset_ = minval;
        maxval_ = int64_t(maxval_in) - int64_t(minval) + 1;
        usemp_ = (maxval_ >= (1 << 12) && n < 2 * size_t(maxval_in)) || maxval_ >= (int64_t(1) << 28);

        // histogram over shifted symbols; leaves enter in increasing symbol
        // order on both the map and vector paths (HuffmanEncoderV2.hpp:283-323)
        std::map<T, size_t> freq;
        for (size_t i = 0; i < n; i++) freq[bins[i] - offset_]++;
        n_ = freq.size();

        if (n_ == 1 || maxval_ == 1) {
            // degenerate: single symbol (constructHuffmanTree 154-170)
            offset_ += freq.begin()->first;
            maxval_ = 1;
            mbft_ = 1;
            limit_ = 1;
            return;
        }

        mbft_ = 1;
        while ((uint64_t(1) << mbft_) < uint64_t(maxval_)) ++mbft_;

        // nodes: leaves first in symbol order, then merged internals
        size_t cap = 2 * n_;
        sym_.assign(cap, 0);
        left_.assign(cap, -1);
        right_.assign(cap, -1);
        size_t cnt = 0;
        // (index, freq) min-heap: smaller freq first, smaller index on ties —
        // a strict total order, so the merge sequence is fully deterministic
        std::vector<std::pair<size_t, int64_t>> heap;  // (freq, ~index) not needed; store pair
        struct Item {
            size_t freq;
            int64_t idx;
        };
        auto worse = [](const Item& a, const Item& b) {  // "a pops after b"
            return a.freq == b.freq ? a.idx > b.idx : a.freq > b.freq;
        };
        std::vector<Item> q;
        for (auto& kv : freq) {
            sym_[cnt] = kv.first;
            q.push_back({kv.second, int64_t(cnt)});
            cnt++;
        }
        std::make_heap(q.begin(), q.end(), worse);
        while (q.size() > 1) {
            std::pop_heap(q.begin(), q.end(), worse);
            Item u = q.back();
            q.pop_back();
            std::pop_heap(q.begin(), q.end(), worse);
            Item v = q.back();
            q.pop_back();
            left_[cnt] = int64_t(u.idx);
            right_[cnt] = int64_t(v.idx);
            q.push_back({u.freq + v.freq, int64_t(cnt)});
            std::push_heap(q.begin(), q.end(), worse);
            cnt++;
        }
        root_ = int64_t(cnt) - 1;
        nodes_ = cnt;
        assign_codes();
    }

    // LSB-first DFS code assignment (dfs_mp/dfs_vec, HuffmanEncoderV2.hpp:50-86)
    void assign_codes() {
        code_len_.assign(size_t(maxval_), 0);
        code_.assign(size_t(maxval_), 0);
        limit_ = 0;
        // iterative preorder carrying (node, depth, code)
        std::vector<std::tuple<int64_t, uint8_t, uint64_t>> stk;
        stk.push_back({root_, 0, 0});
        while (!stk.empty()) {
            auto [u, len, vec] = stk.back();
            stk.pop_back();
            if (left_[u] < 0) {
                code_len_[size_t(sym_[u])] = len;
                code_[size_t(sym_[u])] = vec;
                limit_ = std::max(limit_, len);
                continue;
            }
            stk.push_back({right_[u], uint8_t(len + 1), vec | (uint64_t(1) << len)});
            stk.push_back({left_[u], uint8_t(len + 1), vec});
        }
    }

    void encode(const T* bins, size_t n, Sink& out) const {
        if (maxval_ == 1) {
            put_i64_be(out, uint64_t(n) ^ 0x1234abcdu);
            return;
        }
        size_t head = out.skip(8);
        BitSinkLSB bw(out);
        uint64_t total_bits = 0;
        if (n_ == 0) {  // fixed-length raw mode
            for (size_t i = 0; i < n; i++) bw.bits(uint64_t(bins[i] - offset_), mbft_);
            bw.close();
            total_bits = uint64_t(mbft_) * n;
        } else {
            for (size_t i = 0; i < n; i++) {
                size_t s = size_t(bins[i] - offset_);
                total_bits += code_len_[s];
                bw.bits(code_[s], code_len_[s]);
            }
            bw.close();
        }
        uint64_t v = total_bits ^ 0x1234abcdu;
        for (int i = 0; i < 8; i++) out.patch<uint8_t>(head + i, uint8_t(v >> (8 * (7 - i))));
    }

    void decode(Source& in, size_t count, T* out) const {
        if (maxval_ == 1) {
            uint64_t len = get_i64_be(in) ^ 0x1234abcdu;
            for (size_t i = 0; i < len && i < count; i++) out[i] = offset_;
            return;
        }
        uint64_t len = get_i64_be(in) ^ 0x1234abcdu;
        size_t nbytes = size_t((len + 7) >> 3);
        if (in.remaining() < nbytes) throw std::runtime_error("huffv2: truncated bitstream");
        BitSourceLSB br(in.cursor(), nbytes);
        if (n_ == 0) {  // fixed-length raw mode
            for (size_t i = 0; i < count; i++) out[i] = T(br.bits(mbft_)) + offset_;
        } else {
            for (size_t i = 0; i < count; i++) {
                int64_t u = root_;
                while (left_[u] >= 0) u = br.bit() ? right_[u] : left_[u];
                out[i] = sym_[u] + offset_;
            }
        }
        in.advance(nbytes);
    }

    void save(Sink& out) const {
        out.put<uint8_t>(uint8_t((usemp_ ? 0x80 : 0) | ((n_ == 1) ? 0x40 : 0) | mbft_));
        out.put<T>(offset_);
        put_i64_be(out, uint64_t(n_));
        put_i64_be(out, uint64_t(maxval_));
        if (n_ <= 1) return;
        Sink bits_out;
        BitSinkLSB bw(bits_out);
        // preorder, left child first (saveAsDFSOrder 863-878)
        std::vector<int64_t> stk{root_};
        while (!stk.empty()) {
            int64_t u = stk.back();
            stk.pop_back();
            if (left_[u] < 0) {
                bw.bit(1);
                bw.bits(uint64_t(sym_[u]), mbft_);
            } else {
                bw.bit(0);
                stk.push_back(right_[u]);
                stk.push_back(left_[u]);
            }
        }
        bw.close();
        out.raw(bits_out.buf.data(), bits_out.buf.size());
    }

    void load(Source& in) {
        reset();
        uint8_t b0 = in.template get<uint8_t>();
        usemp_ = (b0 >> 7) & 1;
        mbft_ = b0 & 0x3f;
        offset_ = in.template get<T>();
        n_ = size_t(get_i64_be(in));
        maxval_ = int64_t(get_i64_be(in));
        if (n_ == 0) return;  // fixed-length mode: decode uses mbft only
        if (n_ == 1) {
            maxval_ = 1;  // decode's degenerate path keys off maxval
            return;
        }
        // preorder parse; bit 0 of the stream is the root marker (skipped by
        // starting at bit 1, mirroring loadAsDFSOrder's `size_t i = 1`)
        // every leaf takes at least one bit of the tree's stream
        if (n_ > 8 * in.remaining()) throw std::runtime_error("huffv2: bad symbol count");
        BitSourceLSB br(in.cursor(), in.remaining());
        br.bit();  // root's internal-node bit
        size_t cap = 2 * n_;
        sym_.assign(cap, 0);
        left_.assign(cap, -1);
        right_.assign(cap, -1);
        size_t cnt = 0;
        root_ = int64_t(cnt++);
        // stack of nodes awaiting children; fill left first
        std::vector<int64_t> stk{root_};
        while (!stk.empty()) {
            if (cnt >= cap) throw std::runtime_error("huffv2: malformed tree");
            int64_t child = int64_t(cnt++);
            int64_t parent = stk.back();
            if (left_[parent] < 0) left_[parent] = child;
            else {
                right_[parent] = child;
                stk.pop_back();
            }
            if (br.bit() == 0) {
                stk.push_back(child);
            } else {
                sym_[child] = T(br.bits(mbft_));
            }
        }
        nodes_ = cnt;
        in.advance(br.bytes_consumed());
        // the decode walks the tree; the code table (sized by the
        // archive-given maxval) is the encoder's alone
    }

    int64_t maxval() const { return maxval_; }
    size_t distinct() const { return n_; }

  private:
    void reset() {
        sym_.clear();
        left_.clear();
        right_.clear();
        code_len_.clear();
        code_.clear();
        offset_ = 0;
        maxval_ = 0;
        n_ = 0;
        nodes_ = 0;
        root_ = -1;
        mbft_ = 0;
        limit_ = 0;
        usemp_ = false;
    }

    std::vector<T> sym_;
    std::vector<int64_t> left_, right_;
    std::vector<uint8_t> code_len_;
    std::vector<uint64_t> code_;
    T offset_ = 0;
    int64_t maxval_ = 0;
    size_t n_ = 0;       // distinct symbols
    size_t nodes_ = 0;
    int64_t root_ = -1;
    uint8_t mbft_ = 0;   // minimum bits for raw symbol
    uint8_t limit_ = 0;  // max code length
    bool usemp_ = false;
};

}  // namespace szt
#endif
