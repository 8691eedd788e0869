// Secondary encoders: 44-bit arithmetic (range) coder, run-length, bypass.
//
// These are registered for the module-test tier in the reference
// (tools/test/modules/test_encoder.cpp) and available for custom pipeline
// assembly (tools/sz3/sz3_customized_demo.cpp); none rides the default
// archive path.
//
// Stream contracts:
//  - ArithmeticCoder (reference encoder/ArithmeticEncoder.hpp): scaled
//    frequency table capped at 2^20 total (:95-125); save() writes
//    [numOfRealStates i32 BE][numOfValidStates i32 BE][total_frequency i64 BE]
//    then (low, high, state) per valid state with widths picked by
//    total_frequency (u16/u32/u64) and state count (u8/u16/u32) (:130-283);
//    encode() is the classic 44-bit shift coder emitting MSB-first bits
//    (:455-521); optional zigzag "transform" mode folds symbols around
//    stateNum/2 (:67-78, decode :560-570).
//  - Runlength (RunlengthEncoder.hpp): [value T][count i32] pairs.
//  - Bypass (BypassEncoder.hpp): raw memcpy of the bins.
#ifndef SZT_ENCODERS_EXTRA_HPP
#define SZT_ENCODERS_EXTRA_HPP

#include <cmath>
#include <cstdint>
#include <vector>

#include "common.hpp"
#include "huffman_v2.hpp"  // put_i64_be / get_i64_be

namespace szt {

inline void put_i32_be(Sink& out, uint32_t v) {
    for (int i = 3; i >= 0; i--) out.put<uint8_t>(uint8_t(v >> (8 * i)));
}
inline uint32_t get_i32_be(Source& in) {
    uint32_t v = 0;
    for (int i = 0; i < 4; i++) v = (v << 8) | in.template get<uint8_t>();
    return v;
}
inline void put_i16_be(Sink& out, uint16_t v) {
    out.put<uint8_t>(uint8_t(v >> 8));
    out.put<uint8_t>(uint8_t(v));
}
inline uint16_t get_i16_be(Source& in) {
    uint16_t v = uint16_t(in.template get<uint8_t>()) << 8;
    return uint16_t(v | in.template get<uint8_t>());
}

// MSB-first bit writer/reader (the arithmetic stream orientation)
class BitSinkMSB {
  public:
    explicit BitSinkMSB(Sink& out) : out_(out) {}
    inline void bit(uint32_t v) {
        cur_ = uint8_t((cur_ << 1) | (v & 1));
        if (++nbits_ == 8) {
            out_.put<uint8_t>(cur_);
            cur_ = 0;
            nbits_ = 0;
        }
    }
    // returns true if a partial byte was flushed
    bool close() {
        bool partial = nbits_ != 0;
        if (partial) out_.put<uint8_t>(uint8_t(cur_ << (8 - nbits_)));
        cur_ = 0;
        nbits_ = 0;
        return partial;
    }

  private:
    Sink& out_;
    uint8_t cur_ = 0;
    int nbits_ = 0;
};

class BitSourceMSB {
  public:
    explicit BitSourceMSB(const uint8_t* p, size_t nbytes) : p_(p), nbytes_(nbytes) {}
    inline uint32_t bit() {
        if ((pos_ >> 3) >= nbytes_) return 0;  // reference reads past-end zeros implicitly
        uint32_t v = (p_[pos_ >> 3] >> (7 - (pos_ & 7))) & 1;
        pos_++;
        return v;
    }
    size_t bytes_consumed() const { return (pos_ + 7) >> 3; }

  private:
    const uint8_t* p_;
    size_t nbytes_;
    size_t pos_ = 0;
};

class ArithmeticCoder {
  public:
    static constexpr uint64_t kOneFourth = 0x40000000000ull;
    static constexpr uint64_t kOneHalf = 0x80000000000ull;
    static constexpr uint64_t kThreeFourths = 0xC0000000000ull;
    static constexpr uint64_t kMaxCode = 0xFFFFFFFFFFFull;
    static constexpr uint64_t kMaxIntervals = 1048576;

    explicit ArithmeticCoder(bool transform = false) : transform_(transform) {}

    void build(const int32_t* bins, size_t n, int state_num) {
        if (state_num > 4096) throw std::runtime_error("arithmetic: stateNum must be <= 4096");
        real_states_ = state_num;
        low_.assign(state_num, 0);
        high_.assign(state_num, 0);
        std::vector<size_t> freq(state_num, 0);
        if (transform_) {
            for (size_t i = 0; i < n; i++) freq[size_t(fold(bins[i]))]++;
        } else {
            for (size_t i = 0; i < n; i++) freq[size_t(bins[i])]++;
        }
        size_t sum = 0;
        valid_states_ = 0;
        size_t intv = n <= kMaxIntervals ? 1 : (n % kMaxIntervals == 0 ? n / kMaxIntervals
                                                                       : n / kMaxIntervals + 1);
        for (int s = 0; s < state_num; s++) {
            if (!freq[s]) continue;
            size_t f = intv == 1 ? freq[s] : std::max<size_t>(1, freq[s] / intv);
            low_[s] = sum;
            sum += f;
            high_[s] = sum;
            valid_states_++;
        }
        total_ = sum;
    }

    void encode(const int32_t* bins, size_t n, Sink& out) const {
        BitSinkMSB bw(out);
        uint64_t low = 0, high = kMaxCode;
        int pending = 0;
        auto emit = [&](uint32_t b) {
            bw.bit(b);
            while (pending > 0) {
                bw.bit(b ^ 1);
                pending--;
            }
        };
        for (size_t i = 0; i < n; i++) {
            int c = transform_ ? fold(bins[i]) : bins[i];
            uint64_t range = high - low + 1;
            high = low + range * high_[c] / total_ - 1;
            low = low + range * low_[c] / total_;
            for (;;) {
                if (high < kOneHalf) {
                    emit(0);
                } else if (low >= kOneHalf) {
                    emit(1);
                } else if (low >= kOneFourth && high < kThreeFourths) {
                    pending++;
                    low -= kOneFourth;
                    high -= kOneFourth;
                } else {
                    break;
                }
                high = ((high << 1) + 1) & kMaxCode;
                low = (low << 1) & kMaxCode;
            }
        }
        pending++;
        emit(low < kOneFourth ? 0 : 1);
        // the reference ends with `bytes += 1` (encode :516): the final
        // partial byte is included, or — when the stream happens to be
        // byte-aligned — one extra byte is appended (deterministic 0 here)
        if (!bw.close()) out.put<uint8_t>(0);
    }

    std::vector<int32_t> decode(Source& in, size_t count) const {
        // the stream has no self-length; consume what renormalization pulls
        const uint8_t* base = in.cursor();
        size_t avail = in.remaining();
        std::vector<int32_t> out(count);
        uint64_t value = 0;
        BitSourceMSB br(base, avail);
        for (int i = 0; i < 44; i++) value = (value << 1) | br.bit();
        uint64_t low = 0, high = kMaxCode;
        for (size_t i = 0; i < count; i++) {
            uint64_t range = high - low + 1;
            uint64_t scaled = ((value - low + 1) * total_ - 1) / range;
            int state = 0;
            while (state < real_states_ && !(high_[state] != 0 && scaled < high_[state])) state++;
            if (state == real_states_) throw std::runtime_error("arithmetic: corrupt stream");
            out[i] = transform_ ? unfold(state) : state;
            if (i + 1 == count) break;
            high = low + range * high_[state] / total_ - 1;
            low = low + range * low_[state] / total_;
            for (;;) {
                if (high < kOneHalf) {
                } else if (low >= kOneHalf) {
                    value -= kOneHalf;
                    low -= kOneHalf;
                    high -= kOneHalf;
                } else if (low >= kOneFourth && high < kThreeFourths) {
                    value -= kOneFourth;
                    low -= kOneFourth;
                    high -= kOneFourth;
                } else {
                    break;
                }
                low <<= 1;
                high = (high << 1) + 1;
                value = (value << 1) + br.bit();
            }
        }
        in.advance(std::min(avail, br.bytes_consumed() + 1));  // + pad byte
        return out;
    }

    // [realStates i32 BE][validStates i32 BE][total i64 BE] + per-valid-state
    // (low, high, state) with the reference's width selection
    void save(Sink& out) const {
        put_i32_be(out, uint32_t(real_states_));
        put_i32_be(out, uint32_t(valid_states_));
        put_i64_be(out, total_);
        int fw = total_ <= 65536 ? 2 : (total_ <= 4294967296ull ? 4 : 8);
        int sw = real_states_ <= 256 ? 1 : (real_states_ <= 65536 ? 2 : 4);
        for (int s = 0; s < real_states_; s++) {
            if (!high_[s]) continue;
            if (fw == 2) {
                put_i16_be(out, uint16_t(low_[s]));
                put_i16_be(out, uint16_t(high_[s]));
            } else if (fw == 4) {
                put_i32_be(out, uint32_t(low_[s]));
                put_i32_be(out, uint32_t(high_[s]));
            } else {
                put_i64_be(out, low_[s]);
                put_i64_be(out, high_[s]);
            }
            if (sw == 1) out.put<uint8_t>(uint8_t(s));
            else if (sw == 2) put_i16_be(out, uint16_t(s));
            else put_i32_be(out, uint32_t(s));
        }
    }

    void load(Source& in) {
        real_states_ = int(get_i32_be(in));
        valid_states_ = int(get_i32_be(in));
        total_ = get_i64_be(in);
        low_.assign(real_states_, 0);
        high_.assign(real_states_, 0);
        int fw = total_ <= 65536 ? 2 : (total_ <= 4294967296ull ? 4 : 8);
        int sw = real_states_ <= 256 ? 1 : (real_states_ <= 65536 ? 2 : 4);
        for (int i = 0; i < valid_states_; i++) {
            uint64_t lo, hi;
            if (fw == 2) {
                lo = get_i16_be(in);
                hi = get_i16_be(in);
            } else if (fw == 4) {
                lo = get_i32_be(in);
                hi = get_i32_be(in);
            } else {
                lo = get_i64_be(in);
                hi = get_i64_be(in);
            }
            int s;
            if (sw == 1) s = in.template get<uint8_t>();
            else if (sw == 2) s = get_i16_be(in);
            else s = int(get_i32_be(in));
            low_[s] = lo;
            high_[s] = hi;
        }
    }

  private:
    // zigzag fold around stateNum/2 (reference :67-78)
    int fold(int32_t x) const {
        int half = real_states_ / 2;
        int y = std::abs(x - half) * 2;
        if (x - half < 0) y -= 1;
        return y;
    }
    int unfold(int32_t y) const {
        int half = real_states_ / 2;
        if (y % 2 == 0) return half + (y + 1) / 2;
        return half - (y + 1) / 2;
    }

    bool transform_ = false;
    int real_states_ = 0;
    int valid_states_ = 0;
    uint64_t total_ = 0;
    std::vector<uint64_t> low_, high_;
};

// (value, count) pairs — reference RunlengthEncoder.hpp
struct RunlengthCoder {
    static void encode(const int32_t* bins, size_t n, Sink& out) {
        size_t s = 0;
        for (size_t i = 1; i < n; i++) {
            if (bins[i] != bins[i - 1]) {
                out.put<int32_t>(bins[i - 1]);
                out.put<int32_t>(int32_t(i - s));
                s = i;
            }
        }
        out.put<int32_t>(bins[n - 1]);
        out.put<int32_t>(int32_t(n - s));
    }
    static void decode(Source& in, size_t count, int32_t* out) {
        size_t i = 0;
        while (i < count) {
            int32_t value = in.template get<int32_t>();
            int32_t cnt = in.template get<int32_t>();
            if (cnt < 0 || i + size_t(cnt) > count)
                throw std::runtime_error("runlength: decoded length exceeds target");
            for (int32_t j = 0; j < cnt; j++) out[i + j] = value;
            i += size_t(cnt);
        }
    }
};

struct BypassCoder {
    static void encode(const int32_t* bins, size_t n, Sink& out) { out.put_n(bins, n); }
    static void decode(Source& in, size_t count, int32_t* out) { in.get_n(out, count); }
};

// Byte-truncation compressor: keep the top byte_len bytes of each f32
// (reference compressor/specialized/SZTruncateCompressor.hpp +
// utils/ByteUtil.hpp:169-193 truncateArray/truncateArrayRecover). The
// truncated planes then ride the lossless backend.
inline void truncate_f32(const float* data, size_t n, int byte_len, Sink& out) {
    for (size_t i = 0; i < n; i++) {
        uint32_t u;
        std::memcpy(&u, &data[i], 4);
        for (int b = 4 - byte_len; b < 4; b++) out.put<uint8_t>(uint8_t(u >> (8 * b)));
    }
}

inline void truncate_f32_recover(Source& in, size_t n, int byte_len, float* out) {
    for (size_t i = 0; i < n; i++) {
        uint32_t u = 0;
        for (int b = 4 - byte_len; b < 4; b++)
            u |= uint32_t(in.template get<uint8_t>()) << (8 * b);
        std::memcpy(&out[i], &u, 4);
    }
}

}  // namespace szt
#endif
