// GROMACS-XTC-style triplet coder for ALGO_BIOMDXTC streams.
//
// Stream format contract (reference encoder/XtcBasedEncoder.hpp, itself a
// libxdrf derivative; this file re-implements the observed wire format):
//  - header: minInt[3] (i32 LE), maxInt[3] (i32 LE), smallIdx (i32 LE),
//    bitstream byte count (u64 LE), then the MSB-first packed bitstream
//    (encode, :339-432,544-564).
//  - each "first" triplet is stored absolute (minus minInt) either as three
//    independent bit fields when a per-axis range exceeds 2^24 (bitSize==0,
//    :420-424,482-485) or as one mixed-radix big integer (sendints, :161-205);
//  - followed by 1 flag bit for run-length change, then 5 bits
//    `run + isSmaller + 1` when flagged (:522-528); `run/3` small triplets
//    follow as mixed-radix deltas around smallNum (:529-531) with the
//    magic-number size table adapting via isSmaller (:532-542);
//  - consecutive close triplets trigger the water-model first/second swap
//    (:459-477) which the decoder undoes on the first run element (:714-729);
//  - stream length % 3 remainders ride the encoder's save() block as two
//    raw ints (preprocess_encode :284-292, save :781-784).
#ifndef SZT_XTC_HPP
#define SZT_XTC_HPP

#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <vector>

#include "common.hpp"

namespace szt {

namespace xtc {

static const int kMagic[] = {
    0,       0,       0,       0,       0,        0,        0,       0,       0,       8,       10,
    12,      16,      20,      25,      32,       40,       50,      64,      80,      101,     128,
    161,     203,     256,     322,     406,      512,      645,     812,     1024,    1290,    1625,
    2048,    2580,    3250,    4096,    5060,     6501,     8192,    10321,   13003,   16384,   20642,
    26007,   32768,   41285,   52015,   65536,    82570,    104031,  131072,  165140,  208063,  262144,
    330280,  416127,  524287,  660561,  832255,   1048576,  1321122, 1664510, 2097152, 2642245, 3329021,
    4194304, 5284491, 6658042, 8388607, 10568983, 13316085, 16777216};
constexpr int kFirstIdx = 9;
constexpr int kLastIdx = int(sizeof(kMagic) / sizeof(*kMagic));

// MSB-first bit stream I/O. The WIRE FORMAT (bit order, the mixed-radix
// big-int layout, the magic size table above) is the public GROMACS XTC
// format, which the reference implements via an LGPL libxdrf port; these
// 64-bit-accumulator coders are an independent implementation of that
// format — bits enter/leave a right-aligned accumulator and are flushed a
// byte at a time, with no per-byte carry state.
struct BitWriter {
    std::vector<uint8_t> data;
    uint64_t acc = 0;  // pending bits, right-aligned
    int nacc = 0;

    void put(int nbits, uint32_t num) {
        if (nbits <= 0) return;
        uint64_t mask = nbits >= 32 ? 0xFFFFFFFFull : ((1ull << nbits) - 1);
        acc = (acc << nbits) | (uint64_t(num) & mask);
        nacc += nbits;
        while (nacc >= 8) {
            nacc -= 8;
            data.push_back(uint8_t(acc >> nacc));
        }
    }

    // flush the trailing partial byte (high bits first) and return the byte
    // count; idempotent-enough for the single end-of-frame call sites
    size_t finish() {
        if (nacc > 0) {
            data.push_back(uint8_t(acc << (8 - nacc)));
            acc = 0;
            nacc = 0;
        }
        return data.size();
    }
};

// Reads past the end of the stream's `len` bytes give zero bits.
struct BitReader {
    const uint8_t* data;
    size_t len;
    size_t index = 0;
    uint64_t acc = 0;
    int nacc = 0;

    int get(int nbits) {
        if (nbits <= 0) return 0;
        while (nacc < nbits) {
            acc = (acc << 8) | (index < len ? data[index] : 0);
            index++;
            nacc += 8;
        }
        nacc -= nbits;
        uint64_t mask = nbits >= 32 ? 0xFFFFFFFFull : ((1ull << nbits) - 1);
        return int((acc >> nacc) & mask);
    }
};

inline int sizeofint(int size) {
    int num = 1, bits = 0;
    while (size >= num && bits < 32) {
        bits++;
        num <<= 1;
    }
    return bits;
}

// bits needed for a mixed-radix triple with the given per-axis sizes
inline int sizeofints(int n, const uint32_t sizes[]) {
    uint32_t bytes[32];
    uint32_t nbytes = 1, bits = 0;
    bytes[0] = 1;
    for (int i = 0; i < n; i++) {
        uint32_t tmp = 0, bc = 0;
        for (bc = 0; bc < nbytes; bc++) {
            tmp = bytes[bc] * sizes[i] + tmp;
            bytes[bc] = tmp & 0xff;
            tmp >>= 8;
        }
        while (tmp != 0) {
            bytes[bc++] = tmp & 0xff;
            tmp >>= 8;
        }
        nbytes = bc;
    }
    uint32_t num = 1;
    nbytes--;
    while (bytes[nbytes] >= num) {
        bits++;
        num *= 2;
    }
    return int(bits + nbytes * 8);
}

inline void sendints(BitWriter& w, int n, int nbits, const uint32_t sizes[], const uint32_t nums[]) {
    uint32_t bytes[32];
    int nbytes = 0;
    uint32_t tmp = nums[0];
    do {
        bytes[nbytes++] = tmp & 0xff;
        tmp >>= 8;
    } while (tmp != 0);
    for (int i = 1; i < n; i++) {
        if (nums[i] >= sizes[i]) throw std::runtime_error("xtc: num exceeds size in sendints");
        tmp = nums[i];
        int bc;
        for (bc = 0; bc < nbytes; bc++) {
            tmp = bytes[bc] * sizes[i] + tmp;
            bytes[bc] = tmp & 0xff;
            tmp >>= 8;
        }
        while (tmp != 0) {
            bytes[bc++] = tmp & 0xff;
            tmp >>= 8;
        }
        nbytes = bc;
    }
    if (nbits >= nbytes * 8) {
        for (int i = 0; i < nbytes; i++) w.put(8, bytes[i]);
        w.put(nbits - nbytes * 8, 0);
    } else {
        int i;
        for (i = 0; i < nbytes - 1; i++) w.put(8, bytes[i]);
        w.put(nbits - (nbytes - 1) * 8, bytes[i]);
    }
}

inline void receiveints(BitReader& r, int n, int nbits, const uint32_t sizes[], int nums[]) {
    int bytes[32];
    bytes[0] = bytes[1] = bytes[2] = bytes[3] = 0;
    int nbytes = 0;
    while (nbits > 8) {
        bytes[nbytes++] = r.get(8);
        nbits -= 8;
    }
    if (nbits > 0) bytes[nbytes++] = r.get(nbits);
    for (int i = n - 1; i > 0; i--) {
        int num = 0;
        for (int j = nbytes - 1; j >= 0; j--) {
            num = (num << 8) | bytes[j];
            int p = num / int(sizes[i]);
            bytes[j] = p;
            num -= p * int(sizes[i]);
        }
        nums[i] = num;
    }
    nums[0] = bytes[0] | (bytes[1] << 8) | (bytes[2] << 16) | (bytes[3] << 24);
}

}  // namespace xtc

// Triplet-stream coder. encode()/decode() handle floor(n/3) full triplets;
// the 1-2 remainder values are carried in save()/load() exactly like the
// reference's preprocess_encode/save pair.
class XtcCoder {
  public:
    int32_t reminder1 = 0, reminder2 = 0;

    void preprocess(const int32_t* bins, size_t n) {
        size_t rem = n % 3;
        if (rem == 1) {
            reminder1 = bins[n - 1];
        } else if (rem == 2) {
            reminder1 = bins[n - 1];
            reminder2 = bins[n - 2];
        }
    }

    void encode(const int32_t* bins, size_t n, Sink& out) const {
        using namespace xtc;
        const float max_abs = std::nextafterf(float(INT_MAX), 0.f);
        size_t triplets = n / 3;
        // working copy: the water-model swap mutates the coordinate buffer
        std::vector<int32_t> buf(bins, bins + triplets * 3);

        int mins[3] = {INT_MAX, INT_MAX, INT_MAX};
        int maxs[3] = {INT_MIN, INT_MIN, INT_MIN};
        int min_diff = INT_MAX;
        int prev[3] = {0, 0, 0};
        for (size_t t = 0; t < triplets; t++) {
            for (int k = 0; k < 3; k++) {
                int v = buf[t * 3 + k];
                mins[k] = std::min(mins[k], v);
                maxs[k] = std::max(maxs[k], v);
            }
            int diff = std::abs(prev[0] - buf[t * 3]) + std::abs(prev[1] - buf[t * 3 + 1]) +
                       std::abs(prev[2] - buf[t * 3 + 2]);
            if (diff < min_diff && t >= 1) min_diff = diff;
            for (int k = 0; k < 3; k++) prev[k] = buf[t * 3 + k];
        }

        for (int k = 0; k < 3; k++) out.put<int32_t>(mins[k]);
        for (int k = 0; k < 3; k++) out.put<int32_t>(maxs[k]);

        for (int k = 0; k < 3; k++) {
            if (float(maxs[k]) - float(mins[k]) >= max_abs || float(maxs[k]) >= max_abs / 4 ||
                float(mins[k]) <= -max_abs / 4)
                throw std::runtime_error("xtc: range overflow when biasing by minInt");
        }
        uint32_t size_int[3], bit_size_int[3] = {0, 0, 0};
        for (int k = 0; k < 3; k++) size_int[k] = uint32_t(maxs[k] - mins[k] + 1);
        int bit_size;
        if ((size_int[0] | size_int[1] | size_int[2]) > 0xffffff) {
            for (int k = 0; k < 3; k++) bit_size_int[k] = uint32_t(sizeofint(int(size_int[k])));
            bit_size = 0;
        } else {
            bit_size = sizeofints(3, size_int);
        }

        int small_idx = kFirstIdx;
        while (small_idx < kLastIdx && kMagic[small_idx] < min_diff) small_idx++;
        out.put<int32_t>(small_idx);

        // small_idx can reach kLastIdx (single triplet / huge diffs); the
        // reference reads magicInts[LASTIDX] out of bounds there (UB). Clamp
        // the table reads; the stored header keeps the raw value, which the
        // decoder clamps the same way.
        const int si = std::min(small_idx, kLastIdx - 1);
        int max_idx = std::min(kLastIdx - 1, small_idx + 8);
        int min_idx = max_idx - 8;
        int smaller = kMagic[std::max(kFirstIdx, si - 1)] / 2;
        int small_num = kMagic[si] / 2;
        uint32_t size_small[3] = {uint32_t(kMagic[si]), uint32_t(kMagic[si]),
                                  uint32_t(kMagic[si])};
        int larger = kMagic[max_idx] / 2;

        BitWriter w;
        w.data.reserve(triplets * 12 + 64);
        size_t i = 0;
        int prev_coord[3] = {0, 0, 0};
        int prev_run = -1;
        while (i < triplets) {
            bool is_small = false;
            int32_t* this_coord = buf.data() + i * 3;
            int is_smaller;
            if (small_idx < max_idx && i >= 1 && std::abs(this_coord[0] - prev_coord[0]) < larger &&
                std::abs(this_coord[1] - prev_coord[1]) < larger &&
                std::abs(this_coord[2] - prev_coord[2]) < larger) {
                is_smaller = 1;
            } else if (small_idx > min_idx) {
                is_smaller = -1;
            } else {
                is_smaller = 0;
            }
            if (i + 1 < triplets && std::abs(this_coord[0] - this_coord[3]) < small_num &&
                std::abs(this_coord[1] - this_coord[4]) < small_num &&
                std::abs(this_coord[2] - this_coord[5]) < small_num) {
                // water-model swap: hydrogen first, then oxygen
                std::swap(this_coord[0], this_coord[3]);
                std::swap(this_coord[1], this_coord[4]);
                std::swap(this_coord[2], this_coord[5]);
                is_small = true;
            }
            uint32_t tmp_coord[30];
            tmp_coord[0] = uint32_t(this_coord[0] - mins[0]);
            tmp_coord[1] = uint32_t(this_coord[1] - mins[1]);
            tmp_coord[2] = uint32_t(this_coord[2] - mins[2]);
            if (bit_size == 0) {
                w.put(int(bit_size_int[0]), tmp_coord[0]);
                w.put(int(bit_size_int[1]), tmp_coord[1]);
                w.put(int(bit_size_int[2]), tmp_coord[2]);
            } else {
                sendints(w, 3, bit_size, size_int, tmp_coord);
            }
            for (int k = 0; k < 3; k++) prev_coord[k] = this_coord[k];
            this_coord += 3;
            i++;

            int run = 0;
            if (!is_small && is_smaller == -1) is_smaller = 0;
            while (is_small && run < 8 * 3) {
                // the reference evaluates SQR(d0)+SQR(d1)+SQR(d2) >=
                // smaller*smaller in int arithmetic, which OVERFLOWS once
                // smaller exceeds ~46341 (fine error bounds on wide-range
                // trajectories). Byte parity requires reproducing the wrap,
                // so do the multiplies in uint32 and compare as int32.
                int32_t d0 = this_coord[0] - prev_coord[0];
                int32_t d1 = this_coord[1] - prev_coord[1];
                int32_t d2 = this_coord[2] - prev_coord[2];
                int32_t sq = int32_t(uint32_t(d0) * uint32_t(d0) +
                                     uint32_t(d1) * uint32_t(d1) +
                                     uint32_t(d2) * uint32_t(d2));
                int32_t thr = int32_t(uint32_t(smaller) * uint32_t(smaller));
                if (is_smaller == -1 && sq >= thr) is_smaller = 0;
                tmp_coord[run++] = uint32_t(int(d0) + small_num);
                tmp_coord[run++] = uint32_t(int(d1) + small_num);
                tmp_coord[run++] = uint32_t(int(d2) + small_num);
                for (int k = 0; k < 3; k++) prev_coord[k] = this_coord[k];
                i++;
                this_coord += 3;
                is_small = i < triplets && std::abs(this_coord[0] - prev_coord[0]) < small_num &&
                           std::abs(this_coord[1] - prev_coord[1]) < small_num &&
                           std::abs(this_coord[2] - prev_coord[2]) < small_num;
            }
            if (run != prev_run || is_smaller != 0) {
                prev_run = run;
                w.put(1, 1);
                w.put(5, uint32_t(run + is_smaller + 1));
            } else {
                w.put(1, 0);
            }
#ifdef SZT_XTC_TRACE
            fprintf(stderr, "E i=%zu run=%d smaller=%d sidx=%d\n", i, run, is_smaller, small_idx);
#endif
            for (int k = 0; k < run; k += 3) sendints(w, 3, small_idx, size_small, &tmp_coord[k]);
            if (is_smaller != 0) {
                small_idx += is_smaller;
                if (is_smaller < 0) {
                    small_num = smaller;
                    smaller = kMagic[small_idx - 1] / 2;
                } else {
                    smaller = small_num;
                    small_num = kMagic[small_idx] / 2;
                }
                size_small[0] = size_small[1] = size_small[2] = uint32_t(kMagic[small_idx]);
            }
        }
        size_t nbytes = w.finish();
        out.put<uint64_t>(nbytes);
        out.raw(w.data.data(), nbytes);
    }

    void decode(Source& in, size_t target_len, int32_t* out_bins) const {
        using namespace xtc;
        for (size_t i = 0; i < target_len; i++) out_bins[i] = 0;

        int mins[3], maxs[3];
        for (int k = 0; k < 3; k++) mins[k] = in.template get<int32_t>();
        for (int k = 0; k < 3; k++) maxs[k] = in.template get<int32_t>();

        uint32_t size_int[3], bit_size_int[3] = {0, 0, 0};
        for (int k = 0; k < 3; k++) size_int[k] = uint32_t(maxs[k] - mins[k] + 1);
        int bit_size;
        if ((size_int[0] | size_int[1] | size_int[2]) > 0xffffff) {
            for (int k = 0; k < 3; k++) bit_size_int[k] = uint32_t(sizeofint(int(size_int[k])));
            bit_size = 0;
        } else {
            bit_size = sizeofints(3, size_int);
        }

        int small_idx = in.template get<int32_t>();
        // kLastIdx itself is legal in headers (single-triplet / huge-diff
        // streams); anything below kFirstIdx would index zero-valued magic
        // entries and divide by zero in receiveints
        if (small_idx < kFirstIdx || small_idx > kLastIdx)
            throw std::runtime_error("xtc: bad smallIdx");
        int si = std::min(small_idx, kLastIdx - 1);
        int smaller = kMagic[std::max(kFirstIdx, si - 1)] / 2;
        int small_num = kMagic[si] / 2;
        uint32_t size_small[3] = {uint32_t(kMagic[si]), uint32_t(kMagic[si]),
                                  uint32_t(kMagic[si])};

        uint64_t nbytes = in.template get<uint64_t>();
        if (in.remaining() < nbytes) throw std::runtime_error("xtc: truncated bitstream");
        BitReader r{in.cursor(), size_t(nbytes)};
        in.advance(size_t(nbytes));

        size_t triplets = target_len / 3;
        int prev_coord[3] = {0, 0, 0};
        int run = 0;
        size_t i = 0;
        int32_t* outp = out_bins;
        int this_coord[3];
        while (i < triplets) {
            if (bit_size == 0) {
                this_coord[0] = r.get(int(bit_size_int[0]));
                this_coord[1] = r.get(int(bit_size_int[1]));
                this_coord[2] = r.get(int(bit_size_int[2]));
            } else {
                receiveints(r, 3, bit_size, size_int, this_coord);
            }
            i++;
            for (int k = 0; k < 3; k++) {
                this_coord[k] += mins[k];
                prev_coord[k] = this_coord[k];
            }

            int flag = r.get(1);
            int is_smaller = 0;
            if (flag == 1) {
                run = r.get(5);
                is_smaller = run % 3;
                run -= is_smaller;
                is_smaller--;
            }
#ifdef SZT_XTC_TRACE
            fprintf(stderr, "D i=%zu run=%d smaller=%d sidx=%d\n", i + (size_t)run/3, run, is_smaller, small_idx);
#endif
            if (run > 0) {
                // a run of run/3 more triplets must end inside the stream
                if (size_t(run / 3) > triplets - i)
                    throw std::runtime_error("xtc: run past the end of the stream");
                for (int k = 0; k < run; k += 3) {
                    receiveints(r, 3, small_idx, size_small, this_coord);
                    i++;
                    for (int m = 0; m < 3; m++) this_coord[m] += prev_coord[m] - small_num;
                    if (k == 0) {
                        // undo the water-model swap: emit the later atom first
                        for (int m = 0; m < 3; m++) std::swap(this_coord[m], prev_coord[m]);
                        *outp++ = prev_coord[0];
                        *outp++ = prev_coord[1];
                        *outp++ = prev_coord[2];
                    } else {
                        for (int m = 0; m < 3; m++) prev_coord[m] = this_coord[m];
                    }
                    *outp++ = this_coord[0];
                    *outp++ = this_coord[1];
                    *outp++ = this_coord[2];
                }
            } else {
                *outp++ = this_coord[0];
                *outp++ = this_coord[1];
                *outp++ = this_coord[2];
            }

            small_idx += is_smaller;
            // encoder-produced streams stay in [min_idx, max_idx]; clamp so a
            // crafted stream cannot index outside the magic table or reach a
            // zero divisor in receiveints
            if (small_idx < kFirstIdx || small_idx >= kLastIdx)
                throw std::runtime_error("xtc: smallIdx adaptation out of range");
            if (is_smaller < 0) {
                small_num = smaller;
                smaller = small_idx > kFirstIdx ? kMagic[small_idx - 1] / 2 : 0;
            } else if (is_smaller > 0) {
                smaller = small_num;
                small_num = kMagic[small_idx] / 2;
            }
            size_small[0] = size_small[1] = size_small[2] = uint32_t(kMagic[small_idx]);
        }

        size_t rem = target_len % 3;
        if (rem == 1) {
            out_bins[target_len - 1] = reminder1;
        } else if (rem == 2) {
            out_bins[target_len - 1] = reminder1;
            out_bins[target_len - 2] = reminder2;
        }
    }

    void save(Sink& out) const {
        out.put<int32_t>(reminder1);
        out.put<int32_t>(reminder2);
    }

    void load(Source& in) {
        reminder1 = in.template get<int32_t>();
        reminder2 = in.template get<int32_t>();
    }
};

}  // namespace szt
#endif
