// Engine-side view of the compression configuration, including the compact
// binary form embedded in archives and chunk headers.
//
// Byte layout matches reference utils/Config.hpp:312-413 (and the Python
// sz3_tpu.config.Config — tests assert the two serializers agree).
#ifndef SZT_CONF_HPP
#define SZT_CONF_HPP

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

#include "common.hpp"

namespace szt {

enum class Algo : uint8_t {
    LORENZO_REG = 0,
    INTERP_LORENZO = 1,
    INTERP = 2,
    NOPRED = 3,
    LOSSLESS = 4,
    BIOMD = 5,
    BIOMDXTC = 6,
};

enum class EbMode : uint8_t { ABS = 0, REL = 1, PSNR = 2, L2NORM = 3, ABS_AND_REL = 4, ABS_OR_REL = 5 };

struct Conf {
    std::vector<size_t> dims;
    uint8_t cmprAlgo = uint8_t(Algo::INTERP_LORENZO);
    uint8_t errorBoundMode = uint8_t(EbMode::ABS);
    double absErrorBound = 1e-3;
    double relErrorBound = 0.0;
    double psnrErrorBound = 0.0;
    double l2normErrorBound = 0.0;
    bool openmp = false;
    int32_t quantbinCnt = 65536;
    int32_t blockSize = 0;
    uint8_t predDim = 0;
    uint8_t dataType = 0;
    bool lorenzo = true, lorenzo2 = false, regression = true, regression2 = false;
    uint8_t interpAlgo = 1;  // cubic
    int32_t interpDirection = 0;
    int64_t interpAnchorStride = -1;
    double interpAlpha = 1.25;
    double interpBeta = 2.0;

    int N() const { return int(dims.size()); }
    size_t num() const {
        size_t n = 1;
        for (auto d : dims) n *= d;
        return n;
    }

    // Drop size-1 dims, refresh derived fields (reference Config.hpp:160-177).
    void set_dims(const std::vector<size_t>& in) {
        dims.clear();
        for (auto d : in)
            if (d > 1) dims.push_back(d);
        if (dims.empty()) dims = {1};
        predDim = uint8_t(dims.size());
        blockSize = dims.size() == 1 ? 128 : (dims.size() == 2 ? 16 : 6);
    }

    void save(Sink& out) const {
        size_t start = out.skip(1);  // 1-byte total size, patched below
        out.put<int8_t>(int8_t(dims.size()));
        uint8_t bw = 0;
        size_t mx = *std::max_element(dims.begin(), dims.end());
        while (mx > 0) { mx >>= 1; bw++; }
        out.put<uint8_t>(bw);
        {   // LSB-first bit pack (reference ByteUtil.hpp:206-238)
            uint64_t cur = 0;
            int nbits = 0;
            for (size_t v : dims) {
                cur |= (uint64_t(v) & ((bw >= 64 ? ~0ull : ((1ull << bw) - 1)))) << nbits;
                nbits += bw;
                while (nbits >= 8) {
                    out.put<uint8_t>(uint8_t(cur & 0xFF));
                    cur >>= 8;
                    nbits -= 8;
                }
            }
            if (nbits) out.put<uint8_t>(uint8_t(cur & 0xFF));
        }
        out.put<uint64_t>(num());
        out.put<uint8_t>(cmprAlgo);
        out.put<uint8_t>(errorBoundMode);
        switch (EbMode(errorBoundMode)) {
            case EbMode::ABS: out.put(absErrorBound); break;
            case EbMode::REL: out.put(relErrorBound); break;
            case EbMode::PSNR: out.put(psnrErrorBound); break;
            case EbMode::L2NORM: out.put(l2normErrorBound); break;
            case EbMode::ABS_AND_REL:
            case EbMode::ABS_OR_REL:
                out.put(absErrorBound);
                out.put(relErrorBound);
                break;
        }
        uint8_t boolvals = uint8_t((lorenzo << 7) | (lorenzo2 << 6) | (regression << 5) |
                                   (regression2 << 4) | (openmp << 3));
        out.put(boolvals);
        out.put(dataType);
        out.put(quantbinCnt);
        out.put(blockSize);
        out.put(predDim);
        out.patch<uint8_t>(start, uint8_t(out.size() - start));
    }

    void load(Source& in) {
        uint8_t conf_size = in.get<uint8_t>();
        size_t end_remaining = in.remaining() + 1 - conf_size;  // remaining() when done
        int n = in.get<int8_t>();
        uint8_t bw = in.get<uint8_t>();
        size_t nbytes = (size_t(n) * bw + 7) / 8;
        std::vector<uint8_t> packed(nbytes);
        in.get_n(packed.data(), nbytes);
        dims.assign(size_t(n), 0);
        for (int i = 0; i < n; i++) {
            size_t v = 0;
            for (int j = 0; j < bw; j++) {
                size_t bit = size_t(i) * bw + j;
                v |= size_t((packed[bit / 8] >> (bit % 8)) & 1) << j;
            }
            dims[i] = v;
        }
        in.get<uint64_t>();  // num (derived)
        cmprAlgo = in.get<uint8_t>();
        errorBoundMode = in.get<uint8_t>();
        switch (EbMode(errorBoundMode)) {
            case EbMode::ABS: absErrorBound = in.get<double>(); break;
            case EbMode::REL: relErrorBound = in.get<double>(); break;
            case EbMode::PSNR: psnrErrorBound = in.get<double>(); break;
            case EbMode::L2NORM: l2normErrorBound = in.get<double>(); break;
            case EbMode::ABS_AND_REL:
            case EbMode::ABS_OR_REL:
                absErrorBound = in.get<double>();
                relErrorBound = in.get<double>();
                break;
        }
        if (in.remaining() > end_remaining) {
            uint8_t b = in.get<uint8_t>();
            lorenzo = (b >> 7) & 1;
            lorenzo2 = (b >> 6) & 1;
            regression = (b >> 5) & 1;
            regression2 = (b >> 4) & 1;
            openmp = (b >> 3) & 1;
        }
        if (in.remaining() > end_remaining) dataType = in.get<uint8_t>();
        if (in.remaining() > end_remaining) quantbinCnt = in.get<int32_t>();
        if (in.remaining() > end_remaining) blockSize = in.get<int32_t>();
        if (in.remaining() > end_remaining) predDim = in.get<uint8_t>();
    }
};

// Range of the data (max - min), computed in T (reference Statistic.hpp:11-20).
template <class T>
T data_range(const T* data, size_t n) {
    T mx = data[0], mn = data[0];
    for (size_t i = 1; i < n; i++) {
        if (mx < data[i]) mx = data[i];
        if (mn > data[i]) mn = data[i];
    }
    return mx - mn;
}

// Convert any error-bound mode to ABS in place (reference Statistic.hpp:24-56).
template <class T>
void cal_abs_error_bound(Conf& conf, const T* data, T range = 0) {
    auto rng = [&]() -> double { return double(range > 0 ? range : data_range(data, conf.num())); };
    switch (EbMode(conf.errorBoundMode)) {
        case EbMode::ABS:
            break;
        case EbMode::REL:
            conf.errorBoundMode = uint8_t(EbMode::ABS);
            conf.absErrorBound = conf.relErrorBound * rng();
            break;
        case EbMode::PSNR: {
            conf.errorBoundMode = uint8_t(EbMode::ABS);
            double v1 = conf.psnrErrorBound + 10 * std::log10(1 - 2.0 / 3.0 * 0.99);
            conf.absErrorBound = rng() * std::pow(10, v1 / -20);
            break;
        }
        case EbMode::L2NORM:
            conf.errorBoundMode = uint8_t(EbMode::ABS);
            conf.absErrorBound = std::sqrt(3.0 / conf.num()) * conf.l2normErrorBound;
            break;
        case EbMode::ABS_AND_REL:
            conf.errorBoundMode = uint8_t(EbMode::ABS);
            conf.absErrorBound = std::min(conf.absErrorBound, conf.relErrorBound * rng());
            break;
        case EbMode::ABS_OR_REL:
            conf.errorBoundMode = uint8_t(EbMode::ABS);
            conf.absErrorBound = std::max(conf.absErrorBound, conf.relErrorBound * rng());
            break;
    }
}

}  // namespace szt
#endif
