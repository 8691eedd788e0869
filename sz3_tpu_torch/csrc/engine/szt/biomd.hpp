// ALGO_BIOMD decomposition: molecular-dynamics trajectory prediction.
//
// Behavior contract (reference decomposition/SZBioMDDecomposition.hpp):
//  - 1D: previous-element prediction (75-90).
//  - 2D (atom, xyz): water-model "site" detection over the first <=100 atoms
//    and <=5 columns via relative-jump histogram (cal_site, 92-126, accepted
//    iff 2 < period <= 10); each atom predicted from atom j - max(1, j%site)
//    (165-198).
//  - 3D (time, atom, xyz): frame 0 as in 2D; frames t>0 use previous-frame
//    prediction at site boundaries and a 2D Lorenzo in (time, atom) elsewhere
//    (229-285); trailing frames filled with one constant are elided
//    (findFillValueAndFirstFilledFrame, 130-163) and refilled on decompression
//    (336-342).
//  - serialized state: [site i32][firstFillFrame u64][fillValue T][quantizer]
//    (45-50).
#ifndef SZT_BIOMD_HPP
#define SZT_BIOMD_HPP

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <vector>

#include "common.hpp"
#include "quantizer.hpp"

namespace szt {

// Dominant period of relative jumps down the atom axis; 0 when no clean
// 3..10-atom periodicity exists. Ties in the histogram resolve to the
// first-seen period (the reference's unordered_map iteration order is
// implementation-defined there; ties are not reachable on real MD inputs).
template <class T>
int biomd_cal_site(const T* data, size_t atoms, size_t cols) {
    std::vector<int> sites;
    for (size_t j = 0; j < std::min<size_t>(cols, 5); j++) {
        size_t lprev = 0;
        for (size_t i = 1; i < std::min<size_t>(atoms, 100); i++) {
            T c = data[i * cols + j], p = data[(i - 1) * cols + j];
            if (std::fabs(c - p) / c > 0.5) {
                sites.push_back(int(i - lprev));
                lprev = i;
            }
        }
    }
    // histogram with first-seen tie-break
    std::vector<std::pair<int, size_t>> freq;
    for (int s : sites) {
        bool found = false;
        for (auto& kv : freq)
            if (kv.first == s) {
                kv.second++;
                found = true;
                break;
            }
        if (!found) freq.push_back({s, 1});
    }
    size_t max_count = 0;
    int res = 0;
    for (auto& kv : freq)
        if (kv.second > max_count) {
            res = kv.first;
            max_count = kv.second;
        }
    return (res <= 2 || res > 10) ? 0 : res;
}

// Scan back from the last frame for a constant-filled tail
// (reference SZBioMDDecomposition.hpp:130-163).
template <class T>
std::pair<size_t, T> biomd_find_fill(const T* data, size_t frames, size_t frame_elems) {
    size_t first_fill = frames;
    if (first_fill == 0) return {0, T(0)};
    T fill = data[(frames - 1) * frame_elems];
    for (size_t i = frames - 1; i > 0; i--) {
        const T* f = data + i * frame_elems;
        bool all = true;
        for (size_t j = 0; j < frame_elems; j++)
            if (f[j] != fill) {
                all = false;
                break;
            }
        if (all) first_fill = i;
        else break;
    }
    return {first_fill, fill};
}

template <class T, int N>
struct BioMDCodec {
    static_assert(N >= 1 && N <= 3, "BioMD supports 1D-3D only");

    std::array<size_t, N> dims{};
    LinearQuantizer<T> quant;
    int32_t site = 0;
    size_t first_fill_frame = 0;
    T fill_value = T(0);

    size_t num() const {
        size_t n = 1;
        for (auto d : dims) n *= d;
        return n;
    }

    void compress(T* data, std::vector<int32_t>& bins) {
        bins.resize(num());
        if (N == 1) {
            bins[0] = quant.quantize(data[0], T(0));
            for (size_t i = 1; i < dims[0]; i++) bins[i] = quant.quantize(data[i], data[i - 1]);
            first_fill_frame = dims[0];
        } else if (N == 2) {
            site = biomd_cal_site(data, dims[0], dims[1]);
            first_fill_frame = dims[0];
            fill_value = T(0);
            compress_frame0(data, bins.data(), dims[0], dims[1]);
        } else {
            size_t fstride = dims[1] * dims[2];
            site = biomd_cal_site(data + fstride, dims[1], dims[2]);
            std::array<size_t, 3> d3{dims[0], dims[1], dims[2]};
            auto ff = biomd_find_fill(data, d3[0], fstride);
            first_fill_frame = ff.first;
            fill_value = ff.second;
            size_t last = std::min(d3[0], first_fill_frame);
            compress_frame0(data, bins.data(), d3[1], d3[2]);
            for (size_t i = 1; i < last; i++) {
                for (size_t j = 0; j < d3[1]; j++) {
                    size_t sro = site != 0 ? j % site : 1;
                    for (size_t k = 0; k < d3[2]; k++) {
                        size_t idx = i * fstride + j * d3[2] + k;
                        size_t prev_t = idx - fstride;
                        if (j == 0 || (site != 0 && j % site == 0)) {
                            bins[idx] = quant.quantize(data[idx], data[prev_t]);
                        } else {
                            size_t idx2 = idx - sro * d3[2];           // same frame, ref atom
                            size_t idx3 = prev_t - sro * d3[2];        // prev frame, ref atom
                            bins[idx] = quant.quantize(data[idx],
                                                       T(data[prev_t] + data[idx2] - data[idx3]));
                        }
                    }
                }
            }
            // bins past lastFrame stay 0 — the reference allocates conf.num
            // zeros and never writes the fill tail (compress_3d, :230,266)
        }
    }

    void decompress(const std::vector<int32_t>& bins, T* out) {
        if (N == 1) {
            out[0] = quant.recover(T(0), bins[0]);
            for (size_t i = 1; i < dims[0]; i++) out[i] = quant.recover(out[i - 1], bins[i]);
        } else if (N == 2) {
            decompress_frame0(bins.data(), out, dims[0], dims[1]);
        } else {
            size_t fstride = dims[1] * dims[2];
            size_t last = std::min(dims[0], first_fill_frame);
            decompress_frame0(bins.data(), out, dims[1], dims[2]);
            for (size_t i = 1; i < last; i++) {
                for (size_t j = 0; j < dims[1]; j++) {
                    size_t sro = site != 0 ? j % site : 1;
                    for (size_t k = 0; k < dims[2]; k++) {
                        size_t idx = i * fstride + j * dims[2] + k;
                        size_t prev_t = idx - fstride;
                        if (j == 0 || (site != 0 && j % site == 0)) {
                            out[idx] = quant.recover(out[prev_t], bins[idx]);
                        } else {
                            size_t idx2 = idx - sro * dims[2];
                            size_t idx3 = prev_t - sro * dims[2];
                            out[idx] = quant.recover(T(out[prev_t] + out[idx2] - out[idx3]),
                                                     bins[idx]);
                        }
                    }
                }
            }
            for (size_t i = first_fill_frame; i < dims[0]; i++) {
                T* f = out + i * fstride;
                for (size_t j = 0; j < fstride; j++) f[j] = fill_value;
            }
        }
    }

    void save(Sink& out) const {
        out.put<int32_t>(site);
        out.put<size_t>(first_fill_frame);
        out.put<T>(fill_value);
        quant.save(out);
    }

    void load(Source& in) {
        site = in.template get<int32_t>();
        first_fill_frame = in.template get<size_t>();
        fill_value = in.template get<T>();
        quant.load(in);
    }

    // intra-frame pass shared by 2D data and frame 0 of 3D data
    // (SZBioMDDecomposition.hpp:174-195 / 243-264). Public: the device path
    // (ops/biomd_device.py) runs only frames 1..last on-chip and calls these
    // for the sequential frame-0 atom chain (szt_biomd_frame0_*).
    void compress_frame0(T* data, int32_t* bins, size_t atoms, size_t cols) {
        for (size_t k = 0; k < cols; k++) bins[k] = quant.quantize(data[k], T(0));
        for (size_t j = 1; j < atoms; j++) {
            size_t sro = site != 0 ? std::max<size_t>(1, j % site) : 1;
            for (size_t k = 0; k < cols; k++) {
                size_t idx = j * cols + k;
                bins[idx] = quant.quantize(data[idx], data[idx - sro * cols]);
            }
        }
    }

    void decompress_frame0(const int32_t* bins, T* out, size_t atoms, size_t cols) {
        for (size_t k = 0; k < cols; k++) out[k] = quant.recover(T(0), bins[k]);
        for (size_t j = 1; j < atoms; j++) {
            size_t sro = site != 0 ? std::max<size_t>(1, j % site) : 1;
            for (size_t k = 0; k < cols; k++) {
                size_t idx = j * cols + k;
                out[idx] = quant.recover(out[idx - sro * cols], bins[idx]);
            }
        }
    }
};

// ALGO_BIOMDXTC decomposition: global quantization biased to signed ints for
// the XTC triplet coder (reference decomposition/SZBioMDXtcDecomposition.hpp).
// Quantizer radius is INT_MAX/16 with strict_eb=false (SZAlgoBioMD.hpp:46);
// N==3 elides constant trailing frames, so the bin stream is
// firstFillFrame*dims[1]*dims[2] long (get_num_elements, :60-65).
constexpr int32_t kXtcRadius = INT32_MAX / 16;

template <class T, int N>
struct BioMDXtcCodec {
    static_assert(N >= 1 && N <= 3, "BioMDXtc supports 1D-3D only");

    std::array<size_t, N> dims{};
    LinearQuantizer<T> quant;
    size_t first_fill_frame = 0;
    T fill_value = T(0);

    size_t num() const {
        size_t n = 1;
        for (auto d : dims) n *= d;
        return n;
    }

    void compress(T* data, std::vector<int32_t>& bins) {
        if (N <= 2) {
            // the reference leaves these members untouched on the 1D/2D path
            // and serializes zero-initialized storage; match those bytes
            first_fill_frame = 0;
            fill_value = T(0);
            bins.resize(num());
            for (size_t i = 0; i < bins.size(); i++)
                bins[i] = quant.quantize(data[i], T(0)) - kXtcRadius;
        } else {
            size_t fstride = dims[1] * dims[2];
            auto ff = biomd_find_fill(data, dims[0], fstride);
            first_fill_frame = ff.first;
            fill_value = ff.second;
            size_t last = std::min(dims[0], first_fill_frame);
            bins.resize(last * fstride);
            for (size_t i = 0; i < bins.size(); i++)
                bins[i] = quant.quantize(data[i], T(0)) - kXtcRadius;
        }
    }

    // the stored bins: every point, or for 3D the frames before the fill
    size_t live() const {
        return N <= 2 ? num() : std::min(dims[0], first_fill_frame) * dims[N - 2] * dims[N - 1];
    }

    void decompress(const std::vector<int32_t>& bins, T* out) {
        size_t n = live();
        for (size_t i = 0; i < n; i++) out[i] = quant.recover(T(0), bins[i] + kXtcRadius);
        if (N == 3) {
            size_t fstride = dims[1] * dims[2];
            for (size_t i = first_fill_frame; i < dims[0]; i++) {
                T* f = out + i * fstride;
                for (size_t j = 0; j < fstride; j++) f[j] = fill_value;
            }
        }
    }

    void save(Sink& out) const {
        out.put<size_t>(first_fill_frame);
        out.put<T>(fill_value);
        quant.save(out);
    }

    void load(Source& in) {
        first_fill_frame = in.template get<size_t>();
        fill_value = in.template get<T>();
        quant.load(in);
    }
};

}  // namespace szt
#endif
