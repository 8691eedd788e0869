// Pipeline glue: decomposition -> Huffman -> zstd, the algorithm dispatcher,
// the INTERP_LORENZO auto-tuner, and the chunked (OpenMP-equivalent) parallel
// mode. Output bytes are the archive payload between the 16-byte container
// header and the trailing Config.
//
// Behavior contracts:
//  - payload layout [decomp.save][huffman tree][quant count u64][bitstream]
//    then zstd: reference compressor/SZGenericCompressor.hpp:38-84
//  - dispatcher incl. lossless fallbacks: api/impl/SZDispatcher.hpp:13-101
//  - tuner: api/impl/SZAlgoInterp.hpp:122-286 (+utils/Sample.hpp)
//  - chunked mode: api/impl/SZImplOMP.hpp:16-186
#ifndef SZT_PIPELINE_HPP
#define SZT_PIPELINE_HPP

#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <memory>
#include <thread>
#include <vector>

#include "biomd.hpp"
#include "blockwise.hpp"
#include "common.hpp"
#include "conf.hpp"
#include "huffman.hpp"
#include "huffman_v2.hpp"
#include "interp.hpp"
#include "quantizer.hpp"
#include "xtc.hpp"
#include "zstd_wrap.hpp"

namespace szt {

// Scoped stage timer, printed only when SZT_DEBUG_TIMINGS is set
// (the reference's SZ3_DEBUG_TIMINGS analog, utils/Timer.hpp:30-36).
struct StageTimer {
    const char* name;
    std::chrono::steady_clock::time_point t0;
    explicit StageTimer(const char* n) : name(n), t0(std::chrono::steady_clock::now()) {}
    ~StageTimer() {
        static const bool on = [] {
            const char* e = std::getenv("SZT_DEBUG_TIMINGS");
            return e && *e && std::string(e) != "0";
        }();
        if (on) {
            auto dt = std::chrono::duration<double>(std::chrono::steady_clock::now() - t0);
            std::fprintf(stderr, "[szt] %s time = %.6f\n", name, dt.count());
        }
    }
};

// ---- generic [decomp|tree|count|bits] -> zstd stage -------------------------

template <class T, class Decomp>
std::vector<uint8_t> seal_payload(Decomp& decomp, const std::vector<int32_t>& bins, size_t cap) {
    Huffman<int32_t> huff;
    {
        StageTimer t("huffman build");
        huff.build(bins.data(), bins.size());
    }
    Sink inner;
    inner.reserve(bins.size() / 2 + 4096);
    decomp.save(inner);
    huff.save(inner);
    inner.put<size_t>(bins.size());
    {
        StageTimer t("huffman encode");
        huff.encode(bins.data(), bins.size(), inner);
    }
    StageTimer t("zstd compress");
    return zstd_pack(inner.buf.data(), inner.buf.size(), cap);
}

// `expect`: the bin count the decomposition reads back (checked before the
// bins are sized)
template <class Decomp>
void open_payload(Decomp& decomp, const uint8_t* cmp, size_t len, std::vector<int32_t>& bins,
                  size_t expect) {
    std::vector<uint8_t> raw;
    {
        StageTimer t("zstd decompress");
        raw = zstd_unpack(cmp, len);
    }
    Source src(raw.data(), raw.size());
    decomp.load(src);
    Huffman<int32_t> huff;
    huff.load(src);
    size_t count = src.template get<size_t>();
    check_count(count, expect, "bin");
    bins.resize(count);
    StageTimer t("huffman decode");
    huff.decode(src, count, bins.data());
}

// ---- no-prediction decomposition (reference NoPredictionDecomposition.hpp) --

template <class T>
struct NopredCodec {
    LinearQuantizer<T> quant;
    size_t n = 0;

    void compress(const T* data, int32_t* bins) {
        // reconstructions never feed later predictions here, so they are
        // discarded and the input stays const
        T scratch;
        for (size_t i = 0; i < n; i++) bins[i] = quant.quantize_from(data[i], T(0), scratch);
    }
    void decompress(const int32_t* bins, T* out) {
        for (size_t i = 0; i < n; i++) out[i] = quant.recover(T(0), bins[i]);
    }
    void save(Sink& s) const { quant.save(s); }
    void load(Source& s) { quant.load(s); }
};

// ---- per-algorithm entry points ---------------------------------------------

template <class T, int N>
InterpCodec<T, N> make_interp(const Conf& conf) {
    InterpCodec<T, N> c;
    for (int i = 0; i < N; i++) c.dims[i] = conf.dims[i];
    c.interp_id = conf.interpAlgo;
    c.direction = conf.interpDirection;
    c.anchor_stride = size_t(conf.interpAnchorStride);
    c.alpha = conf.interpAlpha;
    c.beta = conf.interpBeta;
    c.blocksize = 32;
    c.quant = LinearQuantizer<T>(conf.absErrorBound, conf.quantbinCnt / 2);
    return c;
}

inline void default_anchor_stride(Conf& conf) {
    // reference SZAlgoInterp.hpp:21-24
    if (conf.interpAnchorStride < 0) {
        static const int64_t strides[4] = {4096, 128, 32, 16};
        conf.interpAnchorStride = strides[conf.N() - 1];
    }
}

template <class T, int N>
std::vector<uint8_t> compress_interp(Conf& conf, const T* data, size_t cap) {
    default_anchor_stride(conf);
    auto codec = make_interp<T, N>(conf);
    std::vector<int32_t> bins(conf.num());
    // reconstructions land in a scratch buffer; `data` stays untouched
    // (replaces the dispatcher-level defensive copy)
    std::unique_ptr<T[]> work(new T[conf.num()]);
    {
        StageTimer t("interp sweep");
        codec.compress_into(data, work.get(), bins.data());
    }
    return seal_payload<T>(codec, bins, cap);
}

template <class T, int N>
void decompress_interp(const Conf& conf, const uint8_t* cmp, size_t len, T* out) {
    InterpCodec<T, N> codec;
    for (int i = 0; i < N; i++) codec.dims[i] = conf.dims[i];
    std::vector<int32_t> bins;
    open_payload(codec, cmp, len, bins, conf.num());
    codec.decompress(bins.data(), out);
}

template <class T, int N>
std::vector<uint8_t> compress_nopred(Conf& conf, const T* data, size_t cap) {
    NopredCodec<T> codec;
    codec.n = conf.num();
    codec.quant = LinearQuantizer<T>(conf.absErrorBound, conf.quantbinCnt / 2);
    std::vector<int32_t> bins(codec.n);
    codec.compress(data, bins.data());
    return seal_payload<T>(codec, bins, cap);
}

template <class T, int N>
void decompress_nopred(const Conf& conf, const uint8_t* cmp, size_t len, T* out) {
    NopredCodec<T> codec;
    codec.n = conf.num();
    std::vector<int32_t> bins;
    open_payload(codec, cmp, len, bins, codec.n);
    codec.decompress(bins.data(), out);
}

template <class T, int N>
BlockwiseCodec<T, N> make_blockwise(const Conf& conf) {
    BlockwiseCodec<T, N> c;
    for (int i = 0; i < N; i++) c.dims[i] = conf.dims[i];
    c.block_size = conf.blockSize;
    c.use_lorenzo = conf.lorenzo;
    c.use_lorenzo2 = conf.lorenzo2;
    c.use_regression = conf.regression;
    c.eb = conf.absErrorBound;
    c.quant = LinearQuantizer<T>(conf.absErrorBound, conf.quantbinCnt / 2);
    return c;
}

template <class T, int N>
std::vector<uint8_t> compress_lorenzo_reg(Conf& conf, const T* data, size_t cap) {
    auto codec = make_blockwise<T, N>(conf);
    std::vector<int32_t> bins(conf.num());
    {
        StageTimer t("blockwise sweep");
        // the compress-mode PaddedGrid owns its scratch copy and never writes
        // back (blockwise.hpp grid.finish()), so the input is effectively const
        codec.compress(const_cast<T*>(data), bins.data());
    }
    return seal_payload<T>(codec, bins, cap);
}

template <class T, int N>
void decompress_lorenzo_reg(const Conf& conf, const uint8_t* cmp, size_t len, T* out) {
    auto codec = make_blockwise<T, N>(conf);
    std::vector<int32_t> bins;
    open_payload(codec, cmp, len, bins, conf.num());
    codec.decompress(bins.data(), out);
}

// ---- BioMD algorithms (reference api/impl/SZAlgoBioMD.hpp) -------------------

// ALGO_BIOMD: BioMD decomposition -> HuffmanEncoderV2 -> zstd. stateNum for
// the encoder is the quantizer's out-range top = quantbinCnt
// (SZGenericCompressor.hpp:44 with LinearQuantizer radius quantbinCnt/2).
template <class T, int N>
std::vector<uint8_t> compress_biomd(Conf& conf, T* data, size_t cap) {
    if constexpr (N > 3) {
        throw std::invalid_argument("BioMD only supports 1D, 2D or 3D data");
    } else {
        BioMDCodec<T, N> codec;
        for (int i = 0; i < N; i++) codec.dims[i] = conf.dims[i];
        codec.quant = LinearQuantizer<T>(conf.absErrorBound, conf.quantbinCnt / 2);
        std::vector<int32_t> bins;
        codec.compress(data, bins);
        HuffmanV2<int32_t> huff;
        huff.build(bins.data(), bins.size(), conf.quantbinCnt);
        Sink inner;
        inner.reserve(bins.size() / 2 + 4096);
        codec.save(inner);
        huff.save(inner);
        inner.put<size_t>(bins.size());
        huff.encode(bins.data(), bins.size(), inner);
        return zstd_pack(inner.buf.data(), inner.buf.size(), cap);
    }
}

template <class T, int N>
void decompress_biomd(const Conf& conf, const uint8_t* cmp, size_t len, T* out) {
    if constexpr (N > 3) {
        throw std::invalid_argument("BioMD only supports 1D, 2D or 3D data");
    } else {
        auto raw = zstd_unpack(cmp, len);
        Source src(raw.data(), raw.size());
        BioMDCodec<T, N> codec;
        for (int i = 0; i < N; i++) codec.dims[i] = conf.dims[i];
        codec.load(src);
        HuffmanV2<int32_t> huff;
        huff.load(src);
        size_t count = src.template get<size_t>();
        check_count(count, conf.num(), "bin");
        std::vector<int32_t> bins(count);
        huff.decode(src, count, bins.data());
        codec.decompress(bins, out);
    }
}

// ---- BioMD device-path split (ops/biomd_device.py) ---------------------------
// The device lax.scan computes frames 1..last of a 3D trajectory (each frame
// is two vectorized quantize steps when site != 0); the sequential frame-0
// atom chain, the HuffmanV2+zstd sealing and their inverses run here. Payload
// bytes equal compress_biomd's output for the same input (asserted by
// tests/test_biomd_device.py).

template <class T>
void biomd_frame0_encode(double eb, int radius, int32_t site, const T* data,
                         size_t atoms, size_t cols, int32_t* bins, T* recon,
                         std::vector<T>& unpred) {
    BioMDCodec<T, 2> codec;
    codec.dims = {atoms, cols};
    codec.quant = LinearQuantizer<T>(eb, radius);
    codec.site = site;
    std::vector<T> buf(data, data + atoms * cols);
    codec.compress_frame0(buf.data(), bins, atoms, cols);
    std::copy(buf.begin(), buf.end(), recon);
    unpred = std::move(codec.quant.unpred);
}

template <class T>
void biomd_frame0_decode(double eb, int radius, int32_t site, const int32_t* bins,
                         size_t atoms, size_t cols, const T* unpred,
                         size_t n_unpred, T* out) {
    BioMDCodec<T, 2> codec;
    codec.dims = {atoms, cols};
    codec.quant = LinearQuantizer<T>(eb, radius);
    codec.quant.unpred.assign(unpred, unpred + n_unpred);
    codec.site = site;
    codec.decompress_frame0(bins, out, atoms, cols);
}

template <class T, int N>
std::vector<uint8_t> biomd_seal(Conf& conf, const int32_t* bins, size_t n,
                                const T* unpred, size_t n_unpred, int32_t site,
                                size_t first_fill, T fill, size_t cap) {
    BioMDCodec<T, N> codec;
    for (int i = 0; i < N; i++) codec.dims[i] = conf.dims[i];
    codec.quant = LinearQuantizer<T>(conf.absErrorBound, conf.quantbinCnt / 2);
    codec.quant.unpred.assign(unpred, unpred + n_unpred);
    codec.site = site;
    codec.first_fill_frame = first_fill;
    codec.fill_value = fill;
    HuffmanV2<int32_t> huff;
    huff.build(bins, n, conf.quantbinCnt);
    Sink inner;
    inner.reserve(n / 2 + 4096);
    codec.save(inner);
    huff.save(inner);
    inner.put<size_t>(n);
    huff.encode(bins, n, inner);
    return zstd_pack(inner.buf.data(), inner.buf.size(), cap);
}

template <class T, int N>
void biomd_open(Conf& conf, const uint8_t* cmp, size_t len,
                std::vector<int32_t>& bins, std::vector<T>& unpred,
                int32_t& site, size_t& first_fill, T& fill) {
    auto raw = zstd_unpack(cmp, len);
    Source src(raw.data(), raw.size());
    BioMDCodec<T, N> codec;
    for (int i = 0; i < N; i++) codec.dims[i] = conf.dims[i];
    codec.load(src);
    HuffmanV2<int32_t> huff;
    huff.load(src);
    size_t count = src.template get<size_t>();
    check_count(count, conf.num(), "bin");
    bins.resize(count);
    huff.decode(src, count, bins.data());
    unpred = std::move(codec.quant.unpred);
    site = codec.site;
    first_fill = codec.first_fill_frame;
    fill = codec.fill_value;
    // effective quantizer params back into conf (cf. nopred_open)
    conf.absErrorBound = codec.quant.eb();
    conf.quantbinCnt = codec.quant.radius() * 2;
}

// ALGO_BIOMDXTC: Xtc decomposition -> XtcBasedEncoder -> bypass (no zstd).
// Payload layout [decomp][encoder save][count u64][xtc stream] per
// SZGenericCompressor with Lossless_bypass (SZAlgoBioMD.hpp:46-48).
template <class T, int N>
std::vector<uint8_t> compress_biomdxtc(Conf& conf, T* data, size_t cap) {
    if constexpr (N > 3) {
        throw std::invalid_argument("BioMDXtc only supports 1D, 2D or 3D data");
    } else {
        BioMDXtcCodec<T, N> codec;
        for (int i = 0; i < N; i++) codec.dims[i] = conf.dims[i];
        codec.quant = LinearQuantizer<T>(conf.absErrorBound, kXtcRadius, /*strict=*/false);
        std::vector<int32_t> bins;
        codec.compress(data, bins);
        XtcCoder coder;
        coder.preprocess(bins.data(), bins.size());
        Sink inner;
        inner.reserve(bins.size() + 4096);
        codec.save(inner);
        coder.save(inner);
        inner.put<size_t>(bins.size());
        coder.encode(bins.data(), bins.size(), inner);
        if (inner.buf.size() > cap) throw buffer_too_small();
        return std::move(inner.buf);
    }
}

template <class T, int N>
void decompress_biomdxtc(const Conf& conf, const uint8_t* cmp, size_t len, T* out) {
    if constexpr (N > 3) {
        throw std::invalid_argument("BioMDXtc only supports 1D, 2D or 3D data");
    } else {
        Source src(cmp, len);
        BioMDXtcCodec<T, N> codec;
        for (int i = 0; i < N; i++) codec.dims[i] = conf.dims[i];
        codec.load(src);
        XtcCoder coder;
        coder.load(src);
        size_t count = src.template get<size_t>();
        check_count(count, codec.live(), "bin");
        std::vector<int32_t> bins(count);
        coder.decode(src, count, bins.data());
        codec.decompress(bins, out);
    }
}

// ---- INTERP_LORENZO auto-tuner ----------------------------------------------

// Flag blocks whose sampled value range exceeds the error bound
// (reference utils/Sample.hpp:8-127).
template <class T, int N>
void profiling_block(const T* data, const std::array<size_t, N>& dims,
                     std::vector<std::array<size_t, N>>& starts, size_t bs, double abseb,
                     size_t stride) {
    if (stride == 0) stride = bs;
    // origins run over [0, dims[i]-bs) — empty when dims[i] <= bs
    // (reference guards `<` and the loop bound excludes equality)
    for (int i = 0; i < N; i++)
        if (dims[i] <= bs) return;
    std::array<size_t, N> offs;
    offs[N - 1] = 1;
    for (int i = N - 2; i >= 0; i--) offs[i] = offs[i + 1] * dims[i + 1];
    std::array<size_t, N> bi{};
    // iterate block origins 0 .. dims[i]-bs (exclusive) step bs, row-major
    while (true) {
        size_t start = 0;
        for (int i = 0; i < N; i++) start += bi[i] * offs[i];
        T mn = data[start], mx = data[start];
        std::array<size_t, N> si{};
        while (true) {
            size_t idx = start;
            for (int i = 0; i < N; i++) idx += si[i] * offs[i];
            T v = data[idx];
            if (v < mn) mn = v;
            else if (v > mx) mx = v;
            int i = N - 1;
            while (i >= 0 && (si[i] += stride) > bs) si[i--] = 0;
            if (i < 0) break;
        }
        if (double(mx - mn) > abseb) starts.push_back(bi);
        int i = N - 1;
        while (i >= 0) {
            bi[i] += bs;
            if (bi[i] + bs < dims[i]) break;  // origin < dims[i]-bs
            bi[i--] = 0;
        }
        if (i < 0) break;
    }
    // convert block indices (already element offsets) — starts hold origins
}

// Extract equal-size sample blocks (reference utils/Sample.hpp:129-289).
template <class T, int N>
void sample_blocks(const T* data, const std::array<size_t, N>& dims, size_t sbs,
                   std::vector<std::vector<T>>& out, double rate, bool profiling,
                   const std::vector<std::array<size_t, N>>& starts) {
    for (int i = 0; i < N; i++)
        if (dims[i] < sbs) return;
    if (!profiling)  // regular-grid origins run over [0, dims[i]-sbs)
        for (int i = 0; i < N; i++)
            if (dims[i] <= sbs) return;
    out.clear();
    size_t totalblocks = 1;
    for (int i = 0; i < N; i++) totalblocks *= (dims[i] - 1) / sbs;
    std::array<size_t, N> offs;
    offs[N - 1] = 1;
    for (int i = N - 2; i >= 0; i--) offs[i] = offs[i + 1] * dims[i + 1];
    size_t edge = sbs + 1;
    auto copy_block = [&](const std::array<size_t, N>& s) {
        std::vector<T> block(1);
        size_t nb = 1;
        for (int i = 0; i < N; i++) nb *= edge;
        block.resize(nb);
        std::array<size_t, N> li{};
        size_t w = 0;
        while (true) {
            size_t idx = 0;
            for (int i = 0; i < N; i++) idx += (s[i] + li[i]) * offs[i];
            block[w++] = data[idx];
            int i = N - 1;
            while (i >= 0 && ++li[i] == edge) li[i--] = 0;
            if (i < 0) break;
        }
        out.push_back(std::move(block));
    };
    if (profiling) {
        size_t stride = size_t(double(starts.size()) / (double(totalblocks) * rate));
        if (stride == 0) stride = 1;
        for (size_t i = 0; i < starts.size(); i += stride) copy_block(starts[i]);
    } else {
        size_t stride = size_t(1.0 / rate);
        if (stride == 0) stride = 1;
        size_t idx = 0;
        std::array<size_t, N> s{};
        // origins 0 .. dims[i]-sbs (exclusive), step sbs, row-major
        bool done = false;
        while (!done) {
            if (idx % stride == 0) copy_block(s);
            idx++;
            int i = N - 1;
            while (i >= 0) {
                s[i] += sbs;
                if (s[i] < dims[i] - sbs) break;
                s[i--] = 0;
            }
            if (i < 0) done = true;
        }
    }
}

// Trial compression of the sampled blocks through the interp pipeline;
// returns the compression ratio (reference SZAlgoInterp.hpp:43-76).
template <class T, int N>
double interp_trial(const std::vector<std::vector<T>>& blocks, const Conf& test_conf, size_t cap) {
    auto codec = make_interp<T, N>(test_conf);
    std::vector<int32_t> all;
    std::vector<int32_t> bins(test_conf.num());
    for (const auto& blk : blocks) {
        std::vector<T> cur = blk;  // compress mutates
        codec.compress(cur.data(), bins.data());
        all.insert(all.end(), bins.begin(), bins.end());
    }
    auto sealed = seal_payload<T>(codec, all, cap);
    return double(test_conf.num() * blocks.size() * sizeof(T)) / double(sealed.size());
}

// Lorenzo trial over the sampled blocks (reference SZAlgoInterp.hpp:78-119;
// predictor set fixed to {lorenzo1, lorenzo2}).
template <class T, int N>
double lorenzo_trial(const std::vector<std::vector<T>>& blocks, const Conf& test_conf, size_t cap) {
    BlockwiseCodec<T, N> codec;
    for (int i = 0; i < N; i++) codec.dims[i] = test_conf.dims[i];
    codec.block_size = test_conf.blockSize;
    codec.use_lorenzo = true;
    codec.use_lorenzo2 = true;
    codec.use_regression = false;
    codec.eb = test_conf.absErrorBound;
    codec.quant = LinearQuantizer<T>(test_conf.absErrorBound, test_conf.quantbinCnt / 2);
    codec.configure();
    std::vector<int32_t> all;
    std::vector<int32_t> bins(test_conf.num());
    for (const auto& blk : blocks) {
        std::vector<T> cur = blk;
        codec.run_compress(cur.data(), bins.data());
        all.insert(all.end(), bins.begin(), bins.end());
    }
    auto sealed = seal_payload<T>(codec, all, cap);
    return double(test_conf.num() * blocks.size() * sizeof(T)) / double(sealed.size());
}

template <class T, int N>
std::vector<uint8_t> compress_dispatch(Conf& conf, const T* data, size_t cap);

// The sampling auto-tuner behind the default ALGO_INTERP_LORENZO
// (reference SZAlgoInterp.hpp:122-286). Decision only: rewrites conf to
// either ALGO_INTERP (with tuned interp params) or ALGO_LORENZO_REG (with
// the tuned lorenzo config); the caller then runs that algorithm.
template <class T, int N>
void tune_interp_lorenzo(Conf& conf, const T* data) {
    cal_abs_error_bound(conf, data);
    default_anchor_stride(conf);

    const double sample_rate = 0.005;
    static const size_t sbs_default[4] = {4096, 128, 32, 16};
    size_t sbs = sbs_default[N - 1];
    size_t shortest = conf.dims[0];
    for (auto d : conf.dims) shortest = std::min(shortest, d);
    while (sbs >= shortest) sbs /= 2;
    while (sbs >= 16 && std::pow(double(sbs + 1), N) / double(conf.num()) > 1.5 * sample_rate)
        sbs /= 2;
    if (sbs < 8) sbs = 8;

    bool to_tune = std::pow(double(sbs + 1), N) <= 0.05 * double(conf.num());
    for (auto d : conf.dims)
        if (d < sbs) { to_tune = false; break; }
    if (!to_tune) {
        conf.cmprAlgo = uint8_t(Algo::INTERP);
        return;
    }

    std::array<size_t, N> dims;
    for (int i = 0; i < N; i++) dims[i] = conf.dims[i];
    std::vector<std::array<size_t, N>> starts;
    profiling_block<T, N>(data, dims, starts, sbs, conf.absErrorBound, sbs / 4);
    size_t per_block = size_t(std::pow(double(sbs + 1), N));
    bool profiling = double(starts.size() * per_block) >= 0.5 * sample_rate * double(conf.num());
    std::vector<std::vector<T>> blocks;
    sample_blocks<T, N>(data, dims, sbs, blocks, sample_rate, profiling, starts);
    size_t sampling_num = blocks.size() * per_block;
    if (sampling_num == 0 || sampling_num >= size_t(double(conf.num()) * 0.2)) {
        conf.cmprAlgo = uint8_t(Algo::INTERP);
        return;
    }

    double best_lorenzo = 0, best_interp = 0, ratio;
    size_t trial_cap = conf.num() * sizeof(T);
    Conf lorenzo_conf = conf;

    conf.interpDirection = 0;
    conf.interpAlpha = 1.25;
    conf.interpBeta = 2.0;
    Conf test = conf;
    test.set_dims(std::vector<size_t>(N, sbs + 1));
    for (uint8_t op : {uint8_t(0), uint8_t(1)}) {  // linear, cubic
        test.interpAlgo = op;
        ratio = interp_trial<T, N>(blocks, test, trial_cap);
        if (ratio > best_interp) {
            best_interp = ratio;
            conf.interpAlgo = op;
        }
    }
    test.interpAlgo = conf.interpAlgo;
    int fact = 1;
    for (int i = 2; i <= N; i++) fact *= i;
    test.interpDirection = fact - 1;
    ratio = interp_trial<T, N>(blocks, test, trial_cap);
    if (ratio > best_interp * 1.02) {
        best_interp = ratio;
        conf.interpDirection = test.interpDirection;
    }
    test.interpDirection = conf.interpDirection;
    const double alphas[3] = {1.0, 1.5, 2.0};
    const double betas[3] = {1.0, 2.5, 3.0};
    for (int i = 0; i < 3; i++) {
        test.interpAlpha = alphas[i];
        test.interpBeta = betas[i];
        ratio = interp_trial<T, N>(blocks, test, trial_cap);
        if (ratio > best_interp * 1.02) {
            best_interp = ratio;
            conf.interpAlpha = alphas[i];
            conf.interpBeta = betas[i];
        }
    }

    if (N == 1 && best_interp < 50) {  // reference tests lorenzo for 1D only
        lorenzo_conf.cmprAlgo = uint8_t(Algo::LORENZO_REG);
        lorenzo_conf.set_dims(std::vector<size_t>(N, sbs + 1));
        lorenzo_conf.lorenzo = true;
        lorenzo_conf.lorenzo2 = true;
        lorenzo_conf.regression = false;
        lorenzo_conf.regression2 = false;
        lorenzo_conf.openmp = false;
        lorenzo_conf.blockSize = 5;
        best_lorenzo = lorenzo_trial<T, N>(blocks, lorenzo_conf, trial_cap);
    }

    bool use_interp = !(best_lorenzo >= best_interp * 1.1 && best_lorenzo < 50 && best_interp < 50);
    if (use_interp) {
        conf.cmprAlgo = uint8_t(Algo::INTERP);
        return;
    }
    if (conf.relErrorBound < 1.01e-6 && best_lorenzo > 5 && lorenzo_conf.quantbinCnt != 16384) {
        int32_t saved = lorenzo_conf.quantbinCnt;
        lorenzo_conf.quantbinCnt = 16384;
        ratio = lorenzo_trial<T, N>(blocks, lorenzo_conf, trial_cap);
        if (ratio > best_lorenzo * 1.02) best_lorenzo = ratio;
        else lorenzo_conf.quantbinCnt = saved;
    }
    // setDims here deliberately resets blockSize back to the per-N default
    // (reference SZAlgoInterp.hpp:278 — the trial blockSize=5 does not ship)
    lorenzo_conf.set_dims(std::vector<size_t>(conf.dims.begin(), conf.dims.end()));
    conf = lorenzo_conf;
}

template <class T, int N>
std::vector<uint8_t> compress_interp_lorenzo(Conf& conf, const T* data, size_t cap) {
    tune_interp_lorenzo<T, N>(conf, data);
    if (Algo(conf.cmprAlgo) == Algo::INTERP) return compress_interp<T, N>(conf, data, cap);
    return compress_lorenzo_reg<T, N>(conf, data, cap);
}

// ---- dispatcher (reference SZDispatcher.hpp:13-101) --------------------------

template <class T, int N>
std::vector<uint8_t> compress_dispatch(Conf& conf, const T* data, size_t cap) {
    cal_abs_error_bound(conf, data);
    if (conf.absErrorBound == 0) conf.cmprAlgo = uint8_t(Algo::LOSSLESS);

    std::vector<uint8_t> out;
    bool cap_ok = true;
    if (Algo(conf.cmprAlgo) != Algo::LOSSLESS) {
        try {
            // the four main algorithms never mutate the input here (interp
            // reconstructs into scratch, blockwise pads into scratch, nopred
            // discards reconstructions) — no defensive copy needed, unlike
            // the reference's dataCopy (SZDispatcher.hpp:27)
            switch (Algo(conf.cmprAlgo)) {
                case Algo::LORENZO_REG: out = compress_lorenzo_reg<T, N>(conf, data, cap); break;
                case Algo::INTERP: out = compress_interp<T, N>(conf, data, cap); break;
                case Algo::INTERP_LORENZO: out = compress_interp_lorenzo<T, N>(conf, data, cap); break;
                case Algo::NOPRED: out = compress_nopred<T, N>(conf, data, cap); break;
                // BioMD decompositions DO mutate their input (overwrite with
                // reconstructions) and return directly — no ratio fallback
                // (reference SZDispatcher.hpp:36-39)
                case Algo::BIOMD: {
                    std::vector<T> copy(data, data + conf.num());
                    return compress_biomd<T, N>(conf, copy.data(), cap);
                }
                case Algo::BIOMDXTC: {
                    std::vector<T> copy(data, data + conf.num());
                    return compress_biomdxtc<T, N>(conf, copy.data(), cap);
                }
                default: throw std::runtime_error("unknown compression algorithm");
            }
        } catch (buffer_too_small&) {
            cap_ok = false;
        }
    }
    if (Algo(conf.cmprAlgo) == Algo::LOSSLESS || !cap_ok) {
        conf.cmprAlgo = uint8_t(Algo::LOSSLESS);
        return zstd_pack(reinterpret_cast<const uint8_t*>(data), conf.num() * sizeof(T), cap);
    }
    // lossy ratio < 3: prefer plain zstd when smaller (SZDispatcher.hpp:61-74)
    if (double(conf.num() * sizeof(T)) / double(out.size()) < 3) {
        size_t zcap = ZSTD_compressBound(conf.num() * sizeof(T)) + sizeof(size_t);
        auto z = zstd_pack(reinterpret_cast<const uint8_t*>(data), conf.num() * sizeof(T), zcap);
        if (z.size() < out.size() && z.size() <= cap) {
            conf.cmprAlgo = uint8_t(Algo::LOSSLESS);
            return z;
        }
    }
    return out;
}

template <class T, int N>
void decompress_dispatch(const Conf& conf, const uint8_t* cmp, size_t len, T* out) {
    switch (Algo(conf.cmprAlgo)) {
        case Algo::LOSSLESS: {
            size_t n = zstd_unpack_into(cmp, len, reinterpret_cast<uint8_t*>(out),
                                        conf.num() * sizeof(T));
            if (n != conf.num() * sizeof(T))
                throw std::runtime_error("lossless payload size mismatch");
            break;
        }
        case Algo::LORENZO_REG: decompress_lorenzo_reg<T, N>(conf, cmp, len, out); break;
        case Algo::INTERP: decompress_interp<T, N>(conf, cmp, len, out); break;
        case Algo::NOPRED: decompress_nopred<T, N>(conf, cmp, len, out); break;
        case Algo::BIOMD: decompress_biomd<T, N>(conf, cmp, len, out); break;
        case Algo::BIOMDXTC: decompress_biomdxtc<T, N>(conf, cmp, len, out); break;
        default: throw std::runtime_error("unknown compression algorithm");
    }
}

// ---- chunked parallel mode (OpenMP equivalent) -------------------------------
// Payload: [nChunks i32][Config x n][sizes u64 x n][streams]
// (reference SZImplOMP.hpp:100-107). Each chunk is an independent
// dispatcher-level stream over a dim0 slice.

template <class T, int N>
std::vector<uint8_t> compress_chunked(Conf& conf, const T* data, int nthreads) {
    if (nthreads < 1) nthreads = int(std::thread::hardware_concurrency());
    if (conf.dims[0] < size_t(nthreads)) nthreads = int(conf.dims[0]);

    size_t base = conf.num() / conf.dims[0];
    if (EbMode(conf.errorBoundMode) != EbMode::ABS) {
        // global range all-reduce before chunking (SZImplOMP.hpp:57-68)
        T range = data_range(data, conf.num());
        cal_abs_error_bound(conf, data, range);
    }
    std::vector<Conf> confs(nthreads, conf);
    std::vector<std::vector<uint8_t>> streams(nthreads);
    std::vector<std::thread> threads;
    std::vector<std::exception_ptr> errors(nthreads);
    for (int t = 0; t < nthreads; t++) {
        threads.emplace_back([&, t]() {
            try {
                size_t lo = size_t(t) * conf.dims[0] / nthreads;
                size_t hi = size_t(t + 1) * conf.dims[0] / nthreads;
                std::vector<size_t> dims_t(conf.dims.begin(), conf.dims.end());
                dims_t[0] = hi - lo;
                confs[t].set_dims(dims_t);  // drops size-1 dims like the reference
                // reference cap is ZSTD_compressBound(bytes) (SZImplOMP.hpp:74)
                // which is 8 bytes short of what the dispatcher's own lossless
                // fallback frame needs — the reference std::terminate's on
                // incompressible chunks; headroom makes the fallback viable
                size_t cap = ZSTD_compressBound(confs[t].num() * sizeof(T)) + 4096;
                // chunk may drop to lower N; dispatch on its own rank
                const T* dp = data + lo * base;
                switch (confs[t].N()) {
                    case 1: streams[t] = compress_dispatch<T, 1>(confs[t], dp, cap); break;
                    case 2: streams[t] = compress_dispatch<T, 2>(confs[t], dp, cap); break;
                    case 3: streams[t] = compress_dispatch<T, 3>(confs[t], dp, cap); break;
                    case 4: streams[t] = compress_dispatch<T, 4>(confs[t], dp, cap); break;
                    default: throw std::runtime_error("unsupported chunk dimensionality");
                }
            } catch (...) {
                errors[t] = std::current_exception();
            }
        });
    }
    for (auto& th : threads) th.join();
    for (auto& e : errors)
        if (e) std::rethrow_exception(e);

    Sink out;
    out.put<int32_t>(nthreads);
    for (int t = 0; t < nthreads; t++) confs[t].save(out);
    for (int t = 0; t < nthreads; t++) out.put<size_t>(streams[t].size());
    for (int t = 0; t < nthreads; t++) out.raw(streams[t].data(), streams[t].size());
    return std::move(out.buf);
}

template <class T, int N>
void decompress_chunked(const Conf& conf, const uint8_t* cmp, size_t len, T* out) {
    Source src(cmp, len);
    int nthreads = src.get<int32_t>();
    if (nthreads < 1 || size_t(nthreads) > std::max<size_t>(1, conf.dims[0]))
        throw std::runtime_error("szt: invalid chunk count in archive");
    std::vector<Conf> confs(nthreads);
    for (int t = 0; t < nthreads; t++) confs[t].load(src);
    std::vector<size_t> sizes(nthreads), starts(nthreads + 1, 0);
    for (int t = 0; t < nthreads; t++) sizes[t] = src.get<size_t>();
    for (int t = 0; t < nthreads; t++) {
        if (sizes[t] > src.remaining()) throw std::runtime_error("szt: truncated chunk stream");
        starts[t + 1] = starts[t] + sizes[t];
    }
    if (starts[nthreads] > src.remaining())
        throw std::runtime_error("szt: chunk sizes exceed payload");
    const uint8_t* body = src.cursor();

    size_t base = conf.num() / conf.dims[0];
    for (int t = 0; t < nthreads; t++) {  // each chunk fills its own rows
        size_t lo = size_t(t) * conf.dims[0] / nthreads;
        size_t hi = size_t(t + 1) * conf.dims[0] / nthreads;
        check_count(confs[t].num(), (hi - lo) * base, "chunk element");
    }
    std::vector<std::thread> threads;
    std::vector<std::exception_ptr> errors(nthreads);
    for (int t = 0; t < nthreads; t++) {
        threads.emplace_back([&, t]() {
            try {
                size_t lo = size_t(t) * conf.dims[0] / nthreads;
                T* dp = out + lo * base;
                const uint8_t* p = body + starts[t];
                switch (confs[t].N()) {
                    case 1: decompress_dispatch<T, 1>(confs[t], p, sizes[t], dp); break;
                    case 2: decompress_dispatch<T, 2>(confs[t], p, sizes[t], dp); break;
                    case 3: decompress_dispatch<T, 3>(confs[t], p, sizes[t], dp); break;
                    case 4: decompress_dispatch<T, 4>(confs[t], p, sizes[t], dp); break;
                    default: throw std::runtime_error("unsupported chunk dimensionality");
                }
            } catch (...) {
                errors[t] = std::current_exception();
            }
        });
    }
    for (auto& th : threads) th.join();
    for (auto& e : errors)
        if (e) std::rethrow_exception(e);
}

}  // namespace szt
#endif
