// MDZ/ADP adaptive time-series compressor for molecular-dynamics data
// (ICDE'22; reference tools/mdz/include/mdz.hpp + compressor/specialized/
// SZExaaltCompressor.hpp + decomposition/TimeSeriesDecomposition.hpp).
//
// Methods (reference mdz.hpp:30): VQ(0) level quantization, VQT(1) level
// quantization of frame 0 + previous-timestep prediction, MT(2) previous-
// timestep prediction vs a pinned first frame, LR(3) SZ2-style blockwise
// Lorenzo+regression, TS(4) MT without the pinned frame.
//
// Batch pipeline (reference MDZ_Compress, mdz.hpp:361-465): data is cut into
// timestep batches; the per-batch error bound is re-derived from the batch
// range in REL mode (:415-421); every `method_batch`=50 batches the method is
// re-selected by trial-compressing up to 10 frames with each candidate and
// keeping the smallest stream (select, :216-263); level grid for VQ comes
// from optimal 1D k-means over a sample of frame 0 (KmeansUtil get_cluster).
//
// The reference tool never defines an on-disk container (it only reports
// sizes); this implementation adds a self-describing archive so MDZ streams
// actually round-trip through files:
//   [magic "MDZ1"][u8 dtype][u8 ndim][u64 dims x ndim][u8 eb_mode][f64 eb]
//   [u64 batch_size][i32 quantbinCnt][i32 blockSize][u8 has_ts0]
//   [ts0: u64 zlen + zstd frame]            (present iff any MT batch)
//   [u32 nbatches]
//   per batch: [u8 method][f32 level_start][f32 level_offset][i32 level_num]
//              [f64 absEb][u64 stream_len]
//   [streams...]
// 3D inputs follow the reference's per-axis decomposition (mdz.hpp:467-498):
// ndim==3 archives carry dims[2] nested 2D archives, each length-prefixed.
#ifndef SZT_MDZ_HPP
#define SZT_MDZ_HPP

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

#include "blockwise.hpp"
#include "common.hpp"
#include "huffman.hpp"
#include "kmeans.hpp"
#include "pipeline.hpp"  // seal_payload/open_payload + BlockwiseCodec glue
#include "quantizer.hpp"
#include "zstd_wrap.hpp"

namespace szt {

// ---- VQ/VQT: level-quantization compressor (SZExaaltCompressor) -------------

template <class T>
struct ExaaltCodec {
    LinearQuantizer<T> quant;
    float level_start = 0, level_offset = 1;
    int level_num = 0;  // includes the reference's +200 margin (set_level, :186)
    int timestep_op = 0;
    size_t frames = 1, atoms = 0;

    int quantize_to_level(T v) const { return int(std::round((v - level_start) / level_offset)); }
    T level(int l) const { return T(level_start + l * level_offset); }

    size_t num() const { return frames * atoms; }

    // Mirrors SZExaaltCompressor::compress (:35-117). Stream:
    // [quantizer][huff(quant_inds)][huff(pred_inds)] -> zstd.
    std::vector<uint8_t> compress(T* data, size_t cap) {
        size_t n = num();
        std::vector<int32_t> quant_inds(n), pred_inds(n);
        auto l0 = quantize_to_level(data[0]);
        pred_inds[0] = l0 + level_num;
        quant_inds[0] = quant.quantize(data[0], level(l0));

        if (timestep_op == 0) {
            for (size_t i = 1; i < n; i++) {
                auto l = quantize_to_level(data[i]);
                pred_inds[i] = l - l0 + level_num;
                quant_inds[i] = quant.quantize(data[i], level(l));
                l0 = l;
            }
        } else {
            std::vector<int> levels(atoms);
            levels[0] = l0;
            for (size_t i = 1; i < atoms; i++) {
                levels[i] = quantize_to_level(data[i]);
                pred_inds[i] = levels[i] - levels[i - 1] + level_num;
                quant_inds[i] = quant.quantize(data[i], level(levels[i]));
            }
            size_t pred_idx = atoms;
            if (timestep_op == 1) {
                for (size_t i = 0; i < atoms; i++)
                    for (size_t t = 1; t < frames; t++) {
                        size_t idx = t * atoms + i;
                        quant_inds[pred_idx++] = quant.quantize(data[idx], data[idx - atoms]);
                    }
                pred_inds.resize(atoms);
            } else {
                for (size_t i = 0; i < atoms; i++) {
                    l0 = levels[i];
                    for (size_t t = 1; t < frames; t++) {
                        size_t idx = t * atoms + i;
                        auto l = quantize_to_level(data[idx]);
                        pred_inds[pred_idx] = l - l0 + level_num;
                        quant_inds[pred_idx++] = quant.quantize(data[idx], level(l));
                        l0 = l;
                    }
                }
            }
        }

        Sink inner;
        inner.reserve(n / 2 + 4096);
        quant.save(inner);
        Huffman<int32_t> h1;
        h1.build(quant_inds.data(), quant_inds.size());
        h1.save(inner);
        h1.encode(quant_inds.data(), quant_inds.size(), inner);
        Huffman<int32_t> h2;
        h2.build(pred_inds.data(), pred_inds.size());
        h2.save(inner);
        h2.encode(pred_inds.data(), pred_inds.size(), inner);
        return zstd_pack(inner.buf.data(), inner.buf.size(), cap);
    }

    void decompress(const uint8_t* cmp, size_t len, T* out) {
        auto raw = zstd_unpack(cmp, len);
        Source src(raw.data(), raw.size());
        quant.load(src);
        size_t n = num();
        std::vector<int32_t> quant_inds(n);
        Huffman<int32_t> h1;
        h1.load(src);
        h1.decode(src, n, quant_inds.data());
        size_t pred_n = timestep_op == 1 ? atoms : n;
        std::vector<int32_t> pred_inds(pred_n);
        Huffman<int32_t> h2;
        h2.load(src);
        h2.decode(src, pred_n, pred_inds.data());

        int l = pred_inds[0] - level_num;
        out[0] = quant.recover(level(l), quant_inds[0]);
        if (timestep_op == 0) {
            for (size_t i = 1; i < n; i++) {
                l += pred_inds[i] - level_num;
                out[i] = quant.recover(level(l), quant_inds[i]);
            }
        } else {
            std::vector<int> levels(atoms);
            levels[0] = l;
            for (size_t i = 1; i < atoms; i++) {
                l += pred_inds[i] - level_num;
                out[i] = quant.recover(level(l), quant_inds[i]);
                levels[i] = l;
            }
            size_t pred_idx = atoms;
            if (timestep_op == 1) {
                for (size_t i = 0; i < atoms; i++)
                    for (size_t t = 1; t < frames; t++) {
                        size_t idx = t * atoms + i;
                        out[idx] = quant.recover(out[idx - atoms], quant_inds[pred_idx++]);
                    }
            } else {
                for (size_t i = 0; i < atoms; i++) {
                    l = levels[i];
                    for (size_t t = 1; t < frames; t++) {
                        size_t idx = t * atoms + i;
                        l += pred_inds[pred_idx] - level_num;
                        out[idx] = quant.recover(level(l), quant_inds[pred_idx++]);
                    }
                }
            }
        }
    }
};

// ---- MT/TS: previous-timestep prediction (TimeSeriesDecomposition) ----------

template <class T>
struct TimeSeriesCodec {
    size_t frames = 1, atoms = 0;
    LinearQuantizer<T> quant;
    const T* ts0 = nullptr;  // pinned first frame (MT); null = TS mode

    size_t num() const { return frames * atoms; }

    void compress(T* data, std::vector<int32_t>& bins) {
        bins.resize(num());
        size_t c = 0;
        if (ts0 != nullptr) {
            for (size_t j = 0; j < atoms; j++) bins[c++] = quant.quantize(data[j], ts0[j]);
        } else {
            // spatial frame-0 prediction; the reference composes lorenzo/
            // regression predictors here (TimeSeriesDecomposition.hpp:41-61),
            // reachable only via explicit method=4 — 1D Lorenzo is used
            bins[c++] = quant.quantize(data[0], T(0));
            for (size_t j = 1; j < atoms; j++) bins[c++] = quant.quantize(data[j], data[j - 1]);
        }
        // column-major over time like the reference (:63-69)
        for (size_t j = 0; j < atoms; j++)
            for (size_t i = 1; i < frames; i++) {
                size_t idx = i * atoms + j;
                bins[c++] = quant.quantize(data[idx], data[idx - atoms]);
            }
    }

    void decompress(const std::vector<int32_t>& bins, T* out) {
        size_t c = 0;
        if (ts0 != nullptr) {
            for (size_t j = 0; j < atoms; j++) out[j] = quant.recover(ts0[j], bins[c++]);
        } else {
            out[0] = quant.recover(T(0), bins[c++]);
            for (size_t j = 1; j < atoms; j++) out[j] = quant.recover(out[j - 1], bins[c++]);
        }
        for (size_t j = 0; j < atoms; j++)
            for (size_t i = 1; i < frames; i++) {
                size_t idx = i * atoms + j;
                out[idx] = quant.recover(out[idx - atoms], bins[c++]);
            }
    }

    void save(Sink& s) const { quant.save(s); }
    void load(Source& s) { quant.load(s); }
};

template <class T>
std::vector<uint8_t> mdz_seal_ts(TimeSeriesCodec<T>& codec, const std::vector<int32_t>& bins,
                                 size_t cap) {
    return seal_payload<T>(codec, bins, cap);
}

template <class T>
void mdz_open_ts(TimeSeriesCodec<T>& codec, const uint8_t* cmp, size_t len, T* out) {
    std::vector<int32_t> bins;
    open_payload(codec, cmp, len, bins, codec.frames * codec.atoms);
    codec.decompress(bins, out);
}

// ---- LR: SZ2-style blockwise compressor over the 2D batch -------------------

template <class T>
BlockwiseCodec<T, 2> mdz_lr_codec(size_t frames, size_t atoms, double abs_eb, int quantbin,
                                  int block_size) {
    BlockwiseCodec<T, 2> codec;
    codec.dims = {frames, atoms};
    codec.block_size = block_size;
    codec.use_lorenzo = true;
    codec.use_lorenzo2 = false;
    codec.use_regression = true;
    codec.eb = abs_eb;
    codec.quant = LinearQuantizer<T>(abs_eb, quantbin / 2);
    return codec;
}

template <class T>
std::vector<uint8_t> mdz_lr_compress(size_t frames, size_t atoms, double abs_eb, int quantbin,
                                     int block_size, T* data, size_t cap) {
    auto codec = mdz_lr_codec<T>(frames, atoms, abs_eb, quantbin, block_size);
    std::vector<int32_t> bins(frames * atoms);
    codec.compress(data, bins.data());
    return seal_payload<T>(codec, bins, cap);
}

template <class T>
void mdz_lr_decompress(size_t frames, size_t atoms, int block_size, const uint8_t* cmp, size_t len,
                       T* out) {
    auto codec = mdz_lr_codec<T>(frames, atoms, /*abs_eb=*/1.0, /*quantbin=*/65536, block_size);
    std::vector<int32_t> bins;
    open_payload(codec, cmp, len, bins, frames * atoms);
    codec.decompress(bins.data(), out);
}

// ---- adaptive batch pipeline -------------------------------------------------

struct MdzParams {
    std::vector<size_t> dims;     // 1D/2D/3D logical dims
    uint8_t eb_mode = 0;          // 0 ABS, 1 REL
    double eb = 1e-3;             // user bound (mode-dependent)
    size_t batch_size = 0;        // 0 = whole series in one batch
    int32_t quantbin = 1024;      // reference mdz.cpp:58
    int32_t block_size = 128;     // reference mdz.cpp:57
    int method = -1;              // -1 = adaptive re-selection every 50 batches
};

namespace detail {

struct BatchRec {
    uint8_t method;
    float level_start, level_offset;
    int32_t level_num;  // WITHOUT the +200 margin; re-added at codec setup
    double abs_eb;
    std::vector<uint8_t> stream;
};

template <class T>
std::vector<uint8_t> mdz_run_method(int method, size_t frames, size_t atoms, double abs_eb,
                                    const MdzParams& p, float ls, float lo, int ln, const T* ts0,
                                    T* data, size_t cap) {
    if (method == 0 || method == 1) {
        if (ln == 0) throw std::runtime_error("VQ/VQT not available: no level grid detected");
        ExaaltCodec<T> c;
        c.quant = LinearQuantizer<T>(abs_eb, p.quantbin / 2);
        c.level_start = ls;
        c.level_offset = lo;
        c.level_num = ln + 200;  // reference set_level margin (:186)
        c.timestep_op = method;
        c.frames = frames;
        c.atoms = atoms;
        return c.compress(data, cap);
    }
    if (method == 2 || method == 4) {
        TimeSeriesCodec<T> c;
        c.frames = frames;
        c.atoms = atoms;
        c.quant = LinearQuantizer<T>(abs_eb, p.quantbin / 2);
        c.ts0 = method == 2 ? ts0 : nullptr;
        std::vector<int32_t> bins;
        c.compress(data, bins);
        return mdz_seal_ts(c, bins, cap);
    }
    return mdz_lr_compress<T>(frames, atoms, abs_eb, p.quantbin, p.block_size, data, cap);
}

// ---- LAMMPS in-situ hooks (reference tools/mdz/include/mdz.hpp:283-359) ----
// Per-batch entry points for an MD engine writing snapshots as they are
// produced: compress one (frames x atoms) batch with an explicit method, and
// re-select the method by trial-compressing a sample of the batch.

template <class T>
std::vector<uint8_t> lammps_compress(size_t frames, size_t atoms, double abs_eb, int quantbin,
                                     int block_size, int method, float ls, float lo, int ln,
                                     const T* ts0, const T* data) {
    if ((method == 0 || method == 1) && ln == 0)
        throw std::runtime_error("VQ/VQT not available on current dataset, please use ADP or MT");
    MdzParams p;
    p.quantbin = quantbin;
    p.block_size = block_size;
    size_t n = frames * atoms;
    std::vector<T> buf(data, data + n);  // methods overwrite their input
    return mdz_run_method<T>(method, frames, atoms, abs_eb, p, ls, lo, ln, ts0, buf.data(),
                             2 * n * sizeof(T) + 4096);
}

template <class T>
void lammps_decompress(size_t frames, size_t atoms, double abs_eb, int quantbin, int block_size,
                       int method, float ls, float lo, int ln, const T* ts0, const uint8_t* cmp,
                       size_t len, T* out) {
    if (method == 0 || method == 1) {
        ExaaltCodec<T> c;
        c.quant = LinearQuantizer<T>(abs_eb, quantbin / 2);
        c.level_start = ls;
        c.level_offset = lo;
        c.level_num = ln + 200;
        c.timestep_op = method;
        c.frames = frames;
        c.atoms = atoms;
        c.decompress(cmp, len, out);
    } else if (method == 2 || method == 4) {
        TimeSeriesCodec<T> c;
        c.frames = frames;
        c.atoms = atoms;
        c.quant = LinearQuantizer<T>(abs_eb, quantbin / 2);
        c.ts0 = method == 2 ? ts0 : nullptr;
        mdz_open_ts(c, cmp, len, out);
    } else {
        mdz_lr_decompress<T>(frames, atoms, block_size, cmp, len, out);
    }
}

// Reference LAMMPS_select_compressor (:311-359): on the first call skip the
// equilibration half of the batch; clamp the trial to 10 frames; candidates
// are {VQ, VQT} when a level grid exists else {LR}, always plus {MT}.
template <class T>
int lammps_select_compressor(size_t frames, size_t atoms, double abs_eb, int quantbin,
                             int block_size, bool firsttime, float ls, float lo, int ln,
                             const T* ts0, const T* data) {
    const T* base = data;
    size_t f = frames;
    if (firsttime) {
        f = frames / 2;
        base = data + f * atoms;
    }
    if (f > 10) f = 10;
    size_t n = f * atoms;
    size_t cap = 2 * n * sizeof(T) + 4096;
    MdzParams p;
    p.quantbin = quantbin;
    p.block_size = block_size;
    std::vector<size_t> sizes(10, std::numeric_limits<size_t>::max());
    std::vector<T> buf(n);
    auto trial = [&](int m) {
        std::copy(base, base + n, buf.begin());
        try {
            sizes[size_t(m)] =
                mdz_run_method<T>(m, f, atoms, abs_eb, p, ls, lo, ln, ts0, buf.data(), cap).size();
        } catch (...) {
        }
    };
    if (ln > 0) {
        trial(0);
        trial(1);
    } else {
        trial(3);
    }
    trial(2);
    return int(std::min_element(sizes.begin(), sizes.end()) - sizes.begin());
}

// trial-compress candidates on up to 10 frames, keep the smallest
// (reference select, mdz.hpp:216-263)
template <class T>
int mdz_select(size_t ts, size_t batch_frames, size_t atoms, double abs_eb, const MdzParams& p,
               float ls, float lo, int ln, const T* ts0, const T* all_data, size_t total_frames) {
    size_t t = ts;
    size_t frames = batch_frames;
    if (ts == 0) {
        if (batch_frames == 1) return ln > 0 ? 0 : 3;
        t = batch_frames / 2;
        frames = batch_frames / 2;
    }
    if (p.batch_size > 10 || (p.batch_size == 0 && frames > 10)) frames = std::min<size_t>(frames, 10);
    frames = std::min(frames, total_frames - t);
    size_t n = frames * atoms;
    size_t cap = 2 * n * sizeof(T) + 4096;
    std::vector<size_t> sizes(5, std::numeric_limits<size_t>::max());
    std::vector<T> buf(n);
    auto trial = [&](int m) {
        std::copy(all_data + t * atoms, all_data + t * atoms + n, buf.begin());
        try {
            sizes[m] = mdz_run_method<T>(m, frames, atoms, abs_eb, p, ls, lo, ln, ts0,
                                         buf.data(), cap).size();
        } catch (...) {
        }
    };
    if (ln > 0) {
        trial(0);
        trial(1);
    } else {
        trial(3);
    }
    trial(2);
    return int(std::min_element(sizes.begin(), sizes.end()) - sizes.begin());
}

}  // namespace detail

// 2D (frames, atoms) adaptive compress (reference MDZ_Compress, mdz.hpp:361-465)
template <class T>
std::vector<uint8_t> mdz_compress_2d(const MdzParams& p, const T* input) {
    size_t total_frames = p.dims.size() == 2 ? p.dims[0] : 1;
    size_t atoms = p.dims.back();
    size_t batch = p.batch_size ? p.batch_size : total_frames;
    int method_batch = p.method == -1 ? 50 : 0;

    std::vector<T> ts0(input, input + atoms);

    float level_start = 0, level_offset = 1;
    int level_num = 0;
    if (p.method != 2 && p.method != 3 && p.method != 4) {
        size_t sample_num = size_t(0.1 * double(atoms));
        sample_num = std::min(sample_num, size_t(20000));
        sample_num = std::max(sample_num, std::min(size_t(5000), atoms));
        get_cluster(input, atoms, level_start, level_offset, level_num, sample_num);
        if (level_num > double(atoms) * 0.25) level_num = 0;
    }

    int current = p.method;
    bool used_mt = false;
    std::vector<detail::BatchRec> recs;
    std::vector<T> work;
    for (size_t ts = 0; ts < total_frames; ts += batch) {
        size_t frames = std::min(batch, total_frames - ts);
        size_t n = frames * atoms;
        const T* data = input + ts * atoms;

        double abs_eb = p.eb;
        T mx = *std::max_element(data, data + n);
        T mn = *std::min_element(data, data + n);
        if (p.eb_mode == 1) abs_eb = p.eb * double(mx - mn);  // REL per batch (:419-420)
        // constant batches (fill/padded frames) give a zero range -> zero eb,
        // which is UB in the quantizer (the reference has the same hole);
        // any positive bound is exact on constant data
        if (!(abs_eb > 0)) abs_eb = 1.0;

        if (method_batch > 0 && (ts / batch) % method_batch == 0) {
            current = detail::mdz_select<T>(ts, frames, atoms, abs_eb, p, level_start,
                                            level_offset, level_num, ts0.data(), input,
                                            total_frames);
        }
        if (current == 2) used_mt = true;

        work.assign(data, data + n);
        size_t cap = 2 * n * sizeof(T) + 4096;
        detail::BatchRec r;
        r.method = uint8_t(current);
        r.level_start = level_start;
        r.level_offset = level_offset;
        r.level_num = level_num;
        r.abs_eb = abs_eb;
        r.stream = detail::mdz_run_method<T>(current, frames, atoms, abs_eb, p, level_start,
                                             level_offset, level_num, ts0.data(), work.data(), cap);
        recs.push_back(std::move(r));
    }

    Sink out;
    out.raw("MDZ1", 4);
    out.put<uint8_t>(sizeof(T) == 4 ? 0 : 1);
    out.put<uint8_t>(uint8_t(p.dims.size()));
    for (auto d : p.dims) out.put<uint64_t>(d);
    out.put<uint8_t>(p.eb_mode);
    out.put<double>(p.eb);
    out.put<uint64_t>(batch);
    out.put<int32_t>(p.quantbin);
    out.put<int32_t>(p.block_size);  // LR batches need it to re-grid on decode
    out.put<uint8_t>(used_mt ? 1 : 0);
    if (used_mt) {
        auto z = zstd_pack(reinterpret_cast<const uint8_t*>(ts0.data()), atoms * sizeof(T),
                           ZSTD_compressBound(atoms * sizeof(T)) + 16);
        out.put<uint64_t>(z.size());
        out.raw(z.data(), z.size());
    }
    out.put<uint32_t>(uint32_t(recs.size()));
    for (auto& r : recs) {
        out.put<uint8_t>(r.method);
        out.put<float>(r.level_start);
        out.put<float>(r.level_offset);
        out.put<int32_t>(r.level_num);
        out.put<double>(r.abs_eb);
        out.put<uint64_t>(r.stream.size());
    }
    for (auto& r : recs) out.raw(r.stream.data(), r.stream.size());
    return std::move(out.buf);
}

template <class T>
void mdz_decompress_2d(Source& src, const std::vector<size_t>& dims, size_t batch,
                       int32_t block_size, T* out) {
    size_t total_frames = dims.size() == 2 ? dims[0] : 1;
    size_t atoms = dims.back();
    uint8_t has_ts0 = src.get<uint8_t>();
    std::vector<T> ts0;
    if (has_ts0) {
        uint64_t zlen = src.get<uint64_t>();
        if (zlen > src.remaining()) throw std::runtime_error("mdz: truncated first frame");
        auto raw = zstd_unpack(src.cursor(), zlen);
        src.advance(zlen);
        ts0.resize(atoms);
        if (raw.size() != atoms * sizeof(T)) throw std::runtime_error("mdz: bad ts0 payload");
        std::memcpy(ts0.data(), raw.data(), raw.size());
    }
    uint32_t nbatches = src.get<uint32_t>();
    struct Rec {
        uint8_t method;
        float ls, lo;
        int32_t ln;
        double abs_eb;
        uint64_t len;
    };
    std::vector<Rec> recs(nbatches);
    for (auto& r : recs) {
        r.method = src.get<uint8_t>();
        r.ls = src.get<float>();
        r.lo = src.get<float>();
        r.ln = src.get<int32_t>();
        r.abs_eb = src.get<double>();
        r.len = src.get<uint64_t>();
    }
    size_t ts = 0;
    for (auto& r : recs) {
        if (ts >= total_frames) throw std::runtime_error("mdz: batches past the last frame");
        size_t frames = std::min(batch ? batch : total_frames, total_frames - ts);
        T* dst = out + ts * atoms;
        if (r.len > src.remaining()) throw std::runtime_error("mdz: truncated batch");
        const uint8_t* stream = src.cursor();
        if (r.method == 0 || r.method == 1) {
            ExaaltCodec<T> c;
            c.level_start = r.ls;
            c.level_offset = r.lo;
            c.level_num = r.ln + 200;
            c.timestep_op = r.method;
            c.frames = frames;
            c.atoms = atoms;
            c.decompress(stream, size_t(r.len), dst);
        } else if (r.method == 2 || r.method == 4) {
            TimeSeriesCodec<T> c;
            c.frames = frames;
            c.atoms = atoms;
            c.ts0 = r.method == 2 ? ts0.data() : nullptr;
            mdz_open_ts(c, stream, size_t(r.len), dst);
        } else {
            mdz_lr_decompress<T>(frames, atoms, block_size, stream, size_t(r.len), dst);
        }
        src.advance(size_t(r.len));
        ts += frames;
    }
    if (ts != total_frames) throw std::runtime_error("mdz: batches short of the frames");
}

// Entry points handling 1D/2D directly and 3D per-axis (mdz.hpp:467-498).
template <class T>
std::vector<uint8_t> mdz_compress(const MdzParams& p, const T* input) {
    if (p.dims.size() <= 2) return mdz_compress_2d(p, input);
    // (frames, atoms, xyz) -> xyz separate (frames, atoms) series
    size_t F = p.dims[0], A = p.dims[1], X = p.dims[2];
    std::vector<T> tr(F * A);
    Sink out;
    out.raw("MDZ3", 4);
    out.put<uint8_t>(sizeof(T) == 4 ? 0 : 1);
    for (auto d : p.dims) out.put<uint64_t>(d);
    for (size_t x = 0; x < X; x++) {
        for (size_t f = 0; f < F; f++)
            for (size_t a = 0; a < A; a++) tr[f * A + a] = input[f * A * X + a * X + x];
        MdzParams p2 = p;
        p2.dims = {F, A};
        auto sub = mdz_compress_2d(p2, tr.data());
        out.put<uint64_t>(sub.size());
        out.raw(sub.data(), sub.size());
    }
    return std::move(out.buf);
}

struct MdzHeader {
    uint8_t dtype;
    std::vector<size_t> dims;
};

inline MdzHeader mdz_peek(const uint8_t* blob, size_t len) {
    Source src(blob, len);
    char magic[4];
    src.raw(magic, 4);
    MdzHeader h;
    h.dtype = src.get<uint8_t>();
    if (std::memcmp(magic, "MDZ3", 4) == 0) {
        h.dims.resize(3);
        for (auto& d : h.dims) d = src.get<uint64_t>();
    } else if (std::memcmp(magic, "MDZ1", 4) == 0) {
        uint8_t nd = src.get<uint8_t>();
        if (nd < 1 || nd > 2) throw std::runtime_error("mdz: bad rank");
        h.dims.resize(nd);
        for (auto& d : h.dims) d = src.get<uint64_t>();
    } else {
        throw std::runtime_error("not an MDZ archive");
    }
    return h;
}

template <class T>
void mdz_decompress(const uint8_t* blob, size_t len, T* out) {
    Source src(blob, len);
    char magic[4];
    src.raw(magic, 4);
    if (std::memcmp(magic, "MDZ3", 4) == 0) {
        src.get<uint8_t>();  // dtype
        size_t F = src.get<uint64_t>(), A = src.get<uint64_t>(), X = src.get<uint64_t>();
        std::vector<T> tr;
        const std::vector<size_t> series{F, A};
        for (size_t x = 0; x < X; x++) {
            uint64_t sublen = src.get<uint64_t>();
            if (sublen > src.remaining()) throw std::runtime_error("mdz: truncated series");
            if (mdz_peek(src.cursor(), size_t(sublen)).dims != series)
                throw std::runtime_error("mdz: a series' dims differ from the archive's");
            tr.resize(F * A);  // sized once a series has agreed with the header
            mdz_decompress<T>(src.cursor(), size_t(sublen), tr.data());
            src.advance(size_t(sublen));
            for (size_t f = 0; f < F; f++)
                for (size_t a = 0; a < A; a++) out[f * A * X + a * X + x] = tr[f * A + a];
        }
        return;
    }
    if (std::memcmp(magic, "MDZ1", 4) != 0) throw std::runtime_error("not an MDZ archive");
    src.get<uint8_t>();  // dtype
    uint8_t nd = src.get<uint8_t>();
    std::vector<size_t> dims(nd);
    for (auto& d : dims) d = src.get<uint64_t>();
    src.get<uint8_t>();  // eb_mode
    src.get<double>();   // eb
    uint64_t batch = src.get<uint64_t>();
    int32_t quantbin = src.get<int32_t>();
    int32_t block_size = src.get<int32_t>();
    (void)quantbin;  // per-batch quantizer state rides each stream
    mdz_decompress_2d<T>(src, dims, size_t(batch), block_size, out);
}

}  // namespace szt
#endif
