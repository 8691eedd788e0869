// C ABI for the szt native engine. Python binds this with ctypes
// (sz3_tpu/runtime.py). All heavy host-side work lives behind these calls:
// full payload compress/decompress (any algorithm, serial or chunked),
// plus low-level Huffman/zstd entry points for the JAX device path.
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <vector>

#include "szt/bridge.hpp"
#include "szt/container.hpp"
#include "szt/encoders_extra.hpp"
#include "szt/mdz.hpp"
#include "szt/pipeline.hpp"

using namespace szt;

extern "C" {

// Mirrors sz3_tpu.config.Config; field-for-field ctypes struct.
struct SztConf {
    uint64_t dims[4];
    int32_t n_dims;
    uint8_t cmprAlgo;
    uint8_t errorBoundMode;
    uint8_t dataType;
    double absErrorBound;
    double relErrorBound;
    double psnrErrorBound;
    double l2normErrorBound;
    int32_t quantbinCnt;
    int32_t blockSize;
    uint8_t predDim;
    uint8_t lorenzo, lorenzo2, regression, regression2, openmp;
    uint8_t interpAlgo;
    int32_t interpDirection;
    int64_t interpAnchorStride;
    double interpAlpha;
    double interpBeta;
    int32_t nthreads;  // chunked mode thread count; <=0 = hardware default
    // dtype used for engine dispatch. Kept separate from `dataType` because
    // the archived config byte is caller-controlled: the reference CLI leaves
    // it at SZ_FLOAT even for double data (tools/sz3/sz3.cpp:196,278-290) and
    // byte parity requires reproducing that.
    uint8_t engineType;
};

}  // extern "C"

namespace {

Conf to_conf(const SztConf* c) {
    Conf k;
    k.dims.assign(c->dims, c->dims + c->n_dims);
    k.cmprAlgo = c->cmprAlgo;
    k.errorBoundMode = c->errorBoundMode;
    k.dataType = c->dataType;
    k.absErrorBound = c->absErrorBound;
    k.relErrorBound = c->relErrorBound;
    k.psnrErrorBound = c->psnrErrorBound;
    k.l2normErrorBound = c->l2normErrorBound;
    k.quantbinCnt = c->quantbinCnt;
    k.blockSize = c->blockSize;
    k.predDim = c->predDim;
    k.lorenzo = c->lorenzo;
    k.lorenzo2 = c->lorenzo2;
    k.regression = c->regression;
    k.regression2 = c->regression2;
    k.openmp = c->openmp;
    k.interpAlgo = c->interpAlgo;
    k.interpDirection = c->interpDirection;
    k.interpAnchorStride = c->interpAnchorStride;
    k.interpAlpha = c->interpAlpha;
    k.interpBeta = c->interpBeta;
    return k;
}

void from_conf(const Conf& k, SztConf* c) {
    c->n_dims = k.N();
    for (int i = 0; i < k.N(); i++) c->dims[i] = k.dims[i];
    c->cmprAlgo = k.cmprAlgo;
    c->errorBoundMode = k.errorBoundMode;
    c->dataType = k.dataType;
    c->absErrorBound = k.absErrorBound;
    c->relErrorBound = k.relErrorBound;
    c->psnrErrorBound = k.psnrErrorBound;
    c->l2normErrorBound = k.l2normErrorBound;
    c->quantbinCnt = k.quantbinCnt;
    c->blockSize = k.blockSize;
    c->predDim = k.predDim;
    c->lorenzo = k.lorenzo;
    c->lorenzo2 = k.lorenzo2;
    c->regression = k.regression;
    c->regression2 = k.regression2;
    c->openmp = k.openmp;
    c->interpAlgo = k.interpAlgo;
    c->interpDirection = k.interpDirection;
    c->interpAnchorStride = k.interpAnchorStride;
    c->interpAlpha = k.interpAlpha;
    c->interpBeta = k.interpBeta;
}

uint8_t* to_malloc(const std::vector<uint8_t>& v, uint64_t* len) {
    uint8_t* p = static_cast<uint8_t*>(std::malloc(v.size() ? v.size() : 1));
    if (!p) throw std::bad_alloc();
    std::memcpy(p, v.data(), v.size());
    *len = v.size();
    return p;
}

int fail(const std::exception& e, char* err, uint64_t errcap) {
    if (err && errcap) {
        size_t n = std::min(std::strlen(e.what()), size_t(errcap - 1));
        std::memcpy(err, e.what(), n);
        err[n] = 0;
    }
    return -1;
}

template <class T>
std::vector<uint8_t> compress_typed(Conf& conf, const T* data, size_t cap, int nthreads) {
    if (conf.openmp) {
        return compress_chunked<T, 4>(conf, data, nthreads);
    }
    switch (conf.N()) {
        case 1: return compress_dispatch<T, 1>(conf, data, cap);
        case 2: return compress_dispatch<T, 2>(conf, data, cap);
        case 3: return compress_dispatch<T, 3>(conf, data, cap);
        case 4: return compress_dispatch<T, 4>(conf, data, cap);
        default: throw std::runtime_error("unsupported dimensionality");
    }
}

template <class T>
void decompress_typed(const Conf& conf, const uint8_t* cmp, size_t len, T* out) {
    if (conf.openmp) {
        decompress_chunked<T, 4>(conf, cmp, len, out);
        return;
    }
    switch (conf.N()) {
        case 1: decompress_dispatch<T, 1>(conf, cmp, len, out); break;
        case 2: decompress_dispatch<T, 2>(conf, cmp, len, out); break;
        case 3: decompress_dispatch<T, 3>(conf, cmp, len, out); break;
        case 4: decompress_dispatch<T, 4>(conf, cmp, len, out); break;
        default: throw std::runtime_error("unsupported dimensionality");
    }
}

// Invoke f with a typed null pointer for the archive dtype id
// (SZ_FLOAT=0 .. SZ_INT64=9; reference utils/Config.hpp:27-36).
template <class F>
void with_dtype(uint8_t dtype_id, F&& f) {
    switch (dtype_id) {
        case 0: f(static_cast<float*>(nullptr)); break;
        case 1: f(static_cast<double*>(nullptr)); break;
        case 2: f(static_cast<uint8_t*>(nullptr)); break;
        case 3: f(static_cast<int8_t*>(nullptr)); break;
        case 4: f(static_cast<uint16_t*>(nullptr)); break;
        case 5: f(static_cast<int16_t*>(nullptr)); break;
        case 6: f(static_cast<uint32_t*>(nullptr)); break;
        case 7: f(static_cast<int32_t*>(nullptr)); break;
        case 8: f(static_cast<uint64_t*>(nullptr)); break;
        case 9: f(static_cast<int64_t*>(nullptr)); break;
        default: throw std::runtime_error("unsupported dtype");
    }
}

}  // namespace

extern "C" {

void szt_free(void* p) { std::free(p); }

int szt_compress(SztConf* conf, const void* data, uint64_t cap, uint8_t** out, uint64_t* out_len,
                 char* err, uint64_t errcap) {
    try {
        Conf k = to_conf(conf);
        std::vector<uint8_t> payload;
        with_dtype(conf->engineType, [&](auto* tp) {
            using T = std::remove_pointer_t<decltype(tp)>;
            payload = compress_typed<T>(k, static_cast<const T*>(data), cap, conf->nthreads);
        });
        from_conf(k, conf);
        *out = to_malloc(payload, out_len);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

int szt_decompress(const SztConf* conf, const uint8_t* cmp, uint64_t len, void* out, char* err,
                   uint64_t errcap) {
    try {
        Conf k = to_conf(conf);
        with_dtype(conf->engineType, [&](auto* tp) {
            using T = std::remove_pointer_t<decltype(tp)>;
            decompress_typed<T>(k, cmp, len, static_cast<T*>(out));
        });
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

// ---- low-level hooks (JAX device path + unit tests) -------------------------

// [tree][count u64][bitstream]
int szt_huff_encode(const int32_t* bins, uint64_t n, uint8_t** out, uint64_t* out_len, char* err,
                    uint64_t errcap) {
    try {
        Huffman<int32_t> h;
        h.build(bins, n);
        Sink s;
        h.save(s);
        s.put<size_t>(size_t(n));
        h.encode(bins, n, s);
        *out = to_malloc(s.buf, out_len);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

int szt_huff_decode(const uint8_t* buf, uint64_t len, int32_t* out, uint64_t* out_n, char* err,
                    uint64_t errcap) {
    try {
        Source s(buf, len);
        Huffman<int32_t> h;
        h.load(s);
        size_t n = s.get<size_t>();
        if (*out_n < n) throw std::runtime_error("decode output buffer too small");
        h.decode(s, n, out);
        *out_n = n;
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

int szt_zstd_compress(const uint8_t* src, uint64_t n, uint8_t** out, uint64_t* out_len, char* err,
                      uint64_t errcap) {
    try {
        auto v = zstd_pack(src, n, ZSTD_compressBound(n) + sizeof(size_t));
        *out = to_malloc(v, out_len);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

int szt_zstd_decompress(const uint8_t* src, uint64_t n, uint8_t** out, uint64_t* out_len,
                        char* err, uint64_t errcap) {
    try {
        auto v = zstd_unpack(src, n);
        *out = to_malloc(v, out_len);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

// ---- device (JAX) path bridge ------------------------------------------------

#define SZT_DISPATCH_N(fn, T, ...)                                                    \
    do {                                                                              \
        switch (k.N()) {                                                              \
            case 1: fn<T, 1>(__VA_ARGS__); break;                                     \
            case 2: fn<T, 2>(__VA_ARGS__); break;                                     \
            case 3: fn<T, 3>(__VA_ARGS__); break;                                     \
            case 4: fn<T, 4>(__VA_ARGS__); break;                                     \
            default: throw std::runtime_error("unsupported dimensionality");          \
        }                                                                             \
    } while (0)

// grid bins + original data -> stream (caller buffer, num entries) + unpred
// literal bytes (malloc'd)
int szt_interp_emit(const SztConf* conf, const int32_t* bins, const void* orig, int32_t* stream,
                    uint8_t** unpred_out, uint64_t* unpred_bytes, char* err, uint64_t errcap) {
    try {
        Conf k = to_conf(conf);
        default_anchor_stride(k);
        switch (conf->engineType) {
            case 0: {
                std::vector<float> up;
                SZT_DISPATCH_N(interp_emit, float, k, bins, static_cast<const float*>(orig), stream, up);
                std::vector<uint8_t> raw(reinterpret_cast<uint8_t*>(up.data()),
                                         reinterpret_cast<uint8_t*>(up.data() + up.size()));
                *unpred_out = to_malloc(raw, unpred_bytes);
                break;
            }
            case 1: {
                std::vector<double> up;
                SZT_DISPATCH_N(interp_emit, double, k, bins, static_cast<const double*>(orig), stream, up);
                std::vector<uint8_t> raw(reinterpret_cast<uint8_t*>(up.data()),
                                         reinterpret_cast<uint8_t*>(up.data() + up.size()));
                *unpred_out = to_malloc(raw, unpred_bytes);
                break;
            }
            default: throw std::runtime_error("unsupported dtype for device path");
        }
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

int szt_interp_place(const SztConf* conf, const int32_t* stream, const void* unpred,
                     int32_t* bins_grid, void* literal_grid, char* err, uint64_t errcap) {
    try {
        Conf k = to_conf(conf);
        default_anchor_stride(k);  // keep emit/place traversals in lockstep
        switch (conf->engineType) {
            case 0:
                SZT_DISPATCH_N(interp_place, float, k, stream, static_cast<const float*>(unpred),
                               bins_grid, static_cast<float*>(literal_grid));
                break;
            case 1:
                SZT_DISPATCH_N(interp_place, double, k, stream, static_cast<const double*>(unpred),
                               bins_grid, static_cast<double*>(literal_grid));
                break;
            default: throw std::runtime_error("unsupported dtype for device path");
        }
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

int szt_interp_seal(SztConf* conf, const int32_t* stream, uint64_t n, const void* unpred,
                    uint64_t unpred_n, uint64_t cap, uint8_t** out, uint64_t* out_len, char* err,
                    uint64_t errcap) {
    try {
        Conf k = to_conf(conf);
        std::vector<uint8_t> payload;
        auto seal = [&](auto* tp) {
            using T = std::remove_pointer_t<decltype(tp)>;
            switch (k.N()) {
                case 1: payload = interp_seal<T, 1>(k, stream, n, static_cast<const T*>(unpred), unpred_n, cap); break;
                case 2: payload = interp_seal<T, 2>(k, stream, n, static_cast<const T*>(unpred), unpred_n, cap); break;
                case 3: payload = interp_seal<T, 3>(k, stream, n, static_cast<const T*>(unpred), unpred_n, cap); break;
                case 4: payload = interp_seal<T, 4>(k, stream, n, static_cast<const T*>(unpred), unpred_n, cap); break;
                default: throw std::runtime_error("unsupported dimensionality");
            }
        };
        if (conf->engineType == 0) seal(static_cast<float*>(nullptr));
        else if (conf->engineType == 1) seal(static_cast<double*>(nullptr));
        else throw std::runtime_error("unsupported dtype for device path");
        from_conf(k, conf);
        *out = to_malloc(payload, out_len);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

// payload -> stream (caller buffer, conf.num entries) + unpred bytes
// (malloc'd); effective params written back into conf
int szt_interp_open(SztConf* conf, const uint8_t* payload, uint64_t len, int32_t* stream,
                    uint8_t** unpred_out, uint64_t* unpred_bytes, char* err, uint64_t errcap) {
    try {
        Conf k = to_conf(conf);
        std::vector<int32_t> sv;
        auto open = [&](auto* tp) {
            using T = std::remove_pointer_t<decltype(tp)>;
            std::vector<T> up;
            switch (k.N()) {
                case 1: interp_open<T, 1>(k, payload, len, sv, up); break;
                case 2: interp_open<T, 2>(k, payload, len, sv, up); break;
                case 3: interp_open<T, 3>(k, payload, len, sv, up); break;
                case 4: interp_open<T, 4>(k, payload, len, sv, up); break;
                default: throw std::runtime_error("unsupported dimensionality");
            }
            std::vector<uint8_t> raw(reinterpret_cast<uint8_t*>(up.data()),
                                     reinterpret_cast<uint8_t*>(up.data() + up.size()));
            *unpred_out = to_malloc(raw, unpred_bytes);
        };
        if (conf->engineType == 0) open(static_cast<float*>(nullptr));
        else if (conf->engineType == 1) open(static_cast<double*>(nullptr));
        else throw std::runtime_error("unsupported dtype for device path");
        std::memcpy(stream, sv.data(), sv.size() * sizeof(int32_t));
        from_conf(k, conf);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

// stream-order permutation: order[i] = flat grid index of archive stream
// slot i (caller buffer of conf.num() int64 entries)
int szt_interp_order(const SztConf* conf, int64_t* order, char* err, uint64_t errcap) {
    try {
        Conf k = to_conf(conf);
        default_anchor_stride(k);
        switch (k.N()) {
            case 1: interp_order<1>(k, order); break;
            case 2: interp_order<2>(k, order); break;
            case 3: interp_order<3>(k, order); break;
            case 4: interp_order<4>(k, order); break;
            default: throw std::runtime_error("unsupported dimensionality");
        }
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

// run only the INTERP_LORENZO tuner decision; conf is rewritten to the chosen
// algorithm + params (reference SZAlgoInterp.hpp:122-286)
int szt_tune_interp(SztConf* conf, const void* data, char* err, uint64_t errcap) {
    try {
        Conf k = to_conf(conf);
        switch (conf->engineType) {
            case 0: SZT_DISPATCH_N(tune_interp_lorenzo, float, k, static_cast<const float*>(data)); break;
            case 1: SZT_DISPATCH_N(tune_interp_lorenzo, double, k, static_cast<const double*>(data)); break;
            case 7: SZT_DISPATCH_N(tune_interp_lorenzo, int32_t, k, static_cast<const int32_t*>(data)); break;
            case 9: SZT_DISPATCH_N(tune_interp_lorenzo, int64_t, k, static_cast<const int64_t*>(data)); break;
            default: throw std::runtime_error("unsupported dtype");
        }
        from_conf(k, conf);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

int szt_abi_version(void) { return 1; }

// ---- SZ2-compatible C API (reference tools/sz3c/{include/sz3c.h,src/sz3c.cpp})

// SZ2 errorbound-mode codes (sz3c.h:10-16) — NOT the SZ3 EB enum
enum { kSz2Abs = 0, kSz2Rel = 1, kSz2AbsAndRel = 2, kSz2AbsOrRel = 3, kSz2Psnr = 4, kSz2Norm = 5 };
// SZ2 dtype codes (sz3c.h:25-36)
enum { kSz2Float = 0, kSz2Double = 1 };

// Drop-in for the reference `SZ_compress_args` (sz3c.cpp:11-62): full
// self-describing archive in a malloc'd buffer. r5 is folded into r4
// (sz3c.cpp:24); zero-valued trailing dims select the rank.
unsigned char* SZ_compress_args(int dataType, void* data, size_t* outSize, int errBoundMode,
                                double absErrBound, double relBoundRatio, double pwrBoundRatio,
                                size_t r5, size_t r4, size_t r3, size_t r2, size_t r1) {
    (void)pwrBoundRatio;  // point-wise relative is unsupported, like the reference
    try {
        Conf conf;
        std::vector<size_t> dims;
        if (r2 == 0) dims = {r1};
        else if (r3 == 0) dims = {r2, r1};
        else if (r4 == 0) dims = {r3, r2, r1};
        else if (r5 == 0) dims = {r4, r3, r2, r1};
        else dims = {r5 * r4, r3, r2, r1};
        conf.set_dims(dims);
        conf.absErrorBound = absErrBound;
        conf.relErrorBound = relBoundRatio;
        switch (errBoundMode) {
            case kSz2Abs: conf.errorBoundMode = uint8_t(EbMode::ABS); break;
            case kSz2Rel: conf.errorBoundMode = uint8_t(EbMode::REL); break;
            case kSz2AbsAndRel: conf.errorBoundMode = uint8_t(EbMode::ABS_AND_REL); break;
            case kSz2AbsOrRel: conf.errorBoundMode = uint8_t(EbMode::ABS_OR_REL); break;
            default: return nullptr;  // unsupported SZ2 mode
        }
        std::vector<uint8_t> blob;
        if (dataType == kSz2Float) {
            blob = container_compress<float>(conf, static_cast<const float*>(data));
        } else if (dataType == kSz2Double) {
            blob = container_compress<double>(conf, static_cast<const double*>(data));
        } else {
            return nullptr;
        }
        auto* out = static_cast<unsigned char*>(std::malloc(blob.size()));
        if (!out) return nullptr;
        std::memcpy(out, blob.data(), blob.size());
        *outSize = blob.size();
        return out;
    } catch (...) {
        return nullptr;
    }
}

// Drop-in for the reference `SZ_decompress` (sz3c.cpp:64-93).
void* SZ_decompress(int dataType, unsigned char* bytes, size_t byteLength, size_t r5, size_t r4,
                    size_t r3, size_t r2, size_t r1) {
    try {
        size_t n = r1;
        if (r2) n *= r2;
        if (r3) n *= r3;
        if (r4) n *= r4;
        if (r5) n *= r5;
        Conf conf;
        if (dataType == kSz2Float) {
            auto* dec = static_cast<float*>(std::malloc(n * sizeof(float)));
            if (!dec) return nullptr;
            container_decompress<float>(bytes, byteLength, conf, dec);
            return dec;
        } else if (dataType == kSz2Double) {
            auto* dec = static_cast<double*>(std::malloc(n * sizeof(double)));
            if (!dec) return nullptr;
            container_decompress<double>(bytes, byteLength, conf, dec);
            return dec;
        }
        return nullptr;
    } catch (...) {
        return nullptr;
    }
}

void free_buf(void* p) { std::free(p); }

// ---- secondary encoders + truncate compressor --------------------------------

// [table save][bitstream]; state_num <= 4096, transform = zigzag fold mode
int szt_ari_encode(const int32_t* bins, uint64_t n, int32_t state_num, int32_t transform,
                   uint8_t** out, uint64_t* out_len, char* err, uint64_t errcap) {
    try {
        ArithmeticCoder ac(transform != 0);
        ac.build(bins, n, state_num);
        Sink s;
        ac.save(s);
        ac.encode(bins, n, s);
        *out = to_malloc(s.buf, out_len);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

int szt_ari_decode(const uint8_t* blob, uint64_t len, int32_t transform, int32_t* out,
                   uint64_t n, char* err, uint64_t errcap) {
    try {
        Source s(blob, len);
        ArithmeticCoder ac(transform != 0);
        ac.load(s);
        auto v = ac.decode(s, n);
        std::memcpy(out, v.data(), v.size() * sizeof(int32_t));
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

int szt_rle_encode(const int32_t* bins, uint64_t n, uint8_t** out, uint64_t* out_len, char* err,
                   uint64_t errcap) {
    try {
        Sink s;
        RunlengthCoder::encode(bins, n, s);
        *out = to_malloc(s.buf, out_len);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

int szt_rle_decode(const uint8_t* blob, uint64_t len, int32_t* out, uint64_t n, char* err,
                   uint64_t errcap) {
    try {
        Source s(blob, len);
        RunlengthCoder::decode(s, n, out);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

// truncate byte planes -> zstd (reference SZTruncateCompressor)
int szt_truncate_compress(const float* data, uint64_t n, int32_t byte_len, uint8_t** out,
                          uint64_t* out_len, char* err, uint64_t errcap) {
    try {
        if (byte_len < 1 || byte_len > 4) throw std::runtime_error("byte_len must be 1..4");
        Sink s;
        s.reserve(n * byte_len);
        truncate_f32(data, n, byte_len, s);
        auto z = zstd_pack(s.buf.data(), s.buf.size(), ZSTD_compressBound(s.buf.size()) + 16);
        *out = to_malloc(z, out_len);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

int szt_truncate_decompress(const uint8_t* blob, uint64_t len, int32_t byte_len, float* out,
                            uint64_t n, char* err, uint64_t errcap) {
    try {
        auto raw = zstd_unpack(blob, len);
        Source s(raw.data(), raw.size());
        truncate_f32_recover(s, n, byte_len, out);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

// ---- MDZ adaptive time-series compressor (reference tools/mdz) --------------

// dtype: 0 = float32, 1 = float64. method -1 = adaptive (re-select every 50
// batches); 0..4 pin VQ/VQT/MT/LR/TS.
int szt_mdz_compress(const uint64_t* dims, int32_t ndim, uint8_t dtype, uint8_t eb_mode,
                     double eb, uint64_t batch, int32_t quantbin, int32_t method,
                     const void* data, uint8_t** out, uint64_t* out_len, char* err,
                     uint64_t errcap) {
    try {
        MdzParams p;
        p.dims.assign(dims, dims + ndim);
        p.eb_mode = eb_mode;
        p.eb = eb;
        p.batch_size = batch;
        p.quantbin = quantbin;
        p.method = method;
        std::vector<uint8_t> blob;
        if (dtype == 0) blob = mdz_compress<float>(p, static_cast<const float*>(data));
        else if (dtype == 1) blob = mdz_compress<double>(p, static_cast<const double*>(data));
        else throw std::runtime_error("mdz: unsupported dtype");
        *out = to_malloc(blob, out_len);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

int szt_mdz_peek(const uint8_t* blob, uint64_t len, uint64_t* dims, int32_t* ndim,
                 uint8_t* dtype, char* err, uint64_t errcap) {
    try {
        auto h = mdz_peek(blob, len);
        *ndim = int32_t(h.dims.size());
        *dtype = h.dtype;
        for (size_t i = 0; i < h.dims.size(); i++) dims[i] = h.dims[i];
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

int szt_mdz_decompress(const uint8_t* blob, uint64_t len, void* out, char* err, uint64_t errcap) {
    try {
        auto h = mdz_peek(blob, len);
        if (h.dtype == 0) mdz_decompress<float>(blob, len, static_cast<float*>(out));
        else if (h.dtype == 1) mdz_decompress<double>(blob, len, static_cast<double*>(out));
        else throw std::runtime_error("mdz: unsupported dtype");
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

// ---- device entropy stage glue ------------------------------------------------

// Histogram -> Huffman tree with reference tie-breaking. Returns the
// serialized tree bytes (huff.save framing) plus right-aligned 32-bit codes
// and lengths indexed by (symbol - offset). rc 1 = tree deeper than 32 bits
// (caller must use the host encoder).
int szt_huff_table(int64_t offset, const uint64_t* freq, uint64_t state_num, uint32_t* codes,
                   uint8_t* lens, uint8_t** tree_out, uint64_t* tree_len, char* err,
                   uint64_t errcap) {
    try {
        Huffman<int32_t> h;
        std::vector<size_t> f(freq, freq + state_num);
        h.build_hist(int32_t(offset), f);
        if (!h.export_codes32(codes, lens)) return 1;
        Sink s;
        h.save(s);
        *tree_out = to_malloc(s.buf, tree_len);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

// Assemble the payload from device-packed pieces (tree bytes + bitstream +
// stream-order literals); byte-identical to szt_interp_seal's output.
int szt_interp_seal_packed(SztConf* conf, const uint8_t* tree, uint64_t tree_len,
                           const uint8_t* bits, uint64_t bit_count, uint64_t count,
                           const void* unpred, uint64_t unpred_n, uint64_t cap, uint8_t** out,
                           uint64_t* out_len, char* err, uint64_t errcap) {
    try {
        Conf k = to_conf(conf);
        std::vector<uint8_t> payload;
        auto seal = [&](auto* tp) {
            using T = std::remove_pointer_t<decltype(tp)>;
            switch (k.N()) {
                case 1: payload = interp_seal_packed<T, 1>(k, tree, tree_len, bits, bit_count, count, static_cast<const T*>(unpred), unpred_n, cap); break;
                case 2: payload = interp_seal_packed<T, 2>(k, tree, tree_len, bits, bit_count, count, static_cast<const T*>(unpred), unpred_n, cap); break;
                case 3: payload = interp_seal_packed<T, 3>(k, tree, tree_len, bits, bit_count, count, static_cast<const T*>(unpred), unpred_n, cap); break;
                case 4: payload = interp_seal_packed<T, 4>(k, tree, tree_len, bits, bit_count, count, static_cast<const T*>(unpred), unpred_n, cap); break;
                default: throw std::runtime_error("unsupported dimensionality");
            }
        };
        if (conf->engineType == 0) seal(static_cast<float*>(nullptr));
        else if (conf->engineType == 1) seal(static_cast<double*>(nullptr));
        else throw std::runtime_error("unsupported dtype for device path");
        from_conf(k, conf);
        *out = to_malloc(payload, out_len);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

// ---- packed open (deferred entropy decode, device decode path) --------------

int szt_open_packed(SztConf* conf, int algo, const uint8_t* payload, uint64_t len,
                    uint8_t** bits_out, uint64_t* bits_len, uint64_t* count, int64_t* offset,
                    uint32_t** codes_out, uint8_t** lens_out, uint64_t* ncodes,
                    int64_t* const_sym, uint8_t** unpred_out, uint64_t* unpred_bytes,
                    char* err, uint64_t errcap) {
    try {
        Conf k = to_conf(conf);
        std::vector<uint8_t> bits, lens;
        std::vector<uint32_t> codes;
        auto open = [&](auto* tp) {
            using T = std::remove_pointer_t<decltype(tp)>;
            std::vector<T> up;
            if (algo == 2) {
                switch (k.N()) {
                    case 1: interp_open_packed<T, 1>(k, payload, len, bits, *count, *offset, codes, lens, *const_sym, up); break;
                    case 2: interp_open_packed<T, 2>(k, payload, len, bits, *count, *offset, codes, lens, *const_sym, up); break;
                    case 3: interp_open_packed<T, 3>(k, payload, len, bits, *count, *offset, codes, lens, *const_sym, up); break;
                    case 4: interp_open_packed<T, 4>(k, payload, len, bits, *count, *offset, codes, lens, *const_sym, up); break;
                    default: throw std::runtime_error("unsupported dimensionality");
                }
            } else if (algo == 3) {
                nopred_open_packed<T>(k, payload, len, bits, *count, *offset, codes, lens, *const_sym, up);
            } else {
                throw std::runtime_error("unsupported algo for packed open");
            }
            std::vector<uint8_t> raw(reinterpret_cast<uint8_t*>(up.data()),
                                     reinterpret_cast<uint8_t*>(up.data() + up.size()));
            *unpred_out = to_malloc(raw, unpred_bytes);
        };
        if (conf->engineType == 0) open(static_cast<float*>(nullptr));
        else if (conf->engineType == 1) open(static_cast<double*>(nullptr));
        else throw std::runtime_error("unsupported dtype for device path");
        *bits_out = to_malloc(bits, bits_len);
        std::vector<uint8_t> craw(reinterpret_cast<uint8_t*>(codes.data()),
                                  reinterpret_cast<uint8_t*>(codes.data() + codes.size()));
        uint64_t cb = 0;
        *codes_out = reinterpret_cast<uint32_t*>(to_malloc(craw, &cb));
        *lens_out = to_malloc(lens, ncodes);
        from_conf(k, conf);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

// ---- device NOPRED seal/open -------------------------------------------------

int szt_nopred_seal_packed(SztConf* conf, const uint8_t* tree, uint64_t tree_len,
                           const uint8_t* bits, uint64_t bit_count, uint64_t count,
                           const void* unpred, uint64_t unpred_n, uint64_t cap, uint8_t** out,
                           uint64_t* out_len, char* err, uint64_t errcap) {
    try {
        Conf k = to_conf(conf);
        std::vector<uint8_t> payload;
        auto seal = [&](auto* tp) {
            using T = std::remove_pointer_t<decltype(tp)>;
            payload = nopred_seal_packed<T>(k, tree, tree_len, bits, bit_count, count,
                                            static_cast<const T*>(unpred), unpred_n, cap);
        };
        if (conf->engineType == 0) seal(static_cast<float*>(nullptr));
        else if (conf->engineType == 1) seal(static_cast<double*>(nullptr));
        else throw std::runtime_error("unsupported dtype for device path");
        from_conf(k, conf);
        *out = to_malloc(payload, out_len);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

int szt_nopred_open(SztConf* conf, const uint8_t* payload, uint64_t len, int32_t* bins,
                    uint8_t** unpred_out, uint64_t* unpred_bytes, char* err, uint64_t errcap) {
    try {
        Conf k = to_conf(conf);
        std::vector<int32_t> bv;
        auto open = [&](auto* tp) {
            using T = std::remove_pointer_t<decltype(tp)>;
            std::vector<T> up;
            nopred_open<T>(k, payload, len, bv, up);
            std::vector<uint8_t> raw(reinterpret_cast<uint8_t*>(up.data()),
                                     reinterpret_cast<uint8_t*>(up.data() + up.size()));
            *unpred_out = to_malloc(raw, unpred_bytes);
        };
        if (conf->engineType == 0) open(static_cast<float*>(nullptr));
        else if (conf->engineType == 1) open(static_cast<double*>(nullptr));
        else throw std::runtime_error("unsupported dtype for device path");
        if (bv.size() > k.num()) throw std::runtime_error("archived bin count exceeds conf.num");
        std::memcpy(bins, bv.data(), bv.size() * sizeof(int32_t));
        from_conf(k, conf);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

// ---- device blockwise (ALGO_LORENZO_REG) seal --------------------------------

int szt_blockwise_seal(SztConf* conf, const int32_t* bins, uint64_t n, const int32_t* sel,
                       uint64_t nsel, const int32_t* regb, uint64_t nregb, const float* qlu,
                       uint64_t nqlu, const float* qiu, uint64_t nqiu, const float* unpred,
                       uint64_t nun, uint64_t cap, uint8_t** out, uint64_t* out_len, char* err,
                       uint64_t errcap) {
    try {
        Conf k = to_conf(conf);
        std::vector<uint8_t> payload;
        switch (k.N()) {
            case 1: payload = blockwise_seal<float, 1>(k, bins, n, sel, nsel, regb, nregb, qlu, nqlu, qiu, nqiu, unpred, nun, cap); break;
            case 2: payload = blockwise_seal<float, 2>(k, bins, n, sel, nsel, regb, nregb, qlu, nqlu, qiu, nqiu, unpred, nun, cap); break;
            case 3: payload = blockwise_seal<float, 3>(k, bins, n, sel, nsel, regb, nregb, qlu, nqlu, qiu, nqiu, unpred, nun, cap); break;
            case 4: payload = blockwise_seal<float, 4>(k, bins, n, sel, nsel, regb, nregb, qlu, nqlu, qiu, nqiu, unpred, nun, cap); break;
            default: throw std::runtime_error("unsupported dimensionality");
        }
        from_conf(k, conf);
        *out = to_malloc(payload, out_len);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

// blockwise payload -> all archive streams. bins fills the caller buffer
// (conf.num entries); the five side streams come back malloc'd with counts.
// Effective params (eb, quantbinCnt) written back into conf.
int szt_blockwise_open(SztConf* conf, const uint8_t* payload, uint64_t len, int32_t* bins,
                       int32_t** sel, uint64_t* nsel, int32_t** regb, uint64_t* nregb,
                       float** qlu, uint64_t* nqlu, float** qiu, uint64_t* nqiu, float** unpred,
                       uint64_t* nun, char* err, uint64_t errcap) {
    try {
        Conf k = to_conf(conf);
        std::vector<int32_t> bv, sv, rv;
        std::vector<float> qlv, qiv, uv;
        switch (k.N()) {
            case 1: blockwise_open<float, 1>(k, payload, len, bv, sv, rv, qlv, qiv, uv); break;
            case 2: blockwise_open<float, 2>(k, payload, len, bv, sv, rv, qlv, qiv, uv); break;
            case 3: blockwise_open<float, 3>(k, payload, len, bv, sv, rv, qlv, qiv, uv); break;
            case 4: blockwise_open<float, 4>(k, payload, len, bv, sv, rv, qlv, qiv, uv); break;
            default: throw std::runtime_error("unsupported dimensionality");
        }
        if (bv.size() > k.num()) throw std::runtime_error("archived bin count exceeds conf.num");
        std::memcpy(bins, bv.data(), bv.size() * sizeof(int32_t));
        *sel = static_cast<int32_t*>(std::malloc(std::max<size_t>(1, sv.size() * 4)));
        std::memcpy(*sel, sv.data(), sv.size() * 4);
        *nsel = sv.size();
        *regb = static_cast<int32_t*>(std::malloc(std::max<size_t>(1, rv.size() * 4)));
        std::memcpy(*regb, rv.data(), rv.size() * 4);
        *nregb = rv.size();
        *qlu = static_cast<float*>(std::malloc(std::max<size_t>(1, qlv.size() * 4)));
        std::memcpy(*qlu, qlv.data(), qlv.size() * 4);
        *nqlu = qlv.size();
        *qiu = static_cast<float*>(std::malloc(std::max<size_t>(1, qiv.size() * 4)));
        std::memcpy(*qiu, qiv.data(), qiv.size() * 4);
        *nqiu = qiv.size();
        *unpred = static_cast<float*>(std::malloc(std::max<size_t>(1, uv.size() * 4)));
        std::memcpy(*unpred, uv.data(), uv.size() * 4);
        *nun = uv.size();
        from_conf(k, conf);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

// Coefficient-chain replay for the device blockwise decode
// (ops/blockwise_wavefront.py): reconstructed regression coefficients per
// committing block, in row-major commit order. The chain is the format's one
// truly sequential decode dependency (reference RegressionPredictor.hpp:157-164
// pred = previous committed block's reconstructed coefficient) — a few scalar
// f64 ops per block, so it replays here while the element sweep runs as a
// parallel wavefront on device. eb_ql/eb_qi are the linear/intercept
// quantizer bounds (eb/(N+1)/blockSize and eb/(N+1), blockwise.hpp:111-112).
int szt_blockwise_coef_chain(double eb_ql, double eb_qi, uint64_t ncommit,
                             const int32_t* regb, const float* ql_lit, uint64_t nql,
                             const float* qi_lit, uint64_t nqi, float* out,
                             char* err, uint64_t errcap) {
    try {
        LinearQuantizer<float> ql(eb_ql), qi(eb_qi);
        ql.unpred.assign(ql_lit, ql_lit + nql);
        qi.unpred.assign(qi_lit, qi_lit + nqi);
        float prev[4] = {0, 0, 0, 0};
        for (uint64_t b = 0; b < ncommit; b++) {
            for (int k = 0; k < 3; k++) prev[k] = ql.recover(prev[k], regb[b * 4 + k]);
            prev[3] = qi.recover(prev[3], regb[b * 4 + 3]);
            std::memcpy(out + b * 4, prev, 4 * sizeof(float));
        }
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

// Encode counterpart of szt_blockwise_coef_chain for the device wavefront
// ENCODE (ops/blockwise_wavefront_encode.py): raw least-squares coefficients
// of the committing blocks (row-major commit order) -> quantized bins + the
// reconstructed coefficients the element sweep predicts with (reference
// RegressionPredictor.hpp:148-155). Matches LinearQuantizer by-reference
// semantics: on a successful quantize the coefficient becomes its
// reconstruction; on overflow the bin is 0 and the RAW value carries forward
// (and becomes the literal — the caller recovers literals as raw[bins==0]).
int szt_blockwise_coef_chain_encode(double eb_ql, double eb_qi, uint64_t ncommit,
                                    const float* raw, int32_t* bins_out,
                                    float* recon_out, char* err, uint64_t errcap) {
    try {
        LinearQuantizer<float> ql(eb_ql), qi(eb_qi);
        float prev[4] = {0, 0, 0, 0};
        for (uint64_t b = 0; b < ncommit; b++) {
            for (int k = 0; k < 4; k++) {
                float cur = raw[b * 4 + k];
                bins_out[b * 4 + k] = (k < 3 ? ql : qi).quantize(cur, prev[k]);
                prev[k] = cur;  // recon on success, raw on overflow
                recon_out[b * 4 + k] = cur;
            }
        }
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

// Device-packed blockwise seal: side streams (host) + the device-packed
// bins bitstream + device-extracted literals -> payload byte-identical to
// szt_blockwise_seal's (see bridge.hpp::blockwise_seal_packed). f32 (the
// device wavefront's scope).
int szt_blockwise_seal_packed(SztConf* conf, const uint8_t* tree, uint64_t tree_len,
                              const uint8_t* bits, uint64_t bit_count, uint64_t count,
                              const int32_t* sel, uint64_t nsel, const int32_t* regb,
                              uint64_t nregb, const float* qlu, uint64_t nqlu,
                              const float* qiu, uint64_t nqiu, const float* unpred,
                              uint64_t nun, uint64_t cap, uint8_t** out, uint64_t* out_len,
                              char* err, uint64_t errcap) {
    try {
        Conf k = to_conf(conf);
        std::vector<uint8_t> payload;
        switch (k.N()) {
            case 1: payload = blockwise_seal_packed<float, 1>(k, tree, tree_len, bits, bit_count, count, sel, nsel, regb, nregb, qlu, nqlu, qiu, nqiu, unpred, nun, cap); break;
            case 2: payload = blockwise_seal_packed<float, 2>(k, tree, tree_len, bits, bit_count, count, sel, nsel, regb, nregb, qlu, nqlu, qiu, nqiu, unpred, nun, cap); break;
            case 3: payload = blockwise_seal_packed<float, 3>(k, tree, tree_len, bits, bit_count, count, sel, nsel, regb, nregb, qlu, nqlu, qiu, nqiu, unpred, nun, cap); break;
            case 4: payload = blockwise_seal_packed<float, 4>(k, tree, tree_len, bits, bit_count, count, sel, nsel, regb, nregb, qlu, nqlu, qiu, nqiu, unpred, nun, cap); break;
            default: throw std::runtime_error("unsupported dimensionality");
        }
        from_conf(k, conf);
        *out = to_malloc(payload, out_len);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

// Packed blockwise open: side streams decode natively (tiny), the bins
// Huffman bitstream + code table come back raw for the on-chip bit-walk.
int szt_blockwise_open_packed(SztConf* conf, const uint8_t* payload, uint64_t len,
                              uint8_t** bits_out, uint64_t* bits_len, uint64_t* count,
                              int64_t* offset, uint32_t** codes_out, uint8_t** lens_out,
                              uint64_t* ncodes, int64_t* const_sym, int32_t** sel,
                              uint64_t* nsel, int32_t** regb, uint64_t* nregb, float** qlu,
                              uint64_t* nqlu, float** qiu, uint64_t* nqiu, float** unpred,
                              uint64_t* nun, char* err, uint64_t errcap) {
    try {
        Conf k = to_conf(conf);
        std::vector<uint8_t> bits, lens;
        std::vector<uint32_t> codes;
        std::vector<int32_t> sv, rv;
        std::vector<float> qlv, qiv, uv;
        switch (k.N()) {
            case 1: blockwise_open_packed<float, 1>(k, payload, len, bits, *count, *offset, codes, lens, *const_sym, sv, rv, qlv, qiv, uv); break;
            case 2: blockwise_open_packed<float, 2>(k, payload, len, bits, *count, *offset, codes, lens, *const_sym, sv, rv, qlv, qiv, uv); break;
            case 3: blockwise_open_packed<float, 3>(k, payload, len, bits, *count, *offset, codes, lens, *const_sym, sv, rv, qlv, qiv, uv); break;
            case 4: blockwise_open_packed<float, 4>(k, payload, len, bits, *count, *offset, codes, lens, *const_sym, sv, rv, qlv, qiv, uv); break;
            default: throw std::runtime_error("unsupported dimensionality");
        }
        *bits_out = to_malloc(bits, bits_len);
        std::vector<uint8_t> craw(reinterpret_cast<uint8_t*>(codes.data()),
                                  reinterpret_cast<uint8_t*>(codes.data() + codes.size()));
        uint64_t cb = 0;
        *codes_out = reinterpret_cast<uint32_t*>(to_malloc(craw, &cb));
        *lens_out = to_malloc(lens, ncodes);
        auto grab_i32 = [](const std::vector<int32_t>& v, int32_t** p, uint64_t* n) {
            *p = static_cast<int32_t*>(std::malloc(std::max<size_t>(1, v.size() * 4)));
            std::memcpy(*p, v.data(), v.size() * 4);
            *n = v.size();
        };
        auto grab_f32 = [](const std::vector<float>& v, float** p, uint64_t* n) {
            *p = static_cast<float*>(std::malloc(std::max<size_t>(1, v.size() * 4)));
            std::memcpy(*p, v.data(), v.size() * 4);
            *n = v.size();
        };
        grab_i32(sv, sel, nsel);
        grab_i32(rv, regb, nregb);
        grab_f32(qlv, qlu, nqlu);
        grab_f32(qiv, qiu, nqiu);
        grab_f32(uv, unpred, nun);
        from_conf(k, conf);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

// ---- BioMD device-path split (f32; see ops/biomd_device.py) ------------------

// frame-0 scalar atom chain: data(atoms*cols) -> bins + recon (caller buffers)
// + unpred literals (malloc'd)
int szt_biomd_frame0(double eb, int32_t radius, int32_t site, const float* data,
                     uint64_t atoms, uint64_t cols, int32_t* bins, float* recon,
                     float** unpred, uint64_t* nun, char* err, uint64_t errcap) {
    try {
        std::vector<float> uv;
        biomd_frame0_encode<float>(eb, radius, site, data, atoms, cols, bins, recon, uv);
        *unpred = static_cast<float*>(std::malloc(std::max<size_t>(1, uv.size() * 4)));
        std::memcpy(*unpred, uv.data(), uv.size() * 4);
        *nun = uv.size();
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

// frame-0 recover chain: bins + this frame's unpred slice -> out (caller buffer)
int szt_biomd_frame0_open(double eb, int32_t radius, int32_t site,
                          const int32_t* bins, uint64_t atoms, uint64_t cols,
                          const float* unpred, uint64_t nun, float* out,
                          char* err, uint64_t errcap) {
    try {
        biomd_frame0_decode<float>(eb, radius, site, bins, atoms, cols, unpred, nun, out);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

// precomputed bins + codec state -> ALGO_BIOMD payload (HuffmanV2 + zstd),
// byte-identical to the host engine's compress_biomd
int szt_biomd_seal(SztConf* conf, const int32_t* bins, uint64_t n, const float* unpred,
                   uint64_t nun, int32_t site, uint64_t first_fill, float fill,
                   uint64_t cap, uint8_t** out, uint64_t* out_len, char* err,
                   uint64_t errcap) {
    try {
        Conf k = to_conf(conf);
        std::vector<uint8_t> payload;
        switch (k.N()) {
            case 1: payload = biomd_seal<float, 1>(k, bins, n, unpred, nun, site, first_fill, fill, cap); break;
            case 2: payload = biomd_seal<float, 2>(k, bins, n, unpred, nun, site, first_fill, fill, cap); break;
            case 3: payload = biomd_seal<float, 3>(k, bins, n, unpred, nun, site, first_fill, fill, cap); break;
            default: throw std::runtime_error("unsupported dimensionality");
        }
        from_conf(k, conf);
        *out = to_malloc(payload, out_len);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

// ALGO_BIOMD payload -> bins (caller buffer, conf.num entries; count written
// to *nbins) + unpred (malloc'd) + codec state
int szt_biomd_open(SztConf* conf, const uint8_t* payload, uint64_t len, int32_t* bins,
                   uint64_t* nbins, float** unpred, uint64_t* nun, int32_t* site,
                   uint64_t* first_fill, float* fill, char* err, uint64_t errcap) {
    try {
        Conf k = to_conf(conf);
        std::vector<int32_t> bv;
        std::vector<float> uv;
        int32_t s = 0;
        size_t ff = 0;
        float fv = 0;
        switch (k.N()) {
            case 1: biomd_open<float, 1>(k, payload, len, bv, uv, s, ff, fv); break;
            case 2: biomd_open<float, 2>(k, payload, len, bv, uv, s, ff, fv); break;
            case 3: biomd_open<float, 3>(k, payload, len, bv, uv, s, ff, fv); break;
            default: throw std::runtime_error("unsupported dimensionality");
        }
        if (bv.size() > k.num()) throw std::runtime_error("archived bin count exceeds conf.num");
        from_conf(k, conf);
        std::memcpy(bins, bv.data(), bv.size() * sizeof(int32_t));
        *nbins = bv.size();
        *unpred = static_cast<float*>(std::malloc(std::max<size_t>(1, uv.size() * 4)));
        std::memcpy(*unpred, uv.data(), uv.size() * 4);
        *nun = uv.size();
        *site = s;
        *first_fill = ff;
        *fill = fv;
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

}  // extern "C" — the seal/open templates below need C++ linkage

namespace {

// precomputed stored bins (already offset by -kXtcRadius) -> ALGO_BIOMDXTC
// payload, byte-identical to compress_biomdxtc (pipeline.hpp:343-363): the
// device path computes the elementwise quantize, this seals it through the
// XTC triplet coder.
template <class T, int N>
std::vector<uint8_t> biomdxtc_seal_impl(Conf& conf, const int32_t* bins, uint64_t n,
                                        const T* unpred, uint64_t nun,
                                        uint64_t first_fill, T fill, size_t cap) {
    BioMDXtcCodec<T, N> codec;
    for (int i = 0; i < N; i++) codec.dims[i] = conf.dims[i];
    codec.quant = LinearQuantizer<T>(conf.absErrorBound, kXtcRadius, /*strict=*/false);
    codec.quant.unpred.assign(unpred, unpred + nun);
    codec.first_fill_frame = first_fill;
    codec.fill_value = fill;
    XtcCoder coder;
    coder.preprocess(bins, n);
    Sink inner;
    inner.reserve(n + 4096);
    codec.save(inner);
    coder.save(inner);
    inner.put<size_t>(n);
    coder.encode(bins, n, inner);
    if (inner.buf.size() > cap) throw buffer_too_small();
    return std::move(inner.buf);
}

template <class T, int N>
void biomdxtc_open_impl(const Conf& conf, const uint8_t* cmp, size_t len,
                        std::vector<int32_t>& bins, std::vector<T>& unpred,
                        uint64_t& first_fill, T& fill) {
    Source src(cmp, len);
    BioMDXtcCodec<T, N> codec;
    for (int i = 0; i < N; i++) codec.dims[i] = conf.dims[i];
    codec.load(src);
    XtcCoder coder;
    coder.load(src);
    size_t count = src.template get<size_t>();
    check_count(count, codec.live(), "bin");
    bins.resize(count);
    coder.decode(src, count, bins.data());
    unpred = std::move(codec.quant.unpred);
    first_fill = codec.first_fill_frame;
    fill = codec.fill_value;
}

}  // namespace

extern "C" {

int szt_biomdxtc_seal(SztConf* conf, const int32_t* bins, uint64_t n, const float* unpred,
                      uint64_t nun, uint64_t first_fill, float fill, uint64_t cap,
                      uint8_t** out, uint64_t* out_len, char* err, uint64_t errcap) {
    try {
        Conf k = to_conf(conf);
        std::vector<uint8_t> payload;
        switch (k.N()) {
            case 1: payload = biomdxtc_seal_impl<float, 1>(k, bins, n, unpred, nun, first_fill, fill, cap); break;
            case 2: payload = biomdxtc_seal_impl<float, 2>(k, bins, n, unpred, nun, first_fill, fill, cap); break;
            case 3: payload = biomdxtc_seal_impl<float, 3>(k, bins, n, unpred, nun, first_fill, fill, cap); break;
            default: throw std::runtime_error("unsupported dimensionality");
        }
        from_conf(k, conf);
        *out = to_malloc(payload, out_len);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

// ALGO_BIOMDXTC payload -> stored bins (caller buffer, conf.num entries;
// count written to *nbins) + the quantizer's literal stream + fill state
int szt_biomdxtc_open(SztConf* conf, const uint8_t* payload, uint64_t len, int32_t* bins,
                      uint64_t* nbins, float** unpred, uint64_t* nun,
                      uint64_t* first_fill, float* fill, char* err, uint64_t errcap) {
    try {
        Conf k = to_conf(conf);
        std::vector<int32_t> bv;
        std::vector<float> uv;
        uint64_t ff = 0;
        float fv = 0;
        switch (k.N()) {
            case 1: biomdxtc_open_impl<float, 1>(k, payload, len, bv, uv, ff, fv); break;
            case 2: biomdxtc_open_impl<float, 2>(k, payload, len, bv, uv, ff, fv); break;
            case 3: biomdxtc_open_impl<float, 3>(k, payload, len, bv, uv, ff, fv); break;
            default: throw std::runtime_error("unsupported dimensionality");
        }
        if (bv.size() > k.num()) throw std::runtime_error("archived bin count exceeds conf.num");
        std::memcpy(bins, bv.data(), bv.size() * sizeof(int32_t));
        *nbins = bv.size();
        *unpred = static_cast<float*>(std::malloc(std::max<size_t>(1, uv.size() * 4)));
        std::memcpy(*unpred, uv.data(), uv.size() * 4);
        *nun = uv.size();
        *first_fill = ff;
        *fill = fv;
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

// ---- MDZ device-path building blocks (ops/mdz_device.py) ---------------------
// The heavy per-batch quantize sweeps run on device; these entries cover the
// host-side pieces: VQ level learning (kmeans get_cluster + the sampling
// rules of mdz_compress_2d), the Exaalt two-Huffman stream seal/open, and
// the TimeSeries generic seal/open.

int szt_mdz_levels(const float* data, uint64_t atoms, float* ls, float* lo, int32_t* ln,
                   char* err, uint64_t errcap) {
    try {
        size_t sample_num = size_t(0.1 * double(atoms));
        sample_num = std::min(sample_num, size_t(20000));
        sample_num = std::max(sample_num, std::min(size_t(5000), size_t(atoms)));
        float start = 0, offset = 1;
        int num = 0;
        get_cluster(data, atoms, start, offset, num, sample_num);
        if (num > double(atoms) * 0.25) num = 0;
        *ls = start;
        *lo = offset;
        *ln = num;
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

int szt_exaalt_seal(double eb, int32_t radius, const int32_t* qinds, uint64_t n,
                    const int32_t* pinds, uint64_t pn, const float* unpred, uint64_t nun,
                    uint64_t cap, uint8_t** out, uint64_t* out_len, char* err,
                    uint64_t errcap) {
    try {
        LinearQuantizer<float> quant(eb, radius);
        quant.unpred.assign(unpred, unpred + nun);
        Sink inner;
        inner.reserve(n / 2 + 4096);
        quant.save(inner);
        Huffman<int32_t> h1;
        h1.build(qinds, n);
        h1.save(inner);
        h1.encode(qinds, n, inner);
        Huffman<int32_t> h2;
        h2.build(pinds, pn);
        h2.save(inner);
        h2.encode(pinds, pn, inner);
        auto payload = zstd_pack(inner.buf.data(), inner.buf.size(), cap);
        *out = to_malloc(payload, out_len);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

int szt_exaalt_open(const uint8_t* cmp, uint64_t len, uint64_t n, uint64_t pn,
                    int32_t* qinds, int32_t* pinds, float** unpred, uint64_t* nun,
                    char* err, uint64_t errcap) {
    try {
        auto raw = zstd_unpack(cmp, len);
        Source src(raw.data(), raw.size());
        LinearQuantizer<float> quant(1.0);
        quant.load(src);
        Huffman<int32_t> h1;
        h1.load(src);
        h1.decode(src, n, qinds);
        Huffman<int32_t> h2;
        h2.load(src);
        h2.decode(src, pn, pinds);
        *unpred = static_cast<float*>(std::malloc(std::max<size_t>(1, quant.unpred.size() * 4)));
        std::memcpy(*unpred, quant.unpred.data(), quant.unpred.size() * 4);
        *nun = quant.unpred.size();
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

int szt_mdz_ts_seal(double eb, int32_t radius, const int32_t* bins, uint64_t n,
                    const float* unpred, uint64_t nun, uint64_t cap, uint8_t** out,
                    uint64_t* out_len, char* err, uint64_t errcap) {
    try {
        TimeSeriesCodec<float> codec;
        codec.quant = LinearQuantizer<float>(eb, radius);
        codec.quant.unpred.assign(unpred, unpred + nun);
        std::vector<int32_t> bv(bins, bins + n);
        auto payload = seal_payload<float>(codec, bv, cap);
        *out = to_malloc(payload, out_len);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

int szt_mdz_ts_open(const uint8_t* cmp, uint64_t len, uint64_t n, int32_t* bins,
                    float** unpred, uint64_t* nun, char* err, uint64_t errcap) {
    try {
        TimeSeriesCodec<float> codec;
        std::vector<int32_t> bv;
        open_payload(codec, cmp, len, bv, n);
        std::memcpy(bins, bv.data(), bv.size() * sizeof(int32_t));
        *unpred = static_cast<float*>(
            std::malloc(std::max<size_t>(1, codec.quant.unpred.size() * 4)));
        std::memcpy(*unpred, codec.quant.unpred.data(), codec.quant.unpred.size() * 4);
        *nun = codec.quant.unpred.size();
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

// ---- MDZ LAMMPS in-situ hooks (reference tools/mdz/include/mdz.hpp:283-359) --

int szt_lammps_compress(uint64_t frames, uint64_t atoms, double abs_eb, int32_t quantbin,
                        int32_t block_size, int32_t method, float ls, float lo, int32_t ln,
                        const float* ts0, const float* data, uint8_t** out, uint64_t* out_len,
                        char* err, uint64_t errcap) {
    try {
        auto v = detail::lammps_compress<float>(frames, atoms, abs_eb, quantbin, block_size, method, ls,
                                        lo, ln, ts0, data);
        *out = to_malloc(v, out_len);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

int szt_lammps_decompress(uint64_t frames, uint64_t atoms, double abs_eb, int32_t quantbin,
                          int32_t block_size, int32_t method, float ls, float lo, int32_t ln,
                          const float* ts0, const uint8_t* cmp, uint64_t len, float* out,
                          char* err, uint64_t errcap) {
    try {
        detail::lammps_decompress<float>(frames, atoms, abs_eb, quantbin, block_size, method, ls, lo, ln,
                                 ts0, cmp, len, out);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

int szt_lammps_select(uint64_t frames, uint64_t atoms, double abs_eb, int32_t quantbin,
                      int32_t block_size, int32_t firsttime, float ls, float lo, int32_t ln,
                      const float* ts0, const float* data, int32_t* method_out, char* err,
                      uint64_t errcap) {
    try {
        *method_out = detail::lammps_select_compressor<float>(frames, atoms, abs_eb, quantbin, block_size,
                                                      firsttime != 0, ls, lo, ln, ts0, data);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

// ---- cached-permutation fast path (JAX device backend) -----------------------
// The grid<->stream permutation is data-independent per (dims, algo, direction,
// anchor_stride); the Python layer caches it (runtime.interp_order) and applies
// it here instead of with numpy fancy indexing (6-20x faster: int32 moves, no
// intermediate index arrays, one pass).

// stream[i] = bins[perm[i]]; unpred literals = orig[perm[i]] wherever the bin
// is 0, in stream order. `unpred` must have capacity n elements.
int szt_perm_emit(const int64_t* perm, const int32_t* bins, const void* orig, uint64_t n,
                  uint32_t esize, int32_t* stream, void* unpred, uint64_t* unpred_n, char* err,
                  uint64_t errcap) {
    try {
        uint64_t u = 0;
        auto run = [&](auto* src, auto* up) {
            for (uint64_t i = 0; i < n; i++) {
                int64_t p = perm[i];
                int32_t b = bins[p];
                stream[i] = b;
                up[u] = src[p];
                u += (b == 0);  // branchless append
            }
        };
        switch (esize) {
            case 4: run(static_cast<const uint32_t*>(orig), static_cast<uint32_t*>(unpred)); break;
            case 8: run(static_cast<const uint64_t*>(orig), static_cast<uint64_t*>(unpred)); break;
            case 1: run(static_cast<const uint8_t*>(orig), static_cast<uint8_t*>(unpred)); break;
            case 2: run(static_cast<const uint16_t*>(orig), static_cast<uint16_t*>(unpred)); break;
            default: throw std::runtime_error("bad element size");
        }
        *unpred_n = u;
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

// Inverse: bins_grid[perm[i]] = stream[i]; literal_grid[perm[i]] = next unpred
// literal when the bin is 0 (grids are caller-zeroed or fully overwritten).
int szt_perm_place(const int64_t* perm, const int32_t* stream, const void* unpred, uint64_t n,
                   uint32_t esize, int32_t* bins_grid, void* literal_grid, char* err,
                   uint64_t errcap) {
    try {
        uint64_t u = 0;
        auto run = [&](auto* up, auto* lit) {
            using U = std::remove_const_t<std::remove_reference_t<decltype(up[0])>>;
            for (uint64_t i = 0; i < n; i++) {
                int64_t p = perm[i];
                int32_t b = stream[i];
                bins_grid[p] = b;
                lit[p] = (b == 0) ? up[u] : U(0);
                u += (b == 0);
            }
        };
        switch (esize) {
            case 4: run(static_cast<const uint32_t*>(unpred), static_cast<uint32_t*>(literal_grid)); break;
            case 8: run(static_cast<const uint64_t*>(unpred), static_cast<uint64_t*>(literal_grid)); break;
            case 1: run(static_cast<const uint8_t*>(unpred), static_cast<uint8_t*>(literal_grid)); break;
            case 2: run(static_cast<const uint16_t*>(unpred), static_cast<uint16_t*>(literal_grid)); break;
            default: throw std::runtime_error("bad element size");
        }
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

// ---- full-container entry points (native CLI / C callers) --------------------

int szt_container_compress(SztConf* conf, const void* data, uint8_t** out, uint64_t* out_len,
                           char* err, uint64_t errcap) {
    try {
        Conf k = to_conf(conf);
        std::vector<uint8_t> blob;
        with_dtype(conf->engineType, [&](auto* tp) {
            using T = std::remove_pointer_t<decltype(tp)>;
            blob = container_compress<T>(k, static_cast<const T*>(data), conf->nthreads);
        });
        from_conf(k, conf);
        *out = to_malloc(blob, out_len);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

int szt_container_decompress(SztConf* conf, const uint8_t* blob, uint64_t len, void* out,
                             char* err, uint64_t errcap) {
    try {
        Conf k;
        with_dtype(conf->engineType, [&](auto* tp) {
            using T = std::remove_pointer_t<decltype(tp)>;
            container_decompress<T>(blob, len, k, static_cast<T*>(out));
        });
        from_conf(k, conf);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}

}  // extern "C"

// ---- packed open with 64-bit codes --------------------------------------------
// szt_open_packed with the code table exported as right-aligned uint64_t, for
// a device decode that takes Huffman codes of up to 64 bits.

extern "C" {

int szt_open_packed64(SztConf* conf, int algo, const uint8_t* payload, uint64_t len,
                      uint8_t** bits_out, uint64_t* bits_len, uint64_t* count, int64_t* offset,
                      uint64_t** codes_out, uint8_t** lens_out, uint64_t* ncodes,
                      int64_t* const_sym, uint8_t** unpred_out, uint64_t* unpred_bytes,
                      char* err, uint64_t errcap) {
    try {
        Conf k = to_conf(conf);
        std::vector<uint8_t> bits, lens;
        std::vector<uint64_t> codes;
        auto open = [&](auto* tp) {
            using T = std::remove_pointer_t<decltype(tp)>;
            std::vector<T> up;
            if (algo == 2) {
                switch (k.N()) {
                    case 1: interp_open_packed<T, 1>(k, payload, len, bits, *count, *offset, codes, lens, *const_sym, up); break;
                    case 2: interp_open_packed<T, 2>(k, payload, len, bits, *count, *offset, codes, lens, *const_sym, up); break;
                    case 3: interp_open_packed<T, 3>(k, payload, len, bits, *count, *offset, codes, lens, *const_sym, up); break;
                    case 4: interp_open_packed<T, 4>(k, payload, len, bits, *count, *offset, codes, lens, *const_sym, up); break;
                    default: throw std::runtime_error("unsupported dimensionality");
                }
            } else if (algo == 3) {
                nopred_open_packed<T>(k, payload, len, bits, *count, *offset, codes, lens, *const_sym, up);
            } else {
                throw std::runtime_error("unsupported algo for packed open");
            }
            std::vector<uint8_t> raw(reinterpret_cast<uint8_t*>(up.data()),
                                     reinterpret_cast<uint8_t*>(up.data() + up.size()));
            *unpred_out = to_malloc(raw, unpred_bytes);
        };
        if (conf->engineType == 0) open(static_cast<float*>(nullptr));
        else if (conf->engineType == 1) open(static_cast<double*>(nullptr));
        else throw std::runtime_error("unsupported dtype for device path");
        *bits_out = to_malloc(bits, bits_len);
        std::vector<uint8_t> craw(reinterpret_cast<uint8_t*>(codes.data()),
                                  reinterpret_cast<uint8_t*>(codes.data() + codes.size()));
        uint64_t cb = 0;
        *codes_out = reinterpret_cast<uint64_t*>(to_malloc(craw, &cb));
        *lens_out = to_malloc(lens, ncodes);
        from_conf(k, conf);
        return 0;
    } catch (const std::exception& e) {
        return fail(e, err, errcap);
    }
}


// The first n bytes of a zstd-packed payload ([raw length u64][zstd frame]),
// decompressed as a stream that stops there: a BIOMD payload's codec header
// (site, first fill frame, fill value) without the rest of the frame.
int szt_zstd_head(const uint8_t* payload, uint64_t len, uint8_t* out, uint64_t n, char* err,
                  uint64_t errcap) {
    ZSTD_DCtx* dctx = nullptr;
    try {
        if (len < sizeof(size_t)) throw std::runtime_error("szt: truncated zstd frame");
        dctx = ZSTD_createDCtx();
        if (dctx == nullptr) throw std::bad_alloc();
        ZSTD_inBuffer in{payload + sizeof(size_t), len - sizeof(size_t), 0};
        ZSTD_outBuffer head{out, n, 0};
        while (head.pos < n && in.pos < in.size) {
            size_t rc = ZSTD_decompressStream(dctx, &head, &in);
            if (ZSTD_isError(rc)) throw std::runtime_error(ZSTD_getErrorName(rc));
            if (rc == 0) break;     // the frame ended
        }
        if (head.pos < n) throw std::runtime_error("szt: payload shorter than its header");
        ZSTD_freeDCtx(dctx);
        return 0;
    } catch (const std::exception& e) {
        ZSTD_freeDCtx(dctx);
        return fail(e, err, errcap);
    }
}

}  // extern "C"
