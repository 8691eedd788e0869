// Self-describing archive container: header + payload + trailing Config.
//
// Layout (reference api/sz.hpp:7-19,43-115):
//   [magic 0xF342F310 u32][data-version u32][payload size u64]
//   [payload][Config binary save]
// all little-endian; data-version packs (maj<<24)|(min<<16)|(patch<<8)
// (reference version.hpp.in:21-27). Decompression reads the Config from the
// tail, so no external state is needed beyond the element type.
#ifndef SZT_CONTAINER_HPP
#define SZT_CONTAINER_HPP

#include <cstdint>
#include <vector>

#include "conf.hpp"
#include "pipeline.hpp"
#include "zstd_wrap.hpp"

namespace szt {

constexpr uint32_t kMagicNumber = 0xF342F310u;
constexpr uint32_t kDataVersion = (3u << 24) | (3u << 16) | (2u << 8);  // 3.3.2

// Exact serialized Config size (reference utils/Config.hpp:435-439).
inline size_t conf_size_est(const Conf& conf) {
    Sink tmp;
    conf.save(tmp);
    return tmp.size();
}

// Worst-case archive size (reference api/impl/SZImpl.hpp:33-44).
template <class T>
size_t compress_size_bound(const Conf& conf) {
    size_t conf_est = conf_size_est(conf);
    if (conf.openmp) {
        size_t n_chunks = conf.dims.empty() ? 1 : std::min<size_t>(64, conf.dims[0]);
        return 4096 + 4 + n_chunks * (conf_est + 8) +
               ZSTD_compressBound(conf.num() * sizeof(T)) + n_chunks * 4096;
    }
    return 4096 + conf_est + ZSTD_compressBound(conf.num() * sizeof(T));
}

template <class T>
std::vector<uint8_t> container_compress(Conf& conf, const T* data, int nthreads = 0) {
    if (conf.N() > 4) throw std::invalid_argument("data dimension higher than 4 is not supported");
    size_t cap = compress_size_bound<T>(conf) - 16 - conf_size_est(conf) * 2;  // api/sz.hpp:60
    std::vector<uint8_t> payload;
    if (conf.openmp) {
        payload = compress_chunked<T, 4>(conf, data, nthreads);
    } else {
        switch (conf.N()) {
            case 1: payload = compress_dispatch<T, 1>(conf, data, cap); break;
            case 2: payload = compress_dispatch<T, 2>(conf, data, cap); break;
            case 3: payload = compress_dispatch<T, 3>(conf, data, cap); break;
            case 4: payload = compress_dispatch<T, 4>(conf, data, cap); break;
            default: throw std::runtime_error("unsupported dimensionality");
        }
    }
    Sink out;
    out.reserve(payload.size() + 64);
    out.put<uint32_t>(kMagicNumber);
    out.put<uint32_t>(kDataVersion);
    out.put<uint64_t>(payload.size());
    out.raw(payload.data(), payload.size());
    conf.save(out);
    return std::move(out.buf);
}

// Reads the container, fills conf from the tail, decompresses into out
// (caller-sized to conf.num() elements — call container_peek first when the
// caller does not know the dims).
inline void container_peek(const uint8_t* blob, size_t len, Conf& conf) {
    Source hdr(blob, len);
    uint32_t magic = hdr.get<uint32_t>();
    if (magic != kMagicNumber) throw std::runtime_error("magic number mismatch: not an SZ3 archive");
    uint32_t ver = hdr.get<uint32_t>();
    if (ver != kDataVersion) throw std::runtime_error("archive data version mismatch");
    uint64_t payload_size = hdr.get<uint64_t>();
    if (16 + payload_size > len) throw std::runtime_error("truncated archive");
    Source tail(blob + 16 + payload_size, len - 16 - payload_size);
    conf.load(tail);
}

template <class T>
void container_decompress(const uint8_t* blob, size_t len, Conf& conf, T* out) {
    container_peek(blob, len, conf);
    uint64_t payload_size;
    std::memcpy(&payload_size, blob + 8, 8);
    const uint8_t* payload = blob + 16;
    if (conf.openmp) {
        decompress_chunked<T, 4>(conf, payload, payload_size, out);
        return;
    }
    switch (conf.N()) {
        case 1: decompress_dispatch<T, 1>(conf, payload, payload_size, out); break;
        case 2: decompress_dispatch<T, 2>(conf, payload, payload_size, out); break;
        case 3: decompress_dispatch<T, 3>(conf, payload, payload_size, out); break;
        case 4: decompress_dispatch<T, 4>(conf, payload, payload_size, out); break;
        default: throw std::runtime_error("unsupported dimensionality");
    }
}

}  // namespace szt
#endif
