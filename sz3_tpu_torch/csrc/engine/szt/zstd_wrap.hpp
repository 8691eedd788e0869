// zstd byte-stream backend, level 3, framed as [srcLen u64 LE][zstd frame]
// (reference lossless/Lossless_zstd.hpp:29-45). The capacity check that drives
// the dispatcher's lossless downgrade is reproduced: if the destination budget
// cannot hold ZSTD_compressBound(srcLen), buffer_too_small is thrown
// (Lossless_zstd.hpp:32-34).
#ifndef SZT_ZSTD_WRAP_HPP
#define SZT_ZSTD_WRAP_HPP

#include <zstd.h>

#include <cstdint>
#include <vector>

#include "common.hpp"

namespace szt {

inline constexpr int kZstdLevel = 3;

// Compress src into a fresh framed buffer. `dst_cap` carries the caller's
// budget purely for the parity of the too-small fallback; the actual buffer is
// always allocated at the bound.
inline std::vector<uint8_t> zstd_pack(const uint8_t* src, size_t src_len, size_t dst_cap) {
    size_t bound = ZSTD_compressBound(src_len);
    if (dst_cap < sizeof(size_t) || dst_cap - sizeof(size_t) < bound) throw buffer_too_small();
    std::vector<uint8_t> out(sizeof(size_t) + bound);
    std::memcpy(out.data(), &src_len, sizeof(size_t));
    size_t n = ZSTD_compress(out.data() + sizeof(size_t), bound, src, src_len, kZstdLevel);
    if (ZSTD_isError(n)) throw std::runtime_error(ZSTD_getErrorName(n));
    out.resize(sizeof(size_t) + n);
    return out;
}

inline std::vector<uint8_t> zstd_unpack(const uint8_t* src, size_t src_len) {
    if (src_len < sizeof(size_t)) throw std::runtime_error("szt: truncated zstd frame");
    size_t raw_len;
    std::memcpy(&raw_len, src, sizeof(size_t));
    // sanity-bound the declared size against what zstd can legally expand to
    // (window cap), so a corrupt header can't drive a giant allocation
    unsigned long long hint = ZSTD_getFrameContentSize(src + sizeof(size_t),
                                                       src_len - sizeof(size_t));
    if (hint != ZSTD_CONTENTSIZE_UNKNOWN && hint != ZSTD_CONTENTSIZE_ERROR &&
        raw_len != size_t(hint))
        throw std::runtime_error("szt: zstd frame size mismatch");
    // a zstd block of at most 128 KiB takes at least 4 bytes (an RLE block)
    if (raw_len / (size_t(1) << 17) > (src_len - sizeof(size_t)) / 4 + 1)
        throw std::runtime_error("szt: zstd frame size past the frame's reach");
    std::vector<uint8_t> out(raw_len);
    size_t n = ZSTD_decompress(out.data(), raw_len, src + sizeof(size_t), src_len - sizeof(size_t));
    if (ZSTD_isError(n)) throw std::runtime_error(ZSTD_getErrorName(n));
    out.resize(n);
    return out;
}

// Decompress straight into a caller buffer (lossless-mode archives hold the
// raw array; reference SZDispatcher.hpp:80-87).
inline size_t zstd_unpack_into(const uint8_t* src, size_t src_len, uint8_t* dst, size_t dst_cap) {
    if (src_len < sizeof(size_t)) throw std::runtime_error("szt: truncated zstd frame");
    size_t raw_len;
    std::memcpy(&raw_len, src, sizeof(size_t));
    if (raw_len > dst_cap) throw std::runtime_error("szt: lossless payload larger than destination");
    size_t n = ZSTD_decompress(dst, raw_len, src + sizeof(size_t), src_len - sizeof(size_t));
    if (ZSTD_isError(n)) throw std::runtime_error(ZSTD_getErrorName(n));
    return n;
}

}  // namespace szt
#endif
