// Shared plumbing for the szt native engine: little-endian byte IO and the
// error conventions used across the pipeline.
//
// Archive bytes are always little-endian (reference utils/MemoryUtil.hpp:16-26).
// This engine targets LE hosts (x86-64 / aarch64-le); a static_assert guards it.
#ifndef SZT_COMMON_HPP
#define SZT_COMMON_HPP

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <stdexcept>
#include <string>
#include <vector>

namespace szt {

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "szt native engine requires a little-endian host");

// Thrown when a destination buffer cannot hold the compressed stream; the
// dispatcher downgrades to lossless on this (reference SZDispatcher.hpp:44-58).
struct buffer_too_small : std::length_error {
    buffer_too_small() : std::length_error("compressed buffer too small") {}
};

// Append-only little-endian byte sink.
class Sink {
  public:
    std::vector<uint8_t> buf;

    void reserve(size_t n) { buf.reserve(n); }
    size_t size() const { return buf.size(); }
    uint8_t* at(size_t pos) { return buf.data() + pos; }

    void raw(const void* p, size_t n) {
        const uint8_t* b = static_cast<const uint8_t*>(p);
        buf.insert(buf.end(), b, b + n);
    }
    template <class V>
    void put(V v) { raw(&v, sizeof(V)); }
    template <class V>
    void put_n(const V* p, size_t n) { raw(p, n * sizeof(V)); }

    // Reserve space to be patched later (e.g. a size field written after the
    // payload, as SZGenericCompressor does for quant counts).
    size_t skip(size_t n) {
        size_t pos = buf.size();
        buf.resize(pos + n);
        return pos;
    }
    template <class V>
    void patch(size_t pos, V v) { std::memcpy(buf.data() + pos, &v, sizeof(V)); }
};

// Bounds-checked little-endian byte source.
class Source {
  public:
    Source(const uint8_t* p, size_t n) : p_(p), end_(p + n) {}

    const uint8_t* cursor() const { return p_; }
    size_t remaining() const { return static_cast<size_t>(end_ - p_); }

    void raw(void* out, size_t n) {
        if (remaining() < n) throw std::runtime_error("szt: truncated stream");
        std::memcpy(out, p_, n);
        p_ += n;
    }
    template <class V>
    V get() {
        V v;
        raw(&v, sizeof(V));
        return v;
    }
    template <class V>
    void get_n(V* out, size_t n) { raw(out, n * sizeof(V)); }
    void advance(size_t n) {
        if (remaining() < n) throw std::runtime_error("szt: truncated stream");
        p_ += n;
    }
    // the next n bytes, consumed (an archive-given length checked before use)
    const uint8_t* take(size_t n) {
        const uint8_t* p = p_;
        advance(n);
        return p;
    }

  private:
    const uint8_t* p_;
    const uint8_t* end_;
};

// Throws unless an archive-given count equals what the decode needs; checked
// before the count sizes an allocation, a copy or a loop.
inline void check_count(uint64_t got, uint64_t want, const char* what) {
    if (got != want)
        throw std::runtime_error(std::string("szt: archived ") + what + " count " +
                                 std::to_string(got) + " != " + std::to_string(want));
}

}  // namespace szt
#endif
