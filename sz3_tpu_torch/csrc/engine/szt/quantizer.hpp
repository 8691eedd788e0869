// Linear-scaling quantizer: the scalar hot kernel of the whole codec.
//
// Numerical contract is the reference LinearQuantizer (quantizer/
// LinearQuantizer.hpp:43-86): double-precision error-bound arithmetic over
// T-precision data, verify-and-fallback to an "unpredictable" literal list,
// bins in [0, 2*radius] with 0 reserved for unpredictable points.
// Serialized state: [uid=0b10][eb f64][radius i32][unpred count u64][unpred T...]
// (LinearQuantizer.hpp:95-104).
#ifndef SZT_QUANTIZER_HPP
#define SZT_QUANTIZER_HPP

#include <cmath>
#include <cstdint>
#include <vector>

#include "common.hpp"

namespace szt {

template <class T>
class LinearQuantizer {
  public:
    LinearQuantizer() : eb_(1), recip_(1), radius_(32768) {}
    LinearQuantizer(double eb, int radius = 32768, bool strict = true)
        : eb_(eb), recip_(1.0 / eb), radius_(radius), strict_(strict) {}

    double eb() const { return eb_; }
    double recip() const { return recip_; }
    void set_eb(double eb) {
        eb_ = eb;
        recip_ = 1.0 / eb;
    }
    int radius() const { return radius_; }
    void push_unpred(T v) { unpred.push_back(v); }
    int out_range_hi() const { return radius_ * 2; }

    // Quantize data against a prediction; overwrites data with its
    // reconstruction so later predictions see what the decoder will see.
    inline int quantize(T& data, T pred) {
        T diff = data - pred;
        int64_t qi = static_cast<int64_t>(std::fabs(double(diff)) * recip_) + 1;
        if (qi < int64_t(radius_) * 2) {
            qi >>= 1;
            int half = int(qi);
            qi <<= 1;
            int shifted;
            if (diff < 0) {
                qi = -qi;
                shifted = radius_ - half;
            } else {
                shifted = radius_ + half;
            }
            T dec = static_cast<T>(pred + double(qi) * eb_);
            double err = std::fabs(double(dec - data));  // NaN-safe: NaN <= eb is false
            if (err <= eb_ || (!strict_ && err <= eb_ * 1.1)) {
                data = dec;
                return shifted;
            }
        }
        unpred.push_back(data);
        return 0;
    }

    // quantize() against a source value, writing the reconstruction to a
    // separate slot (same arithmetic; lets sweeps leave the input unmutated)
    inline int quantize_from(T src, T pred, T& recon_out) {
        T v = src;
        int q = quantize(v, pred);
        recon_out = v;
        return q;
    }

    inline T recover(T pred, int q) {
        if (q) return static_cast<T>(pred + double(2 * (int64_t(q) - radius_)) * eb_);
        return recover_unpred();
    }

    // the next literal; a stream with more zero bins than literals throws
    inline T recover_unpred() {
        if (unpred_pos_ >= unpred.size()) out_of_literals();
        return unpred[unpred_pos_++];
    }
    [[noreturn, gnu::cold, gnu::noinline]] static void out_of_literals() {
        throw std::runtime_error("szt: more zero bins than literals");
    }

    // Store the literal value; emits bin 0 (used for interp anchor points,
    // reference LinearQuantizer.hpp:88-91).
    inline int save_literal(T v) {
        unpred.push_back(v);
        return 0;
    }

    void save(Sink& out) const {
        out.put<uint8_t>(0b10);
        out.put(eb_);
        out.put<int32_t>(radius_);
        out.put<size_t>(unpred.size());
        if (!unpred.empty()) out.put_n(unpred.data(), unpred.size());
    }

    void load(Source& in) {
        uint8_t uid = in.template get<uint8_t>();
        if (uid != 0b10) throw std::runtime_error("quantizer uid mismatch");
        eb_ = in.template get<double>();
        recip_ = 1.0 / eb_;
        radius_ = in.template get<int32_t>();
        size_t n = in.template get<size_t>();
        if (n > in.remaining() / sizeof(T)) throw std::runtime_error("szt: truncated literals");
        unpred.resize(n);
        if (n) in.get_n(unpred.data(), n);
        unpred_pos_ = 0;
    }

    std::vector<T> unpred;

  private:
    size_t unpred_pos_ = 0;
    double eb_;
    double recip_;
    int radius_;
    bool strict_ = true;
};

}  // namespace szt
#endif
