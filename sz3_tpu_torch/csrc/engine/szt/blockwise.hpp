// Block-wise prediction decomposition (the SZ2-era ALGO_LORENZO_REG path):
// per-block predictor selection among {1st/2nd-order Lorenzo, linear
// regression}, then per-element predict + quantize over a front-padded copy
// of the data so predictions can cross block borders through reconstructed
// values.
//
// Behavior contract:
//  - padded copy & write-back: reference utils/BlockwiseIterator.hpp:194-280
//    (front padding of 2 per dim, zero-initialized)
//  - block walk & element order: BlockwiseIterator.hpp:48-141 (row-major)
//  - Lorenzo stencils & noise: predictor/LorenzoPredictor.hpp:17-94
//  - regression fit / coefficient chain: predictor/RegressionPredictor.hpp
//  - per-block selection by sampled error: predictor/ComposedPredictor.hpp
//    (+ diagonal sampling, BlockwiseIterator.hpp:151-184)
//  - stream layout: decomposition/BlockwiseDecomposition.hpp:69-79
#ifndef SZT_BLOCKWISE_HPP
#define SZT_BLOCKWISE_HPP

#include <array>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

#include "common.hpp"
#include "huffman.hpp"
#include "quantizer.hpp"

namespace szt {

// Front-padded working copy. Reads before the data's front boundary see 0.
template <class T, int N>
struct PaddedGrid {
    std::array<size_t, N> dims{}, src_stride{}, pad_stride{};
    std::vector<T> buf;
    T* base = nullptr;     // first real element inside the padded buffer
    T* writeback = nullptr;
    size_t padding;

    PaddedGrid(T* data, const std::array<size_t, N>& d, size_t pad, bool copy_in)
        : dims(d), padding(pad) {
        size_t cur = 1, curp = 1;
        for (int i = N - 1; i >= 0; i--) {
            src_stride[i] = cur;
            pad_stride[i] = curp;
            cur *= dims[i];
            curp *= dims[i] + padding;
        }
        size_t total_pad = curp;
        buf.assign(total_pad, T(0));
        size_t shift = 0;
        for (int i = 0; i < N; i++) shift += pad_stride[i];
        base = buf.data() + padding * shift;
        if (copy_in) copy_nd(base, pad_stride, data, src_stride);
        else writeback = data;
    }

    void finish() {
        if (writeback) copy_nd(writeback, src_stride, base, pad_stride);
    }

    void copy_nd(T* dst, const std::array<size_t, N>& dst_s, const T* src,
                 const std::array<size_t, N>& src_s) const {
        if constexpr (N == 1) {
            std::memcpy(dst, src, dims[0] * sizeof(T));
        } else if constexpr (N == 2) {
            for (size_t i = 0; i < dims[0]; i++)
                std::memcpy(dst + i * dst_s[0], src + i * src_s[0], dims[1] * sizeof(T));
        } else if constexpr (N == 3) {
            for (size_t i = 0; i < dims[0]; i++)
                for (size_t j = 0; j < dims[1]; j++)
                    std::memcpy(dst + i * dst_s[0] + j * dst_s[1],
                                src + i * src_s[0] + j * src_s[1], dims[2] * sizeof(T));
        } else {
            for (size_t i = 0; i < dims[0]; i++)
                for (size_t j = 0; j < dims[1]; j++)
                    for (size_t k = 0; k < dims[2]; k++)
                        std::memcpy(dst + i * dst_s[0] + j * dst_s[1] + k * dst_s[2],
                                    src + i * src_s[0] + j * src_s[1] + k * src_s[2],
                                    dims[3] * sizeof(T));
        }
    }
};

enum class Pred : int { LORENZO1 = 0, LORENZO2 = 1, REGRESSION = 2 };

template <class T, int N>
class BlockwiseCodec {
  public:
    using idx_t = std::array<size_t, N>;

    std::array<size_t, N> dims{};
    int block_size = 6;
    bool use_lorenzo = true, use_lorenzo2 = false, use_regression = true;
    double eb = 1e-3;
    LinearQuantizer<T> quant;

    // predictor roster in reference registration order
    std::vector<Pred> roster;
    bool single = false;

    void configure() {
        roster.clear();
        if (use_lorenzo) roster.push_back(Pred::LORENZO1);
        if (use_lorenzo2) roster.push_back(Pred::LORENZO2);
        if (use_regression) roster.push_back(Pred::REGRESSION);
        if (roster.empty()) throw std::runtime_error("all predictors disabled");
        if (block_size < 1) throw std::runtime_error("blockwise: bad block size");
        single = roster.size() == 1;
        noise1_ = lorenzo_noise(1);
        noise2_ = lorenzo_noise(2);
        reg_ql_ = LinearQuantizer<T>(eb / (N + 1) / block_size);
        reg_qi_ = LinearQuantizer<T>(eb / (N + 1));
        reg_bins_.clear();
        reg_pos_ = 0;
        selection_.clear();
        sel_pos_ = 0;
        prev_coef_.fill(T(0));
        cur_coef_.fill(T(0));
    }

    size_t num_elements() const {
        size_t n = 1;
        for (auto d : dims) n *= d;
        return n;
    }

    size_t num_blocks() const {
        size_t n = 1;
        for (auto d : dims) n *= (d + block_size - 1) / block_size;
        return n;
    }

    void compress(T* data, int32_t* bins_out) {
        configure();
        run_compress(data, bins_out);
    }

    // One compress sweep without resetting accumulated streams (selection,
    // regression coeffs, unpred) — the tuner feeds several sampled blocks
    // through one codec instance (reference SZAlgoInterp.hpp:91-96).
    void run_compress(T* data, int32_t* bins_out) {
        PaddedGrid<T, N> grid(data, dims, 2, true);
        size_t pos = 0;
        sweep_blocks([&](const idx_t& b0, const idx_t& b1) {
            Pred active;
            bool ok = select_block(grid, b0, b1, active);
            if (!ok) active = Pred::LORENZO1;  // fallback (BlockwiseDecomposition.hpp:34-37)
            else commit_block(active);
            foreach_block(grid, b0, b1, [&](T* c, const idx_t& li) {
                T pred = predict(active, c, grid.pad_stride, li);
                bins_out[pos++] = quant.quantize(*c, pred);
            });
        });
        grid.finish();  // compress path: padded copy owns scratch, original untouched
    }

    // Requires a preceding load(): consumes the selection/coefficient streams
    // and the quantizer's unpred literals read from the archive. (Must NOT
    // re-run configure() here — that would reset the loaded stream state.)
    void decompress(const int32_t* bins, T* out) {
        PaddedGrid<T, N> grid(out, dims, 2, false);
        size_t pos = 0;
        sweep_blocks([&](const idx_t& b0, const idx_t& b1) {
            Pred active;
            if (!select_block_decompress(b0, b1, active)) active = Pred::LORENZO1;
            foreach_block(grid, b0, b1, [&](T* c, const idx_t& li) {
                T pred = predict(active, c, grid.pad_stride, li);
                *c = quant.recover(pred, bins[pos++]);
            });
        });
        grid.finish();
    }

    // Device-path seal support: adopt externally computed side streams
    // (selection, coefficient bins + coef-quantizer literals, element
    // literals) so save() serializes a device-encoded block sweep.
    void adopt_streams(std::vector<int32_t> sel, std::vector<int32_t> regb,
                       std::vector<T> ql_unpred, std::vector<T> qi_unpred,
                       std::vector<T> unpred) {
        configure();
        selection_ = std::move(sel);
        reg_bins_ = std::move(regb);
        reg_ql_.unpred = std::move(ql_unpred);
        reg_qi_.unpred = std::move(qi_unpred);
        quant.unpred = std::move(unpred);
    }

    // Device-path open support: expose the loaded side streams so the
    // device sweep can replay the block recurrence (inverse of
    // adopt_streams; call after load()).
    void export_streams(std::vector<int32_t>& sel, std::vector<int32_t>& regb,
                        std::vector<T>& ql_unpred, std::vector<T>& qi_unpred,
                        std::vector<T>& unpred) const {
        sel = selection_;
        regb = reg_bins_;
        ql_unpred = reg_ql_.unpred;
        qi_unpred = reg_qi_.unpred;
        unpred = quant.unpred;
    }

    // [fallback(nothing)][roster predictors][selection?][quantizer]
    // (reference BlockwiseDecomposition.hpp:69-73)
    void save(Sink& s) {
        for (Pred p : roster)
            if (p == Pred::REGRESSION) save_regression(s);
        if (!single) {
            s.put<size_t>(selection_.size());
            if (!selection_.empty()) {
                Huffman<int32_t> enc;
                enc.build(selection_.data(), selection_.size());
                enc.save(s);
                enc.encode(selection_.data(), selection_.size(), s);
            }
        }
        quant.save(s);
    }

    void load(Source& s) {
        configure();
        for (Pred p : roster)
            if (p == Pred::REGRESSION) load_regression(s);
        if (!single) {
            size_t n = s.template get<size_t>();
            if (n > num_blocks()) throw std::runtime_error("blockwise: selection past the blocks");
            selection_.resize(n);
            if (n) {
                Huffman<int32_t> enc;
                enc.load(s);
                enc.decode(s, n, selection_.data());
            }
            sel_pos_ = 0;
        }
        quant.load(s);
    }

  private:
    double noise1_ = 0, noise2_ = 0;
    LinearQuantizer<T> reg_ql_, reg_qi_;  // linear-term / independent-term coef quantizers
    std::vector<int32_t> reg_bins_;
    size_t reg_pos_ = 0;
    std::vector<int32_t> selection_;
    size_t sel_pos_ = 0;
    std::array<T, N + 1> prev_coef_{}, cur_coef_{};


    // reference LorenzoPredictor.hpp:17-38
    double lorenzo_noise(int order) const {
        static const double n1[5] = {0, 0.5, 0.81, 1.22, 1.79};
        static const double n2[4] = {0, 1.08, 2.76, 6.8};
        if (order == 1) return n1[N] * eb;
        return (N <= 3 ? n2[N] : 0.0) * eb;
    }

    template <class F>
    void sweep_blocks(F&& f) {
        idx_t nblocks, bi{};
        for (int i = 0; i < N; i++) nblocks[i] = (dims[i] + block_size - 1) / block_size;
        while (true) {
            idx_t b0, b1;
            for (int i = 0; i < N; i++) {
                b0[i] = bi[i] * size_t(block_size);
                b1[i] = std::min(b0[i] + block_size, dims[i]);
            }
            f(b0, b1);
            int i = N - 1;
            while (i >= 0 && ++bi[i] == nblocks[i]) bi[i--] = 0;
            if (i < 0) break;
        }
    }

    template <class F>
    void foreach_block(PaddedGrid<T, N>& g, const idx_t& b0, const idx_t& b1, F&& f) {
        const auto& ps = g.pad_stride;
        if constexpr (N == 1) {
            T* d = g.base + b0[0];
            for (size_t i = 0; i < b1[0] - b0[0]; i++) f(d++, idx_t{i});
        } else if constexpr (N == 2) {
            for (size_t i = 0; i < b1[0] - b0[0]; i++) {
                T* d = g.base + (b0[0] + i) * ps[0] + b0[1];
                for (size_t j = 0; j < b1[1] - b0[1]; j++) f(d++, idx_t{i, j});
            }
        } else if constexpr (N == 3) {
            for (size_t i = 0; i < b1[0] - b0[0]; i++)
                for (size_t j = 0; j < b1[1] - b0[1]; j++) {
                    T* d = g.base + (b0[0] + i) * ps[0] + (b0[1] + j) * ps[1] + b0[2];
                    for (size_t k = 0; k < b1[2] - b0[2]; k++) f(d++, idx_t{i, j, k});
                }
        } else {
            for (size_t i = 0; i < b1[0] - b0[0]; i++)
                for (size_t j = 0; j < b1[1] - b0[1]; j++)
                    for (size_t k = 0; k < b1[2] - b0[2]; k++) {
                        T* d = g.base + (b0[0] + i) * ps[0] + (b0[1] + j) * ps[1] +
                               (b0[2] + k) * ps[2] + b0[3];
                        for (size_t l = 0; l < b1[3] - b0[3]; l++) f(d++, idx_t{i, j, k, l});
                    }
        }
    }

    // Diagonal sampling pattern (reference BlockwiseIterator.hpp:151-184).
    template <class F>
    void foreach_sampling(PaddedGrid<T, N>& g, const idx_t& b0, const idx_t& b1, F&& f) {
        size_t m = std::numeric_limits<size_t>::max();
        for (int i = 0; i < N; i++) m = std::min(m, b1[i] - b0[i]);
        auto at = [&](const idx_t& li) {
            size_t off = 0;
            for (int i = 0; i < N; i++) off += (b0[i] + li[i]) * g.pad_stride[i];
            return g.base + off;
        };
        if constexpr (N == 1) {
            f(at({0}), idx_t{0});
            f(at({m - 1}), idx_t{m - 1});
        } else {
            for (size_t i = 0; i < m; i++) {
                size_t j = m - 1 - i;
                if constexpr (N == 2) {
                    f(at({i, i}), idx_t{i, i});
                    f(at({i, j}), idx_t{i, j});
                } else if constexpr (N == 3) {
                    f(at({i, i, i}), idx_t{i, i, i});
                    f(at({i, i, j}), idx_t{i, i, j});
                    f(at({i, j, i}), idx_t{i, j, i});
                    f(at({i, j, j}), idx_t{i, j, j});
                } else {
                    f(at({i, i, i, i}), idx_t{i, i, i, i});
                    f(at({i, i, i, j}), idx_t{i, i, i, j});
                    f(at({i, i, j, i}), idx_t{i, i, j, i});
                    f(at({i, i, j, j}), idx_t{i, i, j, j});
                    f(at({i, j, i, i}), idx_t{i, j, i, i});
                    f(at({i, j, i, j}), idx_t{i, j, i, j});
                    f(at({i, j, j, i}), idx_t{i, j, j, i});
                    f(at({i, j, j, j}), idx_t{i, j, j, j});
                }
            }
        }
    }

    // ---- prediction stencils ------------------------------------------------

    // reference LorenzoPredictor.hpp:60-94 (note the prevK argument/stride
    // pairing; the inclusion-exclusion sums are symmetric so only the exact
    // floating-point summation order matters and is kept).
    T predict(Pred p, T* d, const idx_t& ds, const idx_t& li) const {
        switch (p) {
            case Pred::LORENZO1: return lorenzo1(d, ds);
            case Pred::LORENZO2: return lorenzo2(d, ds);
            default: return regression_predict(li);
        }
    }

    T lorenzo1(T* d, const idx_t& ds) const {
        if constexpr (N == 1) {
            return *(d - 1);
        } else if constexpr (N == 2) {
            auto at = [&](size_t j, size_t i) { return *(d - (j * ds[0] + i)); };
            return at(0, 1) + at(1, 0) - at(1, 1);
        } else if constexpr (N == 3) {
            auto at = [&](size_t k, size_t j, size_t i) { return *(d - (k * ds[1] + j * ds[0] + i)); };
            return at(0, 0, 1) + at(0, 1, 0) + at(1, 0, 0) - at(0, 1, 1) - at(1, 0, 1) -
                   at(1, 1, 0) + at(1, 1, 1);
        } else {
            auto at = [&](size_t t, size_t k, size_t j, size_t i) {
                return *(d - (t * ds[2] + k * ds[1] + j * ds[0] + i));
            };
            return at(0, 0, 0, 1) + at(0, 0, 1, 0) - at(0, 0, 1, 1) + at(0, 1, 0, 0) -
                   at(0, 1, 0, 1) - at(0, 1, 1, 0) + at(0, 1, 1, 1) + at(1, 0, 0, 0) -
                   at(1, 0, 0, 1) - at(1, 0, 1, 0) + at(1, 0, 1, 1) - at(1, 1, 0, 0) +
                   at(1, 1, 0, 1) + at(1, 1, 1, 0) - at(1, 1, 1, 1);
        }
    }

    T lorenzo2(T* d, const idx_t& ds) const {
        if constexpr (N == 1) {
            return 2 * *(d - 1) - *(d - 2);
        } else if constexpr (N == 2) {
            auto at = [&](size_t j, size_t i) { return *(d - (j * ds[0] + i)); };
            return 2 * at(0, 1) - at(0, 2) + 2 * at(1, 0) - 4 * at(1, 1) + 2 * at(1, 2) -
                   at(2, 0) + 2 * at(2, 1) - at(2, 2);
        } else if constexpr (N == 3) {
            auto at = [&](size_t k, size_t j, size_t i) { return *(d - (k * ds[1] + j * ds[0] + i)); };
            return 2 * at(0, 0, 1) - at(0, 0, 2) + 2 * at(0, 1, 0) - 4 * at(0, 1, 1) +
                   2 * at(0, 1, 2) - at(0, 2, 0) + 2 * at(0, 2, 1) - at(0, 2, 2) +
                   2 * at(1, 0, 0) - 4 * at(1, 0, 1) + 2 * at(1, 0, 2) - 4 * at(1, 1, 0) +
                   8 * at(1, 1, 1) - 4 * at(1, 1, 2) + 2 * at(1, 2, 0) - 4 * at(1, 2, 1) +
                   2 * at(1, 2, 2) - at(2, 0, 0) + 2 * at(2, 0, 1) - at(2, 0, 2) +
                   2 * at(2, 1, 0) - 4 * at(2, 1, 1) + 2 * at(2, 1, 2) - at(2, 2, 0) +
                   2 * at(2, 2, 1) - at(2, 2, 2);
        } else {
            return T(0);  // 2nd-order 4D unsupported in reference too
        }
    }

    // reference RegressionPredictor.hpp:77-92
    T regression_predict(const idx_t& li) const {
        if constexpr (N == 1) {
            return cur_coef_[0] * li[0] + cur_coef_[1];
        } else if constexpr (N == 2) {
            return cur_coef_[0] * li[0] + cur_coef_[1] * li[1] + cur_coef_[2];
        } else if constexpr (N == 3) {
            return cur_coef_[0] * li[0] + cur_coef_[1] * li[1] + cur_coef_[2] * li[2] + cur_coef_[3];
        } else {
            return cur_coef_[0] * li[0] + cur_coef_[1] * li[1] + cur_coef_[2] * li[2] +
                   cur_coef_[3] * li[3] + cur_coef_[4];
        }
    }

    // Closed-form least-squares plane fit (reference RegressionPredictor.hpp:28-55).
    bool regression_fit(PaddedGrid<T, N>& g, const idx_t& b0, const idx_t& b1) {
        std::array<double, N> bd{};
        double nelem = 1;
        for (int i = 0; i < N; i++) {
            bd[i] = double(b1[i] - b0[i]);
            if (bd[i] <= 1) return false;
            nelem *= bd[i];
        }
        std::array<double, N + 1> sum{};
        foreach_block(g, b0, b1, [&](T* c, const idx_t& li) {
            // the reference accumulates index[i] * (*c) with index a size_t
            // (RegressionPredictor.hpp:43): for integral T the usual
            // conversions wrap the product in uint64, for floating T the
            // index converts to T — replicate both exactly
            for (int i = 0; i < N; i++) {
                if constexpr (std::is_integral_v<T>)
                    sum[i] += double(li[i] * size_t(*c));
                else
                    sum[i] += T(li[i]) * (*c);
            }
            sum[N] += *c;
        });
        cur_coef_.fill(T(0));
        cur_coef_[N] = T(sum[N] / nelem);
        for (int i = 0; i < N; i++) {
            cur_coef_[i] = T((2 * sum[i] / (bd[i] - 1) - sum[N]) * 6 / nelem / (bd[i] + 1));
            cur_coef_[N] = T(cur_coef_[N] - (bd[i] - 1) * cur_coef_[i] / 2);
        }
        return true;
    }

    // reference RegressionPredictor.hpp:148-155
    void regression_commit() {
        for (int i = 0; i < N; i++) reg_bins_.push_back(reg_ql_.quantize(cur_coef_[i], prev_coef_[i]));
        reg_bins_.push_back(reg_qi_.quantize(cur_coef_[N], prev_coef_[N]));
        prev_coef_ = cur_coef_;
    }

    // reference RegressionPredictor.hpp:157-164
    void regression_recover() {
        if (reg_pos_ + N + 1 > reg_bins_.size())
            throw std::runtime_error("blockwise: coefficient stream too short");
        for (int i = 0; i < N; i++)
            cur_coef_[i] = reg_ql_.recover(cur_coef_[i], reg_bins_[reg_pos_++]);
        cur_coef_[N] = reg_qi_.recover(cur_coef_[N], reg_bins_[reg_pos_++]);
    }

    bool block_valid_for_regression(const idx_t& b0, const idx_t& b1) const {
        for (int i = 0; i < N; i++)
            if (b1[i] - b0[i] <= 1) return false;
        return true;
    }

    // Select predictor for a block (composed: ComposedPredictor.hpp:25-40).
    bool select_block(PaddedGrid<T, N>& g, const idx_t& b0, const idx_t& b1, Pred& out) {
        if (single) {
            out = roster[0];
            if (out == Pred::REGRESSION) {
                if (!regression_fit(g, b0, b1)) return false;
                regression_commit();
            }
            return true;
        }
        size_t np = roster.size();
        std::vector<double> err(np, 0);
        std::vector<bool> valid(np);
        for (size_t i = 0; i < np; i++) {
            Pred p = roster[i];
            valid[i] = (p == Pred::REGRESSION) ? regression_fit(g, b0, b1) : true;
            if (!valid[i]) {
                err[i] = std::numeric_limits<double>::max();
                continue;
            }
            foreach_sampling(g, b0, b1, [&](T* c, const idx_t& li) {
                // estimate_error: |x - pred| (+ noise for Lorenzo), narrowed to
                // T before accumulation (LorenzoPredictor.hpp:56-58)
                T e;
                if (p == Pred::LORENZO1)
                    e = T(std::fabs(*c - lorenzo1(c, g.pad_stride)) + T(noise1_));
                else if (p == Pred::LORENZO2)
                    e = T(std::fabs(*c - lorenzo2(c, g.pad_stride)) + T(noise2_));
                else
                    e = T(std::fabs(*c - regression_predict(li)));
                err[i] += e;
            });
        }
        size_t sid = 0;
        for (size_t i = 1; i < np; i++)
            if (err[i] < err[sid]) sid = i;
        out = roster[sid];
        sid_ = int(sid);
        return valid[sid];
    }

    void commit_block(Pred active) {
        if (!single) {
            selection_.push_back(sid_);
            if (active == Pred::REGRESSION) regression_commit();
        }
        // single-predictor regression commits inside select_block
    }

    bool select_block_decompress(const idx_t& b0, const idx_t& b1, Pred& out) {
        if (single) {
            out = roster[0];
            if (out == Pred::REGRESSION) {
                if (!block_valid_for_regression(b0, b1)) return false;
                regression_recover();
            }
            return true;
        }
        if (sel_pos_ >= selection_.size() || uint32_t(selection_[sel_pos_]) >= roster.size())
            throw std::runtime_error("blockwise: selection stream too short or out of range");
        out = roster[selection_[sel_pos_++]];
        if (out == Pred::REGRESSION) regression_recover();
        return true;
    }

    void save_regression(Sink& s) {
        s.put<size_t>(reg_bins_.size());
        if (!reg_bins_.empty()) {
            reg_qi_.save(s);
            reg_ql_.save(s);
            Huffman<int32_t> enc;
            enc.build(reg_bins_.data(), reg_bins_.size());
            enc.save(s);
            enc.encode(reg_bins_.data(), reg_bins_.size(), s);
        }
    }

    void load_regression(Source& s) {
        size_t n = s.template get<size_t>();
        if (n > (N + 1) * num_blocks())
            throw std::runtime_error("blockwise: coefficients past the blocks");
        reg_bins_.resize(n);
        if (n) {
            reg_qi_.load(s);
            reg_ql_.load(s);
            Huffman<int32_t> enc;
            enc.load(s);
            enc.decode(s, n, reg_bins_.data());
            cur_coef_.fill(T(0));
            reg_pos_ = 0;
        }
    }

    int sid_ = 0;
};

}  // namespace szt
#endif
