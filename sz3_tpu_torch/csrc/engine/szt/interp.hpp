// Multi-level spline-interpolation decomposition (the default SZ3 algorithm).
//
// Behavior contract: reference decomposition/InterpolationDecomposition.hpp.
//  - level schedule & eb scaling: :100-117 (compress), :39-53 (decompress)
//  - anchor grid: :215-233 (saved losslessly as unpred literals, bins = 0)
//  - per-level block sweep of size blocksize*stride over the global grid,
//    blocks visited row-major (:121-135 via utils/Iterator.hpp)
//  - per block: N directional passes in the order of the chosen dimension
//    permutation (:429-450); each pass predicts the odd multiples of the
//    level stride along that direction from already-known points
//  - 1D/2D use the ICDE'21 per-line API (:247-293); 3D/4D the SIGMOD'24
//    fastest-dim-first API (:309-402)
//  - basis functions: utils/Interpolators.hpp:12-39 (T-precision arithmetic,
//    except linear1 which promotes to double)
// Serialized state: [dims u64xN][blocksize u32][interp_id i32][direction i32]
// [anchor_stride u64][alpha f64][beta f64][quantizer] (:149-159).
//
// All points within one (level, pass, boundary-phase) are independent given
// previous phases; the TPU path exploits exactly this structure (see
// sz3_tpu/ops/interp_plan.py). This host codec is the bit-exact scalar engine.
#ifndef SZT_INTERP_HPP
#define SZT_INTERP_HPP

#include <algorithm>
#include <array>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>
#include <vector>

#include "common.hpp"
#include "quantizer.hpp"

namespace szt {

template <class T, int N>
class InterpCodec {
  public:
    using idx_t = std::array<size_t, N>;

    std::array<size_t, N> dims{};
    uint32_t blocksize = 32;  // empirical fixed value (reference :85)
    int32_t interp_id = 1;    // 0 linear, 1 cubic
    int32_t direction = 0;    // index into dimension permutations
    size_t anchor_stride = 0;
    double alpha = -1, beta = -1;
    static constexpr double kLegacyEbRatio = 0.5;

    LinearQuantizer<T> quant;

    size_t num_elements() const {
        size_t n = 1;
        for (auto d : dims) n *= d;
        return n;
    }

    // ---- public pipeline hooks ---------------------------------------------

    // Fill quant_out (num_elements entries) and overwrite data with its
    // reconstruction. Unpred literals accumulate in `quant` across calls
    // (deliberate: the tuner compresses several sampled blocks back to back
    // and serializes the union, reference SZAlgoInterp.hpp:43-76).
    void compress(T* data, int32_t* quant_out) { compress_into(data, data, quant_out); }

    // Same sweep without mutating the source: reconstructions land in `work`
    // (uninitialized, num_elements); predictions read `work` (coarser levels
    // are already reconstructed there), original values read `src` at the
    // mirrored offset. Bit-identical to the in-place sweep — lets the
    // dispatcher skip its defensive full-array copy. Interior points run
    // through the branch-free bulk kernels (see BulkCompress).
    void compress_into(const T* src, T* work, int32_t* quant_out) {
        init();
        qbuf_ = quant_out;
        qpos_ = 0;
        const ptrdiff_t delta = src - work;
        double eb = quant.eb();
        if (anchor_stride == 0) {
            qbuf_[qpos_++] = quant.quantize_from(*(work + delta), T(0), *work);
        } else {
            foreach_anchor(work, [&](T* d) {
                *d = *(d + delta);
                qbuf_[qpos_++] = quant.save_literal(*d);
            });
            levels_--;
        }
        BulkCompress fn{this, delta};
        level_loop(work, eb, fn);
        quant.set_eb(eb);
    }

    void decompress(const int32_t* quant_in, T* out) {
        init();
        double eb = quant.eb();
        if (anchor_stride == 0) {
            *out = quant.recover(T(0), quant_in[qpos_++]);
        } else {
            foreach_anchor(out, [&](T* d) {
                *d = quant.recover_unpred();
                qpos_++;
            });
            levels_--;
        }
        BulkRecover fn{this, quant_in};
        level_loop(out, eb, fn);
    }

    // Visit every stream slot in archive order without touching the
    // quantizer: on_anchor(ptr) for anchor-grid literals, on_point(ptr, pred)
    // for quantized points. Instantiated over the int32 bins grid by the
    // device-path bridge (emit/place): the traversal is data-independent, so
    // walking the bins grid yields the exact reference stream order.
    template <class FA, class FP>
    void traverse(T* grid, FA&& on_anchor, FP&& on_point) {
        init();
        if (anchor_stride == 0) {
            on_point(grid, T(0));
        } else {
            foreach_anchor(grid, on_anchor);
            levels_--;
        }
        level_loop(grid, quant.eb(), on_point);
    }

    // Apply the init-time clamp of anchor_stride (disabled when every dim
    // fits inside one anchor cell, reference :187-192) without traversing.
    void resolve_params() { init(); }

    void save(Sink& s) const {
        s.put_n(dims.data(), N);
        s.put(blocksize);
        s.put(interp_id);
        s.put(direction);
        s.put<size_t>(anchor_stride);
        s.put(alpha);
        s.put(beta);
        quant.save(s);
    }

    // The dims set before load() (the archive Config's) must be the payload's.
    void load(Source& s) {
        const std::array<size_t, N> want = dims;
        s.get_n(dims.data(), N);
        if (dims != want) throw std::runtime_error("interp: payload dims differ from the Config's");
        blocksize = s.template get<uint32_t>();
        interp_id = s.template get<int32_t>();
        direction = s.template get<int32_t>();
        int perms = 1;  // N! dimension orders (1D never reads the direction)
        for (int i = 2; i <= N; i++) perms *= i;
        if (blocksize == 0 || blocksize > (1u << 20) ||
            (N > 1 && (direction < 0 || direction >= perms)))
            throw std::runtime_error("interp: bad block size or direction");
        anchor_stride = s.template get<size_t>();
        alpha = s.template get<double>();
        beta = s.template get<double>();
        quant.load(s);
        qpos_ = 0;
    }

    size_t quant_consumed() const { return qpos_; }

    // ---- bulk (branch-free, vectorizable) point kernels ---------------------
    // Interior points of a pass read only the coarser grid, so a whole inner
    // row can run without the quantizer's data-dependent branch: compute
    // bins/reconstructions unconditionally, then fix the (rare) unpredictable
    // points in stream order. Arithmetic mirrors LinearQuantizer exactly
    // (the int cast is clamped like the device kernel; semantics unchanged).
    // NOTE: no bulk_tag here — the branch-free compress kernel measured
    // SLOWER than the branchy scalar on x86 (the verify chain doesn't
    // auto-vectorize with runtime strides, and the unpred branch predicts
    // ~perfectly), so compression stays scalar; decode keeps its bulk path
    // (see BulkRecover), which did win.
    struct BulkCompress {
        InterpCodec* s;
        ptrdiff_t delta;  // src - work

        inline void operator()(T* d, T pred) {
            s->qbuf_[s->qpos_++] = s->quant.quantize_from(*(d + delta), pred, *d);
        }

        template <class P>
        inline void run(T* d0, size_t m, size_t st, P&& pred_of) {
            LinearQuantizer<T>& q = s->quant;
            const double eb = q.eb(), recip = q.recip();
            const int radius = q.radius();
            const double clampv = double(2 * radius);
            const ptrdiff_t dl = delta;
            int32_t* qout = s->qbuf_ + s->qpos_;
            bool any_unpred = false;
            for (size_t t = 0; t < m; t++) {
                T* d = d0 + t * st;
                T pred = pred_of(d);
                T orig = *(d + dl);
                T diff = orig - pred;
                double scaled = std::fabs(double(diff)) * recip;
                // NaN compares false -> clamp, same as fmin(NaN, clamp)
                double sc = scaled < clampv ? scaled : clampv;
                int32_t qi = int32_t(sc) + 1;
                int32_t half = qi >> 1;
                int32_t qe = half << 1;
                bool neg = diff < T(0);
                T dec = T(double(pred) + double(neg ? -qe : qe) * eb);
                double err = std::fabs(double(dec - orig));
                bool ok = (qi < 2 * radius) & (err <= eb);
                qout[t] = ok ? (neg ? radius - half : radius + half) : 0;
                *d = ok ? dec : orig;
                any_unpred |= !ok;
            }
            s->qpos_ += m;
            if (any_unpred)
                for (size_t t = 0; t < m; t++)
                    if (!qout[t]) q.push_unpred(*(d0 + t * st));
        }
    };

    struct BulkRecover {
        using bulk_tag = void;
        InterpCodec* s;
        const int32_t* qin;

        inline void operator()(T* d, T pred) { *d = s->quant.recover(pred, qin[s->qpos_++]); }

        template <class P>
        inline void run(T* d0, size_t m, size_t st, P&& pred_of) {
            LinearQuantizer<T>& q = s->quant;
            const double eb = q.eb();
            const int radius = q.radius();
            const int32_t* qrow = qin + s->qpos_;
            bool any_zero = false;
            // interior predictions read only coarse (even) positions, never
            // this pass's outputs, so provisional writes for bin-0 lanes are
            // harmless and get fixed in stream order below
            for (size_t t = 0; t < m; t++) {
                T* d = d0 + t * st;
                int32_t b = qrow[t];
                T pred = pred_of(d);
                *d = T(double(pred) + double(2 * (int64_t(b) - radius)) * eb);
                any_zero |= (b == 0);
            }
            s->qpos_ += m;
            if (any_zero)
                for (size_t t = 0; t < m; t++)
                    if (!qrow[t]) *(d0 + t * st) = q.recover_unpred();
        }
    };

    template <class F, class = void>
    struct has_bulk : std::false_type {};
    template <class F>
    struct has_bulk<F, std::void_t<typename F::bulk_tag>> : std::true_type {};

  private:
    int levels_ = -1;
    idx_t offs_{};
    std::vector<std::array<int, N>> seqs_;
    int32_t* qbuf_ = nullptr;
    size_t qpos_ = 0;

    // Reference InterpolationDecomposition.hpp:176-213.
    void init() {
        qpos_ = 0;
        levels_ = -1;
        bool use_anchor = false;
        for (int i = 0; i < N; i++) {
            int l = int(std::ceil(std::log2(double(dims[i]))));
            if (levels_ < l) levels_ = l;
            if (dims[i] > anchor_stride) use_anchor = true;
        }
        if (!use_anchor) anchor_stride = 0;
        if (anchor_stride > 0) {
            int max_level = int(std::log2(double(anchor_stride))) + 1;
            if (max_level <= levels_) levels_ = max_level;
        }
        offs_[N - 1] = 1;
        for (int i = N - 2; i >= 0; i--) offs_[i] = offs_[i + 1] * dims[i + 1];
        seqs_.clear();
        std::array<int, N> seq;
        for (int i = 0; i < N; i++) seq[i] = i;
        do {
            seqs_.push_back(seq);
        } while (std::next_permutation(seq.begin(), seq.end()));
    }

    // Per-level eb schedule (reference :100-116).
    template <class F>
    void level_loop(T* data, double eb, F&& f) {
        for (int level = levels_; level > 0 && level <= levels_; level--) {
            double cur_eb = eb;
            if (alpha < 0) {
                cur_eb = level >= 3 ? eb * kLegacyEbRatio : eb;
            } else if (alpha >= 1) {
                double ratio = std::pow(alpha, level - 1);
                if (ratio > beta) ratio = beta;
                cur_eb = eb / ratio;
            }
            quant.set_eb(cur_eb);
            size_t stride = size_t(1) << (level - 1);
            size_t ibs = blocksize * stride;
            // row-major sweep of interp blocks of edge ibs
            idx_t nblocks;
            for (int i = 0; i < N; i++) nblocks[i] = (dims[i] - 1) / ibs + 1;
            idx_t bi{};
            while (true) {
                idx_t begin, end;
                for (int i = 0; i < N; i++) {
                    begin[i] = bi[i] * ibs;
                    end[i] = std::min(begin[i] + ibs, dims[i] - 1);
                }
                block_interpolation(data, begin, end, stride, f);
                int i = N - 1;
                while (i >= 0 && ++bi[i] == nblocks[i]) bi[i--] = 0;
                if (i < 0) break;
            }
        }
    }

    template <class F>
    void foreach_anchor(T* data, F&& f) {
        idx_t i{};
        while (true) {
            size_t off = 0;
            for (int k = 0; k < N; k++) off += i[k] * offs_[k];
            f(data + off);
            int k = N - 1;
            while (k >= 0 && (i[k] += anchor_stride) >= dims[k]) i[k--] = 0;
            if (k < 0) break;
        }
    }

    // ---- interpolation basis (reference utils/Interpolators.hpp) ----------
    static inline T ip_linear(T a, T b) { return (a + b) / 2; }
    static inline T ip_linear1(T a, T b) { return T(-0.5 * a + 1.5 * b); }
    static inline T ip_quad1(T a, T b, T c) { return (3 * a + 6 * b - c) / 8; }
    static inline T ip_quad2(T a, T b, T c) { return (-a + 6 * b + 3 * c) / 8; }
    static inline T ip_quad3(T a, T b, T c) { return (3 * a - 10 * b + 15 * c) / 8; }
    static inline T ip_cubic(T a, T b, T c, T d) { return (-a + 9 * b + 9 * c - d) / 16; }

    // ---- per-block dispatch (reference :404-454) ---------------------------
    template <class F>
    void block_interpolation(T* data, const idx_t& begin, const idx_t& end, size_t stride, F&& f) {
        if constexpr (N == 1) {
            line_1d(data, begin[0], end[0], stride, f);
        } else if constexpr (N == 2) {
            size_t s2 = stride * 2;
            const auto& dm = seqs_[direction];
            for (size_t j = (begin[dm[1]] ? begin[dm[1]] + s2 : 0); j <= end[dm[1]]; j += s2) {
                size_t bo = begin[dm[0]] * offs_[dm[0]] + j * offs_[dm[1]];
                line_1d(data, bo, bo + (end[dm[0]] - begin[dm[0]]) * offs_[dm[0]],
                        stride * offs_[dm[0]], f);
            }
            for (size_t i = (begin[dm[0]] ? begin[dm[0]] + stride : 0); i <= end[dm[0]]; i += stride) {
                size_t bo = i * offs_[dm[0]] + begin[dm[1]] * offs_[dm[1]];
                line_1d(data, bo, bo + (end[dm[1]] - begin[dm[1]]) * offs_[dm[1]],
                        stride * offs_[dm[1]], f);
            }
        } else {
            size_t s2 = stride * 2;
            const auto& dm = seqs_[direction];
            idx_t strides{}, b = begin;
            strides[dm[0]] = 1;
            for (int i = 1; i < N; i++) {
                b[dm[i]] = begin[dm[i]] ? begin[dm[i]] + s2 : 0;
                strides[dm[i]] = s2;
            }
            pass_nd(data, b, end, dm[0], strides, stride, f);
            for (int i = 1; i < N; i++) {
                b[dm[i]] = begin[dm[i]];
                b[dm[i - 1]] = begin[dm[i - 1]] ? begin[dm[i - 1]] + stride : 0;
                strides[dm[i - 1]] = stride;
                pass_nd(data, b, end, dm[i], strides, stride, f);
            }
        }
    }

    // ICDE'21 per-line kernel (reference :247-293). `begin`/`end` are linear
    // offsets; `stride` a linear element stride.
    template <class F>
    void line_1d(T* data, size_t begin, size_t end, size_t stride, F&& f) {
        size_t n = (end - begin) / stride + 1;
        if (n <= 1) return;
        size_t s1 = stride, s3 = 3 * stride, s5 = 5 * stride;
        if (interp_id == 0 || n < 5) {
            if constexpr (has_bulk<std::decay_t<F>>::value) {
                size_t m = (n - 1) / 2;
                if (m)
                    f.run(data + begin + stride, m, 2 * stride,
                          [&](T* d) { return ip_linear(*(d - s1), *(d + s1)); });
            } else {
                for (size_t i = 1; i + 1 < n; i += 2) {
                    T* d = data + begin + i * stride;
                    f(d, ip_linear(*(d - s1), *(d + s1)));
                }
            }
            if (n % 2 == 0) {
                T* d = data + begin + (n - 1) * stride;
                if (n < 4) f(d, *(d - s1));
                else f(d, ip_linear1(*(d - s3), *(d - s1)));
            }
        } else {
            T* d;
            size_t i = 3;
            if constexpr (has_bulk<std::decay_t<F>>::value) {
                size_t m = n >= 7 ? (n - 7) / 2 + 1 : 0;
                if (m) {
                    f.run(data + begin + 3 * stride, m, 2 * stride, [&](T* dd) {
                        return ip_cubic(*(dd - s3), *(dd - s1), *(dd + s1), *(dd + s3));
                    });
                    i = 3 + 2 * m;
                }
            } else {
                for (; i + 3 < n; i += 2) {
                    d = data + begin + i * stride;
                    f(d, ip_cubic(*(d - s3), *(d - s1), *(d + s1), *(d + s3)));
                }
            }
            d = data + begin + stride;
            f(d, ip_quad1(*(d - s1), *(d + s1), *(d + s3)));
            d = data + begin + i * stride;
            f(d, ip_quad2(*(d - s3), *(d - s1), *(d + s1)));
            if (n % 2 == 0) {
                d = data + begin + (n - 1) * stride;
                f(d, ip_quad3(*(d - s5), *(d - s3), *(d - s1)));
            }
        }
    }

    // SIGMOD'24 fastest-dim-first kernel (reference :309-402): performs every
    // 1D interpolation along `dd` inside [begin_idx, end_idx], sweeping the
    // other dims as an outer grid. Main run first, then boundary phases in
    // the reference's fixed order {1, n-2 | n-3, n-1}.
    template <class F>
    void pass_nd(T* data, const idx_t& begin_idx, const idx_t& end_idx, int dd, idx_t strides,
                 size_t math_stride, F&& f) {
        for (int i = 0; i < N; i++)
            if (end_idx[i] < begin_idx[i]) return;
        size_t n = (end_idx[dd] - begin_idx[dd]) / math_stride + 1;
        if (n <= 1) return;
        size_t offset = 0;
        size_t stride = math_stride * offs_[dd];
        idx_t begins{}, ends, dof;
        for (int i = 0; i < N; i++) {
            ends[i] = end_idx[i] - begin_idx[i] + 1;
            dof[i] = offs_[i];
            offset += offs_[i] * begin_idx[i];
        }
        dof[dd] = stride;
        size_t s2 = 2 * stride;
        if (interp_id == 0) {  // linear
            begins[dd] = 1;
            ends[dd] = n - 1;
            strides[dd] = 2;
            if constexpr (has_bulk<std::decay_t<F>>::value) {
                foreach_rows(data, offset, begins, ends, strides, dof,
                             [&](T* row, size_t m, size_t rst) {
                                 f.run(row, m, rst, [&](T* d) {
                                     return ip_linear(*(d - stride), *(d + stride));
                                 });
                             });
            } else {
                foreach_grid(data, offset, begins, ends, strides, dof,
                             [&](T* d) { f(d, ip_linear(*(d - stride), *(d + stride))); });
            }
            if (n % 2 == 0) {
                begins[dd] = n - 1;
                ends[dd] = n;
                foreach_grid(data, offset, begins, ends, strides, dof, [&](T* d) {
                    if (n < 3) f(d, *(d - stride));
                    else f(d, ip_linear1(*(d - s2), *(d - stride)));
                });
            }
        } else {  // cubic
            size_t s3 = 3 * stride;
            begins[dd] = 3;
            ends[dd] = (n >= 3) ? (n - 3) : 0;
            strides[dd] = 2;
            if constexpr (has_bulk<std::decay_t<F>>::value) {
                foreach_rows(data, offset, begins, ends, strides, dof,
                             [&](T* row, size_t m, size_t rst) {
                                 f.run(row, m, rst, [&](T* d) {
                                     return ip_cubic(*(d - s3), *(d - stride), *(d + stride),
                                                     *(d + s3));
                                 });
                             });
            } else {
                foreach_grid(data, offset, begins, ends, strides, dof, [&](T* d) {
                    f(d, ip_cubic(*(d - s3), *(d - stride), *(d + stride), *(d + s3)));
                });
            }
            size_t bounds[3];
            int nb = 0;
            bounds[nb++] = 1;
            if (n % 2 == 1 && n > 3) bounds[nb++] = n - 2;
            if (n % 2 == 0 && n > 4) bounds[nb++] = n - 3;
            if (n % 2 == 0 && n > 2) bounds[nb++] = n - 1;
            for (int k = 0; k < nb; k++) {
                size_t b = bounds[k];
                begins[dd] = b;
                ends[dd] = b + 1;
                foreach_grid(data, offset, begins, ends, strides, dof, [&](T* d) {
                    if (b >= 3) {
                        if (b + 3 < n)
                            f(d, ip_cubic(*(d - s3), *(d - stride), *(d + stride), *(d + s3)));
                        else if (b + 1 < n)
                            f(d, ip_quad2(*(d - s3), *(d - stride), *(d + stride)));
                        else
                            f(d, ip_linear1(*(d - s3), *(d - stride)));
                    } else {
                        if (b + 3 < n)
                            f(d, ip_quad1(*(d - stride), *(d + stride), *(d + s3)));
                        else if (b + 1 < n)
                            f(d, ip_linear(*(d - stride), *(d + stride)));
                        else
                            f(d, *(d - stride));
                    }
                });
            }
        }
    }

    // Like foreach_grid but hands whole inner rows (count + element step) to
    // the callback, for the bulk point kernels.
    template <class G>
    static void foreach_rows(T* data, size_t offset, const idx_t& begins, const idx_t& ends,
                             const idx_t& strides, const idx_t& dof, G&& g) {
        size_t m = ends[N - 1] > begins[N - 1]
                       ? (ends[N - 1] - begins[N - 1] + strides[N - 1] - 1) / strides[N - 1]
                       : 0;
        if (!m) return;
        size_t rst = strides[N - 1] * dof[N - 1];
        size_t base = offset + begins[N - 1] * dof[N - 1];
        if constexpr (N == 1) {
            g(data + base, m, rst);
        } else if constexpr (N == 2) {
            for (size_t i = begins[0]; i < ends[0]; i += strides[0])
                g(data + base + i * dof[0], m, rst);
        } else if constexpr (N == 3) {
            for (size_t i = begins[0]; i < ends[0]; i += strides[0])
                for (size_t j = begins[1]; j < ends[1]; j += strides[1])
                    g(data + base + i * dof[0] + j * dof[1], m, rst);
        } else {
            for (size_t i = begins[0]; i < ends[0]; i += strides[0])
                for (size_t j = begins[1]; j < ends[1]; j += strides[1])
                    for (size_t k = begins[2]; k < ends[2]; k += strides[2])
                        g(data + base + i * dof[0] + j * dof[1] + k * dof[2], m, rst);
        }
    }

    // Row-major strided grid walk (reference utils/BlockwiseIterator.hpp:283-322).
    template <class F>
    static void foreach_grid(T* data, size_t offset, const idx_t& begins, const idx_t& ends,
                             const idx_t& strides, const idx_t& dof, F&& f) {
        if constexpr (N == 1) {
            for (size_t i = begins[0]; i < ends[0]; i += strides[0]) f(data + offset + i * dof[0]);
        } else if constexpr (N == 2) {
            for (size_t i = begins[0]; i < ends[0]; i += strides[0])
                for (size_t j = begins[1]; j < ends[1]; j += strides[1])
                    f(data + offset + i * dof[0] + j * dof[1]);
        } else if constexpr (N == 3) {
            for (size_t i = begins[0]; i < ends[0]; i += strides[0])
                for (size_t j = begins[1]; j < ends[1]; j += strides[1])
                    for (size_t k = begins[2]; k < ends[2]; k += strides[2])
                        f(data + offset + i * dof[0] + j * dof[1] + k * dof[2]);
        } else {
            for (size_t i = begins[0]; i < ends[0]; i += strides[0])
                for (size_t j = begins[1]; j < ends[1]; j += strides[1])
                    for (size_t k = begins[2]; k < ends[2]; k += strides[2])
                        for (size_t l = begins[3]; l < ends[3]; l += strides[3])
                            f(data + offset + i * dof[0] + j * dof[1] + k * dof[2] + l * dof[3]);
        }
    }
};

}  // namespace szt
#endif
