// Optimal 1D k-means (monotone-matrix DP via divide & conquer) and the MDZ
// level detector.
//
// Behavior contract (reference utils/KmeansUtil.hpp):
//  - cluster(): DP over sorted samples with monotone row minima; k grows until
//    the cost-ratio heuristic D(k-1)/D(k) / running-average > 1.5 stops
//    firing (:179-207); centroids by backtracking (:222-239).
//  - get_cluster(): samples the data, runs cluster() with trial k=150; if no
//    clean cluster count is found level_num=0 (:286-338); level grid params
//    derived from the centroid extremes + mean adjustment (:358-364).
// Divergence: the reference samples with std::random_device (non-
// deterministic archives); this implementation uses a fixed mt19937 seed so
// identical inputs give identical streams — required by our determinism gate.
#ifndef SZT_KMEANS_HPP
#define SZT_KMEANS_HPP

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <functional>
#include <numeric>
#include <random>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace szt {

namespace kmeans1d {

// Row-minima of the implicitly-defined totally monotone DP matrix via
// divide-and-conquer: total monotonicity makes the (smallest-index) argmin
// non-decreasing in the row index, so solving the middle row pins the
// search range for each half. O(n log n) per DP layer — plenty for the
// <=20k-sample, k<=150 clustering this feeds — and structurally independent
// of the reference's SMAWK formulation while producing identical argmins
// (same cost values, same smallest-index tie-breaking).
template <typename T>
void monotone_argmin_rec(size_t row_lo, size_t row_hi, size_t col_lo, size_t col_hi,
                         const std::function<T(size_t, size_t)>& lookup,
                         std::vector<size_t>& result) {
    if (row_lo >= row_hi) return;
    size_t mid = row_lo + (row_hi - row_lo) / 2;
    size_t best = col_lo;
    T best_v = lookup(mid, col_lo);
    for (size_t c = col_lo + 1; c <= col_hi; ++c) {
        T v = lookup(mid, c);
        if (v < best_v) {
            best_v = v;
            best = c;
        }
    }
    result[mid] = best;
    monotone_argmin_rec(row_lo, mid, col_lo, best, lookup, result);
    monotone_argmin_rec(mid + 1, row_hi, best, col_hi, lookup, result);
}

template <typename T>
std::vector<size_t> monotone_argmin(size_t num_rows, size_t num_cols,
                          const std::function<T(size_t, size_t)>& lookup) {
    std::vector<size_t> result(num_rows);
    if (num_rows && num_cols)
        monotone_argmin_rec<T>(0, num_rows, 0, num_cols - 1, lookup, result);
    return result;
}

// within-cluster cost in O(1) via prefix sums
class CostCalculator {
  public:
    CostCalculator(const float* v, size_t n) : cumsum(n + 1, 0.0), cumsum2(n + 1, 0.0) {
        for (size_t i = 0; i < n; ++i) {
            double x = v[i];
            cumsum[i + 1] = x + cumsum[i];
            cumsum2[i + 1] = x * x + cumsum2[i];
        }
    }
    double calc(size_t i, size_t j) const {
        if (j < i) return 0.0;
        double mu = (cumsum[j + 1] - cumsum[i]) / double(j - i + 1);
        return cumsum2[j + 1] - cumsum2[i] + double(j - i + 1) * mu * mu -
               2 * mu * (cumsum[j + 1] - cumsum[i]);
    }

  private:
    std::vector<double> cumsum, cumsum2;
};

// Optimal 1D k-means with automatic k via the reference's ratio heuristic.
// On success k is rewritten to the detected count and centroids[0..k) filled;
// k left at its input value means "no clusters found".
inline void cluster(float* array, size_t n, int& k, float* centroids) {
    std::vector<size_t> sort_idx(n);
    std::iota(sort_idx.begin(), sort_idx.end(), 0);
    std::sort(sort_idx.begin(), sort_idx.end(),
              [&](size_t a, size_t b) { return array[a] < array[b]; });
    std::vector<float> sorted(n);
    for (size_t i = 0; i < n; ++i) sorted[i] = array[sort_idx[i]];

    CostCalculator cost(sorted.data(), n);
    std::vector<float> D(size_t(k) * n);
    std::vector<size_t> T(size_t(k) * n);
    for (size_t i = 0; i < n; ++i) {
        D[i] = float(cost.calc(0, i));
        T[i] = 0;
    }

    double ratio_avg = 0;
    bool found = false;
    size_t bestk = 0;
    for (int k_ = 1; k_ < k; ++k_) {
        auto C = [&](size_t i, size_t j) -> float {
            size_t col = i < j - 1 ? i : j - 1;
            return D[size_t(k_ - 1) * n + col] + float(cost.calc(j, i));
        };
        std::vector<size_t> argmins = monotone_argmin<float>(n, n, C);
        for (size_t i = 0; i < n; ++i) {
            D[size_t(k_) * n + i] = C(i, argmins[i]);
            T[size_t(k_) * n + i] = argmins[i];
        }
        float ratio = D[size_t(k_ - 1) * n + n - 1] / D[size_t(k_) * n + n - 1];
        ratio_avg = (ratio_avg * (k_ - 1) + ratio) / k_;
        if (ratio / ratio_avg > 1.5) {
            bestk = size_t(k_) + 1;
            found = true;
        } else if (found) {
            break;
        }
    }
    if (!found) return;
    k = int(bestk);

    size_t t = n, k_ = bestk - 1, n_ = n - 1;
    do {
        size_t t_ = t;
        t = T[k_ * n + n_];
        float centroid = 0.0f;
        for (size_t i = t; i < t_; ++i) centroid += (sorted[i] - centroid) / float(i - t + 1);
        centroids[k_] = centroid;
        k_ -= 1;
        n_ = t - 1;
    } while (t > 0);
}

}  // namespace kmeans1d

// Level-grid detection for MDZ VQ (reference KmeansUtil.hpp:286-365).
template <class T>
void get_cluster(const T* data, size_t num, float& level_start, float& level_offset,
                 int& level_num, size_t sample_num) {
    T maxv = *std::max_element(data, data + num);
    std::vector<float> sample;
    if (num <= sample_num) {
        sample.assign(data, data + num);
        sample_num = num;
    } else {
        sample.resize(sample_num);
        std::mt19937 gen(42);  // deterministic (see header note)
        std::uniform_int_distribution<size_t> dis(0, num - 1);
        std::unordered_set<size_t> seen;
        for (size_t i = 0; i < sample_num; i++) {
            size_t idx;
            do {
                idx = dis(gen);
            } while (seen.count(idx));
            seen.insert(idx);
            sample[i] = float(data[idx]);
        }
    }

    int k = 150;
    std::vector<float> cents(k);
    kmeans1d::cluster(sample.data(), sample_num, k, cents.data());
    if (k == 150) {
        level_num = 0;
        return;
    }
    level_offset = (cents[k - 1] - cents[0]) / float(k - 1);
    level_start = cents[0];
    for (int i = 1; i < k; i++) level_start += cents[i] - i * level_offset;
    level_start /= float(k);
    level_num = int(std::round((double(maxv) - level_start) / level_offset)) + 1;
}

}  // namespace szt
#endif
