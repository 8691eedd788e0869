// The encode passes of the interpolation decomposition (ALGO_INTERP): each
// pass of ops/interp_fast.encode_grid_fast predicts, quantizes and places
// every point of one (level, direction) in one launch, in place on a working
// copy of the grid, for a batch of grids at once (the tuner's trials and
// sampled blocks).
//
// The JAX package has no Pallas kernel for these passes
// (sz3_tpu/ops/interp_fast.py is an XLA graph). The plain PyTorch version is
// encode_grid_plain in sz3_tpu_torch/ops/interp_fast.py: per pass five
// shifted copies of the coarse array, every basis function of the pass's
// kinds, a select, the quantizer's float64 chain and an interleave, some
// 45-70 elementwise launches, most of them full passes over float64
// temporaries.
//
// The pass. Within one (level, pass) a predicted point reads only coarse
// points, which earlier passes placed, and the originals: never another
// point of the same pass (InterpolationDecomposition.hpp:247-402), save the
// linear-mode block tails (K_LIN1_NEW), which read the stage-1
// reconstruction of the point before them on the same line. So one thread a
// predicted point:
//   - reads its original from x, never from the working grid w, which the
//     pass overwrites;
//   - reads its coarse neighbours A[j-2 .. j+2] from w, the index clamped to
//     [0, C-1] along the pass axis (the plain version's edge padding);
//   - forms the basis function of its kind in the plain version's operation
//     order (Interpolators.hpp:12-39) and the data's type, K_LIN1_OLD in
//     float64 and narrowed;
//   - a K_LIN1_NEW point first forms the stage-1 prediction and
//     reconstruction of point j-1 (j itself at j == 0) in the same thread,
//     then its own prediction f(-0.5 * that + 1.5 * A[j]) in float64;
//   - quantizes as ops/quantize.quantize does and writes its reconstruction
//     to w and its bin to the bins grid, both at its grid position.
//
// The geometry of a pass is one row of 15 integers built on the host from
// the plan (interp_fast.pass_geometry, whose index arithmetic
// tests/test_torch_interp_kernel.py evaluates in numpy against the plain
// version's slices): the point counts n0..n3 and element strides e0..e3 of
// the predicted points along four axes (leading axes of count 1 for ranks
// below 4), the first point's offset, the pass axis dd, the coarse points'
// element stride cstep and count C along dd, the kinds' address and their
// stride between trials (0 unless the plan is stacked), and the per-trial
// bounds' address (0 where the trials share the row's bound).
//
// Batches. The grids form a (T, K) batch: T trials, each with its kinds and
// bound, over K grids; w and the bins grid are (T*K, G) contiguous, and x is
// read at t * xs_t + k * xs_k, so that the tuner's expanded blocks (xs_t = 0)
// are not copied for x.
//
// Bit-exactness. Built with -fmad=false (build.py), so each operation rounds
// once, in the plain version's order: that version runs each arithmetic step
// as its own eager op, the basis functions in the data's type, the
// quantizer's quotient, decoded value and error test in float64. Division by
// 2, 8 or 16 is exact scaling, the same on every device.
//
// Bytes. A point reads its original (the element size), its neighbours
// (mostly from L1 and L2: a coarse point serves its two predicted
// neighbours), and writes its reconstruction and its bin: about 12 bytes a
// float32 point at the first level's passes, where the predicted points of
// a warp lie two elements apart along the innermost axis.

#include <cuda_runtime.h>

namespace {

constexpr int K_CUBIC = 0, K_QUAD1 = 1, K_QUAD2 = 2, K_QUAD3 = 3, K_LINEAR = 4,
              K_LIN1_NEW = 5, K_LIN1_OLD = 6;
constexpr int kThreads = 256;
constexpr int kRow = 15;                // integers a pass row
constexpr int kMaxY = 65535;            // grid.y's limit

struct Pass {
    const void* x;
    void* w;
    int* grid;
    long long xs_t, xs_k;               // x's strides along the trial and block axes
    long long G;                        // elements a grid
    long long batch;                    // T * K
    unsigned nK;
    unsigned npts;                      // predicted points a grid
    int n1, n2, n3;
    long long e0, e1, e2, e3, edd;
    long long base, cstep;
    int dd, C;
    const int* kinds;
    long long kstride;
    const double* ebs;                  // one bound a trial, or null
    double eb;
    int radius;
};

// ops/quantize.quantize, one point: bin 0 marks an unpredictable point,
// whose reconstruction keeps the original value
template <typename T>
__device__ __forceinline__ void quantize(T data, T pred, double eb, int radius, int& bin,
                                         T& recon) {
    const double recip = 1.0 / eb;
    const T diff = data - pred;
    const double scaled = fabs(static_cast<double>(diff)) * recip;
    // the engine's int64 cast gives INT64_MIN for NaN and quotients of 2^63
    // and above: then only the error test decides
    const bool wild = !(scaled < 9223372036854775808.0);
    double c = wild ? 0.0 : scaled;
    const double top = static_cast<double>(2 * radius);
    if (c > top) c = top;
    const int qi = static_cast<int>(c) + 1;
    const int half = qi >> 1;
    const int qeven = half << 1;
    const bool neg = diff < T(0);
    const double q = wild ? -9223372036854775808.0 : static_cast<double>(neg ? -qeven : qeven);
    const int shifted = neg ? radius - half : radius + half;
    const T dec = static_cast<T>(static_cast<double>(pred) + q * eb);
    const double err = fabs(static_cast<double>(dec - data));
    const bool ok = (wild || qi < 2 * radius) && err <= eb;
    bin = ok ? shifted : 0;
    recon = ok ? dec : data;
}

// f(-0.5 a + 1.5 b) in float64, narrowed (Interpolators.hpp linear1)
template <typename T>
__device__ __forceinline__ T linear1(T a, T b) {
    const double l = -0.5 * static_cast<double>(a);
    const double r = 1.5 * static_cast<double>(b);
    return static_cast<T>(l + r);
}

// A[i] of the line, i clamped to [0, C-1]
template <typename T>
__device__ __forceinline__ T coarse(const T* w, long long line, long long cstep, int C, int i) {
    i = i < 0 ? 0 : (i > C - 1 ? C - 1 : i);
    return w[line + i * cstep];
}

// the stage-1 prediction of point j of the line, from its kind; K_COPY,
// K_LIN1_NEW (fixed in stage 2) and any other kind take A[j]
template <typename T>
__device__ __forceinline__ T predict(int kind, const T* w, long long line, long long cstep, int C,
                                     int j) {
    const T z0 = coarse(w, line, cstep, C, j);
    switch (kind) {
    case K_LIN1_OLD:
        return linear1(coarse(w, line, cstep, C, j - 1), z0);
    case K_LINEAR:
        return (z0 + coarse(w, line, cstep, C, j + 1)) / T(2);
    case K_QUAD3: {
        const T m2 = coarse(w, line, cstep, C, j - 2), m1 = coarse(w, line, cstep, C, j - 1);
        return (T(3) * m2 - T(10) * m1 + T(15) * z0) / T(8);
    }
    case K_QUAD2: {
        const T m1 = coarse(w, line, cstep, C, j - 1), p1 = coarse(w, line, cstep, C, j + 1);
        return (-m1 + T(6) * z0 + T(3) * p1) / T(8);
    }
    case K_QUAD1: {
        const T p1 = coarse(w, line, cstep, C, j + 1), p2 = coarse(w, line, cstep, C, j + 2);
        return (T(3) * z0 + T(6) * p1 - p2) / T(8);
    }
    case K_CUBIC: {
        const T m1 = coarse(w, line, cstep, C, j - 1), p1 = coarse(w, line, cstep, C, j + 1),
                p2 = coarse(w, line, cstep, C, j + 2);
        return (-m1 + T(9) * z0 + T(9) * p1 - p2) / T(16);
    }
    default:
        return z0;
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) encode_pass(Pass a) {
    const unsigned idx = blockIdx.x * kThreads + threadIdx.x;
    const unsigned b = blockIdx.z * gridDim.y + blockIdx.y;
    if (idx >= a.npts || b >= a.batch) return;
    unsigned r = idx;
    const int i3 = r % a.n3;
    r /= a.n3;
    const int i2 = r % a.n2;
    r /= a.n2;
    const int i1 = r % a.n1;
    const int i0 = r / a.n1;
    const int j = a.dd == 0 ? i0 : a.dd == 1 ? i1 : a.dd == 2 ? i2 : i3;
    const long long off = i0 * a.e0 + i1 * a.e1 + i2 * a.e2 + i3 * a.e3;
    const long long line = off - j * a.edd;    // the line's coarse point 0
    const unsigned t = b / a.nK, k = b % a.nK;
    const T* x = static_cast<const T*>(a.x) + t * a.xs_t + k * a.xs_k;
    const T* wr = static_cast<const T*>(a.w) + b * a.G;
    const int* kinds = a.kinds + t * a.kstride;
    const double eb = a.ebs != nullptr ? a.ebs[t] : a.eb;
    const int kind = kinds[j];

    T pred;
    if (kind == K_LIN1_NEW) {
        // InterpolationDecomposition.hpp:341-350: the stage-1 reconstruction
        // of the point before on the same line
        const int jp = j > 0 ? j - 1 : 0;
        const T p1 = predict(kinds[jp], wr, line, a.cstep, a.C, jp);
        int bin1;
        T rec1;
        quantize(x[a.base + line + jp * a.edd], p1, eb, a.radius, bin1, rec1);
        pred = linear1(rec1, coarse(wr, line, a.cstep, a.C, j));
    } else {
        pred = predict(kind, wr, line, a.cstep, a.C, j);
    }
    int bin;
    T rec;
    const long long own = a.base + off;
    quantize(x[own], pred, eb, a.radius, bin, rec);
    static_cast<T*>(a.w)[b * a.G + own] = rec;
    a.grid[b * a.G + own] = bin;
}

// a plan without anchors: each grid's first point against a zero prediction
template <typename T>
__global__ void __launch_bounds__(kThreads) first_point(Pass a) {
    const long long b = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (b >= a.batch) return;
    const long long t = b / a.nK, k = b % a.nK;
    int bin;
    T rec;
    quantize(static_cast<const T*>(a.x)[t * a.xs_t + k * a.xs_k], T(0), a.eb, a.radius, bin, rec);
    static_cast<T*>(a.w)[b * a.G] = rec;
    a.grid[b * a.G] = bin;
}

template <typename T>
int run(Pass a, bool anchored, const long long* rows, const double* ebs, int npasses,
        cudaStream_t s) {
    if (!anchored) {
        const unsigned blocks = static_cast<unsigned>((a.batch + kThreads - 1) / kThreads);
        first_point<T><<<blocks, kThreads, 0, s>>>(a);
    }
    const unsigned ys = static_cast<unsigned>(a.batch < kMaxY ? a.batch : kMaxY);
    const unsigned zs = static_cast<unsigned>((a.batch + kMaxY - 1) / kMaxY);
    for (int p = 0; p < npasses; p++) {
        const long long* row = rows + p * kRow;
        const long long npts = row[0] * row[1] * row[2] * row[3];
        a.n1 = static_cast<int>(row[1]);
        a.n2 = static_cast<int>(row[2]);
        a.n3 = static_cast<int>(row[3]);
        a.npts = static_cast<unsigned>(npts);
        a.e0 = row[4];
        a.e1 = row[5];
        a.e2 = row[6];
        a.e3 = row[7];
        a.base = row[8];
        a.dd = static_cast<int>(row[9]);
        a.edd = row[4 + a.dd];
        a.cstep = row[10];
        a.C = static_cast<int>(row[11]);
        a.kinds = reinterpret_cast<const int*>(row[12]);
        a.kstride = row[13];
        a.ebs = reinterpret_cast<const double*>(row[14]);
        a.eb = ebs[p];
        const unsigned xs = static_cast<unsigned>((npts + kThreads - 1) / kThreads);
        encode_pass<T><<<dim3(xs, ys, zs), kThreads, 0, s>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: the originals of the (T, K) batch of grids of G elements, float32 or
// float64 (is_double), grid b = t * K + k at t * xs_t + k * xs_k; w: the
// working grid, (T * K, G) contiguous, x's values on entry (x's and w's grids
// share one row-major layout) and the reconstruction on return; grid: the
// bins, (T * K, G) int32, zeros on entry. rows: npasses rows of 15 integers
// (see above), ebs: each pass's bound where its row has no per-trial bounds.
// Without anchors the first point is quantized against 0 at base_eb first.
// One launch a pass on `stream`. Returns a cudaError_t.
extern "C" int szt_interp_encode(const void* x, void* w, int* grid, int is_double, long long T,
                                 long long K, long long xs_t, long long xs_k, long long G,
                                 int radius, int anchored, double base_eb,
                                 const long long* rows, const double* ebs, int npasses,
                                 void* stream) {
    if (T <= 0 || K <= 0 || K >= (1LL << 31) || G <= 0 || radius < 0 || radius >= (1 << 30))
        return static_cast<int>(cudaErrorInvalidValue);
    if (T * K >= (1LL << 32) - kMaxY) return static_cast<int>(cudaErrorInvalidValue);
    for (int p = 0; p < npasses; p++) {
        const long long* row = rows + p * kRow;
        for (int a = 0; a < 4; a++)
            if (row[a] <= 0 || row[a] >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
        if (row[0] * row[1] * row[2] * row[3] >= (1LL << 32) - kThreads || row[9] < 0 ||
            row[9] > 3 || row[11] <= 0 || row[12] == 0)
            return static_cast<int>(cudaErrorInvalidValue);
    }
    Pass a{};
    a.x = x;
    a.w = w;
    a.grid = grid;
    a.xs_t = xs_t;
    a.xs_k = xs_k;
    a.G = G;
    a.batch = T * K;
    a.nK = static_cast<unsigned>(K);
    a.radius = radius;
    a.eb = base_eb;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return is_double ? run<double>(a, anchored != 0, rows, ebs, npasses, s)
                     : run<float>(a, anchored != 0, rows, ebs, npasses, s);
}
