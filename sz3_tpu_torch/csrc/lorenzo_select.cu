// The predictor selection of ALGO_LORENZO_REG's encode for the roster
// {Lorenzo-1, regression}: for every 6^3 block, the sampled errors of both
// predictors and the pick, as the host engine makes it
// (ComposedPredictor.hpp:25-40, BlockwiseIterator.hpp:151-184).
//
// Replaces the XLA graph of the JAX package's selection,
// sz3_tpu/ops/blockwise_wavefront_encode.py::_jit_select; there is no Pallas
// kernel for it. The plain PyTorch version is select_plain in
// sz3_tpu_torch/ops/blockwise_wavefront_encode.py, a loop over the 84
// (i, j, point) samples that runs some 2,000 elementwise launches on
// strided views, every sample computed for every block and masked.
//
// One thread a block. A block of least extent m takes the samples
// i = 0 .. m-1 with j = m-1-i, four points each, in the reference's order:
// (i,i,i), (i,i,j), (i,j,i), (i,j,j). A sample reads the cell and the seven
// other cells of its Lorenzo-1 stencil, at offsets -1 .. 5 from the block's
// base along each axis. A cell inside the block being selected (every
// offset >= 0) reads `orig`, the original values, which the host engine has
// not yet swept there; a cell in the pad (some offset -1) reads `tap`: the
// original values when speculating, the reconstruction when certifying. The
// two may be one array.
//
// Memory. A CTA takes kW consecutive z-blocks of one (x, y) block row, a
// warp's lanes consecutive blocks. It stages the cells its samples touch
// through shared memory with asynchronous 4-byte copies, each row of the
// tile (fixed x, y offsets; z along the row) read coalesced:
//   tile[x+1][y+1][z'], z' = 0 .. 6 kW: the offsets (x, y) = -1 .. 5 and the
//     z run from the CTA's first block's offset -1 on: `tap` where x or y is
//     -1, else `orig`;
//   side[x][y][k]: `tap` at block k's z offset -1 for x, y >= 0, the cell
//     that tile[x+1][y+1][6k] holds from `orig` as block k-1's z offset 5.
// The samples touch 33 of the tile's 49 rows and 9 of the 36 side cells of
// a block of extent 6 (fewer for a smaller m): the host computes, for each m,
// which rows and side cells its samples touch, and a CTA loads only those of
// the m its blocks have. So each grid is read from device memory about once,
// the neighbouring rows' halos from L2.
//
// Bit-exactness. Built with -fmad=false (build.py), so each float operation
// rounds once, in the plain version's order: the stencil
// ((((((a001 + a010) + a100) - a011) - a101) - a110) + a111), |c - l1| +
// noise1, ((c0 px + c1 py) + c2 pz) + c3 and |c - pr|, each error widened to
// float64 and added in sample order. The plain version adds an exact +0.0
// for each of the 84 - 4m samples a block does not take; both sums start at
// +0.0 and take only non-negative values, +Inf or NaN, on which adding +0.0
// changes nothing, so the kernel skips those additions. An invalid block
// (an extent of 1) takes DBL_MAX as its regression error; regression wins
// only on strictly less (a NaN loses), and ok = !(pick && !valid).

#include <cuda_runtime.h>

#include <float.h>

namespace {

constexpr int kBS = 6;
constexpr int kPad = 2;
constexpr int kW = 32;                  // z-blocks a CTA: one warp computes
constexpr int kThreads = 128;           // four warps copy
constexpr int kWarps = kThreads / 32;
constexpr int kEdge = kBS + 1;          // offsets -1 .. 5
constexpr int kRows = kEdge * kEdge;
constexpr int kRow = kBS * kW + 1;      // a tile row: z offsets -1 .. 6 kW - 1
constexpr int kSides = kBS * kBS;

struct Masks {
    unsigned long long rows[kBS + 1];   // by m: the tile rows x' * 7 + y' touched
    unsigned long long sides[kBS + 1];  // by m: the side cells x * 6 + y touched
};

struct SelectArgs {
    const float* orig;
    const float* tap;
    const float* coefs;                 // (4, nb0, nb1, nb2)
    unsigned char* is_reg;
    unsigned char* ok;
    int nx, ny, nz;                     // the field
    int nb0, nb1, nb2, chunks;
    long long pr, pq;                   // the padded grid's extents along y and z
    float noise1;
    Masks masks;
};

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 800
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
#else
    *dst = *src;
#endif
}

__device__ __forceinline__ void wait_copies() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 800
    asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

__device__ __forceinline__ int extent(int n, int b) {
    const int e = n - kBS * b;
    return e < kBS ? e : kBS;
}

__global__ void __launch_bounds__(kThreads) select_blocks(SelectArgs a) {
    __shared__ float tile[kRows * kRow];
    __shared__ float side[kSides * kW];
    __shared__ unsigned char rows[kRows], sides[kSides];
    __shared__ int nrows, nsides;

    const int chunk = blockIdx.x % a.chunks;
    const int xy = blockIdx.x / a.chunks;
    const int bx = xy / a.nb1, by = xy % a.nb1;
    const int bz0 = chunk * kW;
    const int w = a.nb2 - bz0 < kW ? a.nb2 - bz0 : kW;
    const int len = kBS * w + 1;
    const int exy = min(extent(a.nx, bx), extent(a.ny, by));
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

    // the rows and side cells the CTA's least extents touch, listed
    if (threadIdx.x < 32) {
        const int m_full = min(exy, kBS);
        const int m_last = min(exy, extent(a.nz, a.nb2 - 1));
        const bool has_full = bz0 + w < a.nb2 || w > 1;
        const bool has_last = bz0 + w == a.nb2;
        const unsigned long long rm = (has_full ? a.masks.rows[m_full] : 0ull) |
                                      (has_last ? a.masks.rows[m_last] : 0ull);
        const unsigned long long sm = (has_full ? a.masks.sides[m_full] : 0ull) |
                                      (has_last ? a.masks.sides[m_last] : 0ull);
        for (int r = lane; r < kRows; r += 32)
            if ((rm >> r) & 1) rows[__popcll(rm & ((1ull << r) - 1))] = static_cast<unsigned char>(r);
        for (int s = lane; s < kSides; s += 32)
            if ((sm >> s) & 1) sides[__popcll(sm & ((1ull << s) - 1))] = static_cast<unsigned char>(s);
        if (lane == 0) {
            nrows = __popcll(rm);
            nsides = __popcll(sm);
        }
    }
    __syncthreads();

    // tile row (x', y') starts at the padded cell (x0 + x', y0 + y', z0)
    const long long x0 = kPad + kBS * bx - 1, y0 = kPad + kBS * by - 1, z0 = kPad + kBS * bz0 - 1;
    for (int i = warp; i < nrows; i += kWarps) {
        const int r = rows[i], tx = r / kEdge, ty = r % kEdge;
        const float* g = (tx == 0 || ty == 0) ? a.tap : a.orig;
        const float* src = g + ((x0 + tx) * a.pr + (y0 + ty)) * a.pq + z0;
        float* dst = tile + r * kRow;
        for (int z = lane; z < len; z += 32) copy_async(dst + z, src + z);
    }
    for (int i = warp; i < nsides; i += kWarps) {
        const int s = sides[i], x = s / kBS, y = s % kBS;
        const float* src = a.tap + ((x0 + 1 + x) * a.pr + (y0 + 1 + y)) * a.pq + z0;
        if (lane < w) copy_async(side + s * kW + lane, src + kBS * lane);
    }
    wait_copies();
    __syncthreads();
    if (threadIdx.x >= w) return;

    const int k = threadIdx.x;
    const int ez = extent(a.nz, bz0 + k);
    const int m = min(exy, ez);
    const bool valid = exy > 1 && ez > 1;
    const long long nblk = static_cast<long long>(a.nb0) * a.nb1 * a.nb2;
    const long long b = static_cast<long long>(xy) * a.nb2 + bz0 + k;
    const float c0 = a.coefs[b], c1 = a.coefs[nblk + b], c2 = a.coefs[2 * nblk + b],
                c3 = a.coefs[3 * nblk + b];
    const float* base = tile + (kEdge + 1) * kRow + 1 + kBS * k;   // offsets (0, 0, 0)
    const float* sk = side + k;
    // the cell at offsets (x, y, z) from the block's base, -1 <= x, y, z <= 5
    auto val = [&](int x, int y, int z) -> float {
        if (z < 0 && x >= 0 && y >= 0) return sk[(x * kBS + y) * kW];
        return base[(x * kEdge + y) * kRow + z];
    };

    double err1 = 0.0, err_r = 0.0;
    for (int i = 0; i < m; i++) {
        const int j = m - 1 - i;
        for (int p = 0; p < 4; p++) {
            const int px = i, py = (p & 2) ? j : i, pz = (p & 1) ? j : i;
            const float c = val(px, py, pz);
            // the reference's prev3(k, j, i) reads (x - j, y - k, z - i)
            const float l1 = ((((((val(px, py, pz - 1) + val(px - 1, py, pz)) +
                                  val(px, py - 1, pz)) - val(px - 1, py, pz - 1)) -
                                val(px, py - 1, pz - 1)) - val(px - 1, py - 1, pz)) +
                              val(px - 1, py - 1, pz - 1));
            const float e1 = fabsf(c - l1) + a.noise1;
            const float pr = ((c0 * static_cast<float>(px) + c1 * static_cast<float>(py)) +
                              c2 * static_cast<float>(pz)) + c3;
            const float er = fabsf(c - pr);
            err1 += static_cast<double>(e1);
            err_r += static_cast<double>(er);
        }
    }
    if (!valid) err_r = DBL_MAX;
    const bool pick = err_r < err1;     // roster [L1, REG]: a tie keeps L1
    a.is_reg[b] = pick && valid;
    a.ok[b] = !(pick && !valid);
}

// for each least extent m, the tile rows and side cells its samples touch
Masks masks_of() {
    Masks ms{};
    for (int m = 1; m <= kBS; m++) {
        for (int i = 0; i < m; i++) {
            const int j = m - 1 - i;
            for (int p = 0; p < 4; p++) {
                const int px = i, py = (p & 2) ? j : i, pz = (p & 1) ? j : i;
                for (int d = 0; d < 8; d++) {
                    const int x = px - (d >> 2), y = py - ((d >> 1) & 1), z = pz - (d & 1);
                    if (z < 0 && x >= 0 && y >= 0)
                        ms.sides[m] |= 1ull << (x * kBS + y);
                    else
                        ms.rows[m] |= 1ull << ((x + 1) * kEdge + (y + 1));
                }
            }
        }
    }
    return ms;
}

}  // namespace

// orig and tap: the padded grids (6 nb0 + 2, 6 nb1 + 2, 6 nb2 + 2) float32 of
// the (nx, ny, nz) field's blocks, nb = ceil(n / 6); coefs (4, nb0, nb1,
// nb2) float32, the raw fits; is_reg and ok (nb0, nb1, nb2) bytes, written 0
// or 1. One launch on `stream`. Returns a cudaError_t.
extern "C" int szt_lorenzo_select(const float* orig, const float* tap, const float* coefs,
                                  unsigned char* is_reg, unsigned char* ok, int nx, int ny,
                                  int nz, float noise1, void* stream) {
    if (nx <= 0 || ny <= 0 || nz <= 0) return static_cast<int>(cudaErrorInvalidValue);
    SelectArgs a{orig, tap, coefs, is_reg, ok, nx, ny, nz};
    a.nb0 = (nx + kBS - 1) / kBS;
    a.nb1 = (ny + kBS - 1) / kBS;
    a.nb2 = (nz + kBS - 1) / kBS;
    a.chunks = (a.nb2 + kW - 1) / kW;
    a.pr = kBS * static_cast<long long>(a.nb1) + kPad;
    a.pq = kBS * static_cast<long long>(a.nb2) + kPad;
    a.noise1 = noise1;
    a.masks = masks_of();
    const long long ctas = static_cast<long long>(a.nb0) * a.nb1 * a.chunks;
    if (ctas >= (1LL << 31) || static_cast<long long>(a.nb0) * a.nb1 >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    select_blocks<<<static_cast<unsigned>(ctas), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}
