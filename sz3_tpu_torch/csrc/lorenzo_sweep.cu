// The element sweep of ALGO_LORENZO_REG: every Lorenzo cell of a 3D field,
// plane by anti-diagonal plane, in recover form (decode) or quantize form
// (encode), and the two conversions between the field's natural layout and
// the plane-major layout the sweep runs in.
//
// Replaces the XLA lax.scan of the JAX package's element sweep,
// sz3_tpu/ops/blockwise_wavefront.py::_jit_wavefront (decode) and
// sz3_tpu/ops/blockwise_wavefront_encode.py::_jit_wavefront_enc (encode);
// there is no Pallas kernel for it. The plain PyTorch versions are
// sweep_decode_plain and sweep_encode_plain, and to_planes_plain /
// from_planes_plain for the conversions, in sz3_tpu_torch/ops/.
//
// The first- and second-order Lorenzo stencils read the reconstruction at
// offsets that are non-positive in every axis and sum to at least 1, so the
// cells of plane t = x + y + z depend only on planes before t. The grid is
// the rounded grid (multiples of 6 per axis), front-padded by 2 with zeros:
// rec is (NX+2, NY+2, NZ+2) float32, updated in place; type, bins/vals are
// (NX, NY, NZ). Cells of type KEEP (regression blocks, placed before the
// sweep, and cells outside the field) are left as they are; the encode
// writes bin 0 there.
//
// What bounds it on the card. In the natural layout a plane's cells are
// (NY+2)(NZ+2) - 1 floats apart from lane to lane (z up, x down), so every
// load and store of a warp touches 32 sectors: some 256 bytes of traffic a
// cell for the 12 it needs, and a plane's sectors spread over the whole
// array, so they leave the 50 MB L2 before the next planes reuse them. At
// 256^3 (772 planes) a pass there still sat near its launches (3.5 ms
// against 1.4 ms of empty dependent launches); at 512^3 (1,546 planes, 137 M
// cells) it took 26-34 ms, ten times its launch floor, in proportion to the
// cells. In the plane-major layout below, a 512^3 encode pass is about 7 ms
// of device time on an H100: 1,546 plane launches of about 2.6 us, near the
// launch floor, and about 2.9 ms of conversions, which move 34 bytes a cell
// at some 1.6 TB/s. At 256^3 the launches set the pace, as before. What is
// left is the launches (a persistent kernel or a CUDA graph of a pass) and
// the conversions' bytes.
//
// The plane-major layout. Every padded cell (x, y, z) gets the position
//   below3(t) + below2(t + 1) - below2(s) - max(0, s - (NX+2)) + z,
//   t = x + y + z,  s = x + z + 1,
// where below3(t) counts the padded cells of the planes before t and
// below2(s) the (x, z) pairs with x + z < s: plane t is one contiguous slab,
// its rows (fixed y) in ascending y, each row's z ascending. The layout holds
// exactly the padded cells (no bounding box of planes), and both counts are
// closed forms; the only table is each plane's first position. The sweep
// then walks a plane with one thread per cell: a warp's lanes take
// consecutive positions, and each of a cell's stencil taps (plane t - d, row
// y - dk, z - di) lies at the tap row's start plus z, so the lanes of a row
// read consecutive addresses of the last 3 (L1) or 6 (L2) planes, a few MB
// that stay in L2. A thread loads its own inputs first, then finds its row
// from its position by inverting below2 (a square root and a check); each
// launch also prefetches the next plane's inputs into L2, so that the next
// launch waits on L2 rather than on device memory.
//
// The conversions (convert<kIn>) move tiles through shared memory. A tile
// is one y, 32 rows x, and on each row the 64 cells whose x + z runs over
// one range: a parallelogram whose rows are runs of z in the natural layout
// (read or written along z) and whose 64 columns (fixed x + z) are runs of
// 32 consecutive positions of one plane-major row (written or read by a
// warp, a lane a row). The encode converts rec, the values and the types in
// (one launch) and rec and the bins out (one); the decode rec, the bins,
// the literals and the types in and rec out. A small kernel first writes
// each plane's first position (plane_table). The scratch is 13 bytes a
// padded cell and 8 a plane; one C call runs the whole sweep, conversions
// included: 3 launches and one a plane.
//
// Bit-exactness. The kernels are built with -fmad=false (build.py): the
// stencil sums, the recover pred + q*eb and the quantizer's pred + q*eb
// each round once per operation, as the host engine's -ffp-contract=off
// build and the plain versions do; a contracted multiply-add would move
// results by an ulp. The f32 stencils add their terms in the reference's
// order (prev3(k, j, i) reads (x - j, y - k, z - i)). nvcc's defaults
// -ftz=false -prec-div=true keep subnormals. A NaN or an infinite value in
// the data or the prediction always fails the quantizer's error test, so
// such a cell becomes a literal whatever its (undefined) integer bin was.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 2;
constexpr int kTileX = 32, kTileS = 64;
constexpr unsigned char kL2 = 1, kKeep = 2;

// ---- the plane-major layout ------------------------------------------------------

struct Layout {
    long long p, r, q;  // the padded extents NX+2, NY+2, NZ+2
};

// the counts of (x, z) pairs, in 32 bits: every one is below p q < 2^31
struct Rows {
    int p, q;
    int a, b;           // min(p, q), max(p, q)
    int ta, ta1, tb;    // below2(a) = tri(a), tri(a - 1), below2(b) = a b - tri(a - 1)
    int pq;
};

// k (k + 1) / 2 for k > 0, else 0, modulo 2^64: the sums below are exact
// counts below 2^63, whatever their terms
__host__ __device__ __forceinline__ unsigned long long tri(long long k) {
    if (k <= 0) return 0;
    unsigned long long a = k, b = k + 1;
    if (a & 1) b >>= 1; else a >>= 1;
    return a * b;
}

// the same modulo 2^32
__host__ __device__ __forceinline__ unsigned tri32(int k) {
    if (k <= 0) return 0;
    unsigned a = k, b = k + 1u;
    if (a & 1) b >>= 1; else a >>= 1;
    return a * b;
}

// k (k + 1) (k + 2) / 6 for k > 0, else 0, modulo 2^64
__host__ __device__ __forceinline__ unsigned long long tet(long long k) {
    if (k <= 0) return 0;
    unsigned long long a = k, b = k + 1, c = k + 2;
    if (a % 3 == 0) a /= 3; else if (b % 3 == 0) b /= 3; else c /= 3;
    if (a & 1) b >>= 1; else a >>= 1;  // dividing by 3 keeps the parity
    return a * b * c;
}

// the (x, z) pairs of [0, p) x [0, q) with x + z < s
__host__ __device__ __forceinline__ long long below2(const Layout& L, long long s) {
    return static_cast<long long>(tri(s) - tri(s - L.p) - tri(s - L.q) + tri(s - L.p - L.q));
}

__device__ __forceinline__ int below2(const Rows& w, int s) {
    return static_cast<int>(tri32(s) - tri32(s - w.p) - tri32(s - w.q) + tri32(s - w.p - w.q));
}

// the padded cells with x + y + z < t
__host__ __device__ __forceinline__ long long below3(const Layout& L, long long t) {
    return static_cast<long long>(tet(t) - tet(t - L.p) - tet(t - L.r) - tet(t - L.q) +
                                  tet(t - L.p - L.r) + tet(t - L.p - L.q) + tet(t - L.r - L.q) -
                                  tet(t - L.p - L.r - L.q));
}

// position of (x, y, z) = plane_base(t) - row_shift(s) + z
__host__ __device__ __forceinline__ long long plane_base(const Layout& L, long long t) {
    return below3(L, t) + below2(L, t + 1);
}

__device__ __forceinline__ int row_shift(const Rows& w, int s) {
    return below2(w, s) + (s > w.p ? s - w.p : 0);
}

// the smallest s with below2(s) >= tgt, for 1 <= tgt <= p q, and below2(s):
// the row x + z = s - 1 that holds the tgt-th pair counted from a plane's end.
// below2 is one quadratic or linear piece on each side of a and b; a float
// square root finds s in the piece, and a step or two of its formula fixes it.
__device__ __forceinline__ int row_of(const Rows& w, int tgt, int& f) {
    if (tgt <= w.ta) {          // below2(s) = tri(s) up to a
        int s = static_cast<int>(ceilf((sqrtf(8.0f * tgt + 1.0f) - 1.0f) * 0.5f));
        while (static_cast<int>(tri32(s)) < tgt) ++s;
        while (s > 0 && static_cast<int>(tri32(s - 1)) >= tgt) --s;
        f = static_cast<int>(tri32(s));
        return s;
    }
    if (tgt <= w.tb) {          // below2(s) = a s - tri(a - 1) from a to b
        const int s = static_cast<int>((static_cast<unsigned>(tgt) + w.ta1 + w.a - 1) /
                                       static_cast<unsigned>(w.a));
        f = w.a * s - w.ta1;
        return s;
    }
    // past b, below2(s) = p q - tri(a + b - 1 - s): the largest r = a + b - 1 - s
    // with tri(r) <= p q - tgt
    const int c = w.pq - tgt;
    int r = static_cast<int>(floorf((sqrtf(8.0f * c + 1.0f) - 1.0f) * 0.5f));
    while (static_cast<int>(tri32(r + 1)) <= c) ++r;
    while (r > 0 && static_cast<int>(tri32(r)) > c) --r;
    f = w.pq - static_cast<int>(tri32(r));
    return w.a + w.b - 1 - r;
}

// base[t] = plane_base(t) for t < n
__global__ void __launch_bounds__(kThreads) plane_table(long long* base, Layout L, int n) {
    const int t = blockIdx.x * kThreads + threadIdx.x;
    if (t < n) base[t] = plane_base(L, t);
}

// ---- the conversions ----------------------------------------------------------------

template <typename E>
struct Moves {
    E* nat[3];   // natural: the padded grid (lo 0) or the rounded grid (lo kPad)
    E* pm[3];    // plane-major, indexed by padded cell
    int lo[3];
    int n;
};

// A tile: one y, the kTileX rows x = x0 + xr, and on each row the kTileS
// cells whose s = x + z + 1 runs over s0 + sc: a parallelogram in (x, z),
// whose rows are runs of z in the natural layout and whose columns (fixed s)
// are runs of one plane-major row (z falls as x rises). base[sc] is that
// row's position of z = 0. A row of the shared tile holds kTileS elements
// and 4 bytes more, so that a column's lanes fall in distinct banks. Every
// array of a launch is in flight at once: all rows, one barrier, all columns.
template <typename E>
constexpr int kStrideOf = kTileS + 4 / static_cast<int>(sizeof(E));

// the natural side: a warp a row, the lanes along z
template <typename E, int kArrays, bool kIn>
__device__ __forceinline__ void tile_rows(const Moves<E>& m, E* tiles, const Layout& L,
                                          const Rows& w, int y, int x0, int zc0) {
    constexpr int kStride = kStrideOf<E>;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < kArrays; k++) {
        if (k >= m.n) break;
        const int lo = m.lo[k];
        if (y < lo) continue;
        const long long ny = L.r - lo, nz = L.q - lo;
        E* nat = m.nat[k] + (y - lo) * nz - lo;
        E* tile = tiles + k * kTileX * kStride;
        for (int xr = warp; xr < kTileX; xr += kWarps) {
            const int x = x0 + xr;
            if (x < lo || x >= w.p) continue;
            E* row = nat + (x - lo) * ny * nz;
            for (int sc = lane; sc < kTileS; sc += 32) {
                const int z = zc0 + sc - xr;
                if (z < lo || z >= w.q) continue;
                if (kIn)
                    tile[xr * kStride + sc] = row[z];
                else
                    row[z] = tile[xr * kStride + sc];
            }
        }
    }
}

// the plane-major side: a warp a column, lane xr
template <typename E, int kArrays, bool kIn>
__device__ __forceinline__ void tile_columns(const Moves<E>& m, E* tiles,
                                             const long long* base, const Rows& w, int y,
                                             int x0, int zc0) {
    constexpr int kStride = kStrideOf<E>;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int x = x0 + lane;
#pragma unroll
    for (int k = 0; k < kArrays; k++) {
        if (k >= m.n) break;
        const int lo = m.lo[k];
        if (y < lo || x < lo || x >= w.p) continue;
        E* tile = tiles + k * kTileX * kStride;
        E* pm = m.pm[k];
        for (int sc = warp; sc < kTileS; sc += kWarps) {
            const int z = zc0 + sc - lane;
            if (z < lo || z >= w.q) continue;
            if (kIn)
                pm[base[sc] + z] = tile[lane * kStride + sc];
            else
                tile[lane * kStride + sc] = pm[base[sc] + z];
        }
    }
}

// kIn: natural -> plane-major; else plane-major -> natural, for the 4-byte
// arrays of m4 (up to 3) and the 1-byte array of m1 (up to 1). tab holds plane_base of every
// plane. Block (y, xt, st): x0 = 32 xt, s0 = x0 + 1 + kTileS st.
template <bool kIn>
__global__ void __launch_bounds__(kThreads) convert(Moves<unsigned> m4, Moves<unsigned char> m1,
                                                    const long long* __restrict__ tab, Layout L,
                                                    Rows w, int xtiles, int stiles) {
    __shared__ unsigned tile4[3 * kTileX * kStrideOf<unsigned>];
    __shared__ unsigned char tile1[kTileX * kStrideOf<unsigned char>];
    __shared__ long long base[kTileS];
    int blk = blockIdx.x;
    const int st = blk % stiles;
    blk /= stiles;
    const int x0 = (blk % xtiles) * kTileX;
    const int y = blk / xtiles;
    const int zc0 = st * kTileS;                 // z of lane xr, column sc: zc0 + sc - xr
    for (int sc = threadIdx.x; sc < kTileS; sc += kThreads) {
        const int s = x0 + 1 + zc0 + sc;
        if (s < w.p + w.q) base[sc] = tab[s - 1 + y] - row_shift(w, s);
    }
    if (kIn) {
        tile_rows<unsigned, 3, true>(m4, tile4, L, w, y, x0, zc0);
        tile_rows<unsigned char, 1, true>(m1, tile1, L, w, y, x0, zc0);
        __syncthreads();
        tile_columns<unsigned, 3, true>(m4, tile4, base, w, y, x0, zc0);
        tile_columns<unsigned char, 1, true>(m1, tile1, base, w, y, x0, zc0);
    } else {
        __syncthreads();
        tile_columns<unsigned, 3, false>(m4, tile4, base, w, y, x0, zc0);
        tile_columns<unsigned char, 1, false>(m1, tile1, base, w, y, x0, zc0);
        __syncthreads();
        tile_rows<unsigned, 3, false>(m4, tile4, L, w, y, x0, zc0);
        tile_rows<unsigned char, 1, false>(m1, tile1, L, w, y, x0, zc0);
    }
}

template <bool kIn>
int launch_convert(const Moves<unsigned>& m4, const Moves<unsigned char>& m1,
                   const long long* tab, const Layout& L, const Rows& w, cudaStream_t s) {
    // z = zc0 + sc - xr reaches down to -31 and up past q - 1
    const long long xtiles = (L.p + kTileX - 1) / kTileX;
    const long long stiles = (L.q + kTileX - 1 + kTileS - 1) / kTileS;
    const long long blocks = L.r * xtiles * stiles;
    if (blocks >= (1LL << 31) || m4.n > 3 || m1.n > 1)
        return static_cast<int>(cudaErrorInvalidValue);
    convert<kIn><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        m4, m1, tab, L, w, static_cast<int>(xtiles), static_cast<int>(stiles));
    return static_cast<int>(cudaGetLastError());
}

// ---- the sweep ------------------------------------------------------------------------

struct SweepArgs {      // every array plane-major, indexed by padded cell
    float* rec;
    const unsigned char* type;
    int* ints;          // decode: the bins (read); encode: the bins (written)
    const float* vals;  // decode: the literals; encode: the original values
    double eb, recip;
    int radius;
};

struct Plane {
    long long start;    // below3(t): the plane's first position
    long long pb[7];    // plane_base(t - d), d = 0 .. 6
    long long next;     // the next plane's first position of row y = kPad
    int first;          // the plane's first cell of row y = kPad, from start
    int end;            // the plane's cell count
    int top;            // below2(t + 1)
    int ahead;          // the next plane's cells from next on
};

__device__ __forceinline__ void prefetch_l2(const void* p) {
#ifdef __CUDA_ARCH__
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
#endif
}

// at(dk, dj, di): the reconstruction at (x - dj, y - dk, z - di), which lies
// in plane t - (dk + dj + di), in the row whose s is s - (dj + di)
#define AT(dk, dj, di) r[pb[(dk) + (dj) + (di)] + (z - (di) - h[(dj) + (di)])]

__device__ __forceinline__ float lorenzo1(const float* r, const long long* pb, const int* h,
                                          int z) {
    float p = AT(0, 0, 1);
    p = p + AT(0, 1, 0);
    p = p + AT(1, 0, 0);
    p = p - AT(0, 1, 1);
    p = p - AT(1, 0, 1);
    p = p - AT(1, 1, 0);
    p = p + AT(1, 1, 1);
    return p;
}

__device__ __forceinline__ float lorenzo2(const float* r, const long long* pb, const int* h,
                                          int z) {
    float p = 2.0f * AT(0, 0, 1);
    p = p - AT(0, 0, 2);
    p = p + 2.0f * AT(0, 1, 0);
    p = p - 4.0f * AT(0, 1, 1);
    p = p + 2.0f * AT(0, 1, 2);
    p = p - AT(0, 2, 0);
    p = p + 2.0f * AT(0, 2, 1);
    p = p - AT(0, 2, 2);
    p = p + 2.0f * AT(1, 0, 0);
    p = p - 4.0f * AT(1, 0, 1);
    p = p + 2.0f * AT(1, 0, 2);
    p = p - 4.0f * AT(1, 1, 0);
    p = p + 8.0f * AT(1, 1, 1);
    p = p - 4.0f * AT(1, 1, 2);
    p = p + 2.0f * AT(1, 2, 0);
    p = p - 4.0f * AT(1, 2, 1);
    p = p + 2.0f * AT(1, 2, 2);
    p = p - AT(2, 0, 0);
    p = p + 2.0f * AT(2, 0, 1);
    p = p - AT(2, 0, 2);
    p = p + 2.0f * AT(2, 1, 0);
    p = p - 4.0f * AT(2, 1, 1);
    p = p + 2.0f * AT(2, 1, 2);
    p = p - AT(2, 2, 0);
    p = p + 2.0f * AT(2, 2, 1);
    p = p - AT(2, 2, 2);
    return p;
}

#undef AT

template <bool kEncode>
__global__ void __launch_bounds__(kThreads) sweep_plane(SweepArgs a, Rows w, Plane pl) {
    const int k = blockIdx.x * kThreads + threadIdx.x;
    if (k < pl.ahead) {  // the next plane's inputs, into L2 before its launch
        prefetch_l2(a.type + pl.next + k);
        prefetch_l2(a.vals + pl.next + k);
        if (!kEncode) prefetch_l2(a.ints + pl.next + k);
    }
    const int i = pl.first + k;
    if (i >= pl.end) return;
    const long long cell = pl.start + i;
    // the cell's own inputs first: their latency overlaps finding the cell
    const unsigned char ty = a.type[cell];
    const float v = a.vals[cell];   // encode: the original value; decode: the literal
    const int b = kEncode ? 0 : a.ints[cell];
    int f;
    const int s = row_of(w, pl.top - i, f);  // the cell's x + z + 1
    const int zlo = s > w.p ? s - w.p : 0;
    const int z = zlo + i - (pl.top - f);
    const int x = s - 1 - z;
    if (x < kPad || z < kPad) return;  // the pad
    if (ty == kKeep) {
        if (kEncode) a.ints[cell] = 0;
        return;
    }
    int h[5];                          // row_shift(s - m)
    h[0] = f + zlo;
#pragma unroll
    for (int m = 1; m < 5; m++) {      // s - m >= 1: x, z >= kPad
        const int u = s - m;           // below2(u + 1) - below2(u): the pairs with x + z = u
        int c = u < w.p - 1 ? u : w.p - 1;
        c = c < w.q - 1 ? c : w.q - 1;
        c = c < w.p + w.q - 2 - u ? c : w.p + w.q - 2 - u;
        f -= c + 1;
        h[m] = f + (u > w.p ? u - w.p : 0);
    }
    const float* r = a.rec;
    const float pred = ty == kL2 ? lorenzo2(r, pl.pb, h, z) : lorenzo1(r, pl.pb, h, z);
    if (!kEncode) {
        if (b != 0) {
            // 2 * (b - radius) in int32 arithmetic, as the plain version's
            const int q = static_cast<int>(2u * (static_cast<unsigned>(b) -
                                                 static_cast<unsigned>(a.radius)));
            a.rec[cell] = static_cast<float>(static_cast<double>(pred) +
                                             static_cast<double>(q) * a.eb);
        } else {
            a.rec[cell] = v;
        }
        return;
    }
    // LinearQuantizer::quantize (ops/quantize.py::quantize, cell by cell)
    const float data = v;
    const float diff = data - pred;
    const double scaled = static_cast<double>(fabsf(diff)) * a.recip;
    // the engine's int64 cast: NaN and quotients of 2^63 and above give
    // INT64_MIN, so half is 0, q is -2^63 and only the error test decides
    const bool wild = !(scaled < 9223372036854775808.0);
    const double cap = 2.0 * a.radius;
    const int qi = wild ? 1 : static_cast<int>(scaled < cap ? scaled : cap) + 1;
    const int half = qi >> 1;
    const int qeven = half << 1;
    const bool neg = diff < 0.0f;
    const double q = wild ? -9223372036854775808.0 : static_cast<double>(neg ? -qeven : qeven);
    const int shifted = neg ? a.radius - half : a.radius + half;
    const float dec = static_cast<float>(static_cast<double>(pred) + q * a.eb);
    const double err = fabs(static_cast<double>(dec - data));
    const bool ok = (wild || qi < 2 * a.radius) && err <= a.eb;
    a.ints[cell] = ok ? shifted : 0;
    a.rec[cell] = ok ? dec : data;
}

// the padded extents of the (nx, ny, nz) rounded grid, or false where the
// layout's 32-bit counts of a plane's (x, z) pairs would not hold (p q >=
// 2^31: a grid far beyond the card's memory)
bool layout_of(int nx, int ny, int nz, Layout& L, Rows& w) {
    if (nx <= 0 || ny <= 0 || nz <= 0) return false;
    L = Layout{nx + 2LL, ny + 2LL, nz + 2LL};
    if (L.p * L.q >= (1LL << 31) || L.p + L.q + L.r >= (1LL << 31)) return false;
    const int p = static_cast<int>(L.p), q = static_cast<int>(L.q);
    const int a = p < q ? p : q, b = p < q ? q : p;
    w = Rows{p, q, a, b, static_cast<int>(tri(a)), static_cast<int>(tri(a - 1)),
             static_cast<int>(static_cast<long long>(a) * b - tri(a - 1)), p * q};
    return true;
}

// the plane table's bytes and where it starts in a scratch of 13 bytes a
// padded cell before it
long long table_offset(const Layout& L) { return (13 * L.p * L.r * L.q + 7) / 8 * 8; }
long long table_planes(const Layout& L) { return L.p + L.r + L.q - 2; }

int launch_table(long long* tab, const Layout& L, cudaStream_t s) {
    const int n = static_cast<int>(table_planes(L));
    plane_table<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(tab, L, n);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rec (nx+2, ny+2, nz+2) float32 in place; type (nx, ny, nz) uint8; ints
// (nx, ny, nz) int32 (decode: bins, read; encode: bins, written); vals (nx,
// ny, nz) float32 (decode: literals; encode: originals). scratch: 13 bytes
// a padded cell (the plane-major rec, ints, vals and type), rounded up to 8,
// then 8 bytes a plane (nx + ny + nz + 4) for the planes' first positions.
// Returns a cudaError_t.
extern "C" int szt_lorenzo_sweep(float* rec, const unsigned char* type, int* ints,
                                 const float* vals, int nx, int ny, int nz, double eb,
                                 double recip, int radius, int encode, void* scratch,
                                 long long scratch_bytes, void* stream) {
    Layout L;
    Rows w;
    if (!layout_of(nx, ny, nz, L, w) || radius <= 0 || radius >= (1 << 30))
        return static_cast<int>(cudaErrorInvalidValue);
    const long long n = L.p * L.r * L.q;
    if (scratch == nullptr || scratch_bytes < table_offset(L) + 8 * table_planes(L))
        return static_cast<int>(cudaErrorInvalidValue);
    float* rec_pm = static_cast<float*>(scratch);
    int* ints_pm = reinterpret_cast<int*>(rec_pm + n);
    float* vals_pm = reinterpret_cast<float*>(ints_pm + n);
    unsigned char* type_pm = reinterpret_cast<unsigned char*>(vals_pm + n);
    long long* tab = reinterpret_cast<long long*>(static_cast<char*>(scratch) + table_offset(L));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto u32 = [](const void* p) { return const_cast<unsigned*>(static_cast<const unsigned*>(p)); };

    Moves<unsigned> in4{{u32(rec), u32(vals), u32(ints)}, {u32(rec_pm), u32(vals_pm), u32(ints_pm)},
                        {0, kPad, kPad}, encode ? 2 : 3};
    Moves<unsigned char> in1{{const_cast<unsigned char*>(type)}, {type_pm}, {kPad}, 1};
    int rc = launch_table(tab, L, s);
    if (rc == 0) rc = launch_convert<true>(in4, in1, tab, L, w, s);
    if (rc != 0) return rc;

    const SweepArgs a{rec_pm, type_pm, ints_pm, vals_pm, eb, recip, radius};
    // planes t = 6 .. p + r + q - 3 hold the cells with x, y, z >= kPad
    long long pb[7];    // plane_base(t - d), slid along
    for (int d = 0; d < 7; d++) pb[d] = plane_base(L, 3 * kPad - 1 - d);
    for (long long t = 3 * kPad; t <= L.p + L.r + L.q - 3; t++) {
        Plane pl;
        for (int d = 6; d > 0; d--) pb[d] = pb[d - 1];
        pb[0] = plane_base(L, t);
        pl.start = below3(L, t);
        pl.end = static_cast<int>(below3(L, t + 1) - pl.start);
        pl.top = static_cast<int>(below2(L, t + 1));
        pl.first = static_cast<int>(pl.top - below2(L, t + 1 - kPad));
        for (int d = 0; d < 7; d++) pl.pb[d] = pb[d];
        pl.next = below3(L, t + 1) + below2(L, t + 2) - below2(L, t + 2 - kPad);
        pl.ahead = t < L.p + L.r + L.q - 3 ? static_cast<int>(below3(L, t + 2) - pl.next) : 0;
        const int cells = pl.end - pl.first > pl.ahead ? pl.end - pl.first : pl.ahead;
        const int blocks = (cells + kThreads - 1) / kThreads;
        if (encode)
            sweep_plane<true><<<blocks, kThreads, 0, s>>>(a, w, pl);
        else
            sweep_plane<false><<<blocks, kThreads, 0, s>>>(a, w, pl);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }

    Moves<unsigned> out4{{u32(rec), u32(ints)}, {u32(rec_pm), u32(ints_pm)}, {0, kPad},
                         encode ? 2 : 1};
    Moves<unsigned char> none{{nullptr}, {nullptr}, {0}, 0};
    return launch_convert<false>(out4, none, tab, L, w, s);
}
