// The element sweep of ALGO_LORENZO_REG: every Lorenzo cell of a 3D field,
// plane by anti-diagonal plane, in recover form (decode) or quantize form
// (encode).
//
// Replaces the XLA lax.scan of the JAX package's element sweep,
// sz3_tpu/ops/blockwise_wavefront.py::_jit_wavefront (decode) and
// sz3_tpu/ops/blockwise_wavefront_encode.py::_jit_wavefront_enc (encode);
// there is no Pallas kernel for it. The plain PyTorch versions are
// sweep_decode_plain and sweep_encode_plain in sz3_tpu_torch/ops/.
//
// The first- and second-order Lorenzo stencils read the reconstruction at
// offsets that are non-positive in every axis and sum to at least 1, so the
// cells of plane t = x + y + z depend only on planes before t. One launch
// per plane, a thread per (y, z) of the plane's rows, x = t - y - z; the
// host loop walks the NX + NY + NZ - 2 planes, so Python makes one call per
// sweep. The grid is the rounded grid (multiples of 6 per axis), unskewed
// and front-padded by 2 with zeros: rec is (NX+2, NY+2, NZ+2) float32,
// updated in place; type, bins/vals are (NX, NY, NZ). Cells of type KEEP
// (regression blocks, placed before the sweep, and cells outside the field)
// are left as they are; the encode writes bin 0 there.
//
// What bounds it on the card: the planes' dependency, not bytes. Each plane
// is one launch of a few hundred blocks, and its cells read 7 (L1) or 26
// (L2) neighbours scattered over as many rows as the warp's lanes span
// (x falls by one from lane to lane). The 256^3 field is 772 launches of
// 66,564 threads; the bytes it must move (some 9 bytes a cell decoding, 13
// encoding) would take 0.05 and 0.07 ms at 3.35 TB/s, the launches alone
// more.
// A persistent kernel or a CUDA graph is the next step if the sweep sets
// the pace of a call.
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

namespace {

constexpr int kThreads = 256;
constexpr int kPad = 2;
constexpr unsigned char kL2 = 1, kKeep = 2;

struct SweepArgs {
    float* rec;
    const unsigned char* type;
    int* ints;          // decode: the bins (read); encode: the bins (written)
    const float* vals;  // decode: the literals; encode: the original values
    int nx, ny, nz;
    double eb, recip;
    int radius;
};

__device__ __forceinline__ float lorenzo1(const float* r, long long sx, long long sy) {
    // at(dk, dj, di) = r[-(dj * sx + dk * sy + di)]
    float p = r[-1];
    p = p + r[-sx];
    p = p + r[-sy];
    p = p - r[-sx - 1];
    p = p - r[-sy - 1];
    p = p - r[-sx - sy];
    p = p + r[-sx - sy - 1];
    return p;
}

__device__ __forceinline__ float lorenzo2(const float* r, long long sx, long long sy) {
#define AT(dk, dj, di) r[-((dj) * sx + (dk) * sy + (di))]
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
#undef AT
    return p;
}

template <bool kEncode>
__global__ void __launch_bounds__(kThreads) sweep_plane(SweepArgs a, int t, int y0,
                                                        long long ncells) {
    const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (i >= ncells) return;
    const int y = y0 + static_cast<int>(i / a.nz);
    const int z = static_cast<int>(i % a.nz);
    const int x = t - y - z;
    if (x < 0 || x >= a.nx) return;
    const long long cell = (static_cast<long long>(x) * a.ny + y) * a.nz + z;
    const unsigned char ty = a.type[cell];
    if (ty == kKeep) {
        if (kEncode) a.ints[cell] = 0;
        return;
    }
    const long long sy = a.nz + kPad;
    const long long sx = (a.ny + kPad) * sy;
    float* r = a.rec + (x + kPad) * sx + (y + kPad) * sy + (z + kPad);
    const float pred = ty == kL2 ? lorenzo2(r, sx, sy) : lorenzo1(r, sx, sy);
    if (!kEncode) {
        const int b = a.ints[cell];
        if (b != 0) {
            // 2 * (b - radius) in int32 arithmetic, as the plain version's
            const int q = static_cast<int>(2u * (static_cast<unsigned>(b) -
                                                 static_cast<unsigned>(a.radius)));
            *r = static_cast<float>(static_cast<double>(pred) + static_cast<double>(q) * a.eb);
        } else {
            *r = a.vals[cell];
        }
        return;
    }
    // LinearQuantizer::quantize (ops/quantize.py::quantize, cell by cell)
    const float data = a.vals[cell];
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
    *r = ok ? dec : data;
}

}  // namespace

// rec (nx+2, ny+2, nz+2) float32 in place; type (nx, ny, nz) uint8; ints
// (nx, ny, nz) int32 (decode: bins, read; encode: bins, written); vals (nx,
// ny, nz) float32 (decode: literals; encode: originals). Returns a
// cudaError_t.
extern "C" int szt_lorenzo_sweep(float* rec, const unsigned char* type, int* ints,
                                 const float* vals, int nx, int ny, int nz, double eb,
                                 double recip, int radius, int encode, void* stream) {
    if (nx <= 0 || ny <= 0 || nz <= 0 || radius <= 0 || radius >= (1 << 30))
        return static_cast<int>(cudaErrorInvalidValue);
    const SweepArgs a{rec, type, ints, vals, nx, ny, nz, eb, recip, radius};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    for (int t = 0; t <= nx + ny + nz - 3; t++) {
        // rows y of plane t that hold a cell: x = t - y - z in [0, nx), z in [0, nz)
        const int y0 = t - (nx - 1) - (nz - 1) > 0 ? t - (nx - 1) - (nz - 1) : 0;
        const int y1 = t < ny - 1 ? t : ny - 1;
        const long long ncells = static_cast<long long>(y1 - y0 + 1) * nz;
        const unsigned blocks = static_cast<unsigned>((ncells + kThreads - 1) / kThreads);
        if (encode)
            sweep_plane<true><<<blocks, kThreads, 0, s>>>(a, t, y0, ncells);
        else
            sweep_plane<false><<<blocks, kThreads, 0, s>>>(a, t, y0, ncells);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}
