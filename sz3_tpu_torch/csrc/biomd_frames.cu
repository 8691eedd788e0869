// ALGO_BIOMD's frame recurrence: frames 1..F-1 of a (frames, atoms, cols)
// float32 trajectory, in quantize form (encode) or recover form (decode).
//
// Replaces the XLA lax.scan of the JAX package's frame loop,
// sz3_tpu/ops/biomd_device.py::_encode_scan (encode) and ::_decode_scan
// (decode); there is no Pallas kernel for it. The plain PyTorch versions are
// frames_encode_plain and frames_recover_plain in
// sz3_tpu_torch/ops/biomd_device.py.
//
// The reference (SZBioMDDecomposition.hpp:229-285) predicts the boundary
// atom b of each molecule (b % site == 0) from the previous frame, and every
// other atom j of the molecule from pred = (rec(t-1, j) + rec(t, b)) -
// rec(t-1, b), in float32 and in that order. So an atom depends on the
// previous frame and on its own molecule's boundary atom in the same frame:
// one thread per (molecule, column) walks the frames and keeps the previous
// frame's reconstruction of its molecule's site atoms in registers. Atoms
// past the last whole molecule (atoms not a multiple of site) are lanes the
// thread skips. One launch a call.
//
// Each frame the thread reads `site` values and writes `site` results,
// strided by cols floats across lanes of one molecule; the loads of the next
// frame are issued before the current frame's arithmetic.
//
// Bit-exactness. Built with -fmad=false (build.py): the f32 (a + b) - c and
// the f64 pred + q*eb round once per operation, as the host engine's
// -ffp-contract=off build and the plain versions do. The quantizer clamps
// |diff| / eb at 2*radius before the int cast, so no value reaches an
// undefined conversion; a quotient that is NaN or 2^63 and above takes what
// the engine's int64 cast gives on x86 (INT64_MIN), and the error test alone
// decides it. 2 * (bin - radius) wraps in int32 as PyTorch's does.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct FramesArgs {
    const float* vals;    // encode: the originals; recover: the literal grid
    int* ints;            // encode: the bins (written); recover: the bins (read)
    float* rec;           // recover: the reconstruction (written); encode: unused
    const float* recon0;  // frame 0's reconstruction, (atoms, cols)
    long long frames;     // F - 1: the frames the kernel walks
    int atoms, cols, groups;
    double eb, recip;
    int radius;
};

// LinearQuantizer::quantize (ops/quantize.py::quantize, one cell)
__device__ __forceinline__ int quantize(float data, float pred, float& rec, double eb,
                                        double recip, int radius) {
    const float diff = data - pred;
    const double scaled = static_cast<double>(fabsf(diff)) * recip;
    // the engine's int64 cast: NaN and quotients of 2^63 and above give
    // INT64_MIN, so half is 0, q is -2^63 and only the error test decides
    const bool wild = !(scaled < 9223372036854775808.0);
    const double cap = 2.0 * radius;
    const int qi = wild ? 1 : static_cast<int>(scaled < cap ? scaled : cap) + 1;
    const int half = qi >> 1;
    const int qeven = half << 1;
    const bool neg = diff < 0.0f;
    const double q = wild ? -9223372036854775808.0 : static_cast<double>(neg ? -qeven : qeven);
    const int shifted = neg ? radius - half : radius + half;
    const float dec = static_cast<float>(static_cast<double>(pred) + q * eb);
    const double err = fabs(static_cast<double>(dec - data));
    const bool ok = (wild || qi < 2 * radius) && err <= eb;
    rec = ok ? dec : data;
    return ok ? shifted : 0;
}

// LinearQuantizer::recover (ops/quantize.py::recover, one cell)
__device__ __forceinline__ float recover(float pred, int b, float lit, double eb, int radius) {
    if (b == 0) return lit;
    const int q = static_cast<int>(2u * (static_cast<unsigned>(b) - static_cast<unsigned>(radius)));
    return static_cast<float>(static_cast<double>(pred) + static_cast<double>(q) * eb);
}

template <int SITE, bool kEncode>
__global__ void __launch_bounds__(kThreads) frames_kernel(FramesArgs a) {
    const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (i >= static_cast<long long>(a.groups) * a.cols) return;
    const int g = static_cast<int>(i / a.cols);
    const int c = static_cast<int>(i % a.cols);
    const int a0 = g * SITE;
    const int lanes = a.atoms - a0 < SITE ? a.atoms - a0 : SITE;
    const long long fstride = static_cast<long long>(a.atoms) * a.cols;
    const long long base = static_cast<long long>(a0) * a.cols + c;

    float prev[SITE];
    float val[SITE];
    int bin[SITE];
#pragma unroll
    for (int l = 0; l < SITE; l++) {
        prev[l] = l < lanes ? a.recon0[base + l * a.cols] : 0.0f;
        val[l] = 0.0f;
        bin[l] = 0;
    }
    // frame 0 of the walk (trajectory frame 1)
#pragma unroll
    for (int l = 0; l < SITE; l++) {
        if (l < lanes) {
            val[l] = a.vals[base + l * a.cols];
            if (!kEncode) bin[l] = a.ints[base + l * a.cols];
        }
    }
    for (long long t = 0; t < a.frames; t++) {
        const long long off = t * fstride + base;
        float cur[SITE];
        int cb[SITE];
#pragma unroll
        for (int l = 0; l < SITE; l++) {
            cur[l] = val[l];
            cb[l] = bin[l];
        }
        if (t + 1 < a.frames) {   // the next frame's loads, ahead of this frame's work
#pragma unroll
            for (int l = 0; l < SITE; l++) {
                if (l < lanes) {
                    val[l] = a.vals[off + fstride + l * a.cols];
                    if (!kEncode) bin[l] = a.ints[off + fstride + l * a.cols];
                }
            }
        }
        float rb;
        if (kEncode) {
            a.ints[off] = quantize(cur[0], prev[0], rb, a.eb, a.recip, a.radius);
        } else {
            rb = recover(prev[0], cb[0], cur[0], a.eb, a.radius);
            a.rec[off] = rb;
        }
        const float pb = prev[0];
#pragma unroll
        for (int l = 1; l < SITE; l++) {
            if (l < lanes) {
                const float pred = (prev[l] + rb) - pb;
                float r;
                if (kEncode) {
                    a.ints[off + l * a.cols] = quantize(cur[l], pred, r, a.eb, a.recip, a.radius);
                } else {
                    r = recover(pred, cb[l], cur[l], a.eb, a.radius);
                    a.rec[off + l * a.cols] = r;
                }
                prev[l] = r;
            }
        }
        prev[0] = rb;
    }
}

template <int SITE>
cudaError_t launch(const FramesArgs& a, bool encode, cudaStream_t s) {
    const long long n = static_cast<long long>(a.groups) * a.cols;
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    if (encode)
        frames_kernel<SITE, true><<<blocks, kThreads, 0, s>>>(a);
    else
        frames_kernel<SITE, false><<<blocks, kThreads, 0, s>>>(a);
    return cudaGetLastError();
}

}  // namespace

// vals (frames, atoms, cols) float32: the originals (encode) or the literals
// at the zero bins (recover); ints (frames, atoms, cols) int32: the bins,
// written (encode) or read (recover); rec (frames, atoms, cols) float32, the
// reconstruction (recover; unused in encode); recon0 (atoms, cols) float32.
// `frames` counts the frames after frame 0. Returns a cudaError_t.
extern "C" int szt_biomd_frames(const float* vals, int* ints, float* rec, const float* recon0,
                                long long frames, int atoms, int cols, int site, double eb,
                                double recip, int radius, int encode, void* stream) {
    if (frames <= 0 || atoms <= 0 || cols <= 0 || radius <= 0 || radius >= (1 << 30) ||
        (!encode && rec == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const int groups = (atoms + site - 1) / site;
    if (static_cast<long long>(groups) * cols >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    const FramesArgs a{vals, ints, rec, recon0, frames, atoms, cols, groups, eb, recip, radius};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool enc = encode != 0;
    switch (site) {
        case 3: return static_cast<int>(launch<3>(a, enc, s));
        case 4: return static_cast<int>(launch<4>(a, enc, s));
        case 5: return static_cast<int>(launch<5>(a, enc, s));
        case 6: return static_cast<int>(launch<6>(a, enc, s));
        case 7: return static_cast<int>(launch<7>(a, enc, s));
        case 8: return static_cast<int>(launch<8>(a, enc, s));
        case 9: return static_cast<int>(launch<9>(a, enc, s));
        case 10: return static_cast<int>(launch<10>(a, enc, s));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
