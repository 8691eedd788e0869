// The MDZ frame recurrence of VQT and MT: frames 1..F-1 of a (frames, atoms)
// float32 batch, each atom quantized against its own reconstruction in the
// previous frame, in quantize form (encode) or recover form (decode).
//
// Replaces the XLA lax.scan of the JAX package's frame loop,
// sz3_tpu/ops/mdz_device.py::_jit_frames_encode (encode) and
// ::_jit_frames_decode (decode); there is no Pallas kernel for it. The plain
// PyTorch versions are frames_encode_plain and frames_recover_plain in
// sz3_tpu_torch/ops/mdz_device.py.
//
// An atom depends only on itself one frame back, so one thread owns one
// atom, keeps the previous frame's reconstruction in a register and walks
// every frame: one launch a call. The frames and the reconstruction are
// (frame, atom), read and written coalesced. The bins are in the archive's
// (atom, frame) order (host engine mdz.hpp:88-106, :184-202), where a
// thread's own values are consecutive and a warp's are a row apart. The
// encode stages its bins through shared memory in tiles of 32 frames, so
// that a warp stores one atom's 32 frames (128 bytes) at a time: the kernel
// writes the bins where the archive wants them, with no transpose after it.
// The recover reads its rows directly: the L1 cache holds a warp's sectors
// over eight frames (staging them through shared memory read slower on the
// card). It takes the literals as the archive holds them, compact in (atom,
// frame) order, with each atom's first slot: a thread reads a literal only
// where its bin is 0 and steps on to the next, so no dense literal grid is
// built or read.
//
// Bit-exactness. Built with -fmad=false (build.py): the f64 pred + q*eb
// rounds once per operation, as the host engine's -ffp-contract=off build
// and the plain versions do. The quantizer clamps |diff| / eb at 2*radius
// before the int cast, so no value reaches an undefined conversion; a
// quotient that is NaN or 2^63 and above takes what the engine's int64 cast
// gives on x86 (INT64_MIN), and the error test alone decides it. A literal
// keeps its original value for the next frame. 2 * (bin - radius) wraps in
// int32 as PyTorch's does. A radius of 0 or below (a quantbin under 2)
// makes every other cell a literal.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct FramesArgs {
    const float* vals;    // encode: the originals (frames, atoms); recover: the literals, compact
    const long long* starts;  // recover: each atom's first literal slot (atoms,); encode: unused
    long long lits;       // recover: the literals in vals; encode: unused
    int* ints;            // the bins (atoms, frames): written (encode) or read (recover)
    float* rec;           // recover: the reconstruction (frames, atoms), written; encode: unused
    const float* recon0;  // frame 0's reconstruction, (atoms,)
    long long frames;     // F - 1: the frames the kernel walks
    int atoms;
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

// LinearQuantizer::recover (ops/quantize.py::recover, one cell of a nonzero bin)
__device__ __forceinline__ float recover(float pred, int b, double eb, int radius) {
    const int q = static_cast<int>(2u * (static_cast<unsigned>(b) - static_cast<unsigned>(radius)));
    return static_cast<float>(static_cast<double>(pred) + static_cast<double>(q) * eb);
}

constexpr int kTile = 32;                 // frames a tile: a warp's width
constexpr int kWarps = kThreads / 32;

// quantize form: a tile's bins go through shared memory, one row an atom (the
// odd row length keeps both access patterns free of bank conflicts), and out
// an atom's 32 frames a warp store
__global__ void __launch_bounds__(kThreads) encode_kernel(FramesArgs a) {
    __shared__ int tile[kThreads][kTile + 1];
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    const int j0 = blockIdx.x * kThreads;
    const int j = j0 + threadIdx.x;
    const bool live = j < a.atoms;
    float prev = live ? a.recon0[j] : 0.0f;
    for (long long t0 = 0; t0 < a.frames; t0 += kTile) {
        const int n = a.frames - t0 < kTile ? static_cast<int>(a.frames - t0) : kTile;
        if (live) {
            float val = a.vals[t0 * a.atoms + j];
            for (int tt = 0; tt < n; tt++) {
                const float cur = val;
                if (tt + 1 < n) val = a.vals[(t0 + tt + 1) * a.atoms + j];   // ahead
                tile[threadIdx.x][tt] = quantize(cur, prev, prev, a.eb, a.recip, a.radius);
            }
        }
        __syncthreads();
        for (int r = warp; r < kThreads; r += kWarps) {
            if (j0 + r < a.atoms && lane < n)
                a.ints[static_cast<long long>(j0 + r) * a.frames + t0 + lane] = tile[r][lane];
        }
        __syncthreads();
    }
}

// recover form: a thread reads its own consecutive bins (the warp's rows
// share sectors over eight frames, which the L1 cache holds), reads the next
// of its literals where a bin is 0, and writes the reconstruction coalesced;
// the next frame's bin is loaded ahead of this frame's arithmetic. A slot
// outside the literals (slots that disagree with the bins) reads as NaN, not
// past the buffer.
__global__ void __launch_bounds__(kThreads) recover_kernel(FramesArgs a) {
    const int j = blockIdx.x * kThreads + threadIdx.x;
    if (j >= a.atoms) return;
    const long long own = static_cast<long long>(j) * a.frames;
    unsigned long long slot = static_cast<unsigned long long>(a.starts[j]);
    float prev = a.recon0[j];
    int bin = a.ints[own];
    for (long long t = 0; t < a.frames; t++) {
        const int cb = bin;
        if (t + 1 < a.frames) bin = a.ints[own + t + 1];
        if (cb != 0)
            prev = recover(prev, cb, a.eb, a.radius);
        else
            prev = slot < static_cast<unsigned long long>(a.lits) ? a.vals[slot++] : nanf("");
        a.rec[t * a.atoms + j] = prev;
    }
}

}  // namespace

// encode: vals (frames, atoms) float32, the originals; ints (atoms, frames)
// int32, the bins written; starts and rec unused. recover: ints (atoms,
// frames) int32, the bins read; vals float32, the `lits` literals of the
// zero bins in (atom, frame) order; starts (atoms,) int64, the slot in vals
// of each atom's first literal (an exclusive prefix sum of the atoms'
// zero-bin counts); rec (frames, atoms) float32, the reconstruction written.
// recon0 (atoms,) float32. `frames` counts the frames after frame 0. Returns
// a cudaError_t.
extern "C" int szt_mdz_frames(const float* vals, const long long* starts, long long lits,
                              int* ints, float* rec, const float* recon0, long long frames,
                              int atoms, double eb, double recip, int radius, int encode,
                              void* stream) {
    if (frames <= 0 || atoms <= 0 || radius <= -(1 << 30) || radius >= (1 << 30) ||
        (!encode && (rec == nullptr || starts == nullptr || lits < 0)))
        return static_cast<int>(cudaErrorInvalidValue);
    const FramesArgs a{vals, starts, lits, ints, rec, recon0, frames, atoms, eb, recip, radius};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned blocks = static_cast<unsigned>((atoms + kThreads - 1) / kThreads);
    if (encode)
        encode_kernel<<<blocks, kThreads, 0, s>>>(a);
    else
        recover_kernel<<<blocks, kThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
}
