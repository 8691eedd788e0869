// Histogram and literal slots of the stream-order bins.
//
// Replaces the Pallas kernel sz3_tpu/ops/entropy_device.py::_hist_kernel
// (entry hist_and_literals). Contract: the exact histogram of
// sym_index(bins) over the whole symbol range of the quantizer (n_sym + 2
// entries, block_scan.cuh), and the stream slots of the bin==0 symbols, in
// stream order. The TPU kernel counts only a 16380-bin window around radius
// (its one-hot histogram is an MXU tile) and sends every other symbol to a
// TRASH bucket, which makes the host take over; here every symbol is counted.
// Integer counts do not depend on the order of the atomics, so the result is
// the same from run to run.
//
// What bounds it on the card: bytes moved, the bins read once (4 B a
// symbol). An earlier design (1024 blocks, each over one run of 16,384
// symbols, one 4-byte load a thread followed by a shared atomic, a 65 KB
// shared histogram zeroed and flushed by every block) reached 13 % of that
// bound at 256^3: few bytes in flight, three blocks an SM, and a placement
// pass that walked whole runs. This design, with the readings that chose it
// (NVIDIA H100 80GB HBM3, 256^3 and 512^3 streams of bench.nyx_like; PERF.md):
//   - Persistent blocks, four an SM, each over one contiguous run of tiles
//     of 4096 symbols. A thread counts 16 symbols of a tile from four
//     16-byte loads, all issued before the first is used; a block's loads
//     are 512 contiguous bytes a warp. Eight loads a thread need 127
//     registers and read 36 % slower; blocks that stride over the tiles
//     (which makes the placement wait for a scan of the tiles' counts) read
//     20 % slower at 256^3 and 32 % at 512^3.
//   - The hot loop only counts into shared memory: bin 0, SENTINEL and a
//     window of +-2048 bins around radius (16 KB, so four blocks fit an SM;
//     every symbol of the 256^3 and 512^3 fields lies within +-1649, and
//     +-512, +-2048 and +-8190 windows read within 3 % at three blocks an
//     SM, while +-8190 does not fit four). A symbol outside the window goes
//     to a trash slot that is never flushed and is marked in a register;
//     after the tile, a warp with a marked symbol counts those symbols with
//     global atomics from its registers (the bins are not read twice, and
//     the hot loop holds no global atomic).
//   - Contention: neighbouring stream slots often carry the same symbol. A
//     thread adds each run of equal slots among its 16 with one shared
//     atomic. A warp-wide __match_any_sync per symbol (one atomic per
//     distinct slot per warp) took twice as long on every stream tried.
//   - The literal slots must come out in stream order: an atomic append
//     would order them differently from run to run and change the archive
//     bytes. The count pass adds the zeros of each tile and of each block
//     into counts (one global atomic per warp that met a zero). The host
//     reads the histogram back once (its entry 0 is the literal count) and
//     sizes the slots; the placement pass then runs while the host builds
//     the Huffman tree: each block with zeros sums the counts of the blocks
//     before it, walks its own tiles, skips every tile without a zero, and
//     places each zero of the others at its rank from a block scan. No
//     device-wide scan and no look-back: the 256^3 stream has zeros in 85
//     of its 4096 tiles.
// No float arithmetic.

#include <cuda_runtime.h>

#include "block_scan.cuh"

using namespace szt_cuda;

namespace {

constexpr int kWHalf = 2048;            // half-width of the shared window around radius
constexpr int kWin = 2 * kWHalf;        // window length, in symbol indices
constexpr int kShared = 2 + kWin;       // flushed shared slots: bin 0, SENTINEL, window
constexpr int kTrash = kShared;         // one more slot: symbols the window does not hold
constexpr int kLoads = 4;               // 16-byte loads a thread makes per tile
constexpr int kPer = 4 * kLoads;        // symbols a thread counts per tile
constexpr int kTile = kThreads * kPer;  // symbols of a tile (the wrapper's _K1_TILE)
constexpr unsigned kAll = 0xffffffffu;

// First stream slot of this thread's load q in tile t. A load of the block
// covers 4 * kThreads consecutive slots, so each warp load is 512
// contiguous bytes.
__device__ __forceinline__ long long first_of(long long t, int q) {
    return t * kTile + q * (kThreads * 4) + threadIdx.x * 4;
}

// The tiles [lo, hi) of this block: contiguous, so that the block's zeros
// are one run of the literal slots.
__device__ __forceinline__ void block_tiles(long long tiles, long long& lo, long long& hi) {
    lo = blockIdx.x * tiles / gridDim.x;
    hi = (blockIdx.x + 1) * tiles / gridDim.x;
}

// Tiles [0, whole) are read with 16-byte loads; the rest (the stream's
// ragged end, or every tile of bins that are not 16-byte aligned) slot by
// slot.
__device__ __forceinline__ long long whole_tiles(const int* bins, long long n) {
    return (reinterpret_cast<unsigned long long>(bins) & 15) ? 0 : n / kTile;
}

// This thread's kPer bins of tile t. kWhole: the tile lies inside the
// stream and the bins are 16-byte aligned; otherwise bins past n read as
// SENTINEL and `valid` clears their bits.
template <bool kWhole>
__device__ __forceinline__ unsigned load_tile(const int* __restrict__ bins, long long n,
                                              long long t, int (&b)[kPer]) {
    if (kWhole) {
#pragma unroll
        for (int q = 0; q < kLoads; ++q) {
            const int4 v = __ldg(reinterpret_cast<const int4*>(bins + first_of(t, q)));
            b[4 * q] = v.x;
            b[4 * q + 1] = v.y;
            b[4 * q + 2] = v.z;
            b[4 * q + 3] = v.w;
        }
        return kAll;
    }
    unsigned valid = 0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
        const long long i = first_of(t, e / 4) + e % 4;
        b[e] = i < n ? bins[i] : kSentinel;
        valid |= static_cast<unsigned>(i < n) << e;
    }
    return valid;
}

// Counts this thread's bins of tile t into the shared histogram (the
// window's out-of-range symbols into hist) and the tile's zeros into
// tile_zeros[t]; returns the thread's zeros.
template <bool kWhole>
__device__ __forceinline__ int count_tile(const int* __restrict__ bins, long long n, long long t,
                                          int n_sym, unsigned bw_lo, unsigned wlen, int* sh,
                                          int* __restrict__ hist, int* __restrict__ tile_zeros) {
    int b[kPer];
    const unsigned valid = load_tile<kWhole>(bins, n, t, b);
    int s[kPer];
    int zeros = 0;
    unsigned cold = 0;                  // symbols that go to the trash slot and count
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
        const unsigned d = static_cast<unsigned>(b[e]) - bw_lo;
        s[e] = d < wlen ? static_cast<int>(d) + 2
                        : (b[e] == 0 ? 0 : (b[e] == kSentinel ? 1 : kTrash));
        if (!kWhole && !(valid >> e & 1u)) s[e] = kTrash;
        zeros += s[e] == 0;
        cold |= static_cast<unsigned>(s[e] == kTrash) << e;
    }
    cold &= valid;
    // one shared atomic per run of equal slots
    int cur = s[0], run = 1;
#pragma unroll
    for (int e = 1; e < kPer; ++e) {
        if (s[e] == cur) {
            ++run;
        } else {
            atomicAdd(&sh[cur], run);
            cur = s[e];
            run = 1;
        }
    }
    atomicAdd(&sh[cur], run);
    if (__any_sync(kAll, cold)) {
#pragma unroll
        for (int e = 0; e < kPer; ++e)
            if (cold >> e & 1u) atomicAdd(&hist[sym_index(b[e], n_sym)], 1);
    }
    const int wz = __reduce_add_sync(kAll, zeros);
    if ((threadIdx.x & 31) == 0 && wz) atomicAdd(&tile_zeros[t], wz);
    return zeros;
}

__global__ void __launch_bounds__(kThreads)
hist_count_kernel(const int* __restrict__ bins, long long n, int n_sym, int win_lo,
                  int* __restrict__ hist, int* __restrict__ tile_zeros,
                  int* __restrict__ block_zeros) {
    __shared__ int sh[kShared + 1];
    for (int i = threadIdx.x; i <= kShared; i += kThreads) sh[i] = 0;
    __syncthreads();
    // slot 2 + d holds bin bw_lo + d (symbol index win_lo + d) for d < wlen
    const int win_hi = min(win_lo + kWin, n_sym + 1);
    const unsigned bw_lo = static_cast<unsigned>(win_lo - 1);
    const unsigned wlen = static_cast<unsigned>(win_hi - win_lo);
    long long t, hi;
    block_tiles((n + kTile - 1) / kTile, t, hi);
    const long long whole = min(hi, whole_tiles(bins, n));
    int zeros = 0;
    for (; t < whole; ++t)
        zeros += count_tile<true>(bins, n, t, n_sym, bw_lo, wlen, sh, hist, tile_zeros);
    for (; t < hi; ++t)
        zeros += count_tile<false>(bins, n, t, n_sym, bw_lo, wlen, sh, hist, tile_zeros);
    const int wz = __reduce_add_sync(kAll, zeros);
    if ((threadIdx.x & 31) == 0 && wz) atomicAdd(&block_zeros[blockIdx.x], wz);
    __syncthreads();
    for (int i = threadIdx.x; i < 2 + static_cast<int>(wlen); i += kThreads) {
        const int v = sh[i];
        if (v) atomicAdd(&hist[i < 2 ? i : win_lo + i - 2], v);
    }
}

__global__ void __launch_bounds__(kThreads)
literal_slots_kernel(const int* __restrict__ bins, long long n,
                     const int* __restrict__ tile_zeros, const int* __restrict__ block_zeros,
                     int* __restrict__ slots) {
    __shared__ int ws[kWarps];
    if (block_zeros[blockIdx.x] == 0) return;
    int before = 0;                     // the zeros of the blocks before this one
    for (int i = threadIdx.x; i < static_cast<int>(blockIdx.x); i += kThreads)
        before += block_zeros[i];
    int base;
    block_exclusive_scan<int>(before, ws, base);
    long long lo, hi;
    block_tiles((n + kTile - 1) / kTile, lo, hi);
    const long long whole = whole_tiles(bins, n);
    for (long long t = lo; t < hi; ++t) {
        if (tile_zeros[t] == 0) continue;
        int b[kPer];
        if (t < whole)
            load_tile<true>(bins, n, t, b);
        else
            load_tile<false>(bins, n, t, b);
        // load q covers consecutive stream slots, thread by thread
#pragma unroll
        for (int q = 0; q < kLoads; ++q) {
            int z = 0;
#pragma unroll
            for (int k = 0; k < 4; ++k) z += b[4 * q + k] == 0;
            int total;
            int at = base + block_exclusive_scan<int>(z, ws, total);
#pragma unroll
            for (int k = 0; k < 4; ++k)
                if (b[4 * q + k] == 0) slots[at++] = static_cast<int>(first_of(t, q) + k);
            base += total;
        }
    }
}

}  // namespace

// Count pass over `blocks` persistent blocks. buf holds the histogram
// (n_sym + 2 entries), then the zero counts (one per tile of kTile slots,
// then one per block); it is zeroed here. The histogram's copy to host_hist
// (page-locked, n_sym + 2 entries) is queued behind the count on the stream.
// win_lo >= 2 is the first symbol index of the shared window.
extern "C" int szt_hist_count(const int* bins, long long n, int n_sym, int win_lo, int blocks,
                              int* buf, int* host_hist, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long tiles = (n + kTile - 1) / kTile;
    const size_t hist_bytes = (n_sym + 2) * sizeof(int);
    cudaError_t e = cudaMemsetAsync(buf, 0, hist_bytes + (tiles + blocks) * sizeof(int), s);
    if (e != cudaSuccess) return static_cast<int>(e);
    int* zeros = buf + n_sym + 2;
    hist_count_kernel<<<blocks, kThreads, 0, s>>>(bins, n, n_sym, win_lo, buf, zeros,
                                                  zeros + tiles);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(
        cudaMemcpyAsync(host_hist, buf, hist_bytes, cudaMemcpyDeviceToHost, s));
}

// Placement pass over the count pass's blocks and zero counts (`zeros`, as
// the count pass left them): slots[zeros of the blocks before + rank in the
// block] = stream slot of each zero.
extern "C" int szt_literal_slots(const int* bins, long long n, int blocks, const int* zeros,
                                 int* slots, void* stream) {
    const long long tiles = (n + kTile - 1) / kTile;
    literal_slots_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        bins, n, zeros, zeros + tiles, slots);
    return static_cast<int>(cudaGetLastError());
}
