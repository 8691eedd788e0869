"""Device Huffman entropy stage, encode side (counterpart of
sz3_tpu/ops/entropy_device.py).

Two kernels turn the stream-order bins into the reference Huffman bitstream
(HuffmanEncoder.hpp:135-218: the MSB-first concatenation of the symbols'
codes) without the bins leaving the device:

  hist_and_literals  csrc/hist_literals.cu, replaces _hist_kernel (K1): the
                     exact histogram over the symbol-index space, read back
                     to the host once, and the stream slots of the bin==0
                     symbols in stream order, placed on the card while the
                     host builds the Huffman tree from that histogram.
  pack_bits          csrc/pack_bits.cu, replaces _pack_kernel (K2) and
                     _splice_kernel (K3): code lookup, an int64 exclusive scan
                     of the code lengths, and the codes joined into words in
                     registers and shared memory, tile by tile. One
                     device-wide scan gives every symbol its global offset,
                     so the TPU's per-segment pack and global splice collapse
                     into one kernel.

Each wrapper runs its plain PyTorch version when handed a CPU tensor, and
only then. For a CUDA tensor it launches the kernel or raises. ``launches``
on each wrapper counts its kernel launches.

Symbol index (the histogram's and the code tables' index space), for the
bins of a quantizer of radius r, which lie in [0, 2r): 0 -> bin 0,
1 -> SENTINEL, b + 1 -> bin b in [1, 2r), and 2r + 1 -> anything else (the
invalid bucket: no quantizer writes such a bin, and the host raises when it
is hit). Every symbol the quantizer can write has its own entry, so no input
leaves the device path.
"""

from __future__ import annotations

import torch

from ..build import kernels

W_HALF = 8190                       # half-width of the JAX package's histogram window
K1_W_HALF = 2048                    # half-width of K1's shared window (kWHalf in its source)
SENTINEL = -1

_THREADS = 256                      # block size of both kernels (csrc/*.cu)
_MAX_BLOCKS = 1024
_PACK_TILE = _THREADS * 8           # symbols of one tile of csrc/pack_bits.cu
_K1_TILE = _THREADS * 16            # symbols of one tile of csrc/hist_literals.cu (kTile)
_K1_BLOCKS_PER_SM = 4               # K1's persistent blocks on each SM


def table_len(radius: int) -> int:
    """Entries of the histogram and of each code table."""
    return 2 * radius + 2


def _sym_index(bins: torch.Tensor, radius: int) -> torch.Tensor:
    """bins -> symbol index."""
    n_sym = 2 * radius
    idx = torch.where((bins > 0) & (bins < n_sym), bins + 1, n_sym + 1)
    idx = torch.where(bins == 0, 0, idx)
    idx = torch.where(bins == SENTINEL, 1, idx)
    return idx.to(torch.int32)


def _partition(n: int, tile: int = 1):
    """(blocks, elements per block, a multiple of `tile`): each block owns one
    contiguous run of the stream, so per-block results concatenate in stream
    order."""
    blocks = max(1, min(_MAX_BLOCKS, -(-n // (_THREADS * 16))))
    per_block = -(-n // (blocks * tile)) * tile
    return -(-n // per_block), per_block


def _check_bins(bins: torch.Tensor, radius: int) -> None:
    if not 0 < radius < 2 ** 30:
        raise ValueError(f"radius {radius} outside [1, 2^30)")
    if bins.dtype != torch.int32 or bins.dim() != 1 or not bins.is_contiguous():
        raise ValueError("bins must be a contiguous 1-D int32 tensor")
    if bins.numel() == 0 or bins.numel() >= 2 ** 31:
        raise ValueError(f"stream length {bins.numel()} outside [1, 2^31)")
    if bins.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {bins.device}")


def _ok(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


# ---- K1: histogram + literal slots ---------------------------------------------

def hist_and_literals_plain(bins: torch.Tensor, radius: int):
    """Plain version of :func:`hist_and_literals`."""
    hist = torch.bincount(_sym_index(bins, radius).to(torch.int64),
                          minlength=table_len(radius))
    slots = torch.nonzero(bins == 0).reshape(-1).to(torch.int32)
    return hist.to(torch.int32), slots


def _k1_grid(n: int, sms: int):
    """(tiles, persistent blocks) of K1 for a stream of n symbols on a card
    with `sms` SMs: tile t holds stream slots [t * _K1_TILE, (t + 1) *
    _K1_TILE), and block b takes tiles [b * tiles // blocks, (b + 1) * tiles
    // blocks)."""
    tiles = -(-n // _K1_TILE)
    return tiles, min(tiles, sms * _K1_BLOCKS_PER_SM)


def hist_and_literals(bins: torch.Tensor, radius: int):
    """Stream-order bins (1-D int32) -> (histogram (table_len(radius),) int32
    over the symbol index, on the host, the stream slots of the bin==0
    symbols in stream order, int32, on the bins' device).

    On the card the count pass leaves the histogram in device memory and
    queues its copy to the host; the wrapper waits for it once (its entry 0
    is the literal count, which sizes the slots) and queues the placement
    pass before it returns, so the card places the literals while the caller
    works on the histogram."""
    _check_bins(bins, radius)
    if bins.device.type == "cpu":
        return hist_and_literals_plain(bins, radius)
    n = bins.numel()
    tiles, blocks = _k1_grid(n, torch.cuda.get_device_properties(bins.device).multi_processor_count)
    tl = table_len(radius)
    # the histogram, then the count of zeros of each tile and of each block
    # (zeroed by the count pass)
    buf = torch.empty(tl + tiles + blocks, dtype=torch.int32, device=bins.device)
    hist = torch.empty(tl, dtype=torch.int32, pin_memory=True)
    stream = torch.cuda.current_stream(bins.device)
    win_lo = max(2, radius + 1 - K1_W_HALF)       # the window centres on bin radius
    lib = kernels()
    _ok(lib.szt_hist_count(bins.data_ptr(), n, 2 * radius, win_lo, blocks, buf.data_ptr(),
                           hist.data_ptr(), stream.cuda_stream), "szt_hist_count")
    stream.synchronize()                          # the one read-back
    slots = torch.empty(int(hist[0]), dtype=torch.int32, device=bins.device)
    if slots.numel():
        _ok(lib.szt_literal_slots(bins.data_ptr(), n, blocks, buf[tl:].data_ptr(),
                                  slots.data_ptr(), stream.cuda_stream), "szt_literal_slots")
    hist_and_literals.launches += 1
    return hist, slots


hist_and_literals.launches = 0


# ---- K2+K3: code lookup + bit packing ------------------------------------------

def _place(words: torch.Tensor, off: torch.Tensor, code: torch.Tensor,
           length: torch.Tensor) -> None:
    """Add right-aligned codes of 0..32 bits at bit offsets `off` into the
    int64 words (32 bits used in each); a code spans at most two words."""
    w = off >> 5
    end = (off & 31) + length               # end of the code within word w, 0..63
    fits = end <= 32
    head = torch.where(fits, code << (32 - end).clamp(min=0), code >> (end - 32).clamp(min=0))
    tail = torch.where(fits, 0, (code << (64 - end).clamp(max=63)) & 0xFFFFFFFF)
    words.scatter_add_(0, w, head)
    words.scatter_add_(0, w + 1, tail)


def pack_bits_plain(bins: torch.Tensor, table_codes: torch.Tensor,
                    table_lens: torch.Tensor, radius: int, total_bits: int) -> torch.Tensor:
    """Plain version of :func:`pack_bits`. A code of more than 32 bits goes
    in as two pieces, its top len-32 bits and its low 32. The pieces cover
    disjoint bit ranges, so adding them into int64 words equals ORing them."""
    idx = _sym_index(bins, radius).to(torch.int64)
    lens = table_lens.to(torch.int64)[idx]
    codes = table_codes[idx]
    ends = torch.cumsum(lens, 0)
    if int(ends[-1]) != total_bits:
        raise RuntimeError(f"packed {int(ends[-1])} bits, the histogram says {total_bits}")
    off = ends - lens
    hi_len = (lens - 32).clamp(min=0)
    lo_len = lens - hi_len
    hi = (codes >> 32) & ((1 << hi_len) - 1)
    lo = codes & ((1 << lo_len) - 1)
    nwords = (total_bits + 31) // 32
    words = torch.zeros(nwords + 2, dtype=torch.int64, device=bins.device)
    _place(words, off, hi, hi_len)
    _place(words, off + hi_len, lo, lo_len)
    words = words[:nwords]
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def pack_bits(bins: torch.Tensor, table_codes: torch.Tensor, table_lens: torch.Tensor,
              radius: int, total_bits: int) -> torch.Tensor:
    """Stream-order bins -> packed words (ceil(total_bits/32),) int32 holding
    uint32 bit patterns; stream bit 0 is the MSB of word 0. The tables are
    indexed by symbol index (table_len(radius) entries each): right-aligned
    codes of up to 64 bits as int64, and their lengths as int32.
    `total_bits` (from the histogram and the code lengths) sizes the output;
    the scan's own total must equal it."""
    _check_bins(bins, radius)
    for t, dt in ((table_codes, torch.int64), (table_lens, torch.int32)):
        if (t.dtype != dt or t.shape != (table_len(radius),) or not t.is_contiguous()
                or t.device != bins.device):
            raise ValueError("code tables must be contiguous (table_len(radius),) tensors "
                             "(codes int64, lengths int32) on the bins' device")
    if bins.device.type == "cpu":
        return pack_bits_plain(bins, table_codes, table_lens, radius, total_bits)
    n = bins.numel()
    blocks, per_block = _partition(n, _PACK_TILE)
    nwords = (total_bits + 31) // 32
    words = torch.zeros(nwords + 1, dtype=torch.int32, device=bins.device)
    offsets = torch.empty(blocks + 1, dtype=torch.int64, device=bins.device)
    # scratch: the kernel's own table of (code, length) entries, 16 bytes each
    table = torch.empty((table_len(radius), 2), dtype=torch.int64, device=bins.device)
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    _ok(kernels().szt_pack_bits(bins.data_ptr(), n, 2 * radius, table_codes.data_ptr(),
                                table_lens.data_ptr(), table.data_ptr(), per_block, blocks,
                                offsets.data_ptr(), nwords + 1, words.data_ptr(), stream),
        "szt_pack_bits")
    pack_bits.launches += 1
    got = int(offsets[blocks].item())
    if got != total_bits:
        raise RuntimeError(f"packed {got} bits, the histogram says {total_bits}")
    return words[:nwords]


pack_bits.launches = 0
