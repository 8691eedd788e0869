"""INTERP encode with the entropy stage on the device (counterpart of
``encode_payload_device`` in sz3_tpu/algos/device_encode.py).

  device: predict+quantize passes (ops/interp_fast) -> bins grid -> stream
          order through the cached permutation (ops/stream_order) ->
          histogram (K1's count pass, ops/entropy_device), read back once
  host:   Huffman tree with the reference's tie-breaking (runtime.huff_table),
          exact total bit count from histogram x code lengths, code tables,
          while the card places the literal slots (K1's placement pass)
  device: code lookup + bit packing (K2+K3, ops/entropy_device)
  host:   payload framing + zstd (runtime.interp_seal_packed)

The JAX package sends four kinds of input to its host emit/seal path: no
anchor grid, a literal count above its capacity, bins outside its histogram
window, and Huffman codes deeper than 32 bits. None of them leaves the
device here: the literal output is sized from the device's
count, the histogram and code tables cover the quantizer's whole range, the
packer takes codes of up to 64 bits (with the tree built by
algos/huffman.py when the host engine's table export stops at 32), and the
first point's bin goes into the bins grid when there are no anchors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import runtime
from ..config import Config
from ..ops import entropy_device as ed
from ..ops import stream_order
from ..ops.interp_fast import bins_to_grid, build_fast_plan, encode_grid_fast
from .huffman import build_table


def plan_for(conf: Config):
    return build_fast_plan(tuple(conf.dims), interp_algo=int(conf.interpAlgo),
                           direction=conf.interpDirection,
                           anchor_stride=conf.interpAnchorStride, alpha=conf.interpAlpha,
                           beta=conf.interpBeta, eb=conf.absErrorBound,
                           quantbin_cnt=conf.quantbinCnt)


def perm_for(conf: Config, device) -> torch.Tensor:
    return stream_order.device_perm(tuple(conf.dims), int(conf.interpAlgo),
                                    conf.interpDirection, conf.interpAnchorStride,
                                    stream_order.cache_device(device))


def _huffman_table(offset: int, freq: np.ndarray):
    """The reference Huffman tree of a histogram: (codes uint64, lens, tree
    bytes). The host engine builds it unless a code exceeds 32 bits."""
    try:
        codes, lens, tree = runtime.huff_table(offset, freq)
    except runtime.DeepTreeError:
        return build_table(offset, freq)
    return codes.astype(np.uint64), lens, tree


def _tree_and_tables(hist: torch.Tensor, radius: int, num: int, device):
    """Exact histogram, on the host -> reference Huffman tree -> code tables
    indexed by symbol index. Returns (tree bytes, total bits, codes, lens)
    with the tables on `device` (codes int64, lens int32)."""
    h = hist.numpy().astype(np.int64)
    if h[-1]:
        raise ValueError(f"{h[-1]} bins outside [0, {2 * radius}): not a quantizer's output")
    by_sym = np.concatenate([h[:1], h[2:2 * radius + 1]])   # count of symbol s at [s]
    total = int(by_sym.sum())
    if total != num:
        raise RuntimeError(f"histogram total {total} != num {num}")
    present = np.flatnonzero(by_sym)
    lo, hi = int(present[0]), int(present[-1])
    # the reference convention: offset = min symbol, a trailing zero slot
    freq = np.zeros(hi - lo + 2, np.uint64)
    freq[:-1] = by_sym[lo:hi + 1]
    codes, lens, tree = _huffman_table(lo, freq)
    total_bits = int((freq.astype(np.int64) * lens.astype(np.int64)).sum())

    syms = np.arange(lo, hi + 1)
    idx = np.where(syms == 0, 0, syms + 1)
    tc = np.zeros(ed.table_len(radius), np.uint64)
    tl = np.zeros(ed.table_len(radius), np.int32)
    tc[idx] = codes[:hi - lo + 1]
    tl[idx] = lens[:hi - lo + 1]
    return (tree, total_bits, torch.from_numpy(tc.view(np.int64)).to(device),
            torch.from_numpy(tl).to(device))


def _stream_bytes(words: torch.Tensor, total_bits: int) -> bytes:
    """Packed words (MSB-first uint32 patterns) -> the big-endian byte
    stream the format wants, trimmed to ceil(total_bits/8) bytes."""
    words_np = words.cpu().numpy()
    return words_np.view(np.uint32).byteswap().tobytes()[: (total_bits + 7) // 8]


def encode_payload_device(conf: Config, x: torch.Tensor, cap: int) -> bytes:
    """INTERP payload of the float field `x` (on the device that runs the
    encode, shaped conf.dims) with the entropy stage on that device.
    conf.interpAnchorStride must be resolved."""
    plan = plan_for(conf)
    num = int(np.prod(conf.dims))
    bins_list, b0, _ = encode_grid_fast(x, plan)
    grid = bins_to_grid(bins_list, plan, b0, x.device)
    perm = perm_for(conf, x.device)
    bins_stream = stream_order.to_stream(grid, perm)
    hist, slots = ed.hist_and_literals(bins_stream, plan.radius)   # hist on the host
    tree, total_bits, tc, tl = _tree_and_tables(hist, plan.radius, num, x.device)
    words = ed.pack_bits(bins_stream, tc, tl, plan.radius, total_bits)
    bits_bytes = _stream_bytes(words, total_bits)
    unpred = stream_order.literal_values(x, perm, slots).cpu().numpy()
    return runtime.interp_seal_packed(conf, tree, bits_bytes, total_bits, num, unpred, cap)


def encode_payload_device_blockwise(conf: Config, x: torch.Tensor, cap: int,
                                    stats: Optional[dict] = None) -> bytes:
    """LORENZO_REG payload of the 3D float32 field `x` (on the device that
    runs the encode, shaped conf.dims), with the sweep and the entropy stage
    on that device (counterpart of ``encode_payload_device_blockwise`` in
    sz3_tpu/algos/device_encode.py). Rosters: {L1}, {REG}, {L1, REG}.

      device: fits, selection, sweep and certification
              (ops/blockwise_wavefront_encode), the host engine replaying the
              coefficient chain once a pass
      device: the bins grid to the block-major stream through the cached
              permutation (ops/blockwise_layout), K1, then K2+K3 after the
              host's tree, as in encode_payload_device
      host:   payload framing + zstd (runtime.blockwise_seal_packed)"""
    from ..ops import blockwise_layout as bl
    from ..ops.blockwise_wavefront_encode import encode_blocks_wavefront

    radius = conf.quantbinCnt // 2
    bins_grid, g, sel, regb, qlu, qiu = encode_blocks_wavefront(
        x, conf.absErrorBound, radius, conf.lorenzo, conf.lorenzo2, conf.regression, stats)
    num = x.numel()
    perm = bl.perm_for(conf.dims, x.device)
    bins_stream = stream_order.to_stream(bins_grid, perm)
    hist, slots = ed.hist_and_literals(bins_stream, radius)
    tree, total_bits, tc, tl = _tree_and_tables(hist, radius, num, x.device)
    words = ed.pack_bits(bins_stream, tc, tl, radius, total_bits)
    bits_bytes = _stream_bytes(words, total_bits)
    unpred = stream_order.literal_values(g, perm, slots).cpu().numpy()
    return runtime.blockwise_seal_packed(conf, tree, bits_bytes, total_bits, num, sel, regb,
                                         qlu, qiu, unpred, cap)
