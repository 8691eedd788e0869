"""INTERP decode with the entropy stage on the device (counterpart of
``decode_payload_device`` in sz3_tpu/algos/device_decode.py).

  host:   zstd + payload framing, opened without the Huffman bit-walk
          (runtime.open_packed -> raw bitstream, exported code table, literals)
  device: speculative window decode of the Huffman stream to the dense
          stream-order bins (K4 + K5, ops/entropy_decode)
  device: the literals to the grid points of the stream's zero bins, in
          stream order (the k-th zero bin takes the k-th literal,
          LinearQuantizer.hpp:74-86), and the bins to grid order, both
          through the cached permutation (ops/stream_order)
  device: multi-level grid recovery (ops/interp_fast.decode_grid_fast)

The JAX package hands four kinds of archive to its host decode: streams of
fewer than 64 windows, fields with no anchor grid, Huffman codes deeper than
32 bits, and trees outside its kernel's size classes. All of them decode on
the device here; a constant stream (a tree of one leaf, an empty bitstream)
is a fill.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import runtime
from ..config import Config
from ..ops import stream_order
from ..ops.entropy_decode import decode_stream, upload_bytes
from ..ops.interp_fast import decode_grid_fast, grid_to_pass_slices, initial_literal
from .device_encode import perm_for, plan_for


def dense_bins(bits: bytes, count: int, offset: int, codes: np.ndarray, lens: np.ndarray,
               const_sym: int, device: torch.device,
               stats: Optional[dict] = None) -> torch.Tensor:
    """Huffman stream -> the dense stream-order bins, (count,) int32 on `device`."""
    if const_sym >= 0:
        return torch.full((count,), const_sym, dtype=torch.int32, device=device)
    return decode_stream(bits, count, codes, lens, offset, device, stats)


def decode_payload_device(conf: Config, payload: bytes, dtype, device: torch.device,
                          stats: Optional[dict] = None) -> torch.Tensor:
    """INTERP payload -> the float field on `device`, shaped conf.dims, with
    the entropy decode on that device. conf.interpAnchorStride must be
    resolved; conf picks up the payload header's parameters. Raises
    ValueError on a payload whose counts disagree."""
    dtype = np.dtype(dtype)
    # The payload header is authoritative over the Config tail (the interp
    # compressor re-tunes and may store another interpolator, with the same
    # stream count): open first, plan after.
    bits, count, offset, codes, lens, const_sym, unpred = runtime.open_packed(
        conf, payload, dtype, algo=2)
    num = int(np.prod(conf.dims))
    if count != num:
        raise ValueError(f"archived symbol count {count} != {num} grid points")
    dense = dense_bins(bits, count, offset, codes, lens, const_sym, device, stats)
    slots = torch.nonzero(dense == 0).reshape(-1)
    if slots.numel() != unpred.size:
        raise ValueError(f"literal stream length {unpred.size} != zero bins {slots.numel()}")
    values = upload_bytes(unpred.data, device)[:unpred.nbytes].view(
        torch.float32 if dtype == np.float32 else torch.float64)
    perm = perm_for(conf, device)
    plan = plan_for(conf)
    literal = stream_order.literal_grid(values, perm, slots, num).reshape(plan.dims)
    bins = stream_order.from_stream(dense, perm, num).reshape(plan.dims)
    return decode_grid_fast(grid_to_pass_slices(bins, plan), grid_to_pass_slices(literal, plan),
                            plan, initial_literal(literal, plan), bins[(0,) * bins.dim()],
                            literal.dtype)


def decode_payload_device_blockwise(conf: Config, payload: bytes,
                                    device: torch.device) -> torch.Tensor:
    """LORENZO_REG payload of a 3D float32 field -> the field on `device`,
    shaped conf.dims (counterpart of ``decode_payload_device_blockwise`` in
    sz3_tpu/algos/device_decode.py).

      host:   zstd + framing, the bins' Huffman stream opened without its
              bit-walk, and the side streams (runtime.blockwise_open_packed)
      device: the Huffman decode (K4 + the write phase) to the block-major
              stream, the literals to the zero bins in stream order, both to
              the rounded grid through the block permutation
              (ops/blockwise_layout)
      host:   per-block predictors and the coefficient chain replay
              (ops/blockwise_wavefront.selection_info)
      device: regression cells placed, then the element sweep (lorenzo_sweep)

    Raises ValueError on a payload whose counts disagree."""
    from ..ops import blockwise_layout as bl
    from ..ops import blockwise_wavefront as wf

    roster = wf.roster_of(conf.lorenzo, conf.lorenzo2, conf.regression)
    (bits, count, offset, codes, lens, const_sym, sel, regb, qlu, qiu,
     unpred) = runtime.blockwise_open_packed(conf, payload)
    geo = bl.geometry(conf.dims)
    num = int(np.prod(geo.dims))
    if count != num:
        raise ValueError(f"archived symbol count {count} != {num} grid points")
    eb, radius = conf.absErrorBound, conf.quantbinCnt // 2
    dense = dense_bins(bits, count, offset, codes, lens, const_sym, device)
    slots = torch.nonzero(dense == 0).reshape(-1)
    if slots.numel() != unpred.size:
        raise ValueError(f"literal stream length {unpred.size} != zero bins {slots.numel()}")
    values = upload_bytes(unpred.data, device)[:unpred.nbytes].view(torch.float32)
    perm = bl.perm_for(geo.dims, device)
    lits = stream_order.literal_grid(values, perm, slots, geo.ncells).reshape(geo.grid)
    bins = stream_order.from_stream(dense, perm, geo.ncells).reshape(geo.grid)
    del dense, slots, values
    block_types, coefs = wf.selection_info(geo, roster, sel, regb, qlu, qiu, eb)
    block_types = torch.from_numpy(block_types).to(device)
    types = wf.cell_types(geo, block_types)
    rec = torch.zeros(geo.padded, dtype=torch.float32, device=device)
    wf.reg_preplace_decode(geo, rec, (block_types == bl.T_KEEP).reshape(geo.nb), bins, lits,
                           torch.from_numpy(coefs).to(device).reshape(*geo.nb, 4), eb, radius)
    wf.sweep_decode(rec, types, bins, lits, eb, radius)
    d0, d1, d2 = geo.dims
    return rec[bl.PAD:bl.PAD + d0, bl.PAD:bl.PAD + d1, bl.PAD:bl.PAD + d2].contiguous()
