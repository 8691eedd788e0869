"""Decodes with the entropy stage or the prediction on the device
(counterpart of sz3_tpu/algos/device_decode.py): INTERP, LORENZO_REG and
NOPRED through the device Huffman decode, BIOMD and BIOMDXTC with their
coders opened in the host engine and the rest on the device.

INTERP (``decode_payload_device``):

  host:   zstd + payload framing, opened without the Huffman bit-walk
          (runtime.open_packed -> raw bitstream, exported code table, literals)
  device: the head every Huffman route shares (:func:`huffman_head`): the
          speculative window decode of the stream to the dense stream-order
          bins (K4 + K5, ops/entropy_decode), the literals uploaded
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
from ..ops import biomd_device as bd
from ..ops import stream_order
from ..ops import xtc_device as xtc
from ..ops.entropy_decode import decode_stream
from ..ops.interp_fast import decode_grid_fast, grid_to_pass_slices, initial_literal
from ..ops.quantize import by_slices, recover
from ..utils import trace
from ..utils.copies import to_device
from .device_encode import perm_for, plan_for


def dense_bins(bits: bytes, count: int, offset: int, codes: np.ndarray, lens: np.ndarray,
               const_sym: int, device: torch.device,
               stats: Optional[dict] = None) -> torch.Tensor:
    """Huffman stream -> the dense stream-order bins, (count,) int32 on `device`."""
    with trace.span("entropy.decode", symbols=count, stream_bytes=len(bits)) as sp:
        if const_sym >= 0:
            return torch.full((count,), const_sym, dtype=torch.int32, device=device)
        stats = {} if stats is None else stats
        dense = decode_stream(bits, count, codes, lens, offset, device, stats)
        sp.set(passes=stats["passes"])
    return dense


def huffman_head(stream: tuple, unpred: np.ndarray, num: int, dtype, device: torch.device,
                 stats: Optional[dict] = None, points: str = "grid points"):
    """The head of the three Huffman decodes: the opened stream (bits,
    count, offset, codes, lens, const_sym) and literals -> (dense
    stream-order bins, the zero bins' slots, the literals as `dtype`), all
    on `device`. Raises ValueError where the archived symbol count is not
    `num`, or the literal count not the count of zero bins."""
    bits, count, offset, codes, lens, const_sym = stream
    if count != num:
        raise ValueError(f"archived symbol count {count} != {num} {points}")
    dense = dense_bins(bits, count, offset, codes, lens, const_sym, device, stats)
    slots = torch.nonzero(dense == 0).reshape(-1)
    if slots.numel() != unpred.size:
        raise ValueError(f"literal stream length {unpred.size} != zero bins {slots.numel()}")
    return dense, slots, to_device(unpred.astype(dtype, copy=False), device)


def decode_payload_device(conf: Config, payload: bytes, dtype, device: torch.device,
                          stats: Optional[dict] = None) -> torch.Tensor:
    """INTERP payload -> the float field on `device`, shaped conf.dims, with
    the entropy decode on that device. conf.interpAnchorStride must be
    resolved; conf picks up the payload header's parameters. Raises
    ValueError on a payload whose counts disagree."""
    # The payload header is authoritative over the Config tail (the interp
    # compressor re-tunes and may store another interpolator, with the same
    # stream count): open first, plan after.
    with trace.span("open", payload_bytes=len(payload)):
        *stream, unpred = runtime.open_packed(conf, payload, dtype, algo=2)
    num = int(np.prod(conf.dims))
    with trace.span("interp.decode", points=num):
        dense, slots, values = huffman_head(stream, unpred, num, dtype, device, stats)
        perm = perm_for(conf, device)
        plan = plan_for(conf)
        literal = stream_order.literal_grid(values, perm, slots, num).reshape(plan.dims)
        bins = stream_order.from_stream(dense, perm, num).reshape(plan.dims)
        return decode_grid_fast(grid_to_pass_slices(bins, plan),
                                grid_to_pass_slices(literal, plan), plan,
                                initial_literal(literal, plan), bins[(0,) * bins.dim()],
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
    with trace.span("open", payload_bytes=len(payload)):
        opened = runtime.blockwise_open_packed(conf, payload)
    sel, regb, qlu, qiu, unpred = opened[6:]
    geo = bl.geometry(conf.dims)
    eb, radius = conf.absErrorBound, conf.quantbinCnt // 2
    with trace.span("lorenzo.decode", blocks=geo.nblk):
        dense, slots, values = huffman_head(opened[:6], unpred, int(np.prod(geo.dims)),
                                            np.float32, device)
        perm = bl.perm_for(geo.dims, device)
        lits = stream_order.literal_grid(values, perm, slots, geo.ncells).reshape(geo.grid)
        bins = stream_order.from_stream(dense, perm, geo.ncells).reshape(geo.grid)
        del dense, slots, values
        block_types, coefs = wf.selection_info(geo, roster, sel, regb, qlu, qiu, eb)
        block_types = torch.from_numpy(block_types).to(device)
        types = wf.cell_types(geo, block_types)
        rec = torch.zeros(geo.padded, dtype=torch.float32, device=device)
        wf.reg_preplace_decode(geo, rec, (block_types == bl.T_KEEP).reshape(geo.nb), bins, lits,
                               torch.from_numpy(coefs).to(device).reshape(*geo.nb, 4), eb,
                               radius)
        wf.sweep_decode(rec, types, bins, lits, eb, radius)
        d0, d1, d2 = geo.dims
        return rec[bl.PAD:bl.PAD + d0, bl.PAD:bl.PAD + d1, bl.PAD:bl.PAD + d2].contiguous()


def decode_payload_device_nopred(conf: Config, payload: bytes, dtype,
                                 device: torch.device) -> torch.Tensor:
    """NOPRED payload -> the float field (float32 or float64) on `device`,
    flat, with the entropy decode on that device (counterpart of
    ``decode_payload_device_nopred`` in sz3_tpu/algos/device_decode.py).
    The stream is element order: every point is recovered against a zero
    prediction, slice by slice, then the k-th zero bin takes the k-th
    literal. Raises ValueError on a payload whose counts disagree."""
    with trace.span("open", payload_bytes=len(payload)):
        *stream, unpred = runtime.open_packed(conf, payload, dtype, algo=3)
    num = int(np.prod(conf.dims))
    dense, slots, values = huffman_head(stream, unpred, num, dtype, device, points="points")
    eb, radius = conf.absErrorBound, conf.quantbinCnt // 2
    zero = torch.zeros((), dtype=values.dtype, device=device)
    out = by_slices(lambda b: recover(zero, b, zero, eb, radius),
                    torch.empty(num, dtype=values.dtype, device=device), dense)
    out[slots] = values
    return out


def decode_payload_device_biomd(conf: Config, payload: bytes,
                                device: torch.device) -> torch.Tensor:
    """ALGO_BIOMD payload -> the float32 trajectory on `device`, shaped
    conf.dims (counterpart of ``decode_payload_device_biomd`` in
    sz3_tpu/algos/device_decode.py). The caller has checked, from the
    payload's header, that it is 3D with site != 0 and at least 2 live
    frames.

      host:   HuffmanV2 + zstd open (runtime.biomd_open) and frame 0's
              recover chain (runtime.biomd_frame0_open)
      device: the literals to the zero bins of frames 1..last, in frame-major
              order, then the frame recurrence (ops/biomd_device.
              frames_recover); trailing fill frames written with the fill

    Raises ValueError where the literal stream is shorter than the zero
    bins."""
    with trace.span("open", payload_bytes=len(payload)):
        bins, unpred, site, first_fill, fill = runtime.biomd_open(conf, payload)
    frames, atoms, cols = conf.dims
    last = min(frames, first_fill)
    if bins.size != conf.num:
        raise ValueError(f"biomd bins count {bins.size} != {conf.num} points")
    eb, radius = conf.absErrorBound, conf.quantbinCnt // 2
    # the frame recurrence's own bounds (ops/biomd_device._check), before any
    # device work
    if not 2 < site <= bd.MAX_SITE or not 0 < radius < 2 ** 30 or last < 2:
        raise ValueError(f"biomd site {site}, radius {radius} or {last} live frames out of "
                         f"range")
    acols = atoms * cols
    bins0 = bins[:acols].reshape(atoms, cols)
    n0 = int((bins0 == 0).sum())
    rest = torch.from_numpy(bins[acols:last * acols]).to(device).reshape(last - 1, atoms, cols)
    # the zero bins' flat positions, ascending: frame-major order (an index
    # list, where masked_scatter_ would scan the whole mask in int64)
    at = torch.nonzero(rest.reshape(-1) == 0).reshape(-1)
    n_rest = at.numel()
    if unpred.size < n0 + n_rest:
        raise ValueError(f"biomd literal stream {unpred.size} < zero bins {n0 + n_rest}")
    recon0 = torch.from_numpy(
        runtime.biomd_frame0_open(eb, radius, site, bins0, unpred[:n0])).to(device)
    lits = torch.zeros(rest.shape, dtype=torch.float32, device=device)
    lits.view(-1)[at] = torch.from_numpy(unpred[n0:n0 + n_rest]).to(device)
    out = torch.empty((frames, atoms, cols), dtype=torch.float32, device=device)
    out[0] = recon0
    out[1:last] = bd.frames_recover(rest, lits, recon0, eb, radius, site)
    if first_fill < frames:
        out[first_fill:] = fill
    return out


def decode_payload_device_biomdxtc(conf: Config, payload: bytes,
                                   device: torch.device) -> torch.Tensor:
    """ALGO_BIOMDXTC payload -> the float32 field (1D-3D) on `device`,
    shaped conf.dims (counterpart of ``decode_payload_device_biomdxtc`` in
    sz3_tpu/algos/device_decode.py): the host engine's XTC triplet decode to
    the stored bins (runtime.biomdxtc_open), then on the device one
    elementwise recover (ops/xtc_device.py), slice by slice, and the
    literals placed. Raises ValueError on a payload whose counts disagree."""
    with trace.span("open", payload_bytes=len(payload)):
        stored, unpred, first_fill, fill = runtime.biomdxtc_open(conf, payload)
    dims = tuple(conf.dims)
    stored = torch.from_numpy(stored).to(device)
    lit_at = torch.nonzero(stored == -xtc.XTC_RADIUS).reshape(-1)
    nlit = lit_at.numel()
    if nlit != unpred.size:
        raise ValueError(f"biomdxtc literal count {nlit} != stream {unpred.size}")
    last = min(dims[0], first_fill) if len(dims) == 3 else 1
    live = conf.num if len(dims) != 3 else last * dims[1] * dims[2]
    if stored.numel() != live:
        raise ValueError(f"biomdxtc bins {stored.numel()} != {live} live points")
    out = torch.empty(dims, dtype=torch.float32, device=device)
    rec = out.reshape(-1)[:live]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    by_slices(lambda b: xtc.xtc_recover(b, zero, conf.absErrorBound), rec, stored)
    rec[lit_at] = torch.from_numpy(unpred).to(device)
    if len(dims) == 3 and last < dims[0]:
        out[last:] = fill
    return out
