"""Encodes with the entropy stage or the prediction on the device
(counterpart of sz3_tpu/algos/device_encode.py): INTERP, LORENZO_REG and
NOPRED through the device Huffman encode, BIOMD and BIOMDXTC with their
decomposition on the device and their coders in the host engine.

A Huffman route's encode is a device half and a host half. The device
half predicts and quantizes to bins in stream order (INTERP: the passes of
ops/interp_fast, then the cached permutation of ops/stream_order) and ends
in :func:`pack`: K1's histogram (ops/entropy_device), read back once; the
Huffman tree on the host with the reference's tie-breaking
(runtime.huff_table), the exact bit count and the code tables, while the
card places the literal slots; K2+K3's bit packing; the stream and the
literals queued to page-locked memory (utils/copies). The host half,
:func:`seal_packed`, waits for them, then frames and zstd-compresses the
payload with the route's engine seal (runtime.*_seal_packed).

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

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import runtime
from ..config import Config
from ..ops import biomd_device as bd
from ..ops import entropy_device as ed
from ..ops import stream_order
from ..ops import xtc_device as xtc
from ..ops.interp_fast import (build_fast_plan, encode_grid_fast, encode_route, pass_launches,
                               pass_points)
from ..ops.quantize import by_slices, quantize
from ..utils import trace
from ..utils.copies import to_host
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


def symbol_freq(hist: torch.Tensor, radius: int, num: int):
    """K1's exact histogram (on the host) as the reference Huffman coder's
    input: (min symbol, max symbol, freq) with freq[s - min] the count of
    symbol s and a trailing zero slot (the reference convention)."""
    h = hist.numpy().astype(np.int64)
    if h[-1]:
        raise ValueError(f"{h[-1]} bins outside [0, {2 * radius}): not a quantizer's output")
    by_sym = np.concatenate([h[:1], h[2:2 * radius + 1]])   # count of symbol s at [s]
    total = int(by_sym.sum())
    if total != num:
        raise RuntimeError(f"histogram total {total} != num {num}")
    present = np.flatnonzero(by_sym)
    lo, hi = int(present[0]), int(present[-1])
    freq = np.zeros(hi - lo + 2, np.uint64)
    freq[:-1] = by_sym[lo:hi + 1]
    return lo, hi, freq


def _tree_and_tables(hist: torch.Tensor, radius: int, num: int, device):
    """Exact histogram, on the host -> reference Huffman tree -> code tables
    indexed by symbol index. Returns (tree bytes, total bits, codes, lens)
    with the tables on `device` (codes int64, lens int32)."""
    lo, hi, freq = symbol_freq(hist, radius, num)
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


def _big_endian(words: torch.Tensor, total_bits: int) -> torch.Tensor:
    """Packed words (MSB-first uint32 patterns) -> the big-endian byte
    stream the format wants, ceil(total_bits/8) uint8 on the words' device.
    The byte swap runs where the words are (on the card one short pass), so
    the host copies the stream once."""
    return words.view(torch.uint8).reshape(-1, 4).flip(1).reshape(-1)[:(total_bits + 7) // 8]


def _sealed(seal, conf: Config, *args, bit_count: int = 0, symbols: int = 0) -> bytes:
    """``seal(conf, *args)``, a host engine's seal, in the ``seal`` span."""
    with trace.span("seal", bit_count=bit_count, symbols=symbols) as sp:
        payload = seal(conf, *args)
        sp.set(payload_bytes=len(payload))
    return payload


class Packed(NamedTuple):
    """The device half of a Huffman route's encode (:func:`pack`): what the
    host half (:func:`seal_packed`) hands the engine's seal."""
    tree: bytes
    total_bits: int
    num: int
    bits: torch.Tensor            # the big-endian stream, on the host (page-locked from the card)
    unpred: torch.Tensor          # the literals in stream order, on the host
    done: Optional[torch.cuda.Event]   # recorded after both copies; None on the CPU
    seal: str                     # the engine's seal, a name on runtime
    side: tuple = ()              # host arrays the seal takes before the literals


def pack(seal: str, bins_stream: torch.Tensor, radius: int, num: int, literals,
         side: tuple = ()) -> Packed:
    """K1, the host's tree, then K2+K3 and the literal gather
    (``literals(slots)``) over the stream-order bins, each in its span, and
    the big-endian stream and the literals queued to the host behind an
    event. It waits only for the current stream (K1's histogram, K2+K3's
    bit count), so work queued on other streams runs on."""
    with trace.span("entropy.hist", symbols=bins_stream.numel()):
        hist, slots = ed.hist_and_literals(bins_stream, radius)   # hist on the host
    with trace.span("entropy.tree") as sp:
        tree, total_bits, tc, tl = _tree_and_tables(hist, radius, num, bins_stream.device)
        sp.set(total_bits=total_bits)
    with trace.span("entropy.pack", total_bits=total_bits):
        words = ed.pack_bits(bins_stream, tc, tl, radius, total_bits)
        unpred = literals(slots)
    cuda = bins_stream.is_cuda
    with trace.span("copy.d2h", pinned=cuda) as sp:
        bits, unpred = to_host(_big_endian(words, total_bits)), to_host(unpred)
        sp.set(bytes=bits.nbytes + unpred.nbytes)
    done = None
    if cuda:
        done = torch.cuda.Event()
        done.record()
    return Packed(tree, total_bits, num, bits, unpred, done, seal, side)


def seal_packed(conf: Config, packed: Packed, cap: int) -> bytes:
    """The host half: waits for the copies of ``packed``, then frames and
    zstd-compresses the payload with the engine's seal it names."""
    with trace.span("copy.wait"):
        if packed.done is not None:
            packed.done.synchronize()
        bits = packed.bits.numpy().tobytes()
    return _sealed(getattr(runtime, packed.seal), conf, packed.tree, bits, packed.total_bits,
                   packed.num, *packed.side, packed.unpred.numpy(), cap,
                   bit_count=packed.total_bits, symbols=packed.num)


def pack_device(conf: Config, x: torch.Tensor) -> Packed:
    """The device half of ``encode_payload_device``, on the current stream:
    passes, stream gather, then :func:`pack`."""
    plan = plan_for(conf)
    num = int(np.prod(conf.dims))
    with trace.span("interp.passes", points=num, route=encode_route(x),
                    launches=pass_launches(plan, x), rank=len(plan.dims),
                    predicted=pass_points(plan)):
        grid = torch.zeros(plan.dims, dtype=torch.int32, device=x.device)
        encode_grid_fast(x, plan, grid=grid)
    with trace.span("interp.stream_order"):
        perm = perm_for(conf, x.device)
        bins_stream = stream_order.to_stream(grid, perm)
    return pack("interp_seal_packed", bins_stream, plan.radius, num,
                lambda slots: stream_order.literal_values(x, perm, slots))


def encode_payload_device(conf: Config, x: torch.Tensor, cap: int) -> bytes:
    """INTERP payload of the float field `x` (on the device that runs the
    encode, shaped conf.dims) with the entropy stage on that device: the
    device half, then the host half. conf.interpAnchorStride must be
    resolved."""
    return seal_packed(conf, pack_device(conf, x), cap)


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
              permutation (ops/blockwise_layout), then :func:`pack`
      host:   payload framing + zstd (runtime.blockwise_seal_packed)"""
    from ..ops import blockwise_layout as bl
    from ..ops.blockwise_wavefront_encode import encode_blocks_wavefront

    radius = conf.quantbinCnt // 2
    bins_grid, g, sel, regb, qlu, qiu = encode_blocks_wavefront(
        x, conf.absErrorBound, radius, conf.lorenzo, conf.lorenzo2, conf.regression, stats)
    with trace.span("lorenzo.stream_order"):
        perm = bl.perm_for(conf.dims, x.device)
        bins_stream = stream_order.to_stream(bins_grid, perm)
    return seal_packed(conf, pack("blockwise_seal_packed", bins_stream, radius, x.numel(),
                                  lambda slots: stream_order.literal_values(g, perm, slots),
                                  (sel, regb, qlu, qiu)), cap)


def nopred_bins(flat: torch.Tensor, eb: float, radius: int) -> torch.Tensor:
    """The NOPRED stream of the flat field: its bins against a zero
    prediction, in element order (int32, on flat's device), quantized slice
    by slice."""
    zero = torch.zeros((), dtype=flat.dtype, device=flat.device)
    return by_slices(lambda d: quantize(d, zero, eb, radius)[0],
                     torch.empty(flat.shape, dtype=torch.int32, device=flat.device), flat)


def encode_payload_device_nopred(conf: Config, x: torch.Tensor, cap: int) -> bytes:
    """NOPRED payload of the float field `x` (float32 or float64, on the
    device that runs the encode) with the quantizer and the entropy stage on
    that device (counterpart of ``encode_payload_device_nopred`` in
    sz3_tpu/algos/device_encode.py; reference SZAlgoNopred.hpp:13-36).

      device: quantize against a zero prediction (nopred_bins); the stream
              is the flat bins in element order, so no permutation; then
              :func:`pack`
      host:   payload framing + zstd (runtime.nopred_seal_packed)"""
    radius = conf.quantbinCnt // 2
    flat = x.reshape(-1)
    bins = nopred_bins(flat, conf.absErrorBound, radius)
    return seal_packed(conf, pack("nopred_seal_packed", bins, radius, flat.numel(),
                                  lambda slots: flat.index_select(0, slots)), cap)


def encode_payload_device_biomd(conf: Config, x: torch.Tensor, cap: int, site: int,
                                first_fill: int, fill: float) -> bytes:
    """ALGO_BIOMD payload of the float32 trajectory `x` (on the device that
    runs the encode, shaped conf.dims), with frames 1..last on that device
    (counterpart of ``encode_payload_device_biomd`` in
    sz3_tpu/algos/device_encode.py). `site`, `first_fill` and `fill` come
    from the dispatcher's route check (torch_backend._biomd_on_device).

      host:   frame 0's atom chain (runtime.biomd_frame0), uploaded once
      device: frames 1..last (ops/biomd_device.frames_encode); the literals,
              the originals at the zero bins in frame-major order
      host:   the bins and literals read back, HuffmanV2 + zstd
              (runtime.biomd_seal)"""
    frames, atoms, cols = conf.dims
    last = min(frames, first_fill)
    eb, radius = conf.absErrorBound, conf.quantbinCnt // 2
    bins0, recon0, unpred0 = runtime.biomd_frame0(eb, radius, site, x[0].cpu().numpy())
    live = x[1:last]
    bins_rest = bd.frames_encode(live, torch.from_numpy(recon0).to(x.device), eb, radius, site)
    lits = torch.masked_select(live, bins_rest == 0)
    bins = np.zeros(conf.num, np.int32)
    acols = atoms * cols
    bins[:acols] = bins0.reshape(-1)
    bins[acols:last * acols] = bins_rest.reshape(-1).cpu().numpy()
    unpred = np.concatenate([unpred0, lits.cpu().numpy()])
    return _sealed(runtime.biomd_seal, conf, bins, unpred, site, first_fill, fill, cap,
                   symbols=bins.size)


def encode_payload_device_biomdxtc(conf: Config, x: torch.Tensor, cap: int,
                                   first_fill: int, fill: float) -> bytes:
    """ALGO_BIOMDXTC payload of the float32 field `x` (1D-3D, on the device
    that runs the encode, shaped conf.dims): one elementwise quantize at the
    XTC radius on that device (ops/xtc_device.py), slice by slice, the XTC
    triplet coder in the host engine (runtime.biomdxtc_seal). For 3D data the frames from
    `first_fill` on (trailing frames of one fill value, found on the host)
    are left out, as the engine does; 1D and 2D data pass 0 and 0.0."""
    if len(conf.dims) == 3:
        live = x[:min(conf.dims[0], first_fill)].reshape(-1)
    else:
        live = x.reshape(-1)
    stored = by_slices(lambda d: xtc.xtc_quantize(d, conf.absErrorBound),
                       torch.empty(live.shape, dtype=torch.int32, device=x.device), live)
    unpred = torch.masked_select(live, stored == -xtc.XTC_RADIUS)
    stored, unpred = stored.cpu().numpy(), unpred.cpu().numpy()
    return _sealed(runtime.biomdxtc_seal, conf, stored, unpred, first_fill, np.float32(fill), cap,
                   symbols=stored.size)
