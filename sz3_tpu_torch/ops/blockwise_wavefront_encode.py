"""ALGO_LORENZO_REG encode on the device, 3D float32 (counterpart of
sz3_tpu/ops/blockwise_wavefront_encode.py).

The format's compress sweep (BlockwiseDecomposition.hpp:28-47,
ComposedPredictor.hpp:25-40, RegressionPredictor.hpp:148-155) entangles
three phases:
  1. least-squares fits: each block's from its own original cells, so all
     blocks at once (``fits``);
  2. predictor selection and the regression coefficient chain: a block's
     selection samples reconstructed cells of row-major earlier blocks (the
     pad), and the chain quantizes each committing block's coefficients
     against the previous committing block's reconstruction;
  3. the element sweep, the anti-diagonal recurrence of the decode, in
     quantize form (``sweep_encode``).

The selection is speculated first with the original values standing in for
the reconstruction (``select`` with the original grid as its taps; on the
card one launch of csrc/lorenzo_select.cu, on the CPU ``select_plain``), the
chain runs on the host engine over the speculated commit pattern, the
regression cells are quantized against their plane predictions, the sweep
quantizes the Lorenzo cells, and the selection is then recomputed from the
true reconstruction. Where the two agree for every block, the archive is the
host engine's, byte for byte.

Certification, and why the loop ends (there is no pass cap and no hand-off
to the host engine). A block's selection depends only on its own original
cells, its own fit, and the reconstruction of row-major earlier blocks,
which depends only on their selections and the chain over them. Take a pass
that swept with selection S, and let f be the first block where S differs
from the host engine's selection H. Every block before f then has the host's
reconstruction, so the selection T recomputed from this pass's
reconstruction equals H on every block up to and including f, and S and T
first differ exactly at f. If T equals S, no such f exists: S is H. If not,
the next pass sweeps with T, whose first difference from H lies beyond f.
The first difference moves strictly forward on every pass, so at most
nblocks + 1 passes are made. The loop counts them (``stats["passes"]``) and
raises only if the first difference fails to move, which the argument rules
out.

Scope: float32, 3D, rosters without second-order Lorenzo; the dispatcher
sends everything else to the host engine before any device work.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import runtime
from .blockwise_layout import (BS, PAD, T_KEEP, T_L1, Geometry, _noise, blocked, extents,
                               geometry, reg_valid, valid_cells)
from .blockwise_wavefront import (cell_index, cell_types, check_sweep, lorenzo_sweep,
                                  padded_grid, reg_cells, sweep_planes)
from .quantize import quantize
from ..build import kernels
from ..utils import trace

E = BS ** 3
DBL_MAX = float(np.finfo(np.float64).max)


def fits(blocks_t: torch.Tensor, inside_t: torch.Tensor, ex: torch.Tensor) -> torch.Tensor:
    """Least-squares plane fits of every block at once (_fits in the JAX
    package; RegressionPredictor.hpp:28-55). blocks_t: (216, nblk) float32,
    the blocks' original cells in row-major in-block order; inside_t: (216,
    nblk) bool, the cells inside the field; ex: (3, nblk) int32 extents.
    Returns the raw coefficients (4, nblk) float32. The index*value
    products are float32, accumulated in
    float64 in row-major in-block order one cell at a time (a library sum
    would reorder the additions), and each coefficient narrows where the
    reference narrows it."""
    f64 = torch.float64
    dev = blocks_t.device
    t = torch.arange(E, device=dev)
    fl = torch.stack([t // (BS * BS), (t // BS) % BS, t % BS]).to(torch.float32)   # (3, 216)
    zero = torch.zeros((), dtype=f64, device=dev)
    sums = torch.zeros((4, blocks_t.shape[1]), dtype=f64, device=dev)
    for i in range(E):
        c = blocks_t[i]
        terms = torch.stack([fl[0, i] * c, fl[1, i] * c, fl[2, i] * c, c]).to(f64)
        sums += torch.where(inside_t[i], terms, zero)
    bd = ex.to(f64)
    nelem = bd[0] * bd[1] * bd[2]
    coefs = [((2 * sums[i] / (bd[i] - 1) - sums[3]) * 6 / nelem / (bd[i] + 1)).to(torch.float32)
             for i in range(3)]
    cn = (sums[3] / nelem).to(torch.float32)
    for i in range(3):
        cn = (cn.to(f64) - (bd[i] - 1) * coefs[i].to(f64) / 2).to(torch.float32)
    return torch.stack(coefs + [cn])


def select_route(t: torch.Tensor) -> str:
    """The route `select` takes for tensors on t's device: "plain" on the
    CPU, "kernel" on a CUDA card."""
    return "plain" if t.device.type == "cpu" else "kernel"


def select(geo: Geometry, orig_p: torch.Tensor, tap_p: torch.Tensor, ex: torch.Tensor,
           coefs: torch.Tensor, eb: float):
    """Sampled-error selection for the {L1, REG} roster, over every block at
    once (_jit_select in the JAX package): see select_plain for the
    arguments and the result. CPU tensors take select_plain; CUDA tensors
    one launch of csrc/lorenzo_select.cu, bit-equal to it, which takes each
    block's extents from `geo` (`ex` is extents(geo) on every caller).
    ``select.launches`` counts the launches."""
    if select_route(orig_p) == "plain":
        return select_plain(geo, orig_p, tap_p, ex, coefs, eb)
    for t, dt, shape in ((orig_p, torch.float32, geo.padded), (tap_p, torch.float32, geo.padded),
                         (coefs, torch.float32, (4, *geo.nb))):
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous() \
                or t.device != orig_p.device:
            raise ValueError(f"select argument of {t.dtype} {tuple(t.shape)} on {t.device}: "
                             f"want a contiguous {dt} {shape} on {orig_p.device}")
    is_reg = torch.empty(geo.nb, dtype=torch.bool, device=orig_p.device)
    ok = torch.empty(geo.nb, dtype=torch.bool, device=orig_p.device)
    stream = torch.cuda.current_stream(orig_p.device).cuda_stream
    rc = kernels().szt_lorenzo_select(orig_p.data_ptr(), tap_p.data_ptr(), coefs.data_ptr(),
                                      is_reg.data_ptr(), ok.data_ptr(), *geo.dims,
                                      float(np.float32(_noise(1, 3, eb))), stream)
    if rc != 0:
        raise RuntimeError(f"szt_lorenzo_select: CUDA error {rc}")
    _SELECT.launches += 1
    return is_reg, ok


select.launches = 0
_SELECT = select        # the counter's owner, also while a caller wraps the module's name


def select_plain(geo: Geometry, orig_p: torch.Tensor, tap_p: torch.Tensor, ex: torch.Tensor,
                 coefs: torch.Tensor, eb: float):
    """Plain version of :func:`select`, on any device. orig_p and tap_p: padded
    (NX+2, NY+2, NZ+2) grids, the original values and the taps (the original
    values to speculate, the reconstruction to certify); ex: (3, nb0, nb1,
    nb2) extents; coefs: (4, nb0, nb1, nb2) raw fits. A tap inside the block
    being selected reads the original grid (those cells are not yet swept in
    the host engine), a tap in the pad reads tap_p. Returns (is_reg, ok),
    (nb0, nb1, nb2) bool each: the block selects regression, and the pick
    is valid. ok is false only where an invalid regression wins, which
    takes an infinite Lorenzo error (non-finite data); the host engine
    emits no selection for such a block and predicts it with Lorenzo-1.

    Sample order is the reference's diagonal pattern
    (BlockwiseIterator.hpp:151-184): i ascending, four points per i, with
    j = m-1-i (m the block's least extent). Every (i, j) pair with
    i + j <= 5 is computed for every block and masked, so each block's
    float64 sums take the same additions in the same order as the host's
    (the masked ones add exact zeros)."""
    nb = geo.nb
    f64 = torch.float64
    m = ex.min(dim=0).values
    noise1 = float(np.float32(_noise(1, 3, eb)))

    def val(a, b, c):
        g = orig_p if (a >= 0 and b >= 0 and c >= 0) else tap_p
        return g[PAD + a:PAD + a + BS * (nb[0] - 1) + 1:BS,
                 PAD + b:PAD + b + BS * (nb[1] - 1) + 1:BS,
                 PAD + c:PAD + c + BS * (nb[2] - 1) + 1:BS]

    def l1(px, py, pz):
        def at(dk, dj, di):
            return val(px - dj, py - dk, pz - di)
        return (at(0, 0, 1) + at(0, 1, 0) + at(1, 0, 0) - at(0, 1, 1)
                - at(1, 0, 1) - at(1, 1, 0) + at(1, 1, 1))

    zero = torch.zeros((), dtype=f64, device=orig_p.device)
    err1 = torch.zeros(nb, dtype=f64, device=orig_p.device)
    err_r = torch.zeros(nb, dtype=f64, device=orig_p.device)
    for i in range(BS):
        for j in range(BS - i):
            mask = (m - 1 - i == j) & (i < m)
            for px, py, pz in ((i, i, i), (i, i, j), (i, j, i), (i, j, j)):
                c = val(px, py, pz)
                e1 = (c - l1(px, py, pz)).abs() + noise1
                pr = coefs[0] * float(px) + coefs[1] * float(py) + coefs[2] * float(pz) + coefs[3]
                er = (c - pr).abs()
                err1 = err1 + torch.where(mask, e1.to(f64), zero)
                err_r = err_r + torch.where(mask, er.to(f64), zero)
    valid = (ex > 1).all(dim=0)
    err_r = torch.where(valid, err_r, DBL_MAX)
    # roster order [L1, REG]: strictly less wins, the first index on a tie
    pick_reg = err_r < err1
    return pick_reg & valid, ~(pick_reg & ~valid)


def reg_preplace_encode(geo: Geometry, g: torch.Tensor, rec: torch.Tensor,
                        is_reg: torch.Tensor, coefs: torch.Tensor, eb: float, radius: int):
    """The regression cells of the rounded grid `g` quantized against their
    blocks' plane predictions (coefs: the chain's reconstructed coefficients
    (nb0, nb1, nb2, 4)), their reconstruction written in place into the
    padded `rec`. Returns the cells' (flat indices in the rounded grid int64,
    bins int32) (_reg_preplace in the JAX package, which runs it in numpy
    on the host)."""
    flat, gflat = rec.view(-1), g.reshape(-1)
    cells = [torch.zeros(0, dtype=torch.int64, device=g.device)]
    bins = [torch.zeros(0, dtype=torch.int32, device=g.device)]
    for xyz, pred in reg_cells(geo, is_reg, coefs):
        cell, pad = cell_index(geo.grid, *xyz)
        b, r = quantize(gflat[cell], pred, eb, radius)
        flat[pad] = r
        cells.append(cell)
        bins.append(b)
    return torch.cat(cells), torch.cat(bins)


def sweep_encode_plain(rec: torch.Tensor, types: torch.Tensor, orig: torch.Tensor,
                       eb: float, radius: int) -> torch.Tensor:
    """Plain version of :func:`sweep_encode`: quantizes the Lorenzo cells in
    place on `rec`; returns their bins on the rounded grid (zeros at T_KEEP
    cells)."""
    flat = rec.view(-1)
    oflat = orig.reshape(-1)
    bins = torch.zeros(types.numel(), dtype=torch.int32, device=rec.device)

    def step(cell, pad, pred):
        b, r = quantize(oflat[cell], pred, eb, radius)
        bins[cell] = b
        flat[pad] = r

    sweep_planes(rec, types, step)
    return bins.reshape(types.shape)


def sweep_encode(rec: torch.Tensor, types: torch.Tensor, orig: torch.Tensor, eb: float,
                 radius: int) -> torch.Tensor:
    """The encode sweep (quantize form, see
    ops/blockwise_wavefront.lorenzo_sweep) in place on `rec`; returns the
    bins on the rounded grid."""
    check_sweep(rec, types, orig, radius)
    if rec.device.type == "cpu":
        return sweep_encode_plain(rec, types, orig, eb, radius)
    bins = torch.empty(types.shape, dtype=torch.int32, device=rec.device)
    lorenzo_sweep(rec, types, bins, orig, eb, radius, encode=True)
    return bins


def _first_difference(a: np.ndarray, b: np.ndarray) -> int:
    d = np.flatnonzero(a != b)
    return int(d[0]) if d.size else -1


def encode_blocks_wavefront(x: torch.Tensor, eb: float, radius: int, use_l1: bool,
                            use_l2: bool, use_reg: bool, stats: Optional[dict] = None):
    """The compress sweep of the float32 3D field `x` on its device.

    Returns (bins on the rounded grid (NX, NY, NZ) int32, zeros outside the
    field; the original values on the rounded grid float32; selection int32,
    reg_bins int32, ql_unpred and qi_unpred float32 on the host), the side
    streams as the host engine writes them. `stats`, if given, receives the
    number of sweeps ("passes") and, per pass, the first block where the
    swept and the recomputed selection differ ("first_differences", -1 on
    the certifying pass)."""
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"the device LORENZO_REG encode takes 3D float32, not {x.dtype} "
                         f"{tuple(x.shape)}")
    if use_l2 or not (use_l1 or use_reg):
        raise ValueError("the device LORENZO_REG encode takes the rosters {L1}, {REG} and "
                         "{L1, REG}")
    if stats is None:
        stats = {}
    geo = geometry(x.shape)
    with trace.span("lorenzo.encode", blocks=geo.nblk) as sp:
        out = _encode(geo, x, float(eb), int(radius), use_l1, use_reg, stats)
        sp.set(passes=stats["passes"])
    return out


def _encode(geo: Geometry, x: torch.Tensor, eb: float, radius: int, use_l1: bool,
            use_reg: bool, stats: dict):
    """encode_blocks_wavefront's sweep and certification, each phase in its
    span; `stats` receives the passes and first differences."""
    dev = x.device
    single = not (use_l1 and use_reg)
    with trace.span("lorenzo.fits", reg=use_reg):
        g = torch.zeros(geo.grid, dtype=torch.float32, device=dev)
        g[:geo.dims[0], :geo.dims[1], :geo.dims[2]] = x
        ex = extents(geo, dev)
        if use_reg:
            def by_cell(a):         # (216, nblk): one row per in-block cell
                return blocked(a, geo).permute(1, 3, 5, 0, 2, 4).reshape(E, geo.nblk)
            raw = fits(by_cell(g), by_cell(valid_cells(geo, dev)), ex.reshape(3, -1))  # (4, nblk)
        else:
            raw = torch.zeros((4, geo.nblk), dtype=torch.float32, device=dev)
        raw_host = raw.t().cpu().numpy()                                       # (nblk, 4)
        raw_g = raw.reshape(4, *geo.nb)
        orig_p = padded_grid(geo, g)
    if single:      # one predictor: nothing is speculated
        is_reg = reg_valid(geo, dev) if use_reg else torch.zeros(geo.nb, dtype=torch.bool,
                                                                 device=dev)
    else:
        with trace.span("lorenzo.select", phase="speculate", pass_no=0,
                        route=select_route(orig_p)):
            is_reg, ok = select(geo, orig_p, orig_p, ex, raw_g, eb)

    # the sweep's reconstruction, made again in place by every pass
    rec = torch.empty(geo.padded, dtype=torch.float32, device=dev)
    passes, firsts, last_first = 0, [], -1
    while True:
        passes += 1
        with trace.span("lorenzo.chain", pass_no=passes):
            is_reg_h = is_reg.reshape(-1).cpu().numpy()
            raw_commit = raw_host[is_reg_h]
            regb, creg = runtime.blockwise_coef_chain_encode(eb / 4 / BS, eb / 4, raw_commit)
            coef_rec = np.zeros((geo.nblk, 4), np.float32)
            coef_rec[is_reg_h] = creg
        with trace.span("lorenzo.preplace", pass_no=passes):
            rec.zero_()
            reg_idx, reg_bins = reg_preplace_encode(
                geo, g, rec, is_reg, torch.from_numpy(coef_rec).to(dev).reshape(*geo.nb, 4), eb,
                radius)
            types = cell_types(geo, torch.where(is_reg, T_KEEP, T_L1).to(torch.uint8).reshape(-1))
        with trace.span("lorenzo.sweep", cells=types.numel(), pass_no=passes):
            bins = sweep_encode(rec, types, g, eb, radius)
        if single:
            firsts.append(-1)
            break
        with trace.span("lorenzo.select", phase="certify", pass_no=passes,
                        route=select_route(orig_p)):
            is_reg_true, ok = select(geo, orig_p, rec, ex, raw_g, eb)
            first = _first_difference(is_reg_true.reshape(-1).cpu().numpy(), is_reg_h)
        firsts.append(first)
        if first < 0:
            break
        if first <= last_first:
            raise RuntimeError(f"LORENZO_REG certification made no progress: pass {passes} "
                               f"first differs at block {first}, the pass before at "
                               f"{last_first}")
        last_first = first
        is_reg = is_reg_true
        del bins, types, reg_idx, reg_bins      # the next pass makes them anew
    stats["passes"] = passes
    stats["first_differences"] = firsts

    selection = np.zeros(0, np.int32)
    if not single:          # one entry per block with a valid pick; REG is roster index 1
        selection = is_reg_h[ok.reshape(-1).cpu().numpy()].astype(np.int32)
    ql_unpred = raw_commit[:, :3][regb[:, :3] == 0].astype(np.float32)
    qi_unpred = raw_commit[:, 3][regb[:, 3] == 0].astype(np.float32)
    bins.view(-1)[reg_idx] = reg_bins        # the sweep leaves 0 at regression cells
    return (bins, g, selection, regb.reshape(-1).astype(np.int32), ql_unpred,
            qi_unpred)
