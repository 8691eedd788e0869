"""ALGO_LORENZO_REG on the device, decode side, and the element sweep that
both directions share (counterpart of sz3_tpu/ops/blockwise_wavefront.py).

The decode has no selection step: the predictor of each block is an archive
stream, and the regression coefficient chain (a few scalar operations per
committing block, RegressionPredictor.hpp:157-164) is replayed by the host
engine (runtime.blockwise_coef_chain). Regression cells depend only on their
block's coefficients, so they are placed first, all at once. What is left is
the element sweep over the Lorenzo cells, whose stencils read the
reconstruction at offsets that are non-positive in every axis and sum to at
least 1: every cell of the anti-diagonal plane x + y + z = t depends only on
earlier planes, whatever block it lies in.

  lorenzo_sweep    csrc/lorenzo_sweep.cu, where the JAX package runs the
                   lax.scan of _jit_wavefront (decode) and _jit_wavefront_enc
                   (encode, ops/blockwise_wavefront_encode.py). It takes and
                   hands back the natural, front-padded reconstruction, and
                   inside works in the plane-major layout (``plane_index``):
                   each plane x + y + z = t one contiguous slab of rows of
                   fixed y, z ascending, sized to the padded cells. So a
                   warp's lanes read and write consecutive addresses, and
                   the stencil's taps come from the last few planes, in L2.
                   One C call converts the arrays in (tiled transposes,
                   ``to_planes_plain`` in plain PyTorch), launches one
                   kernel per plane (NX + NY + NZ - 2), and converts rec
                   (and the encode's bins) back (``from_planes_plain``).
                   ``launches`` counts sweeps.

The wrappers (sweep_decode here, sweep_encode in
ops/blockwise_wavefront_encode.py) run the plain PyTorch versions
(sweep_decode_plain, sweep_encode_plain) when handed CPU tensors, and only
then. For CUDA tensors they launch the kernel or raise.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import runtime
from ..build import kernels
from .blockwise_layout import (BS, PAD, T_KEEP, T_L1, T_L2, Geometry, extents, per_block,
                               reg_valid, valid_cells)
from .quantize import recover


def roster_of(use_l1: bool, use_l2: bool, use_reg: bool) -> List[str]:
    roster = [p for p, on in (("L1", use_l1), ("L2", use_l2), ("REG", use_reg)) if on]
    if not roster:
        raise ValueError("all predictors disabled")
    return roster


def selection_info(geo: Geometry, roster, selection, reg_bins, ql_unpred, qi_unpred,
                   eb: float):
    """Archive side streams -> (per-block sweep type (nblk,) uint8: T_L1,
    T_L2, or T_KEEP for a regression block; reconstructed coefficients
    (nblk, 4) float32, zero outside the committing blocks), on the host.
    Thin blocks of a regression-only roster cannot regress and predict with
    Lorenzo-1, as the host engine does (_selection_info in the JAX
    package)."""
    nblk = geo.nblk
    kind_type = {"L1": T_L1, "L2": T_L2, "REG": T_KEEP}
    if len(roster) == 1:
        if roster[0] == "REG":
            commit = reg_valid(geo, "cpu").reshape(-1).numpy()
            types = np.where(commit, T_KEEP, T_L1).astype(np.uint8)
        else:
            commit = np.zeros(nblk, bool)
            types = np.full(nblk, kind_type[roster[0]], np.uint8)
    else:
        sel = np.asarray(selection, np.int32)
        if sel.shape != (nblk,) or sel.min() < 0 or sel.max() >= len(roster):
            raise ValueError(f"selection stream of {sel.size} entries for {nblk} blocks and "
                             f"{len(roster)} predictors")
        types = np.asarray([kind_type[k] for k in roster], np.uint8)[sel]
        commit = types == T_KEEP
    reg_bins = np.asarray(reg_bins, np.int32).reshape(-1)
    if reg_bins.size != 4 * int(commit.sum()):
        raise ValueError(f"coefficient stream of {reg_bins.size} bins for "
                         f"{int(commit.sum())} regression blocks")
    coefs = np.zeros((nblk, 4), np.float32)
    if commit.any():
        coefs[commit] = runtime.blockwise_coef_chain(
            eb / 4 / BS, eb / 4, reg_bins.reshape(-1, 4), ql_unpred, qi_unpred)
    return types, coefs


# the regression cells are placed this many blocks at a time, so that the
# placement's temporaries stay small whatever share of the blocks regress
REG_CHUNK = 1 << 14


def reg_cells(geo: Geometry, is_reg: torch.Tensor, coefs: torch.Tensor):
    """The cells inside the field of the regression blocks (is_reg (nb0,
    nb1, nb2) bool), REG_CHUNK blocks at a time: yields ((x, y, z) rounded-
    grid coordinates, (n,) int64 each; each cell's plane prediction
    c0*x + c1*y + c2*z + c3 from its block's coefficients (coefs (nb0, nb1,
    nb2, 4) float32) with in-block x, y, z, in float32 and in that order)."""
    dev = is_reg.device
    blks = torch.nonzero(is_reg.reshape(-1)).reshape(-1)
    ex = extents(geo, dev).reshape(3, -1)
    cs = coefs.reshape(-1, 4)
    t = torch.arange(BS ** 3, device=dev)
    loc = (t // (BS * BS), (t // BS) % BS, t % BS)
    locf = [c.to(torch.float32) for c in loc]
    for lo in range(0, blks.numel(), REG_CHUNK):
        blk = blks[lo:lo + REG_CHUNK]
        b = (blk // (geo.nb[1] * geo.nb[2]), (blk // geo.nb[2]) % geo.nb[1], blk % geo.nb[2])
        inside = ((loc[0] < ex[0, blk, None]) & (loc[1] < ex[1, blk, None])
                  & (loc[2] < ex[2, blk, None]))
        c = cs[blk]
        pred = c[:, 0:1] * locf[0] + c[:, 1:2] * locf[1] + c[:, 2:3] * locf[2] + c[:, 3:4]
        yield [(b[a][:, None] * BS + loc[a])[inside] for a in range(3)], pred[inside]


def cell_index(grid, x, y, z):
    """(flat index in the rounded grid `grid`, flat index in its padded
    grid) of the cells (x, y, z), int64."""
    nx, ny, nz = grid
    return (x * ny + y) * nz + z, ((x + PAD) * (ny + PAD) + (y + PAD)) * (nz + PAD) + (z + PAD)


def cell_types(geo: Geometry, block_types: torch.Tensor) -> torch.Tensor:
    """Per-block sweep types (nblk,) uint8 -> per-cell types on the rounded
    grid, T_KEEP outside the field."""
    t = per_block(block_types.reshape(geo.nb), geo).expand(
        geo.nb[0], BS, geo.nb[1], BS, geo.nb[2], BS).reshape(geo.grid)
    return torch.where(valid_cells(geo, block_types.device), t, T_KEEP).to(torch.uint8)


def padded_grid(geo: Geometry, inner: torch.Tensor) -> torch.Tensor:
    """The sweep's reconstruction: zeros with `inner` (the rounded grid)
    behind the front pad."""
    r = torch.zeros(geo.padded, dtype=torch.float32, device=inner.device)
    r[PAD:, PAD:, PAD:] = inner
    return r


def reg_preplace_decode(geo: Geometry, rec: torch.Tensor, is_reg: torch.Tensor,
                        bins: torch.Tensor, lits: torch.Tensor, coefs: torch.Tensor, eb: float,
                        radius: int) -> None:
    """The regression cells recovered against their blocks' plane
    predictions, written in place into the padded reconstruction `rec`."""
    flat, bflat, lflat = rec.view(-1), bins.reshape(-1), lits.reshape(-1)
    for xyz, pred in reg_cells(geo, is_reg, coefs):
        cell, pad = cell_index(geo.grid, *xyz)
        flat[pad] = recover(pred, bflat[cell], lflat[cell], eb, radius)


# ---- the element sweep ------------------------------------------------------------

def _plane_cells(grid, t: int, yz: torch.Tensor):
    """The cells of plane x + y + z = t: (flat index in the rounded grid,
    flat index in the padded grid), int64."""
    nz = grid[2]
    y, z = yz // nz, yz % nz
    x = t - y - z
    on = (x >= 0) & (x < grid[0])
    return cell_index(grid, x[on], y[on], z[on])


def lorenzo_predictions(rec: torch.Tensor, p: torch.Tensor, sx: int, sy: int):
    """(first-order, second-order) Lorenzo predictions of the padded cells
    `p` from the flat reconstruction `rec`, each in float32 in the reference's
    exact summation order. The reference's prev3(k, j, i) reads the cell at
    (x - j, y - k, z - i): j moves planes and k rows (LorenzoPredictor.hpp:
    66-68, 104-106); mapping them the other way round swaps two terms and
    drifts a prediction by an ulp at rounding boundaries."""
    def at(dk, dj, di):
        return rec[p - (dj * sx + dk * sy + di)]

    p1 = (at(0, 0, 1) + at(0, 1, 0) + at(1, 0, 0) - at(0, 1, 1)
          - at(1, 0, 1) - at(1, 1, 0) + at(1, 1, 1))
    p2 = (2 * at(0, 0, 1) - at(0, 0, 2) + 2 * at(0, 1, 0) - 4 * at(0, 1, 1)
          + 2 * at(0, 1, 2) - at(0, 2, 0) + 2 * at(0, 2, 1) - at(0, 2, 2)
          + 2 * at(1, 0, 0) - 4 * at(1, 0, 1) + 2 * at(1, 0, 2)
          - 4 * at(1, 1, 0) + 8 * at(1, 1, 1) - 4 * at(1, 1, 2)
          + 2 * at(1, 2, 0) - 4 * at(1, 2, 1) + 2 * at(1, 2, 2)
          - at(2, 0, 0) + 2 * at(2, 0, 1) - at(2, 0, 2) + 2 * at(2, 1, 0)
          - 4 * at(2, 1, 1) + 2 * at(2, 1, 2) - at(2, 2, 0)
          + 2 * at(2, 2, 1) - at(2, 2, 2))
    return p1, p2


def sweep_planes(rec: torch.Tensor, types: torch.Tensor, step) -> None:
    """The plain sweep's walk: for each plane in order, the plane's Lorenzo
    cells and their predictions handed to step(cell, pad, pred), which
    writes the padded reconstruction at `pad`."""
    grid = tuple(types.shape)
    nx, ny, nz = grid
    sx, sy = (ny + PAD) * (nz + PAD), nz + PAD
    flat, tflat = rec.view(-1), types.reshape(-1)
    yz = torch.arange(ny * nz, device=rec.device)
    for t in range(nx + ny + nz - 2):
        cell, pad = _plane_cells(grid, t, yz)
        ty = tflat[cell]
        lor = ty < T_KEEP
        cell, pad, ty = cell[lor], pad[lor], ty[lor]
        if cell.numel() == 0:
            continue
        p1, p2 = lorenzo_predictions(flat, pad, sx, sy)
        step(cell, pad, torch.where(ty == T_L2, p2, p1))


def sweep_decode_plain(rec: torch.Tensor, types: torch.Tensor, bins: torch.Tensor,
                       lits: torch.Tensor, eb: float, radius: int) -> torch.Tensor:
    """Plain version of :func:`sweep_decode`."""
    flat = rec.view(-1)
    bflat, lflat = bins.reshape(-1), lits.reshape(-1)

    def step(cell, pad, pred):
        flat[pad] = recover(pred, bflat[cell], lflat[cell], eb, radius)

    sweep_planes(rec, types, step)
    return rec


def check_sweep(rec, types, vals, radius, bins=None) -> None:
    """The sweep's arguments: rec (NX+2, NY+2, NZ+2) float32, types (NX, NY,
    NZ) uint8, vals and (for the decode) bins (NX, NY, NZ) float32 / int32,
    all contiguous on one device."""
    grid = tuple(types.shape)
    if len(grid) != 3 or min(grid) < 1:
        raise ValueError(f"the sweep's grid must be 3D, not {grid}")
    want = [(rec, torch.float32, tuple(g + PAD for g in grid)), (types, torch.uint8, grid),
            (vals, torch.float32, grid)] + ([(bins, torch.int32, grid)] if bins is not None else [])
    for t, dt, shape in want:
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous() \
                or t.device != rec.device:
            raise ValueError(f"sweep argument of {t.dtype} {tuple(t.shape)} on {t.device}: want "
                             f"a contiguous {dt} {shape} on {rec.device}")
    if not 0 < radius < 2 ** 30:
        raise ValueError(f"radius {radius} outside [1, 2^30)")
    if rec.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rec.device}")


# ---- the sweep's plane-major layout ------------------------------------------------

def _tri(k: torch.Tensor) -> torch.Tensor:
    k = k.clamp(min=0)
    return k * (k + 1) // 2


def _tet(k: torch.Tensor) -> torch.Tensor:
    k = k.clamp(min=0)
    return k * (k + 1) * (k + 2) // 6


def _below2(s, p: int, q: int):
    """The (x, z) pairs of [0, p) x [0, q) with x + z < s."""
    return _tri(s) - _tri(s - p) - _tri(s - q) + _tri(s - p - q)


def _below3(t, p: int, r: int, q: int):
    """The cells of [0, p) x [0, r) x [0, q) with x + y + z < t."""
    return (_tet(t) - _tet(t - p) - _tet(t - r) - _tet(t - q) + _tet(t - p - r)
            + _tet(t - p - q) + _tet(t - r - q) - _tet(t - p - r - q))


def plane_cells(grid) -> int:
    """The plane-major layout's size for the rounded grid `grid`: its padded
    cells, not the box of its planes."""
    return int(np.prod([g + PAD for g in grid]))


def plane_index(grid, device="cpu") -> torch.Tensor:
    """Each padded cell's position in the sweep's plane-major layout of the
    rounded grid `grid`, (NX+2, NY+2, NZ+2) int64: plane t = x + y + z is
    the slab [below3(t), below3(t + 1)), its rows (fixed y) in ascending y,
    each row's z ascending, as csrc/lorenzo_sweep.cu places them."""
    p, r, q = (g + PAD for g in grid)
    x = torch.arange(p, device=device).reshape(-1, 1, 1)
    y = torch.arange(r, device=device).reshape(1, -1, 1)
    z = torch.arange(q, device=device).reshape(1, 1, -1)
    t, s = x + y + z, x + z + 1
    return (_below3(t, p, r, q) + _below2(t + 1, p, q) - _below2(s, p, q)
            - (s - p).clamp(min=0) + z)


def to_planes_plain(nat: torch.Tensor, grid) -> torch.Tensor:
    """Plain version of the sweep's conversion into the plane-major layout
    (convert<true> in csrc/lorenzo_sweep.cu): `nat`, the padded grid or the
    rounded grid `grid` itself, flat with plane_cells(grid) entries; zeros at
    the pad's cells for an array of the rounded grid."""
    shape, padded = tuple(nat.shape), tuple(g + PAD for g in grid)
    if shape not in (padded, tuple(grid)):
        raise ValueError(f"array of shape {shape} on neither the grid {tuple(grid)} nor its "
                         f"padded grid")
    lo = 0 if shape == padded else PAD
    pm = torch.zeros(plane_cells(grid), dtype=nat.dtype, device=nat.device)
    pm[plane_index(grid, nat.device)[lo:, lo:, lo:].reshape(-1)] = nat.reshape(-1)
    return pm


def from_planes_plain(pm: torch.Tensor, grid, padded: bool) -> torch.Tensor:
    """Plain version of the sweep's conversion out of the plane-major layout
    (convert<false>): `pm` in the natural layout, the padded grid or
    (padded False) the rounded grid `grid`."""
    lo = 0 if padded else PAD
    return pm[plane_index(grid, pm.device)[lo:, lo:, lo:]]


def _planes(grid) -> int:
    """The padded grid's planes x + y + z = t."""
    return sum(grid) + 3 * PAD - 2


def sweep_scratch_bytes(grid) -> int:
    """The sweep's scratch: 13 bytes a padded cell (the plane-major
    reconstruction, bins and values, 4 bytes each, and types), rounded up
    to 8, then each plane's first position (8 bytes a plane)."""
    return -(-13 * plane_cells(grid) // 8) * 8 + 8 * _planes(grid)


def lorenzo_sweep(rec: torch.Tensor, types: torch.Tensor, ints: torch.Tensor,
                  vals: torch.Tensor, eb: float, radius: int, encode: bool) -> None:
    """Launch the element sweep on CUDA tensors checked by check_sweep: the
    cells of type T_L1 / T_L2, in place on the padded reconstruction `rec`.
    Decode: `ints` holds the bins and `vals` the literals placed at the zero
    bins; a cell becomes pred + 2*(bin - radius)*eb in float64 narrowed to
    float32, or its literal. Encode: `vals` holds the original values and
    `ints` receives the bins (0 at T_KEEP cells); a cell is quantized as
    ops/quantize.quantize does and `rec` receives its reconstruction. Cells
    of type T_KEEP are left as they are. The sweep runs in the plane-major
    layout, in a scratch of sweep_scratch_bytes; its conversions in and out
    are part of the call."""
    nx, ny, nz = types.shape
    scratch = torch.empty(sweep_scratch_bytes(types.shape), dtype=torch.uint8,
                          device=rec.device)
    stream = torch.cuda.current_stream(rec.device).cuda_stream
    rc = kernels().szt_lorenzo_sweep(rec.data_ptr(), types.data_ptr(), ints.data_ptr(),
                                     vals.data_ptr(), nx, ny, nz, float(eb), 1.0 / eb,
                                     radius, int(encode), scratch.data_ptr(), scratch.numel(),
                                     stream)
    if rc != 0:
        raise RuntimeError(f"szt_lorenzo_sweep: CUDA error {rc}")
    lorenzo_sweep.launches += 1


lorenzo_sweep.launches = 0


def sweep_decode(rec, types, bins, lits, eb: float, radius: int) -> torch.Tensor:
    """The decode sweep (recover form, see lorenzo_sweep) in place on `rec`;
    returns it."""
    check_sweep(rec, types, lits, radius, bins)
    if rec.device.type == "cpu":
        return sweep_decode_plain(rec, types, bins, lits, eb, radius)
    lorenzo_sweep(rec, types, bins, lits, eb, radius, encode=False)
    return rec
