"""SZ3's interpolation decomposition of a 1D or 2D field, in plain torch.

The reference that the port's default path is held to: the quantization bin
of every point, the unpredictable values and the reconstructed field that
SZ3's InterpolationDecomposition writes for a field under one setting
(``interpAlgo``, ``interpDirection``, ``interpAlpha`` / ``interpBeta``,
``interpAnchorStride``, the absolute bound and ``quantbinCnt``), and the
stream order in which the archive lists the bins. It is written from SZ3's
own code (decomposition/InterpolationDecomposition.hpp,
utils/Interpolators.hpp, quantizer/LinearQuantizer.hpp; SURVEY.md section
2), and imports nothing of jax, of the sz3_tpu package or of sz3_tpu_torch.

SZ3's rules, as followed here:

  levels      ``ceil(log2(max dim))`` (:183-190). With an anchor stride
              that some dimension exceeds (else the stride is taken as 0,
              :187-192), the levels are capped at ``log2(stride) + 1``
              (:193-198), the anchor grid (every point whose coordinates
              are all multiples of the stride) is saved losslessly, each
              anchor a bin 0 and an unpredictable value (build_anchor_grid,
              :215-222), and the top level is dropped. Without anchors the
              first point is quantized against 0 at the base bound.
  level bound ``eb * 0.5`` from level 3 up where alpha < 0, ``eb / min(alpha
              ** (level - 1), beta)`` where alpha >= 1, else eb (:101-116).
  blocks      level l has stride s = 2^(l-1) and blocks of 32 s, visited
              row-major; a block spans [begin, min(begin + 32 s, dim - 1)]
              along each axis (:117-135).
  a 2D block  with ``(d0, d1)`` the ``interpDirection``-th permutation of
              the axes: first the lines along d0 at every d1 coordinate
              that is a multiple of 2s, then the lines along d1 at every d0
              coordinate that is a multiple of s; a line at a block's first
              coordinate other than 0 belongs to the block before (the
              ICDE'21 per-line API, :247-293 and :404-454). A 1D field is
              one line a block.
  a line      of n points: linear, or cubic with n < 5, predicts the odd
              points by ``(a + b) / 2``, and for even n the last by a copy
              of its neighbour (n < 4) or by ``-0.5 a + 1.5 b`` (in double,
              then rounded to the field's type); cubic predicts the odd
              points from the fourth on by ``(-a + 9b + 9c - d) / 16``, then
              the first by ``interp_quad_1`` ``(3a + 6b - c) / 8``, the last
              odd one by ``interp_quad_2`` ``(-a + 6b + 3c) / 8``, and for
              even n the last point by ``interp_quad_3`` ``(3a - 10b + 15c)
              / 8`` (Interpolators.hpp:12-39), each in the field's type, one
              operation at a time, in the order the source writes it.
  quantizer   LinearQuantizer with radius ``quantbinCnt / 2`` (32768 by
              default): ``q = int64(|x - p| / eb) + 1`` (the product with
              the double reciprocal of eb); where ``q < 2 radius``, q is
              rounded down to even, the reconstruction ``p + q eb`` (sign of
              x - p, in double, rounded to the field's type) is kept when it
              lies within eb of x, and the bin is ``radius +- q / 2``; else
              the point is unpredictable: bin 0, its value saved and kept
              (LinearQuantizer.hpp:43-71). Each point is predicted from
              reconstructed values, as the decoder will see them.

Departures from SZ3's loop order, none of which changes a value:

  - Each (level, direction) pass is one vectorised step over all its lines
    and blocks at once, where SZ3 walks block by block and line by line. No
    point of a pass predicts from another point of the same pass: the
    points predicted are the odd multiples of s along the pass's axis, and
    every neighbour a predictor reads lies at an even multiple of s along
    it, on a line that an earlier pass or level finished. The second pass
    reads the first pass's points, and runs after it, as in SZ3.
  - Inside a pass, the points are taken predictor by predictor (all cubic
    points, then all quad_1 points, ...), not in SZ3's order along each
    line. Each point's value depends only on its neighbours, so the order
    moves no value; it moves only the order in which unpredictable values
    are saved, and ``Encoded.order`` restores SZ3's order (block, then
    pass, then line, then the line's own order: the run of linear or cubic
    points, then quad_1, quad_2, quad_3 or the last point).
  - The fields are finite: SZ3's ``int64`` cast of a NaN or of a quotient
    past 2^63 is left undefined by C++, and is not reproduced.
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple

import torch

BLOCKSIZE = 32
# the predictors of a line (utils/Interpolators.hpp)
LINEAR, LINEAR1, COPY, CUBIC, QUAD1, QUAD2, QUAD3 = range(7)


class Encoded(NamedTuple):
    bins: torch.Tensor      # int32, the field's shape: each point's bin (anchors 0)
    unpred: torch.Tensor    # the unpredictable values, in the archive's stream order
    recon: torch.Tensor     # the reconstructed field, as the decoder rebuilds it
    order: torch.Tensor     # int64: order[i] is the flat index of the i-th bin of the stream


def settings(conf) -> dict:
    """The keyword arguments of ``encode`` from a Config-like object (the
    Config an archive carries), read by attribute name."""
    return {"eb": float(conf.absErrorBound), "interp_algo": int(conf.interpAlgo),
            "direction": int(conf.interpDirection), "alpha": float(conf.interpAlpha),
            "beta": float(conf.interpBeta), "anchor_stride": int(conf.interpAnchorStride),
            "quantbin_cnt": int(conf.quantbinCnt)}


def level_eb(eb: float, level: int, alpha: float, beta: float) -> float:
    if alpha < 0:
        return eb * 0.5 if level >= 3 else eb
    if alpha >= 1:
        return eb / min(alpha ** (level - 1), beta)
    return eb


def levels_and_anchor(dims, anchor_stride: int):
    """(the number of levels the loop runs, the anchor stride in force)."""
    levels = max(int(math.ceil(math.log2(d))) for d in dims)
    if anchor_stride > 0 and not any(d > anchor_stride for d in dims):
        anchor_stride = 0
    if anchor_stride > 0:
        levels = min(levels, int(math.log2(anchor_stride)) + 1) - 1
    return levels, anchor_stride


def line_points(n: int, cubic: bool):
    """[(local index, kind, rank)] of one line of n points (the ICDE'21
    block_interpolation_1d); rank orders them as SZ3 visits them."""
    if n <= 1:
        return []
    if not cubic or n < 5:
        out = [(i, LINEAR, 2 * i) for i in range(1, n - 1, 2)]
        if n % 2 == 0:
            out.append((n - 1, COPY if n < 4 else LINEAR1, 2 * (n - 1)))
        return out
    out = [(i, CUBIC, 2 * i) for i in range(3, n - 3, 2)]
    last = 3 + 2 * len(out)                      # the loop's i once it ends
    out.append((1, QUAD1, 2 * last - 1))         # after the cubic run
    out.append((last, QUAD2, 2 * last))
    if n % 2 == 0:
        out.append((n - 1, QUAD3, 2 * (n - 1)))
    return out


def axis_points(dim: int, s: int, cubic: bool):
    """The points a pass predicts along an axis of `dim` at stride s: their
    coordinates, kinds, ranks on their line and block index along the axis,
    block by block of 32 s."""
    ibs = BLOCKSIZE * s
    pos, kind, rank, block = [], [], [], []
    for b, begin in enumerate(range(0, dim, ibs)):
        end = min(begin + ibs, dim - 1)
        for i, k, r in line_points((end - begin) // s + 1, cubic):
            pos.append(begin + i * s)
            kind.append(k)
            rank.append(r)
            block.append(b)
    return pos, kind, rank, block


def _predict(kind: int, at) -> torch.Tensor:
    """The prediction of `kind` from the reconstructed values `at(offset)`
    (offset in units of s along the pass's axis), in the field's type."""
    if kind == LINEAR:
        return (at(-1) + at(1)) / 2
    if kind == COPY:
        return at(-1)
    if kind == LINEAR1:
        return (-0.5 * at(-3).double() + 1.5 * at(-1).double()).to(at(-1).dtype)
    if kind == CUBIC:
        return (-at(-3) + 9 * at(-1) + 9 * at(1) - at(3)) / 16
    if kind == QUAD1:
        return (3 * at(-1) + 6 * at(1) - at(3)) / 8
    if kind == QUAD2:
        return (-at(-3) + 6 * at(-1) + 3 * at(1)) / 8
    return (3 * at(-5) - 10 * at(-3) + 15 * at(-1)) / 8


def quantize(x: torch.Tensor, pred: torch.Tensor, eb: float, radius: int):
    """LinearQuantizer.quantize_and_overwrite on every point: (bins int32,
    reconstruction)."""
    diff = x - pred
    qd = diff.abs().double() * (1.0 / eb)
    fits = qd < 2 * radius - 1                   # int64(qd) + 1 < 2 radius
    half = (torch.where(fits, qd, torch.zeros_like(qd)).to(torch.int64) + 1) >> 1
    neg = diff < 0
    signed = torch.where(neg, -2 * half, 2 * half)
    dec = (pred.double() + signed.double() * eb).to(x.dtype)
    ok = fits & ((dec - x).abs().double() <= eb)
    bins = torch.where(neg, radius - half, radius + half).to(torch.int32)
    return torch.where(ok, bins, torch.zeros_like(bins)), torch.where(ok, dec, x)


def encode(x: torch.Tensor, eb: float, *, interp_algo: int = 1, direction: int = 0,
           alpha: float = -1.0, beta: float = -1.0, anchor_stride: int = 0,
           quantbin_cnt: int = 65536) -> Encoded:
    """SZ3's interpolation decomposition of the 1D or 2D field `x` (any
    float dtype, any device) at absolute bound `eb`."""
    if x.dim() not in (1, 2):
        raise ValueError(f"a {x.dim()}D field: this reference takes SZ3's 1D/2D traversal")
    dims = tuple(x.shape)
    dev = x.device
    radius = quantbin_cnt // 2
    cubic = interp_algo == 1
    levels, anchor = levels_and_anchor(dims, anchor_stride)
    axes = list(itertools.permutations(range(x.dim())))[direction if x.dim() > 1 else 0]
    recon = x.clone()
    bins = torch.zeros(dims, dtype=torch.int32, device=dev)
    flat = torch.arange(x.numel(), device=dev).reshape(dims)
    if anchor:
        first = flat[tuple(slice(0, None, anchor) for _ in dims)].reshape(-1)
    else:
        first = flat.reshape(-1)[:1]
        b, r = quantize(x.reshape(-1)[:1], torch.zeros(1, dtype=x.dtype, device=dev), eb,
                        radius)
        bins.view(-1)[:1], recon.view(-1)[:1] = b, r
    order = [first]
    for level in range(levels, 0, -1):
        s = 1 << (level - 1)
        ibs = BLOCKSIZE * s
        cur_eb = level_eb(eb, level, alpha, beta)
        nblocks = [(d - 1) // ibs + 1 for d in dims]
        keys, where = [], []
        # the pass along axes[0] runs on lines every 2s; that along axes[1] on lines every s
        for p, (along, step) in enumerate(zip(axes, (2 * s, s))):
            across = [a for a in range(len(dims)) if a != along]
            pos, kind, rank, blk = (torch.tensor(v, dtype=torch.int64, device=dev)
                                    for v in axis_points(dims[along], s, cubic))
            if pos.numel() == 0:
                continue
            if across:
                lines = torch.arange(0, dims[across[0]], step, device=dev)
                # a line at a block's first coordinate (but 0) is the block before's last
                lblk = torch.clamp(lines - 1, min=0) // ibs
            else:
                lines = torch.zeros(1, dtype=torch.int64, device=dev)
                lblk = lines
            # views (pass axis first, lines second): what is written lands in recon and bins
            r = recon.movedim(along, 0).reshape(dims[along], -1)
            xo = x.movedim(along, 0).reshape(dims[along], -1)
            bo = bins.movedim(along, 0).reshape(dims[along], -1)
            fo = flat.movedim(along, 0).reshape(dims[along], -1)
            got_b = torch.empty((pos.numel(), lines.numel()), dtype=torch.int32, device=dev)
            got_r = torch.empty((pos.numel(), lines.numel()), dtype=x.dtype, device=dev)
            for k in kind.unique().tolist():
                sel = torch.nonzero(kind == k).reshape(-1)
                pk = pos[sel]
                pred = _predict(k, lambda o: r[pk + o * s][:, lines])
                got_b[sel], got_r[sel] = quantize(xo[pk][:, lines], pred, cur_eb, radius)
            # written back after every predictor has read: no point of a pass
            # reads another point of it
            r[pos[:, None], lines[None, :]] = got_r
            bo[pos[:, None], lines[None, :]] = got_b
            # SZ3's visiting order: row-major block, pass, line, place on the line
            bpos = [None] * len(dims)
            bpos[along] = blk[:, None]
            if across:
                bpos[across[0]] = lblk[None, :]
            block_id = bpos[0] * nblocks[1] + bpos[1] if len(dims) == 2 else bpos[0]
            line_no = lines[None, :].expand(pos.numel(), -1)
            key = ((block_id * 2 + p) * (max(dims) + 1) + line_no) * (2 * max(dims) + 2) \
                + rank[:, None]
            keys.append(key.reshape(-1))
            where.append(fo[pos][:, lines].reshape(-1))
        if keys:
            key, at = torch.cat(keys), torch.cat(where)
            order.append(at[torch.argsort(key)])
    order = torch.cat(order)
    fx = x.reshape(-1)[order]
    return Encoded(bins, fx[bins.reshape(-1)[order] == 0], recon, order)
