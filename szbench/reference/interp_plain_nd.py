"""SZ3's interpolation decomposition of a 3D or 4D field, in plain torch.

The reference that the port's default path is held to at rank 3 and 4: the
quantization bin of every point, the unpredictable values and the
reconstructed field that SZ3's InterpolationDecomposition writes for a field
under one setting (``interpAlgo``, ``interpDirection``, ``interpAlpha`` /
``interpBeta``, ``interpAnchorStride``, the absolute bound and
``quantbinCnt``), and the stream order in which the archive lists the bins.
It is written from SZ3's own code (decomposition/InterpolationDecomposition.hpp,
utils/Interpolators.hpp, quantizer/LinearQuantizer.hpp; SURVEY.md section
2), and imports nothing of jax, of the sz3_tpu package or of sz3_tpu_torch.
The quantizer, the level bounds and the level count are the 1D/2D
reference's (interp_plain.py), which SZ3 shares between the two APIs.

SZ3's rules, as followed here:

  levels      ``ceil(log2(max dim))``, capped at ``log2(stride) + 1`` and less
              the top one where an anchor stride is in force (some dimension
              exceeds it); the anchor grid (every point whose coordinates are
              all multiples of the stride) is saved losslessly, each anchor a
              bin 0 and an unpredictable value, in row-major order; without
              anchors the first point is quantized against 0 at the base
              bound (:183-222).
  level bound ``eb * 0.5`` from level 3 up where alpha < 0, ``eb / min(alpha
              ** (level - 1), beta)`` where alpha >= 1, else eb (:101-116).
  blocks      level l has stride s = 2^(l-1) and blocks of 32 s, visited
              row-major; a block spans [begin, min(begin + 32 s, dim - 1)]
              along each axis (:117-135).
  a block     with ``dm`` the ``interpDirection``-th of the N! permutations
              of the axes in lexicographic order (``dim_sequences``,
              :205-212): N passes, the i-th along axis dm[i], over the lines
              whose coordinates are multiples of s along dm[0..i-1] and of 2s
              along dm[i+1..]; along a non-pass axis a line at the block's
              first coordinate other than 0 belongs to the block before (the
              SIGMOD'24 fastest-dim-first API, :309-402, and its per-block
              dispatch, :404-454).
  a pass      over the block's lines of n points along its axis (j = 0 ..
              n - 1 at stride s) predicts the odd j in phases, each phase
              over every line of the block in row-major order of the points
              (:334-399). Linear: the odd j < n - 1 by ``(a + b) / 2``; then,
              for even n, j = n - 1 by a copy of j - 1 (n < 3) or by
              ``-0.5 a + 1.5 b`` of j - 2 and j - 1 (in double, then rounded
              to the field's type; j - 2 is a point of the first phase).
              Cubic: the odd 3 <= j < n - 3 by ``(-a + 9b + 9c - d) / 16``;
              then one phase each for j = 1, j = n - 2 (odd n > 3), j = n - 3
              (even n > 4) and j = n - 1 (even n > 2), in that order, each by
              the cubic where j + 3 < n, else ``interp_quad_2`` ``(-a + 6b +
              3c) / 8`` where j + 1 < n, else ``-0.5 a + 1.5 b`` of j - 3 and
              j - 1 when j >= 3, and by ``interp_quad_1`` ``(3a + 6b - c) /
              8``, the linear or the copy of j - 1 in the same three cases
              when j < 3 (Interpolators.hpp:12-39). Each in the field's type,
              one operation at a time, in the order the source writes it.
  quantizer   LinearQuantizer (LinearQuantizer.hpp:43-71): interp_plain.quantize.
              Each point is predicted from reconstructed values, as the
              decoder will see them.

Departures from SZ3's loop order, none of which changes a value:

  - Each (level, pass, phase) is one vectorised step over the phase's points
    of every block at once, where SZ3 walks block by block and, inside a
    block, pass by pass. A point a pass reads lies on the same line and at
    an even j, so an earlier pass or level of this block, or of a block
    before it in row-major order, finished it; the one read of an odd j,
    linear's last point of an even line, reads the first phase of the same
    line, which runs before it here as in SZ3. No point reads a point that a
    later pass of an earlier block writes: along the later axes its line
    lies at multiples of 2s, where those passes predict odd multiples of s.
  - Inside a phase the points are taken predictor by predictor. Each point's
    value depends only on points of earlier phases, so the order moves no
    value; it moves only the order in which unpredictable values are
    saved, and ``Encoded.order`` restores SZ3's order (level, then block,
    then pass, then phase, then the points' row-major order).
  - The fields are finite: SZ3's ``int64`` cast of a NaN or of a quotient
    past 2^63 is left undefined by C++, and is not reproduced.
"""

from __future__ import annotations

import itertools
import math
from typing import List, Tuple

import torch

from .interp_plain import (BLOCKSIZE, Encoded, level_eb, levels_and_anchor, quantize,
                           settings)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["Encoded", "encode", "settings", "axis_phases", "permutation"]

# the predictors of a pass (utils/Interpolators.hpp): each reads the
# reconstruction at offsets, in units of s along the pass's axis, of the point
LINEAR, COPY, LIN1_2, CUBIC, QUAD1, QUAD2, LIN1_3 = range(7)


def permutation(ndim: int, direction: int) -> Tuple[int, ...]:
    """The axes in the order of ``dim_sequences[direction]``: the N!
    permutations in lexicographic order, as std::next_permutation lists
    them from the identity."""
    return list(itertools.permutations(range(ndim)))[direction]


def line_phases(n: int, cubic: bool) -> List[Tuple[int, int, int]]:
    """[(j, kind, phase)] of one line of n points along a pass."""
    if n <= 1:
        return []
    if not cubic:
        out = [(j, LINEAR, 0) for j in range(1, n - 1, 2)]
        if n % 2 == 0:
            out.append((n - 1, COPY if n < 3 else LIN1_2, 1))
        return out
    out = [(j, CUBIC, 0) for j in range(3, n - 3 if n >= 3 else 0, 2)]
    bounds = [1]
    if n % 2 == 1 and n > 3:
        bounds.append(n - 2)
    if n % 2 == 0 and n > 4:
        bounds.append(n - 3)
    if n % 2 == 0 and n > 2:
        bounds.append(n - 1)
    for phase, b in enumerate(bounds, 1):
        if b >= 3:
            kind = CUBIC if b + 3 < n else QUAD2 if b + 1 < n else LIN1_3
        else:
            kind = QUAD1 if b + 3 < n else LINEAR if b + 1 < n else COPY
        out.append((b, kind, phase))
    return out


def axis_phases(dim: int, s: int, cubic: bool):
    """The points a pass predicts along an axis of `dim` at stride s, block
    by block of 32 s: (coordinates, kinds, phases, block index along the
    axis), lists of equal length."""
    ibs = BLOCKSIZE * s
    pos, kind, phase, block = [], [], [], []
    for b, begin in enumerate(range(0, dim, ibs)):
        end = min(begin + ibs, dim - 1)
        for j, k, p in line_phases((end - begin) // s + 1, cubic):
            pos.append(begin + j * s)
            kind.append(k)
            phase.append(p)
            block.append(b)
    return pos, kind, phase, block


def _linear1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (-0.5 * a.double() + 1.5 * b.double()).to(b.dtype)


def _predict(kind: int, at) -> torch.Tensor:
    """The prediction of `kind` from the reconstruction `at(offset)`, in the
    field's type."""
    if kind == LINEAR:
        return (at(-1) + at(1)) / 2
    if kind == COPY:
        return at(-1)
    if kind == LIN1_2:
        return _linear1(at(-2), at(-1))
    if kind == CUBIC:
        return (-at(-3) + 9 * at(-1) + 9 * at(1) - at(3)) / 16
    if kind == QUAD1:
        return (3 * at(-1) + 6 * at(1) - at(3)) / 8
    if kind == QUAD2:
        return (-at(-3) + 6 * at(-1) + 3 * at(1)) / 8
    return _linear1(at(-3), at(-1))


def _coords(dim: int, step: int, dev) -> torch.Tensor:
    return torch.arange(0, dim, step, dtype=torch.int64, device=dev)


def encode(x: torch.Tensor, eb: float, *, interp_algo: int = 1, direction: int = 0,
           alpha: float = -1.0, beta: float = -1.0, anchor_stride: int = 0,
           quantbin_cnt: int = 65536) -> Encoded:
    """SZ3's interpolation decomposition of the 3D or 4D field `x` (any float
    dtype, any device) at absolute bound `eb`."""
    if x.dim() not in (3, 4):
        raise ValueError(f"a {x.dim()}D field: this reference takes SZ3's 3D/4D traversal")
    dims = tuple(x.shape)
    N, dev = len(dims), x.device
    radius = quantbin_cnt // 2
    cubic = interp_algo == 1
    levels, anchor = levels_and_anchor(dims, anchor_stride)
    dm = permutation(N, direction)
    gstride = [math.prod(dims[a + 1:]) for a in range(N)]
    recon = x.clone()
    bins = torch.zeros(dims, dtype=torch.int32, device=dev)
    if anchor:
        first = sum(_coords(d, anchor, dev).view([-1 if b == a else 1 for b in range(N)])
                    * gstride[a] for a, d in enumerate(dims)).reshape(-1)
    else:
        first = torch.zeros(1, dtype=torch.int64, device=dev)
        b, r = quantize(x.reshape(-1)[:1], torch.zeros(1, dtype=x.dtype, device=dev), eb,
                        radius)
        bins.view(-1)[:1], recon.view(-1)[:1] = b, r
    order = [first]
    for level in range(levels, 0, -1):
        s = 1 << (level - 1)
        ibs = BLOCKSIZE * s
        cur_eb = level_eb(eb, level, alpha, beta)
        nblocks = [(d - 1) // ibs + 1 for d in dims]
        bstride = [math.prod(nblocks[a + 1:]) for a in range(N)]
        keys, where = [], []
        for i, dd in enumerate(dm):
            steps = [s if a in dm[:i] else 2 * s for a in range(N)]
            steps[dd] = 1
            # a view of the pass's lines at full resolution along dd: what is
            # written into it lands in recon and bins
            sl = tuple(slice(0, None, st) for st in steps)
            rv, xv, bv = recon[sl], x[sl], bins[sl]
            pos, kind, phase, blk = (torch.tensor(v, dtype=torch.int64, device=dev)
                                     for v in axis_phases(dims[dd], s, cubic))
            if pos.numel() == 0:
                continue
            for p in phase.unique().tolist():
                got = []
                for k in kind[phase == p].unique().tolist():
                    pk = pos[(phase == p) & (kind == k)]
                    pred = _predict(k, lambda o: rv.index_select(dd, pk + o * s))
                    got.append((pk, *quantize(xv.index_select(dd, pk), pred, cur_eb, radius)))
                # written back once every point of the phase has read
                for pk, b, r in got:
                    ix = (slice(None),) * dd + (pk,)
                    rv[ix], bv[ix] = r, b
            # SZ3's visiting order: row-major block, pass, phase, row-major point
            block_id = torch.zeros((), dtype=torch.int64, device=dev)
            flat = torch.zeros((), dtype=torch.int64, device=dev)
            for a in range(N):
                shape = [-1 if b == a else 1 for b in range(N)]
                if a == dd:
                    c, ba = pos, blk
                else:
                    c = _coords(dims[a], steps[a], dev)
                    ba = torch.clamp(c - 1, min=0) // ibs
                block_id = block_id + (ba * bstride[a]).view(shape)
                flat = flat + (c * gstride[a]).view(shape)
            ph = phase.view([-1 if b == dd else 1 for b in range(N)])
            key = ((block_id * N + i) * 8 + ph) * x.numel() + flat
            keys.append(key.reshape(-1))
            where.append(flat.expand(key.shape).reshape(-1))
            del key, flat, block_id
        if keys:
            key, at = torch.cat(keys), torch.cat(where)
            del keys, where
            order.append(at[torch.argsort(key)])
            del key, at
    order = torch.cat(order)
    fx = x.reshape(-1)[order]
    return Encoded(bins, fx[bins.reshape(-1)[order] == 0], recon, order)
