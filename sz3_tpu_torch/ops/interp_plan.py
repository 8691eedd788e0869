"""Static execution plan for the interpolation decomposition on device.

Key structural fact (see ARCHITECTURE.md and the bit-exact host engine in
native/szt/interp.hpp): within one (level, directional pass) every predicted
point depends only on points from coarser levels or earlier passes — never on
other points of the same pass. The reference's per-block traversal
(decomposition/InterpolationDecomposition.hpp:404-454) therefore decomposes
into dense strided-grid stencil ops:

  - along the pass direction, the predicted positions and their predictor
    kind follow a per-block pattern (period blocksize*stride) derived from
    the reference's 1D kernels (:247-293 old API for 1D/2D, :309-402
    fastest-dim-first API for 3D/4D);
  - along every other axis the union of all blocks' ranges is one uniform
    strided grid (stride 2s for not-yet-processed dims, s for processed).

The plan is pure static metadata (numpy arrays / python ints) baked into the
jitted device program. Quant-bin *values* computed from this plan are
bit-identical to the host engine; the archive's stream *order* is restored by
the native emit/place walk.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np

# predictor kinds; neighbor offsets are in units of the level stride s
K_CUBIC = 0    # (-3,-1,+1,+3): (-a+9b+9c-d)/16
K_QUAD1 = 1    # (-1,+1,+3):    (3a+6b-c)/8
K_QUAD2 = 2    # (-3,-1,+1):    (-a+6b+3c)/8
K_QUAD3 = 3    # (-5,-3,-1):    (3a-10b+15c)/8
K_LINEAR = 4   # (-1,+1):       (a+b)/2
K_LIN1_NEW = 5 # (-2,-1):       f32(-0.5a+1.5b)   [f64 math]
K_LIN1_OLD = 6 # (-3,-1):       f32(-0.5a+1.5b)   [f64 math]
K_COPY = 7     # (-1,):         a



def _block_pattern_old(n: int, cubic: bool) -> List[Tuple[int, int]]:
    """(local_index, kind) for one block line, ICDE'21 API
    (reference InterpolationDecomposition.hpp:247-293)."""
    out = []
    if n <= 1:
        return out
    if not cubic or n < 5:
        for i in range(1, n - 1, 2):
            out.append((i, K_LINEAR))
        if n % 2 == 0:
            out.append((n - 1, K_COPY if n < 4 else K_LIN1_OLD))
    else:
        i = 3
        while i + 3 < n:
            out.append((i, K_CUBIC))
            i += 2
        out.append((1, K_QUAD1))
        out.append((i, K_QUAD2))
        if n % 2 == 0:
            out.append((n - 1, K_QUAD3))
    return out


def _block_pattern_new(n: int, cubic: bool) -> List[Tuple[int, int]]:
    """(local_index, kind) for one block line, SIGMOD'24 API
    (reference InterpolationDecomposition.hpp:334-399)."""
    out = []
    if n <= 1:
        return out
    if not cubic:
        for i in range(1, n - 1, 2):
            out.append((i, K_LINEAR))
        if n % 2 == 0:
            out.append((n - 1, K_COPY if n < 3 else K_LIN1_NEW))
        return out
    for i in range(3, max(n - 3, 0), 2):
        out.append((i, K_CUBIC))
    bounds = [1]
    if n % 2 == 1 and n > 3:
        bounds.append(n - 2)
    if n % 2 == 0 and n > 4:
        bounds.append(n - 3)
    if n % 2 == 0 and n > 2:
        bounds.append(n - 1)
    for b in bounds:
        if b >= 3:
            if b + 3 < n:
                out.append((b, K_CUBIC))
            elif b + 1 < n:
                out.append((b, K_QUAD2))
            else:
                out.append((b, K_LIN1_OLD))
        else:
            if b + 3 < n:
                out.append((b, K_QUAD1))
            elif b + 1 < n:
                out.append((b, K_LINEAR))
            else:
                out.append((b, K_COPY))
    return out


def direction_table(D: int, s: int, ibs: int, cubic: bool, old_api: bool):
    """Predicted positions along one axis for one (level, pass).

    Returns (pos[P], kind[P], nbs[P,4]) as absolute element indices; unused
    neighbor slots are filled with pos (always in-bounds by construction).
    """
    pos, kind = [], []
    b = 0
    while b <= D - 1:
        e = min(b + ibs, D - 1)
        n = (e - b) // s + 1
        pat = _block_pattern_old(n, cubic) if old_api else _block_pattern_new(n, cubic)
        for i, k in pat:
            pos.append(b + i * s)
            kind.append(k)
        b += ibs
    pos = np.asarray(pos, dtype=np.int32)
    kind = np.asarray(kind, dtype=np.int32)
    return pos, kind, None  # third slot kept for signature stability


def level_eb(base_eb: float, level: int, alpha: float, beta: float) -> float:
    """Per-level error bound schedule (reference :100-116)."""
    if alpha < 0:
        return base_eb * 0.5 if level >= 3 else base_eb
    if alpha >= 1:
        ratio = min(alpha ** (level - 1), beta)
        return base_eb / ratio
    return base_eb
