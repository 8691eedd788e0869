"""Interpolation decomposition as dense strided passes on torch tensors
(counterpart of sz3_tpu/ops/interp_fast.py).

Per (level, pass) every predicted point sits at an odd multiple of the level
stride along the pass direction and reads its stencil at indices j-2..j+2 of
the coarse array. A pass is five shifted slices, every basis function, a
per-position kind select, one vectorized quantize or recover, and an
interleave with the coarse array. The plan (FastPass, FastPlan,
build_fast_plan) is numpy metadata, field for field the JAX package's.

Bit parity with the host engine (native/szt/interp.hpp) rests on each
arithmetic step being its own eager op in the reference's order
(utils/Interpolators.hpp:12-39), in the data's own precision; Python scalars
do not promote a float32 tensor.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from sz3_tpu.ops.interp_plan import (K_CUBIC, K_LIN1_NEW, K_LIN1_OLD, K_LINEAR, K_QUAD1,
                                     K_QUAD2, K_QUAD3, direction_table, level_eb)

from .quantize import quantize, recover


def _grid_count(D: int, step: int) -> int:
    return (D - 1) // step + 1


@dataclass(frozen=True)
class FastPass:
    level: int
    eb: float                 # resolved level eb
    eb_ratio: float           # base_eb / eb_ratio == eb
    dd: int
    kind: np.ndarray            # per odd position j (len P), predictor kind
    src_steps: Tuple[int, ...]  # element strides of the coarse array per axis
    out_steps: Tuple[int, ...]  # element strides after this pass
    cur_start: Tuple[int, ...]  # slice origin in the original grid (s on dd)
    cur_steps: Tuple[int, ...]  # slice strides in the original grid
    shape_in: Tuple[int, ...]   # coarse array shape
    shape_out: Tuple[int, ...]  # array shape after interleave
    p: int                      # number of predicted positions along dd
    has_stage2: bool            # linear-mode tail reads a same-pass point


@dataclass(frozen=True)
class FastPlan:
    dims: Tuple[int, ...]
    anchor_stride: int
    base_eb: float
    radius: int
    passes: Tuple[FastPass, ...]
    init_steps: Tuple[int, ...]  # strides of the initial coarse grid


def build_fast_plan(dims: Tuple[int, ...], *, interp_algo: int, direction: int,
                    anchor_stride: int, alpha: float, beta: float, eb: float,
                    quantbin_cnt: int, blocksize: int = 32) -> FastPlan:
    N = len(dims)
    cubic = interp_algo == 1
    old_api = N <= 2

    levels = max(int(math.ceil(math.log2(d))) for d in dims)
    use_anchor = any(d > anchor_stride for d in dims)
    astride = anchor_stride if use_anchor else 0
    if astride > 0:
        max_level = int(math.log2(astride)) + 1
        if max_level <= levels:
            levels = max_level
    seq = list(itertools.permutations(range(N)))[direction]

    top = levels - 1 if astride > 0 else levels
    passes: List[FastPass] = []
    # in anchored mode 2^top equals the anchor stride, so the initial coarse
    # grid is exactly the anchor grid
    init_steps = tuple((1 << top) if astride == 0 else astride for _ in dims)

    cur = list(init_steps)
    for level in range(top, 0, -1):
        s = 1 << (level - 1)
        ibs = blocksize * s
        cur_eb = level_eb(eb, level, alpha, beta)
        if alpha < 0:
            eb_ratio = 2.0 if level >= 3 else 1.0
        elif alpha >= 1:
            eb_ratio = min(alpha ** (level - 1), beta)
        else:
            eb_ratio = 1.0
        for dd in seq:
            D = dims[dd]
            g = _grid_count(D, s)
            c = _grid_count(D, 2 * s)
            P = g - c
            if P <= 0:
                continue  # coarse and fine grids coincide along this axis
            pos, kind_pos, _ = direction_table(D, s, ibs, cubic, old_api)
            kind = np.zeros(P, dtype=np.int32)
            for p_abs, k in zip(pos, kind_pos):
                kind[(p_abs // s - 1) // 2] = k
            src_steps = tuple(cur)
            shape_in = tuple(_grid_count(dims[a], cur[a]) for a in range(N))
            cur_start = tuple(s if a == dd else 0 for a in range(N))
            cur_steps = tuple(2 * s if a == dd else cur[a] for a in range(N))
            cur_out = list(cur)
            cur_out[dd] = s
            shape_out = tuple(_grid_count(dims[a], cur_out[a]) for a in range(N))
            has_stage2 = (not old_api) and (not cubic) and bool((kind == K_LIN1_NEW).any())
            passes.append(FastPass(level=level, eb=cur_eb, eb_ratio=eb_ratio, dd=dd, kind=kind,
                                   src_steps=src_steps, out_steps=tuple(cur_out),
                                   cur_start=cur_start, cur_steps=cur_steps,
                                   shape_in=shape_in, shape_out=shape_out, p=P,
                                   has_stage2=has_stage2))
            cur = cur_out
    return FastPlan(dims=tuple(dims), anchor_stride=astride, base_eb=eb,
                    radius=quantbin_cnt // 2, passes=tuple(passes),
                    init_steps=init_steps)


def from_jax_plan(plan) -> FastPlan:
    """The port's FastPlan from the JAX package's (numpy fields and ints)."""
    passes = tuple(FastPass(**{f.name: getattr(sp, f.name)
                               for f in dataclasses.fields(FastPass)})
                   for sp in plan.passes)
    return FastPlan(dims=tuple(plan.dims), anchor_stride=plan.anchor_stride,
                    base_eb=plan.base_eb, radius=plan.radius, passes=passes,
                    init_steps=tuple(plan.init_steps))


# ---- one pass -----------------------------------------------------------------

def _shifts(coarse: torch.Tensor, spec: FastPass):
    """A[j-2..j+2] for the odd positions j = 0..P-1, with the coarse array
    edge-padded by 2 along the pass axis."""
    dd = spec.dd
    first = coarse.narrow(dd, 0, 1)
    last = coarse.narrow(dd, coarse.shape[dd] - 1, 1)
    apad = torch.cat([first, first, coarse, last, last], dim=dd)
    return [apad.narrow(dd, 2 + d, spec.p) for d in (-2, -1, 0, 1, 2)]


def _kindvec(spec: FastPass, ndim: int, device) -> torch.Tensor:
    shape = [1] * ndim
    shape[spec.dd] = -1
    return torch.as_tensor(spec.kind, device=device).reshape(shape)


def _linear1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(-0.5*a + 1.5*b) in f64, narrowed to a's type (Interpolators.hpp linear1)."""
    return (-0.5 * a.to(torch.float64) + 1.5 * b.to(torch.float64)).to(a.dtype)


def _predict_kinds(kind, m2, m1, z0, p1, p2):
    """Every basis function from the five shifts, then the per-position kind
    select; op order as in Interpolators.hpp:12-39."""
    cubic = (-m1 + 9 * z0 + 9 * p1 - p2) / 16
    quad1 = (3 * z0 + 6 * p1 - p2) / 8
    quad2 = (-m1 + 6 * z0 + 3 * p1) / 8
    quad3 = (3 * m2 - 10 * m1 + 15 * z0) / 8
    linear = (z0 + p1) / 2
    lin1_old = _linear1(m1, z0)
    pred = z0  # K_COPY; K_LIN1_NEW is fixed up in stage 2
    for k, v in ((K_LIN1_OLD, lin1_old), (K_LINEAR, linear), (K_QUAD3, quad3),
                 (K_QUAD2, quad2), (K_QUAD1, quad1), (K_CUBIC, cubic)):
        pred = torch.where(kind == k, v, pred)
    return pred


def _interleave(a: torch.Tensor, r: torch.Tensor, dd: int, g_out: int) -> torch.Tensor:
    """[a0, r0, a1, r1, ...][:g_out] along axis dd."""
    c = a.shape[dd]
    p = r.shape[dd]
    if p < c:
        shape = list(r.shape)
        shape[dd] = c - p
        r = torch.cat([r, r.new_zeros(shape)], dim=dd)
    shape = list(a.shape)
    shape[dd] = 2 * c
    z = torch.stack([a, r], dim=dd + 1).reshape(shape)
    return z.narrow(dd, 0, g_out) if 2 * c != g_out else z


def _stage2_fix(spec: FastPass, kind, a, pred, recon_s1):
    """Linear-mode block tails read the reconstruction of the previous odd
    point of the same pass: pred = f32(-0.5*recon[j-1] + 1.5*A[j])
    (InterpolationDecomposition.hpp:341-350)."""
    dd = spec.dd
    prev = torch.cat([recon_s1.narrow(dd, 0, 1), recon_s1], dim=dd).narrow(dd, 0, spec.p)
    return torch.where(kind == K_LIN1_NEW, _linear1(prev, a), pred)


def encode_pass_fast(cur: torch.Tensor, coarse: torch.Tensor, spec: FastPass, radius: int):
    """cur: original values at this pass's predicted (odd) positions.
    Returns (the next-resolution array, this pass's bins)."""
    m2, m1, z0, p1, p2 = _shifts(coarse, spec)
    kind = _kindvec(spec, coarse.ndim, coarse.device)
    pred = _predict_kinds(kind, m2, m1, z0, p1, p2)
    bins, recon = quantize(cur, pred, spec.eb, radius)
    if spec.has_stage2:
        pred2 = _stage2_fix(spec, kind, z0, pred, recon)
        bins2, recon2 = quantize(cur, pred2, spec.eb, radius)
        m = kind == K_LIN1_NEW
        bins = torch.where(m, bins2, bins)
        recon = torch.where(m, recon2, recon)
    return _interleave(coarse, recon, spec.dd, spec.shape_out[spec.dd]), bins


def decode_pass_fast(coarse: torch.Tensor, bins: torch.Tensor, literal: torch.Tensor,
                     spec: FastPass, radius: int) -> torch.Tensor:
    m2, m1, z0, p1, p2 = _shifts(coarse, spec)
    kind = _kindvec(spec, coarse.ndim, coarse.device)
    pred = _predict_kinds(kind, m2, m1, z0, p1, p2)
    rec = recover(pred, bins, literal, spec.eb, radius)
    if spec.has_stage2:
        pred2 = _stage2_fix(spec, kind, z0, pred, rec)
        rec2 = recover(pred2, bins, literal, spec.eb, radius)
        rec = torch.where(kind == K_LIN1_NEW, rec2, rec)
    return _interleave(coarse, rec, spec.dd, spec.shape_out[spec.dd])


# ---- whole grid ---------------------------------------------------------------

def _decimation_chain(x: torch.Tensor, plan: FastPlan):
    """(x on the initial grid, [x at pass k's predicted positions]) as
    strided views of x."""
    fine = [None] * len(plan.passes)
    cur_arr = x
    for k in range(len(plan.passes) - 1, -1, -1):
        fine[k] = cur_arr
        dd = plan.passes[k].dd
        cur_arr = cur_arr[tuple(slice(None, None, 2) if a == dd else slice(None)
                                for a in range(x.ndim))]
    curs = [fine[k][tuple(slice(1, None, 2) if a == spec.dd else slice(None)
                          for a in range(x.ndim))]
            for k, spec in enumerate(plan.passes)]
    return cur_arr, curs


def encode_grid_fast(x: torch.Tensor, plan: FastPlan):
    """Original grid -> (per-pass bins, first-point bin or None, reconstruction)."""
    coarse, curs = _decimation_chain(x, plan)
    bins_out = []
    b0 = None
    if plan.anchor_stride == 0:
        i0 = (0,) * x.ndim
        b0, r0 = quantize(x[i0], torch.zeros((), dtype=x.dtype, device=x.device),
                          plan.base_eb, plan.radius)
        coarse = coarse.clone()  # a view of x
        coarse[i0] = r0
    for spec, cur in zip(plan.passes, curs):
        coarse, b = encode_pass_fast(cur, coarse, spec, plan.radius)
        bins_out.append(b)
    return bins_out, b0, coarse


def decode_grid_fast(bins_list, literal_list, plan: FastPlan, lit0: torch.Tensor,
                     b0, dtype: torch.dtype) -> torch.Tensor:
    """Per-pass bins and literal slices -> reconstruction grid. lit0 is the
    literal grid on the initial grid (anchors are literals)."""
    coarse = lit0.to(dtype, copy=True)
    if plan.anchor_stride == 0:
        i0 = (0,) * coarse.ndim
        coarse[i0] = recover(torch.zeros((), dtype=dtype, device=coarse.device), b0,
                             lit0[i0], plan.base_eb, plan.radius)
    for spec, b, lit in zip(plan.passes, bins_list, literal_list):
        coarse = decode_pass_fast(coarse, b, lit, spec, plan.radius)
    return coarse


# ---- grid assembly on the device -----------------------------------------------

def _pass_index(spec: FastPass):
    return tuple(slice(spec.cur_start[a], None, spec.cur_steps[a])
                 for a in range(len(spec.cur_start)))


def bins_to_grid(bins_list, plan: FastPlan, b0, device) -> torch.Tensor:
    """Per-pass bins -> the bins grid (anchors at bin 0), by strided slice
    assignment."""
    grid = torch.zeros(plan.dims, dtype=torch.int32, device=device)
    if plan.anchor_stride == 0:
        grid[(0,) * len(plan.dims)] = b0
    for spec, b in zip(plan.passes, bins_list):
        grid[_pass_index(spec)] = b
    return grid


def grid_to_pass_slices(grid: torch.Tensor, plan: FastPlan):
    """Strided views of a bins or literal grid, one per pass."""
    return [grid[_pass_index(spec)] for spec in plan.passes]


def initial_literal(literal: torch.Tensor, plan: FastPlan) -> torch.Tensor:
    return literal[tuple(slice(0, None, s) for s in plan.init_steps)]
