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

The encode takes one of two routes, chosen by the input alone
(:func:`encode_route`): on a CUDA card, float32 and float64 grids take
csrc/interp_encode.cu, one launch a pass that predicts, quantizes and
places every point of the pass in place on a working copy of the grid
(:func:`pass_geometry` describes a pass to it); every other input takes
:func:`encode_grid_plain`, the passes above as eager ops. Both give the same
bits.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from dataclasses import dataclass
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..build import kernels
from .interp_plan import (K_CUBIC, K_LIN1_NEW, K_LIN1_OLD, K_LINEAR, K_QUAD1, K_QUAD2, K_QUAD3,
                          direction_table, level_eb)
from .quantize import quantize, recover
from .stream_order import cache_device


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

    def __post_init__(self):
        # derived once a plan, and not fields, so that a plan stays the JAX
        # package's field for field: each pass's kinds, and the key of its
        # device constants (_consts)
        object.__setattr__(self, "present", tuple(frozenset(np.unique(spec.kind).tolist())
                                                  for spec in self.passes))
        object.__setattr__(self, "consts_key", tuple(
            (spec.kind.shape, np.ascontiguousarray(spec.kind, np.int32).tobytes(),
             np.asarray(spec.eb, np.float64).tobytes() if isinstance(spec.eb, tuple) else None)
            for spec in self.passes))


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


def stack_plans(plans) -> FastPlan:
    """Plans of one pass structure (the tuner's trials of one stage, which
    differ in their kinds or in their level bounds) as one plan over a
    leading trial axis: each pass's kinds stacked (T, P), its bound a float
    where the trials share it and else a tuple of T, its stage 2 where any
    trial has one (a trial without it never matches K_LIN1_NEW)."""
    p0 = plans[0]

    def shape_of(p):
        return (p.dims, p.anchor_stride, p.base_eb, p.radius, p.init_steps,
                [(s.level, s.dd, s.src_steps, s.out_steps, s.cur_start, s.cur_steps, s.shape_in,
                  s.shape_out, s.p) for s in p.passes])

    if any(shape_of(p) != shape_of(p0) for p in plans):
        raise ValueError("stacked plans must share their pass structure")
    passes = []
    for k, spec in enumerate(p0.passes):
        ebs = tuple(p.passes[k].eb for p in plans)
        passes.append(dataclasses.replace(
            spec, kind=np.stack([p.passes[k].kind for p in plans]),
            eb=ebs[0] if len(set(ebs)) == 1 else ebs,
            has_stage2=any(p.passes[k].has_stage2 for p in plans)))
    return dataclasses.replace(p0, passes=tuple(passes))


# ---- one pass -----------------------------------------------------------------

def _shifts(coarse: torch.Tensor, spec: FastPass, lead: int = 0):
    """A[j-2..j+2] for the odd positions j = 0..P-1, with the coarse array
    edge-padded by 2 along the pass axis. `lead` leading axes (a batch of
    grids) come before the grid's own."""
    dd = spec.dd + lead
    first = coarse.narrow(dd, 0, 1)
    last = coarse.narrow(dd, coarse.shape[dd] - 1, 1)
    apad = torch.cat([first, first, coarse, last, last], dim=dd)
    return [apad.narrow(dd, 2 + d, spec.p) for d in (-2, -1, 0, 1, 2)]


@lru_cache(maxsize=16)
def _consts_on(key, device: torch.device):
    if not key:
        return []
    kinds = np.concatenate([np.frombuffer(k, np.int32) for _, k, _ in key])
    kinds = torch.split(torch.from_numpy(kinds).to(device), [len(k) // 4 for _, k, _ in key])
    ebs = [np.frombuffer(e, np.float64) for _, _, e in key if e is not None]
    ebs = iter(torch.split(torch.from_numpy(np.concatenate(ebs)).to(device),
                           [e.size for e in ebs]) if ebs else ())
    return [(k.reshape(shape), None if e is None else next(ebs))
            for k, (shape, _, e) in zip(kinds, key)]


def _consts(plan: FastPlan, device):
    """Every pass's (kind vector, bounds) on `device`, the bounds None but
    in a stacked plan's passes whose trials bound them apart; one copy each
    and cached by the plan's content: a copy from pageable memory waits for
    the device, so one a pass would hold the host back at every pass."""
    return _consts_on(plan.consts_key, cache_device(device))


def _kindvec(kind: torch.Tensor, spec: FastPass, ndim: int, lead: int = 0) -> torch.Tensor:
    """The kind vector shaped to broadcast along the pass axis; a stacked
    plan's (T, P) kinds also along the trial axis, the first."""
    shape = [1] * ndim
    shape[spec.dd + lead] = -1
    if kind.dim() == 2:
        shape[0] = kind.shape[0]
    return kind.reshape(shape)


def _pass_eb(spec: FastPass, ebs, ndim: int):
    """The pass's bound: a float, or a stacked plan's bounds, one a trial,
    shaped to broadcast along the trial axis."""
    return spec.eb if ebs is None else ebs.reshape((-1,) + (1,) * (ndim - 1))


def _linear1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(-0.5*a + 1.5*b) in f64, narrowed to a's type (Interpolators.hpp linear1)."""
    return (-0.5 * a.to(torch.float64) + 1.5 * b.to(torch.float64)).to(a.dtype)


def _predict_kinds(present, kind, m2, m1, z0, p1, p2):
    """The basis functions of the kinds `present` in this pass, from the
    five shifts, then the per-position kind select; op order as in
    Interpolators.hpp:12-39. A kind the pass lacks is neither computed nor
    selected (each op is a launch on the device)."""
    basis = {K_LIN1_OLD: lambda: _linear1(m1, z0),
             K_LINEAR: lambda: (z0 + p1) / 2,
             K_QUAD3: lambda: (3 * m2 - 10 * m1 + 15 * z0) / 8,
             K_QUAD2: lambda: (-m1 + 6 * z0 + 3 * p1) / 8,
             K_QUAD1: lambda: (3 * z0 + 6 * p1 - p2) / 8,
             K_CUBIC: lambda: (-m1 + 9 * z0 + 9 * p1 - p2) / 16}
    pred = z0  # K_COPY; K_LIN1_NEW is fixed up in stage 2
    for k, v in basis.items():
        if k in present:
            pred = v() if present == {k} else torch.where(kind == k, v(), pred)
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


def _stage2_fix(spec: FastPass, kind, a, pred, recon_s1, lead: int = 0):
    """Linear-mode block tails read the reconstruction of the previous odd
    point of the same pass: pred = f32(-0.5*recon[j-1] + 1.5*A[j])
    (InterpolationDecomposition.hpp:341-350)."""
    dd = spec.dd + lead
    prev = torch.cat([recon_s1.narrow(dd, 0, 1), recon_s1], dim=dd).narrow(dd, 0, spec.p)
    return torch.where(kind == K_LIN1_NEW, _linear1(prev, a), pred)


def encode_pass_fast(cur: torch.Tensor, coarse: torch.Tensor, spec: FastPass, radius: int,
                     kind: torch.Tensor, present, eb, lead: int = 0):
    """cur: original values at this pass's predicted (odd) positions; kind:
    the pass's kind vector on the device and `present` its kinds (_consts,
    FastPlan.present); eb: the pass's bound (_pass_eb). Returns (the
    next-resolution array, this pass's bins)."""
    m2, m1, z0, p1, p2 = _shifts(coarse, spec, lead)
    kind = _kindvec(kind, spec, coarse.ndim, lead)
    pred = _predict_kinds(present, kind, m2, m1, z0, p1, p2)
    bins, recon = quantize(cur, pred, eb, radius)
    if spec.has_stage2:
        pred2 = _stage2_fix(spec, kind, z0, pred, recon, lead)
        bins2, recon2 = quantize(cur, pred2, eb, radius)
        m = kind == K_LIN1_NEW
        bins = torch.where(m, bins2, bins)
        recon = torch.where(m, recon2, recon)
    return _interleave(coarse, recon, spec.dd + lead, spec.shape_out[spec.dd]), bins


def decode_pass_fast(coarse: torch.Tensor, bins: torch.Tensor, literal: torch.Tensor,
                     spec: FastPass, radius: int, kind: torch.Tensor, present) -> torch.Tensor:
    m2, m1, z0, p1, p2 = _shifts(coarse, spec)
    kind = _kindvec(kind, spec, coarse.ndim)
    pred = _predict_kinds(present, kind, m2, m1, z0, p1, p2)
    rec = recover(pred, bins, literal, spec.eb, radius)
    if spec.has_stage2:
        pred2 = _stage2_fix(spec, kind, z0, pred, rec)
        rec2 = recover(pred2, bins, literal, spec.eb, radius)
        rec = torch.where(kind == K_LIN1_NEW, rec2, rec)
    return _interleave(coarse, rec, spec.dd, spec.shape_out[spec.dd])


# ---- whole grid ---------------------------------------------------------------

def _decimation_chain(x: torch.Tensor, plan: FastPlan, lead: int = 0):
    """(x on the initial grid, [x at pass k's predicted positions]) as
    strided views of x."""
    fine = [None] * len(plan.passes)
    cur_arr = x
    for k in range(len(plan.passes) - 1, -1, -1):
        fine[k] = cur_arr
        dd = plan.passes[k].dd + lead
        cur_arr = cur_arr[tuple(slice(None, None, 2) if a == dd else slice(None)
                                for a in range(x.ndim))]
    curs = [fine[k][tuple(slice(1, None, 2) if a == spec.dd + lead else slice(None)
                          for a in range(x.ndim))]
            for k, spec in enumerate(plan.passes)]
    return cur_arr, curs


def encode_grid_plain(x: torch.Tensor, plan: FastPlan, lead: int = 0):
    """:func:`encode_grid_fast` as eager ops, on any device: the passes'
    bins as tensors of their own, the first point's bin, the
    reconstruction."""
    coarse, curs = _decimation_chain(x, plan, lead)
    bins_out = []
    b0 = None
    if plan.anchor_stride == 0:
        i0 = (slice(None),) * lead + (0,) * (x.ndim - lead)
        b0, r0 = quantize(x[i0], torch.zeros((), dtype=x.dtype, device=x.device),
                          plan.base_eb, plan.radius)
        coarse = coarse.clone()  # a view of x
        coarse[i0] = r0
    for spec, cur, present, (kind, ebs) in zip(plan.passes, curs, plan.present,
                                               _consts(plan, x.device)):
        coarse, b = encode_pass_fast(cur, coarse, spec, plan.radius, kind, present,
                                     _pass_eb(spec, ebs, x.ndim), lead)
        bins_out.append(b)
    return bins_out, b0, coarse


def encode_route(x: torch.Tensor) -> str:
    """The route :func:`encode_grid_fast` takes for `x`: "kernel" for a
    float32 or float64 tensor on a CUDA card, "plain" otherwise."""
    return "kernel" if x.is_cuda and x.dtype in (torch.float32, torch.float64) else "plain"


def pass_launches(plan: FastPlan, x: torch.Tensor) -> int:
    """The kernel launches :func:`encode_grid_fast` makes for `x` under
    `plan`: one a pass, and one for the first point of a plan without
    anchors, on the kernel route; none on the plain route."""
    if encode_route(x) == "plain":
        return 0
    return len(plan.passes) + (plan.anchor_stride == 0)


def encode_grid_fast(x: torch.Tensor, plan: FastPlan, lead: int = 0,
                     grid: Optional[torch.Tensor] = None):
    """Original grid -> (per-pass bins, first-point bin or None, reconstruction).
    With `lead`, x is a batch of grids on its first `lead` axes, each encoded
    on its own (the tuner's trial blocks), and b0 holds one bin a grid. A
    stacked plan (stack_plans) encodes trial t's grids along x's first axis,
    which has one entry a trial.

    `grid`, if given, is the bins grid to fill: int32 zeros shaped like x
    (anchors keep bin 0). On the kernel route (:func:`encode_route`) each
    pass writes its bins there directly (a grid of zeros is made when none
    is given), and the per-pass bins and b0 returned are strided views of
    it; on the plain route the passes' bins are placed there as
    :func:`bins_to_grid` places them. ``encode_grid_fast.launches`` counts
    the kernel's launches."""
    if encode_route(x) == "plain":
        bins_out, b0, rec = encode_grid_plain(x, plan, lead)
        if grid is not None:
            _place(grid, bins_out, plan, b0, lead)
        return bins_out, b0, rec
    return _encode_grid_kernel(x, plan, lead, grid)


encode_grid_fast.launches = 0
_ENCODE = encode_grid_fast      # the counter's owner, also while a caller wraps the module's name


def pass_geometry(spec: FastPass, dims: Tuple[int, ...]) -> Tuple[int, ...]:
    """The pass as csrc/interp_encode.cu walks it over a row-major grid of
    `dims`: (n0..n3, e0..e3, base, dd, cstep, C). The predicted points form
    an n0 x n1 x n2 x n3 box (ranks below 4 padded with leading axes of
    count 1 and stride 0) whose point (i0..i3) sits at element offset
    base + sum(i_a * e_a); dd is the pass axis in those four, and the
    coarse point A[i] of the point's line at the line's offset (its offset
    less base + i_dd * e_dd) plus i * cstep, with i clamped to [0, C-1]."""
    N = len(dims)
    gs = [1] * N
    for a in range(N - 2, -1, -1):
        gs[a] = gs[a + 1] * dims[a + 1]
    dd = spec.dd
    n = [spec.p if a == dd else spec.shape_in[a] for a in range(N)]
    e = [spec.cur_steps[a] * gs[a] for a in range(N)]
    pad = 4 - N
    return (*([1] * pad + n), *([0] * pad + e), spec.cur_start[dd] * gs[dd], dd + pad,
            spec.src_steps[dd] * gs[dd], spec.shape_in[dd])


def _geometry(plan: FastPlan) -> np.ndarray:
    """(passes, 12) int64, each pass's :func:`pass_geometry`, made once a
    plan, with the points the passes predict (:func:`pass_points`)."""
    geo = plan.__dict__.get("_geometry")
    if geo is None:
        geo = np.array([pass_geometry(spec, plan.dims) for spec in plan.passes],
                       np.int64).reshape(-1, 12)
        object.__setattr__(plan, "_geometry", geo)
        object.__setattr__(plan, "_predicted", int(geo[:, :4].prod(axis=1).sum()))
    return geo


def pass_points(plan: FastPlan) -> int:
    """The points the plan's passes predict, one grid: the sum of n0 n1 n2
    n3 over its :func:`pass_geometry` rows (a host number, cached with them)."""
    _geometry(plan)
    return plan._predicted


def pass_rows(plan: FastPlan, device, trials: int, lead: int):
    """The pass table csrc/interp_encode.cu takes: (passes, 15) int64 rows,
    each pass's :func:`pass_geometry`, then the address of its kinds on
    `device` (_consts), their stride from trial to trial (P in a stacked
    plan, else 0) and the address of its per-trial bounds (0 where the
    trials share one); and (passes,) float64, each pass's shared bound (0
    where it has per-trial bounds). The geometry is made once a plan."""
    rows = np.zeros((len(plan.passes), 15), np.int64)
    rows[:, :12] = _geometry(plan)
    ebs = np.zeros(len(plan.passes), np.float64)
    for k, (spec, (kind, teb)) in enumerate(zip(plan.passes, _consts(plan, device))):
        if kind.dim() == 2 and (lead == 0 or kind.shape[0] != trials):
            raise ValueError(f"a plan stacked over {kind.shape[0]} trials for {trials} trials")
        rows[k, 12:] = (kind.data_ptr(), kind.shape[1] if kind.dim() == 2 else 0,
                        0 if teb is None else teb.data_ptr())
        ebs[k] = 0.0 if teb is not None else spec.eb
    return rows, ebs


def _encode_grid_kernel(x: torch.Tensor, plan: FastPlan, lead: int,
                        grid: Optional[torch.Tensor]):
    """The kernel route of :func:`encode_grid_fast`: a working copy of x
    (the lead axes materialised), then one launch of csrc/interp_encode.cu
    a pass, all from one C call."""
    N = len(plan.dims)
    batch = tuple(x.shape[:lead])
    if tuple(x.shape[lead:]) != plan.dims:
        raise ValueError(f"grid of shape {tuple(x.shape[lead:])} for a plan of {plan.dims}")
    T = batch[0] if lead else 1
    K = int(np.prod(batch[1:], dtype=np.int64)) if lead > 1 else 1
    xv = x.reshape((T, K) + plan.dims)
    if not xv[0, 0].is_contiguous():    # each grid of x is read in w's layout
        xv = xv.contiguous()
    work = torch.empty((T, K) + plan.dims, dtype=x.dtype, device=x.device)
    work.copy_(xv)
    if grid is None:
        grid = torch.zeros(batch + plan.dims, dtype=torch.int32, device=x.device)
    elif (grid.dtype != torch.int32 or tuple(grid.shape) != batch + plan.dims
          or not grid.is_contiguous() or grid.device != x.device):
        raise ValueError(f"bins grid of {grid.dtype} {tuple(grid.shape)} on {grid.device}: "
                         f"want contiguous int32 zeros {batch + plan.dims} on {x.device}")
    rows, ebs = pass_rows(plan, x.device, T, lead)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = kernels().szt_interp_encode(
        xv.data_ptr(), work.data_ptr(), grid.data_ptr(), int(x.dtype == torch.float64), T, K,
        xv.stride(0), xv.stride(1), int(np.prod(plan.dims, dtype=np.int64)), plan.radius,
        int(plan.anchor_stride != 0), float(plan.base_eb), rows.ctypes.data, ebs.ctypes.data,
        len(plan.passes), stream)
    if rc != 0:
        raise RuntimeError(f"szt_interp_encode: CUDA error {rc}")
    _ENCODE.launches += pass_launches(plan, x)
    lead_ix = (slice(None),) * lead
    b0 = grid[lead_ix + (0,) * N] if plan.anchor_stride == 0 else None
    return grid_to_pass_slices(grid, plan, lead), b0, work.reshape(batch + plan.dims)


def decode_grid_fast(bins_list, literal_list, plan: FastPlan, lit0: torch.Tensor,
                     b0, dtype: torch.dtype) -> torch.Tensor:
    """Per-pass bins and literal slices -> reconstruction grid. lit0 is the
    literal grid on the initial grid (anchors are literals)."""
    coarse = lit0.to(dtype, copy=True)
    if plan.anchor_stride == 0:
        i0 = (0,) * coarse.ndim
        coarse[i0] = recover(torch.zeros((), dtype=dtype, device=coarse.device), b0,
                             lit0[i0], plan.base_eb, plan.radius)
    for spec, b, lit, present, (kind, _) in zip(plan.passes, bins_list, literal_list,
                                                plan.present, _consts(plan, coarse.device)):
        coarse = decode_pass_fast(coarse, b, lit, spec, plan.radius, kind, present)
    return coarse


# ---- grid assembly on the device -----------------------------------------------

def _pass_index(spec: FastPass):
    return tuple(slice(spec.cur_start[a], None, spec.cur_steps[a])
                 for a in range(len(spec.cur_start)))


def _place(grid: torch.Tensor, bins_list, plan: FastPlan, b0, lead: int = 0) -> None:
    """Per-pass bins into the bins grid, by strided slice assignment."""
    ix = (slice(None),) * lead
    if plan.anchor_stride == 0:
        grid[ix + (0,) * len(plan.dims)] = b0
    for spec, b in zip(plan.passes, bins_list):
        grid[ix + _pass_index(spec)] = b


def bins_to_grid(bins_list, plan: FastPlan, b0, device, batch: Tuple[int, ...] = ()
                 ) -> torch.Tensor:
    """Per-pass bins -> the bins grid (anchors at bin 0), by strided slice
    assignment; with `batch`, the leading shape of a batch of grids."""
    grid = torch.zeros(tuple(batch) + plan.dims, dtype=torch.int32, device=device)
    _place(grid, bins_list, plan, b0, len(batch))
    return grid


def grid_to_pass_slices(grid: torch.Tensor, plan: FastPlan, lead: int = 0):
    """Strided views of a bins or literal grid, one per pass; with `lead`,
    of a batch of grids on its first `lead` axes."""
    ix = (slice(None),) * lead
    return [grid[ix + _pass_index(spec)] for spec in plan.passes]


def initial_literal(literal: torch.Tensor, plan: FastPlan) -> torch.Tensor:
    return literal[tuple(slice(0, None, s) for s in plan.init_steps)]


@lru_cache(maxsize=32)
def encode_step(dims, interp_algo, direction, anchor_stride, alpha, beta, eb,
                quantbin_cnt, dtype_name):
    """The single-step INTERP encode (counterpart of _jit_encode): (plan,
    run), run(x) giving the bins of every pass in plan order as one flat
    int32 tensor, and b0, the first point's bin where the plan has no anchor
    grid and 0 otherwise. dtype_name is x's dtype, a part of the cache key."""
    plan = build_fast_plan(dims, interp_algo=interp_algo, direction=direction,
                           anchor_stride=anchor_stride, alpha=alpha, beta=beta, eb=eb,
                           quantbin_cnt=quantbin_cnt)

    def run(x: torch.Tensor):
        bins_list, b0, _ = encode_grid_fast(x, plan)
        # one flat tensor for one device->host transfer
        flat = torch.cat([b.reshape(-1) for b in bins_list]) if bins_list else \
            torch.zeros(0, dtype=torch.int32, device=x.device)
        return flat, (b0 if b0 is not None else
                      torch.zeros((), dtype=torch.int32, device=x.device))

    return plan, run
