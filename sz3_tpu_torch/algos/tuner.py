"""The INTERP_LORENZO tuner with its trial encodes on the device
(counterpart of sz3_tpu/algos/tuner.py; host engine
csrc/engine/szt/pipeline.hpp::tune_interp_lorenzo, after the reference's
SZAlgoInterp.hpp:122-286).

The sampling (profiling and block extraction) is numpy on the host, the
port's own copy of the JAX package's. The trial encodes run on the device:
every sampled block of a stage's trials is one grid of a batch that the
INTERP passes (ops/interp_fast.encode_grid_fast with leading trial and block
axes, over the trials' plans stacked by stack_plans) encode at once, instead
of one scalar compression a trial on one core. Each block's bins go to its
stream order through the trial's permutation, in one gather over all blocks,
and the blocks follow one another, as the engine's trials emit them. The
decision logic stays on the host and is the engine's, decision for
decision: the sealed trial sizes (runtime.interp_seal, format-exact), the
ratio comparisons and the 1.02 thresholds. A different decision would
change the archive's bytes.

Stages keep the engine's trial order (later trials depend on earlier
winners): [linear, cubic] -> [reversed direction] -> [three alpha/beta
pairs]. A stage's trials do not depend on one another, and share their pass
structure (the kinds or the level bounds differ), so each stage is one batch
of passes. 1D fields and non-float fields return False, and the dispatcher
runs the engine's tuner (its Lorenzo trial arm: 1D tuning is cheap and rare).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import runtime
from ..config import ALGO, Config
from ..ops.interp_fast import (build_fast_plan, encode_grid_fast, encode_route, pass_launches,
                               stack_plans)
from ..ops.stream_order import cache_device
from ..stats import cal_abs_error_bound
from ..utils import trace


def _default_anchor_stride(conf: Config) -> None:
    if conf.interpAnchorStride < 0:
        conf.interpAnchorStride = [4096, 128, 32, 16][conf.N - 1]


def _profiling_starts(data: np.ndarray, bs: int, abseb: float,
                      stride: int) -> np.ndarray:
    """Row-major origins of blocks whose sampled range exceeds abseb
    (pipeline.hpp::profiling_block; reference utils/Sample.hpp:8-127).
    Returns (K, N) int64 element origins."""
    dims = data.shape
    N = data.ndim
    for d in dims:
        if d <= bs:
            return np.zeros((0, N), np.int64)
    if stride == 0:
        stride = bs
    axes_o = [np.arange(0, d - bs, bs, dtype=np.int64) for d in dims]
    s = np.arange(0, bs + 1, stride, dtype=np.int64)
    flat = [(o[:, None] + s[None, :]).ravel() for o in axes_o]
    sub = data[np.ix_(*flat)]
    shape = []
    for o in axes_o:
        shape += [o.size, s.size]
    sub = sub.reshape(shape)
    perm = tuple(range(0, 2 * N, 2)) + tuple(range(1, 2 * N, 2))
    sub = np.transpose(sub, perm)
    red = tuple(range(N, 2 * N))
    # replicate the scalar walk's arithmetic exactly (pipeline.hpp
    # profiling_block): the range is a T-typed subtraction promoted to
    # double — `double(mx - mn) > abseb` — NOT an f64-exact difference
    # (1-ulp divergence flips block membership at the threshold); and the
    # comparison chain `v < mn / v > mx` IGNORES NaNs unless the block's
    # ORIGIN value is NaN (then mn/mx stay NaN and the block never
    # profiles). fmax/fmin.reduce give the NaN-ignoring min/max.
    mx = np.fmax.reduce(sub, axis=red)
    mn = np.fmin.reduce(sub, axis=red)
    rng = (mx - mn).astype(np.float64)
    origin_ok = ~np.isnan(sub[(...,) + (0,) * N])
    mask = origin_ok & (rng > abseb)
    idx = np.argwhere(mask)      # row-major — matches the native walk order
    out = np.empty_like(idx)
    for a in range(N):
        out[:, a] = axes_o[a][idx[:, a]]
    return out


def _extract_blocks(data: np.ndarray, origins: np.ndarray,
                    edge: int) -> np.ndarray:
    """(K, N) origins -> (K, edge, .., edge) sample blocks."""
    N = data.ndim
    if origins.shape[0] == 0:
        return np.zeros((0,) + (edge,) * N, data.dtype)
    out = np.empty((origins.shape[0],) + (edge,) * N, data.dtype)
    for k, o in enumerate(origins):
        sl = tuple(slice(int(o[a]), int(o[a]) + edge) for a in range(N))
        out[k] = data[sl]
    return out


def _sample_blocks(data: np.ndarray, sbs: int, rate: float, profiling: bool,
                   starts: np.ndarray) -> np.ndarray:
    """pipeline.hpp::sample_blocks (reference utils/Sample.hpp:129-289)."""
    dims = data.shape
    N = data.ndim
    empty = np.zeros((0,) + (sbs + 1,) * N, data.dtype)
    for d in dims:
        if d < sbs:
            return empty
    if not profiling:
        for d in dims:
            if d <= sbs:
                return empty
    totalblocks = 1
    for d in dims:
        totalblocks *= (d - 1) // sbs
    if profiling:
        stride = int(float(starts.shape[0]) / (float(totalblocks) * rate))
        if stride == 0:
            stride = 1
        return _extract_blocks(data, starts[::stride], sbs + 1)
    # regular grid: origins 0..dims-sbs (exclusive) step sbs, row-major,
    # every `stride`-th taken
    axes_o = [np.arange(0, max(d - sbs, 1), sbs, dtype=np.int64)
              for d in dims]
    grid = np.stack(np.meshgrid(*axes_o, indexing="ij"),
                    axis=-1).reshape(-1, N)
    stride = int(1.0 / rate)
    if stride == 0:
        stride = 1
    return _extract_blocks(data, grid[::stride], sbs + 1)


def _trial_conf(conf: Config, edge: int, algo: int, direction: int,
                alpha: float, beta: float) -> Config:
    t = Config(dims=(edge,) * conf.N, cmprAlgo=ALGO.INTERP,
               absErrorBound=conf.absErrorBound)
    t.interpAlgo = algo
    t.interpDirection = direction
    t.interpAnchorStride = conf.interpAnchorStride
    t.interpAlpha = alpha
    t.interpBeta = beta
    t.quantbinCnt = conf.quantbinCnt
    return t


@lru_cache(maxsize=32)
def _trial_plan(dims, interp_algo: int, direction: int, anchor_stride: int, alpha: float,
                beta: float, eb: float, quantbin_cnt: int):
    return build_fast_plan(dims, interp_algo=interp_algo, direction=direction,
                           anchor_stride=anchor_stride, alpha=alpha, beta=beta, eb=eb,
                           quantbin_cnt=quantbin_cnt)


@lru_cache(maxsize=16)
def _trial_order(dims, interp_algo: int, direction: int, anchor_stride: int,
                 device: torch.device) -> torch.Tensor:
    """A trial block's stream-order permutation (runtime.interp_order) on
    `device`, int64: data-independent, so cached per configuration."""
    c = Config(dims=dims, cmprAlgo=ALGO.INTERP)
    c.interpAlgo = interp_algo
    c.interpDirection = direction
    c.interpAnchorStride = anchor_stride
    return torch.from_numpy(runtime.interp_order(c)).to(device)


def trial_streams(blocks: torch.Tensor, trials):
    """The sampled blocks (K, edge, .., edge) encoded with each trial Config
    of `trials` (one pass structure: one stage's), each block on its own,
    as one batch: a list of (the stream, the literals) a trial, each block's
    in its stream order, block after block (the JAX package's per-block
    perm_emit)."""
    k = blocks.shape[0]
    with trace.span("tune.trials", trials=len(trials), blocks=k,
                    route=encode_route(blocks)) as sp:
        plan = stack_plans([_trial_plan(tuple(t.dims), int(t.interpAlgo), t.interpDirection,
                                        t.interpAnchorStride, t.interpAlpha, t.interpBeta,
                                        t.absErrorBound, t.quantbinCnt) for t in trials])
        sp.set(launches=pass_launches(plan, blocks))
        batch = (len(trials), k)
        grid = torch.zeros(batch + blocks.shape[1:], dtype=torch.int32, device=blocks.device)
        encode_grid_fast(blocks.expand(batch + blocks.shape[1:]), plan, lead=2, grid=grid)
        out = []
        for i, t in enumerate(trials):
            perm = _trial_order(tuple(t.dims), int(t.interpAlgo), t.interpDirection,
                                t.interpAnchorStride, cache_device(blocks.device))
            stream = grid[i].reshape(k, -1).index_select(1, perm).reshape(-1)
            orig = blocks.reshape(k, -1).index_select(1, perm).reshape(-1)
            out.append((stream, orig.index_select(0, torch.nonzero(stream == 0).reshape(-1))))
    return out


def _trial_ratios(blocks: torch.Tensor, conf: Config, edge: int, trials,
                  trial_cap: int):
    """Ratios of one stage's trial configs, each (algo, direction, alpha,
    beta), over the sampled blocks; the seal is the format-exact host path,
    so each ratio equals the engine's trial's."""
    ts = [_trial_conf(conf, edge, *trial) for trial in trials]
    num = float(edge ** conf.N * blocks.shape[0] * blocks.element_size())
    streams = trial_streams(blocks, ts)
    with trace.span("tune.seal", trials=len(ts)):
        return [num / len(runtime.interp_seal(t, stream.cpu().numpy(), unpred.cpu().numpy(),
                                              trial_cap))
                for t, (stream, unpred) in zip(ts, streams)]


def tune(conf: Config, data: np.ndarray, device) -> bool:
    """The tuner with its trials on `device`; rewrites conf like the
    engine's tune_interp_lorenzo. Returns False when outside its profile (1D
    or non-float fields: the caller runs the engine's tuner)."""
    if conf.N == 1 or data.dtype not in (np.float32, np.float64):
        return False
    with trace.span("dispatch.tune") as sp:
        with trace.span("tune.sample"):
            blocks = _sampled_blocks(conf, data, device)
        if blocks is not None:
            trials, ratio = _run_trials(conf, blocks, conf.num * data.dtype.itemsize)
            sp.set(trials=trials, edge=blocks.shape[1], blocks=blocks.shape[0], est_ratio=ratio)
        # N >= 2: the reference runs its lorenzo arm for 1D only
        # (SZAlgoInterp.hpp:227-241) -> use_interp is always true here
        conf.cmprAlgo = ALGO.INTERP
        sp.set(interp_algo=int(conf.interpAlgo), direction=conf.interpDirection,
               alpha=conf.interpAlpha, beta=conf.interpBeta)
    return True


def _sampled_blocks(conf: Config, data: np.ndarray, device):
    """The bound made absolute, and the sampled blocks (K, edge, .., edge)
    uploaded to `device`; None where the field is not tuned."""
    cal_abs_error_bound(conf, data)
    _default_anchor_stride(conf)
    N = conf.N
    data = data.reshape(conf.dims)

    sample_rate = 0.005
    sbs = [4096, 128, 32, 16][N - 1]
    shortest = min(conf.dims)
    while sbs >= shortest:
        sbs //= 2
    while sbs >= 16 and (sbs + 1) ** N / conf.num > 1.5 * sample_rate:
        sbs //= 2
    if sbs < 8:
        sbs = 8

    to_tune = (sbs + 1) ** N <= 0.05 * conf.num and \
        all(d >= sbs for d in conf.dims)
    if not to_tune:
        return None

    starts = _profiling_starts(data, sbs, conf.absErrorBound, sbs // 4)
    per_block = (sbs + 1) ** N
    profiling = float(starts.shape[0] * per_block) >= \
        0.5 * sample_rate * float(conf.num)
    blocks = _sample_blocks(data, sbs, sample_rate, profiling, starts)
    sampling_num = blocks.shape[0] * per_block
    if sampling_num == 0 or sampling_num >= conf.num * 0.2:
        return None
    return torch.from_numpy(blocks).to(device)


def _run_trials(conf: Config, blocks: torch.Tensor, trial_cap: int) -> tuple:
    """The three stages of trials over the sampled blocks, conf rewritten
    with each stage's winner; returns the number of trials and the winning
    trial's sampled ratio."""
    N = conf.N
    edge = blocks.shape[1]
    conf.interpDirection = 0
    conf.interpAlpha = 1.25
    conf.interpBeta = 2.0

    best_interp = 0.0
    ratios = _trial_ratios(blocks, conf, edge, [(op, 0, 1.25, 2.0) for op in (0, 1)],
                           trial_cap)                       # linear, cubic
    for op, ratio in enumerate(ratios):
        if ratio > best_interp:
            best_interp = ratio
            conf.interpAlgo = op
    fact = 1
    for i in range(2, N + 1):
        fact *= i
    ratio, = _trial_ratios(blocks, conf, edge, [(int(conf.interpAlgo), fact - 1, 1.25, 2.0)],
                           trial_cap)
    if ratio > best_interp * 1.02:
        best_interp = ratio
        conf.interpDirection = fact - 1
    pairs = ((1.0, 1.0), (1.5, 2.5), (2.0, 3.0))
    ratios = _trial_ratios(blocks, conf, edge, [(int(conf.interpAlgo), conf.interpDirection, a, b)
                                                for a, b in pairs], trial_cap)
    for (a, b), ratio in zip(pairs, ratios):
        if ratio > best_interp * 1.02:
            best_interp = ratio
            conf.interpAlpha = a
            conf.interpBeta = b
    return 2 + 1 + len(pairs), best_interp
