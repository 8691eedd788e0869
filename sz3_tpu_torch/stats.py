"""Error-bound conversions (the port's copy of what it needs from
sz3_tpu/stats.py).

Mirrors reference utils/Statistic.hpp: `calAbsErrorBound` (:31-56).
"""

from __future__ import annotations

import math

import numpy as np

from .config import Config, EB


def data_range(data: np.ndarray) -> float:
    """max - min in the data's type, as the host engine and the reference
    compute it (Statistic.hpp:11-20): a loop from the first element that a
    NaN compares false in, so NaN is passed over unless it is the first
    element, and then the range is NaN. (numpy's max and min, which the JAX
    package uses, return NaN for any NaN.)"""
    flat = data.reshape(-1)
    if flat[0] != flat[0]:
        return float("nan")
    return float(np.fmax.reduce(flat) - np.fmin.reduce(flat))


def cal_abs_error_bound(conf: Config, data: np.ndarray, value_range: float = 0.0) -> None:
    """Convert any error-bound mode to ABS in place (Statistic.hpp:31-56)."""
    if conf.errorBoundMode == EB.ABS:
        return
    rng = value_range if value_range > 0 else data_range(data)
    if conf.errorBoundMode == EB.REL:
        conf.absErrorBound = conf.relErrorBound * rng
    elif conf.errorBoundMode == EB.PSNR:
        v1 = conf.psnrErrorBound + 10 * math.log10(1 - 2.0 / 3.0 * 0.99)
        conf.absErrorBound = rng * 10 ** (v1 / -20)
    elif conf.errorBoundMode == EB.L2NORM:
        conf.absErrorBound = math.sqrt(3.0 / conf.num) * conf.l2normErrorBound
    elif conf.errorBoundMode == EB.ABS_AND_REL:
        conf.absErrorBound = min(conf.absErrorBound, conf.relErrorBound * rng)
    elif conf.errorBoundMode == EB.ABS_OR_REL:
        conf.absErrorBound = max(conf.absErrorBound, conf.relErrorBound * rng)
    else:
        raise ValueError("error bound mode not supported")
    conf.errorBoundMode = EB.ABS
