"""The guarantee an error-bounded archive gives, checked from the inputs.

SZ3's bound (utils/Statistic.hpp's calAbsErrorBound, the quantizer's test
in LinearQuantizer.hpp) is pointwise: every decoded value d of an input
value x satisfies |d - x| <= eb, the difference taken in the data's type
and compared with eb as a double. eb is worked out here again from the
input and the configuration's bound, never read from an archive:

  ABS          eb = abs
  REL          eb = rel * range, range = max - min in the data's type
  PSNR         eb = range * 10 ** -((psnr + 10 log10(1 - 2/3 * 0.99)) / 20)
  L2NORM       eb = sqrt(3 / n) * l2norm
  ABS_AND_REL  eb = min(abs, rel * range); ABS_OR_REL: the max
"""

from __future__ import annotations

import math

import torch

BLOCK = 1 << 26          # elements compared at a time


def value_range(x: torch.Tensor) -> float:
    """max - min, the subtraction in x's type (no NaN in the benchmark's
    inputs)."""
    flat = x.reshape(-1)
    return float(flat.max() - flat.min())


def abs_bound(x: torch.Tensor, error_bound: dict) -> float:
    """The absolute bound of input `x` under the configuration's
    `error_bound` ({"mode": ..., and "abs", "rel", "psnr" or "l2norm"})."""
    mode = error_bound["mode"]
    if mode not in ("ABS", "REL", "PSNR", "L2NORM", "ABS_AND_REL", "ABS_OR_REL"):
        raise ValueError(f"unknown error-bound mode {mode!r}")
    if mode == "ABS":
        return float(error_bound["abs"])
    if mode == "L2NORM":
        return math.sqrt(3.0 / x.numel()) * float(error_bound["l2norm"])
    rng = value_range(x)
    if mode == "REL":
        return float(error_bound["rel"]) * rng
    if mode == "PSNR":
        v1 = float(error_bound["psnr"]) + 10 * math.log10(1 - 2.0 / 3.0 * 0.99)
        return rng * 10 ** (v1 / -20)
    pair = (float(error_bound["abs"]), float(error_bound["rel"]) * rng)
    return min(pair) if mode == "ABS_AND_REL" else max(pair)


def max_abs_error(x: torch.Tensor, d: torch.Tensor) -> float:
    """max |d - x| over the field, the difference in x's type, compared
    block by block; NaN anywhere reads as infinity."""
    if tuple(d.shape) != tuple(x.shape) or d.dtype != x.dtype:
        raise ValueError(f"decoded {tuple(d.shape)} {d.dtype} for input {tuple(x.shape)} "
                         f"{x.dtype}")
    xf, df = x.reshape(-1), d.reshape(-1)
    worst = 0.0
    for i in range(0, xf.numel(), BLOCK):
        diff = (df[i:i + BLOCK] - xf[i:i + BLOCK]).abs()
        if bool(torch.isnan(diff).any()):
            return math.inf
        worst = max(worst, float(diff.max()))
    return worst
