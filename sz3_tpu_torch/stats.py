"""Error-bound conversions and distortion metrics (counterpart of
sz3_tpu/stats.py).

Mirrors reference utils/Statistic.hpp: `verify` (:80-140) and
`calAbsErrorBound` (:31-56).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .config import Config, EB
from .utils.copies import on_device


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


@dataclass
class Distortion:
    """The distortion report of :func:`verify` (reference Statistic.hpp:80-140)."""
    min: float
    max: float
    value_range: float
    max_abs_err: float
    max_rel_err: float
    max_pw_rel_err: float
    psnr: float
    nrmse: float
    norm_err: float
    norm_err_norm: float
    ac_eff: float

    def report(self) -> str:
        return (
            f"Min={self.min:.20G}, Max={self.max:.20G}, range={self.value_range:.20G}\n"
            f"Max absolute error = {self.max_abs_err:.2G}\n"
            f"Max relative error = {self.max_rel_err:.2G}\n"
            f"Max pw relative error = {self.max_pw_rel_err:.2G}\n"
            f"PSNR = {self.psnr:f}, NRMSE= {self.nrmse:.10G}\n"
            f"normError = {self.norm_err:f}, normErr_norm = {self.norm_err_norm:f}\n"
            f"acEff={self.ac_eff:f}"
        )


def moments(original, decoded, device=None) -> dict:
    """The sums and extremes behind :func:`verify`, in float64 on `device`
    (None: the original's device when it is a tensor, else the CUDA card).
    Computed over slices of ``ops.quantize.SLICE`` elements, so the float64
    temporaries stay near 256 MiB whatever the field's size; min and max
    propagate NaN, as numpy's do. Keys: n, min, max, max_abs, max_pw, sse,
    sum_dd, mean_o, mean_d, prod, var_o, var_d (the last three are means)."""
    from .ops.quantize import SLICE

    ori = on_device(original, device).reshape(-1)
    dev = ori.device
    dec = on_device(decoded, dev).reshape(-1)
    n = ori.numel()
    if dec.numel() != n:
        raise ValueError(f"{n} original values, {dec.numel()} decoded")
    f64 = torch.float64
    zero = torch.zeros((), dtype=f64, device=dev)
    mn = torch.full((), float("inf"), dtype=f64, device=dev)
    mx, max_abs, max_pw = -mn, zero.clone(), zero.clone()
    sse, s_o, s_d, s_dd = zero.clone(), zero.clone(), zero.clone(), zero.clone()
    for a in range(0, n, SLICE):
        o, d = ori[a:a + SLICE].to(f64), dec[a:a + SLICE].to(f64)
        mn, mx = torch.minimum(mn, o.amin()), torch.maximum(mx, o.amax())
        e = d - o
        ae = e.abs()
        max_abs = torch.maximum(max_abs, ae.amax())
        # over the nonzero originals; a 0 elsewhere changes no maximum of
        # values >= 0, and gives 0.0 where no original is nonzero
        max_pw = torch.maximum(max_pw, torch.where(o != 0, ae / o.abs(), zero).amax())
        sse += (e * e).sum()
        s_o += o.sum()
        s_d += d.sum()
        s_dd += (d * d).sum()
    first = torch.stack([mn, mx, max_abs, max_pw, sse, s_d, s_dd, s_o]).tolist()
    m1, m2 = first[7] / n, first[5] / n
    prod, v1, v2 = zero.clone(), zero.clone(), zero.clone()
    for a in range(0, n, SLICE):
        o, d = ori[a:a + SLICE].to(f64) - m1, dec[a:a + SLICE].to(f64) - m2
        prod += (o * d).sum()
        v1 += (o * o).sum()
        v2 += (d * d).sum()
    second = torch.stack([prod, v1, v2]).tolist()
    return {"n": n, "min": first[0], "max": first[1], "max_abs": first[2], "max_pw": first[3],
            "sse": first[4], "sum_dd": first[6], "mean_o": m1, "mean_d": m2,
            "prod": second[0] / n, "var_o": second[1] / n, "var_d": second[2] / n}


def verify(original, decoded, *, device=None) -> Distortion:
    """Full distortion report of `decoded` against `original` (tensors or
    arrays of any shape, as many values), the quantities and corner cases of
    the reference's Statistic.hpp:80-140 as the JAX package computes them
    (PSNR inf where the mse or the range is 0, the pointwise relative error
    over the nonzero originals only). Computed in float64 on `device` (None:
    the original's device when it is a tensor, else the CUDA card, which
    raises without one); see :func:`moments`."""
    m = moments(original, decoded, device)
    mn, mx = m["min"], m["max"]
    rng = mx - mn
    max_abs = m["max_abs"]
    mse = m["sse"] / m["n"]
    psnr = 20 * math.log10(rng) - 10 * math.log10(mse) if mse > 0 and rng > 0 else math.inf
    s1, s2 = math.sqrt(m["var_o"]), math.sqrt(m["var_d"])
    norm_err, l2 = math.sqrt(m["sse"]), math.sqrt(m["sum_dd"])
    return Distortion(
        min=mn, max=mx, value_range=rng,
        max_abs_err=max_abs,
        max_rel_err=max_abs / rng if rng > 0 else 0.0,
        max_pw_rel_err=m["max_pw"],
        psnr=psnr, nrmse=math.sqrt(mse) / rng if rng > 0 else 0.0,
        norm_err=norm_err,
        norm_err_norm=norm_err / l2 if l2 > 0 else 0.0,
        ac_eff=m["prod"] / s1 / s2 if s1 > 0 and s2 > 0 else 0.0,
    )
