"""Preprocessors on tensors (counterpart of sz3_tpu/preprocess.py), mirroring
the reference's (vestigial) preprocessor layer (include/SZ3/preprocessor/:
Transpose.hpp, PreFilter.hpp, Wavelet.hpp).

None of these is wired into the archive pipeline in the reference either;
they are user-side data conditioning helpers. Each runs on the device of the
tensor it is given (an array goes to the CUDA card, or to ``device``) and
returns a tensor there. The wavelet is a self-contained Daubechies-4
pyramidal transform in float64 (the reference delegates to GSL).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from .api import on_device


def transpose(data, axes: Sequence[int], *, device=None) -> torch.Tensor:
    """Axis permutation into a fresh contiguous tensor
    (reference Transpose.hpp: up to 4D)."""
    x = on_device(data, device)
    if x.dim() > 4:
        raise ValueError("Data in 5D and above is not supported yet.")
    return x.permute(*axes).contiguous()


def prefilter(data, value_range: Tuple[float, float], default_value: float, *,
              device=None) -> torch.Tensor:
    """Replace out-of-range values with a default (reference PreFilter.hpp)."""
    x = on_device(data, device)
    lo, hi = value_range
    return torch.where((x < lo) | (x > hi), torch.tensor(default_value, dtype=x.dtype,
                                                         device=x.device), x)


# Daubechies-4 analysis coefficients, as the JAX package computes them
_S3 = math.sqrt(3)
_D4_H = [c / (4 * math.sqrt(2)) for c in (1 + _S3, 3 + _S3, 3 - _S3, 1 - _S3)]
_D4_G = [_D4_H[3], -_D4_H[2], _D4_H[1], -_D4_H[0]]


def _filters(device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.tensor(_D4_H, dtype=torch.float64, device=device),
            torch.tensor(_D4_G, dtype=torch.float64, device=device))


def _windows(half: int, length: int, device) -> torch.Tensor:
    """(half, 4) indices of each output's four taps, wrapping at `length`."""
    return (torch.arange(half, device=device)[:, None] * 2
            + torch.arange(4, device=device)[None, :]) % length


def _next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m <<= 1
    return m


def wavelet_forward(data, *, device=None) -> torch.Tensor:
    """Pyramidal D4 DWT over the flattened data, zero-padded to a power of
    two (reference Wavelet.hpp preprocess). Returns the float64 coefficients
    of the padded length; invert with wavelet_inverse(coeffs, n)."""
    x = on_device(data, device).reshape(-1).to(torch.float64)
    n = x.numel()
    h, g = _filters(x.device)
    buf = torch.zeros(_next_pow2(n), dtype=torch.float64, device=x.device)
    buf[:n] = x
    length = buf.numel()
    while length >= 4:
        half = length // 2
        windows = buf[:length][_windows(half, length, x.device)]
        smooth, detail = windows @ h, windows @ g
        buf[:half] = smooth
        buf[half:length] = detail
        length = half
    return buf


def wavelet_inverse(coeffs, n: int, *, device=None) -> torch.Tensor:
    """Inverse of wavelet_forward; returns the first n samples (float64)."""
    buf = on_device(coeffs, device).reshape(-1).to(torch.float64).clone()
    h, g = _filters(buf.device)
    m = buf.numel()
    length = 4
    while length <= m:
        half = length // 2
        # transpose of the analysis operator (orthonormal bank), scattered
        # with the same index matrix the forward transform gathers through
        contrib = buf[:half, None] * h[None, :] + buf[half:length, None] * g[None, :]
        out = torch.zeros(length, dtype=torch.float64, device=buf.device)
        out.index_add_(0, _windows(half, length, buf.device).reshape(-1), contrib.reshape(-1))
        buf[:length] = out
        length *= 2
    return buf[:n]
