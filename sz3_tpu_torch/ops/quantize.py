"""Linear quantizer on torch tensors (counterpart of ``_quantize_native`` and
``_recover_native`` in sz3_tpu/ops/quantize.py; reference
LinearQuantizer.hpp:43-86).

The card has IEEE f64, so the quantizer is the plain f64 formulation and
nothing of the TPU's softfloat, verify or pow2-screen modes is needed. Every
arithmetic step is its own eager op, so each rounds once: no op here may be
fused into a multiply-add. Generic over float32 and float64 data.
"""

from __future__ import annotations

import torch


def quantize(data: torch.Tensor, pred: torch.Tensor, eb: float, radius: int):
    """Returns (bins int32, recon). bins == 0 marks an unpredictable point,
    whose recon keeps the original value (later predictions read it)."""
    recip = 1.0 / eb
    diff = data - pred
    scaled = diff.abs().to(torch.float64) * recip
    # clamp before the int cast; anything at the clamp fails qi < 2*radius
    qi = torch.clamp(scaled, max=float(2 * radius)).to(torch.int32) + 1
    half = qi >> 1
    qeven = half << 1
    neg = diff < 0
    q = torch.where(neg, -qeven, qeven)
    shifted = torch.where(neg, radius - half, radius + half)
    dec = (pred.to(torch.float64) + q.to(torch.float64) * eb).to(data.dtype)
    err = (dec - data).to(torch.float64).abs()
    ok = (qi < 2 * radius) & (err <= eb)
    bins = torch.where(ok, shifted, 0).to(torch.int32)
    recon = torch.where(ok, dec, data)
    return bins, recon


def recover(pred: torch.Tensor, bins: torch.Tensor, literal: torch.Tensor,
            eb: float, radius: int) -> torch.Tensor:
    """bins != 0 -> pred + 2*(bin-radius)*eb in f64, narrowed to pred's type;
    bins == 0 -> the literal placed there."""
    dec = (pred.to(torch.float64)
           + (2 * (bins - radius)).to(torch.float64) * eb).to(pred.dtype)
    return torch.where(bins != 0, dec, literal)
