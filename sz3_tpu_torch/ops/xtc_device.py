"""ALGO_BIOMDXTC's quantizer on the device (counterpart of the native-f64
forms of sz3_tpu/ops/xtc_device.py; reference biomd.hpp:231-291).

The BioMDXtc decomposition is an elementwise quantize against a zero
prediction at the XTC radius (INT32_MAX / 16), with the relaxed tolerance
`err <= eb || err <= eb*1.1` of the non-strict quantizer (quantizer.hpp:55):
no recurrence, so each direction is one pass of elementwise PyTorch
operations on the card. The card has IEEE f64, so the TPU's softfloat forms
(_xtc_quantize_exact, _xtc_recover_exact) have no counterpart here. The XTC
triplet coder (mixed-radix, the GROMACS format) stays in the host engine
(runtime.biomdxtc_seal / biomdxtc_open): a sequential byte format whose cost
follows the compressed size.
"""

from __future__ import annotations

import numpy as np
import torch

XTC_RADIUS = (2**31 - 1) // 16  # kXtcRadius, biomd.hpp:228


def _tol32(eb: float) -> np.float32:
    """Largest f32 <= round53(eb * 1.1): the relaxed acceptance threshold.
    err is an exact f32 value, so err <= f64(eb*1.1) reduces to this f32
    compare."""
    t = np.float64(eb) * np.float64(1.1)
    t32 = np.float32(t)
    if np.float64(t32) > t:
        t32 = np.nextafter(t32, np.float32(0))
    return t32


def xtc_quantize(data: torch.Tensor, eb: float) -> torch.Tensor:
    """float32 data -> stored bins (int32, already offset by -XTC_RADIUS as
    in the archive stream; -XTC_RADIUS marks a literal)."""
    recip = 1.0 / eb
    scaled = data.abs().to(torch.float64) * recip
    clampv = 2 * XTC_RADIUS
    # clamp before the int cast: NaN and huge values end at the clamp
    qi = torch.clamp(scaled, max=float(clampv)).to(torch.int64).to(torch.int32) + 1
    half = qi >> 1
    qe = half << 1
    neg = data < 0
    q = torch.where(neg, -qe, qe)
    dec = (q.to(torch.float64) * eb).to(data.dtype)
    err = (dec - data).to(torch.float64).abs()
    ok = (qi < clampv) & (err <= float(_tol32(eb))) & torch.isfinite(data)
    shifted = torch.where(neg, XTC_RADIUS - half, XTC_RADIUS + half)
    return torch.where(ok, shifted, 0).to(torch.int32) - XTC_RADIUS


def xtc_recover(stored: torch.Tensor, literal: torch.Tensor, eb: float) -> torch.Tensor:
    """Stored bins (offset by -XTC_RADIUS) + the literals placed at the
    -XTC_RADIUS cells -> reconstruction: f32(2*stored*eb) elsewhere
    (quantizer.hpp recover with pred 0, q = stored + XTC_RADIUS)."""
    dec = ((2 * stored.to(torch.int64)).to(torch.float64) * eb).to(literal.dtype)
    return torch.where(stored != -XTC_RADIUS, dec, literal)
