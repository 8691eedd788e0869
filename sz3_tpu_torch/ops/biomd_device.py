"""ALGO_BIOMD's frame recurrence on the device (counterpart of
sz3_tpu/ops/biomd_device.py; reference SZBioMDDecomposition.hpp:229-285).

Frames t > 0 of a 3D (frames, atoms, xyz) trajectory: the boundary atom of
each molecule (j % site == 0) is predicted from the previous frame, every
other atom from a 2D (time, atom) Lorenzo on its molecule's boundary atom,
pred = (prev(t-1, j) + rec(t, b)) - prev(t-1, b) in float32, in that order.
So a frame is two quantize steps over all atoms, and frame t depends only
on frame t - 1. Frame 0's atom chain (j predicted from j - max(1, j % site))
is sequential and runs in the host engine (runtime.biomd_frame0); data with
no molecular period (site == 0) and trajectories with fewer than 2 live
frames stay on the host engine altogether.

  biomd_frames   csrc/biomd_frames.cu, where the JAX package runs the
                 lax.scan of _encode_scan / _decode_scan: one thread per
                 (molecule, column) walks the frames with the previous
                 frame's reconstruction of its molecule in registers. One
                 launch a call; the plain loop takes some 25 a frame.

The wrappers frames_encode / frames_recover run the plain PyTorch versions
(frames_encode_plain, frames_recover_plain) when handed CPU tensors, and
only then. For CUDA tensors they launch the kernel or raise.

cal_site, find_fill and _pad_groups are the port's copy of the JAX
package's host helpers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..build import kernels
from .quantize import quantize, recover

MAX_SITE = 10          # cal_site accepts periods 3..10


def cal_site(frame: np.ndarray) -> int:
    """Water-model site period from relative jumps down the atom axis
    (reference SZBioMDDecomposition.hpp:92-126; host mirror biomd.hpp:35-67).
    frame: (atoms, cols). Ties resolve first-seen; accepted iff 2 < p <= 10."""
    atoms, cols = frame.shape
    sites: list[int] = []
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for j in range(min(cols, 5)):
            lprev = 0
            for i in range(1, min(atoms, 100)):
                c = frame[i, j]
                p = frame[i - 1, j]
                if np.abs(c - p) / c > 0.5:  # T-precision ratio, sign kept
                    sites.append(i - lprev)
                    lprev = i
    freq: dict[int, int] = {}
    for s in sites:
        freq[s] = freq.get(s, 0) + 1
    res, max_count = 0, 0
    for s, n in freq.items():  # insertion order == first-seen
        if n > max_count:
            res, max_count = s, n
    return 0 if (res <= 2 or res > MAX_SITE) else res


def find_fill(data: np.ndarray) -> tuple[int, float]:
    """Trailing constant-filled frames (reference :130-163). data: (F, ...).
    Returns (first_fill_frame, fill_value)."""
    frames = data.shape[0]
    if frames == 0:
        return 0, 0.0
    flat = data.reshape(frames, -1)
    fill = flat[-1, 0]
    first_fill = frames
    for i in range(frames - 1, 0, -1):
        if bool((flat[i] == fill).all()):
            first_fill = i
        else:
            break
    return first_fill, float(fill)


def _pad_groups(x: torch.Tensor, site: int) -> torch.Tensor:
    """(F, A, C) -> (F, G, site, C) with atoms padded to a site multiple."""
    f, a, c = x.shape
    g = -(-a // site)
    pad = g * site - a
    if pad:
        x = torch.cat([x, x.new_zeros((f, pad, c))], dim=1)
    return x.reshape(f, g, site, c)


def _ungroup(x: torch.Tensor, atoms: int) -> torch.Tensor:
    f, g, site, c = x.shape
    return x.reshape(f, g * site, c)[:, :atoms].contiguous()


def frames_encode_plain(x: torch.Tensor, recon0: torch.Tensor, eb: float, radius: int,
                        site: int) -> torch.Tensor:
    """Plain version of :func:`frames_encode`: one loop step a frame, two
    quantize steps each, on the grouped layout (padded lanes computed on
    zeros and dropped)."""
    f1, a, c = x.shape
    xg = _pad_groups(x, site)
    prev = _pad_groups(recon0[None], site)[0]
    bins = torch.empty(xg.shape, dtype=torch.int32, device=x.device)
    for t in range(f1):
        cur = xg[t]
        # boundary lanes: pred = the previous frame's reconstruction
        bins_b, recon_b = quantize(cur[:, :1], prev[:, :1], eb, radius)
        # the others: (prev + rec_b) - prev_b in float32, in that order
        pred_nb = (prev + recon_b) - prev[:, :1]
        bins_nb, recon_nb = quantize(cur, pred_nb, eb, radius)
        bins[t, :, :1] = bins_b
        bins[t, :, 1:] = bins_nb[:, 1:]
        prev = torch.cat([recon_b, recon_nb[:, 1:]], dim=1)
    return _ungroup(bins, a)


def frames_recover_plain(bins: torch.Tensor, lits: torch.Tensor, recon0: torch.Tensor,
                         eb: float, radius: int, site: int) -> torch.Tensor:
    """Plain version of :func:`frames_recover`."""
    f1, a, c = bins.shape
    bg = _pad_groups(bins, site)
    lg = _pad_groups(lits, site)
    prev = _pad_groups(recon0[None], site)[0]
    out = torch.empty(lg.shape, dtype=torch.float32, device=bins.device)
    for t in range(f1):
        b, lit = bg[t], lg[t]
        rec_b = recover(prev[:, :1], b[:, :1], lit[:, :1], eb, radius)
        pred_nb = (prev + rec_b) - prev[:, :1]
        rec_nb = recover(pred_nb, b, lit, eb, radius)
        out[t, :, :1] = rec_b
        out[t, :, 1:] = rec_nb[:, 1:]
        prev = out[t]
    return _ungroup(out, a)


def _check(vals: torch.Tensor, recon0: torch.Tensor, radius: int, site: int,
           ints: torch.Tensor = None) -> None:
    """The recurrence's arguments: vals (F-1, A, C) float32 (originals or the
    literal grid), ints (F-1, A, C) int32 (bins), recon0 (A, C) float32, all
    contiguous on one device."""
    if vals.dim() != 3 or min(vals.shape) < 1:
        raise ValueError(f"frames must be (frames, atoms, cols), not {tuple(vals.shape)}")
    f1, a, c = vals.shape
    want = [(vals, (f1, a, c)), (recon0, (a, c))] + ([(ints, (f1, a, c))] if ints is not None
                                                      else [])
    for t, shape in want:
        dt = torch.int32 if t is ints else torch.float32
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous() \
                or t.device != vals.device:
            raise ValueError(f"frame argument of {t.dtype} {tuple(t.shape)} on {t.device}: "
                             f"want a contiguous {dt} {shape} on {vals.device}")
    if not 2 < site <= MAX_SITE:
        raise ValueError(f"site {site} outside (2, {MAX_SITE}]")
    if not 0 < radius < 2 ** 30:
        raise ValueError(f"radius {radius} outside [1, 2^30)")
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {vals.device}")


def biomd_frames(vals: torch.Tensor, ints: torch.Tensor, rec: torch.Tensor,
                 recon0: torch.Tensor, eb: float, radius: int, site: int,
                 encode: bool) -> None:
    """Launch the frame recurrence on CUDA tensors checked by _check, frames
    1..F-1 after the frame-0 reconstruction `recon0`. Encode: `vals` holds
    the original values and `ints` receives the bins (a bin-0 cell keeps its
    original value for the next frame's predictions). Recover: `ints` holds
    the bins, `vals` the literals placed at the zero bins, and `rec`
    receives the reconstruction."""
    f1, a, c = vals.shape
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    rc = kernels().szt_biomd_frames(vals.data_ptr(), ints.data_ptr(),
                                    rec.data_ptr() if rec is not None else None,
                                    recon0.data_ptr(), f1, a, c, site, float(eb), 1.0 / eb,
                                    radius, int(encode), stream)
    if rc != 0:
        raise RuntimeError(f"szt_biomd_frames: CUDA error {rc}")
    biomd_frames.launches += 1


biomd_frames.launches = 0


def frames_encode(x: torch.Tensor, recon0: torch.Tensor, eb: float, radius: int,
                  site: int) -> torch.Tensor:
    """Frames 1..last (F-1, A, C) float32 and frame 0's reconstruction (A, C)
    -> the bins (F-1, A, C) int32, quantized as the host engine does."""
    _check(x, recon0, radius, site)
    if x.device.type == "cpu":
        return frames_encode_plain(x, recon0, eb, radius, site)
    bins = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    biomd_frames(x, bins, None, recon0, eb, radius, site, encode=True)
    return bins


def frames_recover(bins: torch.Tensor, lits: torch.Tensor, recon0: torch.Tensor,
                   eb: float, radius: int, site: int) -> torch.Tensor:
    """Bins (F-1, A, C) int32, the literals placed at their zero bins (F-1,
    A, C) float32 and frame 0's reconstruction (A, C) -> frames 1..last."""
    _check(lits, recon0, radius, site, bins)
    if bins.device.type == "cpu":
        return frames_recover_plain(bins, lits, recon0, eb, radius, site)
    rec = torch.empty(lits.shape, dtype=torch.float32, device=lits.device)
    biomd_frames(lits, bins, rec, recon0, eb, radius, site, encode=False)
    return rec
