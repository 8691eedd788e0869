"""The MDZ time-series methods on the device (counterpart of
sz3_tpu/ops/mdz_device.py; host engine csrc/engine/szt/mdz.hpp, from the
reference's tools/mdz, SZExaaltCompressor.hpp and
TimeSeriesDecomposition.hpp).

  VQ  (0): level index l = round((v - start) / offset), elementwise (the
           prediction reads the original value, not a reconstruction); the
           pred stream is a first difference of l. One elementwise pass.
  VQT (1): VQ over frame 0's atoms, then frames > 0 quantized against the
           previous frame's reconstruction: the frame recurrence.
  MT  (2): frame 0 quantized against the series' pinned first frame, then
           the same recurrence.
  LR and TS run in the host engine (algos/mdz_torch.py).

Stream order: the codecs visit frame 0 first, then frames > 0 in (atom,
frame) order (mdz.hpp:88-106, :184-202), for the bins and the literals alike.

  mdz_frames   csrc/mdz_frames.cu, where the JAX package runs the lax.scan of
               _jit_frames_encode / _jit_frames_decode: one thread per atom
               walks the frames with the previous frame's reconstruction in a
               register, and reads or writes the bins in the archive's (atom,
               frame) order (the encode through shared-memory tiles of 32
               frames), so no transpose follows. The recover reads the
               literals compact, as the archive holds them, from each atom's
               first slot (literal_starts). One launch a call; the plain loop
               takes some 25 a frame.

The wrappers frames_encode / frames_recover run the plain PyTorch versions
(frames_encode_plain, frames_recover_plain) when handed CPU tensors, and
only then. For CUDA tensors they launch the kernel or raise.

Level arithmetic as the engine's float32 build: (v - start) / offset in
float32, rounded half away from zero (in float64, exact for any float32),
cast to int as x86 does (NaN and values outside int32 give INT_MIN); the
level value f32(start + f32(l) * offset). The quantizer is ops/quantize's.
"""

from __future__ import annotations

import torch

from ..build import kernels
from .quantize import quantize, recover

MARGIN = 200  # reference set_level margin (mdz.hpp:303, SZExaalt :186)
_INT_MIN = -(1 << 31)


def _round_half_away(y: torch.Tensor) -> torch.Tensor:
    """int(std::round(y)) for float32 y, as the engine computes it."""
    y64 = y.to(torch.float64)
    r = torch.where(y64 >= 0, torch.floor(y64 + 0.5), torch.ceil(y64 - 0.5))
    ok = (r >= _INT_MIN) & (r < -_INT_MIN)      # NaN fails both
    return torch.where(ok, r, float(_INT_MIN)).to(torch.int32)


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _to_level(v: torch.Tensor, ls: float, lo: float) -> torch.Tensor:
    return _round_half_away((v - _f32(ls, v)) / _f32(lo, v))


def _level_value(l: torch.Tensor, ls: float, lo: float) -> torch.Tensor:
    return _f32(ls, l) + l.to(torch.float32) * _f32(lo, l)


def _pred_inds(l: torch.Tensor, ln: int) -> torch.Tensor:
    """[l0 + ln, diff(l) + ln] in int32, wrapping as the engine's int does."""
    return torch.cat([l[:1] + ln, torch.diff(l) + ln]).to(torch.int32)


def _literals_at(x: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """x where bins == 0, in order (x and bins flat, one device)."""
    return x.index_select(0, torch.nonzero(bins == 0).reshape(-1))


def _place(unpred: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """The literal grid of flat bins: unpred in order at the zero bins."""
    idx = torch.nonzero(bins == 0).reshape(-1)
    if idx.numel() != unpred.numel():
        raise ValueError(f"{unpred.numel()} literals for {idx.numel()} zero bins")
    lit = torch.zeros(bins.shape, dtype=torch.float32, device=bins.device)
    lit[idx] = unpred
    return lit


# ---- VQ: one elementwise pass ---------------------------------------------------

def _vq(x: torch.Tensor, eb: float, radius: int, ls: float, lo: float, ln: int):
    """Flat float32 values -> (quant_inds, pred_inds, unpred) in archive
    order, and the reconstruction."""
    l = _to_level(x, ls, lo)
    bins, recon = quantize(x, _level_value(l, ls, lo), eb, radius)
    return bins, _pred_inds(l, ln), _literals_at(x, bins), recon


def vq_decode(qinds: torch.Tensor, pinds: torch.Tensor, unpred: torch.Tensor, eb: float,
              radius: int, ls: float, lo: float, ln: int) -> torch.Tensor:
    # the running level wraps in int32 as the engine's; a sum in int64 cast
    # down is the same modulo 2^32
    l = torch.cumsum(pinds.to(torch.int64) - ln, 0).to(torch.int32)
    return recover(_level_value(l, ls, lo), qinds, _place(unpred, qinds), eb, radius)


# ---- frames > 0 (VQT and MT share the recurrence) ----------------------------------

def frames_encode_plain(x: torch.Tensor, recon0: torch.Tensor, eb: float,
                        radius: int) -> torch.Tensor:
    """Plain version of :func:`frames_encode`: one quantize a frame."""
    f1, a = x.shape
    bins = torch.empty((f1, a), dtype=torch.int32, device=x.device)
    prev = recon0
    for t in range(f1):
        bins[t], prev = quantize(x[t], prev, eb, radius)
    return bins.t().contiguous()


def frames_recover_plain(bins: torch.Tensor, unpred: torch.Tensor, starts: torch.Tensor,
                         recon0: torch.Tensor, eb: float, radius: int) -> torch.Tensor:
    """Plain version of :func:`frames_recover`: the literals placed on a
    dense grid by the zero bins alone (`starts` is not read), then one
    recover a frame."""
    a, f1 = bins.shape
    lits = _place(unpred, bins.reshape(-1)).reshape(a, f1)
    out = torch.empty((f1, a), dtype=torch.float32, device=bins.device)
    prev = recon0
    for t in range(f1):
        prev = out[t] = recover(prev, bins[:, t], lits[:, t], eb, radius)
    return out


def _check(frames: torch.Tensor, recon0: torch.Tensor, radius: int, unpred: torch.Tensor = None,
           starts: torch.Tensor = None) -> None:
    """The recurrence's arguments: frames (F-1, A) float32 originals, or
    (A, F-1) int32 bins when the literals `unpred` (n,) float32 and their
    `starts` (A,) int64 are given; recon0 (A,) float32; all contiguous on
    one device."""
    if frames.dim() != 2 or min(frames.shape) < 1:
        raise ValueError(f"frames must be 2D and non-empty, not {tuple(frames.shape)}")
    if unpred is None:
        a = frames.shape[1]
        want = [(frames, frames.shape, torch.float32)]
    else:
        a = frames.shape[0]
        want = [(frames, frames.shape, torch.int32), (unpred, (unpred.numel(),), torch.float32),
                (starts, (a,), torch.int64)]
    want.append((recon0, (a,), torch.float32))
    for t, s, dt in want:
        if t.dtype != dt or tuple(t.shape) != s or not t.is_contiguous() \
                or t.device != frames.device:
            raise ValueError(f"frame argument of {t.dtype} {tuple(t.shape)} on {t.device}: "
                             f"want a contiguous {dt} {s} on {frames.device}")
    if not -2 ** 30 < radius < 2 ** 30:
        # a quantbin of 0 or 1 (radius 0) or below makes every cell a
        # literal, as in the engine
        raise ValueError(f"radius {radius} outside (-2^30, 2^30)")
    if frames.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {frames.device}")


def mdz_frames(vals: torch.Tensor, starts: torch.Tensor, ints: torch.Tensor, rec: torch.Tensor,
               recon0: torch.Tensor, eb: float, radius: int, encode: bool) -> None:
    """Launch the frame recurrence on CUDA tensors checked by _check, frames
    1..F-1 after the frame-0 reconstruction `recon0`. Encode: `vals` (F-1,
    A) holds the originals and `ints` (A, F-1) receives the bins (a bin-0
    cell keeps its original value for the next frame). Recover: `ints` (A,
    F-1) holds the bins, `vals` the literals of the zero bins in (atom,
    frame) order, `starts` (A,) each atom's first literal slot, and `rec`
    (F-1, A) receives the reconstruction (NaN where a slot lies outside
    `vals`: the kernel reads no further)."""
    a = recon0.numel()
    f1 = ints.numel() // a
    stream = torch.cuda.current_stream(ints.device).cuda_stream
    rc = kernels().szt_mdz_frames(vals.data_ptr(),
                                  starts.data_ptr() if starts is not None else None,
                                  0 if encode else vals.numel(), ints.data_ptr(), rec.data_ptr() if rec is not None else None,
                                  recon0.data_ptr(), f1, a, float(eb), 1.0 / eb, radius,
                                  int(encode), stream)
    if rc != 0:
        raise RuntimeError(f"szt_mdz_frames: CUDA error {rc}")
    mdz_frames.launches += 1


mdz_frames.launches = 0


def frames_encode(x: torch.Tensor, recon0: torch.Tensor, eb: float, radius: int) -> torch.Tensor:
    """Frames 1..last (F-1, A) float32 and frame 0's reconstruction (A,) ->
    the bins in the archive's (atom, frame) order, (A, F-1) int32."""
    _check(x, recon0, radius)
    if x.device.type == "cpu":
        return frames_encode_plain(x, recon0, eb, radius)
    bins = torch.empty((x.shape[1], x.shape[0]), dtype=torch.int32, device=x.device)
    mdz_frames(x, None, bins, None, recon0, eb, radius, encode=True)
    return bins


def literal_starts(bins: torch.Tensor, count: int) -> torch.Tensor:
    """Bins (A, F-1) in archive order and the number of literals that go
    with them -> each atom's first literal slot, (A,) int64: the exclusive
    prefix sum of the atoms' zero-bin counts. Raises unless the zero bins
    number `count` (the recover would read past the literals)."""
    zeros = (bins == 0).sum(1)
    ends = torch.cumsum(zeros, 0)
    total = int(ends[-1])
    if total != count:
        raise ValueError(f"{count} literals for {total} zero bins")
    return ends - zeros


def frames_recover(bins: torch.Tensor, unpred: torch.Tensor, starts: torch.Tensor,
                   recon0: torch.Tensor, eb: float, radius: int) -> torch.Tensor:
    """Bins (A, F-1) int32 in archive order, the literals of their zero bins
    (n,) float32 in the same order, each atom's first literal slot (A,)
    int64 (literal_starts, which holds n to the zero bins; the kernel reads
    the literals from these slots) and frame 0's reconstruction (A,) -> frames
    1..last, (F-1, A) float32."""
    _check(bins, recon0, radius, unpred, starts)
    if bins.device.type == "cpu":
        return frames_recover_plain(bins, unpred, starts, recon0, eb, radius)
    rec = torch.empty((bins.shape[1], bins.shape[0]), dtype=torch.float32, device=bins.device)
    mdz_frames(unpred, starts, bins, rec, recon0, eb, radius, encode=False)
    return rec


# ---- per method, in the archive's stream order ------------------------------------

def _rest_encode(x: torch.Tensor, recon0: torch.Tensor, eb: float, radius: int):
    """Frames 1..last -> (bins, literals), flat in (atom, frame) order."""
    bins = frames_encode(x, recon0, eb, radius).reshape(-1)
    idx = torch.nonzero(bins == 0).reshape(-1)
    f1 = x.shape[0]
    # slot k of (atom, frame) order is x[k % (F-1), k // (F-1)]
    return bins, x.reshape(-1).index_select(0, (idx % f1) * x.shape[1] + idx // f1)


def _rest_decode(bins: torch.Tensor, unpred: torch.Tensor, recon0: torch.Tensor, frames: int,
                 eb: float, radius: int) -> torch.Tensor:
    bins = bins.reshape(recon0.numel(), frames - 1)
    return frames_recover(bins, unpred, literal_starts(bins, unpred.numel()), recon0, eb,
                          radius)


def exaalt_encode(x: torch.Tensor, method: int, eb: float, radius: int, ls: float, lo: float,
                  ln_margin: int):
    """(frames, atoms) float32 -> (quant_inds, pred_inds, unpred) exactly as
    ExaaltCodec::compress emits them (mdz.hpp:65-107); method 0 = VQ, 1 =
    VQT; ln_margin includes the +200."""
    if method == 0:
        return _vq(x.reshape(-1), eb, radius, ls, lo, ln_margin)[:3]
    b0, p0, u0, r0 = _vq(x[0], eb, radius, ls, lo, ln_margin)
    if x.shape[0] == 1:
        return b0, p0, u0
    bins, lits = _rest_encode(x[1:], r0, eb, radius)
    return torch.cat([b0, bins]), p0, torch.cat([u0, lits])


def exaalt_decode(qinds: torch.Tensor, pinds: torch.Tensor, unpred: torch.Tensor, method: int,
                  frames: int, atoms: int, eb: float, radius: int, ls: float, lo: float,
                  ln_margin: int) -> torch.Tensor:
    if method == 0:
        return vq_decode(qinds, pinds, unpred, eb, radius, ls, lo,
                         ln_margin).reshape(frames, atoms)
    b0 = qinds[:atoms]
    n0 = int((b0 == 0).sum())
    out0 = vq_decode(b0, pinds, unpred[:n0], eb, radius, ls, lo, ln_margin)
    if frames == 1:
        return out0.reshape(1, atoms)
    rest = _rest_decode(qinds[atoms:], unpred[n0:], out0, frames, eb, radius)
    return torch.cat([out0[None], rest])


def mt_encode(x: torch.Tensor, ts0: torch.Tensor, eb: float, radius: int):
    """(frames, atoms) float32 and the pinned first frame -> (bins, unpred)
    exactly as TimeSeriesCodec::compress with ts0 (mdz.hpp:184-202)."""
    b0, r0 = quantize(x[0], ts0, eb, radius)
    u0 = _literals_at(x[0], b0)
    if x.shape[0] == 1:
        return b0, u0
    bins, lits = _rest_encode(x[1:], r0, eb, radius)
    return torch.cat([b0, bins]), torch.cat([u0, lits])


def mt_decode(bins: torch.Tensor, unpred: torch.Tensor, ts0: torch.Tensor, frames: int,
              atoms: int, eb: float, radius: int) -> torch.Tensor:
    b0 = bins[:atoms]
    n0 = int((b0 == 0).sum())
    out0 = recover(ts0, b0, _place(unpred[:n0], b0), eb, radius)
    if frames == 1:
        return out0.reshape(1, atoms)
    rest = _rest_decode(bins[atoms:], unpred[n0:], out0, frames, eb, radius)
    return torch.cat([out0[None], rest])
