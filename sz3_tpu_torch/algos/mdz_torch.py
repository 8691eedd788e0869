"""The MDZ adaptive batch pipeline with its VQ / VQT / MT sweeps on the
device (counterpart of sz3_tpu/algos/mdz_jax.py). It replays the host
engine's csrc/engine/szt/mdz.hpp::mdz_compress / mdz_decompress byte for
byte:

  host   : VQ level learning (szt_mdz_levels: k-means get_cluster and its
           sampling rules), the method selection's decisions (sizes compared
           as detail::mdz_select does), per-batch REL->ABS bounds, the MDZ1 /
           MDZ3 container (mdz.hpp:502-530), the Huffman + zstd stream seals
           and opens (szt_exaalt_seal / _open, szt_mdz_ts_seal / _open)
  device : the VQ / VQT / MT quantize and recover sweeps (ops/mdz_device.py,
           the frame recurrence in csrc/mdz_frames.cu), on the selection's
           trial samples too
  host   : LR (blockwise) and TS (a sequential frame-0 chain) batches
           through the engine's per-batch LAMMPS entry points

Float32 only; mdz.py sends float64 series and series of more than 3
dimensions to the host engine before any device work. Where every trial of
the selection fails, the engine picks method 0 and its run then raises; so
does this pipeline, with the engine's message.
"""

from __future__ import annotations

import ctypes as C
import struct
from typing import Optional

import numpy as np
import torch

from .. import runtime
from ..mdz import EngineError, _engine_error, lammps_compress, lammps_decompress
from ..ops import mdz_device as md

_ERRCAP = runtime._ERRCAP
_BATCH = struct.Struct("<BffidQ")
_bound = False


def _l():
    global _bound
    l = runtime.lib()
    if not _bound:
        u64, i32, f32 = C.c_uint64, C.c_int32, C.c_float
        u8p = C.POINTER(C.c_uint8)
        l.szt_mdz_levels.restype = C.c_int
        l.szt_mdz_levels.argtypes = [C.c_void_p, u64, C.POINTER(f32), C.POINTER(f32),
                                     C.POINTER(i32), C.c_char_p, u64]
        l.szt_exaalt_seal.restype = C.c_int
        l.szt_exaalt_seal.argtypes = [C.c_double, i32, C.c_void_p, u64, C.c_void_p, u64,
                                      C.c_void_p, u64, u64, C.POINTER(u8p), C.POINTER(u64),
                                      C.c_char_p, u64]
        l.szt_exaalt_open.restype = C.c_int
        l.szt_exaalt_open.argtypes = [C.c_char_p, u64, u64, u64, C.c_void_p, C.c_void_p,
                                      C.POINTER(C.POINTER(f32)), C.POINTER(u64), C.c_char_p,
                                      u64]
        l.szt_mdz_ts_seal.restype = C.c_int
        l.szt_mdz_ts_seal.argtypes = [C.c_double, i32, C.c_void_p, u64, C.c_void_p, u64, u64,
                                      C.POINTER(u8p), C.POINTER(u64), C.c_char_p, u64]
        l.szt_mdz_ts_open.restype = C.c_int
        l.szt_mdz_ts_open.argtypes = [C.c_char_p, u64, u64, C.c_void_p,
                                      C.POINTER(C.POINTER(f32)), C.POINTER(u64), C.c_char_p,
                                      u64]
        _bound = True
    return l


def mdz_levels(frame0: np.ndarray):
    """(level_start, level_offset, level_num) with the pipeline's sampling
    rules (mdz.hpp:456-462); level_num excludes the +200 margin."""
    frame0 = np.ascontiguousarray(frame0, np.float32)
    ls, lo, ln = C.c_float(), C.c_float(), C.c_int32()
    err = C.create_string_buffer(_ERRCAP)
    rc = _l().szt_mdz_levels(frame0.ctypes.data_as(C.c_void_p), C.c_uint64(frame0.size),
                             C.byref(ls), C.byref(lo), C.byref(ln), err, _ERRCAP)
    if rc != 0:
        raise _engine_error("szt_mdz_levels", err)
    return float(ls.value), float(lo.value), int(ln.value)


def _exaalt_seal(eb, radius, qinds, pinds, unpred, cap) -> bytes:
    qinds = np.ascontiguousarray(qinds, np.int32)
    pinds = np.ascontiguousarray(pinds, np.int32)
    unpred = np.ascontiguousarray(unpred, np.float32)
    out = C.POINTER(C.c_uint8)()
    out_len = C.c_uint64()
    err = C.create_string_buffer(_ERRCAP)
    rc = _l().szt_exaalt_seal(
        C.c_double(eb), C.c_int32(radius), qinds.ctypes.data_as(C.c_void_p),
        C.c_uint64(qinds.size), pinds.ctypes.data_as(C.c_void_p), C.c_uint64(pinds.size),
        unpred.ctypes.data_as(C.c_void_p), C.c_uint64(unpred.size), C.c_uint64(cap),
        C.byref(out), C.byref(out_len), err, _ERRCAP)
    if rc != 0:
        raise _engine_error("szt_exaalt_seal", err)
    return runtime._take(out, out_len)


def _unpred_array(up, nun) -> np.ndarray:
    unpred = np.ctypeslib.as_array(up, shape=(nun.value,)).astype(np.float32, copy=True) \
        if nun.value else np.zeros(0, np.float32)
    runtime.lib().szt_free(C.cast(up, C.c_void_p))
    return unpred


def _exaalt_open(stream: bytes, n: int, pn: int):
    qinds = np.empty(n, np.int32)
    pinds = np.empty(pn, np.int32)
    up = C.POINTER(C.c_float)()
    nun = C.c_uint64()
    err = C.create_string_buffer(_ERRCAP)
    rc = _l().szt_exaalt_open(stream, C.c_uint64(len(stream)), C.c_uint64(n), C.c_uint64(pn),
                              qinds.ctypes.data_as(C.c_void_p), pinds.ctypes.data_as(C.c_void_p),
                              C.byref(up), C.byref(nun), err, _ERRCAP)
    if rc != 0:
        raise _engine_error("szt_exaalt_open", err)
    return qinds, pinds, _unpred_array(up, nun)


def _ts_seal(eb, radius, bins, unpred, cap) -> bytes:
    bins = np.ascontiguousarray(bins, np.int32)
    unpred = np.ascontiguousarray(unpred, np.float32)
    out = C.POINTER(C.c_uint8)()
    out_len = C.c_uint64()
    err = C.create_string_buffer(_ERRCAP)
    rc = _l().szt_mdz_ts_seal(
        C.c_double(eb), C.c_int32(radius), bins.ctypes.data_as(C.c_void_p),
        C.c_uint64(bins.size), unpred.ctypes.data_as(C.c_void_p), C.c_uint64(unpred.size),
        C.c_uint64(cap), C.byref(out), C.byref(out_len), err, _ERRCAP)
    if rc != 0:
        raise _engine_error("szt_mdz_ts_seal", err)
    return runtime._take(out, out_len)


def _ts_open(stream: bytes, n: int):
    bins = np.empty(n, np.int32)
    up = C.POINTER(C.c_float)()
    nun = C.c_uint64()
    err = C.create_string_buffer(_ERRCAP)
    rc = _l().szt_mdz_ts_open(stream, C.c_uint64(len(stream)), C.c_uint64(n),
                              bins.ctypes.data_as(C.c_void_p), C.byref(up), C.byref(nun), err,
                              _ERRCAP)
    if rc != 0:
        raise _engine_error("szt_mdz_ts_open", err)
    return bins, _unpred_array(up, nun)


def _radius(quantbin: int) -> int:
    """quantbin / 2 in C++ int arithmetic (towards zero)."""
    return -(-quantbin // 2) if quantbin < 0 else quantbin // 2


def to_host(*tensors: torch.Tensor):
    """The device results a host seal takes, as numpy arrays."""
    return [t.cpu().numpy() for t in tensors]


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


# ---- per-batch method run -------------------------------------------------------

class _Series:
    """One 2D (frames, atoms) series: on the device, and on the host where
    the engine's per-batch coders and the level learning read it."""

    def __init__(self, host: np.ndarray, dev: torch.Tensor):
        self.host, self.dev = host, dev

    def rows(self, a: int, b: int) -> "_Series":
        return _Series(self.host[a:b], self.dev[a:b])


def _run_method(method: int, batch: _Series, abs_eb: float, quantbin: int, block_size: int,
                ls: float, lo: float, ln: int, ts0: _Series) -> bytes:
    """One (frames, atoms) batch -> its method stream, byte-identical to
    detail::mdz_run_method (mdz.hpp:293-319)."""
    radius = _radius(quantbin)
    cap = 2 * batch.host.nbytes + 4096
    if method in (0, 1):
        if ln == 0:
            raise EngineError("mdz", "VQ/VQT not available: no level grid detected")
        qinds, pinds, unpred = to_host(*md.exaalt_encode(batch.dev, method, float(abs_eb),
                                                         radius, ls, lo, ln + md.MARGIN))
        return _exaalt_seal(abs_eb, radius, qinds, pinds, unpred, cap)
    if method == 2:
        bins, unpred = to_host(*md.mt_encode(batch.dev, ts0.dev, float(abs_eb), radius))
        return _ts_seal(abs_eb, radius, bins, unpred, cap)
    # LR (3) and TS (4): the engine's per-batch entry points
    return lammps_compress(batch.host, method, abs_eb=abs_eb, level=(ls, lo, ln),
                           ts0=ts0.host, quantbin=quantbin, block_size=block_size)


def _select(ts: int, batch_frames: int, abs_eb: float, batch_size: int, quantbin: int,
            block_size: int, ls: float, lo: float, ln: int, ts0: _Series, series: _Series,
            total_frames: int) -> int:
    """detail::mdz_select (mdz.hpp:408-440): trial-compress the candidates
    on up to 10 frames, keep the smallest stream (the first on ties; method
    0 where every trial fails, as the engine's argmin)."""
    t, frames = ts, batch_frames
    if ts == 0:
        if batch_frames == 1:
            return 0 if ln > 0 else 3
        t = batch_frames // 2
        frames = batch_frames // 2
    if batch_size > 10 or (batch_size == 0 and frames > 10):
        frames = min(frames, 10)
    frames = min(frames, total_frames - t)
    sample = series.rows(t, t + frames)
    sizes = np.full(5, np.iinfo(np.int64).max, np.int64)

    def trial(m):
        try:
            sizes[m] = len(_run_method(m, sample, abs_eb, quantbin, block_size, ls, lo, ln, ts0))
        except EngineError:     # the engine's own failures, as its catch (...)
            pass

    if ln > 0:
        trial(0)
        trial(1)
    else:
        trial(3)
    trial(2)
    return int(np.argmin(sizes))


def _batch_range(x: torch.Tensor) -> float:
    """max - min of a batch in float32, as the engine's std::max_element and
    std::min_element give them: a NaN is passed over unless it is the
    batch's first value, which then stands as both."""
    flat = x.reshape(-1)
    nan = torch.isnan(flat)
    mx = torch.where(nan, float("-inf"), flat).max()
    mn = torch.where(nan, float("inf"), flat).min()
    return float(torch.where(nan[0], flat[0], mx - mn))


def _compress_2d(series: _Series, dims, eb_mode: int, eb: float, batch_size: int,
                 quantbin: int, method: int, block_size: int = 128) -> bytes:
    """mdz_compress_2d (mdz.hpp:444-530) with the batch sweeps on the device."""
    total_frames = dims[0] if len(dims) == 2 else 1
    batch = batch_size if batch_size else total_frames
    method_batch = 50 if method == -1 else 0

    ts0 = series.rows(0, 1)
    ts0 = _Series(ts0.host[0], ts0.dev[0])
    ls, lo, ln = 0.0, 1.0, 0
    if method not in (2, 3, 4):
        ls, lo, ln = mdz_levels(ts0.host)

    current = method
    used_mt = False
    recs = []
    for ts in range(0, total_frames, batch):
        frames = min(batch, total_frames - ts)
        data = series.rows(ts, ts + frames)
        abs_eb = eb
        if eb_mode == 1:
            abs_eb = eb * _batch_range(data.dev)
        if not abs_eb > 0:
            abs_eb = 1.0
        if method_batch > 0 and (ts // batch) % method_batch == 0:
            current = _select(ts, frames, abs_eb, batch_size, quantbin, block_size, ls, lo, ln,
                              ts0, series, total_frames)
        if current == 2:
            used_mt = True
        try:
            stream = _run_method(current, data, abs_eb, quantbin, block_size, ls, lo, ln, ts0)
        except EngineError as e:
            raise RuntimeError(f"mdz_compress: {e.reason}") from e
        recs.append((current, ls, lo, ln, abs_eb, stream))

    out = bytearray(b"MDZ1")
    out += struct.pack("<BB", 0, len(dims))
    for d in dims:
        out += struct.pack("<Q", d)
    out += struct.pack("<Bd", eb_mode, eb)
    out += struct.pack("<QiiB", batch, quantbin, block_size, 1 if used_mt else 0)
    if used_mt:
        z = runtime.zstd_compress(ts0.host.tobytes())
        out += struct.pack("<Q", len(z)) + z
    out += struct.pack("<I", len(recs))
    for m, s, o, n, e, stream in recs:
        out += _BATCH.pack(m, s, o, n, e, len(stream))
    for rec in recs:
        out += rec[5]
    return bytes(out)


def mdz_compress_torch(data: np.ndarray, *, abs_eb: Optional[float] = None,
                       rel_eb: Optional[float] = None, batch_size: int = 0, method: int = -1,
                       quantbin: int = 1024, device: torch.device) -> bytes:
    """The MDZ archive of the float32 series `data` (1D-3D, C-contiguous;
    exactly one of abs_eb / rel_eb, as mdz.mdz_compress checks) with its
    sweeps on `device`; byte-identical to the host engine's."""
    eb_mode = 0 if abs_eb is not None else 1
    eb = float(abs_eb if abs_eb is not None else rel_eb)
    x = upload(data, device)
    if data.ndim <= 2:
        frames = data.shape[0] if data.ndim == 2 else 1
        series = _Series(data.reshape(frames, -1), x.reshape(frames, -1))
        return _compress_2d(series, data.shape, eb_mode, eb, batch_size, quantbin, method)
    F, A, X = data.shape
    out = bytearray(b"MDZ3")
    out += struct.pack("<B", 0)
    for d in data.shape:
        out += struct.pack("<Q", d)
    for k in range(X):
        # the host side stays a strided view: the engine's coders copy the
        # rows of an LR or TS batch when they run
        axis = _Series(data[:, :, k], x[:, :, k].contiguous())
        sub = _compress_2d(axis, (F, A), eb_mode, eb, batch_size, quantbin, method)
        out += struct.pack("<Q", len(sub)) + sub
    return bytes(out)


# ---- decompress -----------------------------------------------------------------

def _decompress_2d(src: memoryview, dims, batch: int, quantbin: int, block_size: int,
                   device: torch.device) -> torch.Tensor:
    """One MDZ1 body after the shared prefix (mdz_decompress_2d,
    mdz.hpp:533-590) -> (frames, atoms) float32 on `device`."""
    pos = 0
    total_frames = dims[0] if len(dims) == 2 else 1
    atoms = dims[-1]
    radius = _radius(quantbin)
    has_ts0 = src[pos]
    pos += 1
    ts0 = None
    if has_ts0:
        (zlen,) = struct.unpack_from("<Q", src, pos)
        pos += 8
        raw = np.frombuffer(runtime.zstd_decompress(bytes(src[pos:pos + zlen])),
                            np.float32).copy()
        if raw.size != atoms:
            raise ValueError(f"an MDZ first frame of {raw.size} atoms, not {atoms}")
        ts0 = _Series(raw, upload(raw, device))
        pos += zlen
    (nbatches,) = struct.unpack_from("<I", src, pos)
    pos += 4
    hdrs = []
    for _ in range(nbatches):
        hdrs.append(_BATCH.unpack_from(src, pos))
        pos += _BATCH.size
    # the batches must tile the frames, and their streams lie in the archive
    spans, ts = [], 0
    for _ in hdrs:
        if ts >= total_frames:
            raise ValueError("MDZ batches past the last frame")
        spans.append((ts, min(batch if batch else total_frames, total_frames - ts)))
        ts += spans[-1][1]
    if ts != total_frames or pos + sum(h[-1] for h in hdrs) > len(src):
        raise ValueError("MDZ batches short of the frames or past the archive")
    out = None                    # sized once the first batch has opened
    for (ts, frames), (m, ls, lo, ln, abs_eb, slen) in zip(spans, hdrs):
        stream = bytes(src[pos:pos + slen])
        pos += slen
        n = frames * atoms
        if m in (0, 1):
            qinds, pinds, unpred = _exaalt_open(stream, n, atoms if m == 1 else n)
            rows = md.exaalt_decode(
                upload(qinds, device), upload(pinds, device), upload(unpred, device), m, frames,
                atoms, abs_eb, radius, ls, lo, ln + md.MARGIN)
        elif m == 2:
            if ts0 is None:
                raise ValueError("an MT batch in an archive without its first frame")
            bins, unpred = _ts_open(stream, n)
            rows = md.mt_decode(upload(bins, device), upload(unpred, device), ts0.dev, frames,
                                atoms, abs_eb, radius)
        else:
            rows = upload(lammps_decompress(
                stream, m, frames, atoms, abs_eb=abs_eb, level=(ls, lo, ln),
                ts0=ts0.host if ts0 is not None else None, quantbin=quantbin,
                block_size=block_size), device)
        if out is None:
            out = torch.empty((total_frames, atoms), dtype=torch.float32, device=device)
        out[ts:ts + frames] = rows
    return out


def _mdz1_dims(blob: bytes) -> tuple:
    nd = blob[5]
    if nd not in (1, 2):
        raise ValueError(f"an MDZ1 series of rank {nd}")
    return struct.unpack_from(f"<{nd}Q", blob, 6)


def _mdz1(blob: bytes, device: torch.device) -> torch.Tensor:
    dims = _mdz1_dims(blob)
    nd = len(dims)
    pos = 6 + 8 * nd + 9                 # eb mode u8, eb f64
    batch, quantbin, block_size = struct.unpack_from("<Qii", blob, pos)
    pos += 16
    arr = _decompress_2d(memoryview(blob)[pos:], dims, batch, quantbin, block_size, device)
    return arr.reshape(dims)


def mdz_decompress_torch(blob: bytes, device: torch.device) -> torch.Tensor:
    """A float32 MDZ archive -> tensor on `device` (the counterpart of
    mdz_decompress_jax)."""
    magic = blob[:4]
    if magic not in (b"MDZ1", b"MDZ3"):
        raise ValueError("not an MDZ archive")
    if blob[4] != 0:
        raise ValueError("the device pipeline decodes float32 MDZ archives")
    if magic == b"MDZ1":
        return _mdz1(blob, device)
    F, A, X = struct.unpack_from("<QQQ", blob, 5)
    pos = 5 + 24
    out = None                    # sized once the first series has decoded
    for k in range(X):
        (slen,) = struct.unpack_from("<Q", blob, pos)
        pos += 8
        sub = blob[pos:pos + slen]
        if sub[:4] != b"MDZ1" or _mdz1_dims(sub) != (F, A):
            raise ValueError(f"MDZ3 series {k} is no MDZ1 series of dims {(F, A)}")
        series = _mdz1(sub, device)
        if out is None:
            out = torch.empty((F, A, X), dtype=torch.float32, device=device)
        out[:, :, k] = series
        pos += slen
    if out is None:               # no series: no elements
        out = torch.empty((F, A, 0), dtype=torch.float32, device=device)
    return out
