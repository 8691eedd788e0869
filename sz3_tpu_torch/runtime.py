"""ctypes bindings to the port's host engine (csrc/engine/szt_core.cpp; the
port's copy of sz3_tpu/runtime.py, loading the library that build.py builds).

The engine produces/consumes the archive *payload* — everything between the
16-byte container header and the trailing Config — for every algorithm, in
serial or chunked (OpenMP-equivalent) mode.
"""

from __future__ import annotations

import ctypes as C
import os
from typing import Optional, Tuple

import numpy as np

from .config import ALGO, Config, DataType
from .build import build_engine as _build_native

_ERRCAP = 1024

_DTYPE_TO_NP = {
    DataType.FLOAT: np.float32,
    DataType.DOUBLE: np.float64,
    DataType.UINT8: np.uint8,
    DataType.INT8: np.int8,
    DataType.UINT16: np.uint16,
    DataType.INT16: np.int16,
    DataType.UINT32: np.uint32,
    DataType.INT32: np.int32,
    DataType.UINT64: np.uint64,
    DataType.INT64: np.int64,
}
_NP_TO_DTYPE = {np.dtype(v): k for k, v in _DTYPE_TO_NP.items()}


class SztConfC(C.Structure):
    _fields_ = [
        ("dims", C.c_uint64 * 4),
        ("n_dims", C.c_int32),
        ("cmprAlgo", C.c_uint8),
        ("errorBoundMode", C.c_uint8),
        ("dataType", C.c_uint8),
        ("absErrorBound", C.c_double),
        ("relErrorBound", C.c_double),
        ("psnrErrorBound", C.c_double),
        ("l2normErrorBound", C.c_double),
        ("quantbinCnt", C.c_int32),
        ("blockSize", C.c_int32),
        ("predDim", C.c_uint8),
        ("lorenzo", C.c_uint8),
        ("lorenzo2", C.c_uint8),
        ("regression", C.c_uint8),
        ("regression2", C.c_uint8),
        ("openmp", C.c_uint8),
        ("interpAlgo", C.c_uint8),
        ("interpDirection", C.c_int32),
        ("interpAnchorStride", C.c_int64),
        ("interpAlpha", C.c_double),
        ("interpBeta", C.c_double),
        ("nthreads", C.c_int32),
        # dtype for engine dispatch — separate from the archived dataType byte,
        # which is caller-controlled (the reference CLI leaves it SZ_FLOAT even
        # for doubles, tools/sz3/sz3.cpp:196,278-290)
        ("engineType", C.c_uint8),
    ]


_lib: Optional[C.CDLL] = None


def lib() -> C.CDLL:
    global _lib
    if _lib is None:
        path = _build_native()
        l = C.CDLL(str(path))
        u8p = C.POINTER(C.c_uint8)
        u64 = C.c_uint64
        l.szt_compress.restype = C.c_int
        l.szt_compress.argtypes = [C.POINTER(SztConfC), C.c_void_p, u64,
                                   C.POINTER(u8p), C.POINTER(u64), C.c_char_p, u64]
        l.szt_decompress.restype = C.c_int
        l.szt_decompress.argtypes = [C.POINTER(SztConfC), C.c_char_p, u64, C.c_void_p,
                                     C.c_char_p, u64]
        l.szt_huff_encode.restype = C.c_int
        l.szt_huff_encode.argtypes = [C.c_void_p, u64, C.POINTER(u8p), C.POINTER(u64),
                                      C.c_char_p, u64]
        l.szt_huff_decode.restype = C.c_int
        l.szt_huff_decode.argtypes = [C.c_char_p, u64, C.c_void_p, C.POINTER(u64),
                                      C.c_char_p, u64]
        l.szt_zstd_compress.restype = C.c_int
        l.szt_zstd_compress.argtypes = [C.c_char_p, u64, C.POINTER(u8p), C.POINTER(u64),
                                        C.c_char_p, u64]
        l.szt_zstd_decompress.restype = C.c_int
        l.szt_zstd_decompress.argtypes = [C.c_char_p, u64, C.POINTER(u8p), C.POINTER(u64),
                                          C.c_char_p, u64]
        l.szt_free.restype = None
        l.szt_free.argtypes = [C.c_void_p]
        l.szt_interp_emit.restype = C.c_int
        l.szt_interp_emit.argtypes = [C.POINTER(SztConfC), C.c_void_p, C.c_void_p, C.c_void_p,
                                      C.POINTER(u8p), C.POINTER(u64), C.c_char_p, u64]
        l.szt_interp_place.restype = C.c_int
        l.szt_interp_place.argtypes = [C.POINTER(SztConfC), C.c_void_p, C.c_void_p, C.c_void_p,
                                       C.c_void_p, C.c_char_p, u64]
        l.szt_interp_seal.restype = C.c_int
        l.szt_interp_seal.argtypes = [C.POINTER(SztConfC), C.c_void_p, u64, C.c_void_p, u64, u64,
                                      C.POINTER(u8p), C.POINTER(u64), C.c_char_p, u64]
        l.szt_interp_open.restype = C.c_int
        l.szt_interp_open.argtypes = [C.POINTER(SztConfC), C.c_char_p, u64, C.c_void_p,
                                      C.POINTER(u8p), C.POINTER(u64), C.c_char_p, u64]
        l.szt_tune_interp.restype = C.c_int
        l.szt_tune_interp.argtypes = [C.POINTER(SztConfC), C.c_void_p, C.c_char_p, u64]
        l.szt_perm_emit.restype = C.c_int
        l.szt_perm_emit.argtypes = [C.c_void_p, C.c_void_p, C.c_void_p, u64, C.c_uint32,
                                    C.c_void_p, C.c_void_p, C.POINTER(u64), C.c_char_p, u64]
        l.szt_perm_place.restype = C.c_int
        l.szt_perm_place.argtypes = [C.c_void_p, C.c_void_p, C.c_void_p, u64, C.c_uint32,
                                     C.c_void_p, C.c_void_p, C.c_char_p, u64]
        l.szt_huff_table.restype = C.c_int
        l.szt_huff_table.argtypes = [C.c_int64, C.c_void_p, u64, C.c_void_p, C.c_void_p,
                                     C.POINTER(u8p), C.POINTER(u64), C.c_char_p, u64]
        l.szt_blockwise_seal.restype = C.c_int
        l.szt_blockwise_seal.argtypes = [C.POINTER(SztConfC), C.c_void_p, u64, C.c_void_p, u64,
                                         C.c_void_p, u64, C.c_void_p, u64, C.c_void_p, u64,
                                         C.c_void_p, u64, u64, C.POINTER(u8p), C.POINTER(u64),
                                         C.c_char_p, u64]
        l.szt_open_packed.restype = C.c_int
        l.szt_open_packed.argtypes = [
            C.POINTER(SztConfC), C.c_int, C.c_char_p, u64,
            C.POINTER(u8p), C.POINTER(u64), C.POINTER(u64),
            C.POINTER(C.c_int64), C.POINTER(C.POINTER(C.c_uint32)),
            C.POINTER(u8p), C.POINTER(u64), C.POINTER(C.c_int64),
            C.POINTER(u8p), C.POINTER(u64), C.c_char_p, u64]
        l.szt_open_packed64.restype = C.c_int
        l.szt_open_packed64.argtypes = [
            C.POINTER(SztConfC), C.c_int, C.c_char_p, u64,
            C.POINTER(u8p), C.POINTER(u64), C.POINTER(u64),
            C.POINTER(C.c_int64), C.POINTER(C.POINTER(C.c_uint64)),
            C.POINTER(u8p), C.POINTER(u64), C.POINTER(C.c_int64),
            C.POINTER(u8p), C.POINTER(u64), C.c_char_p, u64]
        l.szt_nopred_seal_packed.restype = C.c_int
        l.szt_nopred_seal_packed.argtypes = [
            C.POINTER(SztConfC), C.c_char_p, u64, C.c_char_p, u64, u64,
            C.c_void_p, u64, u64, C.POINTER(u8p), C.POINTER(u64),
            C.c_char_p, u64]
        l.szt_nopred_open.restype = C.c_int
        l.szt_nopred_open.argtypes = [
            C.POINTER(SztConfC), C.c_char_p, u64, C.c_void_p,
            C.POINTER(u8p), C.POINTER(u64), C.c_char_p, u64]
        i32pp = C.POINTER(C.POINTER(C.c_int32))
        f32pp = C.POINTER(C.POINTER(C.c_float))
        l.szt_blockwise_open.restype = C.c_int
        l.szt_blockwise_open.argtypes = [
            C.POINTER(SztConfC), C.c_char_p, u64, C.c_void_p,
            i32pp, C.POINTER(u64), i32pp, C.POINTER(u64),
            f32pp, C.POINTER(u64), f32pp, C.POINTER(u64),
            f32pp, C.POINTER(u64), C.c_char_p, u64]
        l.szt_interp_seal_packed.restype = C.c_int
        l.szt_interp_seal_packed.argtypes = [C.POINTER(SztConfC), C.c_char_p, u64, C.c_char_p,
                                             u64, u64, C.c_void_p, u64, u64, C.POINTER(u8p),
                                             C.POINTER(u64), C.c_char_p, u64]
        l.szt_blockwise_coef_chain.restype = C.c_int
        l.szt_blockwise_coef_chain.argtypes = [C.c_double, C.c_double, u64, C.c_void_p,
                                               C.c_void_p, u64, C.c_void_p, u64,
                                               C.c_void_p, C.c_char_p, u64]
        l.szt_blockwise_coef_chain_encode.restype = C.c_int
        l.szt_blockwise_coef_chain_encode.argtypes = [C.c_double, C.c_double, u64,
                                                      C.c_void_p, C.c_void_p,
                                                      C.c_void_p, C.c_char_p, u64]
        l.szt_blockwise_seal_packed.restype = C.c_int
        l.szt_blockwise_seal_packed.argtypes = [
            C.POINTER(SztConfC), C.c_char_p, u64, C.c_char_p, u64, u64,
            C.c_void_p, u64, C.c_void_p, u64, C.c_void_p, u64, C.c_void_p,
            u64, C.c_void_p, u64, u64, C.POINTER(u8p), C.POINTER(u64),
            C.c_char_p, u64]
        l.szt_blockwise_open_packed.restype = C.c_int
        l.szt_blockwise_open_packed.argtypes = [
            C.POINTER(SztConfC), C.c_char_p, u64,
            C.POINTER(u8p), C.POINTER(u64), C.POINTER(u64),
            C.POINTER(C.c_int64), C.POINTER(C.POINTER(C.c_uint32)),
            C.POINTER(u8p), C.POINTER(u64), C.POINTER(C.c_int64),
            i32pp, C.POINTER(u64), i32pp, C.POINTER(u64),
            f32pp, C.POINTER(u64), f32pp, C.POINTER(u64),
            f32pp, C.POINTER(u64), C.c_char_p, u64]
        l.szt_biomd_frame0.restype = C.c_int
        l.szt_biomd_frame0.argtypes = [C.c_double, C.c_int32, C.c_int32, C.c_void_p,
                                       u64, u64, C.c_void_p, C.c_void_p,
                                       f32pp, C.POINTER(u64), C.c_char_p, u64]
        l.szt_biomd_frame0_open.restype = C.c_int
        l.szt_biomd_frame0_open.argtypes = [C.c_double, C.c_int32, C.c_int32, C.c_void_p,
                                            u64, u64, C.c_void_p, u64, C.c_void_p,
                                            C.c_char_p, u64]
        l.szt_biomd_seal.restype = C.c_int
        l.szt_biomd_seal.argtypes = [C.POINTER(SztConfC), C.c_void_p, u64, C.c_void_p, u64,
                                     C.c_int32, u64, C.c_float, u64, C.POINTER(u8p),
                                     C.POINTER(u64), C.c_char_p, u64]
        l.szt_biomd_open.restype = C.c_int
        l.szt_biomd_open.argtypes = [C.POINTER(SztConfC), C.c_char_p, u64, C.c_void_p,
                                     C.POINTER(u64), f32pp, C.POINTER(u64),
                                     C.POINTER(C.c_int32), C.POINTER(u64),
                                     C.POINTER(C.c_float), C.c_char_p, u64]
        l.szt_zstd_head.restype = C.c_int
        l.szt_zstd_head.argtypes = [C.c_char_p, u64, C.c_void_p, u64, C.c_char_p, u64]
        l.szt_biomdxtc_seal.restype = C.c_int
        l.szt_biomdxtc_seal.argtypes = [C.POINTER(SztConfC), C.c_void_p, u64, C.c_void_p,
                                        u64, u64, C.c_float, u64, C.POINTER(u8p),
                                        C.POINTER(u64), C.c_char_p, u64]
        l.szt_biomdxtc_open.restype = C.c_int
        l.szt_biomdxtc_open.argtypes = [C.POINTER(SztConfC), C.c_char_p, u64, C.c_void_p,
                                        C.POINTER(u64), f32pp, C.POINTER(u64),
                                        C.POINTER(u64), C.POINTER(C.c_float),
                                        C.c_char_p, u64]
        _lib = l
    return _lib


def conf_to_c(conf: Config, nthreads: int = 0, engine_dtype: Optional[DataType] = None) -> SztConfC:
    c = SztConfC()
    c.engineType = int(engine_dtype if engine_dtype is not None else conf.dataType)
    for i, d in enumerate(conf.dims):
        c.dims[i] = d
    c.n_dims = conf.N
    c.cmprAlgo = int(conf.cmprAlgo)
    c.errorBoundMode = int(conf.errorBoundMode)
    c.dataType = int(conf.dataType)
    c.absErrorBound = conf.absErrorBound
    c.relErrorBound = conf.relErrorBound
    c.psnrErrorBound = conf.psnrErrorBound
    c.l2normErrorBound = conf.l2normErrorBound
    c.quantbinCnt = conf.quantbinCnt
    c.blockSize = conf.blockSize
    c.predDim = conf.predDim
    c.lorenzo = conf.lorenzo
    c.lorenzo2 = conf.lorenzo2
    c.regression = conf.regression
    c.regression2 = conf.regression2
    c.openmp = conf.openmp
    c.interpAlgo = int(conf.interpAlgo)
    c.interpDirection = conf.interpDirection
    c.interpAnchorStride = conf.interpAnchorStride
    c.interpAlpha = conf.interpAlpha
    c.interpBeta = conf.interpBeta
    c.nthreads = nthreads
    return c


def conf_from_c(c: SztConfC, conf: Config) -> None:
    """Fold engine-side config mutations (algo resolution, eb conversion,
    tuner decisions) back into the Python Config."""
    from .config import EB, INTERP_ALGO

    conf.dims = tuple(c.dims[i] for i in range(c.n_dims))
    conf.cmprAlgo = ALGO(c.cmprAlgo)
    conf.errorBoundMode = EB(c.errorBoundMode)
    conf.absErrorBound = c.absErrorBound
    conf.relErrorBound = c.relErrorBound
    conf.psnrErrorBound = c.psnrErrorBound
    conf.l2normErrorBound = c.l2normErrorBound
    conf.quantbinCnt = c.quantbinCnt
    conf.blockSize = c.blockSize
    conf.predDim = c.predDim
    conf.lorenzo = bool(c.lorenzo)
    conf.lorenzo2 = bool(c.lorenzo2)
    conf.regression = bool(c.regression)
    conf.regression2 = bool(c.regression2)
    conf.interpAlgo = INTERP_ALGO(c.interpAlgo)
    conf.interpDirection = c.interpDirection
    conf.interpAnchorStride = c.interpAnchorStride
    conf.interpAlpha = c.interpAlpha
    conf.interpBeta = c.interpBeta


def _take(buf_p, n) -> bytes:
    data = C.string_at(buf_p, n.value)
    lib().szt_free(buf_p)
    return data


def np_dtype_id(arr: np.ndarray) -> DataType:
    try:
        return _NP_TO_DTYPE[arr.dtype]
    except KeyError:
        raise TypeError(f"unsupported dtype {arr.dtype}; supported: f32/f64 and u/int 8-64")


def np_dtype_of(dt: DataType):
    return _DTYPE_TO_NP[dt]


def compress_payload(conf: Config, data: np.ndarray, cap: int, nthreads: int = 0) -> bytes:
    """Run the native dispatcher; mutates `conf` like the reference does."""
    data = np.ascontiguousarray(data)
    c = conf_to_c(conf, nthreads, engine_dtype=np_dtype_id(data))
    out = C.POINTER(C.c_uint8)()
    out_len = C.c_uint64()
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_compress(C.byref(c), data.ctypes.data_as(C.c_void_p), C.c_uint64(cap),
                            C.byref(out), C.byref(out_len), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_compress: {err.value.decode()}")
    conf_from_c(c, conf)
    return _take(out, out_len)


def decompress_payload(conf: Config, payload: bytes, dtype: Optional[DataType] = None) -> np.ndarray:
    dt = dtype if dtype is not None else conf.dataType
    c = conf_to_c(conf, engine_dtype=dt)
    out = np.empty(conf.num, dtype=np_dtype_of(dt))
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_decompress(C.byref(c), payload, C.c_uint64(len(payload)),
                              out.ctypes.data_as(C.c_void_p), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_decompress: {err.value.decode()}")
    return out.reshape(conf.dims)


def huff_encode(bins: np.ndarray) -> bytes:
    bins = np.ascontiguousarray(bins, dtype=np.int32)
    out = C.POINTER(C.c_uint8)()
    out_len = C.c_uint64()
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_huff_encode(bins.ctypes.data_as(C.c_void_p), C.c_uint64(bins.size),
                               C.byref(out), C.byref(out_len), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_huff_encode: {err.value.decode()}")
    return _take(out, out_len)


def huff_decode(blob: bytes, max_count: int) -> np.ndarray:
    out = np.empty(max_count, dtype=np.int32)
    n = C.c_uint64(max_count)
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_huff_decode(blob, C.c_uint64(len(blob)),
                               out.ctypes.data_as(C.c_void_p), C.byref(n), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_huff_decode: {err.value.decode()}")
    return out[: n.value]


def interp_emit(conf: Config, bins_grid: np.ndarray, orig: np.ndarray):
    """Grid-order bins + original data -> (stream int32, unpred literals)."""
    dt = np_dtype_id(orig)
    c = conf_to_c(conf, engine_dtype=dt)
    bins_grid = np.ascontiguousarray(bins_grid, dtype=np.int32)
    orig = np.ascontiguousarray(orig)
    stream = np.empty(conf.num, dtype=np.int32)
    out = C.POINTER(C.c_uint8)()
    nbytes = C.c_uint64()
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_interp_emit(C.byref(c), bins_grid.ctypes.data_as(C.c_void_p),
                               orig.ctypes.data_as(C.c_void_p),
                               stream.ctypes.data_as(C.c_void_p),
                               C.byref(out), C.byref(nbytes), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_interp_emit: {err.value.decode()}")
    unpred = np.frombuffer(_take(out, nbytes), dtype=orig.dtype)
    return stream, unpred


def interp_place(conf: Config, stream: np.ndarray, unpred: np.ndarray, dtype):
    """Stream-order bins + literals -> (bins grid, literal grid)."""
    dt = np_dtype_id(np.empty(0, dtype=dtype))
    c = conf_to_c(conf, engine_dtype=dt)
    stream = np.ascontiguousarray(stream, dtype=np.int32)
    unpred = np.ascontiguousarray(unpred, dtype=dtype)
    bins_grid = np.zeros(conf.dims, dtype=np.int32)
    literal = np.zeros(conf.dims, dtype=dtype)
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_interp_place(C.byref(c), stream.ctypes.data_as(C.c_void_p),
                                unpred.ctypes.data_as(C.c_void_p),
                                bins_grid.ctypes.data_as(C.c_void_p),
                                literal.ctypes.data_as(C.c_void_p), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_interp_place: {err.value.decode()}")
    return bins_grid, literal


def interp_seal(conf: Config, stream: np.ndarray, unpred: np.ndarray, cap: int) -> bytes:
    """Stream + literals -> archive payload (byte-identical to host path)."""
    dt = np_dtype_id(unpred)
    c = conf_to_c(conf, engine_dtype=dt)
    stream = np.ascontiguousarray(stream, dtype=np.int32)
    unpred = np.ascontiguousarray(unpred)
    out = C.POINTER(C.c_uint8)()
    out_len = C.c_uint64()
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_interp_seal(C.byref(c), stream.ctypes.data_as(C.c_void_p),
                               C.c_uint64(stream.size), unpred.ctypes.data_as(C.c_void_p),
                               C.c_uint64(unpred.size), C.c_uint64(cap),
                               C.byref(out), C.byref(out_len), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_interp_seal: {err.value.decode()}")
    conf_from_c(c, conf)
    return _take(out, out_len)


def interp_open(conf: Config, payload: bytes, dtype):
    """Payload -> (stream, unpred, conf updated with archived params)."""
    dt = np_dtype_id(np.empty(0, dtype=dtype))
    c = conf_to_c(conf, engine_dtype=dt)
    stream = np.empty(conf.num, dtype=np.int32)
    out = C.POINTER(C.c_uint8)()
    nbytes = C.c_uint64()
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_interp_open(C.byref(c), payload, C.c_uint64(len(payload)),
                               stream.ctypes.data_as(C.c_void_p),
                               C.byref(out), C.byref(nbytes), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_interp_open: {err.value.decode()}")
    unpred = np.frombuffer(_take(out, nbytes), dtype=dtype)
    conf_from_c(c, conf)
    return stream, unpred


def perm_emit(perm: np.ndarray, bins_grid: np.ndarray, orig: np.ndarray):
    """stream[i] = bins[perm[i]]; unpred = orig[perm[i]] where bins==0 (stream
    order). One C++ pass — replaces three numpy fancy-indexing passes."""
    n = perm.size
    stream = np.empty(n, dtype=np.int32)
    unpred = np.empty(n, dtype=orig.dtype)
    u = C.c_uint64()
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_perm_emit(perm.ctypes.data_as(C.c_void_p),
                             bins_grid.ctypes.data_as(C.c_void_p),
                             orig.ctypes.data_as(C.c_void_p), C.c_uint64(n),
                             C.c_uint32(orig.dtype.itemsize),
                             stream.ctypes.data_as(C.c_void_p),
                             unpred.ctypes.data_as(C.c_void_p), C.byref(u), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_perm_emit: {err.value.decode()}")
    return stream, np.ascontiguousarray(unpred[: u.value])


def perm_place(perm: np.ndarray, stream: np.ndarray, unpred: np.ndarray, dims, dtype):
    """Inverse of perm_emit: (bins grid, literal grid) from stream + literals."""
    n = perm.size
    bins_grid = np.empty(n, dtype=np.int32)
    literal = np.empty(n, dtype=dtype)
    stream = np.ascontiguousarray(stream, dtype=np.int32)
    unpred = np.ascontiguousarray(unpred, dtype=dtype)
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_perm_place(perm.ctypes.data_as(C.c_void_p),
                              stream.ctypes.data_as(C.c_void_p),
                              unpred.ctypes.data_as(C.c_void_p), C.c_uint64(n),
                              C.c_uint32(np.dtype(dtype).itemsize),
                              bins_grid.ctypes.data_as(C.c_void_p),
                              literal.ctypes.data_as(C.c_void_p), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_perm_place: {err.value.decode()}")
    return bins_grid.reshape(dims), literal.reshape(dims)


class DeepTreeError(RuntimeError):
    """Huffman tree exceeds the device packer's 32-bit code limit."""


def huff_table(offset: int, freq: np.ndarray):
    """Histogram -> (codes u32 right-aligned, lens u8, serialized tree bytes)
    with the reference's tree-build tie-breaking. freq follows the reference
    convention: freq[s] = count of symbol offset+s, trailing sentinel slot."""
    freq = np.ascontiguousarray(freq, dtype=np.uint64)
    n = freq.size
    codes = np.empty(n, dtype=np.uint32)
    lens = np.empty(n, dtype=np.uint8)
    tree = C.POINTER(C.c_uint8)()
    tree_len = C.c_uint64()
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_huff_table(C.c_int64(offset), freq.ctypes.data_as(C.c_void_p),
                              C.c_uint64(n), codes.ctypes.data_as(C.c_void_p),
                              lens.ctypes.data_as(C.c_void_p),
                              C.byref(tree), C.byref(tree_len), err, _ERRCAP)
    if rc == 1:
        raise DeepTreeError("huffman code length > 32 bits")
    if rc != 0:
        raise RuntimeError(f"szt_huff_table: {err.value.decode()}")
    return codes, lens, _take(tree, tree_len)


def interp_seal_packed(conf: Config, tree: bytes, bits: bytes, bit_count: int,
                       count: int, unpred: np.ndarray, cap: int) -> bytes:
    """Device-packed pieces -> payload (byte-identical to interp_seal)."""
    dt = np_dtype_id(unpred)
    c = conf_to_c(conf, engine_dtype=dt)
    unpred = np.ascontiguousarray(unpred)
    out = C.POINTER(C.c_uint8)()
    out_len = C.c_uint64()
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_interp_seal_packed(C.byref(c), tree, C.c_uint64(len(tree)),
                                      bits, C.c_uint64(bit_count), C.c_uint64(count),
                                      unpred.ctypes.data_as(C.c_void_p),
                                      C.c_uint64(unpred.size), C.c_uint64(cap),
                                      C.byref(out), C.byref(out_len), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_interp_seal_packed: {err.value.decode()}")
    conf_from_c(c, conf)
    return _take(out, out_len)


def open_packed(conf: Config, payload: bytes, dtype, algo: int = 2):
    """Payload -> raw entropy pieces WITHOUT the Huffman bit-walk (device
    decode path): (bits bytes, count, offset, codes u64 right-aligned, lens
    u8, const_sym, unpred). const_sym >= 0 marks a constant stream (empty
    bits). algo: 2 = INTERP, 3 = NOPRED. conf picks up the archived params.
    Codes of up to 64 bits are exported (szt_open_packed64), since the
    port's encode writes them."""
    dt = np_dtype_id(np.empty(0, dtype=dtype))
    c = conf_to_c(conf, engine_dtype=dt)
    bits_p = C.POINTER(C.c_uint8)()
    bits_len = C.c_uint64()
    count = C.c_uint64()
    offset = C.c_int64()
    codes_p = C.POINTER(C.c_uint64)()
    lens_p = C.POINTER(C.c_uint8)()
    ncodes = C.c_uint64()
    const_sym = C.c_int64()
    un_p = C.POINTER(C.c_uint8)()
    un_len = C.c_uint64()
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_open_packed64(
        C.byref(c), C.c_int(algo), payload, C.c_uint64(len(payload)),
        C.byref(bits_p), C.byref(bits_len), C.byref(count), C.byref(offset),
        C.byref(codes_p), C.byref(lens_p), C.byref(ncodes),
        C.byref(const_sym), C.byref(un_p), C.byref(un_len), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_open_packed: {err.value.decode()}")
    bits = _take(bits_p, bits_len)
    n = int(ncodes.value)
    codes = np.ctypeslib.as_array(codes_p, shape=(n,)).astype(np.uint64, copy=True) \
        if n else np.zeros(0, np.uint64)
    lib().szt_free(C.cast(codes_p, C.c_void_p))
    lens = np.frombuffer(_take(lens_p, ncodes), dtype=np.uint8)
    unpred = np.frombuffer(_take(un_p, un_len), dtype=dtype)
    conf_from_c(c, conf)
    return (bits, int(count.value), int(offset.value), codes, lens,
            int(const_sym.value), unpred)


def nopred_seal_packed(conf: Config, tree: bytes, bits: bytes, bit_count: int,
                       count: int, unpred: np.ndarray, cap: int) -> bytes:
    """Device-packed pieces -> NOPRED payload (byte-identical to the host
    engine's compress_nopred seal of the same bins)."""
    dt = np_dtype_id(unpred)
    c = conf_to_c(conf, engine_dtype=dt)
    unpred = np.ascontiguousarray(unpred)
    out = C.POINTER(C.c_uint8)()
    out_len = C.c_uint64()
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_nopred_seal_packed(C.byref(c), tree, C.c_uint64(len(tree)),
                                      bits, C.c_uint64(bit_count), C.c_uint64(count),
                                      unpred.ctypes.data_as(C.c_void_p),
                                      C.c_uint64(unpred.size), C.c_uint64(cap),
                                      C.byref(out), C.byref(out_len), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_nopred_seal_packed: {err.value.decode()}")
    conf_from_c(c, conf)
    return _take(out, out_len)


def nopred_open(conf: Config, payload: bytes, dtype):
    """NOPRED payload -> (element-order bins, unpred literals); conf updated
    with the archived quantizer params."""
    dt = np_dtype_id(np.empty(0, dtype=dtype))
    c = conf_to_c(conf, engine_dtype=dt)
    bins = np.empty(conf.num, dtype=np.int32)
    out = C.POINTER(C.c_uint8)()
    nbytes = C.c_uint64()
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_nopred_open(C.byref(c), payload, C.c_uint64(len(payload)),
                               bins.ctypes.data_as(C.c_void_p),
                               C.byref(out), C.byref(nbytes), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_nopred_open: {err.value.decode()}")
    unpred = np.frombuffer(_take(out, nbytes), dtype=dtype)
    conf_from_c(c, conf)
    return bins, unpred


def blockwise_seal(conf: Config, bins: np.ndarray, selection: np.ndarray,
                   reg_bins: np.ndarray, ql_unpred: np.ndarray,
                   qi_unpred: np.ndarray, unpred: np.ndarray, cap: int) -> bytes:
    """Device-computed blockwise streams -> LORENZO_REG payload (identical to
    the host sweep's seal)."""
    c = conf_to_c(conf, engine_dtype=DataType.FLOAT)
    arrs = [np.ascontiguousarray(bins, np.int32),
            np.ascontiguousarray(selection, np.int32),
            np.ascontiguousarray(reg_bins, np.int32),
            np.ascontiguousarray(ql_unpred, np.float32),
            np.ascontiguousarray(qi_unpred, np.float32),
            np.ascontiguousarray(unpred, np.float32)]
    out = C.POINTER(C.c_uint8)()
    out_len = C.c_uint64()
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_blockwise_seal(
        C.byref(c),
        arrs[0].ctypes.data_as(C.c_void_p), C.c_uint64(arrs[0].size),
        arrs[1].ctypes.data_as(C.c_void_p), C.c_uint64(arrs[1].size),
        arrs[2].ctypes.data_as(C.c_void_p), C.c_uint64(arrs[2].size),
        arrs[3].ctypes.data_as(C.c_void_p), C.c_uint64(arrs[3].size),
        arrs[4].ctypes.data_as(C.c_void_p), C.c_uint64(arrs[4].size),
        arrs[5].ctypes.data_as(C.c_void_p), C.c_uint64(arrs[5].size),
        C.c_uint64(cap), C.byref(out), C.byref(out_len), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_blockwise_seal: {err.value.decode()}")
    conf_from_c(c, conf)
    return _take(out, out_len)


def blockwise_open(conf: Config, payload: bytes):
    """LORENZO_REG payload -> device-sweep streams
    (bins block-sweep order, selection, reg_bins, ql_unpred, qi_unpred,
    unpred). Mutates conf with the archived eb/quantbinCnt."""
    c = conf_to_c(conf, engine_dtype=DataType.FLOAT)
    bins = np.empty(conf.num, dtype=np.int32)
    outs = [C.POINTER(t)() for t in
            (C.c_int32, C.c_int32, C.c_float, C.c_float, C.c_float)]
    ns = [C.c_uint64() for _ in range(5)]
    err = C.create_string_buffer(_ERRCAP)
    args = [C.byref(c), payload, C.c_uint64(len(payload)),
            bins.ctypes.data_as(C.c_void_p)]
    for o, n in zip(outs, ns):
        args += [C.byref(o), C.byref(n)]
    rc = lib().szt_blockwise_open(*args, err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_blockwise_open: {err.value.decode()}")
    res = []
    for o, n, dt in zip(outs, ns, (np.int32, np.int32, np.float32,
                                   np.float32, np.float32)):
        arr = np.ctypeslib.as_array(o, shape=(n.value,)).astype(dt, copy=True)
        lib().szt_free(C.cast(o, C.c_void_p))
        res.append(arr)
    conf_from_c(c, conf)
    return (bins, *res)


def blockwise_coef_chain(eb_ql: float, eb_qi: float, regb: np.ndarray,
                         ql_lit: np.ndarray, qi_lit: np.ndarray) -> np.ndarray:
    """Replay the sequential regression coefficient chain (native):
    regb (ncommit, 4) bins + the two literal streams -> reconstructed
    coefficients (ncommit, 4) f32 in commit order."""
    regb = np.ascontiguousarray(regb, np.int32).reshape(-1, 4)
    ql_lit = np.ascontiguousarray(ql_lit, np.float32)
    qi_lit = np.ascontiguousarray(qi_lit, np.float32)
    out = np.empty((regb.shape[0], 4), np.float32)
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_blockwise_coef_chain(
        C.c_double(eb_ql), C.c_double(eb_qi), C.c_uint64(regb.shape[0]),
        regb.ctypes.data_as(C.c_void_p),
        ql_lit.ctypes.data_as(C.c_void_p), C.c_uint64(ql_lit.size),
        qi_lit.ctypes.data_as(C.c_void_p), C.c_uint64(qi_lit.size),
        out.ctypes.data_as(C.c_void_p), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_blockwise_coef_chain: {err.value.decode()}")
    return out


def blockwise_coef_chain_encode(eb_ql: float, eb_qi: float,
                                raw: np.ndarray):
    """Run the sequential regression coefficient chain forward (native):
    raw coefficients (ncommit, 4) f32 in commit order -> (bins (ncommit, 4)
    i32, recon (ncommit, 4) f32). Literals are raw[bins == 0] in the k-inner
    commit order (ql: k<3, qi: k==3)."""
    raw = np.ascontiguousarray(raw, np.float32).reshape(-1, 4)
    bins = np.empty((raw.shape[0], 4), np.int32)
    recon = np.empty((raw.shape[0], 4), np.float32)
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_blockwise_coef_chain_encode(
        C.c_double(eb_ql), C.c_double(eb_qi), C.c_uint64(raw.shape[0]),
        raw.ctypes.data_as(C.c_void_p), bins.ctypes.data_as(C.c_void_p),
        recon.ctypes.data_as(C.c_void_p), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_blockwise_coef_chain_encode: {err.value.decode()}")
    return bins, recon


def blockwise_seal_packed(conf: Config, tree: bytes, bits: bytes,
                          bit_count: int, count: int, sel: np.ndarray,
                          regb: np.ndarray, qlu: np.ndarray, qiu: np.ndarray,
                          unpred: np.ndarray, cap: int) -> bytes:
    """Device-packed bins bitstream + host side streams -> LORENZO_REG
    payload byte-identical to blockwise_seal's."""
    c = conf_to_c(conf, engine_dtype=DataType.FLOAT)
    sel = np.ascontiguousarray(sel, np.int32)
    regb = np.ascontiguousarray(regb, np.int32)
    qlu = np.ascontiguousarray(qlu, np.float32)
    qiu = np.ascontiguousarray(qiu, np.float32)
    unpred = np.ascontiguousarray(unpred, np.float32)
    out = C.POINTER(C.c_uint8)()
    out_len = C.c_uint64()
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_blockwise_seal_packed(
        C.byref(c), tree, C.c_uint64(len(tree)), bits, C.c_uint64(bit_count),
        C.c_uint64(count),
        sel.ctypes.data_as(C.c_void_p), C.c_uint64(sel.size),
        regb.ctypes.data_as(C.c_void_p), C.c_uint64(regb.size),
        qlu.ctypes.data_as(C.c_void_p), C.c_uint64(qlu.size),
        qiu.ctypes.data_as(C.c_void_p), C.c_uint64(qiu.size),
        unpred.ctypes.data_as(C.c_void_p), C.c_uint64(unpred.size),
        C.c_uint64(cap), C.byref(out), C.byref(out_len), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_blockwise_seal_packed: {err.value.decode()}")
    conf_from_c(c, conf)
    return _take(out, out_len)


def blockwise_open_packed(conf: Config, payload: bytes):
    """LORENZO_REG payload -> raw bins bitstream + code table + side streams
    WITHOUT the bins Huffman walk (for the on-chip bit-walk): returns
    (bits bytes, count, offset, codes u32, lens u8, const_sym,
    sel, regb, qlu, qiu, unpred)."""
    c = conf_to_c(conf, engine_dtype=DataType.FLOAT)
    bits_p = C.POINTER(C.c_uint8)()
    bits_len = C.c_uint64()
    count = C.c_uint64()
    offset = C.c_int64()
    codes_p = C.POINTER(C.c_uint32)()
    lens_p = C.POINTER(C.c_uint8)()
    ncodes = C.c_uint64()
    const_sym = C.c_int64()
    i32p = C.POINTER(C.c_int32)
    f32p = C.POINTER(C.c_float)
    sel_p, regb_p = i32p(), i32p()
    qlu_p, qiu_p, unp_p = f32p(), f32p(), f32p()
    nsel, nregb, nqlu, nqiu, nun = (C.c_uint64() for _ in range(5))
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_blockwise_open_packed(
        C.byref(c), payload, C.c_uint64(len(payload)),
        C.byref(bits_p), C.byref(bits_len), C.byref(count), C.byref(offset),
        C.byref(codes_p), C.byref(lens_p), C.byref(ncodes),
        C.byref(const_sym),
        C.byref(sel_p), C.byref(nsel), C.byref(regb_p), C.byref(nregb),
        C.byref(qlu_p), C.byref(nqlu), C.byref(qiu_p), C.byref(nqiu),
        C.byref(unp_p), C.byref(nun), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_blockwise_open_packed: {err.value.decode()}")
    bits = _take(bits_p, bits_len)
    n = int(ncodes.value)
    codes = np.ctypeslib.as_array(codes_p, shape=(n,)).copy() if n else \
        np.zeros(0, np.uint32)
    lens = np.ctypeslib.as_array(lens_p, shape=(n,)).copy() if n else \
        np.zeros(0, np.uint8)
    lib().szt_free(C.cast(codes_p, C.c_void_p))
    lib().szt_free(C.cast(lens_p, C.c_void_p))
    res = []
    for p, cnt, dt in ((sel_p, nsel, np.int32), (regb_p, nregb, np.int32),
                       (qlu_p, nqlu, np.float32), (qiu_p, nqiu, np.float32),
                       (unp_p, nun, np.float32)):
        arr = np.ctypeslib.as_array(p, shape=(int(cnt.value),)).astype(
            dt, copy=True) if cnt.value else np.zeros(0, dt)
        lib().szt_free(C.cast(p, C.c_void_p))
        res.append(arr)
    conf_from_c(c, conf)
    return (bits, int(count.value), int(offset.value), codes, lens,
            int(const_sym.value), *res)


def biomd_frame0(eb: float, radius: int, site: int, frame: np.ndarray):
    """Scalar frame-0 atom chain (native): (atoms, cols) f32 frame ->
    (bins i32, recon f32, unpred f32) in scan order."""
    frame = np.ascontiguousarray(frame, np.float32)
    atoms, cols = frame.shape
    bins = np.empty(atoms * cols, np.int32)
    recon = np.empty(atoms * cols, np.float32)
    up = C.POINTER(C.c_float)()
    nun = C.c_uint64()
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_biomd_frame0(
        C.c_double(eb), C.c_int32(radius), C.c_int32(site),
        frame.ctypes.data_as(C.c_void_p), C.c_uint64(atoms), C.c_uint64(cols),
        bins.ctypes.data_as(C.c_void_p), recon.ctypes.data_as(C.c_void_p),
        C.byref(up), C.byref(nun), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_biomd_frame0: {err.value.decode()}")
    unpred = np.ctypeslib.as_array(up, shape=(nun.value,)).astype(np.float32, copy=True)
    lib().szt_free(C.cast(up, C.c_void_p))
    return bins.reshape(atoms, cols), recon.reshape(atoms, cols), unpred


def biomd_frame0_open(eb: float, radius: int, site: int, bins: np.ndarray,
                      unpred: np.ndarray) -> np.ndarray:
    """Frame-0 recover chain (native): (atoms, cols) bins + that frame's
    unpred slice -> reconstructed frame."""
    bins = np.ascontiguousarray(bins, np.int32)
    atoms, cols = bins.shape
    unpred = np.ascontiguousarray(unpred, np.float32)
    out = np.empty(atoms * cols, np.float32)
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_biomd_frame0_open(
        C.c_double(eb), C.c_int32(radius), C.c_int32(site),
        bins.ctypes.data_as(C.c_void_p), C.c_uint64(atoms), C.c_uint64(cols),
        unpred.ctypes.data_as(C.c_void_p), C.c_uint64(unpred.size),
        out.ctypes.data_as(C.c_void_p), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_biomd_frame0_open: {err.value.decode()}")
    return out.reshape(atoms, cols)


def biomd_seal(conf: Config, bins: np.ndarray, unpred: np.ndarray, site: int,
               first_fill: int, fill: float, cap: int) -> bytes:
    """Device-computed BIOMD bins + codec state -> payload (HuffmanV2 + zstd),
    byte-identical to the host engine's."""
    c = conf_to_c(conf, engine_dtype=DataType.FLOAT)
    bins = np.ascontiguousarray(bins, np.int32)
    unpred = np.ascontiguousarray(unpred, np.float32)
    out = C.POINTER(C.c_uint8)()
    out_len = C.c_uint64()
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_biomd_seal(
        C.byref(c), bins.ctypes.data_as(C.c_void_p), C.c_uint64(bins.size),
        unpred.ctypes.data_as(C.c_void_p), C.c_uint64(unpred.size),
        C.c_int32(site), C.c_uint64(first_fill), C.c_float(fill),
        C.c_uint64(cap), C.byref(out), C.byref(out_len), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_biomd_seal: {err.value.decode()}")
    conf_from_c(c, conf)
    return _take(out, out_len)


def biomd_open(conf: Config, payload: bytes):
    """ALGO_BIOMD payload -> (bins i32, unpred f32, site, first_fill, fill)."""
    c = conf_to_c(conf, engine_dtype=DataType.FLOAT)
    bins = np.empty(conf.num, dtype=np.int32)
    nbins = C.c_uint64()
    up = C.POINTER(C.c_float)()
    nun = C.c_uint64()
    site = C.c_int32()
    first_fill = C.c_uint64()
    fill = C.c_float()
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_biomd_open(
        C.byref(c), payload, C.c_uint64(len(payload)),
        bins.ctypes.data_as(C.c_void_p), C.byref(nbins), C.byref(up),
        C.byref(nun), C.byref(site), C.byref(first_fill), C.byref(fill),
        err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_biomd_open: {err.value.decode()}")
    conf_from_c(c, conf)
    unpred = np.ctypeslib.as_array(up, shape=(nun.value,)).astype(np.float32, copy=True)
    lib().szt_free(C.cast(up, C.c_void_p))
    return (bins[:nbins.value], unpred, int(site.value),
            int(first_fill.value), float(fill.value))


def biomd_header(payload: bytes):
    """An ALGO_BIOMD payload's codec header, (site, first_fill, fill), read
    from the first 16 bytes of its zstd frame without opening the rest
    (biomd.hpp BioMDCodec::save: int32 site, u64 first fill frame, f32
    fill)."""
    head = np.empty(16, np.uint8)
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_zstd_head(payload, C.c_uint64(len(payload)),
                             head.ctypes.data_as(C.c_void_p), C.c_uint64(head.size), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_zstd_head: {err.value.decode()}")
    b = head.tobytes()
    return (int(np.frombuffer(b, "<i4", 1, 0)[0]), int(np.frombuffer(b, "<u8", 1, 4)[0]),
            float(np.frombuffer(b, "<f4", 1, 12)[0]))


def biomdxtc_seal(conf: Config, bins: np.ndarray, unpred: np.ndarray,
                  first_fill: int, fill: float, cap: int) -> bytes:
    """Device-computed BIOMDXTC stored bins (offset by -kXtcRadius) + literal
    stream -> payload (XTC triplet coder, lossless bypass), byte-identical to
    the host engine's compress_biomdxtc."""
    c = conf_to_c(conf, engine_dtype=DataType.FLOAT)
    bins = np.ascontiguousarray(bins, np.int32)
    unpred = np.ascontiguousarray(unpred, np.float32)
    out = C.POINTER(C.c_uint8)()
    out_len = C.c_uint64()
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_biomdxtc_seal(
        C.byref(c), bins.ctypes.data_as(C.c_void_p), C.c_uint64(bins.size),
        unpred.ctypes.data_as(C.c_void_p), C.c_uint64(unpred.size),
        C.c_uint64(first_fill), C.c_float(fill),
        C.c_uint64(cap), C.byref(out), C.byref(out_len), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_biomdxtc_seal: {err.value.decode()}")
    conf_from_c(c, conf)
    return _take(out, out_len)


def biomdxtc_open(conf: Config, payload: bytes):
    """ALGO_BIOMDXTC payload -> (stored bins i32, unpred f32, first_fill,
    fill)."""
    c = conf_to_c(conf, engine_dtype=DataType.FLOAT)
    bins = np.empty(conf.num, dtype=np.int32)
    nbins = C.c_uint64()
    up = C.POINTER(C.c_float)()
    nun = C.c_uint64()
    first_fill = C.c_uint64()
    fill = C.c_float()
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_biomdxtc_open(
        C.byref(c), payload, C.c_uint64(len(payload)),
        bins.ctypes.data_as(C.c_void_p), C.byref(nbins), C.byref(up),
        C.byref(nun), C.byref(first_fill), C.byref(fill), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_biomdxtc_open: {err.value.decode()}")
    conf_from_c(c, conf)
    unpred = np.ctypeslib.as_array(up, shape=(nun.value,)).astype(np.float32, copy=True)
    lib().szt_free(C.cast(up, C.c_void_p))
    return (bins[:nbins.value], unpred, int(first_fill.value),
            float(fill.value))


def interp_order(conf: Config) -> np.ndarray:
    """Stream-order permutation: perm[i] = flat grid index of stream slot i.

    Data-independent, so cache by (dims, direction, anchorStride); emit/place
    then become numpy gathers/scatters instead of the scalar C++ walk."""
    c = conf_to_c(conf, engine_dtype=DataType.FLOAT)
    out = np.empty(conf.num, dtype=np.int64)
    err = C.create_string_buffer(_ERRCAP)
    l = lib()
    if not hasattr(l, "_order_bound"):
        l.szt_interp_order.restype = C.c_int
        l.szt_interp_order.argtypes = [C.POINTER(SztConfC), C.c_void_p, C.c_char_p, C.c_uint64]
        l._order_bound = True
    rc = l.szt_interp_order(C.byref(c), out.ctypes.data_as(C.c_void_p), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_interp_order: {err.value.decode()}")
    return out


def tune_interp(conf: Config, data: np.ndarray) -> None:
    """Run the INTERP_LORENZO tuner decision; mutates conf."""
    data = np.ascontiguousarray(data)
    c = conf_to_c(conf, engine_dtype=np_dtype_id(data))
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_tune_interp(C.byref(c), data.ctypes.data_as(C.c_void_p), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_tune_interp: {err.value.decode()}")
    conf_from_c(c, conf)


def zstd_compress(data: bytes) -> bytes:
    out = C.POINTER(C.c_uint8)()
    out_len = C.c_uint64()
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_zstd_compress(data, C.c_uint64(len(data)), C.byref(out), C.byref(out_len),
                                 err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_zstd_compress: {err.value.decode()}")
    return _take(out, out_len)


def zstd_decompress(blob: bytes) -> bytes:
    out = C.POINTER(C.c_uint8)()
    out_len = C.c_uint64()
    err = C.create_string_buffer(_ERRCAP)
    rc = lib().szt_zstd_decompress(blob, C.c_uint64(len(blob)), C.byref(out), C.byref(out_len),
                                   err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"szt_zstd_decompress: {err.value.decode()}")
    return _take(out, out_len)
