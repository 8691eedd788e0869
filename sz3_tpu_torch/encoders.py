"""Secondary entropy coders and the byte-truncation compressor (counterpart
of sz3_tpu/encoders.py): host coders in the port's own engine.

Python surface over csrc/engine/szt/encoders_extra.hpp, mirroring the reference's
registered-but-off-default-path modules:
  - arithmetic_encode/decode — 44-bit range coder, <=4096 states, optional
    zigzag transform (reference encoder/ArithmeticEncoder.hpp)
  - runlength_encode/decode  — (value, count) pairs (RunlengthEncoder.hpp)
  - truncate_compress/decompress — keep top N bytes of each float -> zstd
    (compressor/specialized/SZTruncateCompressor.hpp)
The default-path Huffman coder lives in sz3_tpu_torch.runtime (huff_encode/decode);
the device entropy stage in ops/entropy_device.py and ops/entropy_decode.py.
"""

from __future__ import annotations

import ctypes as C

import numpy as np

from .runtime import lib as _lib, _take, _ERRCAP

_bound = False


def _l():
    global _bound
    l = _lib()
    if not _bound:
        u8p = C.POINTER(C.c_uint8)
        u64 = C.c_uint64
        i32 = C.c_int32
        l.szt_ari_encode.restype = C.c_int
        l.szt_ari_encode.argtypes = [C.c_void_p, u64, i32, i32, C.POINTER(u8p), C.POINTER(u64),
                                     C.c_char_p, u64]
        l.szt_ari_decode.restype = C.c_int
        l.szt_ari_decode.argtypes = [C.c_char_p, u64, i32, C.c_void_p, u64, C.c_char_p, u64]
        l.szt_rle_encode.restype = C.c_int
        l.szt_rle_encode.argtypes = [C.c_void_p, u64, C.POINTER(u8p), C.POINTER(u64),
                                     C.c_char_p, u64]
        l.szt_rle_decode.restype = C.c_int
        l.szt_rle_decode.argtypes = [C.c_char_p, u64, C.c_void_p, u64, C.c_char_p, u64]
        l.szt_truncate_compress.restype = C.c_int
        l.szt_truncate_compress.argtypes = [C.c_void_p, u64, i32, C.POINTER(u8p), C.POINTER(u64),
                                            C.c_char_p, u64]
        l.szt_truncate_decompress.restype = C.c_int
        l.szt_truncate_decompress.argtypes = [C.c_char_p, u64, i32, C.c_void_p, u64,
                                              C.c_char_p, u64]
        _bound = True
    return l


def _call_enc(fn, arr, *args):
    out = C.POINTER(C.c_uint8)()
    out_len = C.c_uint64()
    err = C.create_string_buffer(_ERRCAP)
    rc = fn(arr.ctypes.data_as(C.c_void_p), arr.size, *args, C.byref(out), C.byref(out_len),
            err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(err.value.decode())
    return _take(out, out_len)


def arithmetic_encode(bins: np.ndarray, state_num: int, transform: bool = False) -> bytes:
    bins = np.ascontiguousarray(bins, dtype=np.int32)
    return _call_enc(_l().szt_ari_encode, bins, state_num, int(transform))


def arithmetic_decode(blob: bytes, count: int, transform: bool = False) -> np.ndarray:
    out = np.empty(count, dtype=np.int32)
    err = C.create_string_buffer(_ERRCAP)
    rc = _l().szt_ari_decode(blob, len(blob), int(transform),
                             out.ctypes.data_as(C.c_void_p), count, err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(err.value.decode())
    return out


def runlength_encode(bins: np.ndarray) -> bytes:
    bins = np.ascontiguousarray(bins, dtype=np.int32)
    return _call_enc(_l().szt_rle_encode, bins)


def runlength_decode(blob: bytes, count: int) -> np.ndarray:
    out = np.empty(count, dtype=np.int32)
    err = C.create_string_buffer(_ERRCAP)
    rc = _l().szt_rle_decode(blob, len(blob), out.ctypes.data_as(C.c_void_p), count,
                             err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(err.value.decode())
    return out


def truncate_compress(data: np.ndarray, byte_len: int = 2) -> bytes:
    """Keep the top `byte_len` bytes of each float32, zstd the planes."""
    data = np.ascontiguousarray(data, dtype=np.float32)
    return _call_enc(_l().szt_truncate_compress, data, byte_len)


def truncate_decompress(blob: bytes, count: int, byte_len: int = 2) -> np.ndarray:
    out = np.empty(count, dtype=np.float32)
    err = C.create_string_buffer(_ERRCAP)
    rc = _l().szt_truncate_decompress(blob, len(blob), byte_len,
                                      out.ctypes.data_as(C.c_void_p), count, err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(err.value.decode())
    return out
