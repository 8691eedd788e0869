"""Top-level compress/decompress: the SZ3 container around the payload
(reference api/sz.hpp:7-19; counterpart of sz3_tpu/api.py), all little-endian:

  [magic u32][data-version u32][payload size u64] [payload] [Config]

``device`` defaults to ``"cuda"``: the passes and kernels run on the current
CUDA device, and the call raises when there is none. ``device="cpu"`` has to
be asked for, and runs the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple, Union

import numpy as np
import torch

from . import runtime
from .algos.torch_backend import compress_payload_torch, decompress_payload_torch
from .config import Config, DataType, SZ3_MAGIC_NUMBER, version_int, version_str
from .utils import trace
# on_device stays public here, for entry, preprocess and the examples
from .utils.copies import device_of as _device, on_device

_HDR = struct.Struct("<IIQ")
_DATA_VER = version_int((3, 3, 2))


def zstd_compress_bound(n: int) -> int:
    """ZSTD_COMPRESSBOUND (zstd.h macro)."""
    margin = ((128 << 10) - n) >> 11 if n < (128 << 10) else 0
    return n + (n >> 8) + margin


def compress_size_bound(conf: Config, itemsize: int = 0) -> int:
    """Worst-case archive size (reference api/impl/SZImpl.hpp:33-44).

    `itemsize` is the byte width of the actual element type (the reference is
    templated on T); falls back to conf.dataType when omitted.
    """
    item = itemsize or np.dtype(runtime.np_dtype_of(conf.dataType)).itemsize
    if conf.openmp:
        # chunk-level worst case (SZImplOMP.hpp:188-209), computed generously
        n_chunks = min(64, conf.dims[0]) if conf.dims else 1
        return (4096 + 4 + n_chunks * (conf.size_est() + 8) +
                zstd_compress_bound(conf.num * item) + n_chunks * 4096)
    return 4096 + conf.size_est() + zstd_compress_bound(conf.num * item)


def _conf_for(data: np.ndarray, conf: Optional[Config], set_datatype: bool) -> Config:
    c = conf.copy() if conf is not None else Config(dims=data.shape)
    c.set_dims(data.shape)
    if set_datatype:
        c.dataType = runtime.np_dtype_id(data)
    return c


def archive_conf(data: np.ndarray, conf: Optional[Config] = None,
                 set_datatype: bool = True) -> Tuple[Config, int]:
    """The Config an archive of `data` starts from (dims and, unless
    set_datatype is False, dtype taken from `data`), and the payload's
    capacity in bytes (api/sz.hpp:60)."""
    c = _conf_for(data, conf, set_datatype)
    return c, compress_size_bound(c, data.dtype.itemsize) - 16 - c.size_est() * 2


def pack_archive(conf: Config, payload: bytes) -> bytes:
    """The container around a payload: header, payload, Config tail."""
    return _HDR.pack(SZ3_MAGIC_NUMBER, _DATA_VER, len(payload)) + payload + conf.save()


def open_archive(blob: bytes) -> Tuple[Config, bytes]:
    """(Config of the tail, payload) of a container."""
    magic, ver, size = _HDR.unpack_from(blob, 0)
    if magic != SZ3_MAGIC_NUMBER:
        raise ValueError("magic number mismatch: not an SZ3 archive")
    if ver != _DATA_VER:
        raise ValueError(
            f"archive data version {version_str(ver)} != supported {version_str(_DATA_VER)}")
    conf, _ = Config.load(blob, 16 + size)
    return conf, blob[16:16 + size]


def compress(data: Union[np.ndarray, torch.Tensor], conf: Optional[Config] = None, *,
             device="cuda", nthreads: int = 0, set_datatype: bool = True) -> bytes:
    """Compress an array into an SZ3 archive on `device`.

    `conf` carries algorithm and error-bound settings; dims and dtype come
    from `data`. With conf.openmp the archive is in the reference's OpenMP
    format, cut into `nthreads` chunks along the first axis (0: the
    machine's CPU count), which run one after the other on `device`.
    set_datatype=False leaves conf.dataType untouched in the archive tail,
    as the reference CLI does.
    """
    dev = _device(device)
    with trace.span("api.compress") as sp:
        arr = data.detach().cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)
        sp.set(nbytes=arr.nbytes, dims=arr.shape, dtype=arr.dtype.name)
        if arr.ndim > 4:
            raise ValueError("data dimension higher than 4 is not supported")
        c, cap = archive_conf(arr, conf, set_datatype)
        payload = compress_payload_torch(c, arr, cap, dev, nthreads)
        with trace.span("archive.pack", payload_bytes=len(payload)):
            blob = pack_archive(c, payload)
        sp.set(algo=int(c.cmprAlgo), archive_bytes=len(blob))
    return blob


def decompress(blob: bytes, *, device="cuda", dtype=None) -> Tuple[torch.Tensor, Config]:
    """Decompress an SZ3 archive into a tensor on `device`; returns (tensor,
    effective config). `dtype` (numpy dtype or DataType) overrides the
    archive's dataType byte."""
    dev = _device(device)
    with trace.span("api.decompress", archive_bytes=len(blob)) as sp:
        with trace.span("archive.open"):
            conf, payload = open_archive(blob)
        dt = None
        if dtype is not None:
            dt = dtype if isinstance(dtype, DataType) else runtime.np_dtype_id(
                np.empty(0, dtype=dtype))
        out = decompress_payload_torch(conf, payload, dt, dev)
        sp.set(nbytes=out.numel() * out.element_size(), dims=tuple(out.shape),
               algo=int(conf.cmprAlgo))
    return out, conf
