"""Top-level compress/decompress: the SZ3 container around the payload, the
same container as sz3_tpu/api.py writes and reads:

  [magic u32][data-version u32][payload size u64] [payload] [Config]

The device is explicit: ``device="cuda"`` runs the passes and kernels on the
current CUDA device and raises when there is none; ``device="cpu"`` runs the
kernels' plain PyTorch versions.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from sz3_tpu import runtime
from sz3_tpu.api import _DATA_VER, _HDR, _conf_for, compress_size_bound
from sz3_tpu.config import Config, DataType, SZ3_MAGIC_NUMBER, version_str

from .algos.torch_backend import compress_payload_torch, decompress_payload_torch


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested, but torch.cuda.is_available() is False")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


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
             device, set_datatype: bool = True) -> bytes:
    """Compress an array into an SZ3 archive on `device`.

    `conf` carries algorithm and error-bound settings; dims and dtype come
    from `data`. set_datatype=False leaves conf.dataType untouched in the
    archive tail, as the reference CLI does.
    """
    dev = _device(device)
    arr = data.detach().cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)
    if arr.ndim > 4:
        raise ValueError("data dimension higher than 4 is not supported")
    c, cap = archive_conf(arr, conf, set_datatype)
    return pack_archive(c, compress_payload_torch(c, arr, cap, dev))


def decompress(blob: bytes, *, device, dtype=None) -> Tuple[torch.Tensor, Config]:
    """Decompress an SZ3 archive into a tensor on `device`; returns (tensor,
    effective config). `dtype` (numpy dtype or DataType) overrides the
    archive's dataType byte."""
    dev = _device(device)
    conf, payload = open_archive(blob)
    dt = None
    if dtype is not None:
        dt = dtype if isinstance(dtype, DataType) else runtime.np_dtype_id(np.empty(0, dtype=dtype))
    return decompress_payload_torch(conf, payload, dt, dev), conf
