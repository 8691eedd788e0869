"""PyTorch execution backend (counterpart of sz3_tpu/algos/jax_backend.py).

The device runs the prediction+quantization of INTERP (the multi-level
passes), of LORENZO_REG (fits, selection and the element sweep), of NOPRED
(one quantize against zero), of BIOMD (frames after the first, the frame
recurrence) and of BIOMDXTC (one quantize at the XTC radius), the
INTERP_LORENZO tuner's trial encodes (algos/tuner.py), the Huffman
histogram and bit packing of the encode (algos/device_encode.py) and the
Huffman decode (algos/device_decode.py). The package's host engine
(runtime.py) seals the tuner's trials, tunes 1D fields, compresses integer
fields whole, builds the Huffman tree, replays LORENZO_REG's
coefficient chain, runs BIOMD's first frame and its HuffmanV2 coder and the
XTC triplet coder, and does the framing and zstd. Archives are
byte-identical to the host engine's. OpenMP-format archives (conf.openmp)
go chunk by chunk through this dispatcher (parallel/chunked.py).

Dispatcher semantics follow the host path (reference SZDispatcher.hpp:13-76):
eb-mode conversion, lossless mode for eb == 0, the buffer-too-small
downgrade, and the lossy-ratio < 3 zstd preference (not for BIOMD and
BIOMDXTC, which return directly).

Routes to the host engine are decided from the Config, the dtype and
host-side checks of the input before any device work; nothing is handed to
the host engine after a device attempt. They are the ones the JAX package
takes (jax_backend.py:337-384):
  - integer dtypes, for every algorithm;
  - LORENZO_REG other than 3D float32 with blockSize 6, and second-order
    Lorenzo encode rosters (1D fields: the INTERP_LORENZO tuner picks
    Lorenzo only there, and a 1D sweep is one chain of dependent cells);
  - BIOMD other than 3D float32, and trajectories with no molecular period
    (site == 0: every frame is a chain down the atoms) or fewer than 2 live
    frames; the decode decides from the payload header's site and fill frame;
  - BIOMDXTC other than float32 of 1 to 3 dimensions.
The host engine's BIOMD and BIOMDXTC bindings are float32 only. NOPRED
float64 runs on the device: the JAX package's float32 gate there exists only
because the TPU has no IEEE float64.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from .. import runtime
from ..config import ALGO, Config
from ..ops import biomd_device as bd
from ..parallel import chunked
from ..stats import cal_abs_error_bound
from ..utils import trace
from ..utils.copies import to_device
from . import device_decode, device_encode, tuner

_FLOATS = (np.float32, np.float64)


def _resolve_anchor_stride(conf: Config) -> None:
    # the archive's Config tail does not carry the anchor stride; loaded
    # configs hold -1 and the value is derived exactly as on the encode side
    if conf.interpAnchorStride < 0:
        conf.interpAnchorStride = [4096, 128, 32, 16][conf.N - 1]


def _blockwise_on_device(conf: Config, dtype, encode: bool) -> bool:
    """Whether the device runs this LORENZO_REG call (else the host engine)."""
    if np.dtype(dtype) != np.float32 or len(conf.dims) != 3 or conf.blockSize != 6:
        return False
    if encode:
        return not conf.lorenzo2 and (conf.lorenzo or conf.regression)
    return conf.lorenzo or conf.lorenzo2 or conf.regression


def _biomd_on_device(conf: Config, data: np.ndarray) -> Optional[Tuple[int, int, float]]:
    """(site, first fill frame, fill value) when the device runs this BIOMD
    encode, else None (the host engine's route): float32 3D trajectories
    with a molecular period (site != 0) and at least 2 live frames, as the
    JAX package routes them. Host numpy over at most 100 x 5 values of
    frame 1 and one scan back over the trailing frames."""
    if data.dtype != np.float32 or len(conf.dims) != 3 or conf.dims[0] < 2:
        return None
    data = data.reshape(conf.dims)
    site = bd.cal_site(data[1])
    if site == 0:
        return None
    first_fill, fill = bd.find_fill(data)
    if min(conf.dims[0], first_fill) < 2:
        return None
    return site, first_fill, fill


def _biomd_decode_on_device(conf: Config, payload: bytes, dt) -> bool:
    """Whether the device runs this BIOMD decode: float32 3D, and a payload
    header (read without opening the bins) with site != 0 and at least 2
    live frames."""
    if dt != np.float32 or len(conf.dims) != 3:
        return False
    site, first_fill, _ = runtime.biomd_header(payload)
    return site != 0 and min(conf.dims[0], first_fill) >= 2


def _encode_route(conf: Config, data: np.ndarray) -> Optional[tuple]:
    """None where the host engine runs this encode; else the host-side facts
    the device route needs (BIOMD: site, first fill frame, fill value;
    BIOMDXTC: first fill frame, fill value; others: nothing)."""
    algo, dt = conf.cmprAlgo, data.dtype
    if algo == ALGO.LORENZO_REG:
        return () if _blockwise_on_device(conf, dt, encode=True) else None
    if algo in (ALGO.INTERP, ALGO.NOPRED):
        return ()
    if algo == ALGO.BIOMD:
        return _biomd_on_device(conf, data)
    if algo == ALGO.BIOMDXTC:
        if dt != np.float32 or len(conf.dims) > 3:
            return None
        return bd.find_fill(data.reshape(conf.dims)) if len(conf.dims) == 3 else (0, 0.0)
    raise ValueError(f"unknown compression algorithm {algo!r}")


def _device_encode_payload(conf: Config, data: np.ndarray, cap: int, device: torch.device,
                           route: tuple) -> bytes:
    # conf.dims drops size-1 axes (reference setDims); the plan, the stream
    # order and the archive all use that shape
    x = to_device(data.reshape(conf.dims), device)
    algo = conf.cmprAlgo
    if algo == ALGO.LORENZO_REG:
        return device_encode.encode_payload_device_blockwise(conf, x, cap)
    if algo == ALGO.NOPRED:
        return device_encode.encode_payload_device_nopred(conf, x, cap)
    if algo == ALGO.BIOMD:
        return device_encode.encode_payload_device_biomd(conf, x, cap, *route)
    if algo == ALGO.BIOMDXTC:
        return device_encode.encode_payload_device_biomdxtc(conf, x, cap, *route)
    _resolve_anchor_stride(conf)
    return device_encode.encode_payload_device(conf, x, cap)


def compress_payload_torch(conf: Config, data: np.ndarray, cap: int, device: torch.device,
                           nthreads: int = 0) -> bytes:
    """Torch-path equivalent of the native dispatcher; mutates `conf` as the
    reference does. `nthreads` is the chunk count of an OpenMP-format
    archive (0: the machine's CPU count, at most data.shape[0])."""
    if data.dtype not in _FLOATS:
        # integer fields go whole to the engine's dispatcher, which tunes
        # them and cuts their chunks itself
        return runtime.compress_payload(conf, data, cap, nthreads)
    if conf.openmp:
        n = nthreads or min(os.cpu_count() or 1, data.shape[0])
        return chunked.compress_chunked(conf, data, n, device)
    with trace.span("dispatch.bound"):
        cal_abs_error_bound(conf, data)
    if conf.absErrorBound == 0:
        conf.cmprAlgo = ALGO.LOSSLESS
    if conf.cmprAlgo == ALGO.INTERP_LORENZO:
        if not tuner.tune(conf, data, device):     # trials on the device
            with trace.span("dispatch.tune", engine=True):
                runtime.tune_interp(conf, data)    # the engine's (1D fields)
    if conf.cmprAlgo == ALGO.LOSSLESS:
        return runtime.zstd_compress(data.tobytes())
    route = _encode_route(conf, data)
    if route is None:
        return runtime.compress_payload(conf, data, cap)
    return finish_payload(conf, data, cap, lambda: _device_encode_payload(conf, data, cap,
                                                                            device, route))


def finish_payload(conf: Config, data: np.ndarray, cap: int, encode) -> bytes:
    """The dispatcher's downgrades around a lossy encode (`encode()` returns
    its payload; mutates `conf` as the reference does): buffer too small ->
    lossless, and the lossy-ratio < 3 zstd preference (SZDispatcher.hpp:61-74),
    which BIOMD and BIOMDXTC skip (:36-39)."""
    try:
        payload = encode()
    except RuntimeError as e:
        if "buffer too small" not in str(e):
            raise
        conf.cmprAlgo = ALGO.LOSSLESS
        return runtime.zstd_compress(data.tobytes())
    if conf.cmprAlgo in (ALGO.BIOMD, ALGO.BIOMDXTC):
        return payload
    if data.nbytes / len(payload) < 3:
        z = runtime.zstd_compress(data.tobytes())
        if len(z) < len(payload) and len(z) <= cap:
            conf.cmprAlgo = ALGO.LOSSLESS
            return z
    return payload


def decompress_payload_torch(conf: Config, payload: bytes, dtype,
                             device: torch.device) -> torch.Tensor:
    """Payload -> tensor on `device`, shaped conf.dims. `dtype` is a
    DataType overriding the archive's, or None."""
    dt = runtime.np_dtype_of(dtype if dtype is not None else conf.dataType)
    algo = conf.cmprAlgo
    if conf.openmp:
        return chunked.decompress_chunked(conf, payload, dt, device)
    if algo == ALGO.LOSSLESS:
        raw = runtime.zstd_decompress(payload)
        out = np.frombuffer(raw, dtype=dt).reshape(conf.dims).copy()
        return torch.from_numpy(out).to(device)
    if algo == ALGO.LORENZO_REG and _blockwise_on_device(conf, dt, encode=False):
        return device_decode.decode_payload_device_blockwise(conf, payload, device)
    if algo == ALGO.INTERP and dt in _FLOATS:
        _resolve_anchor_stride(conf)
        return device_decode.decode_payload_device(conf, payload, dt, device).reshape(conf.dims)
    if algo == ALGO.NOPRED and dt in _FLOATS:
        return device_decode.decode_payload_device_nopred(conf, payload, dt,
                                                          device).reshape(conf.dims)
    if algo == ALGO.BIOMD and _biomd_decode_on_device(conf, payload, dt):
        return device_decode.decode_payload_device_biomd(conf, payload, device)
    if algo == ALGO.BIOMDXTC and dt == np.float32 and len(conf.dims) <= 3:
        return device_decode.decode_payload_device_biomdxtc(conf, payload, device)
    out = runtime.decompress_payload(conf, payload,
                                     dtype=runtime.np_dtype_id(np.empty(0, dtype=dt)))
    return torch.from_numpy(np.ascontiguousarray(out)).to(device).reshape(conf.dims)
