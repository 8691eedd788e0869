"""PyTorch execution backend (counterpart of sz3_tpu/algos/jax_backend.py).

The device runs the prediction+quantization of INTERP (the multi-level
passes) and of LORENZO_REG (fits, selection and the element sweep), the
Huffman histogram and bit packing of the encode (algos/device_encode.py) and
the Huffman decode (algos/device_decode.py). The package's host engine
(runtime.py) tunes, builds the Huffman tree, replays LORENZO_REG's
coefficient chain, and does the framing and zstd. Archives are
byte-identical to the host engine's.

Dispatcher semantics follow the host path (reference SZDispatcher.hpp:13-76):
eb-mode conversion, lossless mode for eb == 0, the buffer-too-small
downgrade, and the lossy-ratio < 3 zstd preference.

LORENZO_REG runs on the device for 3D float32 fields with blockSize 6, and
for the encode a roster without second-order Lorenzo. Every other
LORENZO_REG configuration goes to the host engine, as the JAX package sends
it (jax_backend.py:337-350, :376-384): 1D fields (the INTERP_LORENZO tuner
picks Lorenzo only there, and a 1D sweep is one chain of dependent cells
with no parallel width), 2D and 4D fields, float64 and integer data,
second-order Lorenzo encode rosters and other block sizes. The route is
decided from the Config and the dtype before any device work; nothing is
handed to the host engine after a device attempt. Algorithms this port does
not run yet raise NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import runtime
from ..config import ALGO, Config
from ..stats import cal_abs_error_bound
from . import device_decode, device_encode

_TODO = {
    ALGO.NOPRED: "NOPRED is ROADMAP Queue 1 item 10",
    ALGO.BIOMD: "BIOMD is ROADMAP Queue 1 item 13",
    ALGO.BIOMDXTC: "BIOMDXTC is ROADMAP Queue 1 item 13",
}


def _unsupported(conf: Config) -> NotImplementedError:
    if conf.openmp:
        return NotImplementedError(
            "chunked (openmp) archives are ROADMAP Queue 1 item 15 (multi-device)")
    why = _TODO.get(conf.cmprAlgo, f"{conf.cmprAlgo.name} has no ROADMAP item yet")
    return NotImplementedError(f"sz3_tpu_torch does not run {conf.cmprAlgo.name}: {why}")


def _resolve_anchor_stride(conf: Config) -> None:
    # the archive's Config tail does not carry the anchor stride; loaded
    # configs hold -1 and the value is derived exactly as on the encode side
    if conf.interpAnchorStride < 0:
        conf.interpAnchorStride = [4096, 128, 32, 16][conf.N - 1]


def _interp_encode_payload(conf: Config, data: np.ndarray, cap: int,
                           device: torch.device) -> bytes:
    _resolve_anchor_stride(conf)
    # conf.dims drops size-1 axes (reference setDims); the plan, the stream
    # permutation and the archive all use that shape
    data = np.ascontiguousarray(data).reshape(conf.dims)
    x = torch.from_numpy(data).to(device)
    return device_encode.encode_payload_device(conf, x, cap)


def _interp_decode_payload(conf: Config, payload: bytes, dtype,
                           device: torch.device) -> torch.Tensor:
    _resolve_anchor_stride(conf)
    return device_decode.decode_payload_device(conf, payload, dtype, device)


def _blockwise_on_device(conf: Config, dtype, encode: bool) -> bool:
    """Whether the device runs this LORENZO_REG call (else the host engine)."""
    if np.dtype(dtype) != np.float32 or len(conf.dims) != 3 or conf.blockSize != 6:
        return False
    if encode:
        return not conf.lorenzo2 and (conf.lorenzo or conf.regression)
    return conf.lorenzo or conf.lorenzo2 or conf.regression


def _device_encode_payload(conf: Config, data: np.ndarray, cap: int,
                           device: torch.device) -> bytes:
    if conf.cmprAlgo == ALGO.LORENZO_REG:
        x = torch.from_numpy(np.ascontiguousarray(data).reshape(conf.dims)).to(device)
        return device_encode.encode_payload_device_blockwise(conf, x, cap)
    return _interp_encode_payload(conf, data, cap, device)


def compress_payload_torch(conf: Config, data: np.ndarray, cap: int,
                           device: torch.device) -> bytes:
    """Torch-path equivalent of the native dispatcher; mutates `conf` as the
    reference does."""
    if conf.openmp:
        raise _unsupported(conf)
    cal_abs_error_bound(conf, data)
    if conf.absErrorBound == 0:
        conf.cmprAlgo = ALGO.LOSSLESS
    if conf.cmprAlgo == ALGO.INTERP_LORENZO:
        runtime.tune_interp(conf, data)
    if conf.cmprAlgo == ALGO.LOSSLESS:
        return runtime.zstd_compress(data.tobytes())
    if conf.cmprAlgo == ALGO.LORENZO_REG:
        if not _blockwise_on_device(conf, data.dtype, encode=True):
            return runtime.compress_payload(conf, data, cap)
    elif conf.cmprAlgo != ALGO.INTERP:
        raise _unsupported(conf)
    elif data.dtype not in (np.float32, np.float64):
        # integer dtypes ride the host engine end to end, as in the JAX
        # package (the interp passes and the packed seal are float-only)
        return runtime.compress_payload(conf, data, cap)
    try:
        payload = _device_encode_payload(conf, data, cap, device)
    except RuntimeError as e:
        if "buffer too small" not in str(e):
            raise
        conf.cmprAlgo = ALGO.LOSSLESS
        return runtime.zstd_compress(data.tobytes())
    # lossy ratio < 3 -> prefer plain zstd when smaller (SZDispatcher.hpp:61-74)
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
    if conf.openmp:
        raise _unsupported(conf)
    if conf.cmprAlgo == ALGO.LOSSLESS:
        raw = runtime.zstd_decompress(payload)
        out = np.frombuffer(raw, dtype=dt).reshape(conf.dims).copy()
        return torch.from_numpy(out).to(device)
    if conf.cmprAlgo == ALGO.LORENZO_REG:
        if _blockwise_on_device(conf, dt, encode=False):
            return device_decode.decode_payload_device_blockwise(conf, payload, device)
    elif conf.cmprAlgo != ALGO.INTERP:
        raise _unsupported(conf)
    elif dt in (np.float32, np.float64):
        return _interp_decode_payload(conf, payload, dt, device).reshape(conf.dims)
    out = runtime.decompress_payload(conf, payload,
                                     dtype=runtime.np_dtype_id(np.empty(0, dtype=dt)))
    return torch.from_numpy(np.ascontiguousarray(out)).to(device).reshape(conf.dims)
