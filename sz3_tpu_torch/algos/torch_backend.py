"""PyTorch execution backend (counterpart of sz3_tpu/algos/jax_backend.py).

The device runs the multi-level prediction+quantization passes and, on the
encode side, the Huffman histogram and bit packing (algos/device_encode.py).
The host engine (sz3_tpu.runtime) tunes, builds the Huffman tree, and does
the framing and zstd. Archives are byte-identical to the host engine's.

Dispatcher semantics follow the host path (reference SZDispatcher.hpp:13-76):
eb-mode conversion, lossless mode for eb == 0, the buffer-too-small
downgrade, and the lossy-ratio < 3 zstd preference. Algorithms this port
does not run yet raise NotImplementedError naming their ROADMAP item; none
of them is quietly handed to the host engine.
"""

from __future__ import annotations

import numpy as np
import torch

from sz3_tpu import runtime
from sz3_tpu.config import ALGO, Config
from sz3_tpu.stats import cal_abs_error_bound

from ..build import host_engine
from . import device_encode
from ..ops.interp_fast import decode_grid_fast, grid_to_pass_slices, initial_literal
from ..ops.stream_order import host_perm

_TODO = {
    ALGO.LORENZO_REG: "LORENZO_REG is ROADMAP Queue 1 item 12",
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
    # the payload header is authoritative over the Config tail (the interp
    # compressor may store another interpolator): open first, plan after
    stream, unpred = runtime.interp_open(conf, payload, dtype)
    perm = host_perm(tuple(conf.dims), int(conf.interpAlgo), conf.interpDirection,
                     conf.interpAnchorStride)
    bins_np, literal_np = runtime.perm_place(perm, stream, unpred, tuple(conf.dims), dtype)
    bins = torch.from_numpy(bins_np).to(device)
    literal = torch.from_numpy(literal_np).to(device)
    plan = device_encode.plan_for(conf)
    return decode_grid_fast(grid_to_pass_slices(bins, plan),
                            grid_to_pass_slices(literal, plan), plan,
                            initial_literal(literal, plan), bins[(0,) * bins.dim()],
                            literal.dtype)


def compress_payload_torch(conf: Config, data: np.ndarray, cap: int,
                           device: torch.device) -> bytes:
    """Torch-path equivalent of the native dispatcher; mutates `conf` as the
    reference does."""
    host_engine()
    if conf.openmp:
        raise _unsupported(conf)
    cal_abs_error_bound(conf, data)
    if conf.absErrorBound == 0:
        conf.cmprAlgo = ALGO.LOSSLESS
    if conf.cmprAlgo == ALGO.INTERP_LORENZO:
        runtime.tune_interp(conf, data)
    if conf.cmprAlgo == ALGO.LOSSLESS:
        return runtime.zstd_compress(data.tobytes())
    if conf.cmprAlgo != ALGO.INTERP:
        raise _unsupported(conf)
    if data.dtype not in (np.float32, np.float64):
        # integer dtypes ride the host engine end to end, as in the JAX
        # package (the interp passes and the packed seal are float-only)
        return runtime.compress_payload(conf, data, cap)
    try:
        payload = _interp_encode_payload(conf, data, cap, device)
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
    host_engine()
    dt = runtime.np_dtype_of(dtype if dtype is not None else conf.dataType)
    if conf.openmp:
        raise _unsupported(conf)
    if conf.cmprAlgo == ALGO.LOSSLESS:
        raw = runtime.zstd_decompress(payload)
        out = np.frombuffer(raw, dtype=dt).reshape(conf.dims).copy()
        return torch.from_numpy(out).to(device)
    if conf.cmprAlgo != ALGO.INTERP:
        raise _unsupported(conf)
    if dt in (np.float32, np.float64):
        return _interp_decode_payload(conf, payload, dt, device).reshape(conf.dims)
    out = runtime.decompress_payload(conf, payload,
                                     dtype=runtime.np_dtype_id(np.empty(0, dtype=dt)))
    return torch.from_numpy(np.ascontiguousarray(out)).to(device).reshape(conf.dims)
