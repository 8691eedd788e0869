"""Drop-in replacement for the reference pysz binding (tools/pysz/src/pysz/sz.pyx),
on the CUDA card (counterpart of sz3_tpu/pysz.py).

Mirrors the published surface:
    from sz3_tpu_torch.pysz import sz, szConfig, szErrorBoundMode, szAlgorithm
    conf = szConfig(data.shape); conf.absErrorBound = 1e-3
    compressed, ratio = sz.compress(data, conf)
    out, used_conf = sz.decompress(compressed, np.float32, data.shape)
    max_diff, psnr, nrmse = sz.verify(data, out)

sz.compress, sz.decompress and sz.verify take a keyword-only ``device``
(default ``"cuda"``, which raises without a card; ``device="cpu"`` runs the
kernels' plain PyTorch versions) and return numpy arrays, as the reference
binding does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from . import api
from .stats import moments
from .config import ALGO, Config, EB


class szErrorBoundMode:
    """Error bound modes (reference sz.pyx:20-27)."""
    ABS = 0
    REL = 1
    PSNR = 2
    L2NORM = 3
    ABS_AND_REL = 4
    ABS_OR_REL = 5


class szAlgorithm:
    """Compression algorithms (reference sz.pyx:30-37)."""
    LORENZO_REG = 0
    INTERP_LORENZO = 1
    INTERP = 2
    NOPRED = 3
    LOSSLESS = 4
    BIOMD = 5
    BIOMDXTC = 6


_SUPPORTED_DTYPES = (np.float32, np.float64, np.int32, np.int64)


class szConfig:
    """Configuration mirroring the reference `szConfig` (sz.pyx:39-172)."""

    def __init__(self, *args):
        self._conf = Config(dims=(1,))
        if args:
            self.setDims(*args)

    def setDims(self, *args):
        if len(args) == 1 and hasattr(args[0], "__iter__"):
            dims_iter = tuple(args[0])
        else:
            dims_iter = args
        if not dims_iter:
            raise ValueError("At least one dimension required")
        for d in dims_iter:
            if not isinstance(d, (int, np.integer)) or d <= 0:
                raise ValueError(f"Dimension must be positive integer, got {d}")
        self._conf.set_dims([int(d) for d in dims_iter])

    def loadcfg(self, cfgpath: str):
        self._conf.loadcfg(cfgpath)

    @property
    def dims(self):
        return tuple(self._conf.dims)

    @property
    def num_elements(self):
        return self._conf.num

    @property
    def ndim(self):
        return self._conf.N

    @property
    def absErrorBound(self):
        return self._conf.absErrorBound

    @absErrorBound.setter
    def absErrorBound(self, value):
        self._conf.absErrorBound = float(value)

    @property
    def relErrorBound(self):
        return self._conf.relErrorBound

    @relErrorBound.setter
    def relErrorBound(self, value):
        self._conf.relErrorBound = float(value)

    @property
    def psnrErrorBound(self):
        return self._conf.psnrErrorBound

    @psnrErrorBound.setter
    def psnrErrorBound(self, value):
        self._conf.psnrErrorBound = float(value)

    @property
    def l2normErrorBound(self):
        return self._conf.l2normErrorBound

    @l2normErrorBound.setter
    def l2normErrorBound(self, value):
        self._conf.l2normErrorBound = float(value)

    @property
    def errorBoundMode(self):
        return int(self._conf.errorBoundMode)

    @errorBoundMode.setter
    def errorBoundMode(self, value):
        self._conf.errorBoundMode = EB(int(value))

    @property
    def cmprAlgo(self):
        return int(self._conf.cmprAlgo)

    @cmprAlgo.setter
    def cmprAlgo(self, value):
        self._conf.cmprAlgo = ALGO(int(value))

    @property
    def openmp(self):
        return bool(self._conf.openmp)

    @openmp.setter
    def openmp(self, value):
        self._conf.openmp = bool(value)

    def __repr__(self):
        return (f"szConfig(dims={self.dims}, errorBoundMode={self.errorBoundMode}, "
                f"absErrorBound={self.absErrorBound}, cmprAlgo={self.cmprAlgo})")


class sz:
    """Static compress/decompress/verify API (reference sz.pyx:174-290)."""

    @staticmethod
    def compress(data: np.ndarray, config, *, device="cuda") -> Tuple[np.ndarray, float]:
        if not isinstance(data, np.ndarray):
            raise TypeError("data must be a numpy array")
        if data.dtype.type not in _SUPPORTED_DTYPES:
            raise TypeError(f"Unsupported dtype {data.dtype}; use float32/float64/int32/int64")
        if not isinstance(config, szConfig):
            raise TypeError("config must be a szConfig")
        data = np.ascontiguousarray(data)
        conf = config._conf.copy()
        conf.set_dims(data.shape)
        blob = api.compress(data, conf, device=device)
        ratio = data.nbytes / len(blob)
        return np.frombuffer(blob, dtype=np.uint8).copy(), ratio

    @staticmethod
    def decompress(compressed: np.ndarray, dtype, shape, *,
                   device="cuda") -> Tuple[np.ndarray, "szConfig"]:
        if isinstance(compressed, (bytes, bytearray)):
            blob = bytes(compressed)
        else:
            blob = np.ascontiguousarray(compressed, dtype=np.uint8).tobytes()
        dt = np.dtype(dtype)
        if dt.type not in _SUPPORTED_DTYPES:
            raise TypeError(f"Unsupported dtype {dt}; use float32/float64/int32/int64")
        arr, conf = api.decompress(blob, device=device, dtype=dt)
        out_conf = szConfig()
        out_conf._conf = conf
        return arr.cpu().numpy().astype(dt, copy=False).reshape(shape), out_conf

    @staticmethod
    def verify(src_data: np.ndarray, dec_data: np.ndarray, *,
               device="cuda") -> Tuple[float, float, float]:
        """(max abs error, PSNR, NRMSE), computed in float64 on `device`."""
        m = moments(src_data, dec_data, device)
        data_range = m["max"] - m["min"]
        mse = m["sse"] / m["n"]
        nrmse = float(np.sqrt(mse) / data_range) if data_range > 0 else 0.0
        psnr = 20 * np.log10(data_range) - 10 * np.log10(mse) if mse > 0 else float("inf")
        return m["max_abs"], float(psnr), nrmse
