"""MDZ/ADP adaptive time-series compressor for molecular-dynamics data
(counterpart of sz3_tpu/mdz.py; host engine csrc/engine/szt/mdz.hpp, after
the reference's `mdz` tool, ICDE'22): per-batch method selection among VQ /
VQT / MT / LR (/ TS), k-means level detection, per-batch REL->ABS error-bound
scaling, and 3D-to-per-axis-2D decomposition. Archives (MDZ1 / MDZ3) are
byte-identical to the host engine's.

    blob = mdz_compress(traj, rel_eb=1e-3, batch_size=100)          # on the card
    out = mdz_decompress(blob)                                      # torch.Tensor

The reference tool's command line is ``main`` (``python -m sz3_tpu_torch.mdz``,
console script ``sz3t-torch-mdz``).

``device`` defaults to ``"cuda"``: VQ, VQT and MT run on the current CUDA
device (algos/mdz_torch.py, the frame recurrence in csrc/mdz_frames.cu), and
the call raises when there is none. ``device="cpu"`` has to be asked for,
and runs the plain PyTorch versions. Float64 series and series of more than
3 dimensions take the host engine's route, decided before any device work
(the engine's per-batch coders are bound for float32 only).
"""

from __future__ import annotations

import ctypes as C
from typing import Optional, Union

import numpy as np
import torch

from . import runtime
from .api import _device

METHODS = {"ADP": -1, "VQ": 0, "VQT": 1, "MT": 2, "LR": 3, "TS": 4}
METHOD_NAMES = {v: k for k, v in METHODS.items()}

_ERRCAP = runtime._ERRCAP
_bound = False


class EngineError(RuntimeError):
    """An error of an engine call; `reason` is the engine's own message."""

    def __init__(self, where: str, reason: str):
        super().__init__(f"{where}: {reason}")
        self.reason = reason


def _engine_error(where: str, err) -> EngineError:
    return EngineError(where, err.value.decode())


def _l():
    global _bound
    l = runtime.lib()
    if not _bound:
        u8p = C.POINTER(C.c_uint8)
        u64 = C.c_uint64
        l.szt_mdz_compress.restype = C.c_int
        l.szt_mdz_compress.argtypes = [C.POINTER(u64), C.c_int32, C.c_uint8, C.c_uint8,
                                       C.c_double, u64, C.c_int32, C.c_int32, C.c_void_p,
                                       C.POINTER(u8p), C.POINTER(u64), C.c_char_p, u64]
        l.szt_mdz_peek.restype = C.c_int
        l.szt_mdz_peek.argtypes = [C.c_char_p, u64, C.POINTER(u64), C.POINTER(C.c_int32),
                                   C.POINTER(C.c_uint8), C.c_char_p, u64]
        l.szt_mdz_decompress.restype = C.c_int
        l.szt_mdz_decompress.argtypes = [C.c_char_p, u64, C.c_void_p, C.c_char_p, u64]
        _bound = True
    return l


def _on_device(data: np.ndarray) -> bool:
    """Whether the device runs this series: float32 of 1 to 3 dimensions."""
    return data.dtype == np.float32 and 1 <= data.ndim <= 3


def engine_compress(data: np.ndarray, abs_eb: Optional[float], rel_eb: Optional[float],
                    batch_size: int, method: int, quantbin: int) -> bytes:
    """The host engine's MDZ archive of `data` (szt_mdz_compress)."""
    if data.ndim > 3:
        raise ValueError("MDZ supports 1D-3D data")
    data = np.ascontiguousarray(data)
    if data.dtype == np.float32:
        dtype = 0
    elif data.dtype == np.float64:
        dtype = 1
    else:
        raise TypeError("MDZ supports float32/float64")
    dims = (C.c_uint64 * data.ndim)(*data.shape)
    out = C.POINTER(C.c_uint8)()
    out_len = C.c_uint64()
    err = C.create_string_buffer(_ERRCAP)
    rc = _l().szt_mdz_compress(dims, data.ndim, dtype, 0 if abs_eb is not None else 1,
                               abs_eb if abs_eb is not None else rel_eb, batch_size, quantbin,
                               method, data.ctypes.data_as(C.c_void_p), C.byref(out),
                               C.byref(out_len), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"mdz_compress: {err.value.decode()}")
    return runtime._take(out, out_len)


def engine_decompress(blob: bytes) -> np.ndarray:
    """The host engine's decode of an MDZ archive (szt_mdz_decompress)."""
    shape, dtype = mdz_peek(blob)
    out = np.empty(shape, dtype=dtype)
    err = C.create_string_buffer(_ERRCAP)
    rc = _l().szt_mdz_decompress(blob, len(blob), out.ctypes.data_as(C.c_void_p), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"mdz_decompress: {err.value.decode()}")
    return out


def mdz_compress(data: Union[np.ndarray, torch.Tensor], *, abs_eb: Optional[float] = None,
                 rel_eb: Optional[float] = None, batch_size: int = 0,
                 method: Union[int, str] = -1, quantbin: int = 1024, device="cuda") -> bytes:
    """Compress a 1D (atoms), 2D (frames, atoms) or 3D (frames, atoms, xyz)
    MD series. Exactly one of abs_eb / rel_eb must be given (reference
    mdz.cpp:40-46). method: "ADP" (adaptive, default) or VQ/VQT/MT/LR/TS."""
    if (abs_eb is None) == (rel_eb is None):
        raise ValueError("specify exactly one of abs_eb / rel_eb")
    if isinstance(method, str):
        method = METHODS[method.upper()]
    dev = _device(device)
    arr = data.detach().cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)
    if not _on_device(arr):
        return engine_compress(arr, abs_eb, rel_eb, batch_size, method, quantbin)
    from .algos import mdz_torch
    return mdz_torch.mdz_compress_torch(np.ascontiguousarray(arr), abs_eb=abs_eb, rel_eb=rel_eb,
                                        batch_size=batch_size, method=method,
                                        quantbin=quantbin, device=dev)


def mdz_peek(blob: bytes):
    """(shape, numpy dtype) described by an MDZ archive header."""
    dims = (C.c_uint64 * 4)()
    ndim = C.c_int32()
    dtype = C.c_uint8()
    err = C.create_string_buffer(_ERRCAP)
    rc = _l().szt_mdz_peek(blob, len(blob), dims, C.byref(ndim), C.byref(dtype), err, _ERRCAP)
    if rc != 0:
        raise RuntimeError(f"mdz_peek: {err.value.decode()}")
    shape = tuple(dims[i] for i in range(ndim.value))
    return shape, (np.float32 if dtype.value == 0 else np.float64)


def mdz_decompress(blob: bytes, *, device="cuda") -> torch.Tensor:
    """Decompress an MDZ archive into a tensor on `device`. Float32 archives
    decode on the device; float64 ones in the host engine."""
    dev = _device(device)
    if blob[:4] in (b"MDZ1", b"MDZ3") and len(blob) > 4 and blob[4] == 0:
        from .algos import mdz_torch
        return mdz_torch.mdz_decompress_torch(blob, dev)
    return torch.from_numpy(engine_decompress(blob)).to(dev)


# ---- LAMMPS in-situ hooks (reference tools/mdz/include/mdz.hpp:283-359) -------

def lammps_compress(data: np.ndarray, method: int, *, abs_eb: float = 1e-3,
                    level=(0.0, 0.0, 0), ts0: Optional[np.ndarray] = None,
                    quantbin: int = 1024, block_size: int = 128) -> bytes:
    """Compress one in-situ (frames x atoms) float32 batch with an explicit
    MDZ method (0 VQ, 1 VQT, 2 MT, 3 LR, 4 TS), as an MD engine would call
    per output interval. `level` = (start, offset, num) from level_detect.
    Runs in the host engine."""
    data = np.ascontiguousarray(data, dtype=np.float32)
    frames, atoms = data.shape
    ls, lo, ln = level
    t = np.ascontiguousarray(ts0, dtype=np.float32) if ts0 is not None else None
    out = C.POINTER(C.c_uint8)()
    out_len = C.c_uint64()
    err = C.create_string_buffer(_ERRCAP)
    rc = _lammps_lib().szt_lammps_compress(
        C.c_uint64(frames), C.c_uint64(atoms), C.c_double(abs_eb), C.c_int32(quantbin),
        C.c_int32(block_size), C.c_int32(method), C.c_float(ls), C.c_float(lo), C.c_int32(ln),
        t.ctypes.data_as(C.c_void_p) if t is not None else None,
        data.ctypes.data_as(C.c_void_p), C.byref(out), C.byref(out_len), err, _ERRCAP)
    if rc != 0:
        raise _engine_error("lammps_compress", err)
    return runtime._take(out, out_len)


def lammps_decompress(blob: bytes, method: int, frames: int, atoms: int, *,
                      abs_eb: float = 1e-3, level=(0.0, 0.0, 0),
                      ts0: Optional[np.ndarray] = None, quantbin: int = 1024,
                      block_size: int = 128) -> np.ndarray:
    ls, lo, ln = level
    t = np.ascontiguousarray(ts0, dtype=np.float32) if ts0 is not None else None
    out = np.empty((frames, atoms), np.float32)
    err = C.create_string_buffer(_ERRCAP)
    rc = _lammps_lib().szt_lammps_decompress(
        C.c_uint64(frames), C.c_uint64(atoms), C.c_double(abs_eb), C.c_int32(quantbin),
        C.c_int32(block_size), C.c_int32(method), C.c_float(ls), C.c_float(lo), C.c_int32(ln),
        t.ctypes.data_as(C.c_void_p) if t is not None else None, blob, C.c_uint64(len(blob)),
        out.ctypes.data_as(C.c_void_p), err, _ERRCAP)
    if rc != 0:
        raise _engine_error("lammps_decompress", err)
    return out


def lammps_select_compressor(data: np.ndarray, *, firsttime: bool, abs_eb: float = 1e-3,
                             level=(0.0, 0.0, 0), ts0: Optional[np.ndarray] = None,
                             quantbin: int = 1024, block_size: int = 128) -> int:
    """Re-select the per-interval method by trial-compressing a sample of the
    batch (reference LAMMPS_select_compressor semantics: on the first call
    the equilibration half is skipped; trials clamp to 10 frames)."""
    data = np.ascontiguousarray(data, dtype=np.float32)
    frames, atoms = data.shape
    ls, lo, ln = level
    t = np.ascontiguousarray(ts0, dtype=np.float32) if ts0 is not None else None
    m = C.c_int32()
    err = C.create_string_buffer(_ERRCAP)
    rc = _lammps_lib().szt_lammps_select(
        C.c_uint64(frames), C.c_uint64(atoms), C.c_double(abs_eb), C.c_int32(quantbin),
        C.c_int32(block_size), C.c_int32(1 if firsttime else 0), C.c_float(ls), C.c_float(lo),
        C.c_int32(ln), t.ctypes.data_as(C.c_void_p) if t is not None else None,
        data.ctypes.data_as(C.c_void_p), C.byref(m), err, _ERRCAP)
    if rc != 0:
        raise _engine_error("lammps_select", err)
    return int(m.value)


def _lammps_lib():
    lib = runtime.lib()
    if not getattr(lib, "_lammps_bound", False):
        u64, i32, f32 = C.c_uint64, C.c_int32, C.c_float
        u8p = C.POINTER(C.c_uint8)
        lib.szt_lammps_compress.restype = C.c_int
        lib.szt_lammps_compress.argtypes = [u64, u64, C.c_double, i32, i32, i32, f32, f32, i32,
                                            C.c_void_p, C.c_void_p, C.POINTER(u8p),
                                            C.POINTER(u64), C.c_char_p, u64]
        lib.szt_lammps_decompress.restype = C.c_int
        lib.szt_lammps_decompress.argtypes = [u64, u64, C.c_double, i32, i32, i32, f32, f32,
                                              i32, C.c_void_p, C.c_char_p, u64, C.c_void_p,
                                              C.c_char_p, u64]
        lib.szt_lammps_select.restype = C.c_int
        lib.szt_lammps_select.argtypes = [u64, u64, C.c_double, i32, i32, i32, f32, f32, i32,
                                          C.c_void_p, C.c_void_p, C.POINTER(i32), C.c_char_p,
                                          u64]
        lib._lammps_bound = True
    return lib


def main(argv=None):
    """CLI mirroring the reference `mdz` tool (tools/mdz/mdz.cpp:4-10):
    mdz file -2 n_frames n_atoms -r reb [batch] [method] [quantbin]
    (counterpart of sz3_tpu/mdz.py:main), on --device (default cuda)."""
    import argparse

    p = argparse.ArgumentParser(prog="sz3t-torch-mdz", description=main.__doc__)
    p.add_argument("file")
    p.add_argument("-1", dest="d1", nargs=1, type=int, metavar="N")
    p.add_argument("-2", dest="d2", nargs=2, type=int, metavar=("F", "A"))
    p.add_argument("-3", dest="d3", nargs=3, type=int, metavar=("F", "A", "X"))
    p.add_argument("-r", dest="reb", type=float, help="relative error bound")
    p.add_argument("-a", dest="aeb", type=float, help="absolute error bound")
    p.add_argument("-b", dest="batch", type=int, default=0)
    p.add_argument("-m", dest="method", default="ADP", choices=list(METHODS))
    p.add_argument("-q", dest="quantbin", type=int, default=1024)
    p.add_argument("-z", dest="out", help="write archive here")
    p.add_argument("-o", dest="dec", help="write decompressed output here")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # reference positional tail: [batch_size [method [quantbin]]] (mdz.cpp:48-61)
    p.add_argument("tail", nargs="*", type=int)
    a = p.parse_args(argv)
    if a.tail:
        a.batch = a.tail[0]
        if len(a.tail) > 1:
            a.method = METHOD_NAMES.get(a.tail[1], "ADP")
        if len(a.tail) > 2:
            a.quantbin = a.tail[2]

    shape = tuple(a.d1 or a.d2 or a.d3 or ())
    if not shape:
        p.error("give -1/-2/-3 dims")
    dev = _device(a.device)
    data = np.fromfile(a.file, dtype=np.float32, count=int(np.prod(shape))).reshape(shape)
    blob = mdz_compress(data, abs_eb=a.aeb, rel_eb=a.reb, batch_size=a.batch,
                        method=a.method, quantbin=a.quantbin, device=dev)
    dec = mdz_decompress(blob, device=dev)
    ratio = data.nbytes / len(blob)
    err = float((dec.to(torch.float64) - torch.from_numpy(data).to(dev, torch.float64))
                .abs().max())
    print(f"Batch={a.batch or shape[0]}")
    print(f"Compression ratio={ratio:.3f}")
    print(f"Max error={err:.6g}")
    if a.out:
        with open(a.out, "wb") as f:
            f.write(blob)
    if a.dec:
        dec.cpu().numpy().tofile(a.dec)


if __name__ == "__main__":
    main()
