"""HDF5 filter integration, drop-in for the reference H5Z-SZ3 plugin
(counterpart of sz3_tpu/h5.py).

Filter id 32024 (reference tools/H5Z-SZ3; id pinned by
tools/test/integration/test_h5_filter.py:33). Datasets written through this
filter carry standard SZ3 containers per chunk, so files are interchangeable
with the reference plugin and with the JAX package's (the same filter id:
whichever registers last serves the process, and each reads the other's
files). The filter compresses and decompresses each chunk inside libhdf5
with the port's host engine (csrc/h5z_szt.cpp, built by
build.build_h5z), on the host, as the JAX package's filter does.

Usage with h5py:

    import h5py, numpy as np
    import sz3_tpu_torch.h5 as szh5

    szh5.register()                       # registers filter 32024 into h5py's libhdf5
    with h5py.File("x.h5", "w") as f:
        f.create_dataset("data", data=arr, chunks=arr.shape,
                         compression=szh5.FILTER_ID,
                         compression_opts=szh5.cd_values(absErrorBound=1e-3))
    with h5py.File("x.h5") as f:
        out = f["data"][:]                # decompresses through the filter

cd_values() plays the role of the reference's cdvalueHelper.py: it packs a
Config into the unsigned-int array HDF5 carries per dataset; set_local then
overrides dims/dtype from the dataset itself.
"""

from __future__ import annotations

import ctypes as C
from pathlib import Path
from typing import Optional, Tuple

from .config import Config
from .build import build_h5z

FILTER_ID = 32024

_registered = False


def _find_libhdf5() -> Optional[str]:
    """Locate the libhdf5 shared object the current process will use."""
    try:
        import h5py
    except ImportError:
        return None
    cand = []
    pkg = Path(h5py.__file__).resolve().parent
    for libs_dir in (pkg.parent / "h5py.libs", pkg / ".libs", pkg):
        if libs_dir.is_dir():
            cand += sorted(libs_dir.glob("libhdf5-*.so*")) + sorted(libs_dir.glob("libhdf5.so*"))
    return str(cand[0]) if cand else None


def register(libhdf5_path: Optional[str] = None) -> None:
    """Register filter 32024 with the HDF5 library h5py uses.

    Idempotent. Must be called after `import h5py` (or with an explicit
    libhdf5 path) and before writing/reading filtered datasets.
    """
    global _registered
    if _registered:
        return
    path = libhdf5_path or _find_libhdf5()
    lib = C.CDLL(str(build_h5z()))
    lib.h5zszt_register.restype = C.c_int
    lib.h5zszt_register.argtypes = [C.c_char_p]
    rc = lib.h5zszt_register(path.encode() if path else None)
    if rc != 0:
        raise RuntimeError(f"h5zszt_register failed with code {rc} (libhdf5={path})")
    _registered = True


def cd_values(conf: Optional[Config] = None, **kwargs) -> Tuple[int, ...]:
    """Pack a Config into HDF5 cd_values (reference cdvalueHelper.py role).

    Keyword arguments set Config fields, e.g. cd_values(absErrorBound=1e-3,
    errorBoundMode=EB.ABS). Dims and dtype are placeholders — the filter's
    set_local callback replaces them with the dataset's chunk shape/dtype.
    """
    c = conf.copy() if conf is not None else Config(dims=(1,))
    for k, v in kwargs.items():
        if not hasattr(c, k):
            raise TypeError(f"Config has no field {k!r}")
        setattr(c, k, v)
    raw = c.save()
    n = (len(raw) + 3) // 4
    buf = raw + b"\0" * (n * 4 - len(raw))
    return tuple(int.from_bytes(buf[i * 4:(i + 1) * 4], "little") for i in range(n))


def plugin_path() -> str:
    """Path to the built filter plugin .so (for HDF5_PLUGIN_PATH use)."""
    return str(build_h5z())
