"""sz3_tpu_torch: the sz3-tpu compressor in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper. Archives are SZ3 containers, byte-identical to
the host engine's (sz3_tpu.runtime), which this package shares with sz3_tpu.

    import sz3_tpu_torch as szp
    blob = szp.compress(data, szp.Config(absErrorBound=1e-3), device="cuda")
    out, conf = szp.decompress(blob, device="cuda")   # out: torch.Tensor

This package imports torch and never jax.
"""

import os as _os
import sys as _sys

if "sz3_tpu" not in _sys.modules:
    # sz3_tpu/__init__.py imports jax, when it is installed, to configure
    # its compile cache; SZT_COMP_CACHE=0 is its opt-out. Set only for this
    # import, so the process environment is left as it was.
    _prev = _os.environ.get("SZT_COMP_CACHE")
    _os.environ["SZT_COMP_CACHE"] = "0"
    try:
        import sz3_tpu  # noqa: F401
    finally:
        if _prev is None:
            del _os.environ["SZT_COMP_CACHE"]
        else:
            _os.environ["SZT_COMP_CACHE"] = _prev

from sz3_tpu.config import ALGO, EB, INTERP_ALGO, Config, DataType  # noqa: E402

from .api import compress, decompress, open_archive, pack_archive  # noqa: E402

__all__ = ["Config", "EB", "ALGO", "INTERP_ALGO", "DataType",
           "compress", "decompress", "open_archive", "pack_archive"]
