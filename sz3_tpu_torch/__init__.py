"""sz3_tpu_torch: the sz3-tpu compressor in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper. Archives are SZ3 containers, byte-identical to
those of the package's own C++ host engine (runtime.py, csrc/engine/).

    import sz3_tpu_torch as szp
    blob = szp.compress(data, szp.Config(absErrorBound=1e-3), device="cuda")
    out, conf = szp.decompress(blob, device="cuda")   # out: torch.Tensor

This package imports torch, numpy and the standard library; never jax, and
nothing of the sz3_tpu package, whose counterpart files the docstrings name.
"""

from .api import compress, decompress, open_archive, pack_archive
from .config import ALGO, EB, INTERP_ALGO, Config, DataType

__all__ = ["Config", "EB", "ALGO", "INTERP_ALGO", "DataType",
           "compress", "decompress", "open_archive", "pack_archive"]
