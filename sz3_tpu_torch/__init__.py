"""sz3_tpu_torch: the sz3-tpu compressor in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper. Archives are SZ3 containers, byte-identical to
those of the package's own C++ host engine (runtime.py, csrc/engine/).

    import sz3_tpu_torch as szp
    blob = szp.compress(data, szp.Config(absErrorBound=1e-3), device="cuda")
    out, conf = szp.decompress(blob, device="cuda")   # out: torch.Tensor
    print(szp.verify(data, out).report())              # on out's device

The user-facing tools: ``python -m sz3_tpu_torch.cli`` (console script
``sz3t-torch``, the reference sz3 CLI's flags), ``sz3_tpu_torch.mdz.main``
(``sz3t-torch-mdz``), ``sz3_tpu_torch.h5tools`` (``sz3t-torch-h5``), the
pysz binding ``sz3_tpu_torch.pysz``, and ``sz3_tpu_torch.tools``.

The reference's four extension patterns: ``python -m
sz3_tpu_torch.examples.customized_demo [--device cpu]`` (or the file by its
path). The single-step INTERP encode at 64^3: ``run, (x,) =
sz3_tpu_torch.entry.entry(device)``, then ``bins, b0 = run(x)``
(``ops.interp_fast.encode_step`` builds the step for other shapes). Both run on
the card by default; the tests pass ``device="cpu"``, and chip_smoke.py's
phase 11 drives both on the card.

This package imports torch, numpy and the standard library (and h5py in its
HDF5 modules); never jax, and nothing of the sz3_tpu package, whose
counterpart files the docstrings name.
"""

from .api import compress, compress_size_bound, decompress, open_archive, pack_archive
from .config import ALGO, EB, INTERP_ALGO, Config, DataType
from .stats import verify

__version__ = "0.1.0"
# the data version stamped into archives (reference version.hpp.in:10-27)
SZ3_DATA_VER = (3, 3, 2)

__all__ = ["Config", "EB", "ALGO", "INTERP_ALGO", "DataType",
           "compress", "decompress", "compress_size_bound", "verify",
           "open_archive", "pack_archive"]
