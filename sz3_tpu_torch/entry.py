"""Single-call entry points of the port.

entry: the single-step INTERP encode (ops/interp_fast.encode_step, the
counterpart of sz3_tpu/ops/interp_fast.py::_jit_encode) at 64^3 with its
input, on the CUDA card by default. It runs the multi-level predict+quantize
passes of the default algorithm (plain PyTorch on the device, as the JAX
package runs them through XLA) over every element, and hands back the bins
as one flat int32 tensor.

dryrun_multichip: the multi-device dry run of parallel/sharded.py
(encode -> OpenMP-format archive -> decode over gloo ranks), re-exported so
that one module holds both single-call entry points.

    from sz3_tpu_torch.entry import entry
    run, (x,) = entry("cuda")        # entry("cpu") on a machine without a card
    bins, b0 = run(x)
"""

from __future__ import annotations

import numpy as np

from .api import on_device
from .ops.interp_fast import encode_step
from .parallel.sharded import dryrun_multichip

__all__ = ["encode_step", "entry", "dryrun_multichip"]


def entry(device="cuda"):
    """(run, (x,)): the single-step INTERP encode at 64^3 (cubic, the first
    direction, anchor stride 32, alpha 1.25, beta 2, ABS 1e-3, 65536 bins,
    float32) and a random-walk field on `device`, made from seed 0."""
    shape = (64, 64, 64)
    rng = np.random.default_rng(0)
    x = on_device(np.cumsum(rng.standard_normal(shape).astype(np.float32), axis=-1) * 0.1,
                  device)
    _, run = encode_step(shape, 1, 0, 32, 1.25, 2.0, 1e-3, 65536, "float32")
    return run, (x,)
