"""Archive stream order on the device (counterpart of sz3_tpu/ops/stream_layout.py
and of the slot->grid gather map in sz3_tpu/algos/device_encode.py:100-110).

The host engine gives the dense stream-order permutation
(``runtime.interp_order``: perm[i] = flat grid index of stream slot i). On
the card a gather is cheap, so the stream is one indexed gather through the
permutation, uploaded once per configuration as int32; the TPU's gather-free
pad/transpose layout and its SENTINEL pads have no counterpart here.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from sz3_tpu.config import ALGO, Config

from ..build import host_engine


def _order(dims, interp_algo: int, direction: int, anchor_stride: int) -> np.ndarray:
    """Stream-order permutation (int64, data-independent). interp_algo
    matters: linear and cubic emit block-boundary points in a different order
    (InterpolationDecomposition.hpp:247-402)."""
    c = Config(dims=dims, cmprAlgo=ALGO.INTERP)
    c.interpAlgo = interp_algo
    c.interpDirection = direction
    c.interpAnchorStride = anchor_stride
    return host_engine().interp_order(c)


# One entry each: a simulation writes the same shape every step, and an entry
# is large (at 512^3 the host copy holds 1 GiB, the device copy 512 MiB). The
# encode keeps only the device copy, the decode only the host copy.

@lru_cache(maxsize=1)
def host_perm(dims, interp_algo: int, direction: int, anchor_stride: int) -> np.ndarray:
    """The permutation on the host, for the decode's ``runtime.perm_place``."""
    return _order(dims, interp_algo, direction, anchor_stride)


@lru_cache(maxsize=1)
def device_perm(dims, interp_algo: int, direction: int, anchor_stride: int,
                device: torch.device) -> torch.Tensor:
    """The permutation as int32 on `device`, uploaded once per configuration."""
    perm = _order(dims, interp_algo, direction, anchor_stride)
    return torch.from_numpy(perm.astype(np.int32)).to(device)


def to_stream(grid: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Grid-order values -> stream order."""
    return grid.reshape(-1).index_select(0, perm)


def literal_values(x: torch.Tensor, perm: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """The original values at the stream slots `slots`, in their order."""
    return x.reshape(-1).index_select(0, perm.index_select(0, slots))
