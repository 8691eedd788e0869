"""Archive stream order on the device (counterpart of sz3_tpu/ops/stream_layout.py,
sz3_tpu/ops/stream_unlayout.py and of the slot->grid gather map in
sz3_tpu/algos/device_encode.py:100-110).

The host engine gives the dense stream-order permutation
(``runtime.interp_order``: perm[i] = flat grid index of stream slot i). On
the card a gather or a scatter is cheap, so the encode's stream is one
indexed gather through the permutation and the decode's grid one indexed
scatter through the same permutation, uploaded once per configuration as
int32; the TPU's gather-free pad/transpose layouts and their SENTINEL pads
have no counterpart here.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import runtime
from ..config import ALGO, Config


def _order(dims, interp_algo: int, direction: int, anchor_stride: int) -> np.ndarray:
    """Stream-order permutation (int64, data-independent). interp_algo
    matters: linear and cubic emit block-boundary points in a different order
    (InterpolationDecomposition.hpp:247-402)."""
    c = Config(dims=dims, cmprAlgo=ALGO.INTERP)
    c.interpAlgo = interp_algo
    c.interpDirection = direction
    c.interpAnchorStride = anchor_stride
    return runtime.interp_order(c)


# Two entries: a simulation writes the same shape every step, and the chunks
# of an OpenMP-format archive come in at most two shapes (ragged heights
# differ by one); an entry is large (512 MiB on the device at 512^3). Encode
# and decode share them.

@lru_cache(maxsize=2)
def device_perm(dims, interp_algo: int, direction: int, anchor_stride: int,
                device: torch.device) -> torch.Tensor:
    """The permutation as int32 on `device`, uploaded once per configuration."""
    perm = _order(dims, interp_algo, direction, anchor_stride)
    return torch.from_numpy(perm.astype(np.int32)).to(device)


def to_stream(grid: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Grid-order values -> stream order."""
    return grid.reshape(-1).index_select(0, perm)


def cache_device(device) -> torch.device:
    """`device` as a key of the permutation caches: one entry per card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def from_stream(dense: torch.Tensor, perm: torch.Tensor, numel: int) -> torch.Tensor:
    """Stream-order values -> flat grid order (the inverse of to_stream).
    Grid points that no stream slot maps to are zeros."""
    n = dense.shape[0] if dense.dim() == 1 else -1
    if dense.dim() != 1 or perm.shape != dense.shape or n > numel:
        raise ValueError(f"stream of {tuple(dense.shape)} and permutation of "
                         f"{tuple(perm.shape)} do not fit a grid of {numel} points")
    if n == numel:
        grid = torch.empty(numel, dtype=dense.dtype, device=dense.device)
    else:
        grid = torch.zeros(numel, dtype=dense.dtype, device=dense.device)
    grid[perm] = dense
    return grid


def literal_values(x: torch.Tensor, perm: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """The original values at the stream slots `slots`, in their order."""
    return x.reshape(-1).index_select(0, perm.index_select(0, slots))


def literal_grid(values: torch.Tensor, perm: torch.Tensor, slots: torch.Tensor,
                 numel: int) -> torch.Tensor:
    """The inverse of literal_values: a flat grid of zeros with values[k] at
    the grid point of stream slot slots[k]."""
    grid = torch.zeros(numel, dtype=values.dtype, device=values.device)
    grid[perm.index_select(0, slots)] = values
    return grid
