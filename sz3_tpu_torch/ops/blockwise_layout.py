"""Block geometry and the block-major stream order of ALGO_LORENZO_REG on the
device (the port's copy of what both directions need from
sz3_tpu/ops/blockwise_device.py, and the counterpart of the TPU layouts in
sz3_tpu/ops/blockwise_wavefront.py and sz3_tpu/algos/device_encode.py).

The format cuts a 3D field into 6^3 blocks in row-major order (tail blocks
are cut short by the field's edge) and stores the element bins block by
block, each block's cells row-major, valid cells only. The sweep works on the
rounded grid, (nb0*6, nb1*6, nb2*6), front-padded by 2 in every axis.

On the card a gather is cheap, so the stream order is one cached
permutation from stream slot to flat index of the rounded grid, built on the
device from ``arange`` arithmetic: stream bins are ``grid.flatten()[perm]``,
literals ``x.flatten()[perm[slots]]``, and the decode scatters through the
same permutation (``ops/stream_order``). It replaces the TPU's gather-free pieces
(``stream_to_blocked``, ``valid_mask`` / ``slot_to_grid`` / ``to_stream``,
``_grid_to_blocks`` / ``_blocks_to_grid``); there are no SENTINEL pads.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import torch

from . import stream_order

BS = 6          # the reference's block size for 3D (Config.hpp:175)
PAD = 2         # front pad of the sweep's grid: the second-order stencil's reach

# per-cell predictor types of the sweep: the two Lorenzo stencils, and cells
# the sweep leaves as they are (regression blocks, pre-placed, and cells
# outside the field)
T_L1, T_L2, T_KEEP = 0, 1, 2


def _noise(order: int, n_dims: int, eb: float) -> float:
    n1 = [0, 0.5, 0.81, 1.22, 1.79]
    n2 = [0, 1.08, 2.76, 6.8]
    return (n1[n_dims] if order == 1 else (n2[n_dims] if n_dims <= 3 else 0.0)) * eb


class Geometry(NamedTuple):
    dims: Tuple[int, int, int]      # the field
    nb: Tuple[int, int, int]        # blocks per axis
    grid: Tuple[int, int, int]      # the rounded grid, nb * 6 per axis

    @property
    def nblk(self) -> int:
        return self.nb[0] * self.nb[1] * self.nb[2]

    @property
    def ncells(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def padded(self) -> Tuple[int, int, int]:
        return tuple(g + PAD for g in self.grid)


def geometry(dims) -> Geometry:
    dims = tuple(int(d) for d in dims)
    if len(dims) != 3 or min(dims) < 1:
        raise ValueError(f"the blockwise sweep takes 3D fields, not {dims}")
    nb = tuple(-(-d // BS) for d in dims)
    return Geometry(dims, nb, tuple(n * BS for n in nb))


def extents(geo: Geometry, device) -> torch.Tensor:
    """(3, nb0, nb1, nb2) int32: each block's extent along each axis."""
    out = torch.empty((3, *geo.nb), dtype=torch.int32, device=device)
    for a in range(3):
        e = (geo.dims[a] - BS * torch.arange(geo.nb[a], dtype=torch.int32, device=device)
             ).clamp(max=BS)
        shape = [1, 1, 1]
        shape[a] = geo.nb[a]
        out[a] = e.reshape(shape)
    return out


def reg_valid(geo: Geometry, device) -> torch.Tensor:
    """(nb0, nb1, nb2) bool: blocks a regression can be fitted to (every
    extent above 1; _reg_valid_static in the JAX package)."""
    return (extents(geo, device) > 1).all(dim=0)


def blocked(a: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """Rounded-grid tensor -> its (nb0, 6, nb1, 6, nb2, 6) view."""
    return a.reshape(geo.nb[0], BS, geo.nb[1], BS, geo.nb[2], BS)


def to_blocks(a: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """Rounded-grid tensor -> (nblk, 216) in block-major order, row-major
    cells inside a block."""
    return blocked(a, geo).permute(0, 2, 4, 1, 3, 5).reshape(geo.nblk, BS ** 3)


def per_block(v: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """(nb0, nb1, nb2, ...) per-block values -> a view that broadcasts
    against ``blocked``."""
    return v.reshape(geo.nb[0], 1, geo.nb[1], 1, geo.nb[2], 1, *v.shape[3:])


def valid_cells(geo: Geometry, device) -> torch.Tensor:
    """(NX, NY, NZ) bool: the rounded grid's cells inside the field."""
    ax = [torch.arange(g, device=device) < d for g, d in zip(geo.grid, geo.dims)]
    return ax[0][:, None, None] & ax[1][None, :, None] & ax[2][None, None, :]


def element_masks(geo: Geometry, device) -> torch.Tensor:
    """(nblk, 216) bool: each block's cells inside the field, in stream
    order (_element_masks in the JAX package)."""
    return to_blocks(valid_cells(geo, device), geo)


# Two entries: a simulation writes the same shape every step, and the chunks
# of an OpenMP-format archive come in at most two shapes; an entry is large
# (537 MB on the device at 512^3).

@lru_cache(maxsize=2)
def device_perm(dims, device: torch.device) -> torch.Tensor:
    """The block-major stream order of a field of `dims` as int32 on
    `device`: perm[slot] = flat index of the rounded grid."""
    geo = geometry(dims)
    if geo.ncells >= 2 ** 31:
        raise ValueError(f"a rounded grid of {geo.ncells} cells does not fit int32 indices")
    idx = torch.arange(geo.ncells, dtype=torch.int32, device=device).reshape(geo.grid)
    return to_blocks(idx, geo)[element_masks(geo, device)]


def perm_for(dims, device) -> torch.Tensor:
    return device_perm(tuple(int(d) for d in dims), stream_order.cache_device(device))
