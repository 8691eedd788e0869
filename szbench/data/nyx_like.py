"""Snapshots of a cosmology-like density field, made on the device from a seed.

The recipe is bench.py's ``nyx_like`` (multiscale waves and a mild random
walk along the last axis, exponentiated, as a baryon density's positive,
skewed values), rewritten in torch so that it runs on the card and takes
the seed: the walk's steps come from a ``torch.Generator`` seeded with it.
Snapshot k is the seed's field rolled by 3k along axis 0, the same values
in another place, as a time series of one shape. Its value range is about
5.9 at every seed.
"""

from __future__ import annotations

import math

import torch


def make(shape, count: int, seed: int, device) -> torch.Tensor:
    """(count, *shape) float32 on `device`; shape is 3D."""
    n0, n1, n2 = shape
    dev = torch.device(device)
    ax = [torch.linspace(0, 1, n, dtype=torch.float64, device=dev) for n in shape]
    x, y, z = ax[0].view(-1, 1, 1), ax[1].view(1, -1, 1), ax[2].view(1, 1, -1)
    pi = math.pi
    f = (torch.sin(4 * pi * x) * torch.cos(6 * pi * y) * torch.sin(2 * pi * z)
         + 0.5 * torch.sin(16 * pi * (x + y)) + 0.25 * torch.cos(32 * pi * (y - z)))
    gen = torch.Generator(device=dev).manual_seed(int(seed) % 2**64)
    steps = torch.randn((n0, n1, n2), generator=gen, device=dev, dtype=torch.float64)
    f = f + 0.05 * torch.cumsum(steps, dim=2) / math.sqrt(n2)
    del steps
    base = torch.exp(f).to(torch.float32)
    del f
    out = torch.empty((count, n0, n1, n2), dtype=torch.float32, device=dev)
    for k in range(count):
        out[k] = torch.roll(base, 3 * k, dims=0)
    return out
