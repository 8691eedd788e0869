"""Smooth fields of any rank, made on the device from a seed, one seed a field.

The recipe is chip_smoke.py's ``wave_field``: waves at three scales (a
product of sines along the axes, each with a random phase) and a mild random
walk along the last axis, as a climate variable's smooth large-scale
structure with small-scale noise. Field v of a pool takes its own seed,
derived from the run's seed and v.
"""

from __future__ import annotations

import math

import torch


def field_seed(seed: int, v: int) -> int:
    return (int(seed) * 1_000_003 + v) % 2**64


def wave_field(shape, seed: int, dev: torch.device) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(seed)
    phases = torch.rand((3, len(shape)), generator=g, device=dev, dtype=torch.float64).cpu()
    f = torch.zeros(shape, dtype=torch.float32, device=dev)
    for k, freq in enumerate((2.0, 6.0, 16.0)):
        term = None
        for ax, n in enumerate(shape):
            v = torch.sin(torch.linspace(0, freq * math.pi, n, device=dev, dtype=torch.float64)
                          + 2 * math.pi * float(phases[k, ax])).float()
            v = v.view([n if i == ax else 1 for i in range(len(shape))])
            term = v if term is None else term * v
        f += term / (k + 1)
        del term
    f += 0.05 / math.sqrt(shape[-1]) * torch.cumsum(
        torch.randn(shape, generator=g, device=dev), dim=-1)
    return f


def make(shape, count: int, seed: int, device) -> torch.Tensor:
    """(count, *shape) float32 on `device`."""
    dev = torch.device(device)
    out = torch.empty((count, *shape), dtype=torch.float32, device=dev)
    for v in range(count):
        out[v] = wave_field(tuple(shape), field_seed(seed, v), dev)
    return out
