"""Tables of periodic orbitals like QMCPACK's einspline coefficients, made on
the device from a seed, one seed a table.

A table is [orbitals, n1, n2, n3]: orbital k is a real function on a
periodic n1 x n2 x n3 grid, as the B-spline coefficients of a plane-wave
orbital are. The recipe, in float64 and stored as float32:

  wave number  orbital k's waves lie near the shell |n| = (3 (k + 1) /
               (4 pi)) ** (1/3), the radius inside which a periodic box holds
               k + 1 integer wave vectors: the orbitals, ordered by energy,
               gain nodes as k grows
  waves        TERMS standing waves, each a product over the three axes of
               cos(2 pi n_a i / n_a-extent + phase), with its integer wave
               vector n = round(|n| d) along a direction d, its phases and
               its amplitude drawn for this orbital from the table's seed
  normalised   each orbital scaled to a mean square of 1 over its grid
  roughness    ROUGH x a standard normal draw at every point, from the
               table's seed on the device

So neighbouring orbitals are unrelated along the first axis, and each grid is
smooth and periodic. The wave vectors, phases and amplitudes are drawn on the
host, so they are the same on every device; the roughness is the device's
generator's. Table v of a pool takes its own seed, derived from the run's
data seed and v.
"""

from __future__ import annotations

import math

import torch

TERMS = 3           # standing waves an orbital
ROUGH = 1e-4        # roughness, against an orbital's root mean square of 1


def field_seed(seed: int, v: int) -> int:
    return (int(seed) * 1_000_003 + v) % 2**64


def table(shape, seed: int, dev: torch.device) -> torch.Tensor:
    """One [orbitals, n1, n2, n3] table, float32 on `dev`."""
    k_count, n1, n2, n3 = shape
    host = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    radius = (3 * torch.arange(1, k_count + 1, dtype=f64) / (4 * math.pi)) ** (1 / 3)
    d = torch.randn((k_count, TERMS, 3), generator=host, dtype=f64)
    d = d / d.norm(dim=-1, keepdim=True)
    waves = torch.round(radius.view(-1, 1, 1) * d)                     # (k, term, axis)
    phase = 2 * math.pi * torch.rand((k_count, TERMS, 3), generator=host, dtype=f64)
    amp = 0.5 + 0.5 * torch.rand((k_count, TERMS), generator=host, dtype=f64)
    waves, phase, amp = waves.to(dev), phase.to(dev), amp.to(dev)
    out = torch.zeros(shape, dtype=f64, device=dev)
    for t in range(TERMS):
        term = amp[:, t].view(-1, 1, 1, 1)
        for a, n in enumerate((n1, n2, n3)):
            i = torch.arange(n, dtype=f64, device=dev)
            wave = torch.cos(2 * math.pi * waves[:, t, a, None] * i / n + phase[:, t, a, None])
            term = term * wave.view([k_count] + [n if b == a else 1 for b in range(3)])
        out += term
        del term
    out /= out.square().mean(dim=(1, 2, 3), keepdim=True).sqrt()
    g = torch.Generator(device=dev).manual_seed(seed)
    out += ROUGH * torch.randn(shape, generator=g, dtype=f64, device=dev)
    return out.to(torch.float32)


def make(shape, count: int, seed: int, device) -> torch.Tensor:
    """(count, *shape) float32 on `device`; shape is 4D."""
    dev = torch.device(device)
    out = torch.empty((count, *shape), dtype=torch.float32, device=dev)
    for v in range(count):
        out[v] = table(tuple(shape), field_seed(seed, v), dev)
    return out
