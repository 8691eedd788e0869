"""The port's copies between the host and the device, in one place.

Reads back to the host (``to_host``) go into page-locked memory, queued on
the current stream: the caller records an event after them and waits on it
before it reads the host buffer. Uploads (``to_device``) go from pageable
memory in a ``copy.h2d`` span. A policy for either direction (pinned
staging of uploads, say) is a change to one function here.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import trace


def device_of(device) -> torch.device:
    """`device` as a torch.device the port runs on: the CPU or a CUDA card
    (RuntimeError when CUDA is asked for and there is none)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested, but torch.cuda.is_available() is False")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_host(t: torch.Tensor) -> torch.Tensor:
    """`t` on the host: from the card a page-locked copy, queued on the
    current stream; a CPU tensor as it is."""
    if t.device.type == "cpu":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def to_device(a, device) -> torch.Tensor:
    """The host array `a`, writable or read-only, as a tensor on `device`,
    copied from pageable memory. On the CPU a writable contiguous array is
    shared and a read-only one copied."""
    a = np.ascontiguousarray(a)
    with trace.span("copy.h2d", bytes=a.nbytes, pinned=False):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)   # a read-only buffer is only read
            t = torch.from_numpy(a)
        return t.to(device, copy=not a.flags.writeable)


def on_device(x, device=None) -> torch.Tensor:
    """`x` (a tensor or an array) as a tensor on `device`. device=None keeps
    a tensor where it is and puts an array on the CUDA card (which raises
    without one)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device_of(device))
    return to_device(x, device_of("cuda" if device is None else device))
