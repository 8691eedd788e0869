"""Small utilities (counterpart of sz3_tpu/utils/__init__.py): scoped
wall-clock timing (the reference utils/Timer.hpp analog, gated by
SZT_DEBUG_TIMINGS like the reference's SZ3_DEBUG_TIMINGS CMake option), the
port's layer spans (``utils.trace``, off by default) and a device trace over
torch.profiler that shows those spans over the kernels."""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

import torch

from . import trace


def timings_enabled() -> bool:
    return os.environ.get("SZT_DEBUG_TIMINGS", "0") not in ("", "0", "false")


class Timer:
    """Scoped timer; prints '<name> time = X.XXXXXX' only when
    SZT_DEBUG_TIMINGS is set (reference utils/Timer.hpp:30-36). stop()
    first waits for the current CUDA device when CUDA is initialized, so a
    time includes the card's work queued inside the interval."""

    def __init__(self, start: bool = False):
        self._t0 = time.perf_counter() if start else None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, name: str = "") -> float:
        if self._t0 is None:
            raise RuntimeError("Timer.stop() before start()")
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        self._t0 = None
        if timings_enabled() and name:
            print(f"{name} time = {dt:.6f}")
        return dt


@contextlib.contextmanager
def timed(name: str):
    """with timed('stage'): ...  — prints when SZT_DEBUG_TIMINGS is set."""
    t = Timer(start=True)
    try:
        yield t
    finally:
        t.stop(name)


@contextlib.contextmanager
def device_trace(log_dir):
    """Trace the block with torch.profiler (the host and, where there is a
    CUDA device, the card) and write a Chrome trace (chrome://tracing,
    Perfetto) to ``<log_dir>/trace.json``, in which the port's layer spans
    (``utils.trace``, on for the block) name the ranges over the kernels
    they launched. Yields the profiler; the block's spans stay for
    ``trace.spans()``, and tracing is left as it was before the block."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    was_on = trace.enabled()
    if not was_on:
        trace.enable()
    try:
        with profile(activities=activities) as prof:
            yield prof
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
    finally:
        if not was_on:
            trace.disable()
    prof.export_chrome_trace(str(out / "trace.json"))
