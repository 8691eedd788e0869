"""The device's side of a traced run: torch.profiler over the window.

Every operation the card ran (kernels, copies, fills) comes back with its
start and end and the host time of the call that launched it, all on the
host's ``time.perf_counter_ns`` clock. A marker recorded under the profiler
at the start of the window places the profiler's clock on the host's (the
method of chip_smoke.py's phase 8); a second marker at the end gives the
drift, which is printed.
"""

from __future__ import annotations

import sys
import time
from typing import NamedTuple

import numpy as np

MARK_START = "szbench: window start"
MARK_END = "szbench: window end"
_LAUNCHES = ("cuda_runtime", "cuda_driver")
KINDS = ("kernel", "copy", "fill")


def _activity(e) -> str:
    """The event's activity ("kernel", "cuda_runtime", ...), where this
    torch's events tell it; else ""."""
    get = getattr(e, "activity_type", None)
    return get() if get is not None else ""


def _is_launch(activity: str, name: str) -> bool:
    """A CUDA runtime or driver call (cudaLaunchKernel, cuLaunchKernel,
    cudaMemcpyAsync, ...), the host side of a device operation."""
    if activity:
        return activity in _LAUNCHES
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def kind_of(activity: str, name: str) -> int:
    """Index into KINDS of a device operation."""
    low = f"{activity} {name}".lower()
    if "memcpy" in low:
        return 1
    if "memset" in low:
        return 2
    return 0


class DeviceOps(NamedTuple):
    """The traced window's device operations, as arrays (ns, host clock)."""
    start: np.ndarray
    end: np.ndarray
    launch: np.ndarray      # host time of the launching call; -1 where none was found
    kind: np.ndarray        # index into KINDS
    name: np.ndarray        # index into names
    names: list


def empty_ops() -> DeviceOps:
    z = np.zeros(0, np.int64)
    return DeviceOps(z, z, z, z, z, [])


class Session:
    """torch.profiler with CPU and CUDA activities, started and stopped by
    the harness around the traced window."""

    def __init__(self, cuda: bool = True) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self._prof = profile(activities=acts)
        self._cuda = cuda
        self._marks = {}

    def _mark(self, name: str) -> None:
        from torch.profiler import record_function

        with record_function(name):
            self._marks[name] = time.perf_counter_ns()

    def start(self) -> None:
        self._prof.start()
        self._mark(MARK_START)

    def stop(self) -> None:
        import torch

        self._mark(MARK_END)
        if self._cuda:
            torch.cuda.synchronize()
        self._prof.stop()

    def device_ops(self) -> DeviceOps:
        from torch.autograd import DeviceType

        events = self._prof.profiler.kineto_results.events()
        launch_at, op_at, marks, dev = {}, {}, {}, []
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                dev.append(e)
                continue
            name = e.name()
            if name in self._marks:
                marks[name] = e.start_ns()
            corr = e.correlation_id()
            if corr:
                (launch_at if _is_launch(_activity(e), name) else op_at)[corr] = e.start_ns()
        if MARK_START not in marks:
            raise RuntimeError("the profiler did not record the window's start marker")
        off = marks[MARK_START] - self._marks[MARK_START]
        if MARK_END in marks:
            drift = marks[MARK_END] - self._marks[MARK_END] - off
            print(f"szbench: profiler clock drift over the window {drift / 1e3:.1f} us",
                  file=sys.stderr)
        n = len(dev)
        start, end = np.empty(n, np.int64), np.empty(n, np.int64)
        launch, kind, name = np.full(n, -1, np.int64), np.empty(n, np.int64), np.empty(n, np.int64)
        names, index = [], {}
        by_link = 0
        for i, e in enumerate(dev):
            s = e.start_ns()
            start[i], end[i] = s, s + e.duration_ns()
            at = launch_at.get(e.correlation_id())
            if at is None:
                at = op_at.get(e.linked_correlation_id())
                by_link += at is not None
            if at is not None:
                launch[i] = at - off
            nm = e.name()
            kind[i] = kind_of(_activity(e), nm)
            if nm not in index:
                index[nm] = len(names)
                names.append(nm)
            name[i] = index[nm]
        start -= off
        end -= off
        lost = int((launch < 0).sum())
        counts = np.bincount(kind, minlength=len(KINDS)).tolist()
        print(f"szbench: {n} device operations traced ({dict(zip(KINDS, counts))}); "
              f"launches found for {n - lost} ({by_link} through the launching op), none for "
              f"{lost}; {len(launch_at)} runtime calls, {len(op_at)} ops", file=sys.stderr)
        return DeviceOps(start, end, launch, kind, name, names)
