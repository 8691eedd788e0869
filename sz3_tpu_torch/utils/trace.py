"""Layer spans of the port: where a compress or a decompress spends its time,
layer by layer, off by default.

    from sz3_tpu_torch.utils import trace
    trace.enable()
    blob = sz3_tpu_torch.compress(field, conf)
    for s in trace.spans():
        print(s.name, (s.t1 - s.t0) / 1e6, "ms", s.attrs)

Each layer of the port opens ``span(name, **attrs)`` around its part of a
call (PERF.md, section 3, lists every name and attribute). A span records
its name, its start and end on ``time.perf_counter_ns()``, its thread, its
parent (the innermost span open on its thread, or the handle passed as
``parent=``, as a worker thread's span takes ``current()`` of the thread
that handed it the work), the call id that every span of one public call
shares (the outermost span's id), and its attributes. Numbers known only
inside the span go in through the handle's ``set(**attrs)``. Finished spans
wait in a buffer of at most ``LIMIT``; ``spans()`` hands them over and
empties it, with the count of spans the full buffer dropped.

While a torch.profiler session is recording, a span also opens
``torch.profiler.record_function(name)``: the layers then stand in the
profiler's own timeline, over the kernels and copies they launched
(``utils.device_trace`` writes such a trace). The profiler mirrors each such
range onto the device's timeline as an annotation event, so a reader that
lays the spans over the device trace on the host clock itself (a trace
reader that counts every device event as work) passes ``ranges=False``.

Off, a span site tests one module flag and gets a shared object that does
nothing. On or off, a span site never synchronises the device, reads a
tensor's values or allocates on the card: its attributes are host numbers
the code already holds, or tensor metadata.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import List, Optional

import torch

LIMIT = 1 << 16             # spans held between two spans()

_on = False
_ranges = True
_kept: List["Span"] = []
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_profiling = getattr(torch._C._autograd, "_profiler_enabled", lambda: False)


class Taken(list):
    """The spans ``spans()`` hands over, in the order they ended;
    ``dropped`` counts those the full buffer left out."""
    dropped = 0


class _Off:
    """What a span site gets while tracing is off."""
    __slots__ = ()

    def set(self, **attrs) -> "_Off":
        return self

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One layer's part of one call. ``t1`` is 0 until the span ends."""
    __slots__ = ("name", "attrs", "t0", "t1", "thread", "id", "parent", "call", "_up", "_rf")

    def __init__(self, name: str, up: Optional["Span"], attrs: dict) -> None:
        self.name, self.attrs, self._up = name, attrs, up
        self.t0 = self.t1 = 0
        self.thread = self.id = self.call = 0
        self.parent: Optional[int] = None
        self._rf = None

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        stack = _stack()
        up = self._up if self._up is not None else (stack[-1] if stack else None)
        self._up = None
        self.id = next(_ids)
        self.parent = up.id if up is not None else None
        self.call = up.call if up is not None else self.id
        self.thread = threading.get_ident()
        stack.append(self)
        if _ranges and _profiling():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _dropped
        self.t1 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        _stack().pop()
        with _lock:
            if len(_kept) < LIMIT:
                _kept.append(self)
            else:
                _dropped += 1
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {(self.t1 - self.t0) / 1e6:.3f} ms, id={self.id}, "
                f"parent={self.parent}, call={self.call}, {self.attrs})")


def span(name: str, parent: Optional[Span] = None, **attrs):
    """A context manager around one layer's part of a call; its handle takes
    ``set(**attrs)``. `parent` overrides the innermost span open on this
    thread (a worker thread passes the handing thread's ``current()``)."""
    if not _on:
        return OFF
    return Span(name, parent, attrs)


def current() -> Optional[Span]:
    """The innermost span open on this thread (None when there is none or
    tracing is off): the parent to hand to a worker thread's spans."""
    if not _on:
        return None
    stack = _stack()
    return stack[-1] if stack else None


def enable(ranges: bool = True) -> None:
    """Record spans from now on; with `ranges`, each span is also a profiler
    range while a torch.profiler session records."""
    global _on, _ranges
    _on, _ranges = True, bool(ranges)


def disable() -> None:
    """Record no more spans (spans open now still end and are kept)."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def spans() -> Taken:
    """The finished spans, in the order they ended; empties the buffer."""
    global _kept, _dropped
    with _lock:
        out = Taken(_kept)
        out.dropped = _dropped
        _kept, _dropped = [], 0
    return out
