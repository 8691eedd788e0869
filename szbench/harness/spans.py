"""Host spans around the port's entry points, taken from outside the port.

In a traced run the harness replaces each entry point that a per-layer
metric lists (``"package.module:attribute"``) by a wrapper that records the
host clock around the call and the numbers the metric's ``note`` takes from
its arguments. Callers that look the attribute up on its module at call
time see the wrapper; ``restore`` puts the originals back.
"""

from __future__ import annotations

import functools
import importlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple


class Span(NamedTuple):
    t0: int          # time.perf_counter_ns() at entry
    t1: int          # ... and at return
    info: dict       # what the metrics' notes took from the call


class Recorder:
    def __init__(self) -> None:
        self.spans: Dict[str, List[Span]] = defaultdict(list)
        self._saved = []

    def wrap(self, key: str, notes: List[Callable]) -> None:
        """Wrap the attribute `key` ("module:attribute"); `notes` are called
        as note(key, args, kwargs, result) after each call and return a dict
        or None."""
        modname, attr = key.split(":")
        mod = importlib.import_module(modname)
        real = getattr(mod, attr)
        spans = self.spans[key]

        @functools.wraps(real)          # keeps attributes such as a launch counter
        def inner(*args, **kwargs):
            t0 = time.perf_counter_ns()
            try:
                out = real(*args, **kwargs)
            except BaseException:
                spans.append(Span(t0, time.perf_counter_ns(), {}))
                raise
            t1 = time.perf_counter_ns()
            info = {}
            for note in notes:
                info.update(note(key, args, kwargs, out) or {})
            spans.append(Span(t0, t1, info))
            return out

        setattr(mod, attr, inner)
        self._saved.append((mod, attr, real))

    def restore(self) -> None:
        while self._saved:
            mod, attr, real = self._saved.pop()
            setattr(mod, attr, real)
