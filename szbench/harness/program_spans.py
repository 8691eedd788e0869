"""The program's own layer spans (sz3_tpu_torch.utils.trace) in a traced run,
laid over the device trace.

Importing this module turns the program's spans on, without the profiler
ranges they may open (the profiler would mirror each range onto the device's
timeline as an event, which szbench/harness/trace.py would count as device
work). A metric's reader that
imports it is itself imported only in --trace 1 runs, at the start of
cell.run and before the warm-up, so --trace 0 runs stay untraced. A program
without layer spans leaves every reading here empty, and the readers return
None.

The spans are on time.perf_counter_ns(), the clock onto which
szbench/harness/trace.py places the device operations (Reading.ops) and on
which the timed calls are taken: each device operation belongs to the spans
open on the host when it was launched, and each idle gap of the card inside
the calls is split exactly among the spans that cover it, clipped to them.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence

import numpy as np

from .reading import inside, merge
from .trace import KINDS

try:
    from sz3_tpu_torch.utils import trace as _program
except ImportError:         # a program without layer spans
    _program = None
else:
    _program.enable(ranges=False)

_taken: list = []
_reported: set = set()


def taken() -> list:
    """Every span the program has ended since this module was imported."""
    if _program is not None:
        got = _program.spans()
        if got.dropped:
            print(f"szbench: the program's buffer dropped {got.dropped} spans", file=sys.stderr)
        _taken.extend(got)
    return _taken


def in_calls(r, kind: Optional[str] = None) -> list:
    """The spans that started inside the reading's timed calls (of `kind`,
    or of every kind)."""
    calls = r.of(kind) if kind else r.calls
    if not calls:
        return []
    cs, ce = merge(np.array([c.t0 for c in calls], np.int64),
                   np.array([c.t1 for c in calls], np.int64))
    spans = [s for s in taken() if s.t1 > 0]
    if not spans:
        return []
    ok = inside(np.array([s.t0 for s in spans], np.int64), cs, ce)
    return [s for s, keep in zip(spans, ok) if keep]


def named(r, name: str, kind: Optional[str] = None) -> list:
    return [s for s in in_calls(r, kind) if s.name == name]


def kernel_s(r, spans: Sequence) -> float:
    """Seconds in which the card ran a kernel launched inside `spans` (the
    union of those kernels' intervals)."""
    ops = r.ops
    gs, ge = merge(np.array([s.t0 for s in spans], np.int64),
                   np.array([s.t1 for s in spans], np.int64))
    m = inside(ops.launch, gs, ge) & (ops.kind == KINDS.index("kernel"))
    ks, ke = merge(ops.start[m], ops.end[m])
    return float((ke - ks).sum()) / 1e9


def kernel_ms_per_call(r, name: str, kind: str = "compress") -> Optional[float]:
    """The kernel time launched inside the spans `name` of the `kind`
    calls, ms a call; None with no device trace or no such span."""
    report(r)
    spans = named(r, name, kind)
    if not r.traced or not spans:
        return None
    return kernel_s(r, spans) * 1e3 / len(r.of(kind))


def _depths(spans: Sequence) -> List[int]:
    by_id = {s.id: s for s in taken()}
    depth: Dict[int, int] = {}

    def of(s) -> int:
        if s.id not in depth:
            up = by_id.get(s.parent) if s.parent is not None else None
            depth[s.id] = 0 if up is None else of(up) + 1
        return depth[s.id]
    return [of(s) for s in spans]


def idle_split(r) -> Dict[str, float]:
    """The card's idle seconds inside the timed calls, by the innermost
    program span open (the deepest; where several threads hold spans, the
    deepest of them), each gap clipped to the spans that cover it. A root
    span's name (api.compress, ...) takes what falls in no span below it;
    "(no span)" what falls in none at all."""
    calls = r.calls
    if not calls:
        return {}
    spans = [s for s in in_calls(r) if s.t1 > s.t0]
    cuts = np.unique(np.array([c.t0 for c in calls] + [c.t1 for c in calls]
                              + [s.t0 for s in spans] + [s.t1 for s in spans], np.int64))
    if cuts.size < 2:
        return {}
    lo, hi = cuts[:-1], cuts[1:]
    names = ["(no span)"]
    label = np.zeros(lo.size, np.int64)
    for d, s in sorted(zip(_depths(spans), spans), key=lambda ds: (ds[0], ds[1].t0)):
        if s.name not in names:
            names.append(s.name)
        a, b = np.searchsorted(cuts, s.t0), np.searchsorted(cuts, s.t1)
        label[a:b] = names.index(s.name)
    cs, ce = merge(np.array([c.t0 for c in calls], np.int64),
                   np.array([c.t1 for c in calls], np.int64))
    in_call = inside((lo + hi) // 2, cs, ce)
    gs, ge = merge(r.ops.start, r.ops.end)
    busy = _busy_before(gs, ge, hi) - _busy_before(gs, ge, lo)
    idle = np.where(in_call, (hi - lo) - busy, 0).astype(np.float64)
    by = np.bincount(label, weights=idle, minlength=len(names))
    return {names[i]: float(v) / 1e9 for i, v in enumerate(by) if v > 0}


def _busy_before(gs: np.ndarray, ge: np.ndarray, t: np.ndarray) -> np.ndarray:
    """ns of the disjoint sorted intervals (gs, ge) before each time of `t`."""
    if gs.size == 0:
        return np.zeros(t.shape, np.int64)
    full = np.concatenate([[0], np.cumsum(ge - gs)])
    k = np.searchsorted(gs, t, "right")           # intervals that start by t
    last = np.maximum(k - 1, 0)
    part = np.where(k > 0, np.minimum(t, ge[last]) - gs[last], 0)
    return full[last] * (k > 0) + part


def roots(r) -> set:
    """Names of the spans that started a call (no parent)."""
    return {s.name for s in in_calls(r) if s.parent is None}


def report(r) -> None:
    """Print, once a reading, the idle split and the spans a call."""
    if id(r) in _reported or not r.traced:
        return
    _reported.add(id(r))
    split = idle_split(r)
    if not in_calls(r):             # a program without layer spans
        return
    total = sum(split.values())
    outside = sum(v for k, v in split.items() if k in roots(r) or k == "(no span)")
    parts = ", ".join(f"{k} {v:.6f}" for k, v in sorted(split.items(), key=lambda kv: -kv[1]))
    print(f"szbench: card idle inside the calls by program span, clipped (s): {parts}; "
          f"outside every span below a call's root: {outside:.6f} of {total:.6f} s "
          f"({100 * outside / total if total else 0:.2f} %); "
          f"{len(in_calls(r)) / len(r.calls):.1f} spans a call", file=sys.stderr)
