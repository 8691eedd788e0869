"""What a per-layer metric reads: the timed calls, the host spans and the
device operations of a run, with the reductions they share.

A metric's reader (szbench/metrics/<metric>.py) gets one ``Reading`` and
returns a number, or None when it finds nothing to read; then the metric is
left out of the result line.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .spans import Span
from .trace import KINDS, DeviceOps, empty_ops


class Call(NamedTuple):
    """One timed call of the program: "compress" or "decompress"."""
    kind: str
    t0: int             # time.perf_counter_ns() before the call
    t1: int             # ... after it returned and the card was synchronised
    nbytes: int         # the field bytes it took (compress) or gave back (decompress)
    fields: int
    archive_bytes: int  # the archives it wrote (compress) or read (decompress)


def merge(starts: np.ndarray, ends: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The union of intervals, as sorted disjoint (starts, ends)."""
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    new = np.empty(s.size, bool)
    new[0] = True
    new[1:] = s[1:] > e[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, s.size - 1)
    return s[first], e[last]


def covered(gs: np.ndarray, ge: np.ndarray, lo: int, hi: int) -> int:
    """ns of the disjoint sorted intervals (gs, ge) inside [lo, hi]."""
    i0 = int(np.searchsorted(ge, lo, "right"))
    i1 = int(np.searchsorted(gs, hi, "left"))
    if i1 <= i0:
        return 0
    return int((np.minimum(ge[i0:i1], hi) - np.maximum(gs[i0:i1], lo)).sum())


def inside(points: np.ndarray, gs: np.ndarray, ge: np.ndarray) -> np.ndarray:
    """Mask of the points that lie in one of the disjoint sorted intervals."""
    if gs.size == 0:
        return np.zeros(points.shape, bool)
    i = np.searchsorted(gs, points, "right") - 1
    ok = i >= 0
    ok[ok] = points[ok] <= ge[i[ok]]
    return ok


class Reading:
    def __init__(self, calls: List[Call], spans: Dict[str, List[Span]],
                 ops: Optional[DeviceOps] = None) -> None:
        self.calls = calls
        self._spans = spans
        self.ops = ops if ops is not None else empty_ops()
        self.traced = ops is not None and ops.start.size > 0   # the card ran something
        self._busy = merge(self.ops.start, self.ops.end)

    def of(self, kind: str) -> List[Call]:
        return [c for c in self.calls if c.kind == kind]

    def spans(self, keys: Iterable[str]) -> List[Span]:
        return [s for k in keys for s in self._spans.get(k, ())]

    def wall_s(self, kind: str) -> float:
        return sum(c.t1 - c.t0 for c in self.of(kind)) / 1e9

    def _launched_in(self, keys: Sequence[str], kinds=KINDS) -> np.ndarray:
        sp = self.spans(keys)
        gs, ge = merge(np.array([s.t0 for s in sp], np.int64), np.array([s.t1 for s in sp],
                                                                         np.int64))
        mask = inside(self.ops.launch, gs, ge)
        if tuple(kinds) != KINDS:
            mask &= np.isin(self.ops.kind, [KINDS.index(k) for k in kinds])
        return mask

    def device_s(self, keys: Sequence[str]) -> float:
        """Seconds the card spent on the operations launched inside the
        spans of `keys` (each operation's own time, summed)."""
        m = self._launched_in(keys)
        return float((self.ops.end[m] - self.ops.start[m]).sum()) / 1e9

    def launches(self, keys: Sequence[str], kinds=("kernel",)) -> int:
        """Device operations of `kinds` launched inside the spans of `keys`."""
        return int(self._launched_in(keys, kinds).sum())

    def busy_in(self, windows: Iterable[Tuple[int, int]]) -> float:
        """Seconds in which the card ran anything, inside the windows."""
        gs, ge = self._busy
        return sum(covered(gs, ge, lo, hi) for lo, hi in windows) / 1e9

    def kernel_s(self, kind: str) -> float:
        """Seconds in which the card ran a kernel launched inside the
        `kind` calls (the union of those kernels' intervals; copies and
        fills left out)."""
        calls = self.of(kind)
        cs, ce = merge(np.array([c.t0 for c in calls], np.int64),
                       np.array([c.t1 for c in calls], np.int64))
        m = inside(self.ops.launch, cs, ce) & (self.ops.kind == KINDS.index("kernel"))
        ks, ke = merge(self.ops.start[m], self.ops.end[m])
        return float((ke - ks).sum()) / 1e9

    def call_windows(self) -> List[Tuple[int, int]]:
        return [(c.t0, c.t1) for c in self.calls]

    def breakdown(self, labels: Dict[str, str], top: int = 10) -> dict:
        """Inside the timed calls: the device operations that took most
        time (by name), and the idle time by what the host was doing, the
        innermost span open at a gap's middle (`labels` maps span keys to
        names; outside every span, the call's kind)."""
        ops = self.ops
        calls = self.call_windows()
        cs, ce = merge(np.array([a for a, _ in calls], np.int64),
                       np.array([b for _, b in calls], np.int64))
        mine = inside(ops.launch, cs, ce)
        dur = np.where(mine, ops.end - ops.start, 0).astype(np.float64)
        by_name = np.bincount(ops.name, weights=dur, minlength=len(ops.names))
        order = [i for i in np.argsort(-by_name)[:top] if by_name[i] > 0]
        device_ops = [[ops.names[i][:200], float(by_name[i]) / 1e9] for i in order]

        gs, ge = self._busy
        gap_s, gap_e = [], []
        for lo, hi in zip(cs.tolist(), ce.tolist()):
            i0, i1 = np.searchsorted(ge, lo, "right"), np.searchsorted(gs, hi, "left")
            b_s, b_e = np.clip(gs[i0:i1], lo, hi), np.clip(ge[i0:i1], lo, hi)
            gap_s.append(np.concatenate([[lo], b_e]))
            gap_e.append(np.concatenate([b_s, [hi]]))
        gap_s = np.concatenate(gap_s) if gap_s else np.zeros(0, np.int64)
        gap_e = np.concatenate(gap_e) if gap_e else np.zeros(0, np.int64)
        keep = gap_e > gap_s
        gap_s, gap_e = gap_s[keep], gap_e[keep]
        mid = (gap_s + gap_e) // 2
        order_mid = np.argsort(mid)
        gap_s, gap_e, mid = gap_s[order_mid], gap_e[order_mid], mid[order_mid]
        best = np.full(mid.size, np.inf)
        label = np.full(mid.size, -1)
        groups = [(f"{c.kind} call", [(c.t0, c.t1)]) for c in self.calls]
        groups += [(labels.get(k, k), [(s.t0, s.t1) for s in v]) for k, v in self._spans.items()]
        names = []
        for name, iv in groups:
            if name not in names:
                names.append(name)
            for t0, t1 in iv:
                sel = slice(np.searchsorted(mid, t0, "left"), np.searchsorted(mid, t1, "right"))
                better = best[sel] > (t1 - t0)
                best[sel] = np.where(better, t1 - t0, best[sel])
                label[sel] = np.where(better, names.index(name), label[sel])
        idle = np.bincount(label + 1, weights=(gap_e - gap_s).astype(np.float64),
                           minlength=len(names) + 1)
        idle_gaps = sorted(([names[i - 1] if i else "outside the calls", float(v) / 1e9]
                            for i, v in enumerate(idle) if v > 0), key=lambda kv: -kv[1])
        return {"device_ops": device_ops, "idle_gaps": idle_gaps[:top]}
