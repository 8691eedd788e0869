"""interp_encode_roofline: the INTERP encode passes on the card, their bytes
bound (szbench/roofline/interp_encode.py, from the ``points`` and
``predicted`` of the program's ``interp.passes`` spans and the element size
of the call's data) over the seconds in which the card ran an operation
launched inside those spans of the window's compresses (the union of their
intervals: the bins grid's zeros, the working copy and the passes), %. None
where the spans do not carry ``predicted``."""

import numpy as np

from szbench.harness import program_spans
from szbench.harness.reading import inside, merge
from szbench.roofline import interp_encode, stages

LAYER = "INTERP passes"
MOVES = "compress_kernel_GBps"
WRAPS = ()


def _device_s(r, spans) -> float:
    """Seconds in which the card ran any operation launched inside `spans`."""
    gs, ge = merge(np.array([s.t0 for s in spans], np.int64),
                   np.array([s.t1 for s in spans], np.int64))
    m = inside(r.ops.launch, gs, ge)
    ks, ke = merge(r.ops.start[m], r.ops.end[m])
    return float((ke - ks).sum()) / 1e9


def read(r):
    program_spans.report(r)
    spans = program_spans.named(r, "interp.passes", "compress")
    if not r.traced or not spans or any("predicted" not in s.attrs for s in spans):
        return None
    roots = {s.id: s for s in program_spans.taken() if s.parent is None}
    nbytes = 0
    for s in spans:
        root = roots.get(s.call)
        if root is None or "dtype" not in root.attrs:
            return None
        nbytes += interp_encode.interp_encode_bytes(s.attrs["points"], s.attrs["predicted"],
                                                    np.dtype(root.attrs["dtype"]).itemsize)
    return stages.share_pct(nbytes, _device_s(r, spans))
