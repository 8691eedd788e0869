"""tuner_launches.encode: the kernels the INTERP tuner launches, a compress:
the kernels launched inside the program's ``dispatch.tune`` spans
(algos/tuner.tune: the trial encodes of its three stages, the trial streams'
gathers) of the window's compresses, from the device trace, over the
compresses. On small fields the trials are many small kernels launched one
by one by the host, and their count sets the tuner's pace."""

import numpy as np

from szbench.harness import program_spans
from szbench.harness.reading import inside, merge
from szbench.harness.trace import KINDS

LAYER = "tuner"
MOVES = "compress_kernel_GBps"
WRAPS = ()


def read(r):
    program_spans.report(r)
    spans = program_spans.named(r, "dispatch.tune", "compress")
    if not r.traced or not spans:
        return None
    gs, ge = merge(np.array([s.t0 for s in spans], np.int64),
                   np.array([s.t1 for s in spans], np.int64))
    kernels = inside(r.ops.launch, gs, ge) & (r.ops.kind == KINDS.index("kernel"))
    return int(kernels.sum()) / len(r.of("compress"))
