"""tuner_kernel_ms.encode: the kernel time of the INTERP tuner's trials, a
compress: the union of the intervals of the kernels launched inside the
program's ``dispatch.tune`` spans (algos/tuner.tune: the sampled blocks'
upload, the trial encodes, the trial streams' read-backs), from the device
trace, over the window's compresses, ms."""

from szbench.harness import program_spans

LAYER = "tuner"
MOVES = "compress_kernel_GBps"
WRAPS = ()


def read(r):
    return program_spans.kernel_ms_per_call(r, "dispatch.tune", "compress")
