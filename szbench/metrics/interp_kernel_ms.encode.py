"""interp_kernel_ms.encode: the kernel time of the INTERP passes, a
compress: the union of the intervals of the kernels launched inside the
program's ``interp.passes`` spans (algos/device_encode.pack_device: the
bins grid, the working copy of the field and the passes), from the device
trace, over the window's compresses, ms."""

from szbench.harness import program_spans

LAYER = "INTERP passes"
MOVES = "compress_kernel_GBps"
WRAPS = ()


def read(r):
    return program_spans.kernel_ms_per_call(r, "interp.passes", "compress")
