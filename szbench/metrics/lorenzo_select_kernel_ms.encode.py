"""lorenzo_select_kernel_ms.encode: the kernel time of LORENZO_REG's
predictor selection, a compress: the union of the intervals of the kernels
launched inside the program's ``lorenzo.select`` spans (the speculated
selection and each certifying pass's, ops/blockwise_wavefront_encode.select),
from the device trace, over the window's compresses, ms."""

from szbench.harness import program_spans

LAYER = "LORENZO_REG encode"
MOVES = "compress_kernel_GBps"
WRAPS = ()


def read(r):
    return program_spans.kernel_ms_per_call(r, "lorenzo.select", "compress")
