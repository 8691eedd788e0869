"""lorenzo_passes.encode: the sweep passes LORENZO_REG's encode makes until
its selection certifies, the ``passes`` the program's ``lorenzo.encode``
span takes (ops/blockwise_wavefront_encode.encode_blocks_wavefront), the
mean over the window's compresses."""

from szbench.harness import program_spans

LAYER = "LORENZO_REG encode"
MOVES = "compress_kernel_GBps"
WRAPS = ()


def read(r):
    program_spans.report(r)
    passes = [s.attrs["passes"] for s in program_spans.named(r, "lorenzo.encode", "compress")
              if "passes" in s.attrs]
    return sum(passes) / len(passes) if passes else None
