"""setup_s: process start to the first timed call, s: imports, the CUDA
context, the inputs made on the card and copied to the host, and the
entry's warm-up (on a checkout's first run also the builds of the
program's engine and kernels)."""


def read(r):
    return r.setup_s
