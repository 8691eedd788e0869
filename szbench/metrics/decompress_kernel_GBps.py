"""decompress_kernel_GBps: the decoded bytes of every decompress of the
window over the seconds in which the card ran a kernel that those calls
launched (the union of their kernels' intervals, from the device trace),
10^9 bytes a second. The decompress's device side; the stream's upload and
the host's open are left out (decompress_wall_GBps has them)."""

TRACE = True     # read from the device trace, in every run


def read(r):
    s = r.kernel_s("decompress") if r.traced else 0.0
    return sum(c.nbytes for c in r.of("decompress")) / s / 1e9 if s > 0 else None
