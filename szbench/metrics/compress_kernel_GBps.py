"""compress_kernel_GBps: the input bytes of every compress of the window
over the seconds in which the card ran a kernel that those calls launched
(the union of their kernels' intervals, from the device trace), 10^9 bytes
a second. The compress's device side, by which GPU compressors are
compared; the copies, which follow the host's pace, and the host's own
work are left out (compress_wall_GBps has them)."""

TRACE = True     # read from the device trace, in every run


def read(r):
    s = r.kernel_s("compress") if r.traced else 0.0
    return sum(c.nbytes for c in r.of("compress")) / s / 1e9 if s > 0 else None
