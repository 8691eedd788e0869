"""compress_wall_GBps: the input bytes of every compress of the window over
the summed wall of those calls, 10^9 bytes a second (host clock, each call
ended by torch.cuda.synchronize()). What a writer of output steps waits
for. Its runs follow the host's pace, which moves whole runs by up to a
third on a shared host, so it is read per layer, in the traced run."""

LAYER = "api, serving"
MOVES = "compress_kernel_GBps"


def read(r):
    wall = r.wall_s("compress")
    return sum(c.nbytes for c in r.of("compress")) / wall / 1e9 if wall > 0 else None
