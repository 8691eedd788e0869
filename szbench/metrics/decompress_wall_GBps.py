"""decompress_wall_GBps: the decoded bytes over the summed wall of the
decompress calls, each ended on its output on the card, 10^9 bytes a
second (host clock). Read per layer, in the traced run, for the reason
compress_wall_GBps gives."""

LAYER = "api, serving"
MOVES = "decompress_kernel_GBps"


def read(r):
    wall = r.wall_s("decompress")
    return sum(c.nbytes for c in r.of("decompress")) / wall / 1e9 if wall > 0 else None
