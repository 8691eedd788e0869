"""The bytes of the INTERP encode passes (csrc/interp_encode.cu, launched in
the program's ``interp.passes`` span), counted from the work as chip_smoke.py
counts its bound, each byte once:

    bytes = points x (2 E + 4) + predicted x (3 E + 4)

with E the bytes of a value, points the grid's points and predicted the
points the passes predict (every point but the anchors). A point: its value
read from the field and written to the working copy (2 E), and its bin's
zero written to the bins grid (4). A predicted point: its original read
(E), its coarse neighbours read (E: each point of the grid is read as a
neighbour by the passes after it, counted once), its reconstruction (E) and
its bin (4) written. At float32 and predicted = points that is 28 bytes a
point: 3.76 GB, 1.122 ms at 3.35 TB/s, at 512^3."""

from __future__ import annotations

BIN_BYTES = 4                 # a quantization bin, int32


def interp_encode_bytes(points: int, predicted: int, value_bytes: int) -> int:
    return points * (2 * value_bytes + BIN_BYTES) + predicted * (3 * value_bytes + BIN_BYTES)
