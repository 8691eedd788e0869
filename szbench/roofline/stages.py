"""The bytes each kernel stage has to move, counted from its work and not
from how today's kernels do it: each input byte read once, each output byte
written once (the arithmetic of chip_smoke.py's bounds). A stage's roofline
share is the least time these bytes take at the peak over the device time
the stage took."""

from __future__ import annotations

from . import peaks

SYMBOL_BYTES = 4              # a quantization bin, int32
VALUE_BYTES = 4               # a float32 value


def entropy_encode_bytes(symbols: int, total_bits: int) -> int:
    """Huffman encode (histogram, code lookup, bit packing): every symbol
    read once, the coded stream written once."""
    return SYMBOL_BYTES * symbols + (total_bits + 7) // 8


def huffman_decode_bytes(stream_bytes: int, symbols: int) -> int:
    """Huffman decode: the coded stream read once, every symbol written
    once."""
    return stream_bytes + SYMBOL_BYTES * symbols


def lorenzo_sweep_bytes(cells: int) -> int:
    """One LORENZO_REG encode sweep over the rounded grid: each cell's
    value read, its bin and its reconstruction written, once each."""
    return cells * (VALUE_BYTES + SYMBOL_BYTES + VALUE_BYTES)


def bound_s(nbytes: int, ops: int = 0) -> float:
    """The least seconds the card could take: the bytes at the memory rate
    or the operations at the peak rate, the larger."""
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.OPS_PER_S)


def share_pct(nbytes: int, device_s: float):
    """The bound's share of the measured device time, %; None where the
    stage took no device time."""
    if device_s <= 0 or nbytes <= 0:
        return None
    return 100.0 * bound_s(nbytes) / device_s
