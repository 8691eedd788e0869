"""The control: the reference put in the program's place, one precision
below the configuration's. The configurations hold float32 fields; the
control keeps each field as a bfloat16 copy (the step below float32), so
its "archive" is the field's bfloat16 bytes and its decode the copy cast
back. At the benchmark's bounds (REL 1e-4) that copy misses the bound, and
the check has to say so (szbench/tests/test_control.py; on the card
``python3 szbench/control.py``).

It offers the calls the entries make of the program (harness/port.Port).
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

_LEN = struct.Struct("<I")


class Control:
    def __init__(self, device, precision: torch.dtype = torch.bfloat16) -> None:
        self.device = torch.device(device)
        self.precision = precision

    def config(self, settings: dict) -> dict:
        return dict(settings)

    def compress(self, field: np.ndarray, conf) -> bytes:
        low = torch.from_numpy(np.ascontiguousarray(field)).to(self.device).to(self.precision)
        head = json.dumps({"shape": list(field.shape), "dtype": str(field.dtype)}).encode()
        return _LEN.pack(len(head)) + head + low.view(torch.int16).cpu().numpy().tobytes()

    def decompress(self, blob: bytes) -> torch.Tensor:
        (n,) = _LEN.unpack_from(blob, 0)
        head = json.loads(blob[4:4 + n])
        raw = np.frombuffer(blob, dtype=np.int16, offset=4 + n).copy()
        low = torch.from_numpy(raw).to(self.device).view(self.precision)
        return low.to(getattr(torch, head["dtype"])).reshape(head["shape"])

    def compress_batch(self, stack: np.ndarray, conf):
        return [self.compress(f, conf) for f in stack]

    def decompress_batch(self, blobs) -> torch.Tensor:
        return torch.stack([self.decompress(b) for b in blobs])
