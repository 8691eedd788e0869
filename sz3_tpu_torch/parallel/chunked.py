"""Chunked archives in the reference's OpenMP format (counterpart of
sz3_tpu/parallel/chunked.py; reference api/impl/SZImplOMP.hpp:100-107):

  [nChunks i32][Config x n][sizes u64 x n][chunk streams...]

Each chunk is a slice of the squeezed conf.dims[0], ragged as the host
engine cuts it, and an independent dispatcher stream. The port runs the
chunks one after the other through its own dispatcher on the one device, so
every chunk's encode or decode is the device path of its algorithm; the
archives are byte-identical to the host engine's threaded path at the same
chunk count, whatever the order the chunks run in.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np
import torch

from .. import runtime
from ..config import EB, Config
from ..stats import cal_abs_error_bound


def _chunk_bounds(dim0: int, n: int) -> List[Tuple[int, int]]:
    return [(t * dim0 // n, (t + 1) * dim0 // n) for t in range(n)]


def compress_chunked(conf: Config, data: np.ndarray, n_chunks: int,
                     device: torch.device) -> bytes:
    """OpenMP-format payload of `data` in `n_chunks` chunks (fewer when the
    squeezed conf.dims[0] is smaller); `conf` keeps the openmp bit and takes
    the global error bound."""
    from ..algos.torch_backend import compress_payload_torch
    from ..api import zstd_compress_bound

    # the engine chunks on the squeezed conf.dims[0] (pipeline.hpp
    # compress_chunked), not on the raw leading axis
    conf.set_dims(data.shape)
    data = data.reshape(conf.dims)
    n_chunks = min(n_chunks, conf.dims[0])
    if conf.errorBoundMode != EB.ABS:
        # one range over the whole field before chunking (SZImplOMP.hpp:57-68)
        cal_abs_error_bound(conf, data, float(data.max() - data.min()))

    confs, streams = [], []
    for lo, hi in _chunk_bounds(conf.dims[0], n_chunks):
        chunk = np.ascontiguousarray(data[lo:hi])
        work = conf.copy()
        work.set_dims(chunk.shape)
        # the reference's cap (SZImplOMP.hpp:73) with the engine's headroom,
        # so that both make the same downgrade decisions
        cap = zstd_compress_bound(chunk.nbytes) + 4096
        work.openmp = False              # the chunk is a plain dispatcher stream
        streams.append(compress_payload_torch(work, chunk, cap, device))
        work.openmp = conf.openmp        # its header keeps the bit and its decisions
        confs.append(work)

    out = bytearray(struct.pack("<i", len(streams)))
    for c in confs:
        out += c.save()
    out += struct.pack(f"<{len(streams)}Q", *(len(s) for s in streams))
    for s in streams:
        out += s
    return bytes(out)


def decompress_chunked(conf: Config, payload: bytes, dtype,
                       device: torch.device) -> torch.Tensor:
    """OpenMP-format payload -> one tensor on `device`, shaped conf.dims,
    each chunk decoded into its rows. `dtype` is the element type (numpy)."""
    from ..algos.torch_backend import decompress_payload_torch

    n = struct.unpack_from("<i", payload, 0)[0]
    if n < 1 or n > max(1, conf.dims[0]):
        raise ValueError(f"invalid chunk count {n} in the archive")
    pos, confs = 4, []
    for _ in range(n):
        c, used = Config.load(payload, pos)
        confs.append(c)
        pos += used
    sizes = struct.unpack_from(f"<{n}Q", payload, pos)
    pos += 8 * n
    if pos + sum(sizes) > len(payload):
        raise ValueError("chunk sizes exceed the payload")
    dt = runtime.np_dtype_id(np.empty(0, dtype=dtype))
    out = torch.empty(conf.dims, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                      device=device)
    rows = tuple(conf.dims[1:])
    for (lo, hi), c, size in zip(_chunk_bounds(conf.dims[0], n), confs, sizes):
        c.openmp = False                 # chunk streams are plain dispatcher streams
        chunk = decompress_payload_torch(c, payload[pos:pos + size], dt, device)
        out[lo:hi] = chunk.reshape((hi - lo,) + rows)
        pos += size
    return out
