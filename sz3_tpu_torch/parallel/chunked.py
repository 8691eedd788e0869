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

import math
import struct
from typing import List, Tuple

import numpy as np
import torch

from .. import runtime
from ..config import EB, Config
from ..stats import cal_abs_error_bound, data_range


def _chunk_bounds(dim0: int, n: int) -> List[Tuple[int, int]]:
    return [(t * dim0 // n, (t + 1) * dim0 // n) for t in range(n)]


def compress_chunked(conf: Config, data: np.ndarray, n_chunks: int,
                     device: torch.device) -> bytes:
    """OpenMP-format payload of `data` in `n_chunks` chunks (fewer when the
    squeezed conf.dims[0] is smaller); `conf` keeps the openmp bit and takes
    the global error bound."""
    # the engine chunks on the squeezed conf.dims[0] (pipeline.hpp
    # compress_chunked), not on the raw leading axis
    conf.set_dims(data.shape)
    data = data.reshape(conf.dims)
    n_chunks = min(n_chunks, conf.dims[0])
    if conf.errorBoundMode != EB.ABS:
        # one range over the whole field before chunking (SZImplOMP.hpp:57-68)
        cal_abs_error_bound(conf, data, data_range(data))
    return assemble([encode_chunk(conf, data, lo, hi, device)
                     for lo, hi in _chunk_bounds(conf.dims[0], n_chunks)])


def encode_chunk(conf: Config, data: np.ndarray, lo: int, hi: int,
                 device: torch.device) -> Tuple[Config, bytes]:
    """(the chunk's Config, its stream): rows [lo, hi) of `data` (shaped
    conf.dims, whose bound is resolved) through the port's dispatcher."""
    from ..algos.torch_backend import compress_payload_torch
    from ..api import zstd_compress_bound

    chunk = np.ascontiguousarray(data[lo:hi])
    work = conf.copy()
    work.set_dims(chunk.shape)
    # the reference's cap (SZImplOMP.hpp:73) with the engine's headroom, so
    # that both make the same downgrade decisions
    cap = zstd_compress_bound(chunk.nbytes) + 4096
    work.openmp = False                  # the chunk is a plain dispatcher stream
    stream = compress_payload_torch(work, chunk, cap, device)
    work.openmp = conf.openmp            # its header keeps the bit and its decisions
    return work, stream


def assemble(chunks: List[Tuple[Config, bytes]]) -> bytes:
    """The OpenMP-format payload of the chunks' (Config, stream) pairs."""
    out = bytearray(struct.pack("<i", len(chunks)))
    for c, _ in chunks:
        out += c.save()
    out += struct.pack(f"<{len(chunks)}Q", *(len(s) for _, s in chunks))
    for _, s in chunks:
        out += s
    return bytes(out)


def read_chunks(conf: Config, payload: bytes) -> List[Tuple[int, int, Config, bytes]]:
    """(lo, hi, Config, stream) of each chunk of an OpenMP-format payload of
    a field shaped conf.dims; each Config with its openmp bit cleared."""
    n = struct.unpack_from("<i", payload, 0)[0]
    if n < 1 or n > max(1, conf.dims[0]):
        raise ValueError(f"invalid chunk count {n} in the archive")
    pos, confs = 4, []
    for _ in range(n):
        c, used = Config.load(payload, pos)
        c.openmp = False                 # chunk streams are plain dispatcher streams
        confs.append(c)
        pos += used
    sizes = struct.unpack_from(f"<{n}Q", payload, pos)
    pos += 8 * n
    if pos + sum(sizes) > len(payload):
        raise ValueError("chunk sizes exceed the payload")
    row = math.prod(conf.dims[1:])
    bounds = _chunk_bounds(conf.dims[0], n)
    for t, ((lo, hi), c) in enumerate(zip(bounds, confs)):
        # a chunk's Config sizes its decode: it must hold the chunk's rows
        if math.prod(c.dims) != (hi - lo) * row:
            raise ValueError(f"chunk {t}'s dims {tuple(c.dims)} do not hold its "
                             f"{hi - lo} rows of {row} points")
    out = []
    for (lo, hi), c, size in zip(bounds, confs, sizes):
        out.append((lo, hi, c, payload[pos:pos + size]))
        pos += size
    return out


def decompress_chunked(conf: Config, payload: bytes, dtype,
                       device: torch.device) -> torch.Tensor:
    """OpenMP-format payload -> one tensor on `device`, shaped conf.dims,
    each chunk decoded into its rows. `dtype` is the element type (numpy)."""
    from ..algos.torch_backend import decompress_payload_torch

    chunks = read_chunks(conf, payload)
    dt = runtime.np_dtype_id(np.empty(0, dtype=dtype))
    out = torch.empty(conf.dims, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                      device=device)
    rows = tuple(conf.dims[1:])
    for lo, hi, c, blob in chunks:
        out[lo:hi] = decompress_payload_torch(c, blob, dt, device).reshape((hi - lo,) + rows)
    return out
