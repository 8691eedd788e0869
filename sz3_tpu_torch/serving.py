"""Batched serving (counterpart of sz3_tpu/serving.py): many fields of one
shape, such as the snapshots a simulation writes every time step, compressed
into one standard SZ3 archive each and decompressed into one stack.

``compress_batch`` routes as the JAX package's does (serving.py:190-208):
INTERP_LORENZO is pinned to INTERP (no tuner); other algorithms, ABS with a
bound <= 0 (lossless) and L2NORM go field by field through the port's own
``compress`` on the device, and so do integer fields and OpenMP-format
Configs, which that ``compress`` sends elsewhere; ABS, REL, PSNR, ABS_AND_REL
and ABS_OR_REL take the batch route. Archive i is byte-identical to
``compress(fields[i], c)``, c being `conf` with INTERP pinned.

The batch route is one route, the pipelined device entropy route
(``_compress_batch_device_entropy``, after serving.py:90-171), for float32
and float64 and every batched bound mode. The JAX package's vmapped
bins-readback route with a host seal (``_jit_encode_batch``,
``_jit_encode_batch_dynamic``) has no counterpart: it exists because its jit
needs one static bound and its pipeline is float32-only, the TPU having no
IEEE float64. Here each field's bound resolves on the host exactly as
single-field compress resolves it, and float64 runs on the card.

The pipeline: up to ``depth`` fields are in flight, each on its own CUDA
stream from a pool of ``depth``. For field i the main thread queues its
upload, INTERP passes, stream gather and K1 on its stream, builds the
Huffman tree on the host, queues K2+K3 and the copies of the packed words
and literals to page-locked memory (``device_encode.pack_device``, which
waits for field i's stream only), then hands the host seal
(``device_encode.seal_packed``: wait on the field's event, frame, zstd) to
a worker thread and goes on to field i+1. The engine's seal releases the
GIL, so the seals of earlier fields run while the card works on later ones,
and beside each other: where the JAX package orders dispatch before force on
one thread, the seals here run on ``depth - 1`` workers (depth 1 is one
field at a time; PERF.md has both on the card). A field's device tensors go
once its device half has queued its copies, so the device memory in flight
is about one field's encode. On the CPU the same function runs, with the
kernels' plain versions and no streams.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from . import runtime
from .algos import device_encode as de
from .algos.torch_backend import _resolve_anchor_stride, finish_payload
from .api import _device, archive_conf, compress, decompress, pack_archive
from .config import ALGO, EB, Config
from .ops.interp_fast import _consts
from .stats import cal_abs_error_bound
from .utils import trace
from .utils.copies import to_device

DEPTH = 3                  # fields in flight (serving.py:91)
_BATCH_MODES = (EB.ABS, EB.REL, EB.PSNR, EB.ABS_AND_REL, EB.ABS_OR_REL)


def compress_batch(fields: Union[np.ndarray, torch.Tensor], conf: Optional[Config] = None, *,
                   device="cuda") -> List[bytes]:
    """Compress a [B, *dims] stack of same-shape fields on `device` into B
    standard SZ3 archives, each byte-identical to single-field compression
    of its field. Raises ValueError on an input that is not a stack."""
    dev = _device(device)
    with trace.span("serving.compress_batch") as sp:
        arr = fields.detach().cpu().numpy() if isinstance(fields, torch.Tensor) \
            else np.asarray(fields)
        sp.set(nbytes=arr.nbytes, dims=arr.shape, dtype=arr.dtype.name)
        if arr.ndim < 2:
            raise ValueError("expected a [B, *dims] stack")
        base = conf.copy() if conf is not None else Config(dims=arr.shape[1:])
        base.set_dims(arr.shape[1:])            # drops size-1 axes like the reference
        base.dataType = runtime.np_dtype_id(arr)
        if base.cmprAlgo == ALGO.INTERP_LORENZO:
            base.cmprAlgo = ALGO.INTERP         # the batch pins the algorithm: no tuner
        if (base.cmprAlgo != ALGO.INTERP or base.errorBoundMode not in _BATCH_MODES
                or (base.errorBoundMode == EB.ABS and base.absErrorBound <= 0)
                or arr.dtype not in (np.float32, np.float64) or base.openmp):
            return [compress(np.ascontiguousarray(f), base.copy(), device=dev) for f in arr]
        _resolve_anchor_stride(base)
        stack = np.ascontiguousarray(arr.reshape((arr.shape[0],) + tuple(base.dims)))
        return _compress_batch_device_entropy(stack, base, dev, DEPTH)


def _compress_batch_device_entropy(stack: np.ndarray, base: Config, device: torch.device,
                                   depth: int = DEPTH) -> List[bytes]:
    """The pipelined batch route (module docstring). `base` is an INTERP
    Config with the anchor stride resolved, shaped like stack[i]."""
    cuda = device.type == "cuda"
    if cuda:
        device = torch.device("cuda", torch.cuda.current_device() if device.index is None
                              else device.index)
        caller = torch.cuda.current_stream(device)
        streams = [torch.cuda.Stream(device) for _ in range(depth)]
        de.perm_for(base, device)           # the stream order, cached, on the caller's stream
    futures = []

    def one(i: int, c: Config, cap: int, packed: Optional[de.Packed], field) -> bytes:
        # on a worker thread: the field's span, handed over, is the parent
        with trace.span("serving.seal", parent=field, field=i):
            if packed is None:                  # a bound of 0: lossless
                return pack_archive(c, runtime.zstd_compress(stack[i].tobytes()))
            return pack_archive(c, finish_payload(c, stack[i], cap,
                                                  lambda: de.seal_packed(c, packed, cap)))

    with ThreadPoolExecutor(max_workers=max(1, depth - 1)) as seals:
        try:
            for i in range(stack.shape[0]):
                with trace.span("serving.field", field=i):
                    field = trace.current()
                    if i >= depth:
                        futures[i - depth].result()     # at most `depth` fields in flight
                    c, cap = archive_conf(stack[i], base)
                    with trace.span("dispatch.bound"):
                        cal_abs_error_bound(c, stack[i])
                    if c.absErrorBound == 0:
                        c.cmprAlgo = ALGO.LOSSLESS
                        futures.append(seals.submit(one, i, c, cap, None, field))
                        continue
                    ctx = contextlib.nullcontext()
                    if cuda:
                        # the pass constants of this field's bounds, uploaded on the
                        # caller's stream from pageable memory: the field's stream
                        # waits for them (and for the stream order) before it reads
                        _consts(de.plan_for(c), device)
                        s = streams[i % depth]
                        s.wait_stream(caller)
                        ctx = torch.cuda.stream(s)
                    with ctx:
                        packed = de.pack_device(c, to_device(stack[i], device))
                    futures.append(seals.submit(one, i, c, cap, packed, field))
            return [f.result() for f in futures]
        finally:
            if cuda:
                for s in streams:
                    s.synchronize()


def decompress_batch(blobs: Sequence[bytes], dtype=None, *, device="cuda") -> torch.Tensor:
    """Decompress archives of one shape into one [B, *dims] tensor on
    `device`, each through the port's ``decompress`` and written into its
    row of one preallocated output. dtype=None takes the dataType each
    archive records. Archives of different shapes or types raise
    ValueError."""
    dev = _device(device)
    if len(blobs) == 0:
        raise ValueError("need at least one archive")
    out = None
    with trace.span("serving.decompress_batch", archives=len(blobs)):
        for i, blob in enumerate(blobs):
            x, _ = decompress(blob, device=dev, dtype=dtype)
            if out is None:
                out = torch.empty((len(blobs),) + tuple(x.shape), dtype=x.dtype, device=dev)
            if tuple(x.shape) != tuple(out.shape[1:]) or x.dtype != out.dtype:
                raise ValueError(f"archive {i} decodes to {tuple(x.shape)} {x.dtype}, archive 0 "
                                 f"to {tuple(out.shape[1:])} {out.dtype}")
            out[i] = x
    return out
