"""Multi-device OpenMP-format archives over torch.distributed (counterpart of
sz3_tpu/parallel/sharded.py, the analogue of the reference's OpenMP mode,
api/impl/SZImplOMP.hpp).

PyTorch's SPMD idiom: one process per rank, each given the whole host
array, as every caller of the JAX package's mesh functions has it, and a
process group (default: the world group). Rank r encodes or decodes its own
dim0 chunks on its device: ``device=None`` takes cuda:{r % device_count} and
raises without a card; the tests pass ``device="cpu"``. With one card every
rank shares cuda:0 and the group must be gloo (NCCL refuses two ranks on one
GPU); with a card per rank NCCL works. A gloo group reduces and gathers on
the host, an NCCL group on the rank's card.

For range-relative bounds the ranks all-reduce one MAX (their rows' maximum
and a flag) and one MIN (their minimum): the range of the whole field is
then bit-equal to ``stats.data_range`` over it, which follows the host engine
and the reference (Statistic.hpp:11-20): NaN is passed over unless the
field's first element is NaN, and the flag carries that case. NaN never
enters a reduction, so every backend gives every rank the same bound.

  sharded_encode          the encode step over equal chunks: this rank's
                          bins and the resolved bound (sharded.py:390)
  sharded_encode_payload  the OpenMP-format payload, one ragged chunk a
                          rank, each through the port's dispatcher (:170)
  sharded_decode_payload  rank r decodes chunks t = r (mod world size); the
                          rows are gathered to every rank (:286)
  dryrun_multichip        n gloo ranks spawned over a ragged REL field:
                          encode -> archive -> decode (the counterpart of
                          __graft_entry__.dryrun_multichip)
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..api import _device
from ..config import ALGO, EB, Config
from ..ops.interp_fast import build_fast_plan, encode_grid_fast
from ..stats import cal_abs_error_bound
from . import chunked


def _rank_device(device) -> torch.device:
    if device is not None:
        return _device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("device=None runs each rank on a CUDA device, and "
                           "torch.cuda.is_available() is False")
    return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())


def _comm_device(group, dev: torch.device) -> torch.device:
    """Where this group's collectives take their tensors."""
    return dev if dist.get_backend(group) == "nccl" else torch.device("cpu")


def global_range(rows: torch.Tensor, first: bool, group=None, device=None) -> float:
    """max - min over every rank's `rows`, in their dtype, then a Python
    float: one MAX all-reduce of (the rows' maximum, a flag) and one MIN
    all-reduce of their minimum, NaN passed over as the engine passes over it.
    `first` is True on the rank whose rows hold the field's first element;
    `device` is the rank's device (default: the rows')."""
    x = rows.reshape(-1)
    flag = False
    if x.is_floating_point():
        nan = torch.isnan(x)
        flag = first and bool(nan[0])
        x = x[~nan]
    if x.numel():
        hi, lo = x.amax(), x.amin()
    else:                       # neutral: no value of this rank counts
        info = torch.iinfo(x.dtype) if not x.is_floating_point() else None
        hi = torch.tensor(-float("inf") if info is None else info.min, dtype=x.dtype)
        lo = torch.tensor(float("inf") if info is None else info.max, dtype=x.dtype)
    comm = _comm_device(group, rows.device if device is None else device)
    hi = torch.stack([hi.cpu(), torch.tensor(int(flag), dtype=x.dtype)]).to(comm)
    lo = lo.reshape(1).to(comm)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    if bool(hi[1]):
        return float("nan")
    return float((hi[0] - lo[0]).item())


def sharded_encode(data: np.ndarray, group=None, *, interp_algo: int, direction: int,
                   anchor_stride: int, alpha: float, beta: float, quantbin_cnt: int,
                   eb_mode: EB, eb_value: float, eb_abs: Optional[float] = None,
                   eb_rel: Optional[float] = None, device=None):
    """The encode step over equal chunks (dim0 divisible by the world size,
    else ValueError): this rank's chunk through the INTERP passes on its
    device. Returns (plan, this rank's flat bins (int32, on the device), its
    first-point bin, the resolved absolute bound). Range-relative bounds
    take the global range (REL, ABS_AND_REL, ABS_OR_REL, as
    sharded.py:54-75)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if data.shape[0] % n != 0:
        raise ValueError(f"dim0 {data.shape[0]} not divisible by world size {n}")
    dev = _rank_device(device)
    h = data.shape[0] // n
    x = torch.from_numpy(np.ascontiguousarray(data[r * h:(r + 1) * h])).to(dev)
    if eb_mode == EB.ABS:
        eb = float(eb_value)
    else:
        rng = global_range(x, r == 0, group)
        if eb_mode == EB.REL:
            eb = eb_value * rng
        elif eb_mode in (EB.ABS_AND_REL, EB.ABS_OR_REL):
            # the combined modes take two bounds (Statistic.hpp:48-55)
            a = eb_abs if eb_abs is not None else eb_value
            rel = eb_rel if eb_rel is not None else eb_value
            eb = (min if eb_mode == EB.ABS_AND_REL else max)(float(a), rel * rng)
        else:
            raise ValueError(f"unsupported sharded eb mode {eb_mode}")
    plan = build_fast_plan(tuple(x.shape), interp_algo=interp_algo, direction=direction,
                           anchor_stride=anchor_stride, alpha=alpha, beta=beta, eb=eb,
                           quantbin_cnt=quantbin_cnt)
    bins_list, b0, _ = encode_grid_fast(x, plan)
    flat = (torch.cat([b.reshape(-1) for b in bins_list]) if bins_list
            else torch.zeros(0, dtype=torch.int32, device=dev))
    return plan, flat, int(b0) if b0 is not None else 0, eb


def sharded_encode_payload(conf: Config, data: np.ndarray, group=None, *, device=None) -> bytes:
    """The OpenMP-format payload of `data` with one chunk a rank, ragged
    along the squeezed dims[0] as the engine cuts it; every rank returns it.
    Explicit INTERP only; ValueError when there are fewer rows than ranks.
    Byte-identical to chunked.compress_chunked with as many chunks, and to
    the engine with as many threads. Mutates `conf` as they do."""
    conf.set_dims(data.shape)
    data = data.reshape(conf.dims)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if conf.dims[0] < n:
        raise ValueError(f"{conf.dims[0]} dim0 rows for {n} ranks")
    if conf.cmprAlgo != ALGO.INTERP:
        raise ValueError("the sharded payload takes explicit ALGO_INTERP (the "
                         "INTERP_LORENZO tuner is a per-chunk decision: use "
                         "compress(..., nthreads=)")
    dev = _rank_device(device)
    lo, hi = chunked._chunk_bounds(conf.dims[0], n)[r]
    if conf.errorBoundMode != EB.ABS:
        # the rows' range on the host: the chunk's encode uploads them itself
        rng = global_range(torch.from_numpy(np.ascontiguousarray(data[lo:hi])), r == 0, group,
                           dev)
        # a range of 0 or NaN falls back to the whole field's, which is the same
        cal_abs_error_bound(conf, data, rng)
    mine = chunked.encode_chunk(conf, data, lo, hi, dev)
    every = [None] * n
    with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
        dist.all_gather_object(every, (mine[0].save(), mine[1]), group=group)
    return chunked.assemble([(Config.load(c, 0)[0], s) for c, s in every])


def sharded_decode_payload(conf: Config, payload: bytes, group=None, dtype=None, *,
                           device=None) -> torch.Tensor:
    """An OpenMP-format payload -> the whole field on every rank, a tensor on
    its device, bit-equal to the port's decompress. Rank r decodes chunks
    t = r (mod world size) into their rows; the rows are all-gathered,
    padded to the tallest chunk, and trimmed. Chunks of INTERP and LOSSLESS
    only (sharded.py:319-323), else ValueError. dtype=None: conf.dataType."""
    from .. import runtime
    from ..algos.torch_backend import decompress_payload_torch

    n_ranks, r = dist.get_world_size(group), dist.get_rank(group)
    dev = _rank_device(device)
    dt = np.dtype(dtype) if dtype is not None else np.dtype(runtime.np_dtype_of(conf.dataType))
    chunks = chunked.read_chunks(conf, payload)
    for _, _, c, _ in chunks:
        if c.cmprAlgo not in (ALGO.LOSSLESS, ALGO.INTERP):
            raise ValueError(f"unsupported chunk algorithm {c.cmprAlgo!r} for the sharded "
                             f"decode (decompress takes every algorithm)")
    rest = tuple(conf.dims[1:])
    tall = max(hi - lo for lo, hi, _, _ in chunks)
    per_rank = -(-len(chunks) // n_ranks)
    tdt = torch.from_numpy(np.empty(0, dt)).dtype
    comm = _comm_device(group, dev)
    mine = torch.zeros((per_rank, tall) + rest, dtype=tdt, device=comm)
    for k, (lo, hi, c, blob) in enumerate(chunks[r::n_ranks]):
        rows = decompress_payload_torch(c, blob, runtime.np_dtype_id(np.empty(0, dt)), dev)
        mine[k, :hi - lo] = rows.reshape((hi - lo,) + rest)
    every = [torch.empty_like(mine) for _ in range(n_ranks)]
    dist.all_gather(every, mine, group=group)
    out = torch.empty(conf.dims, dtype=tdt, device=dev)
    for t, (lo, hi, _, _) in enumerate(chunks):
        out[lo:hi] = every[t % n_ranks][t // n_ranks, :hi - lo]
    return out


def init_file_group(path: str, rank: int, world: int, backend: str = "gloo") -> None:
    """The default process group through a FileStore at `path` (no network)."""
    dist.init_process_group(backend, store=dist.FileStore(path, world), rank=rank,
                            world_size=world)


def _dryrun_worker(rank: int, world: int, path: str, device) -> None:
    torch.set_num_threads(1)
    init_file_group(path, rank, world)
    try:
        rng = np.random.default_rng(0)
        # ragged dim0 (8n+5 rows on n ranks): the reference's uneven split
        # (SZImplOMP.hpp:48-50), as __graft_entry__.dryrun_multichip
        data = np.cumsum(rng.standard_normal((8 * world + 5, 24, 24)).astype(np.float32),
                         axis=-1) * 0.1
        # REL runs the MIN and MAX all-reduces
        _, bins, _, eb = sharded_encode(
            data[:8 * world], interp_algo=1, direction=0, anchor_stride=32, alpha=1.25,
            beta=2.0, quantbin_cnt=65536, eb_mode=EB.REL, eb_value=1e-3, device=device)
        assert bins.numel() > 0 and eb > 0
        conf = Config(dims=data.shape, cmprAlgo=ALGO.INTERP, errorBoundMode=EB.REL,
                      relErrorBound=1e-3, openmp=True)
        payload = sharded_encode_payload(conf, data, device=device)
        out = sharded_decode_payload(Config(dims=data.shape, openmp=True), payload,
                                     dtype=np.float32, device=device)
        err = float(np.abs(out.cpu().numpy() - data).max())
        bound = float(data.max() - data.min()) * 1e-3
        assert err <= bound * 1.01, f"max error {err} > {bound}"
        if rank == 0:
            print(f"dryrun_multichip({world}): collectives + ragged encode->archive"
                  f"({len(payload)}B)->decode over {world} gloo ranks OK within bound",
                  flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int, device=None) -> None:
    """Spawn `n` gloo ranks (torch.multiprocessing, a FileStore in a
    temporary directory) that run encode -> archive -> decode over a ragged
    (8n+5, 24, 24) REL 1e-3 field and check the bound; raises if a rank
    fails. device=None: each rank on cuda:{rank % device_count}."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_dryrun_worker, args=(n, os.path.join(tmp, "store"), device), nprocs=n,
                 join=True)
