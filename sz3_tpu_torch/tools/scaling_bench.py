"""Scaling measurements for the data-parallel (OpenMP-format) paths
(counterpart of tools/scaling_bench.py). Two measurements, labeled as what
they are:

1. Rank scaling through parallel/sharded.py: n gloo ranks (1, 2, 4, 8 by
   default), spawned as processes, each encoding its 1/n of a field with
   ``sharded_encode`` (the encode step: the INTERP passes over its rows, and
   for REL the MIN/MAX all-reduce). Each rank takes cuda:{rank % cards}: on
   a machine with fewer cards than ranks the ranks SHARE a card, as the JAX
   tool's virtual mesh shares one host core, so the wall cannot drop with n;
   what it shows is that the per-chunk work stays flat and what the
   orchestration costs. The label says how many ranks shared a card.

2. The per-chunk device time of the encode step (ops/interp_fast.encode_step:
   the INTERP passes, then the bins' one concatenation) for the chunk shapes an
   n-way split of a base^3 field gives (base = $SZT_SCALE_BASE, 256 by
   default, as in the JAX tool), on one card (CUDA events, the best of 4
   runs of K = 10 encodes). Chunks are independent streams, so n cards each
   encoding a 1/n chunk at the measured rate is the scaling model (the
   range all-reduce adds one scalar collective a field).

With --device cpu both parts run on the host (the kernels' plain versions,
the host clock), and say so.

Usage: python -m sz3_tpu_torch.tools.scaling_bench [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPS = 5
K = 10


def _field(shape, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.standard_normal(shape).astype(np.float32), axis=-1) * 0.1


def _rank(rank: int, world: int, store: str, out: str, edge: int, device) -> None:
    """One rank of part 1: the sharded encode step of an edge^3 REL 1e-3
    field, REPS times after a warm call, each between barriers; writes
    {wall_s, device} to <out>/rank<r>.json."""
    import torch.distributed as dist

    from ..config import EB
    from ..parallel import sharded

    sharded.init_file_group(store, rank, world)
    try:
        data = _field((edge, edge, edge))
        dev = sharded._rank_device(device)

        def step():
            sharded.sharded_encode(data, interp_algo=1, direction=0, anchor_stride=32,
                                   alpha=1.25, beta=2.0, quantbin_cnt=65536, eb_mode=EB.REL,
                                   eb_value=1e-3, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        step()
        walls = []
        for _ in range(REPS):
            dist.barrier()
            t0 = time.perf_counter()
            step()
            dist.barrier()
            walls.append(time.perf_counter() - t0)
        (Path(out) / f"rank{rank}.json").write_text(
            json.dumps({"wall_s": min(walls), "device": str(dev)}))
    finally:
        dist.destroy_process_group()


def rank_scaling(ranks=(1, 2, 4, 8), edge: int = 64, device=None) -> list:
    """Part 1: the sharded encode step's wall on n ranks for n in `ranks`."""
    import torch.multiprocessing as mp

    cards = torch.cuda.device_count() if device is None else 0
    results = []
    for n in ranks:
        with tempfile.TemporaryDirectory() as tmp:
            mp.spawn(_rank, args=(n, os.path.join(tmp, "store"), tmp, edge, device), nprocs=n,
                     join=True)
            walls = [json.loads((Path(tmp) / f"rank{r}.json").read_text()) for r in range(n)]
        wall = max(w["wall_s"] for w in walls)
        shared = (f"{n} ranks on {cards} card(s)" if cards else f"{n} ranks on the CPU")
        results.append({"ranks": n, "chunk_rows": edge // n, "devices": sorted(
            {w["device"] for w in walls}), "shared": shared, "wall_ms": wall * 1e3,
            "wall_x_n_ms": wall * n * 1e3})
        print(f"sharded encode step, {edge}^3 REL 1e-3, {shared}: wall {wall * 1e3:8.2f} ms "
              f"(wall*n = {wall * n * 1e3:8.2f} ms)", flush=True)
    return results


def chunk_model(base: int = 256, splits=(1, 2, 4, 8), device="cuda") -> list:
    """Part 2: the encode step's time a chunk (ops/interp_fast.encode_step:
    the INTERP passes and the bins' one concatenation) for the chunk shapes
    of an n-way split of a base^3 float32 field, on `device`."""
    from ..api import _device
    from ..ops.interp_fast import encode_step
    from .profile_entropy import clock_ms

    dev = _device(device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the CPU (host clock)"
    results = []
    for n in splits:
        shape = (base // n, base, base)
        _, run = encode_step(shape, 1, 0, 32, 1.25, 2.0, 1e-3, 65536, "float32")
        x = torch.from_numpy(_field(shape)).to(dev)

        def run_k():
            for _ in range(K):
                run(x)

        per_chunk = clock_ms(run_k, dev, 4) / K
        gbs = x.numel() * 4 / per_chunk / 1e6
        results.append({"base": base, "n_way_split": n, "chunk_shape": list(shape),
                        "device": where, "chunk_ms": per_chunk, "chunk_gbs": gbs,
                        "modeled_total_gbs": gbs * n})
        print(f"{base}^3 split {n}-way on {where}: chunk {per_chunk:8.3f} ms ({gbs:7.2f} GB/s "
              f"a device) -> modeled {n} devices {gbs * n:8.2f} GB/s", flush=True)
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="scaling_bench", description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None, help="write both parts' results here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from ..api import _device

    dev = _device(args.device)
    out = {"rank_scaling": rank_scaling(device=None if dev.type == "cuda" else "cpu"),
           "chunk_model": chunk_model(int(os.environ.get("SZT_SCALE_BASE", "256")), device=dev)}
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=1))
        print("wrote", args.json)
    return out


if __name__ == "__main__":
    main()
