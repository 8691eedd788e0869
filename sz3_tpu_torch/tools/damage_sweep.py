"""Damaged archives on every decode route of the port.

Each route's archive is written by the port, then decoded again after each
of a seeded set of single-byte flips (spread over the container header, the
payload and the Config tail) and three truncations. The contract, which is
tests/test_robustness.py's for the JAX package: a damaged archive decodes to
an array of the archive's dims and dtype, or raises an Exception. It never
ends the process with a signal, and no case takes more than a few seconds.

    python -m sz3_tpu_torch.tools.damage_sweep [--device cpu|cuda] [--flips N]
        [--save DIR] [ROUTE ...]

prints one JSON line a case (route, case label, outcome, the decoded bytes'
sha256, seconds) as the case ends, and a summary line a route. On the card
every case ends with ``torch.cuda.synchronize()``, so that a kernel fault
shows at its own case. ``--save DIR`` writes each route's clean archive to
DIR/<route>.bin (an MDZ archive, or for "batch" the damaged one of a pair).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

ROUTES = ("interp3d_f32", "interp3d_f64", "interp2d", "interp1d", "nopred", "lorenzo_reg",
          "biomd", "biomdxtc", "openmp", "int32", "mdz", "batch")
# routes whose clean archive the engine's own full decode opens too
# (sz3_tpu_torch.runtime.decompress_payload): the sweep's arrays are held to it
ENGINE_ROUTES = ("interp3d_f32", "interp3d_f64", "interp2d", "interp1d", "nopred",
                 "lorenzo_reg")
# flips that ended the process before the decode routes checked what they
# read: SIGSEGV in the packed open (NOPRED, OpenMP format), glibc aborts in
# the XTC decode (BIOMDXTC); run first in every sweep of their route
KNOWN = {"nopred": (103, 1357), "openmp": (344,), "biomdxtc": (2882, 5569, 6767, 6989, 8410)}


def field(shape=(24, 24, 24), seed=11, dtype=np.float32) -> np.ndarray:
    """A smooth field with noise (tests/test_robustness.py's field)."""
    rng = np.random.default_rng(seed)
    g = np.meshgrid(*[np.linspace(0, 1, s) for s in shape], indexing="ij")
    f = sum(np.sin(2 * np.pi * (k + 1.5) * x) for k, x in enumerate(g))
    return np.ascontiguousarray(f + 0.05 * rng.standard_normal(shape), dtype=dtype)


def md_traj(frames=12, atoms=180, seed=0) -> np.ndarray:
    """A water-like trajectory, (frames, atoms, 3) float32: three-atom
    molecules around random centres, each atom a random walk."""
    rng = np.random.default_rng(seed)
    g = atoms // 3 + 1
    base = rng.uniform(-5, 5, (g, 1, 3)).repeat(3, axis=1)
    base = (base + rng.normal(0, 0.05, (g, 3, 3))).reshape(-1, 3)[:atoms]
    traj = base[None] + np.cumsum(rng.normal(0, 0.01, (frames, atoms, 3)), axis=0)
    return np.ascontiguousarray(traj, dtype=np.float32)


@dataclass
class Archive:
    """A route's clean archive, what its decode must give, how to decode a
    damaged copy of it (`decode(blob)` -> tensor) and the host engine's
    decode of the clean archive (`engine()` -> array)."""
    route: str
    blob: bytes
    dims: Tuple[int, ...]
    dtype: np.dtype
    head: int                       # bytes of container header
    tail: int                       # bytes of Config tail (0: none)
    decode: Callable[[bytes], torch.Tensor]
    engine: Callable[[], np.ndarray]


def make(route: str, device) -> Archive:
    """The route's archive, written by the port on `device`."""
    from .. import ALGO, Config, compress, decompress
    from ..api import open_archive
    from ..runtime import decompress_payload

    def engine(blob: bytes) -> np.ndarray:
        conf, payload = open_archive(blob)
        return decompress_payload(conf, payload)

    def sz3(x: np.ndarray, conf: Config, **kw) -> Archive:
        blob = compress(x, conf, device=device, **kw)
        _, payload = open_archive(blob)
        return Archive(route, blob, tuple(x.shape), x.dtype, 16, len(blob) - 16 - len(payload),
                       lambda b: decompress(b, device=device)[0], lambda: engine(blob))

    if route == "interp3d_f32":
        return sz3(field(), Config(absErrorBound=1e-2))
    if route == "interp3d_f64":
        return sz3(field(dtype=np.float64), Config(absErrorBound=1e-2))
    if route == "interp2d":
        return sz3(field((60, 70)), Config(absErrorBound=1e-2))
    if route == "interp1d":
        return sz3(field((4000,)), Config(absErrorBound=1e-2))
    if route == "nopred":
        return sz3(field(), Config(cmprAlgo=ALGO.NOPRED, absErrorBound=1e-2))
    if route == "lorenzo_reg":
        return sz3(field(), Config(cmprAlgo=ALGO.LORENZO_REG, absErrorBound=1e-2))
    if route == "biomd":
        return sz3(md_traj(), Config(cmprAlgo=ALGO.BIOMD, absErrorBound=1e-3))
    if route == "biomdxtc":
        return sz3(md_traj(), Config(cmprAlgo=ALGO.BIOMDXTC, absErrorBound=1e-3))
    if route == "openmp":
        return sz3(field(), Config(absErrorBound=1e-2, openmp=True), nthreads=3)
    if route == "int32":
        return sz3(np.round(field() * 1000).astype(np.int32), Config(absErrorBound=2))
    if route == "mdz":
        from ..mdz import engine_decompress, mdz_compress, mdz_decompress
        x = md_traj(frames=24)
        blob = mdz_compress(x, abs_eb=1e-3, device=device)
        return Archive(route, blob, x.shape, x.dtype, 64, 0,
                       lambda b: mdz_decompress(b, device=device),
                       lambda: engine_decompress(blob))
    if route == "batch":
        from ..serving import compress_batch, decompress_batch
        x = np.stack([field(seed=11), field(seed=12)])
        first, second = compress_batch(x, Config(absErrorBound=1e-2), device=device)
        _, payload = open_archive(second)
        return Archive(route, second, x.shape, x.dtype, 16, len(second) - 16 - len(payload),
                       lambda b: decompress_batch([first, b], device=device),
                       lambda: np.stack([engine(first), engine(second)]))
    raise ValueError(f"unknown route {route!r}")


def cases(blob: bytes, head: int, tail: int, flips: int = 60) -> List[Tuple[str, bytes]]:
    """(label, damaged archive): `flips` single-byte flips (b ^ 0xFF) at
    seeded distinct positions, a tenth of them in the header and a tenth in
    the tail (where there is one), the rest in between; then the archive cut
    to 16 bytes, to half and to one byte short."""
    rng = np.random.default_rng(0)
    n = len(blob)
    k_head = min(flips, max(1, flips // 10))
    k_tail = min(flips - k_head, max(1, flips // 10)) if tail else 0
    body = np.arange(head, n - tail)
    pos = list(rng.choice(head, min(head, k_head), replace=False))
    if k_tail:
        pos += list(n - tail + rng.choice(tail, min(tail, k_tail), replace=False))
    pos += list(rng.choice(body, min(body.size, flips - len(pos)), replace=False))
    out = [(f"flip@{p}", flip(blob, int(p))) for p in sorted(int(p) for p in pos)]
    out += [(f"cut@{m}", blob[:m]) for m in (16, n // 2, n - 1)]
    return out


def flip(blob: bytes, pos: int) -> bytes:
    return blob[:pos] + bytes([blob[pos] ^ 0xFF]) + blob[pos + 1:]


def digest(x: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()[:16]


def run_case(arc: Archive, label: str, blob: bytes) -> dict:
    """One damaged archive through the route's decode: the outcome, and for
    an array its shape, dtype and digest, and whether they are the archive's."""
    dev_sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    t = time.perf_counter()
    rec = {"route": arc.route, "case": label}
    try:
        out = arc.decode(blob)
        dev_sync()
        x = out.cpu().numpy()
        rec.update(outcome="array", shape=list(x.shape), dtype=str(x.dtype), sha=digest(x),
                   conforms=tuple(x.shape) == tuple(arc.dims) and x.dtype == arc.dtype)
    except Exception as e:                    # the contract: raise, never crash
        dev_sync()
        rec.update(outcome="raised", error=f"{type(e).__name__}: {str(e)[:160]}",
                   conforms=True)
    rec["seconds"] = time.perf_counter() - t
    return rec


def sweep(route: str, device, flips: int = 60,
          emit: Optional[Callable[[dict], None]] = None) -> Tuple[Archive, List[dict]]:
    """The route's archive and the records of its cases: the route's KNOWN
    flips first, then `cases(...)`."""
    arc = make(route, device)
    todo = [(f"flip@{p}", flip(arc.blob, p)) for p in KNOWN.get(route, ())]
    todo += cases(arc.blob, arc.head, arc.tail, flips)
    recs = []
    for label, blob in todo:
        if emit is not None:
            emit({"route": route, "case": label, "outcome": "started"})
        recs.append(run_case(arc, label, blob))
        if emit is not None:
            emit(recs[-1])
    return arc, recs


def summary(route: str, recs: List[dict], seconds: float) -> dict:
    return {"route": route, "cases": len(recs),
            "arrays": sum(r["outcome"] == "array" for r in recs),
            "raised": sum(r["outcome"] == "raised" for r in recs),
            "nonconforming": sum(not r["conforms"] for r in recs),
            "max_case_s": max((r["seconds"] for r in recs), default=0.0), "wall_s": seconds}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("routes", nargs="*", default=list(ROUTES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--flips", type=int, default=60)
    ap.add_argument("--save", default=None)
    args = ap.parse_args(argv)

    def emit(rec):
        print(json.dumps(rec), flush=True)

    bad = 0
    for route in args.routes:
        t = time.perf_counter()
        arc, recs = sweep(route, torch.device(args.device), args.flips, emit)
        if args.save:
            from pathlib import Path
            Path(args.save, f"{route}.bin").write_bytes(arc.blob)
        s = summary(route, recs, time.perf_counter() - t)
        bad += s["nonconforming"]
        emit(s)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
