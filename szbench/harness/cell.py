"""One run of one cell: set-up, the measured window, the check, the result.

  set-up   the cell's files by name; the inputs made on the device (from
           the configuration's data seed, ordered by the run's seed, or
           from the run's seed) and copied to host numpy once (as the
           CLI, pysz and HDF5 users hand them); the entry's warm-up, which builds the
           program's engine and kernels on a checkout's first run and its
           caches (the stream order) on every run
  window   the entry's steps, one after another, for --seconds; every call
           timed on the host clock and ended by torch.cuda.synchronize();
           a sample of the decoded fields copied to the host between
           calls. torch.profiler runs over the window where a metric
           of the run reads the device trace (with --trace 1, always);
           with --trace 1 the port's layer entry points (port.SPANS) and
           the per-layer metrics' are wrapped
  check    after the window, the peak read and the program's state freed:
           no module of JAX or of the JAX package loaded; every decoded
           field of a sample drawn from the seed against its input under
           the bound worked out again from the input (reference/errbound.py);
           every decoded field due in the window counted
  result   the last line of standard output, one JSON object; the numbers
           compared, with their limits, last on standard error and last in
           that object
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import random
import statistics
import subprocess
import sys
import time
import traceback
from typing import Dict, List, Optional

from . import imports, manifest
from .reading import Call, Reading

MAX_ERR_OVER_EB = 1.0     # the configuration's own bound: |decoded - input| <= eb
SAMPLE = 4                # decoded fields of a run held for the check


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one benchmark cell of sz3_tpu_torch once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = os.path.join(root, ".szbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(base, sub)


class Context:
    """What an entry (szbench/entries/<entry>.py) works with."""

    def __init__(self, program, conf, pool, device, seed: int = 0) -> None:
        import torch

        self.program, self.conf, self.pool = program, conf, pool
        self.device = torch.device(device)
        self.calls: List[Call] = []
        self.kept: List[tuple] = []          # (pool index, decoded field on the host)
        self.offered = 0                     # decoded fields handed to keep()
        self._draw = random.Random(seed)
        self.clock = time.perf_counter_ns
        self._cuda = self.device.type == "cuda"

    def sync(self) -> None:
        if self._cuda:
            import torch
            torch.cuda.synchronize()

    def record(self, kind, t0, t1, nbytes, fields, archive_bytes) -> None:
        self.calls.append(Call(kind, t0, t1, int(nbytes), int(fields), int(archive_bytes)))

    def keep(self, k: int, out) -> None:
        """Offer a decoded field to the check after the window. A uniform
        sample of SAMPLE of the window's decoded fields, drawn from the seed
        (reservoir sampling), is held on the host, copied outside every
        timed call. Holding every field would grow the process by a field
        a call, and the host would slow as the window goes on."""
        self.offered += 1
        if len(self.kept) < SAMPLE:
            slot = len(self.kept)
            self.kept.append(None)
        else:
            slot = self._draw.randrange(self.offered)
            if slot >= SAMPLE:
                return
            self.kept[slot] = None           # freed before its successor is copied
        self.kept[slot] = (k, out.detach().to("cpu", copy=True))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read: {e}"


def check(ctx: Context, error_bound: dict) -> Dict[str, dict]:
    """The numbers compared, each with its limit."""
    import torch

    from szbench.reference import errbound

    dev = ctx.device
    bounds, worst, mismatch = {}, 0.0, 0
    for k, out in ctx.kept:
        x = torch.from_numpy(ctx.pool[k]).to(dev)
        if k not in bounds:
            bounds[k] = errbound.abs_bound(x, error_bound)
        try:
            err = errbound.max_abs_error(x, out.to(dev))
        except ValueError as e:
            print(f"szbench: field {k}: {e}", file=sys.stderr)
            mismatch += 1
            continue
        worst = max(worst, err / bounds[k] if bounds[k] > 0 else (0.0 if err == 0 else
                                                                  float("inf")))
    due = sum(c.fields for c in ctx.calls if c.kind == "decompress")
    if not ctx.kept:
        worst = float("inf")
    return {"max_err_over_eb": {"value": worst, "limit": MAX_ERR_OVER_EB},
            "fields_missing": {"value": due - ctx.offered, "limit": 0},
            "fields_wrong_shape": {"value": mismatch, "limit": 0}}


def inputs(gen, config: dict, seed: int, device):
    """The pool of fields. A configuration that names a `data_seed` makes
    the same fields for every run (the work of a compress depends on the
    values: LORENZO_REG's certification passes), and the run's seed orders
    them; without one, the run's seed makes them."""
    fields = int(config["fields"])
    made = gen.make(tuple(config["shape"]), fields, int(config.get("data_seed", seed)), device)
    if "data_seed" not in config:
        return made
    import torch

    order = torch.randperm(fields, generator=torch.Generator().manual_seed(int(seed) % 2**63))
    return made[order.to(made.device)]


def _label(key: str) -> str:
    mod, attr = key.split(":")
    return f"{mod.rsplit('.', 1)[-1]}.{attr}"


def run(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        program=None, bench_dir=None) -> Optional[dict]:
    """One run; returns the result object, or None where the run may print
    none (a forbidden module loaded)."""
    import torch

    from . import port

    readers = {m["name"]: manifest.metric_reader(m["name"], bench_dir)
               for m in (cell.per_layer if trace else cell.end_to_end)}
    config, traffic = cell.config, cell.traffic
    gen = manifest.generator(config["generator"], bench_dir)
    entry = manifest.entry(traffic["entry"], bench_dir)
    if program is None:
        program = port.Port(device)
    bad = imports.found()
    if bad:
        print(f"szbench: loaded with the cell's modules: {bad}", file=sys.stderr)
        return None
    cuda = torch.device(device).type == "cuda"
    dtype = getattr(torch, config["dtype"])
    pool = inputs(gen, config, seed, device).to(dtype).cpu().numpy()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ctx = Context(program, program.config(port.settings(config, traffic)), pool, device, seed)
    entry.warm(ctx)
    ctx.sync()

    recorder = session = None
    if trace or any(getattr(mod, "TRACE", False) for mod in readers.values()):
        from .trace import Session

        session = Session(cuda)
    if trace:
        from .spans import Recorder

        recorder = Recorder()
        notes: Dict[str, list] = {key: [] for key in port.SPANS}
        for mod in readers.values():
            for key in getattr(mod, "WRAPS", ()):
                notes.setdefault(key, [])
                if hasattr(mod, "note"):
                    notes[key].append(mod.note)
        for key, fns in notes.items():
            recorder.wrap(key, fns)
    setup_s = time.perf_counter() - t_start
    failed = 0
    try:
        if session is not None:
            session.start()
        begin = time.perf_counter_ns()
        end_at = begin + int(seconds * 1e9)
        i = 0
        while True:
            try:
                entry.step(ctx, i)
            except Exception:           # a failing call is counted, and the run goes on
                failed += 1
                if failed <= 3:
                    traceback.print_exc()
            i += 1
            if time.perf_counter_ns() >= end_at:
                break
        if session is not None:
            session.stop()
    finally:
        if recorder is not None:
            recorder.restore()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ops = session.device_ops() if session is not None else None
    del session
    program = None
    ctx.program = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    bad = imports.found()
    if bad:
        print(f"szbench: loaded once the window closed: {bad}", file=sys.stderr)
        return None
    print(f"szbench: card {card_line() if cuda else 'none (cpu)'}", file=sys.stderr)
    for kind in ("compress", "decompress"):
        walls = [(c.t1 - c.t0) / 1e6 for c in ctx.calls if c.kind == kind]
        if len(walls) >= 2:
            half = len(walls) // 2
            print(f"szbench: {len(walls)} {kind} calls, wall ms: min {min(walls):.3f}, median "
                  f"{statistics.median(walls):.3f} (first half {statistics.median(walls[:half]):.3f}"
                  f", second {statistics.median(walls[half:]):.3f}), max {max(walls):.3f}",
                  file=sys.stderr)
    t_check = time.perf_counter()
    checks = check(ctx, config["error_bound"])
    checks["calls_failed"] = {"value": failed, "limit": 0}
    print(f"szbench: {len(ctx.kept)} of {ctx.offered} decoded fields checked in "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)

    spans = recorder.spans if recorder is not None else {}
    reading = Reading(ctx.calls, spans, ops)
    reading.setup_s = setup_s
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = readers[m["name"]].read(reading)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name() if cuda else "cpu",
                "count": cell.chips, "memory_peak_bytes": int(peak)}
    # a step that raised made at least one failing call and recorded none
    result = {"correct": bool(correct), "attempted": len(ctx.calls) + failed, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if trace:
        # the traced window is the timed calls: the harness's own work between
        # them (the decoded fields' copies for the check) is left out
        dev_info["busy_s"] = reading.busy_in(reading.call_windows())
        dev_info["window_s"] = (reading.wall_s("compress") + reading.wall_s("decompress"))
        result["breakdown"] = reading.breakdown({k: _label(k) for k in spans})
    result["checks"] = checks
    return result


def print_checks(checks: Dict[str, dict]) -> None:
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)


def _finite(x):
    """JSON has no infinity or NaN: such a number is written as a string."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def main(argv, root: str, t_start: float) -> int:
    args = parse(argv)
    cell = manifest.find_cell(manifest.load_manifest(root), args.workload, root)
    cache_dirs(root)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"szbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    if result is None:
        return 3
    print_checks(result["checks"])
    sys.stderr.flush()
    print(json.dumps(_finite(result), allow_nan=False), flush=True)
    return 0
