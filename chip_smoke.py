#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sz3_tpu_torch) once on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each unguarded (a failure raises and the script exits non-zero):
  1. the card's name and power limit; the host engine and the CUDA kernels
     built from this checkout's sources, with their build times;
  2. each kernel against its plain PyTorch version on the card, bit for bit:
     the encode kernels on the stream-order bins of the 256^3 field and on
     synthetic streams (zeros, SENTINELs, symbols across the quantizer's
     whole range, and a Fibonacci histogram whose Huffman codes exceed 32
     bits; for K1 also a constant stream, an all-zero one and one with no
     symbol in its shared window); the decode kernels (the count phase's first pass and chained
     rescan, and the write phase) on the 256^3 archive's Huffman stream and
     on synthetic streams (codes of up to 63 bits, a shortest code of 1
     bit, fewer than 64 windows, a code that never synchronises). Their
     times (CUDA events, after a warm-up, in the order plain, kernel,
     kernel, plain), each kernel's bound, the decode kernels also with the
     L2 cache flushed before each launch, and every decode launch of one
     256^3 decompress summed; the share of the 256^3 symbols within
     +-64/512/2048/8190 of radius. Only K1's function has PyTorch calls
     (torch.bincount and torch.nonzero), timed beside it. The LORENZO_REG
     element sweep (lorenzo_sweep) in both forms, on the 256^3 field's own
     inputs and on a synthetic 253x255x257 grid (random first-order,
     second-order and kept cells, bins across the quantizer's range, NaN,
     Inf and subnormal values), with its bytes bound and its dependency
     bound (planes times one empty dependent launch, measured here), and
     on the 512^3 field's own inputs held to its plain versions and timed
     beside both bounds; LORENZO_REG's predictor selection (lorenzo_select)
     on the 512^3 field's own inputs, its speculative call and its first
     certifying call, held to select_plain and timed beside each call's
     bytes bound (the cells of both grids that the samples touch); the
     BIOMD frame recurrence (biomd_frames) in both forms on 64 frames of
     9,999 atoms (sites 3 and 4) with NaN, Inf, subnormal and huge values;
     the MDZ frame recurrence (mdz_frames) in both forms on 64 frames of
     9,999 atoms with the same values, at ABS 1e-3 and at an infinite bound;
  3. the inputs the JAX package sends to the host (no anchor grid, bins far
     from radius, a constant stream, f64, codes over 32 bits) compressed and
     decompressed on the card, archives sha256-equal to the host engine's
     and decodes bit-equal to its decode; for LORENZO_REG a constant field,
     tail blocks of extent 1 and 2, the speculation-flip field (passes
     printed), the three golden archives, and the 1D default field, which
     must go to the host engine without a kernel launch;
  4. the main path: sz3_tpu_torch.compress / decompress on the card at
     ABS 1e-3 with the default Config (the tuner's trials on the card), on
     bench.nyx_like(256) and nyx_like(512), and an f64 round trip at 256^3.
     The archives must be sha256-equal to the host engine's, the decodes
     bit-equal to its decode and within the bound, the device tuner's
     decisions equal to the host engine's tuner (both timed), and every
     kernel launched. Wall times, where the
     encode and decode time goes, the warm decode's peak device memory, and
     the card's busy time over one warm encode and decode, split by kind
     (torch.profiler); K1 timed on each size's stream;
  5. the LORENZO_REG path: compress / decompress with cmprAlgo LORENZO_REG
     (roster Lorenzo + regression, blockSize 6) at ABS 1e-3 on the same two
     fields, against the host engine as in phase 4, every kernel launched
     on it (counted over these calls alone), walls, each stage of the
     encode and the decode, the certification passes, peak device memory
     of a warm encode and decode, and the busy share;
  6. the other archive forms, each against the host engine as in phase 5
     (archives sha256-equal, decodes bit-equal, launches counted over the
     calls alone, walls cold and warm, the card's memory over the peak;
     stages with their device memory peaks for NOPRED and the 8-chunk ABS
     archive): NOPRED on nyx_like(512) f32
     and nyx_like(256) f64, with K1's window shares on its element-order
     stream; OpenMP-format archives of the default Config on nyx_like(512)
     in 8 chunks at ABS 1e-3 and REL 1e-3 and in 6 (ragged), each decoded
     across (the port's archive by the engine, the engine's on the card),
     and each chunk's device tuning held to the host engine's tuner.
     K1, K2+K3, the count and the write phase are held against their plain
     versions, bit for bit, on both NOPRED streams and on the last chunk's
     stream of the 8-chunk ABS archive, each the stream that the main path
     encoded and decoded (captured from the device encode and decode);
     BIOMD and BIOMDXTC on a water-like trajectory of 500 frames of the
     ApoA1 system's 92,224 atoms (553 MB), and on one of 200 frames whose last 100 are fill
     frames; biomd_frames against its plain versions at that shape, timed; the golden NOPRED, OpenMP, BIOMD
     and BIOMDXTC archives decoded on the card;
  7. MDZ (sz3_tpu_torch.mdz) against the host engine's szt_mdz_compress /
     szt_mdz_decompress: a lattice trajectory of 500 frames x 92,224 atoms x
     3 (553 MB) under ADP at REL 1e-3 in batches of 100, its first 100
     frames with VQ, VQT and MT pinned, and phase 6's water-like trajectory
     under ADP; archives sha256-equal, decodes bit-equal and within the
     bound, each side decoding the other's archive; walls cold and warm,
     stages (not for the water-like trajectory), warm peaks, each batch's
     method and mdz_frames' launches;
     mdz_frames against its plain versions on the VQT case's own input,
     timed with its bound;
  8. serving (sz3_tpu_torch.serving) on time steps of nyx_like(n) (snapshot
     k: the field rolled by 3k along axis 0 plus N(0, 1e-3 k) noise): 16 x
     256^3 at ABS 1e-3 with snapshots 7 and 15 white noise over 100 times the
     field's range, each value twice along the last axis (the lossless
     route), 4 x 512^3 at ABS, 8 x 256^3 at REL
     1e-3, 4 x 256^3 f64 at ABS; every archive sha256-equal to single-field
     compress (INTERP pinned) and to the host engine's, decompress_batch
     bit-equal to the engine's decode and within the bound; walls cold and
     warm beside the single-field warm walls summed, the busy share, the warm
     peaks, at 512^3 the device time inside the host seals and depth 1; K1,
     K2+K3, the count and the write phase held against their plain versions
     on the REL batch's last field, captured from the serving route;
  9. sharded payloads (sz3_tpu_torch.parallel.sharded) of a 517 x 512 x 512
     field at ABS and REL 1e-3: one NCCL rank in this process and 4 gloo
     ranks sharing cuda:0 (spawned), each payload sha256-equal to
     compress_chunked and to the host engine at as many chunks, each rank's
     decode bit-equal to the engine's; dryrun_multichip(4);
 10. the user-facing tools: the sz3t-torch CLI (sz3_tpu_torch.cli.main, in
     this process) on nyx_like(512) written raw to a file, at ABS 1e-3 with
     -a: its archive sha256-equal to the port's compress(...,
     set_datatype=False) and to phase 4's host-engine archive, its decoded
     file bit-equal to the engine's decode, the -a report's numbers held to
     a numpy float64 verify on the host (min, max and max_abs_err exactly,
     the rest to a relative 1e-12); K1, K2+K3, the count and the write phase
     held against their plain versions on the CLI's own stream (captured);
     the CLI's compress and decompress walls beside compress()'s and
     decompress()'s inside them, with the file I/O and the output's copy to
     the host timed alone; REL 1e-3 at 256^3 against compress() and the
     engine; `python -m sz3_tpu_torch.cli` at 256^3 in a fresh process, its
     cold wall; sz3t-torch-mdz (mdz.main) on phase 7's first 100 lattice
     frames against mdz_compress and the engine; pysz at 256^3 against
     compress() and the engine, round trip; verify on the card at 512^3
     beside numpy on the host, with its peak memory; profile_entropy at
     256^3 (every stage), scaling_bench's rank scaling (1 and 2 gloo ranks
     spawned on the card, a 64^3 REL field) and its per-chunk model at 256^3
     (n = 1, 2, 4, 8); the HDF5 filter plugin built (started on a thread beside the
     engine's build; HDF5 itself is held by the CPU tests). The launches of
     hist_literals, pack_bits, huff_scan, huff_write and mdz_frames are
     counted over the tools' runs, each at least once;
 11. the customized demo (sz3_tpu_torch.examples.customized_demo) on the
     card: pattern 1 (INTERP, LINEAR, ABS 1e-3 at 64^3 through compress /
     decompress) sha256-equal to the host engine's archive and decode, with
     hist_literals, pack_bits, huff_scan and huff_write each launched over
     it and each held bit for bit against its plain version on its stream;
     patterns 2 and 3 (device quantize, host Huffman and zstd) and 4
     (truncate) byte-equal to the same patterns run on the CPU; each
     pattern's wall; `python -m sz3_tpu_torch.examples.customized_demo` in a
     fresh process from the repository root, PYTHONPATH unset: exit 0, its
     four lines, no jax or sz3_tpu module imported (-X importtime); the
     single-step INTERP encode (sz3_tpu_torch.entry.entry) at 64^3 on the
     card bit-equal to entry("cpu"), its cold call and its warm call (CUDA
     events, the median of REPS) beside the card's name and power limit;
 12. the dtype x rank x algorithm x bound-mode surface against the host
     engine, each archive sha256-equal to its archive and each decode on the
     card bit-equal to its decode: (a) the float cases of
     tests/test_torch_matrix.py's blocks A-D (f32 and f64 at 1D-4D under
     INTERP_LORENZO, INTERP, LORENZO_REG and NOPRED, plain and OpenMP-format,
     at ABS and REL; PSNR, L2NORM, ABS_AND_REL and ABS_OR_REL; LINEAR and
     CUBIC INTERP; NaN and +-Inf, size-1 axes, tiny fields, LORENZO_REG
     rosters), hist_literals, pack_bits, huff_scan, huff_write and
     lorenzo_sweep each launched over them and K1, K2+K3, the count and the
     write phase held against their plain versions on the 2D and 4D CUBIC
     cases' streams; (b) a 1800 x 3600 field (SDRBench CESM-ATM's 2D shape)
     and a 288 x 115 x 69 x 69 one (QMCPACK's einspline shape), synthetic,
     under the default Config at ABS 1e-3: the device tuner's decisions
     against the engine's, walls cold and warm beside the engine's, ratio,
     warm peaks, the kernels held on the 2D field's stream; (c) integer
     fields, which take the engine's route: the eight integer dtypes at 64^3
     in one archive and in 8 chunks, uint16 at 512^3 and int32 at 256^3,
     with no kernel launched and no device memory taken by a compress, walls
     beside the engine's; the phase's time;
 14. the benchmark's cell cesm2d-fields against the plain reference of SZ3's
     2D interpolation (szbench/reference/interp_plain.py): its 16 CESM-ATM
     fields at 1800 x 3600, made by the cell's generator from the
     configuration's data_seed, each compressed and decompressed through the
     benchmark's own calls (szbench/harness/port.py) under the cell's
     traffic (the default Config, the tuner on); the reference run on the
     card with the Config each archive carries. Every decoded field
     bit-equal to the reference's reconstruction, the bins of
     encode_grid_fast equal to the reference's, the engine's stream order
     equal to the reference's, and every decoded value within the bound
     worked out again from the input (the cell's check, max_err_over_eb <=
     1.0); the tuner's pick a field, read from its dispatch.tune span, equal to
     the archive's Config. Alone: ``python3 -c "import torch, chip_smoke;
     chip_smoke.phase14_cesm2d(torch.device('cuda'))"``;
 15. the same for the cell qmcpack4d-roundtrip against the plain reference of
     SZ3's 3D/4D interpolation (szbench/reference/interp_plain_nd.py): its 4
     QMCPACK-like tables at 288 x 115 x 69 x 69, made by the cell's
     generator (einspline_like) from data_seed, the passes on the kernel
     route (the interp.passes span's route, with its rank and predicted).
     Alone: ``python3 -c "import torch, chip_smoke;
     chip_smoke.phase15_qmcpack4d(torch.device('cuda'))"``.
The host engine is the port's own (sz3_tpu_torch/csrc/engine, built here by
sz3_tpu_torch.build.host_engine()). The last line is {"ok": true, "device":
{...}}; the line before it lists the kernels. Without a CUDA device, or
without the repository beside it, the script prints no result and exits 2.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import itertools
import json
import math
import os
import struct
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
EB = 1e-3
SIZES = (256, 512)
REPS = 10
PLAIN_SCAN_REPS = 1        # the plain scan is thousands of small launches
SPIN_CYCLES = 40_000_000   # of torch.cuda._sleep: some 20 ms on an H100
# the per-window symbol rows of the decode before its write phase, MB, as
# measured when they existed (PERF.md): they are gone
ROWS_MB = {256: 132, 512: 1400}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
# the kernels are 32-bit integer work outside the tensor cores; the float32
# rate outside the tensor cores stands in as their peak
OPS_PER_S = 67e12


TRAJ_FRAMES, TRAJ_ATOMS = 500, 92_224   # the ApoA1 MD benchmark system's atoms
FILL_FRAMES = 200          # the fill-frame trajectory: 100 live frames, then 100 of fill
CHUNKS = 8


def md_traj(frames, atoms, seed=0, fill_tail=0, site_atoms=3):
    """A water-like trajectory, (frames, atoms, 3) float32: molecules of
    `site_atoms` atoms around random centres, each atom a random walk; the
    last `fill_tail` frames filled with -1 (the port's copy of
    tests/test_biomd_device.py::md_traj)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    g = atoms // site_atoms + 1
    base = rng.uniform(-5, 5, (g, 1, 3)).repeat(site_atoms, axis=1)
    base = (base + rng.normal(0, 0.05, (g, site_atoms, 3))).reshape(-1, 3)[:atoms]
    traj = base[None] + np.cumsum(rng.normal(0, 0.01, (frames, atoms, 3)), axis=0)
    if fill_tail:
        traj[-fill_tail:] = -1.0
    return np.ascontiguousarray(traj, dtype=np.float32)


def walk_field(shape, dtype, seed=0):
    """tests/test_torch_matrix.py's field: a random walk along every axis,
    unit spread; for an integer dtype scaled over (at most 20,000 steps of)
    the type's range and clipped."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    for ax in range(x.ndim):
        x = np.cumsum(x, axis=ax)
    x = (x - x.mean()) / (x.std() or 1.0)
    if dtype in (np.float32, np.float64):
        return x.astype(dtype)
    info = np.iinfo(dtype)
    span = min(float(info.max) - float(info.min), 20000.0)
    mid = 0.0 if info.min < 0 else span / 2
    return np.clip(np.rint(mid + x * span / 8), info.min, info.max).astype(dtype)


def wave_field(shape, seed, dev):
    """A smooth float32 field of any rank, made on the card from a seed by
    bench.nyx_like's recipe: waves at three scales (a product of sines along
    the axes, each with a random phase) and a mild random walk along the
    last axis."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    phases = torch.rand((3, len(shape)), generator=g, device=dev, dtype=torch.float64).cpu()
    f = torch.zeros(shape, dtype=torch.float32, device=dev)
    for k, freq in enumerate((2.0, 6.0, 16.0)):
        term = None
        for ax, n in enumerate(shape):
            v = torch.sin(torch.linspace(0, freq * math.pi, n, device=dev, dtype=torch.float64)
                          + 2 * math.pi * float(phases[k, ax])).float()
            v = v.view([n if i == ax else 1 for i in range(len(shape))])
            term = v if term is None else term * v
        f += term / (k + 1)
        del term
    f += 0.05 / math.sqrt(shape[-1]) * torch.cumsum(
        torch.randn(shape, generator=g, device=dev), dim=-1)
    return f


def _phase9_rank(rank: int, world: int, store: str, out: str, field: str, modes) -> None:
    """One of phase 9's gloo ranks, all on cuda:0: the sharded encode and
    decode of the field saved at `field` in each mode; writes the payload's
    and the decode's sha256, the walls and the kernels' launches to
    <out>/rank<r>.json."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    import sz3_tpu_torch as szp
    from sz3_tpu_torch.ops import entropy_decode as dec
    from sz3_tpu_torch.ops import entropy_device as ed
    from sz3_tpu_torch.parallel import sharded

    counters = {"hist_literals": ed.hist_and_literals, "pack_bits": ed.pack_bits,
                "huff_scan": dec.scan_windows, "huff_write": dec.write_windows}
    data = np.load(field)
    sharded.init_file_group(store, rank, world)
    res = {}
    try:
        for mode in modes:
            kw = {"absErrorBound": EB} if mode == "ABS" else {
                "errorBoundMode": szp.EB.REL, "relErrorBound": 1e-3}
            for w in counters.values():
                w.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            payload = sharded.sharded_encode_payload(
                szp.Config(cmprAlgo=szp.ALGO.INTERP, openmp=True, **kw), data)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            field_out = sharded.sharded_decode_payload(szp.Config(dims=data.shape, openmp=True),
                                                       payload, dtype=np.float32)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            res[mode] = {"payload_sha": hashlib.sha256(payload).hexdigest(),
                         "out_sha": hashlib.sha256(field_out.cpu().numpy().tobytes()).hexdigest(),
                         "enc_s": t1 - t0, "dec_s": t2 - t1,
                         "launches": {k: w.launches for k, w in counters.items()}}
            del field_out
    finally:
        sharded.dist.destroy_process_group()
    (Path(out) / f"rank{rank}.json").write_text(json.dumps(res))


def cell_against_reference(dev, phase: int, workload: str, ref_module: str) -> dict:
    """The fields of the benchmark's cell `workload` through the benchmark's
    calls, each held to the plain reference szbench/reference/<ref_module>.py
    run on the card with the Config the archive carries (phases 14 and 15)."""
    import importlib

    import numpy as np
    import torch

    import sz3_tpu_torch as szp
    from sz3_tpu_torch import runtime
    from sz3_tpu_torch.ops.interp_fast import bins_to_grid, build_fast_plan, encode_grid_fast
    from sz3_tpu_torch.utils import trace
    from szbench.harness import manifest, port
    from szbench.reference import errbound

    ip = importlib.import_module(f"szbench.reference.{ref_module}")
    t_phase = time.perf_counter()
    cell = manifest.find_cell(manifest.load_manifest(ROOT), workload, ROOT)
    cfg = cell.config
    gen = manifest.generator(cfg["generator"])
    pool = gen.make(tuple(cfg["shape"]), int(cfg["fields"]), int(cfg["data_seed"]), dev)
    # host arrays, as the cell hands them over
    pool = pool.to(getattr(torch, cfg["dtype"])).cpu().numpy()
    program = port.Port(dev)
    conf = program.config(port.settings(cfg, cell.traffic))
    rows = []
    traced = trace.enabled()
    trace.enable(ranges=False)          # the tuner's pick, read from its dispatch.tune span
    for v, x in enumerate(pool):
        trace.spans()
        t = time.perf_counter()
        blob = program.compress(x, conf)
        out, carried = szp.decompress(blob, device=dev)     # Port.decompress, with the Config
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        spans = trace.spans()
        tune, = [sp.attrs for sp in spans if sp.name == "dispatch.tune"]
        passes, = [sp.attrs for sp in spans if sp.name == "interp.passes"]
        xd = torch.from_numpy(x).to(dev)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        ref = ip.encode(xd, **ip.settings(carried))
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t
        ref_peak = torch.cuda.max_memory_allocated() - base
        plan = build_fast_plan(tuple(cfg["shape"]), interp_algo=int(carried.interpAlgo),
                               direction=carried.interpDirection,
                               anchor_stride=carried.interpAnchorStride,
                               alpha=carried.interpAlpha, beta=carried.interpBeta,
                               eb=carried.absErrorBound, quantbin_cnt=carried.quantbinCnt)
        bins, b0, _ = encode_grid_fast(xd, plan)
        eb = errbound.abs_bound(xd, cfg["error_bound"])
        rows.append({
            "field": v, "algo": int(carried.cmprAlgo), "interp_algo": int(carried.interpAlgo),
            "direction": carried.interpDirection, "alpha": carried.interpAlpha,
            "beta": carried.interpBeta, "anchor": carried.interpAnchorStride,
            "ratio": x.nbytes / len(blob), "round_trip_s": wall, "tune": tune,
            "passes": {k: passes.get(k) for k in ("route", "launches", "rank", "predicted")},
            "tune_is_carried": (tune["interp_algo"], tune["direction"], tune["alpha"],
                                tune["beta"]) == (int(carried.interpAlgo), carried.interpDirection,
                                                  carried.interpAlpha, carried.interpBeta),
            "bit_equal": bool(torch.equal(out.view(torch.int32), ref.recon.view(torch.int32))),
            "bins_equal": bool(torch.equal(bins_to_grid(bins, plan, b0, dev), ref.bins)),
            "order_equal": bool(np.array_equal(runtime.interp_order(carried),
                                               ref.order.cpu().numpy())),
            "unpred": int(ref.unpred.numel()), "reference_s": ref_s,
            "reference_peak_bytes": int(ref_peak),
            "max_err_over_eb": errbound.max_abs_error(xd, out) / eb})
        print(f"phase {phase} field {v}: {json.dumps(rows[-1])}", flush=True)
        del out, xd, ref, bins
    if not traced:
        trace.disable()
    summary = {"workload": workload, "fields": len(rows),
               "bit_equal": sum(r["bit_equal"] for r in rows),
               "bins_equal": sum(r["bins_equal"] for r in rows),
               "order_equal": sum(r["order_equal"] for r in rows),
               "max_err_over_eb": max(r["max_err_over_eb"] for r in rows),
               "picks": sorted({(r["interp_algo"], r["direction"], r["alpha"], r["beta"])
                                for r in rows}),
               "phase_s": time.perf_counter() - t_phase}
    print(f"phase {phase}: {json.dumps(summary)}", flush=True)
    check(all(r["algo"] == int(szp.ALGO.INTERP) for r in rows),
          f"phase {phase}: a field did not take INTERP")
    check(all(r["tune_is_carried"] for r in rows),
          f"phase {phase}: a dispatch.tune span's decision differs from the archive's Config")
    check(all(r["passes"]["route"] == "kernel" for r in rows),
          f"phase {phase}: the passes did not take the kernel route")
    check(summary["bit_equal"] == summary["fields"],
          f"phase {phase}: {summary['fields'] - summary['bit_equal']} decoded fields differ from "
          f"the plain reference's reconstruction")
    check(summary["bins_equal"] == summary["fields"],
          f"phase {phase}: bins differ from the reference's")
    check(summary["order_equal"] == summary["fields"],
          f"phase {phase}: the stream order differs from the reference's")
    check(summary["max_err_over_eb"] <= 1.0,
          f"phase {phase}: max_err_over_eb {summary['max_err_over_eb']!r} over 1.0")
    return summary


def phase14_cesm2d(dev) -> dict:
    """Phase 14: the fields of the cell cesm2d-fields through the benchmark's
    calls, each held to the plain reference of SZ3's 2D interpolation."""
    return cell_against_reference(dev, 14, "cesm2d-fields", "interp_plain")


def phase15_qmcpack4d(dev) -> dict:
    """Phase 15: the tables of the cell qmcpack4d-roundtrip through the
    benchmark's calls, each held to the plain reference of SZ3's 3D/4D
    interpolation."""
    return cell_against_reference(dev, 15, "qmcpack4d-roundtrip", "interp_plain_nd")


def np_verify(original, decoded) -> dict:
    """The distortion quantities of sz3_tpu_torch.stats.verify in numpy
    float64 on the host, by the formulas of the reference's
    Statistic.hpp:80-140 (as the JAX package computes them)."""
    import numpy as np

    ori = np.asarray(original, dtype=np.float64).ravel()
    dec = np.asarray(decoded, dtype=np.float64).ravel()
    mn, mx = float(ori.min()), float(ori.max())
    rng = mx - mn
    err = dec - ori
    abs_err = np.abs(err)
    max_abs = float(abs_err.max())
    nz = ori != 0
    max_pw = float((abs_err[nz] / np.abs(ori[nz])).max()) if nz.any() else 0.0
    mse = float((err * err).mean())
    m1, m2 = float(ori.mean()), float(dec.mean())
    prod = float(((ori - m1) * (dec - m2)).mean())
    s1 = math.sqrt(float(((ori - m1) ** 2).mean()))
    s2 = math.sqrt(float(((dec - m2) ** 2).mean()))
    norm_err = math.sqrt(float((err * err).sum()))
    l2 = math.sqrt(float((dec * dec).sum()))
    return {"min": mn, "max": mx, "value_range": rng, "max_abs_err": max_abs,
            "max_rel_err": max_abs / rng if rng > 0 else 0.0, "max_pw_rel_err": max_pw,
            "psnr": 20 * math.log10(rng) - 10 * math.log10(mse) if mse > 0 and rng > 0
            else math.inf,
            "nrmse": math.sqrt(mse) / rng if rng > 0 else 0.0, "norm_err": norm_err,
            "norm_err_norm": norm_err / l2 if l2 > 0 else 0.0,
            "ac_eff": prod / s1 / s2 if s1 > 0 and s2 > 0 else 0.0}


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 2
    if not (ROOT / "sz3_tpu_torch" / "__init__.py").is_file() or not (ROOT / "bench.py").is_file():
        print("chip_smoke: run from a checkout of the repository; sz3_tpu_torch is missing",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    import numpy as np

    from sz3_tpu_torch import build

    # the HDF5 filter plugin's g++ build, beside the engine's; joined in phase 10
    h5z = {}

    def build_plugin():
        t0 = time.perf_counter()
        try:
            h5z["path"] = build.build_h5z()
        except RuntimeError as e:       # reported, and failed on, in phase 10
            h5z["error"] = str(e)
        h5z["s"] = time.perf_counter() - t0

    h5z_thread = threading.Thread(target=build_plugin, daemon=True)
    h5z_thread.start()
    t = time.perf_counter()
    runtime = build.host_engine()
    print(f"host engine ready: {time.perf_counter() - t:.2f} s", flush=True)
    t = time.perf_counter()
    build.build_kernels(verbose=True)
    build.kernels()
    print(f"kernel build: {time.perf_counter() - t:.2f} s", flush=True)

    import sz3_tpu_torch as szp
    from bench import nyx_like
    from sz3_tpu_torch import mdz
    from sz3_tpu_torch.algos import device_decode as dd
    from sz3_tpu_torch.algos import device_encode as de
    from sz3_tpu_torch.algos import mdz_torch, torch_backend, tuner
    from sz3_tpu_torch.algos.huffman import build_table
    from sz3_tpu_torch.api import archive_conf
    from sz3_tpu_torch.ops import biomd_device as bd
    from sz3_tpu_torch.ops import blockwise_layout as bl
    from sz3_tpu_torch.ops import blockwise_wavefront as wf
    from sz3_tpu_torch.ops import blockwise_wavefront_encode as wfe
    from sz3_tpu_torch.ops import entropy_decode as dec
    from sz3_tpu_torch.ops import entropy_device as ed
    from sz3_tpu_torch.ops import mdz_device as md
    from sz3_tpu_torch.ops import stream_order
    from sz3_tpu_torch.ops.interp_fast import (bins_to_grid, decode_grid_fast, encode_grid_fast,
                                               encode_grid_plain, grid_to_pass_slices,
                                               initial_literal)
    from sz3_tpu_torch.parallel import chunked
    from sz3_tpu_torch.stats import cal_abs_error_bound
    from sz3_tpu_torch.utils.copies import to_device, to_host

    dev = torch.device("cuda")

    def native_compress(data, conf, nthreads=0):
        c, cap = archive_conf(data, conf)
        return szp.pack_archive(c, runtime.compress_payload(c, data, cap, nthreads))

    def native_decompress(blob):
        conf, payload = szp.open_archive(blob)
        return runtime.decompress_payload(conf, payload)

    t_start = time.perf_counter()

    def stamp(what):
        print(f"[{time.perf_counter() - t_start:7.1f} s] {what}", flush=True)

    def sync_time(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def host_bytes(t):
        """`t` read back through the port's copy to the host, waited for, as bytes."""
        host = to_host(t)
        torch.cuda.current_stream().synchronize()
        return host.numpy().tobytes()

    def event_ms(fn, reps=REPS):
        """ms per call between two CUDA events. The calls are queued behind a
        kernel that spins for some 20 ms, so that the host's share of a call
        (checks, allocation) is done before the card gets to it; a wrapper
        that reads a result back waits for the card all the same."""
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / reps

    def paired_ms(kernel, plain, plain_reps=REPS):
        p1 = event_ms(plain, plain_reps)
        k1 = event_ms(kernel)
        k2 = event_ms(kernel)
        p2 = event_ms(plain, plain_reps)
        return (k1 + k2) / 2, (p1 + p2) / 2, [p1, k1, k2, p2]

    def bound(nbytes, ops):
        """(least ms the card could take, what sets it): each input read once
        and each output written once at the memory rate, or the operations
        at the peak rate."""
        by, op = nbytes / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
        return (by, "bytes") if by >= op else (op, "operations")

    def kind_of(name: str) -> str:
        low = name.lower()
        if "memcpy" in low:
            return "HtoD copies" if "htod" in low else "DtoH copies" if "dtoh" in low \
                else "other copies"
        return "fills" if "memset" in low else "kernels"

    def busy(fn):
        """(device busy ms, profiled wall ms, device events, ms by kind) over
        one call: the union of the intervals of every kernel, copy and fill
        the profiler saw on the card, and the summed time of each kind
        (kernels, host-to-device copies, device-to-host copies, fills)."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        kinds = {}
        for e in events:
            k = kind_of(e.name)
            kinds[k] = kinds.get(k, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
        total, end = 0.0, float("-inf")
        for s, e in sorted((e.time_range.start, e.time_range.end) for e in events):
            if e > end:
                total += e - max(s, end)
                end = e
        return total / 1e3, wall * 1e3, len(events), kinds

    def device_ms(fn, reps=10, by_kind=False):
        """Summed device time of everything one call of fn runs on the card
        (kernels, fills, copies), from torch.profiler: without the time the
        card waits for the host inside a wrapper that reads a result back.
        With by_kind, the same split into kernels, fills and copies."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kinds = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                k = kind_of(e.name)
                kinds[k] = kinds.get(k, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / reps
        return kinds if by_kind else sum(kinds.values())

    def k1_on_card(s, rad):
        """K1's wrapper on the stream s: (ms a call, CUDA events; ms on the
        card, and its kernels and fill alone, torch.profiler)."""
        kinds = device_ms(lambda: ed.hist_and_literals(s, rad), by_kind=True)
        return (event_ms(lambda: ed.hist_and_literals(s, rad)), sum(kinds.values()),
                kinds.get("kernels", 0.0) + kinds.get("fills", 0.0))

    def window_shares(s, rad):
        """% of the stream's symbols (bin 0 aside) within +-64/512/2048/8190
        bins of radius."""
        d = (s[s != 0].to(torch.int64) - rad).abs()
        return [100 * float((d <= w).sum()) / s.numel() for w in (64, 512, 2048, 8190)]

    def outside_k1_window(hist, rad):
        """Symbols (bin 0 and SENTINEL aside) outside K1's shared window."""
        lo = max(2, rad + 1 - ed.K1_W_HALF)
        return int(hist[2:].sum() - hist[lo:lo + 2 * ed.K1_W_HALF].sum())

    def max_abs_diff(a, b) -> int:
        check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel() == 0:
            return 0
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    def tuned_conf(data):
        """The Config that compress() encodes `data` with: tuned by the
        device tuner, anchor stride resolved (the archive's tail does not
        carry every tuned parameter; the payload header does)."""
        conf = szp.Config(absErrorBound=EB)
        conf.set_dims(data.shape)
        check(tuner.tune(conf, data, dev), "the device tuner declined a 3D float field")
        torch_backend._resolve_anchor_stride(conf)
        return conf

    tuned_fields = ("cmprAlgo", "interpAlgo", "interpDirection", "interpAlpha", "interpBeta")

    def both_tuners(conf, data):
        """The device tuner and the host engine's on copies of `conf`: their
        decisions, checked equal, and both times (s)."""
        dconf, hconf = conf.copy(), conf.copy()
        ok, dev_s = sync_time(lambda: tuner.tune(dconf, data, dev))
        _, host_s = sync_time(lambda: runtime.tune_interp(hconf, data))
        got = {f: float(getattr(dconf, f)) for f in tuned_fields}
        want = {f: float(getattr(hconf, f)) for f in tuned_fields}
        check(ok and got == want, f"device tuner {got} != host engine's {want}")
        return got, dev_s, host_s

    def stream_of(x, conf):
        plan = de.plan_for(conf)
        bins_list, b0, _ = encode_grid_fast(x, plan)
        return stream_order.to_stream(bins_to_grid(bins_list, plan, b0, dev),
                                      de.perm_for(conf, dev))

    def lr_conf(eb=EB):
        return szp.Config(cmprAlgo=szp.ALGO.LORENZO_REG, absErrorBound=eb)

    @contextlib.contextmanager
    def first_calls(mod, name, n):
        """Copies of the arguments of the first n calls of mod.name, as
        {"calls": [args, ...]}; an argument that is one tensor in several
        places or calls is one copy in all of them."""
        fn = getattr(mod, name)
        seen = {"calls": []}
        copies = {}

        def keep(v):
            if id(v) not in copies:         # the original kept too, so its id stays its own
                copies[id(v)] = (v, v.clone())
            return copies[id(v)][1]

        def inner(*a, **k):
            if len(seen["calls"]) < n:
                seen["calls"].append([keep(v) if isinstance(v, torch.Tensor) else v for v in a])
            return fn(*a, **k)

        setattr(mod, name, inner)
        try:
            yield seen
        finally:
            setattr(mod, name, fn)

    @contextlib.contextmanager
    def timed(spec, memory=None):
        """Every call of each (module, attribute, stage) in `spec` timed
        between two synchronisations; yields {stage: [seconds per call]}.
        With a dict `memory`, it receives each stage's peak device memory
        above what was allocated when the stage began, in bytes (the largest
        over its calls; a stage that holds others counts their peaks too). A
        wrapper stands in for the function while the block runs, so a
        kernel's own launch count is not kept then."""
        stages = {}
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in spec]
        frames = []     # per open stage: [allocated at its start, peak seen so far]

        def wrap(fn, stage):
            def inner(*a, **k):
                if memory is not None:
                    torch.cuda.synchronize()
                    if frames:      # the peak so far of the stage that holds this one
                        frames[-1][1] = max(frames[-1][1], torch.cuda.max_memory_allocated())
                    frames.append([torch.cuda.memory_allocated(), 0])
                    torch.cuda.reset_peak_memory_stats()
                out, sec = sync_time(lambda: fn(*a, **k))
                stages.setdefault(stage, []).append(sec)
                if memory is not None:
                    held, seen = frames.pop()
                    peak = max(seen, torch.cuda.max_memory_allocated())
                    memory[stage] = max(memory.get(stage, 0), peak - held)
                    if frames:
                        frames[-1][1] = max(frames[-1][1], peak)
                return out
            inner.launches = 0
            return inner

        for (mod, name, fn), (_, _, stage) in zip(saved, spec):
            setattr(mod, name, wrap(fn, stage))
        try:
            yield stages
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)

    @contextlib.contextmanager
    def captured(mod, name):
        """Copies of the arguments of each call of mod.name, the last call's
        kept."""
        fn = getattr(mod, name)
        seen = {}

        def inner(*a, **k):
            seen["args"] = [v.clone() if isinstance(v, torch.Tensor) else v for v in a]
            return fn(*a, **k)

        setattr(mod, name, inner)
        try:
            yield seen
        finally:
            setattr(mod, name, fn)

    fields = {}
    native = {}
    t = time.perf_counter()
    fields[256] = nyx_like(256)
    print(f"nyx_like(256): {time.perf_counter() - t:.2f} s", flush=True)
    native[256] = sync_time(lambda: native_compress(fields[256], szp.Config(absErrorBound=EB)))

    # ---- phase 2: kernels against their plain versions --------------------------
    conf = tuned_conf(fields[256])
    check(conf.cmprAlgo == szp.ALGO.INTERP, f"tuner chose {conf.cmprAlgo.name}, not INTERP")
    radius = conf.quantbinCnt // 2
    x = torch.from_numpy(fields[256].reshape(conf.dims)).to(dev)
    stream = stream_of(x, conf)
    num = stream.numel()

    rng = np.random.default_rng(7)
    syn_n = 5_000_003
    syn = (radius + np.round(rng.standard_normal(syn_n) * 40)).astype(np.int32)
    syn[rng.random(syn_n) < 0.01] = 0
    syn[rng.random(syn_n) < 0.005] = ed.SENTINEL
    syn_wide = syn.copy()
    far = rng.random(syn_n) < 0.01
    syn_wide[far] = rng.integers(1, 2 * radius, int(far.sum()))
    # Fibonacci counts over 36 symbols give a Huffman tree 35 levels deep
    fib = [1, 1]
    while len(fib) < 36:
        fib.append(fib[-1] + fib[-2])
    syn_deep = np.repeat(np.arange(radius - 18, radius + 18, dtype=np.int32), fib)
    syn_deep = syn_deep[rng.permutation(syn_deep.size)]
    syn_streams = {"synthetic": syn, "synthetic, whole range": syn_wide,
                   "synthetic, codes > 32 bits": syn_deep}
    syn_streams = {k: torch.from_numpy(v).to(dev) for k, v in syn_streams.items()}
    # K1 alone: one symbol everywhere (the most contention), every slot a
    # literal, and no symbol in K1's shared window (every one on its cold path)
    far_out = rng.integers(radius + ed.K1_W_HALF + 1, 2 * radius + 3, syn_n)
    low = rng.random(syn_n) < 0.5
    far_out[low] = rng.integers(1, radius - ed.K1_W_HALF - 1, int(low.sum()))
    k1_only = {"constant": torch.full((num,), radius, dtype=torch.int32, device=dev),
               "all zero": torch.zeros(syn_n, dtype=torch.int32, device=dev),
               "all outside the shared window": torch.from_numpy(far_out.astype(np.int32)).to(dev)}

    def hold_k1(name, s, rad):
        """K1 against its plain version on the stream s, bit for bit: (max
        abs diff, the histogram on the host)."""
        hk, sk = ed.hist_and_literals(s, rad)
        hp, sp = ed.hist_and_literals_plain(s, rad)
        torch.cuda.synchronize()
        hp = hp.cpu()
        err = max(max_abs_diff(hk, hp), max_abs_diff(sk, sp))
        check(err == 0 and torch.equal(hk, hp) and torch.equal(sk, sp),
              f"K1 {name}: differs from its plain version (max abs diff {err})")
        print(f"K1 {name}: bit-equal to plain (n={s.numel()}, literals={sk.numel()}, "
              f"outside the shared window={outside_k1_window(hk, rad)})", flush=True)
        return err, hk

    def hold_pack(name, s, tc, tl, rad, nbits):
        """K2+K3 against its plain version on the stream s under the code
        tables tc, tl, bit for bit: (max abs diff, the packed words)."""
        wk = ed.pack_bits(s, tc, tl, rad, nbits)
        wp = ed.pack_bits_plain(s, tc, tl, rad, nbits)
        torch.cuda.synchronize()
        err = max_abs_diff(wk, wp)
        check(err == 0 and torch.equal(wk, wp),
              f"K2+K3 {name}: differs from its plain version (max abs diff {err})")
        print(f"K2+K3 {name}: bit-equal to plain ({nbits} bits, {wk.numel()} words, "
              f"longest code {int(tl.max())} bits)", flush=True)
        return err, wk

    k1_err = 0
    for name, s in (("256^3 stream", stream), *syn_streams.items(), *k1_only.items()):
        err, hk = hold_k1(name, s, radius)
        k1_err = max(k1_err, err)
        outside = outside_k1_window(hk, radius)
        check(name != "all outside the shared window" or outside == syn_n,
              f"K1 {name}: {outside} of {syn_n} symbols outside the shared window")
    del k1_only
    print("share of the 256^3 symbols within +-64/512/2048/8190 of radius: "
          + " / ".join(f"{v:.5f} %" for v in window_shares(stream, radius))
          + f" (K1's shared window: +-{ed.K1_W_HALF})", flush=True)

    tables = {"256^3 stream": (stream,) + de._tree_and_tables(
        ed.hist_and_literals(stream, radius)[0], radius, num, dev)}
    for name, s in syn_streams.items():
        h, _ = ed.hist_and_literals(s, radius)
        tables[name] = (s,) + de._tree_and_tables(h, radius, int(s.numel() - int(h[1])), dev)
    # random tables of codes of 1-64 bits (not a Huffman code, but every
    # length and every alignment of a code across two or three words)
    rand_lens = rng.integers(1, 65, ed.table_len(radius)).astype(np.int32)
    rand_codes = rng.integers(-2 ** 63, 2 ** 63 - 1, ed.table_len(radius), dtype=np.int64)
    rand_tl = torch.from_numpy(rand_lens).to(dev)
    rand_s = tables["synthetic, whole range"][0]
    rand_bits = int(rand_tl.to(torch.int64)[ed._sym_index(rand_s, radius).long()].sum())
    tables["synthetic, random 1-64 bit codes"] = (
        rand_s, b"", rand_bits, torch.from_numpy(rand_codes).to(dev), rand_tl)
    k2_err = 0
    for name, (s, _tree, nbits, tc, tl) in tables.items():
        k2_err = max(k2_err, hold_pack(name, s, tc, tl, radius, nbits)[0])
    check(int(tables["synthetic, codes > 32 bits"][4].max()) > 33, "no code exceeds 33 bits")

    _, _, total_bits, tc, tl = tables["256^3 stream"]
    k1_ms, k1_plain_ms, k1_runs = paired_ms(lambda: ed.hist_and_literals(stream, radius),
                                            lambda: ed.hist_and_literals_plain(stream, radius))
    k2_ms, k2_plain_ms, k2_runs = paired_ms(
        lambda: ed.pack_bits(stream, tc, tl, radius, total_bits),
        lambda: ed.pack_bits_plain(stream, tc, tl, radius, total_bits))
    _, k1_dev_ms, k1_kern_ms = k1_on_card(stream, radius)
    k2_dev_ms = device_ms(lambda: ed.pack_bits(stream, tc, tl, radius, total_bits))
    # the library yardstick, never called by the port: a histogram of a
    # precomputed symbol index and the positions of the zeros
    idx64 = ed._sym_index(stream, radius).to(torch.int64)
    bincount_ms = event_ms(lambda: torch.bincount(idx64, minlength=ed.table_len(radius)))
    nonzero_ms = event_ms(lambda: torch.nonzero(stream == 0))
    k1_library_ms = bincount_ms + nonzero_ms
    del idx64
    print(f"K1 hist_literals at 256^3: kernel {k1_ms:.4f} ms a call, of which {k1_dev_ms:.4f} ms "
          f"on the card ({k1_kern_ms:.4f} ms kernels and fill; the wrapper reads the histogram "
          f"back once, between its count and placement passes), plain {k1_plain_ms:.3f} ms "
          f"(plain,kernel,kernel,plain = {[round(v, 4) for v in k1_runs]}); PyTorch calls: "
          f"torch.bincount of the int64 symbol index {bincount_ms:.4f} ms + "
          f"torch.nonzero(bins == 0) {nonzero_ms:.4f} ms = {k1_library_ms:.4f} ms", flush=True)
    print(f"K2+K3 pack_bits at 256^3: kernel {k2_ms:.3f} ms a call, of which {k2_dev_ms:.3f} ms "
          f"on the card (the wrapper reads the total back), plain {k2_plain_ms:.3f} ms "
          f"(plain,kernel,kernel,plain = {[round(v, 3) for v in k2_runs]})", flush=True)
    nlit = ed.hist_and_literals(stream, radius)[1].numel()
    k1_bound = bound(4 * num + 4 * ed.table_len(radius) + 4 * nlit, 4 * num)
    k2_bound = bound(4 * num + 12 * ed.table_len(radius) + 4 * ((total_bits + 31) // 32),
                     12 * num)
    del x, stream, syn_streams, tables, tc, tl
    torch.cuda.empty_cache()

    # the decode kernels: huff_scan (K4, the count phase) and huff_write (the
    # write phase, which does what K5's compaction did)
    def coded_stream(freq, syms, lo=1, rad=64):
        """The Huffman stream of the symbols `syms` under the reference tree
        of the counts `freq` (freq[s] = count of symbol lo + s; the stream
        need not follow them), packed by K2+K3: (bits, codes, lens, offset,
        the symbols)."""
        freq = np.asarray(list(freq) + [0], dtype=np.uint64)
        codes, lens, _tree = build_table(lo, freq)
        tc = np.zeros(ed.table_len(rad), np.int64)
        tl = np.zeros(ed.table_len(rad), np.int32)
        at = np.arange(lo, lo + freq.size) + 1
        tc[at] = codes.view(np.int64)
        tl[at] = lens
        syms = syms.astype(np.int32)
        nbits = int(tl[syms + 1].sum())
        words = ed.pack_bits(torch.from_numpy(syms).to(dev), torch.from_numpy(tc).to(dev),
                             torch.from_numpy(tl).to(dev), rad, nbits)
        return host_bytes(de._big_endian(words, nbits)), codes, lens, lo, syms

    def first_pass_args(nwin):
        idx = torch.arange(nwin, dtype=torch.int32, device=dev)
        starts = torch.zeros(nwin, dtype=torch.int32, device=dev)
        starts[0] = dec.RUN_BITS
        return idx, starts

    def validate(state, wstart):
        bad, want = dec.bad_windows(state, wstart)
        return bad, want, int(bad.sum())

    def scan_to_end(stream_t, total_bits, tables, scan=None):
        """decode_stream's pass loop, pass by pass: (validated state, windows
        per pass, seconds in the scans, seconds in the validations)."""
        scan = scan or dec.scan_windows
        nwin = -(-total_bits // dec.W_BITS)
        state = dec.ScanState(*(t.zero_() for t in dec.new_scan_state(nwin, dev)))
        idx, starts = first_pass_args(nwin)
        wstart = idx.to(torch.int64) * dec.W_BITS
        redo, scan_s, check_s = [], 0.0, 0.0
        while True:
            _, t_s = sync_time(lambda: scan(stream_t, total_bits, tables, idx, starts, state,
                                            chain=bool(redo)))
            scan_s += t_s
            redo.append(idx.numel())
            (bad, want, nbad), t_s = sync_time(lambda: validate(state, wstart))
            check_s += t_s
            if nbad == 0:
                return state, redo, scan_s, check_s
            check(len(redo) <= nwin, "the scan passes do not end")
            idx, starts = dec.rescan_args(bad, want, wstart)

    conf256, payload256 = szp.open_archive(native[256][0])
    torch_backend._resolve_anchor_stride(conf256)
    bits256, count256, off256, codes256, lens256, const256, _ = runtime.open_packed(
        conf256, payload256, np.float32)
    check(const256 < 0 and count256 == num, "the 256^3 archive's stream is not a Huffman stream")
    fib64 = [1, 1]
    while len(fib64) < 64:
        fib64.append(fib64[-1] + fib64[-2])
    # the whole 256^3 stream for the first pass and the decode; its first
    # 4096 windows for the chained rescan too (the plain version steps the
    # k-th windows of all walks together, and a rough stretch of the field
    # makes a walk hundreds of windows long)
    dec_cases = {
        "256^3 stream": (bits256, codes256, lens256, off256,
                         runtime.interp_open(conf256, payload256, np.float32)[0]),
        "256^3 stream, first 4096 windows": (bits256[:4096 * dec.W_BITS // 8], codes256,
                                             lens256, off256, None),
        "synthetic, codes up to 63 bits": coded_stream(fib64, rng.integers(0, 64, 400_000) + 1),
        "synthetic, shortest code 1 bit": coded_stream(
            [2 ** k for k in range(20, 0, -1)], np.minimum(rng.geometric(0.5, 3_000_000), 20)),
        "synthetic, under 64 windows": coded_stream(
            [1000, 600, 350, 200, 120, 70, 40, 20, 10, 5, 2, 1], rng.integers(0, 12, 900) + 1),
        # 32 codes of 5 bits: a walk that starts off the symbol lattice never
        # synchronises, so every window after the second is bad and the
        # chained rescan is one sequential walk (kept short: the plain
        # version takes one round of launches per window of a walk)
        "synthetic, never synchronises": coded_stream([5] * 32,
                                                      rng.integers(0, 32, 20_000) + 1),
    }
    def runs_of(nout):
        n64 = nout.to(torch.int64)
        return torch.cumsum(n64, 0) - n64, int(n64.sum())

    def hold_decode(name, bits, codes, lens, lo, chained):
        """The count phase (a first pass over the stream `bits`, and with
        `chained` a chained rescan of its bad windows) and the write phase
        (on the runs of both) against their plain versions, bit for bit:
        (max abs diff of the count phase, of the write phase)."""
        total = len(bits) * 8
        tabs = dec.build_decode_tables(codes, lens, lo, dev)
        stream_t = dec.upload_bytes(bits, dev, dec.PAD_BYTES)
        nwin = -(-total // dec.W_BITS)
        wstart = torch.arange(nwin, device=dev) * dec.W_BITS
        states = []
        for scan in (dec.scan_windows, dec.scan_windows_plain):
            st = dec.ScanState(*(t.zero_() for t in dec.new_scan_state(nwin, dev)))
            scan(stream_t, total, tabs, *first_pass_args(nwin), st)
            first = dec.ScanState(*(t.clone() for t in st))
            bad, want = dec.bad_windows(st, wstart)
            if chained:
                scan(stream_t, total, tabs, *dec.rescan_args(bad, want, wstart), st, chain=True)
            states.append((first, st, int(bad.sum()), int(dec.bad_windows(st, wstart)[0].sum())))
        torch.cuda.synchronize()
        err = max(max_abs_diff(a, b) for a, b in zip((*states[0][0], *states[0][1]),
                                                     (*states[1][0], *states[1][1])))
        check(err == 0, f"K4 {name}: differs from its plain version (max abs diff {err})")
        scan_err, write_err = err, 0
        # the write phase on the runs of the first pass (mis-speculated
        # windows and all: the function is defined by its arguments) and on
        # those the rescan leaves
        for st in states[0][:2]:
            off, n_all = runs_of(st.nout)
            wk = dec.write_windows(stream_t, total, tabs, st.entry, st.nout, off, n_all)
            wp = dec.write_windows_plain(stream_t, total, tabs, st.entry, st.nout, off, n_all)
            torch.cuda.synchronize()
            err = max_abs_diff(wk, wp)
            check(err == 0 and torch.equal(wk, wp),
                  f"huff_write {name}: differs from its plain version (max abs diff {err})")
            write_err = max(write_err, err)
        what = (f"a first pass and a chained rescan of its {states[0][2]} bad windows, which "
                f"leaves {states[0][3]}" if chained
                else f"a first pass, which leaves {states[0][2]} bad windows")
        print(f"K4 huff_scan, huff_write {name}: bit-equal to plain over {what}, and the "
              f"write phase on both sets of runs ({nwin} windows, codes of "
              f"{int(lens[lens > 0].min())}-{int(lens.max())} bits, {tabs.sub_len.numel()} second-table "
              f"entries)", flush=True)
        return scan_err, write_err

    k4_err = kw_err = 0
    for name, (bits, codes, lens, lo, want_syms) in dec_cases.items():
        errs = hold_decode(name, bits, codes, lens, lo, chained=name != "256^3 stream")
        k4_err, kw_err = max(k4_err, errs[0]), max(kw_err, errs[1])
        if want_syms is not None:
            stats = {}
            dense = dec.decode_stream(bits, len(want_syms), codes, lens, lo, dev, stats)
            check(np.array_equal(dense.cpu().numpy(), want_syms),
                  f"decode_stream {name}: not the stream's symbols")
            print(f"  decode_stream == the {len(want_syms)} symbols in {stats['passes']} passes "
                  f"over {stats['redo_counts']} windows", flush=True)
            del dense
        stamp(f"decode kernels, {name}")
    check(int(dec_cases["synthetic, codes up to 63 bits"][2].max()) == 63, "no 63-bit code")
    # symbols are whole int32 values, not fields of a table entry
    bits, codes, lens, lo, want_syms = dec_cases["synthetic, under 64 windows"]
    far = (1 << 24) - 3
    dense = dec.decode_stream(bits, len(want_syms), codes, lens, far, dev)
    check(np.array_equal(dense.cpu().numpy(), want_syms - lo + far),
          "huff_write, symbols from 2^24 on: not the stream's symbols")
    print("huff_write, symbols from 2^24 on: decode_stream == the symbols", flush=True)

    stamp("encode kernels and decode cases done")
    total256 = len(bits256) * 8
    tabs = dec.build_decode_tables(codes256, lens256, off256, dev)
    stream_t = dec.upload_bytes(bits256, dev, dec.PAD_BYTES)
    nwin256 = -(-total256 // dec.W_BITS)
    idx_all, starts_all = first_pass_args(nwin256)
    st = dec.ScanState(*(t.zero_() for t in dec.new_scan_state(nwin256, dev)))
    k4_ms, k4_plain_ms, k4_runs = paired_ms(
        lambda: dec.scan_windows(stream_t, total256, tabs, idx_all, starts_all, st),
        lambda: dec.scan_windows_plain(stream_t, total256, tabs, idx_all, starts_all, st),
        plain_reps=PLAIN_SCAN_REPS)
    decoded = int((st.nskip.to(torch.int64) + st.nout).sum())

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    # count phase: the stream, the length tables, idx and starts read; four
    # int32 per window written. Operations: a step of huff_scan.cu's
    # count_until is 18 integer instructions (the index shift, the table
    # load, two for the short-code test, four for the group's fields and its
    # test, two selects, two adds, four in the reader's skip, the loop test)
    # and takes 1.7 symbols at this stream's 5.5 bits a symbol: 11 a symbol
    k4_bound = bound(len(bits256) + nbytes(tabs.root, tabs.sub_len, tabs.deep_key, tabs.deep_len)
                     + 8 * nwin256 + 16 * nwin256, 11 * decoded)
    st, redo256, _, _ = scan_to_end(stream_t, total256, tabs)
    nout, off = dec.owned_runs(st, count256)
    kw_ms, kw_plain_ms, kw_runs = paired_ms(
        lambda: dec.write_windows(stream_t, total256, tabs, st.entry, nout, off, count256),
        lambda: dec.write_windows_plain(stream_t, total256, tabs, st.entry, nout, off, count256),
        plain_reps=PLAIN_SCAN_REPS)
    # write phase: the stream, the tables, entry, nout (int32) and off (int64)
    # read; one int32 per symbol written
    kw_bound = bound(len(bits256) + nbytes(tabs.root, tabs.l1_sym, tabs.sub_len, tabs.sub_sym,
                                           tabs.deep_key, tabs.deep_sym, tabs.deep_len)
                     + 16 * nwin256 + 4 * count256, 24 * count256)

    # the same two launches with the L2 cache flushed before each: the
    # 11.6 MB stream fits the 50 MB L2, and back-to-back launches find it there
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def cold_ms(fn, reps=10):
        ms = 0.0
        for _ in range(reps):
            torch.cuda._sleep(SPIN_CYCLES // 10)        # the host gets ahead of the card
            flush.fill_(1)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            ms += start.elapsed_time(stop)
        return ms / reps

    st_cold = dec.ScanState(*(t.clone() for t in st))
    k4_cold_ms = cold_ms(lambda: dec.scan_windows(stream_t, total256, tabs, idx_all, starts_all,
                                                  st_cold))
    kw_cold_ms = cold_ms(lambda: dec.write_windows(stream_t, total256, tabs, st.entry, nout, off,
                                                   count256))
    del flush, st_cold

    def decode_launches_ms():
        """Every decode kernel launch of one decode_stream of the 256^3
        stream: each count pass with the arguments and the scan state it had,
        timed alone (the state is copied back before each launch, and the
        time of the copies alone is taken off), then the write phase:
        (summed ms, ms per launch)."""
        state = dec.new_scan_state(nwin256, dev)
        idx, starts = idx_all, starts_all
        wstart = idx_all.to(torch.int64) * dec.W_BITS
        passes = []
        while True:
            passes.append((idx, starts, bool(passes), [t.clone() for t in state]))
            dec.scan_windows(stream_t, total256, tabs, idx, starts, state, chain=passes[-1][2])
            bad, want = dec.bad_windows(state, wstart)
            if int(bad.sum()) == 0:
                break
            idx, starts = dec.rescan_args(bad, want, wstart)
        per = []
        for p_idx, p_starts, chain, before in passes:
            def restore():
                for t, b in zip(state, before):
                    t.copy_(b)

            def one_pass():
                restore()
                dec.scan_windows(stream_t, total256, tabs, p_idx, p_starts, state, chain=chain)

            per.append(max(0.0, event_ms(one_pass) - event_ms(restore)))
        per.append(kw_ms)
        return sum(per), per

    family_ms, family_per = decode_launches_ms()
    print(f"K4 huff_scan, first pass over the 256^3 stream ({nwin256} windows, {decoded} "
          f"symbols counted, runway {dec.RUN_BITS} bits): kernel {k4_ms:.3f} ms ({k4_cold_ms:.3f} "
          f"ms with the L2 flushed before each launch), plain {k4_plain_ms:.3f} ms "
          f"({PLAIN_SCAN_REPS} repetition of the plain version per reading; "
          f"plain,kernel,kernel,plain = {[round(v, 3) for v in k4_runs]}), bound "
          f"{k4_bound[0]:.4f} ms by {k4_bound[1]}; no PyTorch call decodes a Huffman stream",
          flush=True)
    print(f"huff_write at 256^3 ({count256} symbols from {nwin256} proven windows): kernel "
          f"{kw_ms:.3f} ms ({kw_cold_ms:.3f} ms with the L2 flushed before each launch), plain "
          f"{kw_plain_ms:.3f} ms (plain,kernel,kernel,plain = "
          f"{[round(v, 3) for v in kw_runs]}), bound {kw_bound[0]:.4f} ms by {kw_bound[1]}; no "
          f"PyTorch call computes it (torch.masked_select compacted the symbol rows, which are "
          f"gone)", flush=True)
    print(f"every decode kernel launch of one 256^3 decode_stream, each timed alone: "
          f"{family_ms:.3f} ms = {[round(v, 3) for v in family_per]} (count passes over "
          f"{redo256} windows, then the write phase)", flush=True)
    print(f"bounds of the encode kernels at 256^3: K1 {k1_bound[0]:.4f} ms by {k1_bound[1]}, "
          f"K2+K3 {k2_bound[0]:.4f} ms by {k2_bound[1]}; K2+K3 has no PyTorch call of its own",
          flush=True)
    del st, nout, off, stream_t, tabs, idx_all, starts_all, dec_cases
    torch.cuda.empty_cache()

    # the element sweep of LORENZO_REG (lorenzo_sweep.cu) in both forms: on
    # the 256^3 field's own inputs, captured from one encode and one decode,
    # and on a synthetic grid that is not a multiple of 6 per axis
    native_lr = {256: sync_time(lambda: native_compress(fields[256], lr_conf()))}
    with captured(wfe, "sweep_encode") as enc_in:
        szp.compress(fields[256], lr_conf(), device="cuda")
    with captured(wf, "sweep_decode") as dec_in:
        szp.decompress(native_lr[256][0], device="cuda")
    rec_e, types_e, orig_e, eb_e, rad_e = enc_in["args"]
    rec_d, types_d, bins_d, lits_d, eb_d, rad_d = dec_in["args"]
    syn_shape = (253, 255, 257)
    srng = np.random.default_rng(5)
    s_types = srng.integers(0, 3, syn_shape).astype(np.uint8)
    s_bins = srng.integers(1, 2 * radius, syn_shape).astype(np.int32)
    s_bins[srng.random(syn_shape) < 0.05] = 0
    s_vals = (np.cumsum(srng.standard_normal(syn_shape), axis=2) * 0.01).astype(np.float32)
    sflat = s_vals.reshape(-1)
    sflat[::97] = np.nan
    sflat[5::131] = np.inf
    sflat[7::137] = -np.inf
    sflat[11::139] = np.float32(3e-39)
    s_geo = bl.Geometry(syn_shape, syn_shape, syn_shape)
    s_rec = wf.padded_grid(s_geo, torch.from_numpy(
        np.where(s_types == bl.T_KEEP, s_vals + 0.5, 0).astype(np.float32)).to(dev))
    s_types, s_bins, s_vals = (torch.from_numpy(a).to(dev) for a in (s_types, s_bins, s_vals))

    def bits_diff(a, b) -> int:
        return max_abs_diff(a.view(torch.int32), b.view(torch.int32))

    sweep_cases = {
        "256^3 encode": ("encode", rec_e, types_e, orig_e, None, eb_e, rad_e),
        "256^3 decode": ("decode", rec_d, types_d, lits_d, bins_d, eb_d, rad_d),
        "253x255x257 synthetic, encode": ("encode", s_rec, s_types, s_vals, None, EB, radius),
        "253x255x257 synthetic, decode": ("decode", s_rec, s_types, s_vals, s_bins, EB, radius),
    }
    sweep_err = 0
    for name, (form, rec0, types_t, vals, bins_t, eb_s, rad_s) in sweep_cases.items():
        rk, rp = rec0.clone(), rec0.clone()
        if form == "encode":
            bk = wfe.sweep_encode(rk, types_t, vals, eb_s, rad_s)
            bp = wfe.sweep_encode_plain(rp, types_t, vals, eb_s, rad_s)
            torch.cuda.synchronize()
            err = max(bits_diff(rk, rp), max_abs_diff(bk, bp))
        else:
            wf.sweep_decode(rk, types_t, bins_t, vals, eb_s, rad_s)
            wf.sweep_decode_plain(rp, types_t, bins_t, vals, eb_s, rad_s)
            torch.cuda.synchronize()
            err = bits_diff(rk, rp)
        check(err == 0, f"lorenzo_sweep {name}: differs from its plain version (max abs diff "
                        f"{err})")
        sweep_err = max(sweep_err, err)
        kinds = [int((types_t == k).sum()) for k in (bl.T_L1, bl.T_L2, bl.T_KEEP)]
        print(f"lorenzo_sweep {name}: bit-equal to plain ({tuple(types_t.shape)} grid, "
              f"L1/L2/KEEP cells {kinds})", flush=True)
        del rk, rp
    check(bool((s_types == bl.T_L2).any()), "no L2 cell in the synthetic sweep")

    # times at 256^3, order plain, kernel, kernel, plain; the sweep runs in
    # place, so each form works on a scratch copy of its inputs
    scratch = rec_d.clone()
    swd_ms, swd_plain_ms, swd_runs = paired_ms(
        lambda: wf.sweep_decode(scratch, types_d, bins_d, lits_d, eb_d, rad_d),
        lambda: wf.sweep_decode_plain(scratch, types_d, bins_d, lits_d, eb_d, rad_d),
        plain_reps=1)
    scratch = rec_e.clone()
    swe_ms, swe_plain_ms, swe_runs = paired_ms(
        lambda: wfe.sweep_encode(scratch, types_e, orig_e, eb_e, rad_e),
        lambda: wfe.sweep_encode_plain(scratch, types_e, orig_e, eb_e, rad_e), plain_reps=1)
    del scratch
    # one empty dependent launch: the floor of each of the sweep's launches
    empty_ms = event_ms(lambda: torch.cuda._sleep(0), reps=1000)
    gx, gy, gz = types_d.shape
    planes = gx + gy + gz - 2
    n1 = [int((t == bl.T_L1).sum()) for t in (types_d, types_e)]
    n2 = [int((t == bl.T_L2).sum()) for t in (types_d, types_e)]

    def sweep_bytes(types_t, bins_t=None):
        """The bytes the sweep must move on these inputs (bins_t given: the
        decode). Every cell's type (1 byte); the reconstruction read where a
        Lorenzo cell's stencil reaches a cell the sweep does not write (the
        pad, KEEP cells) and written at the Lorenzo cells; the decode reads
        the Lorenzo cells' bins and the literals of those whose bin is 0, the
        encode reads the Lorenzo cells' originals and writes every cell's
        bin (4 bytes each)."""
        sx, sy, sz = types_t.shape
        pd = bl.PAD
        l2 = types_t == bl.T_L2
        lor = l2 | (types_t == bl.T_L1)
        reach = torch.zeros((sx + pd, sy + pd, sz + pd), dtype=torch.bool, device=dev)
        for a, b, c in itertools.product(range(3), repeat=3):
            if a + b + c:
                reach[pd - a:pd - a + sx, pd - b:pd - b + sy, pd - c:pd - c + sz] |= (
                    lor if max(a, b, c) == 1 else l2)
        reach[pd:, pd:, pd:] &= ~lor
        nlor = int(lor.sum())
        fixed = types_t.numel() + 4 * int(reach.sum()) + 8 * nlor
        if bins_t is None:
            return fixed + 4 * types_t.numel()
        return fixed + 4 * int((lor & (bins_t == 0)).sum())

    # operations: a first-order cell 7 stencil adds, a second-order one 51
    # (26 terms, 25 of them scaled); recover 5 more, quantize 16 more
    swd_bytes, swe_bytes = sweep_bytes(types_d, bins_d), sweep_bytes(types_e)
    swd_bound = bound(swd_bytes, 12 * n1[0] + 56 * n2[0])
    swe_bound = bound(swe_bytes, 23 * n1[1] + 67 * n2[1])
    sw_dep_ms = planes * empty_ms
    print(f"lorenzo_sweep at 256^3 (grid {gx}x{gy}x{gz}, {planes} planes, one launch each; "
          f"L1 cells decode/encode {n1}, L2 {n2}): decode kernel {swd_ms:.4f} ms, plain "
          f"{swd_plain_ms:.2f} ms (plain,kernel,kernel,plain = {[round(v, 4) for v in swd_runs]}); "
          f"encode kernel {swe_ms:.4f} ms, plain {swe_plain_ms:.2f} ms ("
          f"{[round(v, 4) for v in swe_runs]}); bound by bytes or operations: decode "
          f"{swd_bound[0]:.5f} ms by {swd_bound[1]} ({swd_bytes} bytes), encode "
          f"{swe_bound[0]:.5f} ms by {swe_bound[1]} ({swe_bytes} bytes); dependency bound {planes} x {empty_ms * 1e3:.3f} us (one empty "
          f"dependent launch, this card) = {sw_dep_ms:.4f} ms; no PyTorch call computes it",
          flush=True)
    del enc_in, dec_in, rec_e, types_e, orig_e, rec_d, types_d, bins_d, lits_d, sweep_cases
    del s_rec, s_types, s_bins, s_vals
    torch.cuda.empty_cache()

    # the same at 512^3, the size users store: both forms held bit for bit to
    # their plain versions on the inputs of one encode and one decode on the
    # card (the 516^3 rounded grid; the layout's 32-bit row math and its
    # conversions depend on the grid's size), then timed (phase 5 holds the
    # 512^3 LORENZO_REG archive sha256-equal to the engine's)
    if 512 not in fields:
        t = time.perf_counter()
        fields[512] = nyx_like(512)
        print(f"nyx_like(512): {time.perf_counter() - t:.2f} s", flush=True)
        native[512] = sync_time(lambda: native_compress(fields[512], szp.Config(absErrorBound=EB)))
    with captured(wfe, "sweep_encode") as enc_in, first_calls(wfe, "select", 2) as sel_in:
        lr_blob512 = szp.compress(fields[512], lr_conf(), device="cuda")
    with captured(wf, "sweep_decode") as dec_in:
        szp.decompress(lr_blob512, device="cuda")
    del lr_blob512
    rec_e, types_e, orig_e, eb_e, rad_e = enc_in["args"]
    rec_d, types_d, bins_d, lits_d, eb_d, rad_d = dec_in["args"]
    for form in ("encode", "decode"):
        if form == "encode":
            rk, rp = rec_e.clone(), rec_e.clone()
            bk = wfe.sweep_encode(rk, types_e, orig_e, eb_e, rad_e)
            bp = wfe.sweep_encode_plain(rp, types_e, orig_e, eb_e, rad_e)
            torch.cuda.synchronize()
            err = max(bits_diff(rk, rp), max_abs_diff(bk, bp))
            del bk, bp
        else:
            rk, rp = rec_d.clone(), rec_d.clone()
            wf.sweep_decode(rk, types_d, bins_d, lits_d, eb_d, rad_d)
            wf.sweep_decode_plain(rp, types_d, bins_d, lits_d, eb_d, rad_d)
            torch.cuda.synchronize()
            err = bits_diff(rk, rp)
        check(err == 0, f"lorenzo_sweep 512^3 {form}: differs from its plain version (max abs "
                        f"diff {err})")
        sweep_err = max(sweep_err, err)
        print(f"lorenzo_sweep 512^3 {form}: bit-equal to plain ({tuple(types_d.shape)} grid)",
              flush=True)
        del rk, rp
    scratch = rec_d.clone()
    swd5_ms = event_ms(lambda: wf.sweep_decode(scratch, types_d, bins_d, lits_d, eb_d, rad_d))
    scratch = rec_e.clone()
    swe5_ms = event_ms(lambda: wfe.sweep_encode(scratch, types_e, orig_e, eb_e, rad_e))
    del scratch
    gx, gy, gz = types_d.shape
    planes5 = gx + gy + gz - 2
    n1 = [int((t == bl.T_L1).sum()) for t in (types_d, types_e)]
    n2 = [int((t == bl.T_L2).sum()) for t in (types_d, types_e)]
    swd5_bytes, swe5_bytes = sweep_bytes(types_d, bins_d), sweep_bytes(types_e)
    swd5_bound = bound(swd5_bytes, 12 * n1[0] + 56 * n2[0])
    swe5_bound = bound(swe5_bytes, 23 * n1[1] + 67 * n2[1])
    sw5_dep_ms = planes5 * empty_ms
    print(f"lorenzo_sweep at 512^3 (grid {gx}x{gy}x{gz}, {planes5} planes, one launch each and "
          f"the layout's conversions; L1 cells decode/encode {n1}, L2 {n2}): decode kernel "
          f"{swd5_ms:.4f} ms, encode kernel {swe5_ms:.4f} ms; bound by "
          f"bytes or operations: decode {swd5_bound[0]:.5f} ms by {swd5_bound[1]} ({swd5_bytes} "
          f"bytes), encode {swe5_bound[0]:.5f} ms by {swe5_bound[1]} ({swe5_bytes} bytes); "
          f"dependency bound {planes5} x {empty_ms * 1e3:.3f} us = {sw5_dep_ms:.4f} ms", flush=True)
    del enc_in, dec_in, rec_e, types_e, orig_e, rec_d, types_d, bins_d, lits_d
    torch.cuda.empty_cache()

    # LORENZO_REG's predictor selection (lorenzo_select.cu) on the 512^3
    # field's own inputs: the speculative call (one grid as both arguments)
    # and the first certifying call (the originals and the reconstruction)
    def select_bytes(geo, ex, same):
        """The bytes a selection must move: each cell of either grid that a
        taken sample reads, once (the speculative call's grids are one), the
        fits read and the two bytes a block written."""
        m = ex.min(dim=0).values
        inside = torch.zeros(geo.padded, dtype=torch.bool, device=dev)
        pad = inside if same else torch.zeros_like(inside)
        nb = geo.nb
        for i in range(bl.BS):
            for j in range(bl.BS - i):
                taken = (m - 1 - i == j) & (i < m)
                for px, py, pz in ((i, i, i), (i, i, j), (i, j, i), (i, j, j)):
                    for d in range(8):
                        a, b, c = px - (d >> 2), py - ((d >> 1) & 1), pz - (d & 1)
                        g = inside if min(a, b, c) >= 0 else pad
                        g[bl.PAD + a:bl.PAD + a + bl.BS * (nb[0] - 1) + 1:bl.BS,
                          bl.PAD + b:bl.PAD + b + bl.BS * (nb[1] - 1) + 1:bl.BS,
                          bl.PAD + c:bl.PAD + c + bl.BS * (nb[2] - 1) + 1:bl.BS] |= taken
        cells = int(inside.sum()) + (0 if same else int(pad.sum()))
        return 4 * cells + 18 * geo.nblk

    sel_err, sel_rows = 0, {}
    for name, (geo_s, orig_s, tap_s, ex_s, coefs_s, eb_s) in zip(
            ("speculative", "first certifying"), sel_in["calls"]):
        same = tap_s is orig_s
        check(same == (name == "speculative"), f"lorenzo_select 512^3 {name}: the taps are "
                                               f"{'' if same else 'not '}the originals")
        before = wfe.select.launches
        kern = wfe.select(geo_s, orig_s, tap_s, ex_s, coefs_s, eb_s)
        check(wfe.select.launches == before + 1, f"lorenzo_select 512^3 {name}: "
                                                 f"{wfe.select.launches - before} launches")
        plain = wfe.select_plain(geo_s, orig_s, tap_s, ex_s, coefs_s, eb_s)
        torch.cuda.synchronize()
        err = max(max_abs_diff(kern[0], plain[0]), max_abs_diff(kern[1], plain[1]))
        check(err == 0 and all(torch.equal(k, p) for k, p in zip(kern, plain)),
              f"lorenzo_select 512^3 {name}: differs from select_plain (max abs diff {err})")
        sel_err = max(sel_err, err)
        ms, plain_ms, runs = paired_ms(
            lambda: wfe.select(geo_s, orig_s, tap_s, ex_s, coefs_s, eb_s),
            lambda: wfe.select_plain(geo_s, orig_s, tap_s, ex_s, coefs_s, eb_s))
        nbytes_s = select_bytes(geo_s, ex_s, same)
        # 21 float operations a sample (the stencil's 6, two errors' 5 and
        # the plane's 6, two widenings and two float64 sums), 24 samples a block
        bnd = bound(nbytes_s, 21 * 24 * geo_s.nblk)
        sel_rows[name] = (ms, plain_ms, bnd)
        print(f"lorenzo_select 512^3 {name}: bit-equal to select_plain ({geo_s.nblk} blocks, "
              f"regression picked by {int(kern[0].sum())}, no selection for "
              f"{int((~kern[1]).sum())}); kernel {ms:.4f} ms, plain {plain_ms:.3f} ms "
              f"(plain,kernel,kernel,plain = {[round(v, 4) for v in runs]}); bound "
              f"{bnd[0]:.5f} ms by {bnd[1]} ({nbytes_s} bytes), the kernel at "
              f"{ms / bnd[0]:.2f} x", flush=True)
        del kern, plain
    del sel_in, geo_s, orig_s, tap_s, ex_s, coefs_s
    torch.cuda.empty_cache()

    # the BIOMD frame recurrence (biomd_frames.cu) in both forms against its
    # plain versions, bit for bit: 64 frames x 9,999 atoms x 3 (not a multiple
    # of 4: the last molecule of site 4 has 3 atoms) with NaN, Inf, subnormal
    # and huge values, frame 0 reconstructed by the host engine; the recover
    # form on the encode's bins and on bins across the quantizer's range.
    # Times at the main path's shape are taken in phase 6.
    frames_err = 0
    for site in (3, 4):
        traj = md_traj(64, 9_999, seed=site, site_atoms=site)
        live = traj[1:].reshape(-1)
        live[::97] = np.nan
        live[5::131] = np.inf
        live[7::137] = -np.inf
        live[11::139] = np.float32(3e-39)
        live[13::149] = np.float32(2.0 ** 40)
        _, recon0, _ = runtime.biomd_frame0(EB, radius, site, traj[0])
        xt = torch.from_numpy(np.ascontiguousarray(traj[1:])).to(dev)
        r0 = torch.from_numpy(recon0).to(dev)
        bk = bd.frames_encode(xt, r0, EB, radius, site)
        bp = bd.frames_encode_plain(xt, r0, EB, radius, site)
        torch.cuda.synchronize()
        err = max_abs_diff(bk, bp)
        rand_bins = torch.from_numpy(np.where(
            np.random.default_rng(site).random(xt.shape) < 0.05, 0,
            np.random.default_rng(site).integers(1, 2 * radius, xt.shape)).astype(np.int32)).to(dev)
        for b in (bk, rand_bins):
            lits = torch.where(b == 0, xt, 0.0)
            rk = bd.frames_recover(b, lits, r0, EB, radius, site)
            rp = bd.frames_recover_plain(b, lits, r0, EB, radius, site)
            torch.cuda.synchronize()
            err = max(err, max_abs_diff(rk.view(torch.int32), rp.view(torch.int32)))
        check(err == 0, f"biomd_frames site {site}: differs from its plain version (max abs "
                        f"diff {err})")
        frames_err = max(frames_err, err)
        print(f"biomd_frames site {site} ({tuple(xt.shape)} frames after frame 0): both forms "
              f"bit-equal to plain (literals {int((bk == 0).sum())} of {bk.numel()})", flush=True)
        del xt, r0, bk, bp, rand_bins, lits, rk, rp, traj, live
    torch.cuda.empty_cache()

    # the MDZ frame recurrence (mdz_frames.cu) in both forms against its
    # plain versions, bit for bit: 64 frames x 9,999 atoms with NaN, Inf,
    # subnormal and huge values, at ABS 1e-3 and at an infinite bound (a REL
    # bound over an infinite range), MDZ's default radius; the recover form
    # on the encode's bins and on bins across the quantizer's range. Times
    # at the main path's shape are taken in phase 7.
    mdz_err = 0
    mdz_rad = 512
    for feb in (EB, float("inf")):
        rng_m = np.random.default_rng(11)
        xs = (rng_m.uniform(-5, 5, 9_999)[None]
              + np.cumsum(rng_m.normal(0, 0.01, (64, 9_999)), axis=0)).astype(np.float32)
        live = xs[1:].reshape(-1)
        live[::97] = np.nan
        live[5::131] = np.inf
        live[7::137] = -np.inf
        live[11::139] = np.float32(3e-39)
        live[13::149] = np.float32(2.0 ** 40)
        xt = torch.from_numpy(np.ascontiguousarray(xs[1:])).to(dev)
        r0 = torch.from_numpy(xs[0] + np.float32(1e-4)).to(dev)
        bk = md.frames_encode(xt, r0, feb, mdz_rad)
        bp = md.frames_encode_plain(xt, r0, feb, mdz_rad)
        torch.cuda.synchronize()
        err = max_abs_diff(bk, bp)
        rand_bins = torch.from_numpy(np.where(
            rng_m.random(bk.shape) < 0.05, 0,
            rng_m.integers(1, 2 * mdz_rad, bk.shape)).astype(np.int32)).to(dev)
        for b in (bk, rand_bins):
            lits = xt.t().reshape(-1)[(b.reshape(-1) == 0).nonzero().reshape(-1)]
            starts = md.literal_starts(b, lits.numel())
            rk = md.frames_recover(b, lits, starts, r0, feb, mdz_rad)
            rp = md.frames_recover_plain(b, lits, starts, r0, feb, mdz_rad)
            torch.cuda.synchronize()
            err = max(err, max_abs_diff(rk.view(torch.int32), rp.view(torch.int32)))
        check(err == 0, f"mdz_frames at eb {feb}: differs from its plain version (max abs diff "
                        f"{err})")
        mdz_err = max(mdz_err, err)
        print(f"mdz_frames at eb {feb} ({tuple(xt.shape)} frames after frame 0): both forms "
              f"bit-equal to plain (literals {int((bk == 0).sum())} of {bk.numel()})", flush=True)
        del xt, r0, bk, bp, rand_bins, lits, starts, rk, rp, xs, live
    torch.cuda.empty_cache()

    stamp("phase 2 done")

    # ---- phase 3: inputs the JAX package hands to the host ----------------------
    edge_rng = np.random.default_rng(11)
    slab = (np.cumsum(edge_rng.standard_normal((64, 64, 64)), axis=2) * 0.01).astype(np.float32)
    slab[:6] += edge_rng.standard_normal((6, 64, 64)).astype(np.float32) * 0.2
    # name -> (field, Config, what its entropy stage must be)
    edges = {
        "no anchor grid (20^3)": (
            (np.cumsum(edge_rng.standard_normal((20, 20, 20)), axis=2) * 0.1).astype(np.float32),
            szp.Config(cmprAlgo=szp.ALGO.INTERP, absErrorBound=EB), "huffman"),
        "noise, stored lossless (64^3, ABS 1e-5)": (
            edge_rng.standard_normal((64, 64, 64)).astype(np.float32) * 0.2,
            szp.Config(cmprAlgo=szp.ALGO.INTERP, absErrorBound=1e-5), "lossless"),
        "bins far from radius (64^3 with a noisy slab, ABS 1e-5)": (
            slab, szp.Config(cmprAlgo=szp.ALGO.INTERP, absErrorBound=1e-5), "huffman, wide"),
        "constant stream (30^3 zeros)": (
            np.zeros((30, 30, 30), np.float32),
            szp.Config(cmprAlgo=szp.ALGO.INTERP, absErrorBound=EB), "constant"),
        "f64 (40x41x42)": (
            np.cumsum(edge_rng.standard_normal((40, 41, 42)), axis=2) * 0.1,
            szp.Config(cmprAlgo=szp.ALGO.INTERP, absErrorBound=EB), "huffman"),
    }
    for name, (data, c, expect) in edges.items():
        blob_native = native_compress(data, c)
        blob = szp.compress(data, c, device="cuda")
        check(hashlib.sha256(blob).hexdigest() == hashlib.sha256(blob_native).hexdigest(),
              f"{name}: archive sha256 differs from the host engine's")
        out, dconf = szp.decompress(blob, device="cuda")
        check(out.cpu().numpy().tobytes() == native_decompress(blob_native).tobytes(),
              f"{name}: decode not bit-equal to the host engine's")
        stats = {}
        if dconf.cmprAlgo == szp.ALGO.INTERP:      # how the entropy decode went
            dconf, dpayload = szp.open_archive(blob)
            torch_backend._resolve_anchor_stride(dconf)
            dd.decode_payload_device(dconf, dpayload, data.dtype, dev, stats)
        ec = c.copy()
        ec.set_dims(data.shape)
        torch_backend._resolve_anchor_stride(ec)
        h, _ = ed.hist_and_literals(stream_of(torch.from_numpy(data).to(dev), ec),
                                    ec.quantbinCnt // 2)
        outside = outside_k1_window(h, ec.quantbinCnt // 2)
        how = (f"{stats['nwin']} windows, {stats['passes']} scan passes" if stats
               else "a constant stream: a fill" if dconf.cmprAlgo == szp.ALGO.INTERP
               else f"stored as {dconf.cmprAlgo.name}")
        check(how.startswith({"huffman": str(stats.get("nwin")), "constant": "a constant",
                              "lossless": "stored as LOSSLESS"}[expect.split(",")[0]]),
              f"{name}: expected a {expect} entropy stage, got {how}")
        check(("wide" in expect) <= (outside > 0), f"{name}: no symbol outside the window")
        print(f"edge {name}: archive sha256 == host engine, decode on the card bit-equal "
              f"({how}; anchor stride {de.plan_for(ec).anchor_stride}, {outside} symbols "
              f"outside the shared window)", flush=True)

    stamp("edge archives done")
    # an archive whose Huffman codes exceed 32 bits: Fibonacci counts over the
    # bins of a 1-D field, packed and sealed by the port's own encode pieces.
    # The anchor points are literals (bin 0), as the format wants; a wide
    # anchor stride leaves two of them, and bin 0 takes the Fibonacci term 2
    deep_counts = fib[:2] + fib[3:34]
    deep_n = 2 + sum(deep_counts)
    dconf = szp.Config(cmprAlgo=szp.ALGO.INTERP, absErrorBound=EB)
    dconf.set_dims((deep_n,))
    dconf.interpAnchorStride = 1 << 23
    at_anchor = de.perm_for(dconf, dev) % dconf.interpAnchorStride == 0
    anchors = torch.nonzero(at_anchor).reshape(-1)
    check(anchors.numel() == 2, f"{anchors.numel()} anchor points, not 2")
    deep_bins = np.repeat(np.arange(radius - 16, radius + 17, dtype=np.int32), deep_counts)
    ds = torch.zeros(deep_n, dtype=torch.int32, device=dev)
    ds[~at_anchor] = torch.from_numpy(deep_bins[edge_rng.permutation(deep_bins.size)]).to(dev)
    hist, slots = ed.hist_and_literals(ds, radius)
    check(torch.equal(slots.to(torch.int64), anchors), "the anchors are not the literals")
    tree, nbits, tc, tl = de._tree_and_tables(hist, radius, deep_n, dev)
    check(int(tl.max()) > 32, "the deep archive's codes do not exceed 32 bits")
    payload = runtime.interp_seal_packed(
        dconf, tree, host_bytes(de._big_endian(ed.pack_bits(ds, tc, tl, radius, nbits), nbits)),
        nbits, deep_n, edge_rng.standard_normal(anchors.numel()).astype(np.float32), 1 << 40)
    blob = szp.pack_archive(dconf, payload)
    out, _ = szp.decompress(blob, device="cuda")
    check(out.cpu().numpy().tobytes() == native_decompress(blob).tobytes(),
          "codes over 32 bits: decode not bit-equal to the host engine's")
    print(f"edge codes over 32 bits ({deep_n} symbols, longest code {int(tl.max())} "
          f"bits): decode on the card bit-equal to the host engine's", flush=True)
    del ds, tc, tl, out, deep_bins, anchors, at_anchor, hist, slots
    torch.cuda.empty_cache()

    # LORENZO_REG inputs on the card against the host engine: a constant
    # field, thin tail blocks, the speculation-flip field (pass count
    # printed), the golden archives of other SZ3 builds, and the 1D default
    # field, which the tuner sends to LORENZO_REG and which goes to the host
    # engine without a device launch
    lr_rng = np.random.default_rng(11)
    f3 = lr_rng.standard_normal((13, 14, 8)).astype(np.float32)
    thin = (np.cumsum(f3, axis=0) * 0.1 + np.cumsum(f3, axis=-1) * 0.05).astype(np.float32)
    f24 = np.random.default_rng(11).standard_normal((24, 24, 24)).astype(np.float32)
    flip = (np.cumsum(f24, axis=0) * 0.1 + np.cumsum(f24, axis=-1) * 0.05).astype(np.float32)
    flip = (flip + (np.random.default_rng(11).integers(0, 3, flip.shape) - 1).astype(np.float32)
            * 9e-4).astype(np.float32)
    lr_edges = {"constant (13x12x7)": (np.full((13, 12, 7), 2.5, np.float32), EB),
                "thin tail blocks (13x14x8, extents 1 and 2; ABS 1e-2)": (thin, 1e-2),
                "speculation-flip field (24^3)": (flip, EB)}
    for name, (data, eb_x) in lr_edges.items():
        pass_stats = {}
        encode = wfe.encode_blocks_wavefront
        wfe.encode_blocks_wavefront = lambda *a: encode(*a[:6], stats=pass_stats)
        try:
            blob = szp.compress(data, lr_conf(eb_x), device="cuda")
        finally:
            wfe.encode_blocks_wavefront = encode
        blob_native = native_compress(data, lr_conf(eb_x))
        check(hashlib.sha256(blob).hexdigest() == hashlib.sha256(blob_native).hexdigest(),
              f"LORENZO_REG {name}: archive sha256 differs from the host engine's")
        check(szp.open_archive(blob)[0].cmprAlgo == szp.ALGO.LORENZO_REG,
              f"LORENZO_REG {name}: not a LORENZO_REG archive")
        out, _ = szp.decompress(blob, device="cuda")
        check(out.cpu().numpy().tobytes() == native_decompress(blob_native).tobytes(),
              f"LORENZO_REG {name}: decode not bit-equal to the host engine's")
        print(f"edge LORENZO_REG {name}: archive sha256 == host engine, decode on the card "
              f"bit-equal; {pass_stats['passes']} encode passes (first differences "
              f"{pass_stats['first_differences']})", flush=True)
    manifest = json.loads((ROOT / "tests" / "golden" / "manifest.json").read_text())
    for case in manifest:
        if "LORENZO_REG" not in (case["ini"] or ""):
            continue
        ref = (ROOT / "tests" / "golden" / f"{case['name']}.sz").read_bytes()
        before = wf.lorenzo_sweep.launches
        out, gconf = szp.decompress(ref, device="cuda", dtype=np.float32)
        out = out.cpu().numpy()
        check(wf.lorenzo_sweep.launches == before + 1, f"golden {case['name']}: no sweep")
        check(out.tobytes() == native_decompress(ref).tobytes(),
              f"golden {case['name']}: decode not bit-equal to the host engine's")
        check(hashlib.sha256(out.tobytes()).hexdigest() == case["out_sha"],
              f"golden {case['name']}: decode hash differs from the manifest's")
        print(f"golden {case['name']} ({tuple(case['shape'])}, roster L1/L2/REG = "
              f"{int(gconf.lorenzo)}/{int(gconf.lorenzo2)}/{int(gconf.regression)}): decoded on "
              f"the card, bit-equal to the host engine and to the recorded hash", flush=True)
    walk = (np.cumsum(np.cumsum(np.random.default_rng(0).standard_normal(400_000))) * 1e-3
            ).astype(np.float32)
    all_counters = [ed.hist_and_literals, ed.pack_bits, dec.scan_windows, dec.write_windows,
                    wf.lorenzo_sweep]
    for w in all_counters:
        w.launches = 0
    blob = szp.compress(walk, szp.Config(absErrorBound=EB), device="cuda")
    out, wconf = szp.decompress(blob, device="cuda")
    seen = [w.launches for w in all_counters]
    blob_native = native_compress(walk, szp.Config(absErrorBound=EB))
    check(blob == blob_native, "1D default field: archive differs from the host engine's")
    check(wconf.cmprAlgo == szp.ALGO.LORENZO_REG, "1D default field: the tuner did not pick "
                                                  "LORENZO_REG")
    check(out.cpu().numpy().tobytes() == native_decompress(blob_native).tobytes(),
          "1D default field: decode not bit-equal")
    check(seen == [0] * len(all_counters), f"1D default field launched kernels {seen}")
    print(f"edge 1D default field (400,000 f32, tuned to LORENZO_REG): the host engine's "
          f"route, archive == host engine ({len(blob)} bytes), decode bit-equal, no kernel "
          f"launched", flush=True)
    del out, walk
    torch.cuda.empty_cache()

    stamp("phase 3 done")

    # ---- phase 4: the main path ---------------------------------------------------
    # launches are counted over the compress/decompress calls only: the
    # counters are zeroed just before them and read just after
    counters = {"hist_literals": ed.hist_and_literals, "pack_bits": ed.pack_bits,
                "huff_scan": dec.scan_windows, "huff_write": dec.write_windows}
    # the INTERP encode kernel counts on here alone: the later phases take
    # their counters from `counters`, and LORENZO_REG's never launches it
    launches = dict.fromkeys([*counters, "interp_encode"], 0)

    def drive(fn):
        """Run one piece of the main path with every launch count set to 0
        just before it and read just after."""
        for w in counters.values():
            w.launches = 0
        interp_before = encode_grid_fast.launches
        out = sync_time(fn)
        seen = {k: w.launches for k, w in counters.items()}
        seen["interp_encode"] = encode_grid_fast.launches - interp_before
        for k, v in seen.items():
            launches[k] += v
        return out, seen
    ie_rows = {}
    for n in SIZES:
        if n not in fields:
            t = time.perf_counter()
            fields[n] = nyx_like(n)
            print(f"nyx_like({n}): {time.perf_counter() - t:.2f} s", flush=True)
            native[n] = sync_time(lambda: native_compress(fields[n],
                                                          szp.Config(absErrorBound=EB)))
        data = fields[n]
        blob_native, native_enc_s = native[n]
        ref_out, native_dec_s = sync_time(lambda: native_decompress(blob_native))
        sha_native = hashlib.sha256(blob_native).hexdigest()

        torch.cuda.reset_peak_memory_stats()
        (blob_cold, enc_cold_s), _ = drive(
            lambda: szp.compress(data, szp.Config(absErrorBound=EB), device="cuda"))
        (blob_warm, enc_warm_s), enc_seen = drive(
            lambda: szp.compress(data, szp.Config(absErrorBound=EB), device="cuda"))
        ((out, _), dec_s), _ = drive(lambda: szp.decompress(blob_native, device="cuda"))
        del out
        torch.cuda.synchronize()
        first_peak = torch.cuda.max_memory_allocated()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ((out, _), dec_warm_s), dec_seen = drive(
            lambda: szp.decompress(blob_native, device="cuda"))
        dec_peak = torch.cuda.max_memory_allocated() - held
        torch.cuda.reset_peak_memory_stats()
        check(enc_seen["hist_literals"] == 1 and enc_seen["pack_bits"] >= 1
              and enc_seen["interp_encode"] >= 1, f"{n}^3 compress launched {enc_seen}")
        check(dec_seen["huff_scan"] >= 1 and dec_seen["huff_write"] >= 1,
              f"{n}^3 decompress launched {dec_seen}")
        for label, b in (("cold", blob_cold), ("warm", blob_warm)):
            check(hashlib.sha256(b).hexdigest() == sha_native,
                  f"{n}^3 {label} archive sha256 differs from the host engine's")
        out_np = out.cpu().numpy()
        check(out_np.shape == ref_out.shape, f"{n}^3 decode shape {out_np.shape}")
        check(np.array_equal(out_np.view(np.int32), ref_out.view(np.int32)),
              f"{n}^3 decode not bit-equal to the host engine's")
        err = float(np.abs(out_np.astype(np.float64) - data.astype(np.float64)).max())
        check(err <= EB, f"{n}^3 max error {err} > {EB}")
        mb = data.nbytes / 1e6
        print(f"main path {n}^3 ({mb:.0f} MB f32, ratio {data.nbytes / len(blob_cold):.2f}): "
              f"archive sha256 == host engine {sha_native[:16]}; decode bit-equal; "
              f"max err {err:.3e}", flush=True)
        print(f"  encode wall: port cold {enc_cold_s:.3f} s, port warm {enc_warm_s:.3f} s "
              f"({mb / enc_warm_s / 1e3:.3f} GB/s), host engine {native_enc_s:.3f} s", flush=True)
        print(f"  decode wall: port first {dec_s:.3f} s, port warm {dec_warm_s:.3f} s "
              f"({mb / dec_warm_s / 1e3:.3f} GB/s), host engine {native_dec_s:.3f} s; "
              f"launches per decompress {dec_seen}, per compress {enc_seen}", flush=True)
        print(f"  peak device memory of the warm decompress, above the {held / 2**30:.3f} GiB "
              f"held before it (cached stream order): {dec_peak / 2**30:.3f} GiB "
              f"({dec_peak / 1e6:.0f} MB); the per-window symbol rows that the decode no longer "
              f"makes were {ROWS_MB[n]} MB at this size; peak over this size's two compresses and "
              f"first decompress {first_peak / 2**30:.2f} GiB", flush=True)
        del out, out_np

        # the device tuner (on the main path since PR 7) against the host
        # engine's: the same decisions, both times, twice each
        base = szp.Config(absErrorBound=EB)
        base.set_dims(data.shape)
        runs = [both_tuners(base, data) for _ in range(2)]
        busy_ms, wall_ms, events, kinds = busy(lambda: tuner.tune(base.copy(), data, dev))
        print(f"  tuner at {n}^3: device {runs[0][1]:.4f} / {runs[1][1]:.4f} s, host engine "
              f"{runs[0][2]:.4f} / {runs[1][2]:.4f} s (two calls each); decisions equal "
              f"{runs[1][0]}; one device tune under torch.profiler: {events} device events, "
              f"busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall", flush=True)

        # where the encode time goes: the stages of compress, one by one
        c, tune_s = sync_time(lambda: tuned_conf(data))
        x, up_s = sync_time(lambda: torch.from_numpy(data.reshape(c.dims)).to(dev))
        plan = de.plan_for(c)
        perm = de.perm_for(c, dev)
        (bins_list, b0), pass_s = sync_time(lambda: encode_grid_fast(x, plan)[:2])
        pass_ms = event_ms(lambda: encode_grid_fast(x, plan), reps=3)
        # the passes' kernel (one launch a pass, in place) against their
        # plain version on the card: bits, time, and a bound of 28 bytes a
        # point (the original and the neighbours read, the reconstruction
        # and the bin written, the working copy, the bins grid's zeros)
        pbins, pb0, prec = encode_grid_plain(x, plan)
        rec = encode_grid_fast(x, plan)[2]
        check(torch.equal(bins_to_grid(bins_list, plan, b0, dev),
                          bins_to_grid(pbins, plan, pb0, dev))
              and torch.equal(rec.view(torch.int32), prec.view(torch.int32)),
              f"{n}^3 INTERP encode kernel differs from its plain version")
        del pbins, pb0, prec, rec
        ie_ms, ie_plain_ms, ie_runs = paired_ms(lambda: encode_grid_fast(x, plan),
                                                lambda: encode_grid_plain(x, plan), plain_reps=1)
        ie_rows[n] = (ie_ms, ie_plain_ms, bound(28 * x.numel(), 0), len(plan.passes))
        print(f"  interp_encode at {n}^3 ({len(plan.passes)} passes, one launch each): "
              f"{ie_ms:.4f} ms a call (working copy and passes), plain {ie_plain_ms:.4f} ms "
              f"(runs plain, kernel, kernel, plain {[round(v, 4) for v in ie_runs]}), bound "
              f"{ie_rows[n][2][0]:.4f} ms by {ie_rows[n][2][1]}", flush=True)
        stream, gather_s = sync_time(lambda: stream_order.to_stream(
            bins_to_grid(bins_list, plan, b0, dev), perm))
        rad = c.quantbinCnt // 2
        (hist, slots), k1_s = sync_time(lambda: ed.hist_and_literals(stream, rad))
        (tree, nbits, tc, tl), tree_s = sync_time(
            lambda: de._tree_and_tables(hist, rad, stream.numel(), dev))
        words, k2_s = sync_time(lambda: ed.pack_bits(stream, tc, tl, rad, nbits))
        (unpred, bits), d2h_s = sync_time(lambda: (   # host_bytes waits for both copies
            to_host(stream_order.literal_values(x, perm, slots)).numpy(),
            host_bytes(de._big_endian(words, nbits))))
        payload, seal_s = sync_time(lambda: runtime.interp_seal_packed(
            c, tree, bits, nbits, stream.numel(), unpred, 1 << 40))
        _, payload_native = szp.open_archive(blob_native)
        check(payload == payload_native, f"{n}^3 staged payload differs")
        print(f"  encode stages (s): device tune {tune_s:.3f}, upload {up_s:.3f}, "
              f"device passes {pass_s:.3f} (events {pass_ms / 1e3:.3f}), stream gather "
              f"{gather_s:.3f}, K1 {k1_s:.3f}, host tree {tree_s:.3f}, K2+K3 {k2_s:.3f}, "
              f"D2H {d2h_s:.3f}, host seal {seal_s:.3f}", flush=True)
        k1_call, k1_dev, k1_kern = k1_on_card(stream, rad)
        k1_bnd = bound(4 * stream.numel() + 4 * ed.table_len(rad) + 4 * slots.numel(),
                       4 * stream.numel())
        print(f"  K1 at {n}^3: {k1_call:.4f} ms a call, {k1_dev:.4f} ms on the card "
              f"({k1_kern:.4f} ms kernels and fill), bound {k1_bnd[0]:.4f} ms by {k1_bnd[1]}; "
              f"share of the symbols within +-64/512/2048/8190 of radius: "
              + " / ".join(f"{v:.5f} %" for v in window_shares(stream, rad)), flush=True)
        del x, bins_list, stream, hist, slots, words, perm

        # where the decode time goes: the stages of decompress, one by one
        dc, dpayload = szp.open_archive(blob_native)
        torch_backend._resolve_anchor_stride(dc)
        (bits, count, offset, codes, lens, _const, unpred), open_s = sync_time(
            lambda: runtime.open_packed(dc, dpayload, np.float32))
        (stream_t, values), up2_s = sync_time(lambda: (
            dec.upload_bytes(bits, dev, dec.PAD_BYTES),
            to_device(unpred, dev)))
        tabs, tables_s = sync_time(lambda: dec.build_decode_tables(codes, lens, offset, dev))
        state, redo, scan_s, check_s = scan_to_end(stream_t, len(bits) * 8, tabs)
        dense, write_s = sync_time(lambda: dec.write_windows(
            stream_t, len(bits) * 8, tabs, state.entry, *dec.owned_runs(state, count), count))
        perm = de.perm_for(dc, dev)
        plan = de.plan_for(dc)
        lit_d, place_s = sync_time(lambda: stream_order.literal_grid(
            values, perm, torch.nonzero(dense == 0).reshape(-1), count).reshape(plan.dims))
        bins_d, scatter_s = sync_time(
            lambda: stream_order.from_stream(dense, perm, count).reshape(plan.dims))

        def passes():
            return decode_grid_fast(grid_to_pass_slices(bins_d, plan),
                                    grid_to_pass_slices(lit_d, plan), plan,
                                    initial_literal(lit_d, plan), bins_d[(0,) * bins_d.dim()],
                                    lit_d.dtype)

        staged, dpass_s = sync_time(passes)
        check(np.array_equal(staged.cpu().numpy().view(np.int32), ref_out.view(np.int32)),
              f"{n}^3 staged decode not bit-equal to the host engine's")
        dpass_ms = event_ms(passes, reps=3)
        print(f"  decode stages (s): host zstd open {open_s:.3f}, upload (stream + literals) "
              f"{up2_s:.3f}, tables {tables_s:.3f}, K4 {scan_s:.3f} in {len(redo)} passes over "
              f"{redo} windows, validation {check_s:.3f}, write phase {write_s:.3f}, literal placement "
              f"{place_s:.3f}, inverse scatter {scatter_s:.3f}, device passes {dpass_s:.3f} "
              f"(events {dpass_ms / 1e3:.3f})", flush=True)
        del bins_d, lit_d, state, dense, stream_t, values, staged, perm
        torch.cuda.empty_cache()

        for label, fn in (("encode", lambda: szp.compress(data, szp.Config(absErrorBound=EB),
                                                          device="cuda")),
                          ("decode", lambda: szp.decompress(blob_native, device="cuda"))):
            busy_ms, wall_ms, events, kinds = busy(fn)
            share = f"{100 * busy_ms / wall_ms:.2f} %" if events else "not measured"
            split = ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(kinds.items()))
            print(f"  device busy, warm {label} under torch.profiler: {busy_ms:.2f} ms of "
                  f"{wall_ms:.2f} ms wall ({share}; {events} device events; {split})",
                  flush=True)
        stamp(f"main path {n}^3 done")
        torch.cuda.empty_cache()

    # the same path in f64 at 256^3
    data64 = fields[256].astype(np.float64)
    blob64_native, _ = sync_time(lambda: native_compress(data64, szp.Config(absErrorBound=EB)))
    (blob64, enc64_s), _ = drive(
        lambda: szp.compress(data64, szp.Config(absErrorBound=EB), device="cuda"))
    ((out64, _), dec64_s), seen64 = drive(lambda: szp.decompress(blob64, device="cuda"))
    check(hashlib.sha256(blob64).hexdigest() == hashlib.sha256(blob64_native).hexdigest(),
          "f64 256^3 archive sha256 differs from the host engine's")
    out64 = out64.cpu().numpy()
    check(out64.dtype == np.float64 and out64.tobytes() == native_decompress(blob64).tobytes(),
          "f64 256^3 decode not bit-equal to the host engine's")
    err64 = float(np.abs(out64 - data64).max())
    check(err64 <= EB, f"f64 256^3 max error {err64} > {EB}")
    check(seen64["huff_scan"] >= 1 and seen64["huff_write"] >= 1,
          f"f64 256^3 decompress launched {seen64}")
    print(f"main path 256^3 f64 ({data64.nbytes / 1e6:.0f} MB): archive sha256 == host engine, "
          f"decode bit-equal, max err {err64:.3e}; encode {enc64_s:.3f} s, decode "
          f"{dec64_s:.3f} s; launches per decompress {seen64}", flush=True)
    del out64, data64

    print(f"main-path launches {launches}", flush=True)
    for k, v in launches.items():
        check(v >= 1, f"kernel {k} was not launched on the main path")
    stamp("phase 4 done")

    # ---- phase 5: the LORENZO_REG path ---------------------------------------------
    # compress / decompress with cmprAlgo = LORENZO_REG (default roster L1 +
    # REG, blockSize 6); launches counted over these calls alone
    lr_counters = dict(counters, lorenzo_sweep=wf.lorenzo_sweep, lorenzo_select=wfe.select)
    lr_launches = dict.fromkeys(lr_counters, 0)

    def drive_lr(fn):
        for w in lr_counters.values():
            w.launches = 0
        out = sync_time(fn)
        seen = {k: w.launches for k, w in lr_counters.items()}
        for k, v in seen.items():
            lr_launches[k] += v
        return out, seen

    lr_encode_stages = [
        (wfe, "fits", "fits"), (wfe, "select", "selection"),
        (runtime, "blockwise_coef_chain_encode", "chain"),
        (wfe, "reg_preplace_encode", "REG pre-placement"), (wfe, "sweep_encode", "sweep"),
        (stream_order, "to_stream", "stream gather"), (ed, "hist_and_literals", "K1"),
        (de, "_tree_and_tables", "host tree"), (ed, "pack_bits", "K2+K3"),
        (stream_order, "literal_values", "literal gather"), (de, "to_host", "D2H"),
        (runtime, "blockwise_seal_packed", "host seal")]
    lr_decode_stages = [
        (runtime, "blockwise_open_packed", "host zstd open"),
        (dd, "dense_bins", "Huffman decode"), (dec, "scan_windows", "count phase"),
        (dec, "write_windows", "write phase"),
        (stream_order, "literal_grid", "literal placement"), (stream_order, "from_stream", "bins placement"),
        (wf, "selection_info", "chain"), (wf, "reg_preplace_decode", "REG pre-placement"),
        (wf, "sweep_decode", "sweep")]

    def mem_line(mem):
        return ", ".join(f"{k} {v / 2**20:.1f}" for k, v in mem.items())

    def stage_line(stages, order):
        return ", ".join(f"{name} {sum(stages[name]):.4f}"
                         + (f" ({len(stages[name])} calls)" if len(stages[name]) > 1 else "")
                         for name in dict.fromkeys(n for _, _, n in order) if name in stages)

    lr_passes = {}
    for n in SIZES:
        data = fields[n]
        if n in native_lr:
            blob_native, native_enc_s = native_lr[n]
        else:
            blob_native, native_enc_s = sync_time(lambda: native_compress(data, lr_conf()))
        ref_out, native_dec_s = sync_time(lambda: native_decompress(blob_native))
        sha_native = hashlib.sha256(blob_native).hexdigest()
        (blob_cold, enc_cold_s), _ = drive_lr(lambda: szp.compress(data, lr_conf(), device="cuda"))
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (blob_warm, enc_warm_s), enc_seen = drive_lr(
            lambda: szp.compress(data, lr_conf(), device="cuda"))
        enc_peak = torch.cuda.max_memory_allocated() - held
        ((out, _), dec_s), _ = drive_lr(lambda: szp.decompress(blob_native, device="cuda"))
        del out
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ((out, _), dec_warm_s), dec_seen = drive_lr(
            lambda: szp.decompress(blob_native, device="cuda"))
        dec_peak = torch.cuda.max_memory_allocated() - held
        for label, b in (("cold", blob_cold), ("warm", blob_warm)):
            check(hashlib.sha256(b).hexdigest() == sha_native,
                  f"LORENZO_REG {n}^3 {label} archive sha256 differs from the host engine's")
        check(szp.open_archive(blob_native)[0].cmprAlgo == szp.ALGO.LORENZO_REG,
              f"LORENZO_REG {n}^3: the archive is not LORENZO_REG")
        out_np = out.cpu().numpy()
        check(out_np.shape == ref_out.shape and np.array_equal(out_np.view(np.int32),
                                                               ref_out.view(np.int32)),
              f"LORENZO_REG {n}^3 decode not bit-equal to the host engine's")
        err = float(np.abs(out_np.astype(np.float64) - data.astype(np.float64)).max())
        check(err <= EB, f"LORENZO_REG {n}^3 max error {err} > {EB}")
        check(enc_seen["hist_literals"] == 1 and enc_seen["pack_bits"] == 1
              and enc_seen["lorenzo_sweep"] >= 1
              and enc_seen["lorenzo_select"] == enc_seen["lorenzo_sweep"] + 1,
              f"LORENZO_REG {n}^3 compress launched {enc_seen}")
        check(dec_seen["huff_scan"] >= 1 and dec_seen["huff_write"] == 1
              and dec_seen["lorenzo_sweep"] == 1 and dec_seen["lorenzo_select"] == 0,
              f"LORENZO_REG {n}^3 decompress launched {dec_seen}")
        mb = data.nbytes / 1e6
        print(f"LORENZO_REG {n}^3 ({mb:.0f} MB f32, ratio {data.nbytes / len(blob_cold):.2f}): "
              f"archive sha256 == host engine {sha_native[:16]}; decode bit-equal; max err "
              f"{err:.3e}", flush=True)
        print(f"  encode wall: port cold {enc_cold_s:.3f} s, port warm {enc_warm_s:.3f} s "
              f"({mb / enc_warm_s / 1e3:.3f} GB/s), host engine {native_enc_s:.3f} s", flush=True)
        print(f"  decode wall: port first {dec_s:.3f} s, port warm {dec_warm_s:.3f} s "
              f"({mb / dec_warm_s / 1e3:.3f} GB/s), host engine {native_dec_s:.3f} s; launches "
              f"per compress {enc_seen}, per decompress {dec_seen}", flush=True)
        total = torch.cuda.get_device_properties(0).total_memory
        print(f"  peak device memory above what was held before the call: warm compress "
              f"{enc_peak / 2**30:.3f} GiB ({enc_peak / data.nbytes:.2f} bytes a field byte), "
              f"warm decompress {dec_peak / 2**30:.3f} GiB ({dec_peak / data.nbytes:.2f}); at "
              f"that ratio the card's {total / 2**30:.1f} GiB, less the {held / 2**30:.3f} GiB "
              f"held, fits a field of {(total - held) / (enc_peak / data.nbytes) / 1e9:.1f} GB "
              f"to compress and {(total - held) / (dec_peak / data.nbytes) / 1e9:.1f} GB to "
              f"decompress", flush=True)
        del out, out_np

        # where the time goes: each stage timed between synchronisations
        c, cap = archive_conf(data, lr_conf())
        x, up_s = sync_time(lambda: torch.from_numpy(data).to(dev))
        pstats, enc_mem = {}, {}
        with timed(lr_encode_stages + [(wfe, "encode_blocks_wavefront", "wavefront"),
                                       (de, "encode_payload_device_blockwise", "all")],
                   enc_mem) as st:
            payload, staged_s = sync_time(
                lambda: de.encode_payload_device_blockwise(c, x, cap, pstats))
        check(payload == szp.open_archive(blob_native)[1], f"LORENZO_REG {n}^3 staged payload "
                                                           f"differs")
        lr_passes[n] = pstats["passes"]
        print(f"  encode stages (s): upload {up_s:.4f}, {stage_line(st, lr_encode_stages)}; "
              f"sweep per pass {[round(v, 4) for v in st['sweep']]}; {pstats['passes']} passes "
              f"(first differences {pstats['first_differences']}); all {staged_s:.4f}",
              flush=True)
        print(f"  encode stages, peak device memory above what each began with (MiB): "
              f"{mem_line(enc_mem)}", flush=True)
        del x
        dc, dpayload = szp.open_archive(blob_native)
        dec_mem = {}
        with timed(lr_decode_stages + [(dd, "decode_payload_device_blockwise", "all")],
                   dec_mem) as st:
            staged, staged_s = sync_time(
                lambda: dd.decode_payload_device_blockwise(dc, dpayload, dev))
        check(np.array_equal(staged.cpu().numpy().view(np.int32), ref_out.view(np.int32)),
              f"LORENZO_REG {n}^3 staged decode not bit-equal")
        print(f"  decode stages (s): {stage_line(st, lr_decode_stages)}; all {staged_s:.4f} "
              f"(the Huffman decode holds the count and write phases)", flush=True)
        print(f"  decode stages, peak device memory above what each began with (MiB): "
              f"{mem_line(dec_mem)}", flush=True)
        del staged
        for label, fn in (("encode", lambda: szp.compress(data, lr_conf(), device="cuda")),
                          ("decode", lambda: szp.decompress(blob_native, device="cuda"))):
            busy_ms, wall_ms, events, kinds = busy(fn)
            share = f"{100 * busy_ms / wall_ms:.2f} %" if events else "not measured"
            split = ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(kinds.items()))
            print(f"  device busy, warm LORENZO_REG {label} under torch.profiler: {busy_ms:.2f} ms "
                  f"of {wall_ms:.2f} ms wall ({share}; {events} device events; {split})",
                  flush=True)
        stamp(f"LORENZO_REG {n}^3 done")
        torch.cuda.empty_cache()

    print(f"LORENZO_REG path launches {lr_launches}; encode passes {lr_passes}", flush=True)
    for k, v in lr_launches.items():
        check(v >= 1, f"kernel {k} was not launched on the LORENZO_REG path")
    stamp("phase 5 done")

    # ---- phase 6: NOPRED, OpenMP-format archives, BIOMD and BIOMDXTC --------------
    # each against the host engine at full size: archives sha256-equal, decodes
    # bit-equal; launches counted over the compress / decompress calls alone
    p6_counters = dict(counters, biomd_frames=bd.biomd_frames)
    p6_launches = dict.fromkeys(p6_counters, 0)

    def drive6(fn):
        for w in p6_counters.values():
            w.launches = 0
        out = sync_time(fn)
        seen = {k: w.launches for k, w in p6_counters.items()}
        for k, v in seen.items():
            p6_launches[k] += v
        return out, {k: v for k, v in seen.items() if v}

    def conf6(algo=None, **kw):
        c = szp.Config(absErrorBound=EB, **kw)
        if algo is not None:
            c.cmprAlgo = algo
        return c

    nopred_enc_stages = [(de, "nopred_bins", "quantize"), (ed, "hist_and_literals", "K1"),
                         (de, "_tree_and_tables", "host tree"), (ed, "pack_bits", "K2+K3"),
                         (de, "to_host", "D2H"),
                         (runtime, "nopred_seal_packed", "host seal"),
                         (runtime, "zstd_compress", "zstd of the ratio rule")]
    nopred_dec_stages = [(runtime, "open_packed", "host zstd open"),
                         (dd, "dense_bins", "Huffman decode"), (dec, "scan_windows", "count phase"),
                         (dec, "write_windows", "write phase"), (dd, "recover", "recover")]
    omp_enc_stages = [(runtime, "tune_interp", "host tune"),
                      (torch_backend, "compress_payload_torch", "chunk"),
                      (de, "encode_payload_device", "device encode"),
                      (runtime, "interp_seal_packed", "host seal")]
    omp_dec_stages = [(torch_backend, "decompress_payload_torch", "chunk"),
                      (runtime, "open_packed", "host zstd open"),
                      (dd, "dense_bins", "Huffman decode"),
                      (dd, "decode_payload_device", "device decode")]

    def staged(stages, spec, fn, rest):
        """fn() with each stage of `spec` timed and its device memory peak;
        prints both and the whole call's time; with `rest` (stages that do
        not nest) also the time outside them."""
        mem = {}
        with timed(spec, mem) as st:
            out, all_s = sync_time(fn)
        outside = (f" (outside the stages: {all_s - sum(sum(v) for v in st.values()):.4f})"
                   if rest else "")
        print(f"  {stages} (s): {stage_line(st, spec)}; all {all_s:.4f}{outside}", flush=True)
        print(f"  {stages}, peak device memory above what each began with (MiB): "
              f"{mem_line(mem)}", flush=True)
        return out

    compress_torch = torch_backend.compress_payload_torch
    decompress_torch = torch_backend.decompress_payload_torch

    def case6(label, data, make_conf, enc_spec, dec_spec, expect, nthreads=0, bound_eb=EB,
              busy_too=False, capture=None, rest=(False, False)):
        """One phase-6 case: the host engine's archive and decode, the port's
        cold and warm compress and first and warm decompress on the card,
        checked equal; walls, launches, peaks, and with stage specs the
        stages. Returns (archive, captured arguments)."""
        blob_native, native_enc_s = sync_time(lambda: native_compress(data, make_conf(),
                                                                      nthreads))
        ref_out, native_dec_s = sync_time(lambda: native_decompress(blob_native))
        sha_native = hashlib.sha256(blob_native).hexdigest()
        grabbed = {}
        with contextlib.ExitStack() as stack:
            for mod, name in capture or []:
                grabbed[name] = stack.enter_context(captured(mod, name))
            (blob_cold, enc_cold_s), _ = drive6(
                lambda: szp.compress(data, make_conf(), device="cuda", nthreads=nthreads))
            ((out, _), dec_s), _ = drive6(lambda: szp.decompress(blob_native, device="cuda"))
        del out
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (blob_warm, enc_warm_s), enc_seen = drive6(
            lambda: szp.compress(data, make_conf(), device="cuda", nthreads=nthreads))
        enc_peak = torch.cuda.max_memory_allocated() - held
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ((out, oconf), dec_warm_s), dec_seen = drive6(
            lambda: szp.decompress(blob_native, device="cuda"))
        dec_peak = torch.cuda.max_memory_allocated() - held
        for tag, b in (("cold", blob_cold), ("warm", blob_warm)):
            check(hashlib.sha256(b).hexdigest() == sha_native,
                  f"{label} {tag} archive sha256 differs from the host engine's")
        out_np = out.cpu().numpy()
        check(out_np.shape == ref_out.shape and out_np.tobytes() == ref_out.tobytes(),
              f"{label}: decode not bit-equal to the host engine's")
        err = float(np.abs(out_np.astype(np.float64) - data.astype(np.float64)).max())
        check(err <= bound_eb, f"{label}: max error {err} > {bound_eb}")
        got = {"enc": enc_seen, "dec": dec_seen}
        for side, want in expect.items():
            check(want(got[side]), f"{label}: {side} launched {got[side]}")
        mb = data.nbytes / 1e6
        algo = szp.open_archive(blob_native)[0]
        print(f"{label} ({mb:.0f} MB {data.dtype}, {algo.cmprAlgo.name}"
              f"{', openmp' if algo.openmp else ''}, ratio {data.nbytes / len(blob_cold):.2f}): "
              f"archive sha256 == host engine {sha_native[:16]}; decode bit-equal; max err "
              f"{err:.3e}", flush=True)
        print(f"  encode wall: port cold {enc_cold_s:.3f} s, port warm {enc_warm_s:.3f} s "
              f"({mb / enc_warm_s / 1e3:.3f} GB/s), host engine {native_enc_s:.3f} s", flush=True)
        print(f"  decode wall: port first {dec_s:.3f} s, port warm {dec_warm_s:.3f} s "
              f"({mb / dec_warm_s / 1e3:.3f} GB/s), host engine {native_dec_s:.3f} s; launches "
              f"per compress {enc_seen}, per decompress {dec_seen}", flush=True)
        total = torch.cuda.get_device_properties(0).total_memory
        print(f"  peak device memory above what was held before the call: warm compress "
              f"{enc_peak / 2**30:.3f} GiB ({enc_peak / data.nbytes:.2f} bytes a field byte), "
              f"warm decompress {dec_peak / 2**30:.3f} GiB ({dec_peak / data.nbytes:.2f}); at "
              f"that ratio the card's {total / 2**30:.1f} GiB, less the {held / 2**30:.3f} GiB "
              f"held, fits a field of {(total - held) / (enc_peak / data.nbytes) / 1e9:.1f} GB "
              f"to compress and {(total - held) / (dec_peak / data.nbytes) / 1e9:.1f} GB to "
              f"decompress", flush=True)
        del out, out_np
        if enc_spec is None:
            torch.cuda.empty_cache()
            stamp(f"{label} done")
            return blob_native, {k: v.get("args") for k, v in grabbed.items()}
        c, cap = archive_conf(data, make_conf())
        payload = staged("encode stages", enc_spec,
                         lambda: compress_torch(c, data, cap, dev, nthreads), rest[0])
        check(payload == szp.open_archive(blob_native)[1], f"{label}: staged payload differs")
        dc, dpayload = szp.open_archive(blob_native)
        staged("decode stages", dec_spec, lambda: decompress_torch(dc, dpayload, None, dev),
               rest[1])
        if busy_too:
            for what, fn in (("encode", lambda: szp.compress(data, make_conf(), device="cuda",
                                                             nthreads=nthreads)),
                             ("decode", lambda: szp.decompress(blob_native, device="cuda"))):
                busy_ms, wall_ms, events, kinds = busy(fn)
                share = f"{100 * busy_ms / wall_ms:.2f} %" if events else "not measured"
                split = ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(kinds.items()))
                print(f"  device busy, warm {what} under torch.profiler: {busy_ms:.2f} ms of "
                      f"{wall_ms:.2f} ms wall ({share}; {events} device events; {split})",
                      flush=True)
        torch.cuda.empty_cache()
        stamp(f"{label} done")
        return blob_native, {k: v.get("args") for k, v in grabbed.items()}

    def hold_path(label, s, enc_conf, dec_args, algo):
        """K1, K2+K3, the count phase and the write phase against their plain
        versions, bit for bit, on a stream of the main path: `s`, the stream
        that the encode of (enc_conf, ...) made, and the Huffman stream of
        the payload that the decode of `dec_args` opened. The packed words
        must be that payload's stream, and the decode's symbols `s`."""
        nonlocal k1_err, k2_err, k4_err, kw_err
        rad = enc_conf.quantbinCnt // 2
        e1, hist = hold_k1(f"{label} stream", s, rad)
        _, nbits, tc, tl = de._tree_and_tables(hist, rad, s.numel(), dev)
        e2, words = hold_pack(f"{label} stream", s, tc, tl, rad, nbits)
        dconf, dpayload, ddt = dec_args[:3]
        bits, count, lo, codes, lens, const_sym, _ = runtime.open_packed(dconf, dpayload, ddt,
                                                                         algo=algo)
        check(const_sym < 0 and count == s.numel(), f"{label}: not a Huffman stream of "
                                                    f"{s.numel()} symbols")
        check(host_bytes(de._big_endian(words, nbits)) == bits,
              f"{label}: the packed words are not the payload's Huffman stream")
        del words, tc, tl
        e4a, ewa = hold_decode(f"{label} stream", bits, codes, lens, lo, chained=False)
        e4b, ewb = hold_decode(f"{label} stream, first 4096 windows",
                               bits[:4096 * dec.W_BITS // 8], codes, lens, lo, chained=True)
        check(torch.equal(dec.decode_stream(bits, count, codes, lens, lo, dev), s),
              f"{label}: the decode's symbols are not the encode's stream")
        print(f"  {label}: K1, K2+K3, the count and the write phase bit-equal to their plain "
              f"versions on the path's stream; the decode gives back the encode's stream",
              flush=True)
        k1_err, k2_err = max(k1_err, e1), max(k2_err, e2)
        k4_err, kw_err = max(k4_err, e4a, e4b), max(kw_err, ewa, ewb)
        torch.cuda.empty_cache()
        return hist

    # NOPRED: 512^3 float32 and 256^3 float64; the kernels held against
    # their plain versions on the element-order streams of the path
    nopred = szp.ALGO.NOPRED
    np_capture = [(de, "encode_payload_device_nopred"), (dd, "decode_payload_device_nopred")]
    _, got = case6("NOPRED 512^3", fields[512], lambda: conf6(nopred), nopred_enc_stages,
                   nopred_dec_stages,
                   {"enc": lambda s: s == {"hist_literals": 1, "pack_bits": 1},
                    "dec": lambda s: s.get("huff_scan", 0) >= 1 and s.get("huff_write") == 1},
                   busy_too=True, capture=np_capture, rest=(True, False))
    np_conf, np_x = got["encode_payload_device_nopred"][:2]
    np_rad = np_conf.quantbinCnt // 2
    np_stream = de.nopred_bins(np_x.reshape(-1), np_conf.absErrorBound, np_rad)
    del np_x, got["encode_payload_device_nopred"]
    np_hist = hold_path("NOPRED 512^3", np_stream, np_conf,
                        got["decode_payload_device_nopred"], algo=3)
    # K1's time and window shares on the NOPRED stream
    np_call, np_dev, np_kern = k1_on_card(np_stream, np_rad)
    np_bound = bound(4 * np_stream.numel() + 4 * ed.table_len(np_rad) + 4 * int(np_hist[0]),
                     4 * np_stream.numel())
    far = (np_stream[np_stream != 0].to(torch.int64) - np_rad).abs()
    print(f"  K1 on the NOPRED 512^3 stream ({np_stream.numel()} symbols in element order, "
          f"{int((np_hist[2:] > 0).sum())} distinct, farthest {int(far.max())} bins from radius, "
          f"{outside_k1_window(np_hist, np_rad)} outside K1's +-{ed.K1_W_HALF} window): "
          f"{np_call:.4f} ms a call, {np_dev:.4f} ms on the card ({np_kern:.4f} ms kernels and "
          f"fill), bound {np_bound[0]:.4f} ms by {np_bound[1]}; share of the symbols within "
          f"+-64/512/2048/8190 of radius: "
          + " / ".join(f"{v:.5f} %" for v in window_shares(np_stream, np_rad)), flush=True)
    del np_stream, np_hist, far, got
    torch.cuda.empty_cache()
    _, got = case6("NOPRED 256^3 f64", fields[256].astype(np.float64), lambda: conf6(nopred),
                   nopred_enc_stages, nopred_dec_stages,
                   {"enc": lambda s: s == {"hist_literals": 1, "pack_bits": 1},
                    "dec": lambda s: s.get("huff_write") == 1},
                   capture=np_capture, rest=(True, False))
    np_conf, np_x = got["encode_payload_device_nopred"][:2]
    hold_path("NOPRED 256^3 f64", de.nopred_bins(np_x.reshape(-1), np_conf.absErrorBound,
                                                 np_conf.quantbinCnt // 2),
              np_conf, got["decode_payload_device_nopred"], algo=3)
    del np_x, got

    # OpenMP-format archives: the default Config (tuner on), chunks on the
    # card one after the other, against the engine's threaded path at the
    # same chunk count; a ragged count; cross decodes
    omp_cases = {
        f"chunked ABS 1e-3, {CHUNKS} chunks, 512^3": (lambda: conf6(openmp=True), CHUNKS, EB),
        f"chunked REL 1e-3, {CHUNKS} chunks, 512^3": (
            lambda: szp.Config(errorBoundMode=szp.EB.REL, relErrorBound=1e-3, openmp=True),
            CHUNKS, 1e-3 * float(fields[512].max() - fields[512].min())),
        "chunked ABS 1e-3, 6 chunks (ragged), 512^3": (lambda: conf6(openmp=True), 6, EB),
    }
    for label, (make, n, eb_b) in omp_cases.items():
        first = n == CHUNKS and "ABS" in label
        blob_native, got = case6(label, fields[512], make, omp_enc_stages if first else None,
                                 omp_dec_stages,
                                 {"enc": lambda s, n=n: s.get("hist_literals") == n
                                  and s.get("pack_bits") == n,
                                  "dec": lambda s, n=n: s.get("huff_write") == n},
                                 nthreads=n, bound_eb=eb_b, busy_too=first,
                                 capture=[(de, "encode_payload_device"),
                                          (dd, "decode_payload_device")] if first else None)
        if first:       # the kernels on the last chunk's stream, against their plain versions
            check(None not in got.values(), f"{label}: the last chunk did not take the INTERP "
                                            f"device route")
            ch_conf, ch_x = got["encode_payload_device"][:2]
            torch_backend._resolve_anchor_stride(ch_conf)
            hold_path(f"{label}, chunk {n} of {n} {tuple(ch_x.shape)}",
                      stream_of(ch_x, ch_conf), ch_conf, got["decode_payload_device"], algo=2)
            del ch_x, got
        blob_port = szp.compress(fields[512], make(), device="cuda", nthreads=n)
        by_engine = native_decompress(blob_port)
        by_port = szp.decompress(blob_native, device="cuda")[0].cpu().numpy()
        check(by_engine.tobytes() == by_port.tobytes(),
              f"{label}: cross decodes (port -> engine, engine -> port) differ")
        nch = struct.unpack_from("<i", szp.open_archive(blob_native)[1], 0)[0]
        check(nch == n, f"{label}: {nch} chunks")
        print(f"  cross decode: the port's archive in the engine and the engine's on the card, "
              f"bit-equal ({nch} chunks)", flush=True)
        del blob_port, by_engine, by_port
        # each chunk's tuning, as compress_chunked hands it to the dispatcher:
        # the device tuner against the host engine's
        cc = make()
        cc.set_dims(fields[512].shape)
        whole = fields[512].reshape(cc.dims)
        if cc.errorBoundMode != szp.EB.ABS:
            cal_abs_error_bound(cc, whole, float(whole.max() - whole.min()))
        dev_s = host_s = 0.0
        picks = set()
        for lo, hi in chunked._chunk_bounds(cc.dims[0], n):
            part = np.ascontiguousarray(whole[lo:hi])
            pc = cc.copy()
            pc.set_dims(part.shape)
            pc.openmp = False
            cal_abs_error_bound(pc, part)
            got, d_s, h_s = both_tuners(pc, part)
            dev_s, host_s = dev_s + d_s, host_s + h_s
            picks.add(tuple(got.values()))
        print(f"  tuner on each of the {n} chunks: decisions equal to the host engine's "
              f"({len(picks)} distinct: {sorted(picks)}); device {dev_s:.4f} s, host engine "
              f"{host_s:.4f} s in all", flush=True)

    # BIOMD and BIOMDXTC on a water-like trajectory of the ApoA1 system's
    # atoms, and a shorter one with a tail of fill frames (its depth cut to
    # keep the script's time)
    t = time.perf_counter()
    trajs = {"": md_traj(TRAJ_FRAMES, TRAJ_ATOMS, seed=0),
             ", 100 fill frames": md_traj(FILL_FRAMES, TRAJ_ATOMS, seed=2, fill_tail=100)}
    print(f"trajectories {TRAJ_FRAMES} and {FILL_FRAMES} x {TRAJ_ATOMS} x 3: "
          f"{time.perf_counter() - t:.2f} s",
          flush=True)
    for traj in trajs.values():      # three-site water, as the reference detects it
        check(bd.cal_site(traj[1]) == 3, f"trajectory site {bd.cal_site(traj[1])}, not 3")
    bio_args = {}
    for tag, traj in trajs.items():
        for algo in (szp.ALGO.BIOMD, szp.ALGO.BIOMDXTC):
            biomd = algo == szp.ALGO.BIOMD
            want = {"biomd_frames": 1} if biomd else {}
            # no stages: PERF.md holds their earlier readings, and the script's
            # time limit took these repetitions when phases 8 and 9 came
            _, got = case6(f"{algo.name} {traj.shape[0]}x{TRAJ_ATOMS}x3{tag}", traj,
                           lambda algo=algo: conf6(algo), None, None,
                           {"enc": lambda s, want=want: s == want,
                            "dec": lambda s, want=want: s == want},
                           bound_eb=EB * 1.2,
                           capture=[(bd, "frames_encode"), (bd, "frames_recover")]
                           if biomd and not tag else None)
            bio_args.update(got)
    water = trajs[""]           # phase 7 compresses it with MDZ
    del trajs

    # the recurrence at the main path's shape: kernel against plain, bit for
    # bit, and timed (plain, kernel, kernel, plain; the plain loop once)
    fx, fr0, feb, frad, fsite = bio_args["frames_encode"]
    fb, flits, _, _, _, _ = bio_args["frames_recover"]
    check(torch.equal(bd.frames_encode(fx, fr0, feb, frad, fsite),
                      bd.frames_encode_plain(fx, fr0, feb, frad, fsite))
          and torch.equal(bd.frames_recover(fb, flits, fr0, feb, frad, fsite).view(torch.int32),
                          bd.frames_recover_plain(fb, flits, fr0, feb, frad, fsite)
                          .view(torch.int32)),
          "biomd_frames at the main path's shape differs from its plain version")
    bfe_ms, bfe_plain_ms, bfe_runs = paired_ms(
        lambda: bd.frames_encode(fx, fr0, feb, frad, fsite),
        lambda: bd.frames_encode_plain(fx, fr0, feb, frad, fsite), plain_reps=1)
    bfr_ms, bfr_plain_ms, bfr_runs = paired_ms(
        lambda: bd.frames_recover(fb, flits, fr0, feb, frad, fsite),
        lambda: bd.frames_recover_plain(fb, flits, fr0, feb, frad, fsite), plain_reps=1)
    fcells = fx.numel()
    fzero = int((fb == 0).sum())
    # encode: the frames read, the bins written, frame 0's reconstruction read;
    # recover: the bins and the literals at their zero bins read, the
    # reconstruction written. Operations: some 20 a cell to quantize, 6 to
    # recover, 2 for the prediction
    bfe_bound = bound(8 * fcells + 4 * fr0.numel(), 22 * fcells)
    bfr_bound = bound(8 * fcells + 4 * fzero + 4 * fr0.numel(), 8 * fcells)
    print(f"biomd_frames at {tuple(fx.shape)} (site {fsite}): bit-equal to plain; recover "
          f"kernel {bfr_ms:.4f} ms, plain {bfr_plain_ms:.2f} ms ({[round(v, 4) for v in bfr_runs]}"
          f"), bound {bfr_bound[0]:.5f} ms by {bfr_bound[1]}; encode kernel {bfe_ms:.4f} ms, plain "
          f"{bfe_plain_ms:.2f} ms ({[round(v, 4) for v in bfe_runs]}), bound {bfe_bound[0]:.5f} ms "
          f"by {bfe_bound[1]}; one launch a call (the plain loop {2 + 3 * fx.shape[0]} or more "
          f"PyTorch calls); no PyTorch call computes it", flush=True)
    del bio_args, fx, fr0, fb, flits

    # the golden NOPRED, OpenMP, BIOMD and BIOMDXTC archives decoded on the card
    for case in manifest:
        if not any(k in case["name"] for k in ("nopred", "omp", "biomd")):
            continue
        ref = (ROOT / "tests" / "golden" / f"{case['name']}.sz").read_bytes()
        gdt = np.dtype(case["dtype"])
        for w in p6_counters.values():
            w.launches = 0
        out, gconf = szp.decompress(ref, device="cuda", dtype=gdt)
        seen = {k: w.launches for k, w in p6_counters.items() if w.launches}
        gconf_ref, gpayload = szp.open_archive(ref)
        want = runtime.decompress_payload(gconf_ref, gpayload,
                                          dtype=runtime.np_dtype_id(np.empty(0, gdt)))
        out = out.cpu().numpy()
        check(out.tobytes() == want.tobytes(),
              f"golden {case['name']}: decode not bit-equal to the host engine's")
        check(hashlib.sha256(out.tobytes()).hexdigest() == case["out_sha"],
              f"golden {case['name']}: decode hash differs from the manifest's")
        print(f"golden {case['name']} ({tuple(case['shape'])} {gdt}, {gconf.cmprAlgo.name}"
              f"{', openmp' if gconf.openmp else ''}): decoded on the card, bit-equal to the host "
              f"engine and to the recorded hash; launches {seen}", flush=True)

    print(f"phase 6 launches {p6_launches}", flush=True)
    for k in ("hist_literals", "pack_bits", "huff_scan", "huff_write", "biomd_frames"):
        check(p6_launches[k] >= 1, f"kernel {k} was not launched in phase 6")
    stamp("phase 6 done")

    # ---- phase 7: MDZ ------------------------------------------------------------------
    # sz3_tpu_torch.mdz on the card against the host engine's szt_mdz_compress /
    # szt_mdz_decompress: archives sha256-equal, decodes bit-equal and within
    # the bound, each side decoding the other's archive; mdz_frames' launches
    # counted over these calls alone
    p7_launches = {"mdz_frames": 0}

    def drive7(fn):
        md.mdz_frames.launches = 0
        out = sync_time(fn)
        seen = md.mdz_frames.launches
        p7_launches["mdz_frames"] += seen
        return out, seen

    mdz_enc_stages = [(mdz_torch, "mdz_levels", "levels"), (mdz_torch, "_select", "select trials"),
                      (md, "exaalt_encode", "VQ/VQT sweeps"), (md, "mt_encode", "MT sweeps"),
                      (mdz_torch, "_exaalt_seal", "host seals"),
                      (mdz_torch, "_ts_seal", "host seals"),
                      (mdz_torch, "lammps_compress", "host LR/TS"),
                      (mdz_torch, "to_host", "D2H copies"), (mdz_torch, "upload", "H2D copies")]
    mdz_dec_stages = [(mdz_torch, "_exaalt_open", "host opens"),
                      (mdz_torch, "_ts_open", "host opens"),
                      (md, "exaalt_decode", "VQ/VQT sweeps"), (md, "mt_decode", "MT sweeps"),
                      (mdz_torch, "lammps_decompress", "host LR/TS"),
                      (mdz_torch, "upload", "H2D copies")]

    def mdz_methods(blob):
        """The method of each batch, a list per axis."""
        def one(b):
            pos = 6 + 8 * b[5] + 9 + 16
            used = b[pos]
            pos += 1
            if used:
                pos += 8 + struct.unpack_from("<Q", b, pos)[0]
            nb = struct.unpack_from("<I", b, pos)[0]
            return [mdz.METHOD_NAMES[b[pos + 4 + 29 * i]] for i in range(nb)]

        if blob[:4] == b"MDZ1":
            return [one(blob)]
        out, pos = [], 29
        for _ in range(struct.unpack_from("<Q", blob, 21)[0]):
            ln = struct.unpack_from("<Q", blob, pos)[0]
            out.append(one(blob[pos + 8:pos + 8 + ln]))
            pos += 8 + ln
        return out

    def case7(label, data, kw, capture=False, stages=True):
        """One MDZ case: the engine's archive and decode, the port's cold and
        warm compress and decompress on the card, checked equal; walls,
        peaks, methods, launches and stages. Returns the captured arguments
        of the recurrence's wrappers (with `capture`)."""
        method = kw.get("method", "ADP")
        eng = (kw.get("abs_eb"), kw.get("rel_eb"), kw.get("batch_size", 0), mdz.METHODS[method],
               1024)
        blob_native, native_enc_s = sync_time(lambda: mdz.engine_compress(data, *eng))
        ref_out, native_dec_s = sync_time(lambda: mdz.engine_decompress(blob_native))
        sha_native = hashlib.sha256(blob_native).hexdigest()
        grabbed = {}
        with contextlib.ExitStack() as stack:
            if capture:
                for name in ("frames_encode", "frames_recover"):
                    grabbed[name] = stack.enter_context(captured(md, name))
            (blob_cold, enc_cold_s), seen_c = drive7(
                lambda: mdz.mdz_compress(data, device="cuda", **kw))
            (out, dec_s), seen_dc = drive7(lambda: mdz.mdz_decompress(blob_native, device="cuda"))
        del out
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (blob_warm, enc_warm_s), seen_e = drive7(
            lambda: mdz.mdz_compress(data, device="cuda", **kw))
        enc_peak = torch.cuda.max_memory_allocated() - held
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (out, dec_warm_s), seen_d = drive7(lambda: mdz.mdz_decompress(blob_native, device="cuda"))
        dec_peak = torch.cuda.max_memory_allocated() - held
        for tag, b in (("cold", blob_cold), ("warm", blob_warm)):
            check(hashlib.sha256(b).hexdigest() == sha_native,
                  f"{label} {tag} archive sha256 differs from the host engine's")
        out_np = out.cpu().numpy()
        check(out_np.shape == ref_out.shape and out_np.tobytes() == ref_out.tobytes(),
              f"{label}: decode not bit-equal to the host engine's")
        check(mdz.engine_decompress(blob_warm).tobytes() == out_np.tobytes(),
              f"{label}: the engine's decode of the port's archive differs from the card's")
        span = float(data.max()) - float(data.min())
        bound_eb = kw["abs_eb"] if "abs_eb" in kw else kw["rel_eb"] * span * (1 + 1e-6)
        err = float(np.abs(out_np.astype(np.float64) - data.astype(np.float64)).max())
        check(err <= bound_eb, f"{label}: max error {err} > {bound_eb}")
        methods = mdz_methods(blob_native)
        recurrent = any(m in ("VQT", "MT") for axis in methods for m in axis)
        check(method == "VQ" or seen_e >= 1, f"{label}: compress launched mdz_frames {seen_e} "
                                              f"times")
        check(not recurrent or seen_d >= 1, f"{label}: decompress launched mdz_frames {seen_d} "
                                            f"times")
        mb = data.nbytes / 1e6
        print(f"{label} ({mb:.0f} MB {data.dtype}, {kw}, ratio {data.nbytes / len(blob_cold):.2f}): "
              f"archive sha256 == host engine {sha_native[:16]}; decode bit-equal; each side "
              f"decodes the other's archive; max err {err:.3e} (bound {bound_eb:.3e})", flush=True)
        print(f"  methods per batch: " + "; ".join(f"axis {k}: {' '.join(a)}"
                                                for k, a in enumerate(methods)), flush=True)
        print(f"  encode wall: port cold {enc_cold_s:.3f} s, port warm {enc_warm_s:.3f} s "
              f"({mb / enc_warm_s / 1e3:.3f} GB/s), host engine {native_enc_s:.3f} s", flush=True)
        print(f"  decode wall: port first {dec_s:.3f} s, port warm {dec_warm_s:.3f} s "
              f"({mb / dec_warm_s / 1e3:.3f} GB/s), host engine {native_dec_s:.3f} s; mdz_frames "
              f"launches: compress {seen_c} / {seen_e} (cold / warm), decompress {seen_dc} / "
              f"{seen_d}", flush=True)
        print(f"  peak device memory above what was held before the call: warm compress "
              f"{enc_peak / 2**30:.3f} GiB ({enc_peak / data.nbytes:.2f} bytes a series byte), "
              f"warm decompress {dec_peak / 2**30:.3f} GiB ({dec_peak / data.nbytes:.2f})",
              flush=True)
        del out, out_np
        if stages:
            # the select trials hold their own sweeps, seals and copies
            staged("encode stages", mdz_enc_stages,
                   lambda: mdz.mdz_compress(data, device="cuda", **kw), False)
            staged("decode stages", mdz_dec_stages,
                   lambda: mdz.mdz_decompress(blob_native, device="cuda"), True)
        torch.cuda.empty_cache()
        stamp(f"{label} done")
        return {k: v.get("args") for k, v in grabbed.items()}

    # a lattice trajectory of the ApoA1 system's atom count: atoms vibrating
    # around levels 1.5 apart (noise 0.05), the port's counterpart of
    # tests/test_mdz.py::lattice_traj, as solid-state MD of the EXAALT kind
    t = time.perf_counter()
    rng_l = np.random.default_rng(0)
    lattice = (rng_l.integers(0, 12, (TRAJ_ATOMS, 3)) * 1.5
               + rng_l.normal(0, 0.05, (TRAJ_FRAMES, TRAJ_ATOMS, 3))).astype(np.float32)
    print(f"lattice trajectory {TRAJ_FRAMES} x {TRAJ_ATOMS} x 3: {time.perf_counter() - t:.2f} s",
          flush=True)
    case7(f"MDZ ADP {TRAJ_FRAMES}x{TRAJ_ATOMS}x3 lattice", lattice,
          dict(rel_eb=1e-3, batch_size=100))
    head = np.ascontiguousarray(lattice[:100])
    mdz_args = {}
    for method in ("VQ", "VQT", "MT"):
        got = case7(f"MDZ {method} 100x{TRAJ_ATOMS}x3 lattice", head,
                    dict(rel_eb=1e-3, method=method), capture=method == "VQT")
        mdz_args.update({k: v for k, v in got.items() if v is not None})
    del lattice         # phase 10 runs sz3t-torch-mdz on `head`
    case7(f"MDZ ADP {TRAJ_FRAMES}x{TRAJ_ATOMS}x3 water-like", water,
          dict(rel_eb=1e-3, batch_size=100), stages=False)
    del water

    # the recurrence on the path's own input (the VQT case's last axis):
    # kernel against plain, bit for bit, and timed (plain, kernel, kernel,
    # plain; the plain loop once)
    check(set(mdz_args) == {"frames_encode", "frames_recover"},
          f"the VQT case did not run the recurrence both ways: {sorted(mdz_args)}")
    mx, mr0, meb, mrad = mdz_args["frames_encode"]
    mb, mlits, mstarts, _, _, _ = mdz_args["frames_recover"]
    err_e = max_abs_diff(md.frames_encode(mx, mr0, meb, mrad),
                         md.frames_encode_plain(mx, mr0, meb, mrad))
    err_r = max_abs_diff(
        md.frames_recover(mb, mlits, mstarts, mr0, meb, mrad).view(torch.int32),
        md.frames_recover_plain(mb, mlits, mstarts, mr0, meb, mrad).view(torch.int32))
    check(err_e == 0 and err_r == 0,
          f"mdz_frames on the path's input differs from its plain version ({err_e}, {err_r})")
    mdz_err = max(mdz_err, err_e, err_r)
    mfe_ms, mfe_plain_ms, mfe_runs = paired_ms(
        lambda: md.frames_encode(mx, mr0, meb, mrad),
        lambda: md.frames_encode_plain(mx, mr0, meb, mrad), plain_reps=1)
    mfr_ms, mfr_plain_ms, mfr_runs = paired_ms(
        lambda: md.frames_recover(mb, mlits, mstarts, mr0, meb, mrad),
        lambda: md.frames_recover_plain(mb, mlits, mstarts, mr0, meb, mrad), plain_reps=1)
    # the pass that a kernel writing frame-major bins would need after it
    tr_ms = event_ms(lambda: mb.t().contiguous())
    mcells = mx.numel()
    # encode: the frames read and the bins written, frame 0's reconstruction
    # read; recover: the bins, this run's literals (one a zero bin), each
    # atom's literal slot and frame 0 read, the reconstruction written.
    # Operations: some 20 a cell to quantize, 6 to recover
    mfe_bound = bound(8 * mcells + 4 * mr0.numel(), 20 * mcells)
    mfr_bound = bound(8 * mcells + 4 * mlits.numel() + 12 * mr0.numel(), 6 * mcells)
    print(f"mdz_frames at {tuple(mx.shape)} (the VQT case's input, {mlits.numel()} literals): "
          f"bit-equal to plain; recover kernel {mfr_ms:.4f} ms, plain {mfr_plain_ms:.2f} ms "
          f"({[round(v, 4) for v in mfr_runs]}), bound {mfr_bound[0]:.5f} ms by {mfr_bound[1]}; encode kernel {mfe_ms:.4f} ms, plain "
          f"{mfe_plain_ms:.2f} ms ({[round(v, 4) for v in mfe_runs]}), bound {mfe_bound[0]:.5f} ms "
          f"by {mfe_bound[1]}; one launch a call (the plain loop some {25 * mx.shape[0]} PyTorch "
          f"calls); no PyTorch call computes it; the bins are written in the archive's (atom, "
          f"frame) order: the transpose of frame-major bins that it saves takes {tr_ms:.4f} ms",
          flush=True)
    del mdz_args, mx, mr0, mb, mlits, mstarts
    print(f"phase 7 launches {p7_launches}", flush=True)
    check(p7_launches["mdz_frames"] >= 1, "kernel mdz_frames was not launched in phase 7")
    stamp("phase 7 done")

    # ---- phase 8: serving ------------------------------------------------------------
    # sz3_tpu_torch.serving on time steps of nyx_like(n): snapshot k is the field
    # rolled by 3k along axis 0 plus N(0, 1e-3 k) noise (np.random.default_rng(k));
    # each archive sha256-equal to the port's single-field compress (INTERP
    # pinned) and to the host engine's, decompress_batch bit-equal to the
    # engine's decode; launches counted over the batch calls alone
    from concurrent.futures import ThreadPoolExecutor

    from sz3_tpu_torch import serving

    p8_launches = dict.fromkeys(counters, 0)
    engine_pool = ThreadPoolExecutor(max_workers=8)   # the engine's calls release the GIL

    def drive8(fn):
        for w in counters.values():
            w.launches = 0
        out = sync_time(fn)
        seen = {k: w.launches for k, w in counters.items()}
        for k, v in seen.items():
            p8_launches[k] += v
        return out, {k: v for k, v in seen.items() if v}

    def snapshots(base, b, noise=()):
        """b time steps of `base`; those in `noise` white noise over 100 times
        its range, each value twice along the last axis: most points are
        literals (ratio below 3), and zstd of the field beats the lossy
        payload, so they take the lossless route. (Plain white noise over the
        range stays INTERP at ratio 2.5, and over 100 times the range it
        ties with zstd: lossless at 96^3, INTERP at 256^3.)"""
        lo, hi = float(base.min()), float(base.max())
        mid, half = (lo + hi) / 2, 50 * (hi - lo)
        out = np.empty((b,) + base.shape, base.dtype)
        for k in range(b):
            rng = np.random.default_rng(k)
            if k in noise:
                half_shape = base.shape[:-1] + (base.shape[-1] // 2,)
                out[k] = np.repeat(rng.uniform(mid - half, mid + half, half_shape), 2, axis=-1)
            else:
                out[k] = np.roll(base, 3 * k, axis=0)
                if k:
                    out[k] += rng.standard_normal(base.shape, dtype=np.float32) * (1e-3 * k)
        return out

    def pinned(make):
        c = make()
        if c.cmprAlgo == szp.ALGO.INTERP_LORENZO:
            c.cmprAlgo = szp.ALGO.INTERP
        return c

    def union(spans):
        out = []
        for s, e in sorted(spans):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def seal_overlap(fn):
        """One call under torch.profiler: (device busy ms, device ms inside the
        host seals, the seals' ms (their union), wall ms, seals, {stage: (calls,
        s)}). Wrappers of the device half, the host half and the engine's seal
        record their host intervals (without a synchronisation); the seals'
        are placed on the profiler's clock by a marker the main thread
        records."""
        from torch.profiler import ProfilerActivity, profile, record_function

        stages = {"device halves (main thread)": (de, "pack_device"),
                  "host halves (workers)": (de, "seal_packed"),
                  "engine seals": (runtime, "interp_seal_packed")}
        got = {k: [] for k in stages}
        saved = {k: getattr(mod, name) for k, (mod, name) in stages.items()}

        def recorder(key):
            real = saved[key]

            def inner(*a, **k):
                t0 = time.perf_counter_ns()
                try:
                    return real(*a, **k)
                finally:
                    got[key].append((t0, time.perf_counter_ns()))
            return inner

        for key, (mod, name) in stages.items():
            setattr(mod, name, recorder(key))
        spans = got["engine seals"]
        try:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with record_function("phase 8 clock marker"):
                    mark = time.perf_counter_ns()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            for key, (mod, name) in stages.items():
                setattr(mod, name, saved[key])
        events = prof.events()
        off = next(e for e in events if e.name == "phase 8 clock marker").time_range.start \
            - mark / 1e3
        dev_iv = union([(e.time_range.start, e.time_range.end) for e in events
                        if e.device_type == torch.autograd.DeviceType.CUDA])
        seal_iv = union([(s / 1e3 + off, e / 1e3 + off) for s, e in spans])
        inside = sum(max(0.0, min(e1, e2) - max(s1, s2))
                     for s1, e1 in dev_iv for s2, e2 in seal_iv)
        return (sum(e - s for s, e in dev_iv) / 1e3, inside / 1e3,
                sum(e - s for s, e in seal_iv) / 1e3, wall * 1e3, len(spans),
                {k: (len(v), sum(e - s for s, e in v) / 1e9) for k, v in got.items()})

    def case8(label, stack, make, bound_eb, noise=(), hold=False, overlap=False):
        """One phase-8 case (`bound_eb(i)`: field i's bound); with `hold`, returns
        the arguments of the last field's device encode and decode, captured
        from the serving route."""
        b = stack.shape[0]
        gb = stack.nbytes / 1e9
        want, eng_s = sync_time(lambda: list(engine_pool.map(
            lambda f: native_compress(f, pinned(make)), stack)))
        shas = [hashlib.sha256(x).hexdigest() for x in want]
        grabbed = {}
        with contextlib.ExitStack() as st:
            if hold:
                grabbed["enc"] = st.enter_context(captured(de, "pack_device"))
            (blobs_cold, cold_s), _ = drive8(
                lambda: serving.compress_batch(stack, make(), device="cuda"))
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (blobs, warm_s), enc_seen = drive8(
            lambda: serving.compress_batch(stack, make(), device="cuda"))
        peak = torch.cuda.max_memory_allocated() - held
        reserved = torch.cuda.max_memory_reserved()
        for tag, got in (("cold", blobs_cold), ("warm", blobs)):
            check([hashlib.sha256(x).hexdigest() for x in got] == shas,
                  f"{label}: {tag} batch archives differ from the host engine's")
        check(enc_seen == {"hist_literals": b, "pack_bits": b},
              f"{label}: the batch launched {enc_seen}")
        single_s, single_peak = 0.0, 0
        for i, f in enumerate(stack):
            torch.cuda.synchronize()
            sheld = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            (blob, s), _ = drive8(lambda: szp.compress(f, pinned(make), device="cuda"))
            single_peak = max(single_peak, torch.cuda.max_memory_allocated() - sheld)
            check(blob == want[i], f"{label}: single-field archive {i} differs from the "
                                   f"engine's")
            single_s += s
        lossless = [i for i, x in enumerate(blobs)
                    if szp.open_archive(x)[0].cmprAlgo == szp.ALGO.LOSSLESS]
        check(lossless == list(noise), f"{label}: lossless fields {lossless}, not {noise}")
        ref = list(engine_pool.map(native_decompress, want))
        with contextlib.ExitStack() as st:
            if hold:
                grabbed["dec"] = st.enter_context(captured(dd, "decode_payload_device"))
            (out, dec_s), dec_seen = drive8(lambda: serving.decompress_batch(blobs,
                                                                             device="cuda"))
        check(out.device.type == "cuda" and tuple(out.shape) == stack.shape,
              f"{label}: decompress_batch gave {tuple(out.shape)} on {out.device}")
        err = 0.0
        for i in range(b):
            o = out[i].cpu().numpy()
            check(o.tobytes() == ref[i].tobytes(),
                  f"{label}: field {i} decode not bit-equal to the engine's")
            e = float(np.abs(o.astype(np.float64) - stack[i]).max())
            check(e <= bound_eb(i), f"{label}: field {i} max error {e} > {bound_eb(i)}")
            err = max(err, e)
        coded = b - len(lossless)
        check(dec_seen.get("huff_write") == coded and dec_seen.get("huff_scan", 0) >= coded,
              f"{label}: decompress_batch launched {dec_seen}")
        del out
        if overlap:
            busy_ms, inside_ms, seal_ms, wall_ms, nseal, host = seal_overlap(
                lambda: serving.compress_batch(stack, make(), device="cuda"))
        else:
            busy_ms, wall_ms, _, _ = busy(lambda: serving.compress_batch(stack, make(),
                                                                          device="cuda"))
        inflight = min(serving.DEPTH, b)
        print(f"{label} ({b} x {stack[0].nbytes / 1e6:.0f} MB {stack.dtype}, {gb:.2f} GB, "
              f"ratio {stack.nbytes / sum(map(len, blobs)):.2f}, lossless fields {lossless}): "
              f"archives sha256 == single-field compress == host engine; decompress_batch "
              f"bit-equal; max err {err:.3e}", flush=True)
        print(f"  batch wall: cold {cold_s:.3f} s, warm {warm_s:.3f} s ({gb / warm_s:.3f} GB/s); "
              f"single-field compress, warm walls summed {single_s:.3f} s "
              f"({gb / single_s:.3f} GB/s); host engine {eng_s:.3f} s on 8 threads; "
              f"decompress_batch {dec_s:.3f} s ({gb / dec_s:.3f} GB/s); launches per "
              f"batch {enc_seen}, per decompress_batch {dec_seen}", flush=True)
        print(f"  warm batch: device busy {busy_ms:.2f} of {wall_ms:.2f} ms under torch.profiler "
              f"({100 * busy_ms / wall_ms:.2f} %{'' if busy_ms else ', not measured'}); peak device memory {peak / 2**30:.3f} GiB above "
              f"the {held / 2**30:.3f} GiB held ({peak / inflight / 2**30:.3f} GiB per in-flight "
              f"field, {inflight} in flight; {peak / stack[0].nbytes:.2f} bytes a field byte), "
              f"reserved {reserved / 2**30:.3f} GiB; single-field warm compress peak "
              f"{single_peak / 2**30:.3f} GiB ({single_peak / stack[0].nbytes:.2f} bytes a field "
              f"byte)", flush=True)
        if overlap:
            share = f"{100 * inside_ms / busy_ms:.2f} %" if busy_ms else "not measured"
            print(f"  the {nseal} host seals of the warm batch span {seal_ms:.2f} ms (their union); "
                  f"device busy inside them {inside_ms:.2f} ms of the call's {busy_ms:.2f} ms "
                  f"({share}); host time by stage, summed over the fields: "
                  + ", ".join(f"{k} {v[1]:.3f} s ({v[0]} calls)" for k, v in host.items()),
                  flush=True)
            serving.DEPTH, depth = 1, serving.DEPTH
            try:
                (one, one_s), _ = drive8(lambda: serving.compress_batch(stack, make(),
                                                                        device="cuda"))
            finally:
                serving.DEPTH = depth
            check(one == blobs, f"{label}: depth 1 archives differ")
            print(f"  depth 1 (one field at a time, each sealed before the next starts): "
                  f"{one_s:.3f} s, against {warm_s:.3f} s at depth {depth}", flush=True)
        torch.cuda.empty_cache()
        stamp(f"{label} done")
        return {k: v.get("args") for k, v in grabbed.items()}

    def abs_conf():
        return szp.Config(absErrorBound=EB)

    def abs_bound(i):
        return EB

    case8("serving ABS 1e-3, 16 x 256^3", snapshots(fields[256], 16, noise=(7, 15)), abs_conf,
          abs_bound, noise=(7, 15))
    case8("serving ABS 1e-3, 4 x 512^3", snapshots(fields[512], 4), abs_conf, abs_bound,
          overlap=True)
    rel_stack = snapshots(fields[256], 8)
    rel_bounds = [1e-3 * float(f.max() - f.min()) for f in rel_stack]
    got = case8("serving REL 1e-3, 8 x 256^3", rel_stack,
                lambda: szp.Config(errorBoundMode=szp.EB.REL, relErrorBound=1e-3),
                rel_bounds.__getitem__, hold=True)
    del rel_stack
    s_conf, s_x = got["enc"][:2]
    hold_path("serving REL 256^3, field 8 of 8", stream_of(s_x, s_conf), s_conf, got["dec"],
              algo=2)
    del s_x, got
    case8("serving ABS 1e-3, 4 x 256^3 f64", snapshots(fields[256].astype(np.float64), 4),
          abs_conf, abs_bound)
    print(f"phase 8 launches {p8_launches}", flush=True)
    for k in counters:
        check(p8_launches[k] >= 1, f"kernel {k} was not launched in phase 8")
    stamp("phase 8 done")

    # ---- phase 9: sharded OpenMP-format archives -----------------------------------------
    # sz3_tpu_torch.parallel.sharded on a ragged 517 x 512 x 512 field (nyx_like(512)
    # and its first 5 planes; 4 chunks of 129 / 130 rows) at ABS and REL 1e-3: one
    # rank over NCCL in this process, then 4 gloo ranks sharing cuda:0, spawned;
    # payloads sha256-equal to compress_chunked and to the host engine at as many
    # chunks, the sharded decode bit-equal to the engine's decode
    import tempfile

    import torch.distributed as tdist
    import torch.multiprocessing as tmp_mp

    from sz3_tpu_torch.parallel import sharded

    p9_launches = dict.fromkeys(counters, 0)
    field9 = np.concatenate([fields[512], fields[512][:5]])
    modes9 = {"ABS": {"absErrorBound": EB},
              "REL": {"errorBoundMode": szp.EB.REL, "relErrorBound": 1e-3}}

    def conf9(mode):
        return szp.Config(cmprAlgo=szp.ALGO.INTERP, openmp=True, **modes9[mode])

    def engine9(mode, n):
        c, cap = archive_conf(field9, conf9(mode))
        return runtime.compress_payload(c, field9, cap, n)

    jobs = {(m, n): engine_pool.submit(engine9, m, n) for m in modes9 for n in (1, 4)}
    eng9 = {k: f.result() for k, f in jobs.items()}
    def engine9_decode(mode, payload):
        return runtime.decompress_payload(archive_conf(field9, conf9(mode))[0], payload)

    dec_jobs = {k: engine_pool.submit(engine9_decode, k[0], p) for k, p in eng9.items()}
    eng9_out = {k: hashlib.sha256(f.result().tobytes()).hexdigest() for k, f in dec_jobs.items()}
    for mode in modes9:
        got, s = sync_time(lambda: chunked.compress_chunked(conf9(mode), field9, 4, dev))
        check(got == eng9[mode, 4], f"compress_chunked {mode}, 4 chunks: payload differs from "
                                    f"the engine's")
        print(f"sharded {mode}: compress_chunked in 4 chunks == host engine at nthreads=4 "
              f"({len(got)} B, {s:.3f} s on the card)", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        sharded.init_file_group(str(Path(tmp) / "store"), 0, 1, backend="nccl")
        try:
            for mode in modes9:
                for w in counters.values():
                    w.launches = 0
                payload, enc_s = sync_time(lambda: sharded.sharded_encode_payload(
                    conf9(mode), field9))
                out, dec_s = sync_time(lambda: sharded.sharded_decode_payload(
                    szp.Config(dims=field9.shape, openmp=True), payload, dtype=np.float32))
                for k, w in counters.items():
                    p9_launches[k] += w.launches
                check(payload == eng9[mode, 1], f"NCCL rank, {mode}: payload differs")
                check(hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
                      == eng9_out[mode, 1], f"NCCL rank, {mode}: decode differs from the engine's")
                print(f"sharded {mode}, 1 NCCL rank on {out.device}: payload == host engine, "
                      f"decode bit-equal; encode {enc_s:.3f} s, decode {dec_s:.3f} s",
                      flush=True)
                del out
        finally:
            tdist.destroy_process_group()
        torch.cuda.empty_cache()
        npy = Path(tmp) / "field9.npy"
        np.save(npy, field9)
        t = time.perf_counter()
        tmp_mp.spawn(_phase9_rank, args=(4, str(Path(tmp) / "store4"), tmp, str(npy),
                                         list(modes9)), nprocs=4, join=True)
        spawn_s = time.perf_counter() - t
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text()) for r in range(4)]
    for mode in modes9:
        want_p = hashlib.sha256(eng9[mode, 4]).hexdigest()
        for r, res in enumerate(ranks):
            check(res[mode]["payload_sha"] == want_p, f"gloo rank {r}, {mode}: payload differs")
            check(res[mode]["out_sha"] == eng9_out[mode, 4],
                  f"gloo rank {r}, {mode}: decode differs from the engine's")
            for k, v in res[mode]["launches"].items():
                p9_launches[k] += v
        print(f"sharded {mode}, 4 gloo ranks on cuda:0: every rank's payload == host engine at "
              f"nthreads=4 and == compress_chunked, decode bit-equal; encode "
              f"{[round(x[mode]['enc_s'], 3) for x in ranks]} s, decode "
              f"{[round(x[mode]['dec_s'], 3) for x in ranks]} s by rank; launches by rank "
              f"{[x[mode]['launches'] for x in ranks]}", flush=True)
    print(f"  4 ranks spawned and joined in {spawn_s:.1f} s", flush=True)
    t = time.perf_counter()
    sharded.dryrun_multichip(4)
    print(f"  dryrun_multichip(4): {time.perf_counter() - t:.1f} s", flush=True)
    del field9, eng9
    engine_pool.shutdown()
    print(f"phase 9 launches {p9_launches}", flush=True)
    for k in counters:
        check(p9_launches[k] >= 1, f"kernel {k} was not launched in phase 9")
    stamp("phase 9 done")

    # ---- phase 10: the user-facing tools ----------------------------------------------
    # the CLI, sz3t-torch-mdz and pysz as a user runs them; the kernels' launches
    # counted over those runs alone (zeroed just before each, read just after)
    from sz3_tpu_torch import cli as pcli
    from sz3_tpu_torch import pysz as ppysz
    from sz3_tpu_torch.tools import profile_entropy, scaling_bench

    p10_counters = dict(counters, mdz_frames=md.mdz_frames)
    p10_launches = dict.fromkeys(p10_counters, 0)

    def drive10(fn):
        for w in p10_counters.values():
            w.launches = 0
        out = sync_time(fn)
        seen = {k: w.launches for k, w in p10_counters.items()}
        for k, v in seen.items():
            p10_launches[k] += v
        return out, seen

    def quiet(fn):
        """fn's standard output kept (and echoed, indented): (result, text)."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fn()
        text = buf.getvalue()
        print("    | " + text.rstrip().replace("\n", "\n    | "), flush=True)
        return out, text

    def cli(argv):
        rc, text = quiet(lambda: pcli.main([str(a) for a in argv]))
        check(rc == 0, f"sz3t-torch {' '.join(map(str, argv))} returned {rc}")
        return text

    def sha(b):
        return hashlib.sha256(b).hexdigest()

    tmp10 = tempfile.TemporaryDirectory()
    tdir = Path(tmp10.name)
    x512 = fields[512]
    dims512 = ["-3", *map(str, reversed(x512.shape))]
    src512 = tdir / "nyx512.f32"
    _, write_in_s = sync_time(lambda: x512.tofile(src512))
    blob512_native = native[512][0]
    ref512 = native_decompress(blob512_native)

    # the checked run: compress, decompress and -a in one command line; the
    # report's Distortion kept from the CLI's own verify
    kept = {}
    real_verify = pcli.verify

    def keep_verify(o, d):
        kept["d"] = real_verify(o, d)
        return kept["d"]

    pcli.verify = keep_verify
    try:
        with captured(de, "encode_payload_device") as enc10, \
                captured(dd, "decode_payload_device") as dec10:
            (text, cli_s), seen = drive10(lambda: cli(
                ["-f", "-i", src512, "-z", tdir / "a.sz", "-o", tdir / "a.out", *dims512,
                 "-M", "ABS", EB, "-a"]))
    finally:
        pcli.verify = real_verify
    check(seen["hist_literals"] == 1 and seen["pack_bits"] >= 1 and seen["huff_scan"] >= 1
          and seen["huff_write"] >= 1, f"the CLI at 512^3 launched {seen}")
    blob_cli = (tdir / "a.sz").read_bytes()
    blob_api = szp.compress(x512, szp.Config(absErrorBound=EB), device="cuda",
                            set_datatype=False)
    check(sha(blob_cli) == sha(blob_api) == sha(blob512_native),
          "the CLI's 512^3 archive differs from compress()'s or the host engine's")
    dec_host = np.fromfile(tdir / "a.out", dtype=np.float32)
    (tdir / "a.out").unlink()
    check(dec_host.tobytes() == ref512.tobytes(),
          "the CLI's 512^3 decode is not bit-equal to the host engine's")
    _, np_s = sync_time(lambda: kept.update(h=np_verify(x512, dec_host)))
    d, h = kept["d"], kept["h"]
    check(d.report() in text, "the CLI printed another report than its verify's")
    for f, want in h.items():
        got = getattr(d, f)
        if f in ("min", "max", "value_range", "max_abs_err", "max_rel_err"):
            ok = got == want
        else:
            ok = got == want or abs(got - want) <= 1e-12 * abs(want)
        check(ok, f"-a's {f} {got!r} != numpy float64's {want!r}")
    print(f"sz3t-torch at 512^3 ABS {EB} with -a ({cli_s:.3f} s, the first CLI run): archive "
          f"sha256 == compress(set_datatype=False) == host engine {sha(blob_cli)[:16]}; decoded "
          f"file bit-equal to the engine's decode; -a's min, max, max_abs_err equal numpy "
          f"float64's, the rest within 1e-12 (max err {d.max_abs_err:.3e}, PSNR "
          f"{d.psnr:.4f}); launches {seen}", flush=True)
    c_conf, c_x = enc10["args"][:2]
    hold_path("CLI 512^3", stream_of(c_x, c_conf), c_conf, dec10["args"], algo=2)
    del c_x, enc10, dec10

    # walls: the CLI's compress and decompress, each a run of its own, with
    # compress() / decompress() inside them; the file I/O and the output's copy
    # to the host timed alone on the same files
    with timed([(pcli, "compress", "compress()"), (pcli, "decompress", "decompress()")]) as st:
        (_, cli_enc_s), _ = drive10(lambda: cli(["-f", "-i", src512, "-z", tdir / "b.sz",
                                                 *dims512, "-M", "ABS", EB]))
        (_, cli_dec_s), _ = drive10(lambda: cli(["-f", "-z", tdir / "b.sz", "-o", tdir / "b.out",
                                                 *dims512]))
    check((tdir / "b.sz").read_bytes() == blob_cli, "the warm CLI archive differs")
    (tdir / "b.out").unlink()
    _, read_in_s = sync_time(lambda: np.fromfile(src512, dtype=np.float32))
    out_dev, _ = szp.decompress(blob_cli, device="cuda", dtype=np.float32)
    host, d2h_s = sync_time(lambda: out_dev.cpu().numpy())
    _, write_out_s = sync_time(lambda: host.tofile(tdir / "c.out"))
    (tdir / "c.out").unlink()
    enc_api, dec_api = st["compress()"][0], st["decompress()"][0]
    print(f"  CLI walls at 512^3 (warm): compress {cli_enc_s:.3f} s, of which compress() "
          f"{enc_api:.3f} s; reading the {x512.nbytes / 1e6:.0f} MB input alone {read_in_s:.3f} s "
          f"(writing it {write_in_s:.3f} s); the rest {cli_enc_s - enc_api - read_in_s:.3f} s",
          flush=True)
    print(f"  decompress {cli_dec_s:.3f} s, of which decompress() {dec_api:.3f} s; the output's "
          f"copy to the host alone {d2h_s:.3f} s, writing it alone {write_out_s:.3f} s; the rest "
          f"{cli_dec_s - dec_api - d2h_s - write_out_s:.3f} s", flush=True)
    del host

    # verify on the card at 512^3 beside numpy float64 on the host
    x_dev = torch.from_numpy(x512).to(dev)
    szp.verify(x_dev, out_dev)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    d_card, v_s = sync_time(lambda: szp.verify(x_dev, out_dev))
    v_peak = torch.cuda.max_memory_allocated() - held
    check(d_card == d, "verify on the card differs from the CLI's")
    print(f"  verify at 512^3: on the card {v_s:.3f} s (peak {v_peak / 2**20:.1f} MiB above "
          f"its two inputs, {v_peak / x512.nbytes:.3f} bytes a field byte); numpy float64 on "
          f"the host {np_s:.3f} s", flush=True)
    del x_dev, out_dev, ref512, dec_host
    torch.cuda.empty_cache()
    stamp("CLI 512^3 done")

    # REL at 256^3, in this process; then ABS in a fresh process
    x256 = fields[256]
    src256 = tdir / "nyx256.f32"
    x256.tofile(src256)
    dims256 = ["-3", *map(str, reversed(x256.shape))]
    (_, rel_s), seen = drive10(lambda: cli(["-f", "-i", src256, "-z", tdir / "r.sz", "-o",
                                            tdir / "r.out", *dims256, "-M", "REL", "1e-3"]))
    rel_conf = szp.Config(errorBoundMode=szp.EB.REL, relErrorBound=1e-3)
    blob_rel = native_compress(x256, rel_conf)
    check((tdir / "r.sz").read_bytes() == blob_rel == szp.compress(
        x256, rel_conf, device="cuda", set_datatype=False),
        "the CLI's REL 256^3 archive differs from compress()'s or the host engine's")
    check((tdir / "r.out").read_bytes() == native_decompress(blob_rel).tobytes(),
          "the CLI's REL 256^3 decode is not the engine's")
    print(f"sz3t-torch at 256^3 REL 1e-3: {rel_s:.3f} s; archive == compress() == host engine, "
          f"decode bit-equal; launches {seen}", flush=True)
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "sz3_tpu_torch.cli", "-f", "-i", str(src256),
                           "-z", "s.sz", "-o", "s.out", *dims256, "-M", "ABS", str(EB)],
                          capture_output=True, text=True, timeout=600, cwd=tdir,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})
    sub_s = time.perf_counter() - t
    check(proc.returncode == 0, f"python -m sz3_tpu_torch.cli failed:\n{proc.stderr[-2000:]}")
    blob256_native = native[256][0]
    ref256 = native_decompress(blob256_native)
    check((tdir / "s.sz").read_bytes() == blob256_native
          and (tdir / "s.out").read_bytes() == ref256.tobytes(),
          "python -m sz3_tpu_torch.cli at 256^3: archive or decode differs from the engine's")
    print(f"python -m sz3_tpu_torch.cli at 256^3 ABS {EB} in a fresh process: {sub_s:.2f} s cold "
          f"(interpreter, imports, CUDA start-up, compress, decompress); archive and decode "
          f"the engine's", flush=True)
    stamp("CLI 256^3 done")

    # sz3t-torch-mdz on phase 7's first 100 lattice frames, ADP at REL 1e-3
    traj_path = tdir / "lattice100.f32"
    head.tofile(traj_path)
    (_, mdz_s), seen = drive10(lambda: quiet(lambda: mdz.main(
        [str(traj_path), "-3", *map(str, head.shape), "-r", "1e-3", "-z",
         str(tdir / "m.mdz"), "-o", str(tdir / "m.out")])))
    check(seen["mdz_frames"] >= 1, f"sz3t-torch-mdz launched {seen}")
    blob_m = (tdir / "m.mdz").read_bytes()
    check(blob_m == mdz.mdz_compress(head, rel_eb=1e-3, device="cuda")
          == mdz.engine_compress(head, None, 1e-3, 0, mdz.METHODS["ADP"], 1024),
          "sz3t-torch-mdz's archive differs from mdz_compress's or the engine's")
    check((tdir / "m.out").read_bytes() == mdz.engine_decompress(blob_m).tobytes(),
          "sz3t-torch-mdz's decode is not the engine's")
    print(f"sz3t-torch-mdz, {' x '.join(map(str, head.shape))} lattice frames, ADP REL 1e-3: "
          f"{mdz_s:.3f} s; "
          f"archive == mdz_compress == engine, decode bit-equal; methods "
          f"{mdz_methods(blob_m)}; launches {seen}", flush=True)
    del head

    # pysz at 256^3
    pconf = ppysz.szConfig(x256.shape)
    pconf.absErrorBound = EB
    ((parr, ratio), pz_s), seen = drive10(lambda: ppysz.sz.compress(x256, pconf))
    check(parr.tobytes() == blob256_native == szp.compress(x256, szp.Config(absErrorBound=EB),
                                                            device="cuda"),
          "pysz's archive differs from compress(set_datatype=True)'s or the engine's")
    ((pout, _), pd_s), seen_d = drive10(lambda: ppysz.sz.decompress(parr, np.float32, x256.shape))
    check(pout.tobytes() == ref256.tobytes(), "pysz's decode is not the engine's")
    max_diff, psnr, _ = ppysz.sz.verify(x256, pout)
    check(max_diff <= EB, f"pysz round trip max error {max_diff}")
    print(f"pysz at 256^3: compress {pz_s:.3f} s (ratio {ratio:.2f}), decompress {pd_s:.3f} s; "
          f"bytes == compress() == engine; round trip max err {max_diff:.3e}, PSNR {psnr:.2f}; "
          f"launches {seen} / {seen_d}", flush=True)
    del ref256, pout, parr

    # the profiling tools at 256^3
    prof = profile_entropy.main(["--n", "256", "--reps", "3"])
    check(len(prof["ms"]) == 4 and all(v > 0 for v in prof["ms"].values()),
          f"profile_entropy: {prof['ms']}")
    print(f"profile_entropy {prof['n']}^3 ({prof['where']}, best of 3): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in prof["ms"].items()) + f"; code lengths max "
        f"{prof['tree']['max_len']}, mean {prof['tree']['mean_len']:.2f} bits", flush=True)
    chunks = scaling_bench.chunk_model(256)
    check([r["n_way_split"] for r in chunks] == [1, 2, 4, 8], "scaling_bench's chunk model")
    ranks = scaling_bench.rank_scaling((1, 2), 64)
    check([r["ranks"] for r in ranks] == [1, 2] and all(
        d.startswith("cuda") for r in ranks for d in r["devices"]),
        f"scaling_bench's rank scaling: {ranks}")
    tmp10.cleanup()

    h5z_thread.join()
    check("path" in h5z, f"build_h5z failed: {h5z.get('error', '')[-2000:]}")
    import importlib.util
    print(f"HDF5 filter plugin built ({h5z['s']:.1f} s on its thread beside the engine's build): "
          f"{Path(h5z['path']).name}; h5py is "
          f"{'present' if importlib.util.find_spec('h5py') else 'absent'} here, so HDF5 itself "
          f"is held only by the CPU tests (tests/test_torch_h5.py)", flush=True)
    print(f"phase 10 launches {p10_launches}", flush=True)
    for k in p10_counters:
        check(p10_launches[k] >= 1, f"kernel {k} was not launched in phase 10")
    stamp("phase 10 done")

    # ---- phase 11: the customized demo's four patterns, the single-step encode ----
    # the kernels' launches counted over pattern 1 on the card alone (zeroed
    # just before it, read just after)
    from sz3_tpu_torch import entry as pentry
    from sz3_tpu_torch.examples import customized_demo as demo

    with captured(de, "encode_payload_device") as enc11, \
            captured(dd, "decode_payload_device") as dec11:
        for w in counters.values():
            w.launches = 0
        (blob1, out1), p1_s = sync_time(lambda: demo.pattern1_highlevel_api("cuda"))
        p11_launches = {k: w.launches for k, w in counters.items()}
    data1 = demo.make_data()
    blob1_native = native_compress(data1, szp.Config(
        cmprAlgo=szp.ALGO.INTERP, interpAlgo=szp.INTERP_ALGO.LINEAR, absErrorBound=EB))
    check(sha(blob1) == sha(blob1_native),
          "demo pattern 1: the archive differs from the host engine's")
    check(out1.cpu().numpy().tobytes() == native_decompress(blob1_native).tobytes(),
          "demo pattern 1: the decode is not bit-equal to the host engine's")
    for k in counters:
        check(p11_launches[k] >= 1, f"kernel {k} was not launched by demo pattern 1")
    # K1, K2+K3, the count and the write phase against their plain versions
    # on the demo's own stream (two rescans at 64^3)
    d_conf, d_x = enc11["args"][:2]
    hold_path("demo pattern 1 64^3", stream_of(d_x, d_conf), d_conf, dec11["args"], algo=2)
    del d_x, enc11, dec11
    (bins2, pay2, out2), p2_s = sync_time(lambda: demo.pattern2_assemble_modules("cuda"))
    (bins3, pay3), p3_s = sync_time(lambda: demo.pattern3_custom_decomposition("cuda"))
    (blob4, out4), p4_s = sync_time(demo.pattern4_custom_compressor)
    walls = [p1_s, p2_s, p3_s, p4_s]
    t = time.perf_counter()
    h2 = demo.pattern2_assemble_modules("cpu")
    h3 = demo.pattern3_custom_decomposition("cpu")
    h4 = demo.pattern4_custom_compressor()
    cpu_s = time.perf_counter() - t
    check(bins2.cpu().equal(h2[0]) and pay2 == h2[1]
          and out2.cpu().numpy().tobytes() == h2[2].numpy().tobytes(),
          "demo pattern 2: the card's bins, payload or recovery differ from the CPU's")
    check(bins3.cpu().equal(h3[0]) and pay3 == h3[1],
          "demo pattern 3: the card's bins or payload differ from the CPU's")
    check(blob4 == h4[0] and out4.tobytes() == h4[1].tobytes(),
          "demo pattern 4: the blob differs from the CPU run's")
    print("demo on the card, walls (s) of patterns 1-4: " + ", ".join(f"{s:.4f}" for s in walls)
          + f" (patterns 2-4 on the CPU {cpu_s:.3f} s in all); pattern 1's archive "
          f"({len(blob1)} bytes, ratio {data1.nbytes / len(blob1):.1f}) sha256 == host engine "
          f"{sha(blob1)[:16]}, decode bit-equal; patterns 2 and 3 (payloads {len(pay2)} / "
          f"{len(pay3)} bytes) and 4 byte-equal to the CPU's; launches {p11_launches}",
          flush=True)
    del out1, out2, bins2, bins3, h2, h3

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-X", "importtime", "-m",
                           "sz3_tpu_torch.examples.customized_demo"], capture_output=True,
                          text=True, timeout=600, cwd=ROOT, env=env)
    demo_s = time.perf_counter() - t
    check(proc.returncode == 0, f"python -m sz3_tpu_torch.examples.customized_demo failed:\n"
                                f"{proc.stderr[-2000:]}")
    heads = [ln.split(":")[0] for ln in proc.stdout.splitlines()]
    check(heads == ["1. high-level API", "2. assembled modules", "3. custom decomposition",
                    "4. custom compressor (truncate)"], f"the demo printed {proc.stdout!r}")
    imported = {ln.rsplit("|", 1)[1].strip() for ln in proc.stderr.splitlines()
                if ln.startswith("import time:") and ln.count("|") == 2}
    check("torch" in imported and not [m for m in imported if m in ("jax", "sz3_tpu")
                                       or m.startswith(("jax.", "sz3_tpu."))],
          "the demo's process imported jax or the JAX package")
    print(f"python -m sz3_tpu_torch.examples.customized_demo in a fresh process, PYTHONPATH "
          f"unset: {demo_s:.2f} s cold, the four lines, neither jax nor sz3_tpu imported:\n    | "
          + proc.stdout.rstrip().replace("\n", "\n    | "), flush=True)

    run_c, (x_c,) = pentry.entry("cuda")
    (flat_c, b0_c), cold_s = sync_time(lambda: run_c(x_c))
    run_h, (x_h,) = pentry.entry("cpu")
    flat_h, b0_h = run_h(x_h)
    check(flat_c.dtype == torch.int32 and flat_c.cpu().equal(flat_h) and int(b0_c) == int(b0_h),
          "entry('cuda')'s bins or b0 differ from entry('cpu')'s")
    ev_ms, host_ms = [], []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        run_c(x_c)
        stop.record()
        stop.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        ev_ms.append(start.elapsed_time(stop))
    entry_ms = sorted(ev_ms)[REPS // 2]
    e_busy, e_wall, e_events, e_kinds = busy(lambda: run_c(x_c))
    print(f"entry('cuda') at 64^3: cold call {cold_s * 1e3:.3f} ms, warm {entry_ms:.4f} ms "
          f"(CUDA events, median of {REPS}; host clock median "
          f"{sorted(host_ms)[REPS // 2]:.4f} ms); {flat_c.numel()} bins and b0 bit-equal to "
          f"entry('cpu'); card: {card}", flush=True)
    print(f"  one warm call under torch.profiler: the card busy {e_busy:.3f} of {e_wall:.3f} ms "
          f"({100 * e_busy / e_wall:.2f} %), {e_events} device events; ms by kind " + ", ".join(
              f"{k} {v:.3f}" for k, v in sorted(e_kinds.items())), flush=True)
    del flat_c, x_c
    stamp("phase 11 done")

    # ---- phase 12: the dtype x rank x algorithm x bound-mode surface ----------------
    # (a) the float cases of tests/test_torch_matrix.py on the card, (b) a 2D
    # and a 4D field at the sizes users store, (c) integer fields, which take
    # the host engine's route; every archive sha256-equal to the host
    # engine's, every decode bit-equal to its decode. Launches are counted
    # over the compress / decompress calls alone.
    t12 = time.perf_counter()
    p12_counters = dict(counters, lorenzo_sweep=wf.lorenzo_sweep)
    p12_launches = dict.fromkeys(p12_counters, 0)
    any_kernel = dict(p12_counters, biomd_frames=bd.biomd_frames, mdz_frames=md.mdz_frames)

    def drive12(fn):
        """(result, seconds, launches of every kernel) of fn(), each count
        set to 0 just before it and read just after."""
        for w in any_kernel.values():
            w.launches = 0
        out, sec = sync_time(fn)
        seen = {k: w.launches for k, w in any_kernel.items()}
        for k in p12_launches:
            p12_launches[k] += seen[k]
        return out, sec, seen

    def conf12(kw):
        enums = {"errorBoundMode": szp.EB, "cmprAlgo": szp.ALGO, "interpAlgo": szp.INTERP_ALGO}
        return szp.Config(**{k: enums[k][v] if k in enums else v for k, v in kw.items()})

    def case12(label, x, kw, nthreads=2):
        """The host engine's archive and decode of x under the Config `kw`,
        and the port's on the card, checked equal: (the archive, launches of
        the compress, of the decompress, the engine's walls, the port's)."""
        blob_native, ne_s = sync_time(lambda: native_compress(x, conf12(kw), nthreads))
        ref, nd_s = sync_time(lambda: native_decompress(blob_native))
        blob, pe_s, seen_enc = drive12(lambda: szp.compress(x, conf12(kw), device="cuda",
                                                            nthreads=nthreads))
        (out, _), pd_s, seen_dec = drive12(lambda: szp.decompress(blob_native, device="cuda"))
        check(sha(blob) == sha(blob_native),
              f"phase 12 {label}: the archive's sha256 differs from the host engine's")
        out = out.cpu().numpy()
        check(out.dtype == ref.dtype == x.dtype and out.shape == ref.shape
              and out.tobytes() == ref.tobytes(),
              f"phase 12 {label}: the decode is not bit-equal to the host engine's")
        return blob, seen_enc, seen_dec, (ne_s, nd_s), (pe_s, pd_s)

    floats12 = (np.float32, np.float64)
    shapes12 = ((5000,), (60, 70), (24, 26, 28), (6, 7, 8, 9))
    algos12 = ("INTERP_LORENZO", "INTERP", "LORENZO_REG", "NOPRED")
    abs_f, rel_f = ({"errorBoundMode": "ABS", "absErrorBound": 1e-2},
                    {"errorBoundMode": "REL", "relErrorBound": 1e-3})
    modes12 = {"PSNR 60": {"errorBoundMode": "PSNR", "psnrErrorBound": 60.0},
               "L2NORM 1e-1": {"errorBoundMode": "L2NORM", "l2normErrorBound": 1e-1},
               "ABS_AND_REL": {"errorBoundMode": "ABS_AND_REL", "absErrorBound": 1e-2,
                               "relErrorBound": 1e-3},
               "ABS_OR_REL": {"errorBoundMode": "ABS_OR_REL", "absErrorBound": 1e-2,
                              "relErrorBound": 1e-3}}

    def nan_inf_field():
        x = walk_field(shapes12[2], np.float32, seed=3)
        x[3, 4, 5] = np.nan
        x[10, 0, 27] = np.inf
        x[23, 25, 0] = -np.inf
        x[7, 7, 7:9] = np.nan
        return x

    # (label, the field's maker, Config) in the order of the CPU matrix
    cases = [(f"A {np.dtype(dt).name} {s} {a}{' openmp' if omp else ''} {b}",
              lambda s=s, dt=dt: walk_field(s, dt), dict(bk, cmprAlgo=a, openmp=omp))
             for dt in floats12 for s in shapes12 for a in algos12 for omp in (False, True)
             for b, bk in (("ABS", abs_f), ("REL", rel_f))]
    cases += [(f"B {m} {np.dtype(dt).name} {a}", lambda dt=dt: walk_field(shapes12[2], dt, 1),
               dict(mk, cmprAlgo=a)) for m, mk in modes12.items() for dt in floats12
              for a in algos12]
    cases += [(f"C {ia} {np.dtype(dt).name} {s}", lambda s=s, dt=dt: walk_field(s, dt, 2),
               dict(abs_f, cmprAlgo="INTERP", interpAlgo=ia)) for ia in ("LINEAR", "CUBIC")
              for dt in floats12 for s in shapes12]
    cases += [(f"D NaN and Inf {a}", nan_inf_field, dict(abs_f, cmprAlgo=a)) for a in algos12]
    cases += [(f"D {s} {a}", lambda s=s: walk_field(s, np.float32, 4), dict(abs_f, cmprAlgo=a))
              for s in ((1, 40, 50), (40, 1, 50), (1, 1, 3000), (3, 3, 3), (2, 2000))
              for a in ("INTERP_LORENZO", "LORENZO_REG")]
    cases += [(f"D roster lorenzo/lorenzo2/regression {r}",
               lambda: walk_field(shapes12[2], np.float32, 5),
               dict(abs_f, cmprAlgo="LORENZO_REG", lorenzo=bool(r[0]), lorenzo2=bool(r[1]),
                    regression=bool(r[2])))
              for r in ((1, 1, 0), (0, 0, 1), (1, 0, 0), (1, 1, 1))]
    # K1, K2+K3, the count and the write phase held against their plain
    # versions on the streams of these two cases, captured from the path
    held12 = ("C CUBIC float32 (60, 70)", "C CUBIC float32 (6, 7, 8, 9)")
    by_algo = {}
    t = time.perf_counter()
    for label, make_x, kw in cases:
        with captured(de, "encode_payload_device") as enc12, \
                captured(dd, "decode_payload_device") as dec12:
            _, seen_enc, seen_dec, _, _ = case12(label, make_x(), kw)
        tally = by_algo.setdefault(kw["cmprAlgo"], dict.fromkeys(p12_counters, 0))
        for k in tally:
            tally[k] += seen_enc[k] + seen_dec[k]
        if label in held12:
            h_conf, h_x = enc12["args"][:2]
            hold_path(f"phase 12 {label}", stream_of(h_x, h_conf), h_conf, dec12["args"],
                      algo=2)
    float_s = time.perf_counter() - t
    print(f"phase 12 (a): {len(cases)} float cases of the CPU matrix (blocks A-D) on the card in "
          f"{float_s:.2f} s: every archive sha256-equal to the host engine's, every decode "
          f"bit-equal; launches by algorithm {by_algo}; card: {card}", flush=True)
    for k in p12_counters:
        check(p12_launches[k] >= 1, f"kernel {k} was not launched in phase 12 (a)")
    torch.cuda.empty_cache()

    # (b) an SDRBench CESM-ATM 2D field's shape and a QMCPACK einspline
    # field's (4D), synthetic, under the default Config at ABS 1e-3
    for label, shape, seed, hold in (("CESM-ATM-shaped 2D", (1800, 3600), 21, True),
                                     ("QMCPACK-shaped 4D", (288, 115, 69, 69), 22, False)):
        x = wave_field(shape, seed, dev).cpu().numpy()
        mb = x.nbytes / 1e6
        base = szp.Config(absErrorBound=EB)
        base.set_dims(x.shape)
        picked, tune_dev_s, tune_host_s = both_tuners(base, x)
        blob_native, ne_s = sync_time(lambda: native_compress(x, szp.Config(absErrorBound=EB)))
        ref, nd_s = sync_time(lambda: native_decompress(blob_native))
        with captured(de, "encode_payload_device") as enc12, \
                captured(dd, "decode_payload_device") as dec12:
            blob_cold, cold_s, _ = drive12(
                lambda: szp.compress(x, szp.Config(absErrorBound=EB), device="cuda"))
            (out, _), dcold_s, _ = drive12(lambda: szp.decompress(blob_native, device="cuda"))
        del out
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        blob_warm, warm_s, enc_seen = drive12(
            lambda: szp.compress(x, szp.Config(absErrorBound=EB), device="cuda"))
        enc_peak = torch.cuda.max_memory_allocated() - held
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (out, oconf), dwarm_s, dec_seen = drive12(
            lambda: szp.decompress(blob_native, device="cuda"))
        dec_peak = torch.cuda.max_memory_allocated() - held
        for tag, b in (("cold", blob_cold), ("warm", blob_warm)):
            check(sha(b) == sha(blob_native),
                  f"phase 12 {label} {tag}: the archive's sha256 differs from the host engine's")
        out_np = out.cpu().numpy()
        del out
        check(out_np.shape == ref.shape and out_np.tobytes() == ref.tobytes(),
              f"phase 12 {label}: the decode is not bit-equal to the host engine's")
        err = float(np.abs(out_np.astype(np.float64) - x.astype(np.float64)).max())
        check(err <= EB, f"phase 12 {label}: max error {err} > {EB}")
        check(enc_seen["hist_literals"] == 1 and enc_seen["pack_bits"] >= 1
              and dec_seen["huff_scan"] >= 1 and dec_seen["huff_write"] == 1,
              f"phase 12 {label}: launches per compress {enc_seen}, per decompress {dec_seen}")
        print(f"phase 12 (b) {label} {shape} ({mb:.1f} MB f32, {oconf.cmprAlgo.name}, ratio "
              f"{x.nbytes / len(blob_warm):.2f}): archive sha256 == host engine "
              f"{sha(blob_native)[:16]}; decode bit-equal; max err {err:.3e}; card: {card}",
              flush=True)
        print(f"  tuner: device {tune_dev_s:.4f} s, host engine {tune_host_s:.4f} s, decisions "
              f"equal {picked}", flush=True)
        print(f"  encode wall: port cold {cold_s:.3f} s, warm {warm_s:.3f} s "
              f"({mb / warm_s / 1e3:.3f} GB/s), host engine {ne_s:.3f} s; decode wall: port "
              f"first {dcold_s:.3f} s, warm {dwarm_s:.3f} s ({mb / dwarm_s / 1e3:.3f} GB/s), "
              f"host engine {nd_s:.3f} s", flush=True)
        print(f"  warm peak device memory above what was held: compress {enc_peak / 2**30:.3f} "
              f"GiB ({enc_peak / x.nbytes:.2f} bytes a field byte), decompress "
              f"{dec_peak / 2**30:.3f} GiB ({dec_peak / x.nbytes:.2f}); launches per compress "
              f"{ {k: v for k, v in enc_seen.items() if v} }, per decompress "
              f"{ {k: v for k, v in dec_seen.items() if v} }", flush=True)
        if hold:
            h_conf, h_x = enc12["args"][:2]
            hold_path(f"phase 12 {label}", stream_of(h_x, h_conf), h_conf, dec12["args"],
                      algo=2)
        del x, ref, out_np, blob_cold, blob_warm, blob_native, enc12, dec12
        torch.cuda.empty_cache()

    # (c) integer fields: the host engine's route, no kernel launched and no
    # device memory taken by the compress (the decode's output goes to the card)
    ints12 = (np.int8, np.uint8, np.int16, np.uint16, np.int32, np.uint32, np.int64, np.uint64)
    t = time.perf_counter()
    for dt in ints12:
        x = walk_field((64, 64, 64), dt, seed=11)
        for omp in (False, True):
            label = f"{np.dtype(dt).name} 64^3{f', openmp {CHUNKS} chunks' if omp else ''}"
            _, seen_enc, seen_dec, _, _ = case12(label, x, {"absErrorBound": 2, "openmp": omp},
                                                 CHUNKS if omp else 0)
            check(not any(seen_enc.values()) and not any(seen_dec.values()),
                  f"phase 12 {label}: launched {seen_enc} / {seen_dec}")
    small_s = time.perf_counter() - t
    print(f"phase 12 (c): the 8 integer dtypes at 64^3, default Config at ABS 2, one archive and "
          f"in {CHUNKS} chunks: 16 archives sha256-equal to the host engine's, decodes "
          f"bit-equal, no kernel launched ({small_s:.2f} s)", flush=True)
    for label, shape, dt, seed in (("uint16 512^3", (512, 512, 512), np.uint16, 23),
                                   ("int32 256^3", (256, 256, 256), np.int32, 24)):
        f = wave_field(shape, seed, dev)
        lo, hi = (0, 60000) if dt == np.uint16 else (-10**6, 10**6)
        x = ((f - f.min()) / (f.max() - f.min()) * (hi - lo) + lo).round().to(
            torch.int64).cpu().numpy().astype(dt)
        del f
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        blob, pe_s, seen_enc = drive12(
            lambda: szp.compress(x, szp.Config(absErrorBound=2), device="cuda"))
        enc_mem = torch.cuda.max_memory_allocated() - held
        blob2, seen_enc2, seen_dec, (ne_s, nd_s), (pe2_s, pd_s) = case12(
            label, x, {"absErrorBound": 2}, 0)
        check(blob == blob2, f"phase 12 {label}: the first archive differs from the second")
        check(not any(seen_enc.values()) and not any(seen_enc2.values())
              and not any(seen_dec.values()) and enc_mem == 0,
              f"phase 12 {label}: launched {seen_enc} / {seen_dec}, compress took {enc_mem} "
              f"bytes of device memory")
        print(f"phase 12 (c) {label} ({x.nbytes / 1e6:.1f} MB, ratio {x.nbytes / len(blob):.2f}, "
              f"{szp.open_archive(blob)[0].cmprAlgo.name}): archive sha256-equal to the host "
              f"engine's, decode bit-equal, no kernel launched, no device memory taken by the "
              f"compress; walls: port compress {pe_s:.3f} / {pe2_s:.3f} s, host engine "
              f"{ne_s:.3f} s; port decompress (to the card) {pd_s:.3f} s, host engine "
              f"{nd_s:.3f} s; card: {card}", flush=True)
        del x, blob, blob2
    p12_s = time.perf_counter() - t12
    print(f"phase 12 launches {p12_launches}; phase 12 took {p12_s:.1f} s", flush=True)
    stamp("phase 12 done")

    # ---- phase 13: damaged archives --------------------------------------------------
    # Users decode archives they did not write (from disks, networks, HDF5
    # files). Every decode route of sz3_tpu_torch/tools/damage_sweep.py, on an
    # archive written here, then decoded again after the route's KNOWN flips
    # (which ended the process before its checks), 60 seeded single-byte flips
    # and three truncations: each case decodes to the archive's dims and dtype
    # or raises, and the card is synchronised after each, so that a kernel
    # fault shows at its own case. Then each route's clean archive decodes
    # bit-equal to the host engine's: the context survived. Launches are
    # counted over the whole phase.
    from sz3_tpu_torch.tools import damage_sweep as dsw

    t13 = time.perf_counter()
    p13_counters = dict(counters, lorenzo_sweep=wf.lorenzo_sweep, biomd_frames=bd.biomd_frames,
                        mdz_frames=md.mdz_frames)
    for w in p13_counters.values():
        w.launches = 0
    arcs13 = {}
    for route in dsw.ROUTES:
        t = time.perf_counter()
        arc, recs = dsw.sweep(route, dev, flips=60)
        s = dsw.summary(route, recs, time.perf_counter() - t)
        arcs13[route] = arc
        known = recs[:len(dsw.KNOWN.get(route, ()))]
        print(f"phase 13 {route}: {s['cases']} cases of a {len(arc.blob)}-byte archive, "
              f"{s['arrays']} decoded, {s['raised']} raised, {s['wall_s']:.2f} s (longest case "
              f"{s['max_case_s']:.3f} s)" + (f"; KNOWN flips {[r['outcome'] for r in known]}"
                                             if known else ""), flush=True)
        check(s["nonconforming"] == 0,
              f"phase 13 {route}: {s['nonconforming']} cases decoded to other dims or dtype")
        check(s["max_case_s"] < 10.0, f"phase 13 {route}: a case took {s['max_case_s']:.1f} s")
        check(all(r["outcome"] == "raised" for r in known),
              f"phase 13 {route}: a KNOWN flip did not raise: {known}")
    for route, arc in arcs13.items():
        got = arc.decode(arc.blob).cpu().numpy()
        want = np.asarray(arc.engine()).reshape(got.shape)
        check(got.dtype == want.dtype and np.array_equal(got.view(np.uint8), want.view(np.uint8)),
              f"phase 13 {route}: the clean archive's decode after the sweep differs from the "
              f"host engine's")
    torch.cuda.synchronize()
    p13_launches = {k: w.launches for k, w in p13_counters.items()}
    p13_s = time.perf_counter() - t13
    print(f"phase 13: every clean archive decodes bit-equal to the host engine's after the "
          f"sweep; launches {p13_launches}; phase 13 took {p13_s:.1f} s", flush=True)
    for k in ("huff_scan", "huff_write", "lorenzo_sweep", "biomd_frames", "mdz_frames"):
        check(p13_launches[k] >= 1, f"kernel {k} was not launched in phase 13")
    stamp("phase 13 done")

    # ---- phase 14: the cell cesm2d-fields against the plain reference ---------------------
    phase14_cesm2d(dev)
    stamp("phase 14 done")

    # ---- phase 15: the cell qmcpack4d-roundtrip against the plain reference ---------------
    phase15_qmcpack4d(dev)
    stamp("phase 15 done")

    check("jax" not in sys.modules, "jax was imported")
    check(not any(m == "sz3_tpu" or m.startswith("sz3_tpu.") for m in sys.modules),
          "the JAX package was imported")

    def row(name, source, replaces, err, ms, plain_ms, bnd, library_ms, **extra):
        return {"name": name, "route": "cuda", "source": f"sz3_tpu_torch/csrc/{source}",
                "replaces": replaces, **extra,
                "launches": next(d[name] for d in (launches, lr_launches, p6_launches,
                                                   p7_launches) if name in d),
                "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library_ms}

    kernels = [
        row("hist_literals", "hist_literals.cu", "sz3_tpu/ops/entropy_device.py:124", k1_err,
            k1_ms, k1_plain_ms, k1_bound, k1_library_ms, device_ms=k1_dev_ms),
        row("pack_bits", "pack_bits.cu", "sz3_tpu/ops/entropy_device.py:308", k2_err, k2_ms,
            k2_plain_ms, k2_bound, None, also_replaces="sz3_tpu/ops/entropy_device.py:484",
            device_ms=k2_dev_ms),
        row("huff_scan", "huff_scan.cu", "sz3_tpu/ops/entropy_decode.py:283", k4_err, k4_ms,
            k4_plain_ms, k4_bound, None),
        row("huff_write", "huff_write.cu", "sz3_tpu/ops/entropy_decode.py:470", kw_err,
            kw_ms, kw_plain_ms, kw_bound, None),
        row("lorenzo_sweep", "lorenzo_sweep.cu", "sz3_tpu/ops/blockwise_wavefront.py:178",
            sweep_err, swd_ms, swd_plain_ms, swd_bound, None,
            also_replaces="sz3_tpu/ops/blockwise_wavefront_encode.py:284",
            encode_ms=swe_ms, encode_plain_ms=swe_plain_ms, encode_bound_ms=swe_bound[0],
            encode_bound_by=swe_bound[1], dependency_bound_ms=sw_dep_ms, ms_512=swd5_ms,
            encode_ms_512=swe5_ms, bound_ms_512=swd5_bound[0],
            encode_bound_ms_512=swe5_bound[0], dependency_bound_ms_512=sw5_dep_ms),
        row("interp_encode", "interp_encode.cu", "sz3_tpu/ops/interp_fast.py:280", 0.0,
            ie_rows[512][0], ie_rows[512][1], ie_rows[512][2], None, passes=ie_rows[512][3],
            ms_256=ie_rows[256][0], plain_ms_256=ie_rows[256][1], bound_ms_256=ie_rows[256][2][0]),
        row("lorenzo_select", "lorenzo_select.cu", "sz3_tpu/ops/blockwise_wavefront_encode.py:152",
            sel_err, sel_rows["first certifying"][0], sel_rows["first certifying"][1],
            sel_rows["first certifying"][2], None, speculative_ms=sel_rows["speculative"][0],
            speculative_plain_ms=sel_rows["speculative"][1],
            speculative_bound_ms=sel_rows["speculative"][2][0]),
        row("biomd_frames", "biomd_frames.cu", "sz3_tpu/ops/biomd_device.py:117", frames_err,
            bfr_ms, bfr_plain_ms, bfr_bound, None,
            also_replaces="sz3_tpu/ops/biomd_device.py:95", encode_ms=bfe_ms,
            encode_plain_ms=bfe_plain_ms, encode_bound_ms=bfe_bound[0],
            encode_bound_by=bfe_bound[1]),
        row("mdz_frames", "mdz_frames.cu", "sz3_tpu/ops/mdz_device.py:124", mdz_err,
            mfr_ms, mfr_plain_ms, mfr_bound, None,
            also_replaces="sz3_tpu/ops/mdz_device.py:110", encode_ms=mfe_ms,
            encode_plain_ms=mfe_plain_ms, encode_bound_ms=mfe_bound[0],
            encode_bound_by=mfe_bound[1], transpose_ms=tr_ms),
    ]
    for r in kernels:
        r["lorenzo_reg_launches"] = lr_launches.get(r["name"], 0)
        r["phase6_launches"] = p6_launches.get(r["name"], 0)
        r["phase7_launches"] = p7_launches.get(r["name"], 0)
        r["phase8_launches"] = p8_launches.get(r["name"], 0)
        r["phase9_launches"] = p9_launches.get(r["name"], 0)
        r["phase10_launches"] = p10_launches.get(r["name"], 0)
        r["phase11_launches"] = p11_launches.get(r["name"], 0)
        r["phase12_launches"] = p12_launches.get(r["name"], 0)
        r["phase13_launches"] = p13_launches.get(r["name"], 0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
