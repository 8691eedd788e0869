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
     (torch.bincount and torch.nonzero), timed beside it;
  3. the inputs the JAX package sends to the host (no anchor grid, bins far
     from radius, a constant stream, f64, codes over 32 bits) compressed and
     decompressed on the card, archives sha256-equal to the host engine's
     and decodes bit-equal to its decode;
  4. the main path: sz3_tpu_torch.compress / decompress on the card at
     ABS 1e-3 with the default Config (tuner on), on bench.nyx_like(256) and
     nyx_like(512), and an f64 round trip at 256^3. The archives must be
     sha256-equal to the host engine's, the decodes bit-equal to its decode
     and within the bound, and every kernel launched. Wall times, where the
     encode and decode time goes, the warm decode's peak device memory, and
     the card's busy time over one warm encode and decode, split by kind
     (torch.profiler); K1 timed on each size's stream.
The host engine is the port's own (sz3_tpu_torch/csrc/engine, built here by
sz3_tpu_torch.build.host_engine()). The last line is {"ok": true, "device":
{...}}; the line before it lists the kernels. Without a CUDA device, or
without the repository beside it, the script prints no result and exits 2.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
EB = 1e-3
SIZES = (256, 512)
REPS = 20
PLAIN_SCAN_REPS = 1        # the plain scan is thousands of small launches
SPIN_CYCLES = 40_000_000   # of torch.cuda._sleep: some 20 ms on an H100
# the per-window symbol rows of the decode before its write phase, MB, as
# measured when they existed (PERF.md): they are gone
ROWS_MB = {256: 132, 512: 1400}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
# the kernels are 32-bit integer work outside the tensor cores; the float32
# rate outside the tensor cores stands in as their peak
OPS_PER_S = 67e12


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

    t = time.perf_counter()
    runtime = build.host_engine()
    print(f"host engine ready: {time.perf_counter() - t:.2f} s", flush=True)
    t = time.perf_counter()
    build.build_kernels(verbose=True)
    build.kernels()
    print(f"kernel build: {time.perf_counter() - t:.2f} s", flush=True)

    import sz3_tpu_torch as szp
    from bench import nyx_like
    from sz3_tpu_torch.algos import device_decode as dd
    from sz3_tpu_torch.algos import device_encode as de
    from sz3_tpu_torch.algos import torch_backend
    from sz3_tpu_torch.algos.huffman import build_table
    from sz3_tpu_torch.api import archive_conf
    from sz3_tpu_torch.ops import entropy_decode as dec
    from sz3_tpu_torch.ops import entropy_device as ed
    from sz3_tpu_torch.ops import stream_order
    from sz3_tpu_torch.ops.interp_fast import (bins_to_grid, decode_grid_fast, encode_grid_fast,
                                               grid_to_pass_slices, initial_literal)

    dev = torch.device("cuda")

    def native_compress(data, conf):
        c, cap = archive_conf(data, conf)
        return szp.pack_archive(c, runtime.compress_payload(c, data, cap))

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
        """The Config that compress() encodes `data` with: tuned by the host
        engine, anchor stride resolved (the archive's tail does not carry
        every tuned parameter; the payload header does)."""
        conf = szp.Config(absErrorBound=EB)
        conf.set_dims(data.shape)
        runtime.tune_interp(conf, data)
        torch_backend._resolve_anchor_stride(conf)
        return conf

    def stream_of(x, conf):
        plan = de.plan_for(conf)
        bins_list, b0, _ = encode_grid_fast(x, plan)
        return stream_order.to_stream(bins_to_grid(bins_list, plan, b0, dev),
                                      de.perm_for(conf, dev))

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

    k1_err = 0
    for name, s in (("256^3 stream", stream), *syn_streams.items(), *k1_only.items()):
        hk, sk = ed.hist_and_literals(s, radius)
        hp, sp = ed.hist_and_literals_plain(s, radius)
        torch.cuda.synchronize()
        hp = hp.cpu()
        err = max(max_abs_diff(hk, hp), max_abs_diff(sk, sp))
        check(err == 0 and torch.equal(hk, hp) and torch.equal(sk, sp),
              f"K1 {name}: differs from its plain version (max abs diff {err})")
        k1_err = max(k1_err, err)
        outside = outside_k1_window(hk, radius)
        check(name != "all outside the shared window" or outside == syn_n,
              f"K1 {name}: {outside} of {syn_n} symbols outside the shared window")
        print(f"K1 {name}: bit-equal to plain (n={s.numel()}, literals={sk.numel()}, "
              f"outside the shared window={outside})", flush=True)
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
        wk = ed.pack_bits(s, tc, tl, radius, nbits)
        wp = ed.pack_bits_plain(s, tc, tl, radius, nbits)
        torch.cuda.synchronize()
        err = max_abs_diff(wk, wp)
        check(err == 0 and torch.equal(wk, wp),
              f"K2+K3 {name}: differs from its plain version (max abs diff {err})")
        k2_err = max(k2_err, err)
        print(f"K2+K3 {name}: bit-equal to plain ({nbits} bits, {wk.numel()} words, "
              f"longest code {int(tl.max())} bits)", flush=True)
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
        return de._stream_bytes(words, nbits), codes, lens, lo, syms

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

    k4_err = kw_err = 0
    for name, (bits, codes, lens, lo, want_syms) in dec_cases.items():
        total = len(bits) * 8
        tabs = dec.build_decode_tables(codes, lens, lo, dev)
        stream_t = dec.upload_bytes(bits, dev, dec.PAD_BYTES)
        nwin = -(-total // dec.W_BITS)
        wstart = torch.arange(nwin, device=dev) * dec.W_BITS
        chained = name != "256^3 stream"
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
        k4_err = max(k4_err, err)
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
            kw_err = max(kw_err, err)
        what = (f"a first pass and a chained rescan of its {states[0][2]} bad windows, which "
                f"leaves {states[0][3]}" if chained
                else f"a first pass, which leaves {states[0][2]} bad windows")
        print(f"K4 huff_scan, huff_write {name}: bit-equal to plain over {what}, and the "
              f"write phase on both sets of runs ({nwin} windows, codes of "
              f"{int(lens[lens > 0].min())}-{int(lens.max())} bits, {tabs.sub_len.numel()} second-table "
              f"entries)", flush=True)
        if want_syms is not None:
            stats = {}
            dense = dec.decode_stream(bits, len(want_syms), codes, lens, lo, dev, stats)
            check(np.array_equal(dense.cpu().numpy(), want_syms),
                  f"decode_stream {name}: not the stream's symbols")
            print(f"  decode_stream == the {len(want_syms)} symbols in {stats['passes']} passes "
                  f"over {stats['redo_counts']} windows", flush=True)
            del dense
        del states, st, wk, wp
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
        dconf, tree, de._stream_bytes(ed.pack_bits(ds, tc, tl, radius, nbits), nbits), nbits,
        deep_n, edge_rng.standard_normal(anchors.numel()).astype(np.float32), 1 << 40)
    blob = szp.pack_archive(dconf, payload)
    out, _ = szp.decompress(blob, device="cuda")
    check(out.cpu().numpy().tobytes() == native_decompress(blob).tobytes(),
          "codes over 32 bits: decode not bit-equal to the host engine's")
    print(f"edge codes over 32 bits ({deep_n} symbols, longest code {int(tl.max())} "
          f"bits): decode on the card bit-equal to the host engine's", flush=True)
    del ds, tc, tl, out, deep_bins, anchors, at_anchor, hist, slots
    torch.cuda.empty_cache()

    stamp("phase 3 done")

    # ---- phase 4: the main path ---------------------------------------------------
    # launches are counted over the compress/decompress calls only: the
    # counters are zeroed just before them and read just after
    counters = {"hist_literals": ed.hist_and_literals, "pack_bits": ed.pack_bits,
                "huff_scan": dec.scan_windows, "huff_write": dec.write_windows}
    launches = dict.fromkeys(counters, 0)

    def drive(fn):
        """Run one piece of the main path with every launch count set to 0
        just before it and read just after."""
        for w in counters.values():
            w.launches = 0
        out = sync_time(fn)
        seen = {k: w.launches for k, w in counters.items()}
        for k, v in seen.items():
            launches[k] += v
        return out, seen
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
        check(enc_seen["hist_literals"] == 1 and enc_seen["pack_bits"] >= 1,
              f"{n}^3 compress launched {enc_seen}")
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

        # where the encode time goes: the stages of compress, one by one
        c, tune_s = sync_time(lambda: tuned_conf(data))
        x, up_s = sync_time(lambda: torch.from_numpy(data.reshape(c.dims)).to(dev))
        plan = de.plan_for(c)
        perm = de.perm_for(c, dev)
        (bins_list, b0), pass_s = sync_time(lambda: encode_grid_fast(x, plan)[:2])
        pass_ms = event_ms(lambda: encode_grid_fast(x, plan), reps=3)
        stream, gather_s = sync_time(lambda: stream_order.to_stream(
            bins_to_grid(bins_list, plan, b0, dev), perm))
        rad = c.quantbinCnt // 2
        (hist, slots), k1_s = sync_time(lambda: ed.hist_and_literals(stream, rad))
        (tree, nbits, tc, tl), tree_s = sync_time(
            lambda: de._tree_and_tables(hist, rad, stream.numel(), dev))
        words, k2_s = sync_time(lambda: ed.pack_bits(stream, tc, tl, rad, nbits))
        (bits, unpred), d2h_s = sync_time(lambda: (
            de._stream_bytes(words, nbits),
            stream_order.literal_values(x, perm, slots).cpu().numpy()))
        payload, seal_s = sync_time(lambda: runtime.interp_seal_packed(
            c, tree, bits, nbits, stream.numel(), unpred, 1 << 40))
        _, payload_native = szp.open_archive(blob_native)
        check(payload == payload_native, f"{n}^3 staged payload differs")
        print(f"  encode stages (s): host tune {tune_s:.3f}, upload {up_s:.3f}, "
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
            dec.upload_bytes(unpred.data, dev)[:unpred.nbytes].view(torch.float32)))
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
    check("jax" not in sys.modules, "jax was imported")
    check(not any(m == "sz3_tpu" or m.startswith("sz3_tpu.") for m in sys.modules),
          "the JAX package was imported")

    def row(name, source, replaces, err, ms, plain_ms, bnd, library_ms, **extra):
        return {"name": name, "route": "cuda", "source": f"sz3_tpu_torch/csrc/{source}",
                "replaces": replaces, **extra, "launches": launches[name], "max_abs_err": err,
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
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
