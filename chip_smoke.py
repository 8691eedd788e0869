#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sz3_tpu_torch) once on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each unguarded (a failure raises and the script exits non-zero):
  1. the card's name and power limit; the host engine and the CUDA kernels
     built from this checkout's sources, with their build times;
  2. each kernel against its plain PyTorch version on the card, bit for bit,
     on the stream-order bins of the 256^3 field and on synthetic streams
     (zeros, SENTINELs, symbols across the quantizer's whole range, and a
     Fibonacci histogram whose Huffman codes exceed 32 bits), and their
     times (CUDA events, after a warm-up, in the order plain, kernel,
     kernel, plain);
  3. the inputs the JAX package sends to the host (no anchor grid, bins far
     from radius) compressed on the card, archives sha256-equal to the host
     engine's;
  4. the main path: sz3_tpu_torch.compress / decompress on the card at
     ABS 1e-3 with the default Config (tuner on), on bench.nyx_like(256) and
     nyx_like(512). The archives must be sha256-equal to the host engine's,
     the decodes bit-equal to its decode and within the bound, and every
     kernel launched. Wall times, where the encode and decode time goes, and
     the card's busy time over one warm encode and decode (torch.profiler).
The host engine's archives are made by sz3_tpu_torch.build.host_engine()
(the engine the port shares) inside the port's own container helpers.
The last line is {"ok": true, "device": {...}}; the line before it lists the
kernels. Without a CUDA device, or without the repository beside it, the
script prints no result and exits 2.
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
    from sz3_tpu_torch.algos import device_encode as de
    from sz3_tpu_torch.algos import torch_backend
    from sz3_tpu_torch.api import archive_conf
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

    def sync_time(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def event_ms(fn, reps=REPS):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / reps

    def paired_ms(kernel, plain):
        p1 = event_ms(plain)
        k1 = event_ms(kernel)
        k2 = event_ms(kernel)
        p2 = event_ms(plain)
        return (k1 + k2) / 2, (p1 + p2) / 2, [p1, k1, k2, p2]

    def busy(fn):
        """(device busy ms, profiled wall ms, device events) over one call:
        the union of the intervals of every kernel, copy and fill the
        profiler saw on the card."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        total, end = 0.0, float("-inf")
        for s, e in spans:
            if e > end:
                total += e - max(s, end)
                end = e
        return total / 1e3, wall * 1e3, len(spans)

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
    win_lo = max(2, radius + 1 - ed.W_HALF)

    k1_err = 0
    for name, s in (("256^3 stream", stream), *syn_streams.items()):
        hk, sk = ed.hist_and_literals(s, radius)
        hp, sp = ed.hist_and_literals_plain(s, radius)
        torch.cuda.synchronize()
        err = max(max_abs_diff(hk, hp), max_abs_diff(sk, sp))
        check(err == 0 and torch.equal(hk, hp) and torch.equal(sk, sp),
              f"K1 {name}: differs from its plain version (max abs diff {err})")
        k1_err = max(k1_err, err)
        outside = int(hk[2:].sum() - hk[win_lo:win_lo + 2 * ed.W_HALF].sum())
        print(f"K1 {name}: bit-equal to plain (n={s.numel()}, literals={sk.numel()}, "
              f"outside the shared window={outside})", flush=True)

    tables = {"256^3 stream": (stream,) + de._tree_and_tables(
        ed.hist_and_literals(stream, radius)[0], radius, num)}
    for name, s in syn_streams.items():
        h, _ = ed.hist_and_literals(s, radius)
        tables[name] = (s,) + de._tree_and_tables(h, radius, int(s.numel() - int(h[1])))
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
    print(f"K1 hist_literals at 256^3: kernel {k1_ms:.3f} ms, plain {k1_plain_ms:.3f} ms "
          f"(plain,kernel,kernel,plain = {[round(v, 3) for v in k1_runs]})", flush=True)
    print(f"K2+K3 pack_bits at 256^3: kernel {k2_ms:.3f} ms, plain {k2_plain_ms:.3f} ms "
          f"(plain,kernel,kernel,plain = {[round(v, 3) for v in k2_runs]})", flush=True)
    del x, stream, syn_streams, tables, tc, tl
    torch.cuda.empty_cache()

    # ---- phase 3: inputs the JAX package hands to the host ----------------------
    edge_rng = np.random.default_rng(11)
    edges = {
        "no anchor grid (20^3)": (
            (np.cumsum(edge_rng.standard_normal((20, 20, 20)), axis=2) * 0.1).astype(np.float32),
            szp.Config(cmprAlgo=szp.ALGO.INTERP, absErrorBound=EB)),
        "bins far from radius (64^3 noise, ABS 1e-5)": (
            edge_rng.standard_normal((64, 64, 64)).astype(np.float32) * 0.2,
            szp.Config(cmprAlgo=szp.ALGO.INTERP, absErrorBound=1e-5)),
    }
    for name, (data, c) in edges.items():
        blob_native = native_compress(data, c)
        blob = szp.compress(data, c, device="cuda")
        check(hashlib.sha256(blob).hexdigest() == hashlib.sha256(blob_native).hexdigest(),
              f"{name}: archive sha256 differs from the host engine's")
        out, _ = szp.decompress(blob, device="cuda")
        check(np.array_equal(out.cpu().numpy().view(np.int32),
                             native_decompress(blob_native).view(np.int32)),
              f"{name}: decode not bit-equal to the host engine's")
        ec = c.copy()
        ec.set_dims(data.shape)
        torch_backend._resolve_anchor_stride(ec)
        h, _ = ed.hist_and_literals(stream_of(torch.from_numpy(data).to(dev), ec),
                                    ec.quantbinCnt // 2)
        wl = max(2, ec.quantbinCnt // 2 + 1 - ed.W_HALF)
        outside = int(h[2:].sum() - h[wl:wl + 2 * ed.W_HALF].sum())
        print(f"edge {name}: archive sha256 == host engine, decode bit-equal "
              f"(anchor stride {de.plan_for(ec).anchor_stride}, {outside} symbols outside "
              f"the shared window)", flush=True)

    # ---- phase 4: the main path ---------------------------------------------------
    # launches are counted over the compress/decompress calls only: the
    # counters are zeroed just before them and read just after
    launches = {"hist_literals": 0, "pack_bits": 0}
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
        ed.hist_and_literals.launches = 0
        ed.pack_bits.launches = 0
        blob_cold, enc_cold_s = sync_time(
            lambda: szp.compress(data, szp.Config(absErrorBound=EB), device="cuda"))
        blob_warm, enc_warm_s = sync_time(
            lambda: szp.compress(data, szp.Config(absErrorBound=EB), device="cuda"))
        (out, _), dec_s = sync_time(lambda: szp.decompress(blob_native, device="cuda"))
        launches["hist_literals"] += ed.hist_and_literals.launches
        launches["pack_bits"] += ed.pack_bits.launches
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
        print(f"  decode wall: port {dec_s:.3f} s ({mb / dec_s / 1e3:.3f} GB/s), "
              f"host engine {native_dec_s:.3f} s", flush=True)
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
            lambda: de._tree_and_tables(hist, rad, stream.numel()))
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
        del x, bins_list, stream, hist, slots, words, perm

        (stream_h, unpred_h), open_s = sync_time(
            lambda: runtime.interp_open(c, payload_native, np.float32))
        hperm = stream_order.host_perm(tuple(c.dims), int(c.interpAlgo), c.interpDirection,
                                       c.interpAnchorStride)
        (bins_np, lit_np), place_s = sync_time(lambda: runtime.perm_place(
            hperm, stream_h, unpred_h, tuple(c.dims), np.float32))
        (bins_d, lit_d), up2_s = sync_time(lambda: (torch.from_numpy(bins_np).to(dev),
                                                    torch.from_numpy(lit_np).to(dev)))

        def dec():
            return decode_grid_fast(grid_to_pass_slices(bins_d, plan),
                                    grid_to_pass_slices(lit_d, plan), plan,
                                    initial_literal(lit_d, plan), None, lit_d.dtype)

        _, dpass_s = sync_time(dec)
        dpass_ms = event_ms(dec, reps=3)
        print(f"  decode stages (s): host open {open_s:.3f}, host perm_place {place_s:.3f}, "
              f"upload {up2_s:.3f}, device passes {dpass_s:.3f} (events {dpass_ms / 1e3:.3f})",
              flush=True)
        del bins_d, lit_d, hperm, bins_np, lit_np
        torch.cuda.empty_cache()

        for label, fn in (("encode", lambda: szp.compress(data, szp.Config(absErrorBound=EB),
                                                          device="cuda")),
                          ("decode", lambda: szp.decompress(blob_native, device="cuda"))):
            busy_ms, wall_ms, events = busy(fn)
            share = f"{100 * busy_ms / wall_ms:.2f} %" if events else "not measured"
            print(f"  device busy, warm {label} under torch.profiler: {busy_ms:.2f} ms of "
                  f"{wall_ms:.2f} ms wall ({share}; {events} device events)", flush=True)
        print(f"  peak device memory from this size's first compress on "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        torch.cuda.empty_cache()

    print(f"main-path launches {launches}", flush=True)
    for k, v in launches.items():
        check(v >= 1, f"kernel {k} was not launched on the main path")
    check("jax" not in sys.modules, "jax was imported")

    kernels = [
        {"name": "hist_literals", "route": "cuda",
         "source": "sz3_tpu_torch/csrc/hist_literals.cu",
         "replaces": "sz3_tpu/ops/entropy_device.py:124",
         "launches": launches["hist_literals"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "pack_bits", "route": "cuda",
         "source": "sz3_tpu_torch/csrc/pack_bits.cu",
         "replaces": "sz3_tpu/ops/entropy_device.py:308",
         "also_replaces": "sz3_tpu/ops/entropy_device.py:484",
         "launches": launches["pack_bits"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
