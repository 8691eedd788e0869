"""Per-stage device timings of the INTERP encode's entropy path (counterpart
of tools/profile_entropy.py), on the CUDA card by default.

Stages of algos/device_encode.pack_device, each timed cumulatively:
  S1  the INTERP predict+quantize passes (ops/interp_fast)
  S2  + the stream-order gather (bins grid -> archive order, ops/stream_order)
  S3  + K1 hist_literals (csrc/hist_literals.cu; the histogram read back)
  B   the host Huffman tree and code tables + K2+K3 pack_bits
      (csrc/pack_bits.cu)
On the card each stage is timed with CUDA events around the call (the best
of --reps); with --device cpu, on the host clock, with the kernels' plain
versions, and the printout says so. --trace DIR writes a torch.profiler
Chrome trace of one S3 and one B to DIR/trace.json.

Also prints the Huffman tree's statistics (the code-length distribution and
the escape prefixes), which size the decode's tables.

Usage: python -m sz3_tpu_torch.tools.profile_entropy [--n 256] [--eb 1e-3]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def nyx_like(n: int) -> np.ndarray:
    """The Nyx-like field of bench.py (multiscale waves + mild turbulence)."""
    rng = np.random.default_rng(42)
    ax = np.linspace(0, 1, n, dtype=np.float64)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    f = (np.sin(4 * np.pi * X) * np.cos(6 * np.pi * Y) * np.sin(2 * np.pi * Z)
         + 0.5 * np.sin(16 * np.pi * (X + Y)) + 0.25 * np.cos(32 * np.pi * (Y - Z)))
    f += 0.05 * np.cumsum(rng.standard_normal((n, n, n)), axis=2) / np.sqrt(n)
    return np.ascontiguousarray(np.exp(f), dtype=np.float32)


def clock_ms(fn, dev: torch.device, reps: int) -> float:
    """Best time of `reps` calls of fn, ms, after one warm call: CUDA events
    on the card, the host clock on the CPU."""
    fn()
    best = float("inf")
    for _ in range(reps):
        if dev.type == "cuda":
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            best = min(best, start.elapsed_time(stop))
        else:
            t = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t) * 1e3)
    return best


def tree_stats(hist: torch.Tensor, radius: int, num: int) -> dict:
    """Code-length distribution of the histogram's Huffman tree: max and
    stream-mean length, the stream share and count of codes longer than L,
    and for first-level tables of L1 bits the escape prefixes."""
    from ..algos import device_encode as de

    lo, _, freq = de.symbol_freq(hist, radius, num)
    codes, lens, _ = de._huffman_table(lo, freq)
    used = lens > 0
    lv = lens[used].astype(np.int64)
    fv = freq[used].astype(np.float64)
    cv = codes[used].astype(np.uint64)
    total = fv.sum()
    out = {"states": int(freq.size), "max_len": int(lv.max()),
           "mean_len": float((fv * lv).sum() / total), "longer_than": {}, "escapes": {}}
    for L in (8, 10, 11, 12, 13, 14, 16, 20, 24, 32):
        out["longer_than"][L] = (float(fv[lv > L].sum() / total), int((lv > L).sum()))
    for L1 in (10, 11, 12):
        deep = lv > L1
        if deep.any():
            pref = (cv[deep] << (64 - lv[deep]).astype(np.uint64)) >> np.uint64(64 - L1)
            out["escapes"][L1] = (len(np.unique(pref)), int((lv[deep] - L1).max()))
        else:
            out["escapes"][L1] = (0, 0)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="profile_entropy", description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--eb", type=float, default=1e-3)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--trace", default="", help="write a torch.profiler trace to this directory")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..algos import device_encode as de
    from ..api import _device
    from ..config import ALGO, Config
    from ..ops import entropy_device as ed
    from ..ops import stream_order
    from ..ops.interp_fast import bins_to_grid, encode_grid_fast

    dev = _device(args.device)
    where = (f"{torch.cuda.get_device_name(dev)}, CUDA events" if dev.type == "cuda"
             else "the CPU, host clock, the kernels' plain versions")
    data = nyx_like(args.n)
    nbytes = data.nbytes
    conf = Config(dims=data.shape, cmprAlgo=ALGO.INTERP, absErrorBound=args.eb)
    conf.interpAnchorStride = [4096, 128, 32, 16][conf.N - 1]
    plan = de.plan_for(conf)
    perm = de.perm_for(conf, dev)
    x = torch.from_numpy(data).to(dev)
    num = x.numel()
    log(f"field {data.shape} {nbytes / 1e6:.1f} MB on {where}")

    def s1():
        return encode_grid_fast(x, plan)

    def s2():
        bins_list, b0, _ = encode_grid_fast(x, plan)
        return stream_order.to_stream(bins_to_grid(bins_list, plan, b0, dev), perm)

    def s3():
        s = s2()
        return s, ed.hist_and_literals(s, plan.radius)

    stream, (hist, _) = s3()

    def b():
        _, total_bits, tc, tl = de._tree_and_tables(hist, plan.radius, num, dev)
        return ed.pack_bits(stream, tc, tl, plan.radius, total_bits)

    res = {"device": str(dev), "where": where, "n": args.n, "bytes": nbytes, "ms": {}}
    for name, fn in (("S1 quantize passes", s1), ("S2 + stream-order gather", s2),
                     ("S3 + K1 hist_literals", s3), ("B host tree + K2+K3 pack_bits", b)):
        ms = clock_ms(fn, dev, args.reps)
        res["ms"][name] = ms
        log(f"{name:32s} {ms:9.3f} ms   {nbytes / ms / 1e6:7.2f} GB/s")
    t = res["ms"]
    names = list(t)
    log(f"stage deltas: gather {t[names[1]] - t[names[0]]:.3f} ms, K1 "
        f"{t[names[2]] - t[names[1]]:.3f} ms; S3 + B {t[names[2]] + t[names[3]]:.3f} ms "
        f"-> {nbytes / (t[names[2]] + t[names[3]]) / 1e6:.2f} GB/s")

    st = tree_stats(hist, plan.radius, num)
    res["tree"] = st
    _, total_bits, _, _ = de._tree_and_tables(hist, plan.radius, num, dev)
    log(f"\nHuffman tree: {st['states']} states; code lengths max {st['max_len']}, "
        f"mean (stream) {st['mean_len']:.2f} bits; stream {total_bits / 8 / 1e6:.2f} MB packed")
    for L, (p, ncode) in st["longer_than"].items():
        log(f"  len > {L:2d}: stream share {p:9.2e}  ({ncode} codes)")
    for L1, (npref, rest) in st["escapes"].items():
        log(f"  L1={L1}: escape prefixes {npref}, max remaining bits {rest}")

    if args.trace:
        from ..utils import device_trace

        with device_trace(args.trace):
            s3()
            b()
        log(f"trace written to {args.trace}/trace.json")
    return res


if __name__ == "__main__":
    main()
