"""On a CUDA card: each hand-written kernel equals its plain PyTorch version
bit for bit, and the port's archives equal the host engine's. The kernels
have no CPU mode, so without a card every test here skips.

Run on the card:  python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

import sz3_tpu_torch as szp
from sz3_tpu_torch import ALGO, Config
from sz3_tpu_torch.algos import device_encode as tde
from sz3_tpu_torch.algos.huffman import build_table
from sz3_tpu_torch.ops import entropy_decode as tdec
from sz3_tpu_torch.ops import entropy_device as ted

pytestmark = pytest.mark.cuda

RADIUS = 32768


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _stream(n, seed, spread=30.0, zeros=0.01, wide=0.0, sentinels=0.0):
    rng = np.random.default_rng(seed)
    b = (RADIUS + np.round(rng.standard_normal(n) * spread)).astype(np.int32)
    b[rng.random(n) < zeros] = 0
    b[rng.random(n) < sentinels] = ted.SENTINEL
    far = rng.random(n) < wide
    b[far] = rng.integers(1, 2 * RADIUS, int(far.sum()))
    return b


def _k1_matches_plain(b, radius):
    """K1 on the card equals its plain version; the histogram comes back on
    the host, the slots stay on the card."""
    h, s = ted.hist_and_literals(b, radius)
    hp, sp = ted.hist_and_literals_plain(b, radius)
    assert h.device.type == "cpu" and s.device == b.device
    assert torch.equal(h, hp.cpu()) and torch.equal(s, sp)


@pytest.mark.parametrize("n", [1, 255, 4097, 3_000_017])
@pytest.mark.parametrize("seed", [0, 1])
def test_hist_and_literals_matches_plain(dev, n, seed):
    b = torch.from_numpy(_stream(n, seed, wide=0.01 * seed, sentinels=0.01)).to(dev)
    _k1_matches_plain(b, RADIUS)
    if n > 1:               # bins that do not start on a 16-byte boundary
        _k1_matches_plain(b[1:], RADIUS)


@pytest.mark.parametrize("radius", [1, 100, 8000, 1 << 20])
def test_hist_window_edges(dev, radius):
    """Small radii put the shared window over the whole index space; large
    ones leave most symbols to the cold path's global atomics."""
    rng = np.random.default_rng(radius)
    b = torch.from_numpy(rng.integers(-2, 2 * radius + 2, 200_003).astype(np.int32)).to(dev)
    _k1_matches_plain(b, radius)


def _k1_stream(name, n, rng):
    if name == "constant":                  # one symbol: the most contention
        return np.full(n, RADIUS, np.int32)
    if name == "all_zero":                  # every slot a literal
        return np.zeros(n, np.int32)
    if name == "alternating":
        return np.where(np.arange(n) % 2 == 0, RADIUS, RADIUS + 1).astype(np.int32)
    if name == "all_outside":               # no symbol in the shared window
        near = RADIUS - ted.W_HALF
        b = rng.integers(RADIUS + ted.W_HALF + 1, 2 * RADIUS + 5, n)
        low = rng.random(n) < 0.5
        b[low] = rng.integers(-4, near - 1, int(low.sum()))
        b[(b == 0) | (b == ted.SENTINEL)] = 2 * RADIUS + 3      # the invalid bucket
        return b.astype(np.int32)
    return _stream(n, int(rng.integers(1 << 30)), spread=300.0, sentinels=0.01)


@pytest.mark.parametrize("name", ["constant", "all_zero", "alternating", "all_outside"])
def test_hist_and_literals_edge_streams(dev, name):
    _k1_matches_plain(torch.from_numpy(_k1_stream(name, 3_000_017, np.random.default_rng(2)))
                      .to(dev), RADIUS)


@pytest.mark.parametrize("unit,delta", [("one", 0), ("tile", -1), ("tile", 0), ("tile", 1),
                                        ("grid", -1), ("grid", 0), ("grid", 1)])
@pytest.mark.parametrize("name", ["constant", "all_zero", "peaked"])
def test_hist_and_literals_tile_and_grid_edges(dev, unit, delta, name):
    """n = 1, n at a tile's end and at the end of one round of the
    persistent blocks, each +-1."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = {"one": 1, "tile": ted._K1_TILE,
         "grid": ted._k1_grid(1 << 30, sms)[1] * ted._K1_TILE}[unit] + delta
    _k1_matches_plain(torch.from_numpy(_k1_stream(name, n, np.random.default_rng(n))).to(dev),
                      RADIUS)


@pytest.mark.parametrize("n,spread,wide", [(1, 30.0, 0.0), (4097, 30.0, 0.0),
                                           (3_000_017, 300.0, 0.0), (2_000_003, 3000.0, 0.0),
                                           (2_000_003, 30.0, 0.02)])
def test_pack_bits_matches_plain(dev, n, spread, wide):
    b = torch.from_numpy(_stream(n, 5, spread=spread, wide=wide, sentinels=0.01)).to(dev)
    hist, _ = ted.hist_and_literals(b, RADIUS)
    _tree, total, tc, tl = tde._tree_and_tables(hist, RADIUS,
                                                int((b != ted.SENTINEL).sum()), dev)
    w = ted.pack_bits(b, tc, tl, RADIUS, total)
    assert torch.equal(w, ted.pack_bits_plain(b, tc, tl, RADIUS, total))


def test_pack_bits_codes_up_to_64_bits(dev):
    rng = np.random.default_rng(9)
    b = torch.from_numpy(_stream(1_000_003, 9, spread=3000.0, wide=0.05)).to(dev)
    tl = torch.from_numpy(rng.integers(0, 65, ted.table_len(RADIUS)).astype(np.int32)).to(dev)
    tc = torch.from_numpy(rng.integers(-2 ** 63, 2 ** 63 - 1, ted.table_len(RADIUS),
                                       dtype=np.int64)).to(dev)
    total = int(tl.to(torch.int64)[ted._sym_index(b, RADIUS).long()].sum())
    w = ted.pack_bits(b, tc, tl, RADIUS, total)
    assert torch.equal(w, ted.pack_bits_plain(b, tc, tl, RADIUS, total))


@pytest.mark.parametrize("n,lo,hi", [(3 * 2048, 33, 64), (2048, 64, 64),
                                     (2 * 2048 + 8 * 37 + 5, 1, 40), (5, 1, 64),
                                     (1_000_003, 0, 3)])
def test_pack_bits_tile_edges(dev, n, lo, hi):
    """Whole tiles of 33-64 bit codes (the most the kernel's shared buffer
    holds), a stream that ends inside a thread's run of 8 symbols, and codes
    so short that many threads share one word."""
    rng = np.random.default_rng(n + hi)
    tbl = ted.table_len(RADIUS)
    tl = torch.from_numpy(rng.integers(lo, hi + 1, tbl).astype(np.int32)).to(dev)
    tc = torch.from_numpy(rng.integers(-2 ** 63, 2 ** 63 - 1, tbl, dtype=np.int64)).to(dev)
    b = torch.from_numpy(rng.integers(1, 2 * RADIUS, n).astype(np.int32)).to(dev)
    total = int(tl.to(torch.int64)[ted._sym_index(b, RADIUS).long()].sum())
    w = ted.pack_bits(b, tc, tl, RADIUS, total)
    assert torch.equal(w, ted.pack_bits_plain(b, tc, tl, RADIUS, total))
    # bins that do not start on a 16-byte boundary take the scalar loads
    if n > 8:
        total = int(tl.to(torch.int64)[ted._sym_index(b[1:], RADIUS).long()].sum())
        w = ted.pack_bits(b[1:], tc, tl, RADIUS, total)
        assert torch.equal(w, ted.pack_bits_plain(b[1:], tc, tl, RADIUS, total))


def test_launches_count_and_no_cpu_fallback(dev):
    b = torch.from_numpy(_stream(10_000, 3)).to(dev)
    before = (ted.hist_and_literals.launches, ted.pack_bits.launches)
    hist, _ = ted.hist_and_literals(b, RADIUS)
    _tree, total, tc, tl = tde._tree_and_tables(hist, RADIUS, b.numel(), dev)
    ted.pack_bits(b, tc, tl, RADIUS, total)
    assert (ted.hist_and_literals.launches, ted.pack_bits.launches) == \
        (before[0] + 1, before[1] + 1)
    # the plain versions never count
    ted.hist_and_literals(b.cpu(), RADIUS)
    assert ted.hist_and_literals.launches == before[0] + 1


def test_compress_launches_k1_once_and_reads_it_back_once(dev, monkeypatch):
    """A main-path compress launches K1 once and reads its results back to
    the host once: inside K1's wrapper and the tree build that takes its
    histogram, the host waits for the card once, and no CUDA tensor is read
    back any other way."""
    counts = {"waits": 0, "other read-backs": 0}
    inside = [False]

    def counted(real):
        def wait(*a, **k):
            counts["waits"] += inside[0]
            return real(*a, **k)
        return wait

    monkeypatch.setattr(torch.cuda.Stream, "synchronize", counted(torch.cuda.Stream.synchronize))
    monkeypatch.setattr(torch.cuda.Event, "synchronize", counted(torch.cuda.Event.synchronize))
    monkeypatch.setattr(torch.cuda, "synchronize", counted(torch.cuda.synchronize))
    for name in ("cpu", "item", "tolist", "numpy", "to", "__int__", "__index__", "__bool__",
                 "__float__"):
        def spy(self, *a, _real=getattr(torch.Tensor, name), **k):
            out = _real(self, *a, **k)
            if inside[0] and self.is_cuda and not (isinstance(out, torch.Tensor) and out.is_cuda):
                counts["other read-backs"] += 1
            return out

        monkeypatch.setattr(torch.Tensor, name, spy)

    def watched(real):
        def call(*a, **k):
            inside[0] = True
            try:
                return real(*a, **k)
            finally:
                inside[0] = False
        return call

    class EntropyDevice:            # the encode's `ed`, with K1's wrapper watched
        hist_and_literals = staticmethod(watched(ted.hist_and_literals))

        def __getattr__(self, name):
            return getattr(ted, name)

    monkeypatch.setattr(tde, "ed", EntropyDevice())
    monkeypatch.setattr(tde, "_tree_and_tables", watched(tde._tree_and_tables))
    rng = np.random.default_rng(4)
    x = (np.cumsum(rng.standard_normal((64, 64, 64)).astype(np.float32), axis=-1) * 0.1)
    launches = ted.hist_and_literals.launches
    szp.compress(x, Config(cmprAlgo=ALGO.INTERP, absErrorBound=1e-3), device=dev)
    monkeypatch.undo()
    assert counts == {"waits": 1, "other read-backs": 0}
    assert ted.hist_and_literals.launches == launches + 1


@pytest.mark.parametrize("shape,algo,eb", [((33, 37, 41), 1, 1e-3), ((64, 64, 64), 0, 1e-3),
                                           ((33, 34, 35, 20), 1, 1e-3), ((20, 20, 20), 1, 1e-3),
                                           ((48, 40, 40), 1, 1e-6)])
def test_archives_match_host_engine(dev, shape, algo, eb):
    # the port's own engine: a machine with a card need not be able to build
    # the JAX package's (tests/test_torch_copies.py holds the two equal)
    from sz3_tpu_torch import runtime

    rng = np.random.default_rng(1)
    x = (np.cumsum(rng.standard_normal(shape).astype(np.float32), axis=-1) * 0.1)
    conf = Config(dims=shape, cmprAlgo=ALGO.INTERP, absErrorBound=eb, interpAlgo=algo)
    blob = szp.compress(x, conf, device=dev)
    c, cap = szp.api.archive_conf(x, conf)
    assert blob == szp.pack_archive(c, runtime.compress_payload(c, x, cap))
    out, _ = szp.decompress(blob, device=dev)
    assert out.device.type == "cuda"
    ref = runtime.decompress_payload(*szp.open_archive(blob))
    assert np.array_equal(out.cpu().numpy().view(np.int32), ref.view(np.int32))


# ---- the decode kernels (huff_scan counts, huff_write writes) ----------------------

DEC_RADIUS = 64


def _fib(k):
    f = [1, 1]
    while len(f) < k:
        f.append(f[-1] + f[-2])
    return f


def _coded_stream(freq, syms, lo=1):
    """A Huffman stream of the symbols `syms` under the reference tree of the
    counts `freq` (freq[s] = count of symbol lo + s; the stream itself need
    not follow them): (bits, exported codes, lens, offset, tree bytes)."""
    freq = np.asarray(list(freq) + [0], dtype=np.uint64)
    codes, lens, tree = build_table(lo, freq)
    tc = np.zeros(ted.table_len(DEC_RADIUS), np.int64)
    tl = np.zeros(ted.table_len(DEC_RADIUS), np.int32)
    s = np.arange(lo, lo + freq.size)
    tc[s + 1] = codes.view(np.int64)
    tl[s + 1] = lens
    bins = torch.from_numpy(np.asarray(syms, np.int32))
    total_bits = int(tl[np.asarray(syms) + 1].sum())
    words = ted.pack_bits_plain(bins, torch.from_numpy(tc), torch.from_numpy(tl), DEC_RADIUS,
                                total_bits)
    bits = words.numpy().view(np.uint32).byteswap().tobytes()[:(total_bits + 7) // 8]
    return bits, codes, lens, lo, tree


def _decode_cases():
    rng = np.random.default_rng(21)
    flat = [1000, 600, 350, 200, 120, 70, 40, 20, 10, 5, 2, 1]
    return {
        # a stream of 3 windows (the JAX package wants 64)
        "under_64_windows": (flat, rng.integers(0, len(flat), 900) + 1),
        # fewer bits than one window
        "one_window": (flat, rng.integers(0, len(flat), 40) + 1),
        # counts 2^k: code lengths 1, 2, 3, ..., and the 1-bit code is most of the stream
        "shortest_code_1_bit": ([2 ** k for k in range(20, 0, -1)],
                                np.minimum(rng.geometric(0.5, 30000), 20)),
        # Fibonacci counts: a tree 33 levels deep; every symbol in the stream
        "fibonacci_33_levels": (_fib(34), rng.integers(0, 34, 20000) + 1),
        # codes of up to 63 bits
        "fibonacci_63_levels": (_fib(64), rng.integers(0, 64, 20000) + 1),
        # eight codes of 3 bits: a walk that starts off the symbol lattice
        # never synchronises, so each validation pass proves one more window
        "never_synchronises": ([5] * 8, rng.integers(0, 8, 6000) + 1),
    }


def _two_passes(bits, codes, lens, lo, device, scan):
    """Zeroed scan state after one speculative pass of every window by `scan`,
    and again after a chained rescan of the windows that pass leaves bad."""
    total_bits = len(bits) * 8
    tables = tdec.build_decode_tables(codes, lens, lo, device)
    stream = tdec.upload_bytes(bits, device, tdec.PAD_BYTES)
    nwin = -(-total_bits // tdec.W_BITS)
    state = tdec.new_scan_state(nwin, device)
    for s in state:
        s.zero_()
    idx = torch.arange(nwin, dtype=torch.int32, device=device)
    starts = torch.zeros(nwin, dtype=torch.int32, device=device)
    starts[0] = tdec.RUN_BITS
    scan(stream, total_bits, tables, idx, starts, state)
    first = tdec.ScanState(*(s.clone() for s in state))
    wstart = idx.to(torch.int64) * tdec.W_BITS
    bad, want = tdec.bad_windows(state, wstart)
    idx = torch.nonzero(bad).reshape(-1)
    starts = (want[idx] - wstart[idx] + tdec.RUN_BITS).to(torch.int32)
    scan(stream, total_bits, tables, idx.to(torch.int32), starts, state, chain=True)
    return first, state, (stream, total_bits, tables)


@pytest.mark.parametrize("name", list(_decode_cases()))
def test_scan_and_compact_match_plain(dev, name):
    """The count phase (a first pass and a chained rescan) and the write
    phase, which does what the compaction did, against their plain versions."""
    freq, syms = _decode_cases()[name]
    bits, codes, lens, lo, _ = _coded_stream(freq, syms)
    k1, k, args = _two_passes(bits, codes, lens, lo, dev, tdec.scan_windows)
    p1, p, _ = _two_passes(bits, codes, lens, lo, dev, tdec.scan_windows_plain)
    for a, b in zip((*k1, *k), (*p1, *p)):
        assert torch.equal(a, b)
    # the runs of the first pass, mis-speculated windows and all, and of the rescan
    for st in (k1, k):
        n64 = st.nout.to(torch.int64)
        off = torch.cumsum(n64, 0) - n64
        count = int(n64.sum())
        assert torch.equal(tdec.write_windows(*args, st.entry, st.nout, off, count),
                           tdec.write_windows_plain(*args, st.entry, st.nout, off, count))
    before = (tdec.scan_windows.launches, tdec.write_windows.launches)
    stats = {}
    dense = tdec.decode_stream(bits, len(syms), codes, lens, lo, dev, stats)
    assert dense.device.type == "cuda"
    assert np.array_equal(dense.cpu().numpy(), syms)
    assert tdec.scan_windows.launches == before[0] + stats["passes"]
    assert tdec.write_windows.launches == before[1] + 1


def test_write_takes_symbols_outside_24_bits(dev):
    """Symbols below 0 or from 2^24 on: the kernel reads a code's symbol from
    an array of whole int32 values, not from beside its length."""
    freq, syms = _decode_cases()["fibonacci_33_levels"]
    for lo in (-7, (1 << 24) - 5):
        bits, codes, lens, _, _ = _coded_stream(freq, syms)
        dense = tdec.decode_stream(bits, len(syms), codes, lens, lo, dev)
        assert np.array_equal(dense.cpu().numpy(), syms - 1 + lo)


def test_f64_and_edge_archives_decode_on_the_card(dev):
    from sz3_tpu_torch import runtime

    rng = np.random.default_rng(6)
    cases = [(np.cumsum(rng.standard_normal((40, 41, 42)), axis=-1) * 0.1, 1e-6),
             (np.zeros((24, 20, 18), np.float32), 1e-3),
             ((np.cumsum(rng.standard_normal((20, 20, 20)), axis=2) * 0.1).astype(np.float32),
              1e-3)]
    for x, eb in cases:
        blob = szp.compress(x, Config(cmprAlgo=ALGO.INTERP, absErrorBound=eb), device=dev)
        conf, payload = szp.open_archive(blob)
        ref = runtime.decompress_payload(conf, payload)
        out, _ = szp.decompress(blob, device=dev)
        assert out.cpu().numpy().tobytes() == ref.tobytes()
