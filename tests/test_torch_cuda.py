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


# ---- LORENZO_REG: the element sweep -------------------------------------------------

def _sweep_case(shape, seed):
    """Random L1/L2/KEEP types, bins across the quantizer's whole range,
    values with NaN, Inf and subnormals, a reconstruction with kept cells."""
    from sz3_tpu_torch.ops import blockwise_wavefront as twf
    from sz3_tpu_torch.ops.blockwise_layout import Geometry

    rng = np.random.default_rng(seed)
    types = rng.integers(0, 3, shape).astype(np.uint8)
    bins = rng.integers(1, 2 * RADIUS, shape).astype(np.int32)
    bins[rng.random(shape) < 0.05] = 0
    vals = (np.cumsum(rng.standard_normal(shape), axis=2) * 0.01).astype(np.float32)
    flat = vals.reshape(-1)
    flat[::97] = np.nan
    flat[5::131] = np.inf
    flat[7::137] = -np.inf
    flat[11::139] = np.float32(3e-39)
    init = np.where(types == 2, vals + 0.5, 0).astype(np.float32)
    rec = twf.padded_grid(Geometry(shape, shape, shape), torch.from_numpy(init))
    return rec, *(torch.from_numpy(a) for a in (types, bins, vals))


@pytest.mark.parametrize("shape", [(1, 1, 1), (6, 6, 6), (12, 18, 6), (2, 40, 3), (37, 29, 45),
                                   (6, 30, 12), (66, 6, 126), (126, 66, 6)])
@pytest.mark.parametrize("eb", [1e-3, 1e-1])
def test_lorenzo_sweep_matches_plain(dev, shape, eb):
    """Both forms of the kernel equal their plain versions bit for bit, on
    grid edges and random types, grids thin in y and in z among them (the
    plane-major layout's rows); one launch counted per sweep."""
    from sz3_tpu_torch.ops import blockwise_wavefront as twf
    from sz3_tpu_torch.ops import blockwise_wavefront_encode as twfe

    rec, types, bins, vals = (t.to(dev) for t in _sweep_case(shape, sum(shape)))
    rk, rp = rec.clone(), rec.clone()
    before = twf.lorenzo_sweep.launches
    twf.sweep_decode(rk, types, bins, vals, eb, RADIUS)
    assert twf.lorenzo_sweep.launches == before + 1
    twf.sweep_decode_plain(rp, types, bins, vals, eb, RADIUS)
    assert torch.equal(rk.view(torch.int32), rp.view(torch.int32))
    rk, rp = rec.clone(), rec.clone()
    bk = twfe.sweep_encode(rk, types, vals, eb, RADIUS)
    bp = twfe.sweep_encode_plain(rp, types, vals, eb, RADIUS)
    assert torch.equal(bk, bp) and torch.equal(rk.view(torch.int32), rp.view(torch.int32))
    assert twf.lorenzo_sweep.launches == before + 2


@pytest.mark.parametrize("roster", [(True, False, True), (True, False, False),
                                    (False, False, True)])
@pytest.mark.parametrize("shape", [(18, 18, 18), (33, 6, 47), (64, 50, 37)])
def test_lorenzo_reg_archives_on_the_card(dev, roster, shape):
    """LORENZO_REG archives written on the card equal the host engine's, and
    decode on the card bit-equal to its decode, one sweep per pass."""
    from sz3_tpu_torch import runtime
    from sz3_tpu_torch.api import archive_conf
    from sz3_tpu_torch.ops import blockwise_wavefront as twf

    rng = np.random.default_rng(sum(shape))
    f = rng.standard_normal(shape).astype(np.float32)
    x = (np.cumsum(f, axis=0) * 0.1 + np.cumsum(f, axis=-1) * 0.05).astype(np.float32)
    conf = Config(cmprAlgo=ALGO.LORENZO_REG, absErrorBound=1e-2)
    conf.lorenzo, conf.lorenzo2, conf.regression = roster
    c, cap = archive_conf(x, conf)
    want = szp.pack_archive(c, runtime.compress_payload(c, x, cap))
    before = twf.lorenzo_sweep.launches
    blob = szp.compress(x, conf, device=dev)
    assert blob == want and twf.lorenzo_sweep.launches > before
    before = twf.lorenzo_sweep.launches
    out, dconf = szp.decompress(blob, device=dev)
    assert dconf.cmprAlgo == ALGO.LORENZO_REG and twf.lorenzo_sweep.launches == before + 1
    assert out.device.type == "cuda"
    ref = runtime.decompress_payload(*szp.open_archive(blob))
    assert out.cpu().numpy().tobytes() == ref.tobytes()


# ---- LORENZO_REG: the predictor selection ---------------------------------------------

SELECT_SHAPES = [(1, 1, 1), (6, 6, 6), (12, 18, 6), (20, 19, 17), (37, 29, 45), (13, 12, 12)]


def _select_case(shape, eb, taps, seed):
    """select's arguments on the CPU: the padded originals, the taps (the
    same tensor, or the originals moved by up to 2 eb), extents and fits.
    At 13 x 12 x 12, +Inf at the base of the extent-1 block (2, 0, 0), whose
    invalid regression then wins (no selection), and a NaN in block (0, 1, 1)."""
    from sz3_tpu_torch.ops import blockwise_layout as bl
    from sz3_tpu_torch.ops import blockwise_wavefront as twf
    from sz3_tpu_torch.ops import blockwise_wavefront_encode as twfe

    rng = np.random.default_rng(seed)
    f = rng.standard_normal(shape).astype(np.float32)
    x = (np.cumsum(f, axis=0) * 0.1 + np.cumsum(f, axis=-1) * 0.05).astype(np.float32)
    if shape == (13, 12, 12):
        x[12, 0, 0] = np.inf
        x[3, 7, 8] = np.nan
    geo = bl.geometry(shape)
    g = torch.zeros(geo.grid)
    g[:shape[0], :shape[1], :shape[2]] = torch.from_numpy(x)
    ex = bl.extents(geo, "cpu")
    raw = twfe.fits(bl.to_blocks(g, geo).t().contiguous(),
                    bl.to_blocks(bl.valid_cells(geo, "cpu"), geo).t().contiguous(),
                    ex.reshape(3, -1))
    orig_p = twf.padded_grid(geo, g)
    tap_p = orig_p if taps == "originals" else twf.padded_grid(geo, g + torch.from_numpy(
        rng.uniform(-2 * eb, 2 * eb, geo.grid).astype(np.float32)))
    return geo, orig_p, tap_p, ex, raw.reshape(4, *geo.nb)


@pytest.mark.parametrize("taps", ["originals", "perturbed"])
@pytest.mark.parametrize("eb", [1e-3, 1e-1])
@pytest.mark.parametrize("shape", SELECT_SHAPES)
def test_lorenzo_select_matches_plain(dev, shape, eb, taps):
    """The kernel's is_reg and ok equal select_plain's bit for bit, on the
    CPU and on the card, tail blocks, extents of 1 and non-finite data among
    them; the speculative call passes one tensor as both grids. One launch
    counted a call."""
    from sz3_tpu_torch.ops import blockwise_wavefront_encode as twfe

    geo, orig_p, tap_p, ex, coefs = _select_case(shape, eb, taps, sum(shape))
    want = twfe.select_plain(geo, orig_p, tap_p, ex, coefs, eb)
    o = orig_p.to(dev)
    t = o if tap_p is orig_p else tap_p.to(dev)
    ex_d, coefs_d = ex.to(dev), coefs.to(dev)
    before = twfe.select.launches
    got = twfe.select(geo, o, t, ex_d, coefs_d, eb)
    assert twfe.select.launches == before + 1
    on_card = twfe.select_plain(geo, o, t, ex_d, coefs_d, eb)
    for g, w, c in zip(got, want, on_card):
        assert g.dtype == torch.bool and g.device.type == "cuda"
        assert torch.equal(g.cpu(), w) and torch.equal(c.cpu(), w)
    if shape == (13, 12, 12):
        assert not bool(want[1].all())


def test_lorenzo_select_archive_on_the_card(dev):
    """A {L1, REG} compress of a 37 x 29 x 45 field on the card gives the
    host engine's archive; every lorenzo.select span takes the kernel route
    and one launch."""
    from sz3_tpu_torch import runtime
    from sz3_tpu_torch.api import archive_conf
    from sz3_tpu_torch.ops import blockwise_wavefront_encode as twfe
    from sz3_tpu_torch.utils import trace

    rng = np.random.default_rng(37)
    f = rng.standard_normal((37, 29, 45)).astype(np.float32)
    x = (np.cumsum(f, axis=0) * 0.1 + np.cumsum(f, axis=-1) * 0.05).astype(np.float32)
    conf = Config(cmprAlgo=ALGO.LORENZO_REG, absErrorBound=1e-2)
    c, cap = archive_conf(x, conf)
    want = szp.pack_archive(c, runtime.compress_payload(c, x, cap))
    before = twfe.select.launches
    trace.spans()
    trace.enable()
    try:
        blob = szp.compress(x, conf, device=dev)
    finally:
        trace.disable()
        spans = trace.spans()
    routes = [s.attrs["route"] for s in spans if s.name == "lorenzo.select"]
    assert blob == want
    assert len(routes) >= 2 and set(routes) == {"kernel"}
    assert twfe.select.launches == before + len(routes)


# ---- BIOMD: the frame recurrence ------------------------------------------------------

def _frames_case(frames, atoms, site, seed):
    """A molecule-like trajectory of `site`-atom molecules with NaN, Inf,
    subnormal and huge values, its frame-0 reconstruction from the host
    engine, and bins and literals across the quantizer's range."""
    from sz3_tpu_torch import runtime

    rng = np.random.default_rng(seed)
    g = -(-atoms // site)
    base = np.repeat(rng.uniform(-5, 5, (g, 1, 3)), site, axis=1).reshape(-1, 3)[:atoms]
    traj = (base[None] + np.cumsum(rng.normal(0, 0.01, (frames, atoms, 3)), axis=0))
    traj = traj.astype(np.float32)
    flat = traj[1:].reshape(-1)
    flat[::97] = np.nan
    flat[5::131] = np.inf
    flat[7::137] = -np.inf
    flat[11::139] = np.float32(3e-39)
    flat[13::149] = np.float32(2.0 ** 40)
    _, recon0, _ = runtime.biomd_frame0(1e-3, RADIUS, site, traj[0])
    bins = rng.integers(1, 2 * RADIUS, (frames - 1, atoms, 3)).astype(np.int32)
    bins[rng.random(bins.shape) < 0.05] = 0
    return traj[1:], recon0, bins


@pytest.mark.parametrize("atoms,site", [(1, 3), (2, 3), (3, 3), (7, 3), (332, 4), (1001, 10),
                                        (64, 5), (9999, 3)])
@pytest.mark.parametrize("eb", [1e-3, 1e-1])
def test_biomd_frames_matches_plain(dev, atoms, site, eb):
    """Both forms of the kernel equal their plain versions bit for bit:
    atoms not a multiple of site (padded lanes, a last molecule of one or
    two atoms), every site from 3 to 10, special values; one launch a
    call, which the plain versions do not count."""
    from sz3_tpu_torch.ops import biomd_device as tbd

    x, recon0, bins = _frames_case(9, atoms, site, atoms + site)
    x, recon0, bins = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                       for a in (x, recon0, bins))
    before = tbd.biomd_frames.launches
    bk = tbd.frames_encode(x, recon0, eb, RADIUS, site)
    assert tbd.biomd_frames.launches == before + 1
    bp = tbd.frames_encode_plain(x, recon0, eb, RADIUS, site)
    assert torch.equal(bk, bp)
    for b in (bk, bins):
        lits = torch.where(b == 0, x, 0.0)
        rk = tbd.frames_recover(b, lits, recon0, eb, RADIUS, site)
        rp = tbd.frames_recover_plain(b, lits, recon0, eb, RADIUS, site)
        assert torch.equal(rk.view(torch.int32), rp.view(torch.int32))
    assert tbd.biomd_frames.launches == before + 3
    tbd.frames_encode(x.cpu(), recon0.cpu(), eb, RADIUS, site)
    assert tbd.biomd_frames.launches == before + 3


@pytest.mark.parametrize("algo,kw", [("BIOMD", dict()), ("BIOMD", dict(fill_tail=8, frames=32)),
                                     ("BIOMD", dict(site_atoms=4, atoms=332)),
                                     ("BIOMDXTC", dict()), ("BIOMDXTC", dict(fill_tail=6))])
def test_biomd_archives_on_the_card(dev, algo, kw):
    """BIOMD and BIOMDXTC archives written on the card equal the host
    engine's and decode on the card bit-equal to its decode; BIOMD launches
    the recurrence once each way."""
    from sz3_tpu_torch import runtime
    from sz3_tpu_torch.api import archive_conf
    from sz3_tpu_torch.ops import biomd_device as tbd

    rng = np.random.default_rng(0)
    atoms, site, frames = kw.get("atoms", 333), kw.get("site_atoms", 3), kw.get("frames", 24)
    g = atoms // site + 1
    base = rng.uniform(-5, 5, (g, 1, 3)).repeat(site, axis=1)
    base = (base + rng.normal(0, 0.05, (g, site, 3))).reshape(-1, 3)[:atoms]
    x = (base[None] + np.cumsum(rng.normal(0, 0.01, (frames, atoms, 3)), axis=0))
    x = x.astype(np.float32)
    if kw.get("fill_tail"):
        x[-kw["fill_tail"]:] = -1.0
    conf = Config(cmprAlgo=getattr(ALGO, algo), absErrorBound=1e-3)
    c, cap = archive_conf(x, conf)
    want = szp.pack_archive(c, runtime.compress_payload(c, x, cap))
    before = tbd.biomd_frames.launches
    assert szp.compress(x, conf, device=dev) == want
    out, _ = szp.decompress(want, device=dev)
    assert out.device.type == "cuda"
    assert tbd.biomd_frames.launches == before + (2 if algo == "BIOMD" else 0)
    ref = runtime.decompress_payload(*szp.open_archive(want))
    assert out.cpu().numpy().tobytes() == ref.tobytes()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_nopred_and_chunked_archives_on_the_card(dev, dtype):
    """NOPRED (symbols past K1's shared window among them) and an
    OpenMP-format archive, written and read on the card, equal the host
    engine's."""
    from sz3_tpu_torch import runtime
    from sz3_tpu_torch.api import archive_conf

    rng = np.random.default_rng(2)
    x = np.exp(rng.uniform(-1.75, 1.75, (40, 50, 60))).astype(dtype)
    for conf, n in ((Config(cmprAlgo=ALGO.NOPRED, absErrorBound=1e-3), 0),
                    (Config(absErrorBound=1e-3, openmp=True), 6)):
        c, cap = archive_conf(x, conf)
        want = szp.pack_archive(c, runtime.compress_payload(c, x, cap, nthreads=n))
        before = ted.hist_and_literals.launches
        assert szp.compress(x, conf, device=dev, nthreads=n) == want
        assert ted.hist_and_literals.launches > before
        out, _ = szp.decompress(want, device=dev)
        ref = runtime.decompress_payload(*szp.open_archive(want))
        assert out.device.type == "cuda" and out.cpu().numpy().tobytes() == ref.tobytes()


# ---- MDZ: the VQT / MT frame recurrence, and the device tuner ----------------------

def _mdz_frames_case(frames, atoms, seed):
    """Frames of atoms drifting around random levels with NaN, Inf,
    subnormal and huge values, a frame-0 reconstruction, and bins (atom,
    frame) across the quantizer's range."""
    rng = np.random.default_rng(seed)
    x = (rng.uniform(-5, 5, atoms)[None]
         + np.cumsum(rng.normal(0, 0.01, (frames, atoms)), axis=0)).astype(np.float32)
    flat = x[1:].reshape(-1)
    flat[::97] = np.nan
    flat[5::131] = np.inf
    flat[7::137] = -np.inf
    flat[11::139] = np.float32(3e-39)
    flat[13::149] = np.float32(2.0 ** 40)
    recon0 = x[0] + np.float32(1e-4)
    bins = rng.integers(1, 2 * RADIUS, (atoms, frames - 1)).astype(np.int32)
    bins[rng.random(bins.shape) < 0.05] = 0
    return x[1:], recon0, bins


@pytest.mark.parametrize("frames,atoms", [(2, 1), (9, 31), (100, 257), (33, 10001)])
@pytest.mark.parametrize("eb", [1e-3, 1e-1, float("inf")])
def test_mdz_frames_matches_plain(dev, frames, atoms, eb):
    """Both forms of the kernel equal their plain versions bit for bit, on
    special values, on bins across the range, and under an infinite bound;
    one launch a call, which the plain versions do not count."""
    from sz3_tpu_torch.ops import mdz_device as tmd

    x, recon0, bins = _mdz_frames_case(frames, atoms, frames + atoms)
    x, recon0, bins = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                       for a in (x, recon0, bins))
    before = tmd.mdz_frames.launches
    bk = tmd.frames_encode(x, recon0, eb, RADIUS)
    assert tmd.mdz_frames.launches == before + 1
    assert torch.equal(bk, tmd.frames_encode_plain(x, recon0, eb, RADIUS))
    for b in (bk, bins):
        unpred = x.t().reshape(-1)[(b.reshape(-1) == 0).nonzero().reshape(-1)]
        starts = tmd.literal_starts(b, unpred.numel())
        rk = tmd.frames_recover(b, unpred, starts, recon0, eb, RADIUS)
        rp = tmd.frames_recover_plain(b, unpred, starts, recon0, eb, RADIUS)
        assert torch.equal(rk.view(torch.int32), rp.view(torch.int32))
    assert tmd.mdz_frames.launches == before + 3
    tmd.frames_encode(x.cpu(), recon0.cpu(), eb, RADIUS)
    assert tmd.mdz_frames.launches == before + 3


def test_mdz_frames_reads_no_literal_past_its_buffer(dev):
    """Literal slots past the literals read as NaN in the recover form, not
    past the buffer."""
    from sz3_tpu_torch.ops import mdz_device as tmd

    x, recon0, bins = _mdz_frames_case(9, 300, 5)
    x, recon0, bins = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                       for a in (x, recon0, bins))
    unpred = x.t().reshape(-1)[(bins.reshape(-1) == 0).nonzero().reshape(-1)]
    starts = tmd.literal_starts(bins, unpred.numel()) + unpred.numel()
    rk = tmd.frames_recover(bins, unpred, starts, recon0, 1e-3, RADIUS)
    assert bool(torch.isnan(rk.t()[bins == 0]).all())


@pytest.mark.parametrize("method,kw", [("VQT", dict(rel_eb=1e-3)), ("MT", dict(abs_eb=1e-3)),
                                       ("ADP", dict(rel_eb=1e-3, batch_size=40)),
                                       ("VQ", dict(rel_eb=1e-3)), ("LR", dict(rel_eb=1e-3))])
@pytest.mark.parametrize("ndim", [2, 3])
def test_mdz_archives_on_the_card(dev, method, kw, ndim):
    """MDZ archives written on the card equal the host engine's, and decode
    on the card bit-equal to its decode; VQT and MT launch the recurrence."""
    from sz3_tpu_torch import mdz as tmdz
    from sz3_tpu_torch.ops import mdz_device as tmd

    rng = np.random.default_rng(ndim)
    shape = (120, 700) if ndim == 2 else (60, 300, 3)
    levels = rng.integers(0, 12, shape[1:]) * 1.5
    x = (levels[None] + rng.normal(0, 0.05, shape)).astype(np.float32)
    want = tmdz.engine_compress(x, kw.get("abs_eb"), kw.get("rel_eb"), kw.get("batch_size", 0),
                                tmdz.METHODS[method], 1024)
    before = tmd.mdz_frames.launches
    assert tmdz.mdz_compress(x, method=method, device=dev, **kw) == want
    out = tmdz.mdz_decompress(want, device=dev)
    assert out.device.type == "cuda"
    assert out.cpu().numpy().tobytes() == tmdz.engine_decompress(want).tobytes()
    if method in ("VQT", "MT"):
        assert tmd.mdz_frames.launches >= before + 2


@pytest.mark.parametrize("eb", [1e-2, 1e-4])
def test_tuner_decisions_on_the_card(dev, eb):
    """The device tuner's trials on the card take the host engine's
    decisions on tests/test_tuner.py's fields."""
    from test_tuner import FIELDS

    from sz3_tpu_torch import runtime
    from sz3_tpu_torch.algos import tuner

    for name, data in FIELDS.items():
        a = Config(dims=data.shape, cmprAlgo=ALGO.INTERP_LORENZO, absErrorBound=eb)
        b = Config(dims=data.shape, cmprAlgo=ALGO.INTERP_LORENZO, absErrorBound=eb)
        assert tuner.tune(a, data.copy(), dev)
        runtime.tune_interp(b, data.copy())
        for f in ("cmprAlgo", "interpAlgo", "interpDirection", "interpAlpha", "interpBeta"):
            assert float(getattr(a, f)) == float(getattr(b, f)), (name, f)


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype,mode", [(np.float32, "ABS"), (np.float64, "ABS"),
                                        (np.float32, "REL")])
def test_serving_pipeline_on_the_card(dev, monkeypatch, depth, dtype, mode):
    """compress_batch's streamed pipeline at depth 1-4 gives, field by field,
    the archives of single-field compress on the card (at ABS a noise field
    in the middle and last take the lossless route), each field's device half on
    a stream of its own; decompress_batch returns the stack on the card,
    bit-equal to single-field decompress."""
    from sz3_tpu_torch import serving

    rng = np.random.default_rng(depth)
    fields = np.cumsum(rng.standard_normal((6, 33, 34, 35)), axis=-1).astype(dtype) * 0.1
    fields[2] = rng.uniform(-1e4, 1e4, fields[2].shape)
    fields[5] = rng.uniform(-1e4, 1e4, fields[5].shape)
    conf = Config(cmprAlgo=ALGO.INTERP, absErrorBound=1e-3, relErrorBound=1e-3,
                  errorBoundMode=getattr(szp.EB, mode))
    streams = []
    real = tde.pack_device
    monkeypatch.setattr(tde, "pack_device", lambda c, x: streams.append(
        torch.cuda.current_stream().cuda_stream) or real(c, x))
    monkeypatch.setattr(serving, "DEPTH", depth)
    blobs = serving.compress_batch(fields, conf, device="cuda")
    assert len(streams) == 6 and len(set(streams)) == depth
    assert torch.cuda.current_stream().cuda_stream not in streams
    monkeypatch.setattr(tde, "pack_device", real)
    for i, f in enumerate(fields):
        assert blobs[i] == szp.compress(f, conf.copy(), device="cuda"), f"field {i}"
    if mode == "ABS":
        assert [szp.open_archive(b)[0].cmprAlgo for b in blobs].count(ALGO.LOSSLESS) == 2
    out = serving.decompress_batch(blobs, device="cuda")
    assert out.device.type == "cuda" and tuple(out.shape) == fields.shape
    for i, b in enumerate(blobs):
        assert torch.equal(out[i], szp.decompress(b, device="cuda")[0])


def test_lorenzo_and_nopred_read_back_pinned_behind_an_event(dev, monkeypatch):
    """LORENZO_REG's and NOPRED's stream and literals come back to
    page-locked memory, queued behind an event that the host half waits on
    before it seals, as INTERP's do; the archives equal the engine's."""
    from sz3_tpu_torch import runtime

    rng = np.random.default_rng(3)
    x = (np.cumsum(rng.standard_normal((40, 41, 42)), axis=-1) * 0.05).astype(np.float32)
    x.reshape(-1)[::211] = 1e5
    copied, waited, sealed = [], [], []
    to_host, seal_packed, sync = tde.to_host, tde.seal_packed, torch.cuda.Event.synchronize
    monkeypatch.setattr(tde, "to_host", lambda t: copied.append(to_host(t)) or copied[-1])
    monkeypatch.setattr(tde, "seal_packed", lambda *a: sealed.append(a[1]) or seal_packed(*a))
    monkeypatch.setattr(torch.cuda.Event, "synchronize", lambda e: waited.append(e) or sync(e))
    for algo, eb in ((ALGO.LORENZO_REG, 1e-3), (ALGO.NOPRED, 1e-1)):
        copied.clear(), waited.clear(), sealed.clear()
        conf = Config(cmprAlgo=algo, absErrorBound=eb)
        blob = szp.compress(x, conf.copy(), device="cuda")
        assert szp.open_archive(blob)[0].cmprAlgo == algo
        packed, = sealed
        assert [t.is_pinned() for t in copied] == [True, True], algo
        assert packed.bits is copied[0] and packed.unpred is copied[1]
        assert isinstance(packed.done, torch.cuda.Event) and waited == [packed.done], algo
        c, cap = szp.api.archive_conf(x, conf.copy())
        assert blob == szp.pack_archive(c, runtime.compress_payload(c, x, cap)), algo


def _cli_field(tmp_path, shape=(24, 40, 64), seed=9):
    x = (np.cumsum(np.random.default_rng(seed).standard_normal(shape), axis=-1) * 0.1
         ).astype(np.float32)
    x.tofile(tmp_path / "in.dat")
    return x, ["-3", *map(str, reversed(shape))]


@pytest.mark.parametrize("bound", [["-M", "ABS", "1e-3"], ["-M", "REL", "1e-3"]])
def test_cli_on_the_card(dev, tmp_path, capsys, bound):
    """sz3t-torch on its default device writes the host engine's archive
    (--backend native) and decodes it bit-equal to the engine; -a's report
    on the card is the host's: its extremes exactly, its sums to the digits
    printed."""
    from sz3_tpu_torch import runtime
    from sz3_tpu_torch.cli import main

    x, dims = _cli_field(tmp_path)
    src = str(tmp_path / "in.dat")
    assert main(["-f", "-i", src, *dims, *bound, "-z", str(tmp_path / "c.sz"), "-o",
                 str(tmp_path / "c.out"), "-a"]) == 0
    card = capsys.readouterr().out
    assert main(["-f", "-i", src, *dims, *bound, "-z", str(tmp_path / "n.sz"), "-o",
                 str(tmp_path / "n.out"), "--backend", "native", "--device", "cpu", "-a"]) == 0
    host = capsys.readouterr().out
    blob = (tmp_path / "c.sz").read_bytes()
    assert blob == (tmp_path / "n.sz").read_bytes()
    assert (tmp_path / "c.out").read_bytes() == (tmp_path / "n.out").read_bytes()
    conf, payload = szp.open_archive(blob)
    assert (tmp_path / "c.out").read_bytes() == runtime.decompress_payload(conf, payload).tobytes()
    import re

    def report(text):
        """The printed lines but times and paths: those of sums (PSNR, NRMSE,
        normError, acEff) as numbers, the others as text."""
        exact, sums = [], []
        for ln in text.splitlines():
            if "=" not in ln or "time" in ln or "file" in ln:
                continue
            if any(k in ln for k in ("PSNR", "normError", "acEff")):
                sums += [float(v) for v in re.findall(r"=\s*([-+.\dEe]+)", ln)]
            else:
                exact.append(ln)
        return exact, sums

    (ce, cs), (he, hs) = report(card), report(host)
    assert ce == he and len(ce) == 6 and len(cs) == len(hs) == 5
    # the sums agree to 1e-12 (test_torch_tools.py), so the printed values
    # differ by at most one unit of the last place %f prints
    assert all(abs(a - b) <= 1e-6 + 1e-9 * abs(b) for a, b in zip(cs, hs)), (cs, hs)


def test_tools_on_the_card(dev, tmp_path):
    """verify, pysz and the preprocessors on the card agree with their CPU
    runs (verify and the wavelet to the tolerances of test_torch_tools.py)."""
    from sz3_tpu_torch import preprocess, pysz

    x, _ = _cli_field(tmp_path)
    y = x + np.float32(1e-4) * np.sin(np.arange(x.size, dtype=np.float32)).reshape(x.shape)
    a, b = szp.verify(x, y), szp.verify(x, y, device="cpu")
    for f in ("min", "max", "max_abs_err"):
        assert getattr(a, f) == getattr(b, f)
    for f in ("psnr", "nrmse", "norm_err", "ac_eff", "max_pw_rel_err"):
        assert abs(getattr(a, f) - getattr(b, f)) <= 1e-12 * abs(getattr(b, f))
    conf = pysz.szConfig(x.shape)
    conf.absErrorBound = 1e-3
    blob, _ = pysz.sz.compress(x, conf)
    assert np.array_equal(blob, pysz.sz.compress(x, conf, device="cpu")[0])
    out, _ = pysz.sz.decompress(blob, np.float32, x.shape)
    assert np.array_equal(out, pysz.sz.decompress(blob, np.float32, x.shape, device="cpu")[0])
    t = torch.from_numpy(x).to(dev)
    assert torch.equal(preprocess.transpose(t, (2, 0, 1)).cpu(),
                       preprocess.transpose(x, (2, 0, 1), device="cpu"))
    c = preprocess.wavelet_forward(t)
    assert c.device.type == "cuda"
    cc = preprocess.wavelet_forward(x, device="cpu")
    assert float((c.cpu() - cc).abs().max()) <= 1e-12 * float(cc.abs().max())
    back = preprocess.wavelet_inverse(c, x.size).cpu()
    assert float((back - torch.from_numpy(x).double().reshape(-1)).abs().max()) < 1e-9
