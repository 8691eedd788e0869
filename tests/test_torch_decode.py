"""The port's Huffman decode on the CPU (the kernels' plain PyTorch versions),
with a tolerance of zero: against the JAX package's decode_stream, _scan and
_compact in interpret mode on one stream, and against the port's host engine
on the streams the JAX package hands to the host (few windows, a constant
stream, codes deeper than 32 bits, a shortest code of one bit). The port
keeps no per-window symbol rows: where the JAX package compacts rows, the
port's write phase decodes each window again from its entry."""

import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sz3_tpu as szt
import sz3_tpu_torch as szp
from sz3_tpu.config import ALGO, Config
from sz3_tpu.ops import entropy_decode as jed
from sz3_tpu_torch import runtime
from sz3_tpu_torch.algos import device_decode as tdd
from sz3_tpu_torch.ops import entropy_decode as ted
from sz3_tpu_torch.ops import stream_order

from test_torch_cuda import _coded_stream, _decode_cases as _cases

CPU = torch.device("cpu")


# ---- one stream through both packages --------------------------------------------

class _Stream:
    """The Huffman stream of a (40, 36, 20) f32 field at ABS 1e-3, opened by
    the port's engine, and what each package's first speculative pass makes
    of it. The runway is a constant of each package (the port's is longer);
    the port's pass is made at the JAX package's, so that the two can be
    compared window by window."""

    def __init__(self):
        with pytest.MonkeyPatch.context() as patch:
            patch.setattr(ted, "RUN_BITS", jed.RUN_BITS)
            self._scan_both()

    def _scan_both(self):
        rng = np.random.default_rng(8)
        dims = (40, 36, 20)
        x = (np.cumsum(rng.standard_normal(dims), axis=-1) / 8).astype(np.float32)
        blob = szt.compress(x, Config(dims=dims, cmprAlgo=ALGO.INTERP, absErrorBound=1e-3))
        conf, payload = szp.open_archive(blob)
        conf.interpAnchorStride = 32
        (self.bits, self.count, self.offset, self.codes, self.lens, const_sym,
         _unpred) = runtime.open_packed(conf, payload, np.float32)
        assert const_sym < 0
        self.want, _ = runtime.interp_open(conf, payload, np.float32)
        self.total_bits = len(self.bits) * 8
        self.nwin = -(-self.total_bits // ted.W_BITS)
        assert self.nwin >= 64

        # the port: first pass of every window, speculating
        self.tables = ted.build_decode_tables(self.codes, self.lens, self.offset, CPU)
        self.stream = ted.upload_bytes(self.bits, CPU, ted.PAD_BYTES)
        self.state = ted.new_scan_state(self.nwin, CPU)
        for t in self.state:
            t.zero_()
        idx = torch.arange(self.nwin, dtype=torch.int32)
        starts = torch.zeros(self.nwin, dtype=torch.int32)
        starts[0] = ted.RUN_BITS
        ted.scan_windows_plain(self.stream, self.total_bits, self.tables, idx, starts,
                               self.state)

        # the JAX package: the same pass, as decode_stream sets it up
        codes64, lens64 = self.codes.astype(np.int64), self.lens.astype(np.int64)
        l1, eyt, deep, cap, levels = jed.build_decode_tables(codes64, lens64, self.offset)
        nb = -(-self.nwin // jed.BWIN)
        nwinp = nb * jed.BWIN
        pad = (-len(self.bits)) % 4
        words = np.frombuffer(self.bits + b"\x00" * pad, dtype=">u4").astype(np.uint32)
        words = np.pad(words, (0, nwinp * jed.W_WORDS - words.size))
        tiles = jed._window_tiles(jnp.asarray(words.view(np.int32)), self.nwin, nb)
        entries = np.zeros(nwinp, np.int32)
        entries[0] = jed.RUN_BITS
        ends = np.zeros(nwinp, np.int64)
        ends[:self.nwin] = np.minimum(
            jed.RUN_BITS + jed.W_BITS,
            jed.RUN_BITS + self.total_bits - np.arange(self.nwin, dtype=np.int64) * jed.W_BITS)
        shape = (nb * jed.GROUPS, 128)
        s, entry, exit_, nskip, nout = jed._scan(
            tiles, jnp.asarray(entries.reshape(shape)),
            jnp.asarray(ends.astype(np.int32).reshape(shape)), l1, eyt, deep, nb, cap, levels)
        self.j_cap, self.j_nb = cap, nb
        self.j_symsT = jed._to_window_major(s, nb, cap, cap // 128)
        self.j_entry, self.j_exit, self.j_nskip, self.j_nout = (
            np.asarray(a).ravel() for a in (entry, exit_, nskip, nout))


@pytest.fixture(scope="module")
def stream():
    return _Stream()


@pytest.fixture
def jax_runway(monkeypatch):
    """The port's plain versions at the JAX package's runway, for the tests
    that read the scan state of the `stream` fixture."""
    monkeypatch.setattr(ted, "RUN_BITS", jed.RUN_BITS)


def test_decode_stream_matches_jax(stream):
    """(a) decode_stream == sz3_tpu.ops.entropy_decode.decode_stream == the
    engine's bit-walk, on a stream of at least 64 windows."""
    got = ted.decode_stream(stream.bits, stream.count, stream.codes, stream.lens,
                            stream.offset, CPU)
    assert got.dtype == torch.int32 and tuple(got.shape) == (stream.count,)
    want = np.asarray(jed.decode_stream(stream.bits, stream.count,
                                        stream.codes.astype(np.int64),
                                        stream.lens.astype(np.int64), stream.offset))
    assert np.array_equal(got.numpy(), want.ravel()[:stream.count])
    assert np.array_equal(got.numpy(), stream.want)


def _runs(nout):
    n64 = torch.as_tensor(nout).to(torch.int64)
    return n64, torch.cumsum(n64, 0) - n64, int(n64.sum())


def test_scan_plain_matches_jax_scan(stream, jax_runway):
    """(b) entry, exit, nskip, nout of every window on the first speculative
    pass, and each window's owned symbols (the port's through its write
    phase, the JAX package's from its rows)."""
    n = stream.nwin
    st = stream.state
    assert np.array_equal(st.entry.numpy(), stream.j_entry[:n])
    assert np.array_equal(st.exit.numpy(), stream.j_exit[:n])
    assert np.array_equal(st.nskip.numpy(), stream.j_nskip[:n])
    assert np.array_equal(st.nout.numpy(), stream.j_nout[:n])
    assert (st.nout.numpy() > 0).all()
    # some windows mis-speculate on this stream: the chain check has work to do
    bad, _ = ted.bad_windows(st, torch.arange(n, dtype=torch.int64) * ted.W_BITS)
    assert 0 < int(bad.sum()) < n and not bool(bad[0])
    rows = np.asarray(stream.j_symsT).reshape(-1, stream.j_cap)
    n64, off, count = _runs(st.nout)
    mine = ted.write_windows_plain(stream.stream, stream.total_bits, stream.tables, st.entry,
                                   st.nout, off, count).numpy()
    for w in range(n):
        a, b = int(st.nskip[w]), int(st.nskip[w] + st.nout[w])
        assert np.array_equal(mine[int(off[w]):int(off[w] + n64[w])], rows[w, a:b]), w


def test_write_plain_matches_jax_compact(stream, jax_runway):
    """(c) the dense symbols of the first pass's runs (mis-speculated windows
    and all: the function is defined by its arguments): the port's
    scan_windows_plain + write_windows_plain against the JAX package's _scan
    + _compact."""
    n = stream.nwin
    nout = stream.j_nout[:n].astype(np.int64)
    count = int(nout.sum())
    off = np.cumsum(nout) - nout
    st = stream.state
    got = ted.write_windows(stream.stream, stream.total_bits, stream.tables, st.entry, st.nout,
                            torch.from_numpy(off), count)

    nwinp = stream.j_nb * jed.BWIN
    offs = np.full(nwinp, count, np.int64)
    offs[:n] = off
    nfull = np.zeros(nwinp, np.int32)
    nfull[:n] = nout
    skf = np.zeros(nwinp, np.int32)
    skf[:n] = stream.j_nskip[:n]
    out = jnp.zeros((-(-count // 128) + 256, 128), jnp.int32)
    want = jed._compact(stream.j_symsT, jnp.asarray(offs.astype(np.int32)), jnp.asarray(skf),
                        jnp.asarray(nfull), out, nwinp // jed.COMPACT_BATCH,
                        stream.j_cap // 128)
    assert np.array_equal(got.numpy(), np.asarray(want).ravel()[:count])


# ---- the write phase on its own ----------------------------------------------------

def _proven(bits, codes, lens, lo):
    """(stream, total_bits, tables, proven scan state) of a coded stream: the
    passes of decode_stream, up to the write phase."""
    total_bits = len(bits) * 8
    tables = ted.build_decode_tables(codes, lens, lo, CPU)
    stream = ted.upload_bytes(bits, CPU, ted.PAD_BYTES)
    nwin = -(-total_bits // ted.W_BITS)
    state = ted.new_scan_state(nwin, CPU)
    idx = torch.arange(nwin, dtype=torch.int32)
    starts = torch.zeros(nwin, dtype=torch.int32)
    starts[0] = ted.RUN_BITS
    wstart = idx.to(torch.int64) * ted.W_BITS
    chain = False
    while True:
        ted.scan_windows(stream, total_bits, tables, idx, starts, state, chain=chain)
        bad, want = ted.bad_windows(state, wstart)
        if not bool(bad.any()):
            return stream, total_bits, tables, state
        idx, starts = ted.rescan_args(bad, want, wstart)
        chain = True


@pytest.mark.parametrize("name", ["shortest_code_1_bit", "fibonacci_63_levels",
                                  "under_64_windows", "one_window"])
def test_write_phase_writes_the_streams_symbols(name):
    """The write phase alone, from a proven chain: a 1-bit shortest code (the
    longest runs a window can own), codes of 63 bits, fewer than 64 windows,
    and a single window."""
    freq, syms = _cases()[name]
    bits, codes, lens, lo, _ = _coded_stream(freq, syms)
    stream, total_bits, tables, state = _proven(bits, codes, lens, lo)
    nout, off = ted.owned_runs(state, len(syms))
    dense = ted.write_windows(stream, total_bits, tables, state.entry, nout, off, len(syms))
    assert dense.dtype == torch.int32 and np.array_equal(dense.numpy(), syms)
    assert int(nout.max()) <= tables.cap
    if name == "shortest_code_1_bit":
        assert int(lens[lens > 0].min()) == 1 and int(nout.max()) > 512
    if name == "fibonacci_63_levels":
        assert int(lens.max()) == 63 and tables.deep_key.numel() > 0


def test_write_phase_stops_at_the_last_windows_trimmed_count():
    """The zero bits that pad the stream's last byte decode to symbols the
    stream does not hold. owned_runs takes them off the last window's count,
    and the write phase ends on that count, not on the stream's end."""
    freq, _ = _cases()["under_64_windows"]
    rng = np.random.default_rng(5)
    for n in range(900, 940):
        syms = rng.integers(0, len(freq), n) + 1
        bits, codes, lens, lo, _ = _coded_stream(freq, syms)
        stream, total_bits, tables, state = _proven(bits, codes, lens, lo)
        excess = int(state.nout.sum()) - n
        if excess:
            break
    assert excess > 0
    nout, off = ted.owned_runs(state, n)
    assert int(nout[-1]) == int(state.nout[-1]) - excess
    dense = ted.write_windows(stream, total_bits, tables, state.entry, nout, off, n)
    assert np.array_equal(dense.numpy(), syms)
    # uncut, the last window's run would pass the end of dense: it is cut there
    n64, off_all, _ = _runs(state.nout)
    cut = ted.write_windows(stream, total_bits, tables, state.entry, state.nout, off_all, n)
    assert np.array_equal(cut.numpy(), syms)


def test_symbols_anywhere_in_int32_decode():
    """The symbols are whole int32 values of their own array, beside the
    table entries that hold the lengths: negative ones and ones that would
    not fit beside a length in one 32-bit entry decode all the same."""
    freq, syms = _cases()["fibonacci_33_levels"]
    bits, codes, lens, lo, _ = _coded_stream(freq, syms)
    tables = ted.build_decode_tables(codes, lens, lo, CPU)
    short = tables.l1_len > 0
    assert torch.equal((tables.root & 0xff)[short], tables.l1_len[short])
    for far in (-3, (1 << 24) - 2, 2 ** 31 - 1 - len(freq)):
        got = ted.decode_stream(bits, len(syms), codes, lens, far, CPU)
        assert np.array_equal(got.numpy(), syms - lo + far)


def _kernel_lookup(tables, bits):
    """(symbol, length) as csrc/huff_walk.cuh looks a code up, for the
    left-aligned 64-bit values `bits`: the root table by 11-bit prefix, then
    the prefix's second table, then the search among the deep codes."""
    i1 = (bits >> np.uint64(64 - ted.L1_BITS)).astype(np.int64)
    e = tables.root.numpy().view(np.uint32)[i1]
    low = (e & 0xff).astype(np.int64)
    sym = tables.l1_sym.numpy()[i1].astype(np.int64)
    ln = np.where(low <= ted.L1_BITS, low, 0)
    sub = (low & 0x80) != 0
    m = np.where(sub, low & 0x7f, 1)
    at = (e >> 8).astype(np.int64) + ((bits << np.uint64(ted.L1_BITS))
                                      >> (64 - m).astype(np.uint64)).astype(np.int64)
    at = np.where(sub, at, 0)
    if tables.sub_len.numel():
        sl = tables.sub_len.numpy()[at].astype(np.int64)
        hit = sub & (sl > 0)
        ln = np.where(hit, sl, ln)
        sym = np.where(hit, tables.sub_sym.numpy()[at], sym)
    search = ln == 0
    if tables.deep_key.numel():
        key = (bits ^ np.uint64(1 << 63)).view(np.int64)
        r = np.searchsorted(tables.deep_key.numpy(), key, side="right") - 1
        found = search & (r >= 0)
        ln = np.where(found, tables.deep_len.numpy()[r.clip(min=0)], ln)
        sym = np.where(found, tables.deep_sym.numpy()[r.clip(min=0)], sym)
    return np.where(ln > 0, sym, 0), ln


@pytest.mark.parametrize("name", ["stream", "fibonacci_63_levels", "fibonacci_33_levels",
                                  "shortest_code_1_bit"])
def test_kernel_tables_hold_the_same_code(stream, name, monkeypatch):
    """The tables the kernels read (root, second tables, deep codes) give the
    symbol and length that the plain lookup gives, at every bit of the
    stream and on random bits; also when the second tables' budget runs out
    and some prefixes are left to the search."""
    if name == "stream":
        bits, codes, lens, lo = stream.bits, stream.codes, stream.lens, stream.offset
    else:
        bits, codes, lens, lo, _ = _coded_stream(*_cases()[name])
    rng = np.random.default_rng(3)
    full = ted.SUB_BUDGET
    for budget in (full, 1 << 6):
        monkeypatch.setattr(ted, "SUB_BUDGET", budget)
        tables = ted.build_decode_tables(codes, lens, lo, CPU)
        deep = int((lens > ted.L1_BITS).sum())
        assert tables.sub_len.numel() <= budget
        if budget == full:
            assert (tables.sub_len.numel() > 0) == (deep > 0)
        noise = rng.integers(0, 256, 4000, dtype=np.uint8).tobytes()
        data = ted.upload_bytes(bits[:4000] + noise, CPU, ted.PAD_BYTES)
        words = ted._be_words(data)
        p = torch.arange(8 * (min(len(bits), 4000) + len(noise)), dtype=torch.int64)
        sym, ln = ted._lookup_plain(words, p, tables)
        wi, sh = (p >> 5).numpy(), (p & 31).numpy().astype(np.uint64)
        w = words.numpy().astype(np.uint64)
        hi = ((w[wi] << np.uint64(32)) | w[wi + 1])
        lo64 = ((w[wi + 2] << np.uint64(32)) | w[wi + 3])
        win = np.where(sh > 0, (hi << sh) | (lo64 >> (np.uint64(64) - sh).clip(max=63)), hi)
        ksym, kln = _kernel_lookup(tables, win)
        assert np.array_equal(kln, ln.numpy())
        assert np.array_equal(ksym, np.where(ln.numpy() > 0, sym.numpy(), 0))
        if tables.maxlen <= 32:
            # a reader that holds 32 valid bits finds the same codes
            ksym, kln = _kernel_lookup(tables, win & ~np.uint64(0xFFFFFFFF))
            assert np.array_equal(kln, ln.numpy())


@pytest.mark.parametrize("name", ["stream", "shortest_code_1_bit", "fibonacci_33_levels"])
def test_group_steps_land_on_symbol_boundaries(stream, name):
    """The count phase may take all the short codes that lie whole within the
    11 bits of a lookup in one step (root's bytes 1 and 2): walking the
    stream by such steps visits symbol boundaries only, and counts every
    symbol passed."""
    if name == "stream":
        bits, codes, lens, lo, syms = (stream.bits, stream.codes, stream.lens, stream.offset,
                                       stream.want)
    else:
        freq, syms = _cases()[name]
        bits, codes, lens, lo, _ = _coded_stream(freq, syms)
    tables = ted.build_decode_tables(codes, lens, lo, CPU)
    root = tables.root.numpy().view(np.uint32)
    codelen = dict(zip((np.flatnonzero(lens) + lo).tolist(), lens[lens > 0].tolist()))
    nsym = min(len(syms), 4000)
    bounds = np.concatenate([[0], np.cumsum([codelen[int(s)] for s in syms[:nsym]])])
    stream_bits = np.unpackbits(np.frombuffer(bits, np.uint8))
    stream_bits = np.concatenate([stream_bits, np.zeros(64, np.uint8)])
    weights = 1 << np.arange(ted.L1_BITS - 1, -1, -1)
    pos = n = steps = 0
    while n < nsym - 11:
        e = int(root[int(stream_bits[pos:pos + ted.L1_BITS] @ weights)])
        low = e & 0xff
        if 1 <= low <= ted.L1_BITS:
            assert (e >> 8) & 0xff >= low and (e >> 16) >= 1
            pos += (e >> 8) & 0xff
            n += e >> 16
        else:
            pos = int(bounds[n + 1])
            n += 1
        steps += 1
        assert bounds[n] == pos
    if name == "shortest_code_1_bit":
        assert steps < 0.5 * n                          # most steps take several symbols


def test_decode_stream_keeps_no_symbol_rows():
    """decode_stream makes no tensor of windows x cap elements (the rows of
    the JAX package's scan): on a 1-bit shortest code, where a row would be
    1090 symbols, nothing it makes is larger than the dense stream."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Largest(TorchDispatchMode):
        numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor):
                    self.numel = max(self.numel, t.numel())
            return out

    freq, syms = _cases()["shortest_code_1_bit"]
    bits, codes, lens, lo, _ = _coded_stream(freq, syms)
    stats = {}
    with Largest() as seen:
        dense = ted.decode_stream(bits, len(syms), codes, lens, lo, CPU, stats)
    assert np.array_equal(dense.numpy(), syms)
    assert stats["nwin"] * stats["cap"] > 2 * len(syms)
    assert seen.numel == len(syms)
    assert ted.ScanState._fields == ("entry", "exit", "nskip", "nout")


def test_proven_chain_at_the_ports_runway_matches_a_sequential_walk(stream):
    """The port's own runway (longer than the JAX package's, at which the
    tests above compare window by window): after the passes of
    decode_stream, every window's entry, exit and nout are those of the
    stream's true symbol boundaries, which one sequential walk of the
    engine's symbols gives; a first-pass window that speculated right counted
    the symbols that start in its runway."""
    assert ted.RUN_BITS % 32 == 0 and jed.RUN_BITS < ted.RUN_BITS <= 256
    _, total_bits, tables, state = _proven(stream.bits, stream.codes, stream.lens, stream.offset)
    assert tables.cap == (ted.RUN_BITS + ted.W_BITS) // int(stream.lens[stream.lens > 0].min()) + 2
    starts = np.cumsum(stream.lens[stream.want - stream.offset].astype(np.int64))
    starts = np.concatenate([[0], starts])              # boundary k = first bit of symbol k
    assert total_bits - 8 < starts[-1] <= total_bits
    n = stream.nwin
    lo = np.arange(n, dtype=np.int64) * ted.W_BITS
    first = np.searchsorted(starts, lo)                 # first symbol that starts in the window
    entry = starts[first] - lo + ted.RUN_BITS
    assert np.array_equal(state.entry.numpy(), entry)
    assert np.array_equal(state.exit.numpy()[:-1], entry[1:] + ted.W_BITS)
    assert np.array_equal(state.nout.numpy()[:-1], np.diff(first))
    nout, _ = ted.owned_runs(state, stream.count)
    assert int(nout[-1]) == stream.count - first[-1]
    # nskip has no true value: a runway is walked before the walk is in step
    lmin = int(stream.lens[stream.lens > 0].min())
    nskip = state.nskip.numpy()
    assert nskip.min() >= 0 and nskip.max() <= ted.RUN_BITS // lmin and (nskip > 0).sum() > n // 2


# ---- streams the JAX package refuses, against the port's engine ------------------

def _engine_decode(tree, bits, count):
    blob = tree + struct.pack("<QQ", count, len(bits)) + bits
    return runtime.huff_decode(blob, count)


@pytest.mark.parametrize("name", list(_cases()))
def test_decode_stream_matches_engine(name):
    """(d) decode_stream == the engine's sequential decode of the same tree
    and bits."""
    freq, syms = _cases()[name]
    bits, codes, lens, lo, tree = _coded_stream(freq, syms)
    stats = {}
    got = ted.decode_stream(bits, len(syms), codes, lens, lo, CPU, stats)
    assert np.array_equal(got.numpy(), _engine_decode(tree, bits, len(syms)))
    assert np.array_equal(got.numpy(), syms)
    assert stats["nwin"] == -(-len(bits) * 8 // 1024)
    assert stats["passes"] == len(stats["redo_counts"]) >= 1
    assert stats["redo_counts"][0] == stats["nwin"]
    longest = int(lens.max())
    if name == "fibonacci_33_levels":
        assert longest == 33
    if name == "fibonacci_63_levels":
        assert longest == 63
    if name == "never_synchronises":
        assert longest == 3 and stats["passes"] == 2
        assert stats["nwin"] // 2 < stats["redo_counts"][1] < stats["nwin"]
    if name == "shortest_code_1_bit":
        assert int(lens[lens > 0].min()) == 1
        assert stats["cap"] == ted.RUN_BITS + ted.W_BITS + 2
    if name == "under_64_windows":
        assert 1 < stats["nwin"] < 64


def test_second_pass_rescans_only_bad_windows(stream):
    """A stream that needs at least two validation passes: the later passes
    scan fewer windows than the first, and from proven entries."""
    stats = {}
    ted.decode_stream(stream.bits, stream.count, stream.codes, stream.lens, stream.offset,
                      CPU, stats)
    assert stats["passes"] >= 2
    assert all(r < stats["nwin"] for r in stats["redo_counts"][1:])


def test_constant_stream():
    """A tree of one leaf has an empty bitstream: the decode is a fill."""
    dense = tdd.dense_bins(b"", 1000, 7, np.zeros(0, np.uint64), np.zeros(0, np.uint8), 7, CPU)
    assert dense.dtype == torch.int32 and bool((dense == 7).all()) and dense.numel() == 1000
    x = np.zeros((24, 20, 18), np.float32)
    blob = szp.compress(x, szp.Config(cmprAlgo=szp.ALGO.INTERP, absErrorBound=1e-3),
                        device="cpu")
    conf, payload = szp.open_archive(blob)
    conf.interpAnchorStride = 32
    assert runtime.open_packed(conf, payload, np.float32)[5] >= 0
    out, _ = szp.decompress(blob, device="cpu")
    assert np.array_equal(out.numpy(), szt.decompress(blob)[0])


def test_codes_over_64_bits_raise():
    lens = np.array([65, 1], np.uint8)
    with pytest.raises(ValueError, match="65 > 64"):
        ted.build_decode_tables(np.zeros(2, np.uint64), lens, 0, CPU)


# ---- corrupt inputs -----------------------------------------------------------------

@pytest.mark.parametrize("delta", [+3, -400])
def test_wrong_count_raises(delta):
    """(e) a count the stream does not hold: more symbols than it decodes to,
    or fewer than the last byte's padding explains."""
    freq, syms = _cases()["under_64_windows"]
    bits, codes, lens, lo, _ = _coded_stream(freq, syms)
    with pytest.raises(ValueError, match="symbol count"):
        ted.decode_stream(bits, len(syms) + delta, codes, lens, lo, CPU)


def _payload(shape=(30, 28, 26)):
    rng = np.random.default_rng(4)
    x = (np.cumsum(rng.standard_normal(shape).astype(np.float32), axis=-1) * 0.1)
    x.reshape(-1)[::50] = 1e6                           # some literals
    blob = szp.compress(x, szp.Config(cmprAlgo=szp.ALGO.INTERP, absErrorBound=1e-3),
                        device="cpu")
    conf, payload = szp.open_archive(blob)
    conf.interpAnchorStride = 32
    return conf, payload


def test_literal_count_mismatch_raises(monkeypatch):
    conf, payload = _payload()
    real = runtime.open_packed

    def short(*a, **kw):
        out = list(real(*a, **kw))
        assert out[6].size > 1
        out[6] = out[6][:-1]
        return tuple(out)

    monkeypatch.setattr(tdd.runtime, "open_packed", short)
    with pytest.raises(ValueError, match="literal stream length"):
        tdd.decode_payload_device(conf, payload, np.float32, CPU)


def test_archived_count_mismatch_raises(monkeypatch):
    conf, payload = _payload()
    real = runtime.open_packed

    def miscount(*a, **kw):
        out = list(real(*a, **kw))
        out[1] -= 1
        return tuple(out)

    monkeypatch.setattr(tdd.runtime, "open_packed", miscount)
    with pytest.raises(ValueError, match="archived symbol count"):
        tdd.decode_payload_device(conf, payload, np.float32, CPU)


# ---- stream order ---------------------------------------------------------------------

@pytest.mark.parametrize("dims,algo", [((20, 17, 13), 1), ((33, 40), 0), ((9, 10, 11, 6), 1)])
def test_from_stream_inverts_to_stream(dims, algo):
    """from_stream and literal_grid are the inverses of to_stream and
    literal_values, and equal the engine's perm_place."""
    rng = np.random.default_rng(2)
    num = int(np.prod(dims))
    perm = stream_order.device_perm(dims, algo, 0, 32, CPU)
    assert perm.dtype == torch.int32
    grid = torch.from_numpy(rng.integers(0, 9, num).astype(np.int32))
    dense = stream_order.to_stream(grid, perm)
    assert torch.equal(stream_order.from_stream(dense, perm, num), grid)
    slots = torch.nonzero(dense == 0).reshape(-1)
    x = torch.from_numpy(rng.standard_normal(num).astype(np.float32))
    values = stream_order.literal_values(x, perm, slots)
    lit = stream_order.literal_grid(values, perm, slots, num)
    assert torch.equal(lit, torch.where(grid == 0, x, 0.0))
    bins_np, lit_np = runtime.perm_place(perm.numpy().astype(np.int64), dense.numpy(),
                                         values.numpy(), dims, np.float32)
    assert np.array_equal(bins_np.ravel(), grid.numpy())
    assert np.array_equal(lit_np.ravel()[grid.numpy() == 0], x.numpy()[grid.numpy() == 0])
    with pytest.raises(ValueError, match="do not fit"):
        stream_order.from_stream(dense[:-1], perm, num)
