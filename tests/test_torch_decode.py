"""The port's Huffman decode on the CPU (the kernels' plain PyTorch versions),
with a tolerance of zero: against the JAX package's decode_stream, _scan and
_compact in interpret mode on one stream, and against the port's host engine
on the streams the JAX package hands to the host (few windows, a constant
stream, codes deeper than 32 bits, a shortest code of one bit)."""

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
    of it."""

    def __init__(self):
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
        self.state = ted.new_scan_state(self.nwin, self.tables.cap, CPU)
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


def test_scan_plain_matches_jax_scan(stream):
    """(b) entry, exit, nskip, nout of every window on the first speculative
    pass, and each window's owned symbols."""
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
    mine = st.syms.numpy()
    for w in range(n):
        a, b = int(st.nskip[w]), int(st.nskip[w] + st.nout[w])
        assert np.array_equal(mine[w, a:b], rows[w, a:b]), w


def test_compact_plain_matches_jax_compact(stream):
    """(c) the compaction of the first pass's runs (mis-speculated windows
    and all: the function is defined by its arguments)."""
    n = stream.nwin
    nout = stream.j_nout[:n].astype(np.int64)
    count = int(nout.sum())
    off = np.cumsum(nout) - nout
    st = stream.state
    got = ted.compact_plain(st.syms, st.nskip, st.nout, torch.from_numpy(off), count)

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
        assert int(lens[lens > 0].min()) == 1 and stats["cap"] == 1090
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
