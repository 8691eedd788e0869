"""The entropy kernels' plain versions equal the JAX package's Pallas
kernels (run in interpret mode on the CPU) and an independent numpy
reference (tests/test_torch_cuda.py holds each kernel to its plain version
on a CUDA card).

K1 = hist_and_literals (histogram + literal slots), K2+K3 = pack_bits
(code lookup + bit packing)."""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sz3_tpu.algos import device_encode as jde
from sz3_tpu.ops import entropy_device as jed
from sz3_tpu_torch.algos import device_encode as tde
from sz3_tpu_torch.ops import entropy_device as ted

RADIUS = 32768
WLO = RADIUS - ted.W_HALF


def _stream(n, seed, spread=30.0, zeros=0.01, trash=0.0, sentinel_tail=0):
    """Bins clustered around RADIUS with zeros, optional out-of-window
    symbols, and SENTINEL pads at the end."""
    rng = np.random.default_rng(seed)
    b = (RADIUS + np.round(rng.standard_normal(n) * spread)).astype(np.int32)
    b[rng.random(n) < zeros] = 0
    far = rng.random(n) < trash
    b[far] = RADIUS + ted.W_HALF + rng.integers(0, 30000, int(far.sum()))
    if sentinel_tail:
        b[n - sentinel_tail:] = ted.SENTINEL
    return b


@pytest.fixture(scope="module")
def jax_results():
    """JAX interpret-mode results on two streams of 2 chunks (16384 bins):
    A has out-of-window symbols (K1 only), B does not (K1 and K2+K3).
    Both end in SENTINEL pads, as the JAX stream layout does."""
    n = 2 * jed.CHUNK
    a = _stream(n, 1, trash=0.002, sentinel_tail=300)
    b = _stream(n, 2, spread=200.0, zeros=0.02, sentinel_tail=1000)
    out = {"a": a, "b": b}
    for key, s in (("a", a), ("b", b)):
        hist, slots, nlit = jed.hist_and_literals(jnp.asarray(s), jnp.int32(WLO), 64)
        out[key + "_k1"] = (np.array(hist).ravel(), np.array(slots).ravel(),
                            int(np.asarray(nlit)[0]))
    hist_b = out["b_k1"][0].reshape(128, 128)
    num_b = int((b != ted.SENTINEL).sum())
    _tree, total_bits, _nl, tc, tl, c0 = jde._tree_and_tables(
        hist_b, np.array([out["b_k1"][2]], np.int32), 64, 2 * RADIUS, num_b)
    words, _cbits = jed.pack_bits(jnp.asarray(b), tc, tl, jnp.int32(WLO), c0, 2,
                                  n // 128 + 256)
    out["b_k2"] = (np.array(words).ravel(), total_bits, np.array(tc).ravel(),
                   np.array(tl).ravel(), num_b)
    return out


def _as_jax_hist(hist):
    """The port's histogram (one entry per symbol) folded into the JAX
    package's index space: its window, and TRASH for every other symbol."""
    h = hist.numpy().astype(np.int64)
    j = np.zeros(jed.IDX_SPACE, np.int64)
    j[:2] = h[:2]
    j[2:2 + 2 * ted.W_HALF] = h[WLO + 1:WLO + 1 + 2 * ted.W_HALF]
    j[jed.TRASH] = h[2:].sum() - j[2:2 + 2 * ted.W_HALF].sum()
    return j


def _as_port_table(t_jax, dtype):
    """A JAX code table (window layout) in the port's symbol-index layout."""
    t = np.asarray(t_jax).ravel().view(np.uint32).astype(dtype)
    out = np.zeros(ted.table_len(RADIUS), dtype)
    out[0] = t[0]
    out[WLO + 1:WLO + 1 + 2 * ted.W_HALF] = t[2:2 + 2 * ted.W_HALF]
    return out


@pytest.mark.parametrize("key", ["a", "b"])
def test_hist_and_literals_matches_pallas(jax_results, key):
    hist_j, slots_j, nlit_j = jax_results[key + "_k1"]
    hist, slots = ted.hist_and_literals(torch.from_numpy(jax_results[key]), RADIUS)
    assert slots.numel() == nlit_j
    assert np.array_equal(_as_jax_hist(hist), hist_j)
    assert np.array_equal(slots.numpy(), slots_j[:nlit_j])


def test_code_tables_match_jax(jax_results):
    words_j, total_bits_j, tc_j, tl_j, num_b = jax_results["b_k2"]
    hist, _ = ted.hist_and_literals(torch.from_numpy(jax_results["b"]), RADIUS)
    _tree, total_bits, tc, tl = tde._tree_and_tables(hist, RADIUS, num_b, "cpu")
    assert total_bits == total_bits_j
    assert np.array_equal(tc.numpy(), _as_port_table(tc_j, np.int64))
    assert np.array_equal(tl.numpy(), _as_port_table(tl_j, np.int32))


def test_pack_bits_matches_pallas(jax_results):
    words_j, total_bits, tc_j, tl_j, _ = jax_results["b_k2"]
    words = ted.pack_bits(torch.from_numpy(jax_results["b"]),
                          torch.from_numpy(_as_port_table(tc_j, np.int64)),
                          torch.from_numpy(_as_port_table(tl_j, np.int32)), RADIUS, total_bits)
    nwords = (total_bits + 31) // 32
    assert words.numel() == nwords
    assert np.array_equal(words.numpy(), words_j[:nwords])


# ---- numpy references, more cases ---------------------------------------------------

def _np_sym_index(b, radius):
    idx = np.where((b > 0) & (b < 2 * radius), b.astype(np.int64) + 1, 2 * radius + 1)
    idx = np.where(b == 0, 0, idx)
    return np.where(b == ted.SENTINEL, 1, idx)


def _np_pack(b, codes, lens, radius):
    """Concatenate each symbol's code bits MSB-first, as bytes, big-endian
    words."""
    idx = _np_sym_index(b, radius)
    c = codes[idx].astype(np.uint64)
    n = lens[idx].astype(np.int64)
    shifts = np.concatenate([np.arange(k - 1, -1, -1) for k in n]) if n.sum() else \
        np.zeros(0, np.int64)
    owners = np.repeat(np.arange(b.size), n)
    bits = ((c[owners] >> shifts.astype(np.uint64)) & np.uint64(1)).astype(np.uint8)
    nwords = (int(n.sum()) + 31) // 32
    padded = np.zeros(nwords * 32, np.uint8)
    padded[:bits.size] = bits
    return np.packbits(padded).view(">u4").astype(np.uint32).view(np.int32), int(n.sum())


@pytest.mark.parametrize("n,wlo,seed", [(1, WLO, 0), (777, WLO, 1), (40000, WLO, 2),
                                        (5000, -100, 3), (20000, 16384 - ted.W_HALF, 4)])
def test_hist_and_literals_matches_numpy(n, wlo, seed):
    """Bins near radius (radius = wlo + W_HALF) and anywhere in the
    quantizer's range, with zeros, SENTINELs and a few invalid values."""
    rng = np.random.default_rng(seed)
    radius = wlo + ted.W_HALF
    b = (radius + rng.integers(-9000, 9000, n)).astype(np.int32)
    anywhere = rng.random(n) < 0.2
    b[anywhere] = rng.integers(-3, 2 * radius + 3, int(anywhere.sum()))
    b[rng.random(n) < 0.05] = 0
    b[rng.random(n) < 0.05] = ted.SENTINEL
    hist, slots = ted.hist_and_literals(torch.from_numpy(b), radius)
    assert np.array_equal(hist.numpy(), np.bincount(_np_sym_index(b, radius),
                                                    minlength=ted.table_len(radius)))
    assert np.array_equal(slots.numpy(), np.nonzero(b == 0)[0])


@pytest.mark.parametrize("n,maxlen,seed", [(1, 32, 0), (100, 32, 1), (5000, 12, 2),
                                           (3000, 32, 3), (64, 1, 4), (3000, 64, 5),
                                           (1, 64, 6), (2000, 40, 7)])
def test_pack_bits_matches_numpy(n, maxlen, seed):
    """Random code tables (lengths 0..maxlen: codes of up to 64 bits, which
    straddle two or three words) against a bit-by-bit numpy packer."""
    rng = np.random.default_rng(seed)
    tbl = ted.table_len(RADIUS)
    lens = rng.integers(0, maxlen + 1, tbl).astype(np.int32)
    lens[1] = 0                                   # SENTINEL codes nothing
    raw = rng.integers(0, 2 ** 64, tbl, dtype=np.uint64)
    keep = np.where(lens == 64, ~np.uint64(0),
                    (np.uint64(1) << lens.clip(max=63).astype(np.uint64)) - np.uint64(1))
    codes = raw & keep
    b = rng.integers(1, 2 * RADIUS, n).astype(np.int32)
    b[rng.random(n) < 0.1] = 0
    b[rng.random(n) < 0.1] = ted.SENTINEL
    want, total = _np_pack(b, codes, lens, RADIUS)
    tc = torch.from_numpy(codes.view(np.int64))
    got = ted.pack_bits(torch.from_numpy(b), tc, torch.from_numpy(lens), RADIUS, total)
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(RuntimeError, match="bits"):
        ted.pack_bits(torch.from_numpy(b), tc, torch.from_numpy(lens), RADIUS, total + 1)


def _random_codes(rng, lo, hi):
    """A table of random codes of lo..hi bits (SENTINEL codes nothing)."""
    tbl = ted.table_len(RADIUS)
    lens = rng.integers(lo, hi + 1, tbl).astype(np.int32)
    lens[1] = 0
    raw = rng.integers(0, 2 ** 64, tbl, dtype=np.uint64)
    keep = np.where(lens == 64, ~np.uint64(0),
                    (np.uint64(1) << lens.clip(max=63).astype(np.uint64)) - np.uint64(1))
    return raw & keep, lens


@pytest.mark.parametrize("n,lo,hi", [
    # whole tiles of the kernel (2048 symbols, 8 to a thread) in which every
    # code has 33-64 bits: the most a tile's shared buffer has to hold
    (3 * ted._PACK_TILE, 33, 64), (ted._PACK_TILE, 64, 64),
    # a stream that ends inside a thread's run of 8 symbols
    (2 * ted._PACK_TILE + 8 * 37 + 5, 1, 40), (5, 1, 64)])
def test_pack_bits_tile_edges_match_numpy(n, lo, hi):
    rng = np.random.default_rng(n + hi)
    codes, lens = _random_codes(rng, lo, hi)
    b = rng.integers(1, 2 * RADIUS, n).astype(np.int32)
    want, total = _np_pack(b, codes, lens, RADIUS)
    assert total >= lo * n
    got = ted.pack_bits(torch.from_numpy(b), torch.from_numpy(codes.view(np.int64)),
                        torch.from_numpy(lens), RADIUS, total)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 4096, 4097, 5_000_003, 1 << 27])
def test_partition_covers_the_stream_in_whole_tiles(n):
    for tile in (1, ted._PACK_TILE):
        blocks, per_block = ted._partition(n, tile)
        assert per_block % tile == 0 and 1 <= blocks <= ted._MAX_BLOCKS
        assert (blocks - 1) * per_block < n <= blocks * per_block


@pytest.mark.parametrize("n", [1, ted._K1_TILE - 1, ted._K1_TILE, ted._K1_TILE + 1, 1 << 24])
@pytest.mark.parametrize("sms", [1, 132])
def test_k1_grid_covers_the_stream_once_in_whole_tiles(n, sms):
    """K1's tiles cover stream slots [0, n) once, its persistent blocks take
    every tile once, in order, at least one each (block b: tiles [b * tiles
    // blocks, (b + 1) * tiles // blocks), as csrc/hist_literals.cu's
    block_tiles), and a tile's 16 slots per thread (load q of thread x:
    q * 1024 + 4x + 0..3, as its first_of) cover the tile once."""
    tiles, blocks = ted._k1_grid(n, sms)
    assert (tiles - 1) * ted._K1_TILE < n <= tiles * ted._K1_TILE
    assert 1 <= blocks == min(tiles, sms * ted._K1_BLOCKS_PER_SM)
    bounds = [b * tiles // blocks for b in range(blocks + 1)]
    assert bounds[0] == 0 and bounds[-1] == tiles
    assert all(lo < hi for lo, hi in zip(bounds, bounds[1:]))
    q, x, k = np.meshgrid(np.arange(ted._K1_TILE // (4 * ted._THREADS)),
                          np.arange(ted._THREADS), np.arange(4), indexing="ij")
    in_tile = (q * 4 * ted._THREADS + 4 * x + k).ravel()
    assert np.array_equal(np.sort(in_tile), np.arange(ted._K1_TILE))


def test_k1_constants_match_the_kernel_source():
    """The wrapper sizes K1's buffers by its tile and centres its window by
    its half-width: both must be the kernel's."""
    from pathlib import Path

    src = (Path(ted.__file__).parents[1] / "csrc" / "hist_literals.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kWHalf") == ted.K1_W_HALF
    assert 4 * const("kLoads") * ted._THREADS == ted._K1_TILE


def test_wrappers_reject_bad_input():
    with pytest.raises(ValueError):
        ted.hist_and_literals(torch.zeros(10, dtype=torch.int64), RADIUS)
    with pytest.raises(ValueError):
        ted.hist_and_literals(torch.zeros(0, dtype=torch.int32), RADIUS)
    with pytest.raises(ValueError):
        ted.pack_bits(torch.zeros(10, dtype=torch.int32), torch.zeros(5, dtype=torch.int64),
                      torch.zeros(5, dtype=torch.int32), RADIUS, 0)
    tbl = ted.table_len(RADIUS)
    with pytest.raises(ValueError):                      # 32-bit code table
        ted.pack_bits(torch.zeros(10, dtype=torch.int32), torch.zeros(tbl, dtype=torch.int32),
                      torch.zeros(tbl, dtype=torch.int32), RADIUS, 0)


def _fib(k):
    f = [1, 1]
    while len(f) < k:
        f.append(f[-1] + f[-2])
    return f[:k]


def test_wide_and_deep_symbols_stay_on_device():
    """The inputs the JAX package sends to the host get their codes here:
    bins far from radius, and a Huffman tree deeper than 32 levels. Bins a
    quantizer cannot write raise."""
    b = torch.tensor([RADIUS + ted.W_HALF + 5, RADIUS, 1, 2 * RADIUS - 1, 0], dtype=torch.int32)
    hist, _ = ted.hist_and_literals(b, RADIUS)
    _tree, total, tc, tl = tde._tree_and_tables(hist, RADIUS, 5, "cpu")
    assert int((tl > 0).sum()) == 5 and total == int(tl.sum())
    bad = torch.tensor([RADIUS, 2 * RADIUS], dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        tde._tree_and_tables(ted.hist_and_literals(bad, RADIUS)[0], RADIUS, 2, "cpu")
    # Fibonacci frequencies give a Huffman tree deeper than 32 levels
    fib = _fib(40)
    hist = torch.zeros(ted.table_len(RADIUS), dtype=torch.int32)
    hist[RADIUS + 1:RADIUS + 41] = torch.tensor(fib, dtype=torch.int32)
    _tree, total, tc, tl = tde._tree_and_tables(hist, RADIUS, sum(fib), "cpu")
    assert int(tl.max()) == 39 and total == sum(f * int(n) for f, n in
                                                zip(fib, tl[RADIUS + 1:RADIUS + 41]))


def test_deep_tree_matches_host_engine():
    """A stream whose Huffman tree is 33 levels deep, end to end through the
    entropy stage: tree bytes and packed bits equal the host engine's own
    Huffman encode of the same stream (runtime.huff_encode)."""
    from sz3_tpu import runtime

    fib = _fib(34)                                      # 14.9 million symbols
    syms = RADIUS - 17 + np.arange(34, dtype=np.int32)
    b = np.repeat(syms, fib)
    blob = runtime.huff_encode(b)
    bins = torch.from_numpy(b)
    hist, slots = ted.hist_and_literals(bins, RADIUS)
    assert slots.numel() == 0
    tree, total, tc, tl = tde._tree_and_tables(hist, RADIUS, b.size, "cpu")
    assert int(tl.max()) == 33
    words = ted.pack_bits(bins, tc, tl, RADIUS, total)
    bits = tde._stream_bytes(words, total)
    want = tree + np.array([b.size, len(bits)], "<u8").tobytes() + bits
    assert blob == want


def test_tree_builder_matches_host_engine():
    """The port's tree builder (used when the host engine's 32-bit table
    export refuses a tree) gives the host engine's codes, lengths and tree
    bytes wherever both run: ties, one symbol, two symbols, wide histograms."""
    from sz3_tpu import runtime
    from sz3_tpu_torch.algos.huffman import build_table

    rng = np.random.default_rng(0)
    cases = [np.array([5, 0], np.uint64), np.array([3, 3, 0], np.uint64),
             np.array([1, 0, 0, 1, 0], np.uint64), np.full(300, 7, np.uint64)]
    for size in (50, 700, 40000):
        f = rng.integers(0, 1000, size).astype(np.uint64)
        f[rng.random(size) < 0.3] = 0
        f[0] = 1
        f[-1] = 0
        cases.append(f)
    f = np.zeros(20001, np.uint64)
    f[:-1] = np.round(1e6 * np.exp(-np.abs(np.arange(20000) - 10000) / 50.0))
    f[0] = max(f[0], 1)
    cases.append(f)
    for i, f in enumerate(cases):
        codes, lens, tree = runtime.huff_table(i - 3, f)
        got_codes, got_lens, got_tree = build_table(i - 3, f)
        assert np.array_equal(got_lens, lens), i
        assert np.array_equal(got_codes, codes.astype(np.uint64)), i
        assert got_tree == tree, i
