"""On a CUDA card: each hand-written kernel equals its plain PyTorch version
bit for bit, and the port's archives equal the host engine's. The kernels
have no CPU mode, so without a card every test here skips.

Run on the card:  python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

import sz3_tpu_torch as szp
from sz3_tpu.config import ALGO, Config
from sz3_tpu_torch.algos import device_encode as tde
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


@pytest.mark.parametrize("n", [1, 255, 4097, 3_000_017])
@pytest.mark.parametrize("seed", [0, 1])
def test_hist_and_literals_matches_plain(dev, n, seed):
    b = torch.from_numpy(_stream(n, seed, wide=0.01 * seed, sentinels=0.01)).to(dev)
    h, s = ted.hist_and_literals(b, RADIUS)
    hp, sp = ted.hist_and_literals_plain(b, RADIUS)
    assert torch.equal(h, hp) and torch.equal(s, sp)


@pytest.mark.parametrize("radius", [1, 100, 8000, 1 << 20])
def test_hist_window_edges(dev, radius):
    """Small radii put the shared window against the bottom of the index
    space; large ones leave most symbols to the global atomics."""
    rng = np.random.default_rng(radius)
    b = torch.from_numpy(rng.integers(-2, 2 * radius + 2, 200_003).astype(np.int32)).to(dev)
    h, s = ted.hist_and_literals(b, radius)
    hp, sp = ted.hist_and_literals_plain(b, radius)
    assert torch.equal(h, hp) and torch.equal(s, sp)


@pytest.mark.parametrize("n,spread,wide", [(1, 30.0, 0.0), (4097, 30.0, 0.0),
                                           (3_000_017, 300.0, 0.0), (2_000_003, 3000.0, 0.0),
                                           (2_000_003, 30.0, 0.02)])
def test_pack_bits_matches_plain(dev, n, spread, wide):
    b = torch.from_numpy(_stream(n, 5, spread=spread, wide=wide, sentinels=0.01)).to(dev)
    hist, _ = ted.hist_and_literals(b, RADIUS)
    _tree, total, tc, tl = tde._tree_and_tables(hist, RADIUS,
                                                int((b != ted.SENTINEL).sum()))
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


def test_launches_count_and_no_cpu_fallback(dev):
    b = torch.from_numpy(_stream(10_000, 3)).to(dev)
    before = (ted.hist_and_literals.launches, ted.pack_bits.launches)
    hist, _ = ted.hist_and_literals(b, RADIUS)
    _tree, total, tc, tl = tde._tree_and_tables(hist, RADIUS, b.numel())
    ted.pack_bits(b, tc, tl, RADIUS, total)
    assert (ted.hist_and_literals.launches, ted.pack_bits.launches) == \
        (before[0] + 1, before[1] + 1)
    # the plain versions never count
    ted.hist_and_literals(b.cpu(), RADIUS)
    assert ted.hist_and_literals.launches == before[0] + 1


@pytest.mark.parametrize("shape,algo,eb", [((33, 37, 41), 1, 1e-3), ((64, 64, 64), 0, 1e-3),
                                           ((33, 34, 35, 20), 1, 1e-3), ((20, 20, 20), 1, 1e-3),
                                           ((48, 40, 40), 1, 1e-6)])
def test_archives_match_host_engine(dev, shape, algo, eb):
    import sz3_tpu as szt

    rng = np.random.default_rng(1)
    x = (np.cumsum(rng.standard_normal(shape).astype(np.float32), axis=-1) * 0.1)
    conf = Config(dims=shape, cmprAlgo=ALGO.INTERP, absErrorBound=eb, interpAlgo=algo)
    blob = szp.compress(x, conf, device=dev)
    assert blob == szt.compress(x, conf, backend="native")
    out, _ = szp.decompress(blob, device=dev)
    assert out.device.type == "cuda"
    ref, _ = szt.decompress(blob)
    assert np.array_equal(out.cpu().numpy().view(np.int32), ref.view(np.int32))
