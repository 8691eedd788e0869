"""The port end to end on the CPU, with a tolerance of zero: archives
byte-equal to backend="native" and backend="jax", reconstructions bit-equal,
and the golden archives decoded to their recorded hashes."""

import hashlib
import json

import numpy as np
import pytest
import torch

import sz3_tpu as szt
import sz3_tpu.config as J                      # the JAX package's Config classes
import sz3_tpu_torch as szp
import sz3_tpu_torch.config as P                # the port's own: a different class
from sz3_tpu_torch.config import ALGO, INTERP_ALGO
from sz3_tpu_torch.ops import entropy_device as ted

from conftest import GOLDEN


def _field(shape, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.standard_normal(shape).astype(dtype), axis=-1) * 0.1).astype(dtype)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[a.dtype.itemsize])


def _same_decode(blob, **kw):
    """Port decode == native decode, bit for bit; returns the port's."""
    dn, cn = szt.decompress(blob, **kw)
    dp, cp = szp.decompress(blob, device="cpu", **kw)
    assert isinstance(dp, torch.Tensor) and dp.device.type == "cpu"
    assert isinstance(cp, P.Config) and not isinstance(cp, J.Config)
    assert tuple(dp.shape) == tuple(np.asarray(dn).shape)
    assert np.array_equal(_bits(dn), _bits(dp.numpy()))
    assert cp.save() == cn.save()
    return dp.numpy()


def _three_way(x, make_conf, jax=True, **kw):
    """`make_conf(ns)` builds the Config from the namespace it is given: each
    package is handed a Config of its own class."""
    bn = szt.compress(x, make_conf(J), backend="native", **kw)
    bp = szp.compress(x, make_conf(P), device="cpu", **kw)
    assert bp == bn
    if jax:
        assert szt.compress(x, make_conf(J), backend="jax", **kw) == bn
    return bn


@pytest.mark.parametrize("shape", [(4000,), (96, 113), (33, 37, 41), (9, 10, 11, 12)])
@pytest.mark.parametrize("ia", [INTERP_ALGO.LINEAR, INTERP_ALGO.CUBIC])
def test_interp_matches_native_and_jax(shape, ia):
    x = _field(shape)
    blob = _three_way(x, lambda ns: ns.Config(dims=shape, cmprAlgo=ns.ALGO.INTERP, absErrorBound=1e-3,
                                        interpAlgo=ia))
    out = _same_decode(blob)
    assert np.abs(out.astype(np.float64) - x).max() <= 1e-3


def test_double_interp_decode():
    """f64 through the INTERP decode (the Huffman stream, the f64 literals
    and the passes), not the lossless store."""
    x = _field((40, 41, 42), np.float64, seed=3)
    blob = _three_way(x, lambda ns: ns.Config(dims=x.shape, cmprAlgo=ns.ALGO.INTERP,
                                              absErrorBound=1e-3))
    out, conf = szp.decompress(blob, device="cpu")
    assert conf.cmprAlgo == ALGO.INTERP and out.dtype == torch.float64
    assert np.abs(_same_decode(blob) - x).max() <= 1e-3


def test_wide_bins_decode():
    """Bins far from radius (a noisy slab at a tight bound) stay an INTERP
    archive and decode bit-equal."""
    rng = np.random.default_rng(11)
    x = (np.cumsum(rng.standard_normal((64, 64, 64)), axis=2) * 0.01).astype(np.float32)
    x[:6] += rng.standard_normal((6, 64, 64)).astype(np.float32) * 0.2
    blob = _three_way(x, lambda ns: ns.Config(dims=x.shape, cmprAlgo=ns.ALGO.INTERP,
                                              absErrorBound=1e-5), jax=False)
    assert szp.open_archive(blob)[0].cmprAlgo == ALGO.INTERP
    assert np.abs(_same_decode(blob).astype(np.float64) - x).max() <= 1e-5


def test_payload_wins_over_stale_tail():
    """A Config that names another interpolator than the payload header (the
    tail records the tuner's choice, the interp compressor may store another)
    decodes by the payload (tests/test_device_decode.py)."""
    from sz3_tpu_torch.algos import device_decode as tdd

    x = _field((48, 40, 36), seed=7)
    conf = J.Config(dims=x.shape, cmprAlgo=J.ALGO.INTERP, absErrorBound=1e-3)
    conf.interpAnchorStride = 16
    conf.interpAlgo = 0                                  # the payload: LINEAR
    blob = szt.compress(x, conf, set_datatype=False)
    want, _ = szt.decompress(blob, dtype=np.float32)
    stale, payload = szp.open_archive(blob)
    stale.interpAlgo = INTERP_ALGO.CUBIC                 # the tail claims CUBIC
    stale.interpAnchorStride = 32                        # and the default stride
    got = tdd.decode_payload_device(stale, payload, np.float32, torch.device("cpu"))
    assert np.array_equal(_bits(got.numpy()), _bits(want))
    assert stale.interpAlgo == INTERP_ALGO.LINEAR and stale.interpAnchorStride == 16


def test_decode_uses_no_host_huffman_walk(monkeypatch):
    """The float decode opens the payload without the host bit-walk and
    places nothing on the host."""
    from sz3_tpu_torch import runtime

    def refuse(*a, **k):
        raise AssertionError("host Huffman walk or host placement on the float decode path")

    x = _field((33, 37, 41), seed=2)
    blob = szp.compress(x, P.Config(cmprAlgo=ALGO.INTERP, absErrorBound=1e-3), device="cpu")
    want = _same_decode(blob)
    for name in ("interp_open", "perm_place", "interp_place", "huff_decode",
                 "decompress_payload"):
        monkeypatch.setattr(runtime, name, refuse)
    out, _ = szp.decompress(blob, device="cpu")
    assert np.array_equal(_bits(out.numpy()), _bits(want))


def test_double():
    x = _field((40, 41, 42), np.float64, seed=3)
    blob = _three_way(x, lambda ns: ns.Config(dims=x.shape, cmprAlgo=ns.ALGO.INTERP, absErrorBound=1e-6))
    assert np.abs(_same_decode(blob) - x).max() <= 1e-6


def test_tuned_default_path():
    x = _field((48, 48, 48), seed=5)
    blob = _three_way(x, lambda ns: ns.Config(dims=x.shape, absErrorBound=1e-3))
    _same_decode(blob)


def test_rel_mode():
    x = _field((40, 40, 40), seed=6)
    blob = _three_way(x, lambda ns: ns.Config(dims=x.shape, cmprAlgo=ns.ALGO.INTERP,
                                        errorBoundMode=ns.EB.REL, relErrorBound=1e-4))
    out = _same_decode(blob)
    assert np.abs(out - x).max() <= float(x.max() - x.min()) * 1e-4 * 1.000001


def test_lossless_mode():
    x = _field((32, 32, 32), seed=7)
    blob = _three_way(x, lambda ns: ns.Config(dims=x.shape, absErrorBound=0.0))
    assert np.array_equal(_same_decode(blob), x)


def test_size1_dims():
    rng = np.random.default_rng(9)
    x = (np.cumsum(rng.standard_normal((1, 64, 64)).astype(np.float32), axis=-1) * 0.1)
    blob = _three_way(x, lambda ns: ns.Config(dims=x.shape, cmprAlgo=ns.ALGO.INTERP, absErrorBound=1e-3),
                      set_datatype=False)
    out = _same_decode(blob, dtype=np.float32)
    assert np.abs(out.reshape(x.shape) - x).max() <= 1e-3


# the device-entropy cases of tests/test_device_entropy.py (anchor stride 32,
# 128 in 2D). The JAX package sends (65, 33, 40) at 1e-4 to the host (some
# bins fall outside its histogram window); the port's encode keeps it, and
# `wide` says that some symbols lie outside that window (ted.W_HALF)
ENTROPY_CASES = [((40, 33, 27), 1e-3, 1, False), ((64, 64, 64), 1e-3, 1, False),
                 ((65, 33, 40), 1e-4, 1, True), ((40, 33, 27), 1e-3, 0, False),
                 ((129, 129), 1e-3, 1, False), ((33, 34, 35, 20), 1e-3, 1, False)]


def _spy_hist(monkeypatch):
    """Record the histograms the encode computes."""
    seen = []
    real = ted.hist_and_literals

    def spy(bins, radius):
        out = real(bins, radius)
        seen.append((out[0], radius))
        return out

    monkeypatch.setattr(ted, "hist_and_literals", spy)
    return seen


def _outside_window(hist, radius):
    lo = max(2, radius + 1 - ted.W_HALF)
    return int(hist[2:].sum() - hist[lo:lo + 2 * ted.W_HALF].sum())


@pytest.mark.parametrize("dims,eb,algo,wide", ENTROPY_CASES)
def test_device_entropy_route(dims, eb, algo, wide, monkeypatch):
    rng = np.random.default_rng(3)
    x = np.ascontiguousarray(np.cumsum(rng.standard_normal(dims), axis=0).astype(np.float32)
                             * 0.1)

    def conf(ns):
        c = ns.Config(dims=dims, cmprAlgo=ns.ALGO.INTERP, absErrorBound=eb, interpAlgo=algo)
        c.interpAnchorStride = 128 if len(dims) == 2 else 32
        return c

    seen = _spy_hist(monkeypatch)
    blob = _three_way(x, conf, jax=False)
    assert len(seen) == 1
    assert (_outside_window(*seen[0]) > 0) == wide
    _same_decode(blob)


def test_no_anchor_grid_stays_on_device(monkeypatch):
    """A field no larger than the anchor stride has no anchor grid; its
    encode takes the entropy kernels' route all the same."""
    seen = _spy_hist(monkeypatch)
    x = _field((20, 20, 20), seed=8)
    blob = _three_way(x, lambda ns: ns.Config(dims=x.shape, cmprAlgo=ns.ALGO.INTERP, absErrorBound=1e-3),
                      jax=False)
    assert len(seen) == 1
    _same_decode(blob)


def test_container_helpers():
    """pack_archive/open_archive write and read the container around a
    host-engine payload exactly as sz3_tpu's compress does."""
    from sz3_tpu_torch import runtime

    x = _field((30, 31, 32), seed=15)
    c, cap = szp.api.archive_conf(x, P.Config(absErrorBound=1e-3))
    blob = szp.pack_archive(c, runtime.compress_payload(c, x, cap))
    assert blob == szt.compress(x, J.Config(absErrorBound=1e-3), backend="native")
    conf, payload = szp.open_archive(blob)
    assert conf.save() == c.save()
    assert np.array_equal(runtime.decompress_payload(conf, payload), szt.decompress(blob)[0])
    with pytest.raises(ValueError, match="magic"):
        szp.open_archive(b"\0" * 32)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_integer_dtypes_ride_the_host_engine(dtype):
    x = (_field((30, 31, 32), np.float64, seed=10) * 1000).astype(dtype)
    blob = _three_way(x, lambda ns: ns.Config(dims=x.shape, cmprAlgo=ns.ALGO.INTERP, absErrorBound=2.0),
                      jax=False)
    _same_decode(blob)


def test_nonfinite_and_subnormal_values():
    """NaN, Inf and subnormal values become literals exactly as in the host
    engine."""
    x = _field((40, 36, 33), seed=11)
    flat = x.reshape(-1)
    flat[::97] = np.nan
    flat[5::131] = np.inf
    flat[7::137] = -np.inf
    flat[11::139] = np.float32(3e-39)
    blob = _three_way(x, lambda ns: ns.Config(dims=x.shape, cmprAlgo=ns.ALGO.INTERP, absErrorBound=1e-3),
                      jax=False)
    _same_decode(blob)


@pytest.mark.parametrize("algo", [ALGO.NOPRED, ALGO.LORENZO_REG, ALGO.BIOMD])
def test_other_algorithms_raise(algo):
    x = _field((24, 24, 3), seed=12)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        szp.compress(x, P.Config(dims=x.shape, cmprAlgo=algo, absErrorBound=1e-3), device="cpu")


def test_openmp_raises():
    x = _field((32, 24, 24), seed=13)
    with pytest.raises(NotImplementedError, match="item 15"):
        szp.compress(x, P.Config(dims=x.shape, absErrorBound=1e-3, openmp=True), device="cpu")


def test_tensor_input():
    x = _field((33, 37, 41), seed=14)
    assert szp.compress(torch.from_numpy(x), P.Config(dims=x.shape, absErrorBound=1e-3),
                        device="cpu") == \
        szt.compress(x, J.Config(dims=x.shape, absErrorBound=1e-3), backend="native")


_MANIFEST = json.loads((GOLDEN / "manifest.json").read_text())
_GOLDEN = [c for c in _MANIFEST if c["dtype"] in ("float32", "float64") and not c["env"]]


@pytest.mark.parametrize("case", _GOLDEN, ids=[c["name"] for c in _GOLDEN])
def test_golden_corpus(case):
    """Golden reference archives of the slice's algorithms (INTERP, LOSSLESS)
    decode to their recorded hash; the others raise NotImplementedError."""
    ref = (GOLDEN / f"{case['name']}.sz").read_bytes()
    try:
        out, conf = szp.decompress(ref, device="cpu", dtype=np.dtype(case["dtype"]))
    except NotImplementedError as e:
        assert "ROADMAP" in str(e)
        _, conf = szt.decompress(ref, dtype=np.dtype(case["dtype"]))
        assert int(conf.cmprAlgo) not in (ALGO.INTERP, ALGO.LOSSLESS)
        return
    assert conf.cmprAlgo in (ALGO.INTERP, ALGO.LOSSLESS)
    assert hashlib.sha256(out.numpy().tobytes()).hexdigest() == case["out_sha"]


def test_device_defaults_to_the_card():
    """compress and decompress run on the card unless the caller asks for the
    CPU: without a device argument, on a machine without a card, they raise."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    x = np.zeros((8, 8, 8), np.float32)
    with pytest.raises(RuntimeError, match="is_available"):
        szp.compress(x, P.Config(absErrorBound=1e-3))
    blob = szp.compress(x, P.Config(absErrorBound=1e-3), device="cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        szp.decompress(blob)
