"""The port end to end on the CPU, with a tolerance of zero: archives
byte-equal to backend="native" and backend="jax", reconstructions bit-equal,
and the golden archives decoded to their recorded hashes."""

import hashlib
import json

import numpy as np
import pytest
import torch

import sz3_tpu as szt
import sz3_tpu_torch as szp
from sz3_tpu.config import ALGO, Config, EB, INTERP_ALGO
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
    assert tuple(dp.shape) == tuple(np.asarray(dn).shape)
    assert np.array_equal(_bits(dn), _bits(dp.numpy()))
    assert cp.save() == cn.save()
    return dp.numpy()


def _three_way(x, make_conf, jax=True, **kw):
    bn = szt.compress(x, make_conf(), backend="native", **kw)
    bp = szp.compress(x, make_conf(), device="cpu", **kw)
    assert bp == bn
    if jax:
        assert szt.compress(x, make_conf(), backend="jax", **kw) == bn
    return bn


@pytest.mark.parametrize("shape", [(4000,), (96, 113), (33, 37, 41), (9, 10, 11, 12)])
@pytest.mark.parametrize("ia", [INTERP_ALGO.LINEAR, INTERP_ALGO.CUBIC])
def test_interp_matches_native_and_jax(shape, ia):
    x = _field(shape)
    blob = _three_way(x, lambda: Config(dims=shape, cmprAlgo=ALGO.INTERP, absErrorBound=1e-3,
                                        interpAlgo=ia))
    out = _same_decode(blob)
    assert np.abs(out.astype(np.float64) - x).max() <= 1e-3


def test_double():
    x = _field((40, 41, 42), np.float64, seed=3)
    blob = _three_way(x, lambda: Config(dims=x.shape, cmprAlgo=ALGO.INTERP, absErrorBound=1e-6))
    assert np.abs(_same_decode(blob) - x).max() <= 1e-6


def test_tuned_default_path():
    x = _field((48, 48, 48), seed=5)
    blob = _three_way(x, lambda: Config(dims=x.shape, absErrorBound=1e-3))
    _same_decode(blob)


def test_rel_mode():
    x = _field((40, 40, 40), seed=6)
    blob = _three_way(x, lambda: Config(dims=x.shape, cmprAlgo=ALGO.INTERP,
                                        errorBoundMode=EB.REL, relErrorBound=1e-4))
    out = _same_decode(blob)
    assert np.abs(out - x).max() <= float(x.max() - x.min()) * 1e-4 * 1.000001


def test_lossless_mode():
    x = _field((32, 32, 32), seed=7)
    blob = _three_way(x, lambda: Config(dims=x.shape, absErrorBound=0.0))
    assert np.array_equal(_same_decode(blob), x)


def test_size1_dims():
    rng = np.random.default_rng(9)
    x = (np.cumsum(rng.standard_normal((1, 64, 64)).astype(np.float32), axis=-1) * 0.1)
    blob = _three_way(x, lambda: Config(dims=x.shape, cmprAlgo=ALGO.INTERP, absErrorBound=1e-3),
                      set_datatype=False)
    out = _same_decode(blob, dtype=np.float32)
    assert np.abs(out.reshape(x.shape) - x).max() <= 1e-3


# the device-entropy cases of tests/test_device_entropy.py (anchor stride 32,
# 128 in 2D). The JAX package sends (65, 33, 40) at 1e-4 to the host (some
# bins fall outside its histogram window); the port's encode keeps it, and
# `wide` says that some symbols lie outside K1's shared-memory window
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

    def conf():
        c = Config(dims=dims, cmprAlgo=ALGO.INTERP, absErrorBound=eb, interpAlgo=algo)
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
    blob = _three_way(x, lambda: Config(dims=x.shape, cmprAlgo=ALGO.INTERP, absErrorBound=1e-3),
                      jax=False)
    assert len(seen) == 1
    _same_decode(blob)


def test_container_helpers():
    """pack_archive/open_archive write and read the container around a
    host-engine payload exactly as sz3_tpu's compress does."""
    from sz3_tpu import runtime

    x = _field((30, 31, 32), seed=15)
    c, cap = szp.api.archive_conf(x, Config(absErrorBound=1e-3))
    blob = szp.pack_archive(c, runtime.compress_payload(c, x, cap))
    assert blob == szt.compress(x, Config(absErrorBound=1e-3), backend="native")
    conf, payload = szp.open_archive(blob)
    assert conf.save() == c.save()
    assert np.array_equal(runtime.decompress_payload(conf, payload), szt.decompress(blob)[0])
    with pytest.raises(ValueError, match="magic"):
        szp.open_archive(b"\0" * 32)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_integer_dtypes_ride_the_host_engine(dtype):
    x = (_field((30, 31, 32), np.float64, seed=10) * 1000).astype(dtype)
    blob = _three_way(x, lambda: Config(dims=x.shape, cmprAlgo=ALGO.INTERP, absErrorBound=2.0),
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
    blob = _three_way(x, lambda: Config(dims=x.shape, cmprAlgo=ALGO.INTERP, absErrorBound=1e-3),
                      jax=False)
    _same_decode(blob)


@pytest.mark.parametrize("algo", [ALGO.NOPRED, ALGO.LORENZO_REG, ALGO.BIOMD])
def test_other_algorithms_raise(algo):
    x = _field((24, 24, 3), seed=12)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        szp.compress(x, Config(dims=x.shape, cmprAlgo=algo, absErrorBound=1e-3), device="cpu")


def test_openmp_raises():
    x = _field((32, 24, 24), seed=13)
    with pytest.raises(NotImplementedError, match="item 15"):
        szp.compress(x, Config(dims=x.shape, absErrorBound=1e-3, openmp=True), device="cpu")


def test_tensor_input():
    x = _field((33, 37, 41), seed=14)
    conf = Config(dims=x.shape, absErrorBound=1e-3)
    assert szp.compress(torch.from_numpy(x), conf, device="cpu") == \
        szt.compress(x, conf, backend="native")


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
        assert conf.cmprAlgo not in (ALGO.INTERP, ALGO.LOSSLESS)
        return
    assert conf.cmprAlgo in (ALGO.INTERP, ALGO.LOSSLESS)
    assert hashlib.sha256(out.numpy().tobytes()).hexdigest() == case["out_sha"]
