"""ALGO_NOPRED on the port, on the CPU (the kernels' plain versions): the
quantizer against zero and the device Huffman stage on a stream in element
order. Archives are byte-equal to backend="native" and decodes bit-equal to
the host engine's, for float32 and float64, with a tolerance of zero."""

import numpy as np
import pytest
import torch

import sz3_tpu as szt
import sz3_tpu.config as J
import sz3_tpu_torch as szp
import sz3_tpu_torch.config as P
from sz3_tpu_torch import runtime
from sz3_tpu_torch.algos import device_decode as tdd
from sz3_tpu_torch.algos import device_encode as tde
from sz3_tpu_torch.ops import entropy_device as ted
from sz3_tpu_torch.ops import quantize as tq

CPU = torch.device("cpu")


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({4: np.int32, 8: np.int64}[a.dtype.itemsize])


def _field(shape, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.standard_normal(shape), axis=-1) * 0.1).astype(dtype)


def _nyx_like(shape, seed=0):
    """Values exp(+-1.75) as bench.nyx_like makes them: at ABS 1e-3 the
    symbols run to some 2,900 bins above radius, past K1's shared window."""
    rng = np.random.default_rng(seed)
    return np.exp(rng.uniform(-1.75, 1.75, shape)).astype(np.float32)


def _spy_route(monkeypatch):
    """Record each K1 call's histogram and forbid the host engine's NOPRED
    compress and decompress."""
    seen = []
    real = ted.hist_and_literals

    def spy(bins, radius):
        out = real(bins, radius)
        seen.append((out[0], radius))
        return out

    def refuse(*a, **k):
        raise AssertionError("host engine on the NOPRED device route")

    monkeypatch.setattr(ted, "hist_and_literals", spy)
    for name in ("compress_payload", "decompress_payload", "nopred_open"):
        monkeypatch.setattr(runtime, name, refuse)
    return seen


def _roundtrip(x, eb=1e-3, **kw):
    """Port archive == native archive; port decode == native decode, bit for
    bit; returns (archive's algorithm, port decode)."""
    bn = szt.compress(x, J.Config(cmprAlgo=J.ALGO.NOPRED, absErrorBound=eb), **kw)
    bp = szp.compress(x, P.Config(cmprAlgo=P.ALGO.NOPRED, absErrorBound=eb), device="cpu", **kw)
    assert bp == bn
    dn, cn = szt.decompress(bn)
    dp, cp = szp.decompress(bn, device="cpu")
    assert dp.dtype == torch.from_numpy(np.empty(0, x.dtype)).dtype
    assert np.array_equal(_bits(np.asarray(dn)), _bits(dp.numpy()))
    assert cp.save() == cn.save()
    return szp.open_archive(bn)[0].cmprAlgo, dp.numpy()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(4000,), (96, 113), (33, 37, 41), (9, 10, 11, 12)])
def test_nopred_matches_native(shape, dtype, monkeypatch):
    x = _field(shape, dtype, seed=len(shape))
    bn = szt.compress(x, J.Config(cmprAlgo=J.ALGO.NOPRED, absErrorBound=1e-2))
    seen = _spy_route(monkeypatch)
    bp = szp.compress(x, P.Config(cmprAlgo=P.ALGO.NOPRED, absErrorBound=1e-2), device="cpu")
    assert bp == bn and len(seen) == 1
    assert szp.open_archive(bp)[0].cmprAlgo == P.ALGO.NOPRED
    out, _ = szp.decompress(bn, device="cpu")
    monkeypatch.undo()
    want, _ = szt.decompress(bn)
    assert np.array_equal(_bits(want), _bits(out.numpy()))
    assert np.abs(out.numpy().astype(np.float64) - x).max() <= 1e-2


def test_streams_beyond_k1_window(monkeypatch):
    """Symbols farther than K1_W_HALF bins from radius (the kernel's cold
    path of global atomics)."""
    x = _nyx_like((20, 30, 40))
    seen = []
    real = ted.hist_and_literals
    monkeypatch.setattr(ted, "hist_and_literals",
                        lambda b, r: seen.append(b.clone()) or real(b, r))
    algo, out = _roundtrip(x)
    assert algo == P.ALGO.NOPRED and len(seen) == 1
    far = (seen[0][seen[0] != 0] - 32768).abs()
    assert int((far > ted.K1_W_HALF).sum()) > 1000
    assert np.abs(out.astype(np.float64) - x).max() <= 1e-3


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("value", [0.0, 1.25, -3e4])
def test_constant_field(value, dtype):
    """One symbol: the stream is the engine's one-leaf tree (an empty
    bitstream), and the ratio rule decides as the engine does."""
    x = np.full((24, 25, 26), value, dtype)
    _, out = _roundtrip(x)
    assert np.abs(out.astype(np.float64) - x).max() <= 1e-3


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_all_literal_field(dtype):
    """Every value beyond radius * 2eb: every bin is 0. The archive (zstd,
    by the ratio rule) equals the engine's, and the NOPRED payload itself
    opens in the engine and in the port to the input, bit for bit."""
    rng = np.random.default_rng(3)
    x = (1e5 + rng.standard_normal((20, 21, 22)) * 1e3).astype(dtype)
    algo, out = _roundtrip(x)
    assert np.array_equal(_bits(out), _bits(x))
    conf, cap = szp.api.archive_conf(x, P.Config(cmprAlgo=P.ALGO.NOPRED, absErrorBound=1e-3))
    payload = tde.encode_payload_device_nopred(conf, torch.from_numpy(x), cap)
    assert conf.cmprAlgo == P.ALGO.NOPRED
    assert np.array_equal(_bits(runtime.decompress_payload(conf, payload)), _bits(x))
    got = tdd.decode_payload_device_nopred(conf.copy(), payload, dtype, CPU)
    assert np.array_equal(_bits(got.numpy()), _bits(x.reshape(-1)))


def test_nonfinite_and_subnormal_values():
    x = _field((30, 31, 32), seed=9)
    flat = x.reshape(-1)
    flat[::97] = np.nan
    flat[5::131] = np.inf
    flat[7::137] = -np.inf
    flat[11::139] = np.float32(3e-39)
    flat[13::149] = np.float32(2.0 ** 40)
    _roundtrip(x)


def test_integer_dtypes_ride_the_host_engine(monkeypatch):
    x = (_field((20, 21, 22), np.float64, seed=4) * 1000).astype(np.int32)
    monkeypatch.setattr(ted, "hist_and_literals",
                        lambda *a: pytest.fail("device route for integer data"))
    _roundtrip(x, eb=2.0)


def test_truncated_literal_stream_raises(monkeypatch):
    x = _field((24, 25, 26), seed=5)
    x.reshape(-1)[::40] = 1e6                              # some literals
    conf, cap = szp.api.archive_conf(x, P.Config(cmprAlgo=P.ALGO.NOPRED, absErrorBound=1e-3))
    payload = tde.encode_payload_device_nopred(conf, torch.from_numpy(x), cap)
    real = runtime.open_packed

    def short(*a, **kw):
        out = list(real(*a, **kw))
        assert out[6].size > 1
        out[6] = out[6][:-1]
        return tuple(out)

    monkeypatch.setattr(tdd.runtime, "open_packed", short)
    with pytest.raises(ValueError, match="literal stream length"):
        tdd.decode_payload_device_nopred(conf.copy(), payload, np.float32, CPU)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_quantize_and_recover_by_slices(dtype, monkeypatch):
    """The quantize and the recover run slice by slice (ops/quantize.SLICE,
    which bounds their float64 temporaries); slices that do not divide the
    field, with literals in many of them, give the engine's archive and
    decode."""
    monkeypatch.setattr(tq, "SLICE", 4093)
    x = _field((20, 31, 33), dtype, seed=7)
    x.reshape(-1)[::61] = 1e6
    calls = {"quantize": 0, "recover": 0}
    for mod, name in ((tde, "quantize"), (tdd, "recover")):
        real = getattr(mod, name)

        def spy(*a, _r=real, _n=name):
            calls[_n] += 1
            return _r(*a)

        monkeypatch.setattr(mod, name, spy)
    algo, out = _roundtrip(x)
    assert algo == P.ALGO.NOPRED
    assert calls == {"quantize": -(-x.size // 4093), "recover": -(-x.size // 4093)}
    lit = x == 1e6
    assert np.array_equal(_bits(out[lit]), _bits(x[lit]))
