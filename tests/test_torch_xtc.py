"""ALGO_BIOMDXTC on the port, on the CPU: one elementwise quantize at the
XTC radius (ops/xtc_device.py), the XTC triplet coder in the host engine.
Archives are byte-equal to backend="native", decodes bit-equal to the
engine's, and the quantizer bit-equal to the JAX package's native-f64 forms
(on the CPU with x64, as that package's own tests run them)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sz3_tpu as szt
import sz3_tpu.config as J
import sz3_tpu_torch as szp
import sz3_tpu_torch.config as P
from sz3_tpu.ops import xtc_device as jxtc
from sz3_tpu_torch import runtime
from sz3_tpu_torch.algos import device_decode as tdd
from sz3_tpu_torch.ops import quantize as tq
from sz3_tpu_torch.ops import xtc_device as txtc

from test_xtc_device import CASES, EBS, md_traj

CPU = torch.device("cpu")


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({4: np.int32, 8: np.int64}[a.dtype.itemsize])


def _roundtrip(x, eb=1e-3, **kw):
    bn = szt.compress(x, J.Config(cmprAlgo=J.ALGO.BIOMDXTC, absErrorBound=eb), **kw)
    bp = szp.compress(x, P.Config(cmprAlgo=P.ALGO.BIOMDXTC, absErrorBound=eb), device="cpu",
                      **kw)
    assert bp == bn
    dn, cn = szt.decompress(bn)
    dp, cp = szp.decompress(bn, device="cpu")
    assert np.array_equal(_bits(np.asarray(dn)), _bits(dp.numpy()))
    assert cp.save() == cn.save()
    return bn


def _spy(monkeypatch):
    calls = []
    for name in ("xtc_quantize", "xtc_recover"):
        real = getattr(txtc, name)
        monkeypatch.setattr(txtc, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))

    def refuse(*a, **k):
        raise AssertionError("host engine on the BIOMDXTC device route")

    monkeypatch.setattr(runtime, "compress_payload", refuse)
    monkeypatch.setattr(runtime, "decompress_payload", refuse)
    return calls


@pytest.mark.parametrize("eb", EBS)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_3d_matches_native(case, eb, monkeypatch):
    """tests/test_xtc_device.py's trajectories, a fill tail among them."""
    traj = md_traj(**CASES[case])
    calls = _spy(monkeypatch)
    _roundtrip(traj, eb)
    assert calls == ["xtc_quantize", "xtc_recover"]


@pytest.mark.parametrize("shape", [(64, 9), (731,), (3, 5000)])
def test_1d_and_2d(shape, monkeypatch):
    """1D and 2D data have no fill-frame trim (reference biomd.hpp:246-253)."""
    rng = np.random.default_rng(5)
    x = np.cumsum(rng.normal(0, 0.01, shape), axis=-1).astype(np.float32)
    calls = _spy(monkeypatch)
    _roundtrip(x)
    assert calls == ["xtc_quantize", "xtc_recover"]


def _special_values(n=1 << 15, seed=11):
    rng = np.random.default_rng(seed)
    data = (rng.standard_normal(n) * np.exp2(rng.integers(-24, 12, n))).astype(np.float32)
    data[:6] = [0.0, -0.0, np.inf, -np.inf, np.nan, np.float32(3e-39)]
    return data


def _at_the_clamp(eb):
    """Values whose |x| / eb lies around 2 * XTC_RADIUS, the clamp."""
    c = 2 * txtc.XTC_RADIUS * eb
    return np.array([c * f for f in (0.999999, 0.9999999, 1.0, 1.0000001, 1.000001, 2.0, 1e3)]
                    + [-c, c / 2, c / 4 * 3], np.float32)


@pytest.mark.parametrize("eb", [1e-3, 3.7e-5, 123.0])
def test_quantize_and_recover_match_jax(eb):
    assert txtc.XTC_RADIUS == jxtc.XTC_RADIUS and txtc._tol32(eb) == jxtc._tol32(eb)
    data = np.concatenate([_special_values(), _at_the_clamp(eb)])
    want = np.asarray(jxtc._xtc_quantize_native(jnp.asarray(data), eb))
    got = txtc.xtc_quantize(torch.from_numpy(data), eb).numpy()
    assert np.array_equal(want, got)
    assert (got == -txtc.XTC_RADIUS).any() and (got != -txtc.XTC_RADIUS).any()
    lits = np.where(want == -txtc.XTC_RADIUS, data, 0).astype(np.float32)
    jrec = np.asarray(jxtc.xtc_recover(jnp.asarray(want), jnp.asarray(lits), eb))
    trec = txtc.xtc_recover(torch.from_numpy(got), torch.from_numpy(lits), eb).numpy()
    assert np.array_equal(_bits(jrec), _bits(trec))


def test_nonfinite_and_clamp_values_in_archives():
    traj = md_traj(frames=10, atoms=120, seed=4)
    flat = traj.reshape(-1)
    flat[::97] = np.nan
    flat[5::131] = np.inf
    flat[7::137] = -np.inf
    flat[11::139] = np.float32(3e-39)
    flat[13::149] = _at_the_clamp(1e-3)[2]
    flat[17::151] = -_at_the_clamp(1e-3)[0]
    _roundtrip(traj)


@pytest.mark.parametrize("case", ["f64", "4d", "int32"])
def test_engine_routes(case, monkeypatch):
    rng = np.random.default_rng(6)
    x = {"f64": lambda: md_traj().astype(np.float64),
         "4d": lambda: md_traj(frames=4, atoms=30).reshape(2, 2, 30, 3),
         "int32": lambda: (md_traj() * 1000).astype(np.int32)}[case]()
    monkeypatch.setattr(txtc, "xtc_quantize", lambda *a: pytest.fail("device route"))
    monkeypatch.setattr(txtc, "xtc_recover", lambda *a: pytest.fail("device route"))
    if case == "4d":
        for pkg, kw in ((szt, {}), (szp, {"device": "cpu"})):
            with pytest.raises(RuntimeError):
                pkg.compress(x, pkg.Config(cmprAlgo=pkg.ALGO.BIOMDXTC, absErrorBound=1e-3), **kw)
        return
    _roundtrip(x, eb=1e-6 if case == "f64" else 2.0)


def test_literal_count_mismatch_raises(monkeypatch):
    traj = md_traj(frames=8, atoms=60, seed=2)
    traj.reshape(-1)[::50] = np.nan
    conf = P.Config(dims=traj.shape, cmprAlgo=P.ALGO.BIOMDXTC, absErrorBound=1e-3)
    payload = runtime.compress_payload(conf, traj.copy(), 2 * traj.nbytes + 4096)
    real = runtime.biomdxtc_open

    def short(*a):
        stored, unpred, first_fill, fill = real(*a)
        assert unpred.size > 1
        return stored, unpred[:-1], first_fill, fill

    monkeypatch.setattr(runtime, "biomdxtc_open", short)
    with pytest.raises(ValueError, match="literal count"):
        tdd.decode_payload_device_biomdxtc(conf, payload, CPU)


@pytest.mark.parametrize("kw", [dict(frames=10, atoms=120, seed=4),
                                dict(frames=12, atoms=90, seed=5, fill_tail=3)])
def test_quantize_and_recover_by_slices(kw, monkeypatch):
    """The quantize and the recover run slice by slice (ops/quantize.SLICE);
    slices that do not divide the live frames, literals among them, give
    the engine's archive and decode."""
    monkeypatch.setattr(tq, "SLICE", 997)
    traj = md_traj(**kw)
    frames = kw["frames"] - kw.get("fill_tail", 0)
    traj[:frames].reshape(-1)[::53] = np.nan          # literals in the live frames
    calls = []
    for name in ("xtc_quantize", "xtc_recover"):
        real = getattr(txtc, name)
        monkeypatch.setattr(txtc, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    _roundtrip(traj)
    n = -(-frames * kw["atoms"] * 3 // 997)
    assert calls == ["xtc_quantize"] * n + ["xtc_recover"] * n
