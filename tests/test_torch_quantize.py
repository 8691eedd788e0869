"""The port's quantizer is bit-equal to the JAX package's native-f64
quantizer (``_quantize_native`` / ``_recover_native``) for float32 and
float64, including inputs engineered to sit on f64 ulp ties and rounding
boundaries (the inputs of tests/test_exactf64.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sz3_tpu.ops.quantize import _quantize_native, _recover_native
from sz3_tpu_torch.ops.quantize import quantize, recover

RADIUS = 32768


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32 if a.dtype == np.float32 else np.int64)


def _check(data, pred, eb, radius=RADIUS):
    jb, jr = _quantize_native(jnp.asarray(data), jnp.asarray(pred), eb, radius)
    tb, tr = quantize(torch.from_numpy(data), torch.from_numpy(pred), eb, radius)
    assert np.array_equal(np.asarray(jb), tb.numpy())
    assert np.array_equal(_bits(jr), _bits(tr.numpy()))
    bins = np.array(jb)
    jrec = _recover_native(jnp.asarray(pred), jnp.asarray(bins), jnp.asarray(data), eb, radius)
    trec = recover(torch.from_numpy(pred), torch.from_numpy(bins), torch.from_numpy(data),
                   eb, radius)
    assert np.array_equal(_bits(jrec), _bits(trec.numpy()))
    return bins


EBS = [1e-3, 1e-4, 3.7e-2, 1.1920929e-07, 123.456, 1e-9]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("eb", EBS)
def test_random_uniform(eb, dtype):
    rng = np.random.default_rng(int(eb * 1e9) % 2**31)
    n = 1 << 14
    data = (rng.standard_normal(n) * 10).astype(dtype)
    pred = (data + rng.standard_normal(n) * (5 * eb)).astype(dtype)
    bins = _check(data, pred, eb)
    assert (bins != 0).any()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("eb", [1e-3, 7.3e-5])
def test_wide_scales(eb, dtype):
    rng = np.random.default_rng(7)
    n = 1 << 14
    scale = np.exp2(rng.integers(-40, 40, n)).astype(dtype)
    data = (rng.standard_normal(n) * scale).astype(dtype)
    pred = (data.astype(np.float64) * (1 + rng.standard_normal(n) * 1e-3)).astype(dtype)
    _check(data, pred, eb)


@pytest.mark.parametrize("eb", [1e-3, 2.5e-4])
def test_directed_ulp_boundaries(eb):
    """Data within a few f32 ulps of pred + q*eb (test_exactf64.py:95-113)."""
    rng = np.random.default_rng(11)
    qs = rng.integers(0, 2 * RADIUS, 1 << 14)
    pred = rng.standard_normal(1 << 14).astype(np.float32)
    base = pred.astype(np.float64) + qs * np.float64(eb)
    outs = []
    for bump in (-2, -1, 0, 1, 2):
        v = base.astype(np.float32)
        step = np.float32(np.inf) if bump >= 0 else np.float32(-np.inf)
        for _ in range(abs(bump)):
            v = np.nextafter(v, step)
        outs.append(v)
    _check(np.concatenate(outs), np.tile(pred, 5), eb)


def test_directed_ulp_boundaries_f64():
    eb = 1e-3
    rng = np.random.default_rng(12)
    qs = rng.integers(0, 2 * RADIUS, 1 << 12)
    pred = rng.standard_normal(1 << 12)
    base = pred + qs * eb
    outs = [base]
    for step in (np.inf, -np.inf):
        outs.append(np.nextafter(base, step))
    _check(np.concatenate(outs), np.tile(pred, 3), eb)


def test_exact_halfway_and_err_equality():
    """Exact halves and err == eb (test_exactf64.py:116-124)."""
    eb = 0.125
    rng = np.random.default_rng(3)
    pred = (rng.integers(-1000, 1000, 1 << 14) * np.float32(0.25)).astype(np.float32)
    q = rng.integers(-100, 100, 1 << 14)
    _check((pred.astype(np.float64) + (q + 0.5) * eb).astype(np.float32), pred, eb)
    _check((pred.astype(np.float64) + q * eb + eb).astype(np.float32), pred, eb)


def _np_quantize(data, pred, eb, radius=RADIUS):
    """IEEE numpy semantics of the host engine's quantizer (quantizer.hpp)."""
    with np.errstate(invalid="ignore", over="ignore"):
        diff = data - pred
        scaled = np.minimum(np.abs(diff).astype(np.float64) * (1.0 / eb), 2.0 * radius)
        qi = np.where(np.isnan(scaled), 0, scaled).astype(np.int32) + 1
        half = qi >> 1
        neg = diff < 0
        q = np.where(neg, -(half << 1), half << 1)
        dec = (pred.astype(np.float64) + q.astype(np.float64) * eb).astype(data.dtype)
        err = np.abs((dec - data).astype(np.float64))
    ok = (qi < 2 * radius) & (err <= eb)
    return (np.where(ok, np.where(neg, radius - half, radius + half), 0).astype(np.int32),
            np.where(ok, dec, data))


def test_specials_and_edges():
    """Signed zeros, subnormals, the f32 limits, Inf and NaN
    (test_exactf64.py:127-133). Non-finite inputs become literals. XLA on
    the CPU flushes subnormals to zero, the host engine and the port do not,
    so the subnormal lanes are held to IEEE numpy and the rest to JAX."""
    eb = 1e-3
    data = np.array([0.0, -0.0, 1e-38, -1e-38, 3.4e38, -3.4e38,
                     np.inf, -np.inf, np.nan, 1e-44, 5.0], np.float32)
    pred = np.array([0.0, 0.0, 0.0, 1e-38, 3.4e38, 3.39e38,
                     1.0, 0.0, 0.0, 0.0, 5.0], np.float32)
    normal = np.array([True, True, False, False, True, True, True, True, True, False, True])
    nb, nr = _np_quantize(data, pred, eb)
    tb, tr = quantize(torch.from_numpy(data), torch.from_numpy(pred), eb, RADIUS)
    assert np.array_equal(tb.numpy(), nb)
    assert np.array_equal(_bits(tr.numpy()), _bits(nr))
    assert (nb[6:9] == 0).all()
    _check(data[normal], pred[normal], eb)


def test_zero_diff_and_tiny_eb():
    data = np.full(64, 1.2345678, np.float32)
    _check(data, data.copy(), 1e-12)


@pytest.mark.parametrize("radius", [128, 8192, 32768])
def test_radius_clamp(radius):
    rng = np.random.default_rng(radius)
    data = (rng.standard_normal(4096) * 1000).astype(np.float32)
    pred = np.zeros_like(data)
    bins = _check(data, pred, 1e-2, radius)
    assert (bins == 0).any() and (bins != 0).any()


def test_zero_dim():
    jb, jr = _quantize_native(jnp.float32(1.5), jnp.float32(0.0), 1e-3, RADIUS)
    tb, tr = quantize(torch.tensor(1.5, dtype=torch.float32), torch.tensor(0.0), 1e-3, RADIUS)
    assert tb.dim() == 0 and int(tb) == int(jb)
    assert float(tr) == float(jr)
