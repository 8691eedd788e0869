"""Batched serving on the port (sz3_tpu_torch.serving), on the CPU with the
kernels' plain versions: the counterpart of each test in
tests/test_serving.py. Both packages take the same numpy stacks, made from
a seed. The port's archives are held to the JAX package's compress_batch
(bytes equal) and to the port's own single-field compress with INTERP
pinned, and its decompress_batch to the JAX package's, bit for bit."""

import numpy as np
import pytest
import torch

import sz3_tpu as szt
import sz3_tpu.config as J
import sz3_tpu_torch as szp
import sz3_tpu_torch.config as P
from sz3_tpu.serving import compress_batch as jax_compress_batch
from sz3_tpu.serving import decompress_batch as jax_decompress_batch
from sz3_tpu_torch import serving
from sz3_tpu_torch.algos import device_encode as de


def stack(b=5, n=24, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return np.exp(np.cumsum(rng.standard_normal((b, n, n, n)).astype(np.float32),
                            axis=-1) * 0.05).astype(dtype)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({4: np.int32, 8: np.int64}[a.dtype.itemsize])


def _singles(fields, make_conf):
    """The port's single-field archives, INTERP pinned by the caller's Config."""
    return [szp.compress(f, make_conf(P), device="cpu") for f in fields]


def _decodes_equal(blobs, fields, bound):
    """The port's decompress_batch == the JAX package's, bit for bit, and
    within `bound` of the fields."""
    out = serving.decompress_batch(blobs, device="cpu")
    ref = jax_decompress_batch(blobs)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert tuple(out.shape) == ref.shape and out.numpy().dtype == ref.dtype
    assert np.array_equal(_bits(out.numpy()), _bits(ref))
    err = np.abs(out.numpy().reshape(fields.shape).astype(np.float64) - fields).max()
    assert err <= bound
    return out


def _abs(ns, **kw):
    kw.setdefault("absErrorBound", 1e-3)
    return ns.Config(cmprAlgo=ns.ALGO.INTERP, **kw)


@pytest.fixture(scope="module")
def abs5():
    """Five fields at ABS 1e-3: the JAX package's batch archives and the
    port's single-field ones."""
    fields = stack()
    jax_blobs = jax_compress_batch(fields, _abs(J, dims=fields.shape[1:]))
    return fields, jax_blobs, _singles(fields, _abs)


@pytest.mark.parametrize("depth", [1, 3, 4])
@pytest.mark.parametrize("b", [1, 2, 5])
def test_archives_match_single_field_and_jax(abs5, monkeypatch, b, depth):
    """tests/test_serving.py::test_archives_match_single_field, at every
    batch size and pipeline depth: the same archives, each through the
    pipelined route's device half and host half once."""
    fields, jax_blobs, singles = abs5
    monkeypatch.setattr(serving, "DEPTH", depth)
    halves = []
    real = de.pack_device
    monkeypatch.setattr(de, "pack_device", lambda c, x: halves.append(1) or real(c, x))
    blobs = serving.compress_batch(fields[:b], _abs(P), device="cpu")
    assert len(halves) == b
    assert blobs == jax_blobs[:b] == singles[:b]


def test_roundtrip_and_standard_archives(abs5):
    """test_roundtrip_stack and test_archives_standard: the stack decodes
    bit-equal to the JAX package's decompress_batch, and every archive is a
    plain SZ3 container that the host engine opens to the same values."""
    fields, jax_blobs, _ = abs5
    out = _decodes_equal(jax_blobs, fields, 1e-3)
    for i, blob in enumerate(jax_blobs):
        assert np.array_equal(_bits(szt.decompress(blob)[0]), _bits(out[i].numpy()))


def test_default_algo_pins_interp(abs5):
    """conf=None: INTERP_LORENZO is pinned to INTERP (no tuner)."""
    fields = abs5[0][:2]
    blobs = serving.compress_batch(fields, device="cpu")
    assert blobs == jax_compress_batch(fields)
    assert blobs == _singles(fields, lambda ns: ns.Config(cmprAlgo=ns.ALGO.INTERP))
    _decodes_equal(blobs, fields, 1e-3)


def test_tensor_input_matches_numpy(abs5):
    fields, jax_blobs, _ = abs5
    assert serving.compress_batch(torch.from_numpy(fields[:2]), _abs(P),
                                  device="cpu") == jax_blobs[:2]


def test_rejects_non_stack():
    with pytest.raises(ValueError):
        serving.compress_batch(np.zeros(10, np.float32), device="cpu")
    with pytest.raises(ValueError):
        serving.decompress_batch([], device="cpu")


def test_rejects_archives_of_different_shapes():
    a = szp.compress(stack(1)[0], _abs(P), device="cpu")
    b = szp.compress(stack(1, n=20)[0], _abs(P), device="cpu")
    with pytest.raises(ValueError):
        serving.decompress_batch([a, b], device="cpu")


def test_size1_dim_matches_single_field():
    rng = np.random.default_rng(2)
    fields = np.cumsum(rng.standard_normal((2, 1, 64, 64)).astype(np.float32), axis=-1) * 0.1
    blobs = serving.compress_batch(fields, _abs(P, dims=fields.shape[1:]), device="cpu")
    assert blobs == jax_compress_batch(fields, _abs(J, dims=fields.shape[1:]))
    assert blobs == _singles(fields, _abs)
    out = _decodes_equal(blobs, fields, 1e-3)
    assert tuple(out.shape) == (2, 64, 64)


@pytest.mark.parametrize("mode", ["REL", "PSNR", "ABS_AND_REL", "ABS_OR_REL"])
def test_range_modes_match_single_field(mode):
    """test_rel_batch_matches_single_field_archives and
    test_psnr_and_combined_modes_round_trip: each field's bound resolves
    from its own range, as single-field compress resolves it."""
    rng = np.random.default_rng(0)
    fields = np.cumsum(rng.standard_normal((3, 24, 20, 16)).astype(np.float32), axis=-1) * 0.1
    fields[1] *= 5

    # the absolute bound of the combined modes is set where the relative one decides
    abs_eb = {"ABS_AND_REL": 1.0, "ABS_OR_REL": 1e-6}.get(mode, 1e-3)

    def make(ns):
        c = ns.Config(cmprAlgo=ns.ALGO.INTERP, errorBoundMode=getattr(ns.EB, mode),
                      absErrorBound=abs_eb, relErrorBound=1e-3, psnrErrorBound=60.0)
        c.interpAnchorStride = 32
        return c

    blobs = serving.compress_batch(fields, make(P), device="cpu")
    assert blobs == jax_compress_batch(fields, make(J))
    assert blobs == _singles(fields, make)
    ebs = [szp.open_archive(b)[0].absErrorBound for b in blobs]
    assert len(set(ebs)) == 3
    _decodes_equal(blobs, fields, max(ebs))


def test_float64_keeps_dtype(monkeypatch):
    """test_float64_roundtrip_keeps_dtype: f64 takes the same pipelined
    route (the JAX package's f64 batch goes through its bins-readback
    route)."""
    fields = stack(2, n=20, seed=4, dtype=np.float64)
    halves = []
    real = de.pack_device
    monkeypatch.setattr(de, "pack_device", lambda c, x: halves.append(x.dtype) or real(c, x))
    blobs = serving.compress_batch(fields, _abs(P, absErrorBound=1e-6), device="cpu")
    assert halves == [torch.float64] * 2
    assert blobs == jax_compress_batch(fields, _abs(J, dims=fields.shape[1:], absErrorBound=1e-6))
    assert blobs == _singles(fields, lambda ns: _abs(ns, absErrorBound=1e-6))
    out = _decodes_equal(blobs, fields, 1e-6)
    assert out.dtype == torch.float64


@pytest.mark.parametrize("depth", [1, 3])
def test_noise_fields_take_the_lossless_route(monkeypatch, depth):
    """Fields 2 and 4 (the middle and the last) are white noise far wider
    than the quantizer's reach: their lossy payloads fall below ratio 3 and
    lose to zstd, so they are sealed LOSSLESS, as single-field compress and
    the host engine seal them (test_fallback_field_still_sealed). The JAX
    package's bins-readback route skips the ratio rule and keeps them
    INTERP; its single-field compress does not."""
    fields = stack()
    rng = np.random.default_rng(9)
    fields[2] = rng.uniform(-1e4, 1e4, fields[2].shape)
    fields[4] = rng.uniform(-1e4, 1e4, fields[4].shape)
    monkeypatch.setattr(serving, "DEPTH", depth)
    blobs = serving.compress_batch(fields, _abs(P), device="cpu")
    assert blobs == _singles(fields, _abs)
    for i, blob in enumerate(blobs):
        assert blob == szt.compress(fields[i], _abs(J), backend="native")
        assert szp.open_archive(blob)[0].cmprAlgo == (P.ALGO.LOSSLESS if i in (2, 4)
                                                      else P.ALGO.INTERP)
    jax_blobs = jax_compress_batch(fields, _abs(J, dims=fields.shape[1:]))
    assert [i for i in range(5) if jax_blobs[i] != blobs[i]] == [2, 4]
    _decodes_equal(blobs, fields, 1e-3)


@pytest.mark.parametrize("case", ["lossless", "L2NORM", "LORENZO_REG", "int32"])
def test_field_by_field_routes(monkeypatch, case):
    """test_lossless_mode_falls_back, and the other inputs that go field by
    field through the port's compress: L2NORM, another algorithm, an
    integer dtype."""
    fields = stack(2, n=20, seed=6)
    kw = {"lossless": dict(absErrorBound=0.0),
          "L2NORM": dict(errorBoundMode="L2NORM", l2normErrorBound=0.5),
          "LORENZO_REG": dict(cmprAlgo="LORENZO_REG", absErrorBound=1e-3),
          "int32": dict(absErrorBound=2.0)}[case]
    if case == "int32":
        fields = (fields * 1000).astype(np.int32)

    def make(ns):
        c = ns.Config(**{k: (getattr(ns.EB, v) if k == "errorBoundMode" else
                             getattr(ns.ALGO, v) if k == "cmprAlgo" else v)
                         for k, v in kw.items()})
        if c.cmprAlgo == ns.ALGO.INTERP_LORENZO:
            c.cmprAlgo = ns.ALGO.INTERP         # as the batch pins it
        return c

    batched = []
    real = serving._compress_batch_device_entropy
    monkeypatch.setattr(serving, "_compress_batch_device_entropy",
                        lambda *a: batched.append(1) or real(*a))
    blobs = serving.compress_batch(fields, make(P), device="cpu")
    assert batched == []
    want = [szp.compress(f, make(P), device="cpu") for f in fields]
    assert blobs == want
    if case != "int32":
        assert blobs == jax_compress_batch(fields, make(J))
    out = serving.decompress_batch(blobs, device="cpu").numpy()
    assert np.array_equal(_bits(out), _bits(jax_decompress_batch(blobs)))
    if case == "lossless":
        assert np.array_equal(out, fields)
