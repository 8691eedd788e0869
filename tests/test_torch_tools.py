"""The port's user-facing modules on the CPU, each held against its JAX
counterpart: verify (sz3_tpu.stats.verify), pysz (sz3_tpu.pysz), the
secondary encoders (sz3_tpu.encoders), the preprocessors
(sz3_tpu.preprocess), the timers and the trace (sz3_tpu.utils), the
profiling tools and the ParaView reader (tools/).

Tolerances: verify's min, max and max_abs_err are exact (float64 of the same
values); the other quantities are sums, taken in another order (slices of
2^22 elements, torch's reductions against numpy's pairwise sums), and agree
to a relative 1e-12. transpose and prefilter are exact; the wavelet's
window products (`windows @ H`) may sum in another order than numpy's
matmul, and agree to 1e-12 of the largest coefficient."""

import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import sz3_tpu as szt
import sz3_tpu.encoders as jenc
import sz3_tpu.preprocess as jpre
import sz3_tpu.pysz as jpysz
import sz3_tpu.stats as jstats
import sz3_tpu_torch as szp
import sz3_tpu_torch.encoders as penc
import sz3_tpu_torch.preprocess as ppre
import sz3_tpu_torch.pysz as ppysz
from sz3_tpu_torch import utils as putils

ROOT = Path(__file__).resolve().parents[1]
EXACT = ("min", "max", "value_range", "max_abs_err", "max_rel_err")


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def _close(a, b, rel=1e-12):
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    if math.isinf(a) or math.isinf(b):
        return a == b
    return abs(a - b) <= rel * max(abs(a), abs(b)) or abs(a - b) <= 1e-300


def _pairs():
    rng = np.random.default_rng(0)
    x = (np.cumsum(rng.standard_normal((12, 20, 30)), axis=-1) * 0.1).astype(np.float32)
    noisy = (x + rng.uniform(-1e-3, 1e-3, x.shape)).astype(np.float32)
    nan_o, nan_d = x.copy(), noisy.copy()
    nan_o[3, 4, 5] = np.nan
    nan_d[7, 1, 2] = np.nan
    zeros_o = x.copy()
    zeros_o[::2] = 0
    ints = rng.integers(-1000, 1000, (40, 50)).astype(np.int32)
    return {
        "smooth": (x, noisy),
        "f64": (x.astype(np.float64), noisy.astype(np.float64) + 1e-9),
        "nan_in_original": (nan_o, noisy),
        "nan_in_decoded": (x, nan_d),
        "constant": (np.full((30, 40), 2.5, np.float32), np.full((30, 40), 2.5, np.float32)),
        "constant_with_error": (np.full((30, 40), 2.5, np.float32),
                                np.full((30, 40), 2.5, np.float32) + 1e-3),
        "all_zero": (np.zeros((50, 60), np.float32), np.zeros((50, 60), np.float32)),
        "some_zero_originals": (zeros_o, noisy),
        "exact_equal": (x, x.copy()),
        "int32": (ints, ints + rng.integers(-2, 3, ints.shape).astype(np.int32)),
        "inf": (np.array([1.0, np.inf, 3.0], np.float64), np.array([1.0, np.inf, 3.5])),
        "large_1d": (rng.standard_normal(3 * (1 << 22) // 2), rng.standard_normal(3 * (1 << 22) // 2)),
    }


@pytest.mark.parametrize("name", list(_pairs()))
def test_verify_matches_the_jax_package(name):
    o, d = _pairs()[name]
    with np.errstate(all="ignore"):
        want = jstats.verify(o, d)
    got = szp.verify(torch.from_numpy(o), torch.from_numpy(d))   # a CPU tensor: on the CPU
    for f in want.__dataclass_fields__:
        a, b = getattr(got, f), getattr(want, f)
        if f in EXACT:
            assert (a == b) or (math.isnan(a) and math.isnan(b)), (f, a, b)
        else:
            assert _close(a, b), (f, a, b)
    if name not in ("smooth", "f64", "large_1d", "some_zero_originals", "int32"):
        assert got.report() == want.report()


def test_verify_takes_arrays_and_defaults_to_the_card():
    o, d = _pairs()["smooth"]
    assert szp.verify(o, d, device="cpu").report() == jstats.verify(o, d).report()
    _no_card()
    with pytest.raises(RuntimeError, match="cuda"):
        szp.verify(o, d)


def test_verify_refuses_unequal_counts():
    with pytest.raises(ValueError):
        szp.verify(np.zeros(10), np.zeros(11), device="cpu")


def _pysz_field():
    return np.fromfunction(lambda i, j, k: np.sin(i / 9) + np.cos(j / 7) + k / 40,
                           (20, 30, 40)).astype(np.float32)


@pytest.mark.parametrize("mode,algo", [("ABS", None), ("REL", None), ("ABS", "LORENZO_REG"),
                                       ("ABS", "NOPRED"), ("PSNR", "INTERP")])
def test_pysz_bytes_equal_the_jax_binding(mode, algo):
    data = _pysz_field()
    blobs, outs = [], []
    for mod, kw in ((jpysz, {}), (ppysz, {"device": "cpu"})):
        conf = mod.szConfig(data.shape)
        conf.errorBoundMode = getattr(mod.szErrorBoundMode, mode)
        conf.absErrorBound, conf.relErrorBound, conf.psnrErrorBound = 1e-3, 1e-3, 70.0
        if algo:
            conf.cmprAlgo = getattr(mod.szAlgorithm, algo)
        blob, ratio = mod.sz.compress(data, conf, **kw)
        assert ratio == data.nbytes / blob.size
        out, used = mod.sz.decompress(blob, np.float32, data.shape, **kw)
        assert isinstance(out, np.ndarray) and out.dtype == np.float32 and out.shape == data.shape
        blobs.append(blob)
        outs.append((out, mod.sz.verify(data, out, **kw), used.dims))
    assert np.array_equal(blobs[0], blobs[1])
    assert np.array_equal(outs[0][0], outs[1][0]) and outs[0][2] == outs[1][2]
    (jd, jp, jn), (pd, pp, pn) = outs[0][1], outs[1][1]
    assert jd == pd and _close(jp, pp) and _close(jn, pn)


def test_pysz_verify_corner_cases():
    for o, d in ((np.ones(100), np.ones(100)), (np.ones(100), np.ones(100) * 1.5),
                 (np.zeros(64, np.float32), np.zeros(64, np.float32))):
        with np.errstate(all="ignore"):
            want = jpysz.sz.verify(o, d)
            got = ppysz.sz.verify(o, d, device="cpu")
        assert got[0] == want[0] and got[1] == want[1] and got[2] == want[2]


def test_pysz_defaults_to_the_card():
    _no_card()
    data = _pysz_field()
    conf = ppysz.szConfig(data.shape)
    with pytest.raises(RuntimeError, match="cuda"):
        ppysz.sz.compress(data, conf)
    blob, _ = jpysz.sz.compress(data, jpysz.szConfig(data.shape))
    with pytest.raises(RuntimeError, match="cuda"):
        ppysz.sz.decompress(blob, np.float32, data.shape)
    with pytest.raises(RuntimeError, match="cuda"):
        ppysz.sz.verify(data, data)


def test_pysz_type_checks():
    conf = ppysz.szConfig((4, 4))
    with pytest.raises(TypeError):
        ppysz.sz.compress([1.0, 2.0], conf, device="cpu")
    with pytest.raises(TypeError):
        ppysz.sz.compress(np.zeros(4, np.int16), conf, device="cpu")
    with pytest.raises(ValueError):
        ppysz.szConfig(0, 3)


def _bins(kind):
    rng = np.random.default_rng(2)
    if kind == "mod100":
        return (np.arange(1000) % 100).astype(np.int32), 100
    if kind == "skewed":
        return np.where(rng.random(200000) < 0.9, 2048,
                        rng.integers(0, 4096, 200000)).astype(np.int32), 4096
    if kind == "runs":
        return np.repeat(np.arange(20, dtype=np.int32), 1000), 20
    return np.full(5000, 7, dtype=np.int32), 100


@pytest.mark.parametrize("kind", ["mod100", "skewed", "runs", "single"])
@pytest.mark.parametrize("transform", [False, True])
def test_arithmetic_coder_bytes_equal_the_jax_package(kind, transform):
    bins, states = _bins(kind)
    blob = penc.arithmetic_encode(bins, states, transform)
    assert blob == jenc.arithmetic_encode(bins, states, transform)
    assert np.array_equal(penc.arithmetic_decode(blob, bins.size, transform), bins)


@pytest.mark.parametrize("kind", ["mod100", "skewed", "runs", "single"])
def test_runlength_coder_bytes_equal_the_jax_package(kind):
    bins, _ = _bins(kind)
    blob = penc.runlength_encode(bins)
    assert blob == jenc.runlength_encode(bins)
    assert np.array_equal(penc.runlength_decode(blob, bins.size), bins)


@pytest.mark.parametrize("byte_len", [1, 2, 3, 4])
def test_truncate_bytes_equal_the_jax_package(byte_len):
    data = np.random.default_rng(5).normal(0, 1, 10000).astype(np.float32)
    blob = penc.truncate_compress(data, byte_len)
    assert blob == jenc.truncate_compress(data, byte_len)
    out = penc.truncate_decompress(blob, data.size, byte_len)
    assert np.array_equal(out, jenc.truncate_decompress(blob, data.size, byte_len))
    if byte_len == 4:
        assert np.array_equal(out, data)


def test_encoder_errors_raise():
    with pytest.raises(RuntimeError):
        penc.arithmetic_encode(np.zeros(10, np.int32), 5000)


def test_transpose_and_prefilter_exact():
    rng = np.random.default_rng(0)
    a = rng.normal(0, 1, (5, 7, 9, 3)).astype(np.float32)
    for axes in ((3, 1, 0, 2), (0, 1, 2, 3), (2, 3, 0, 1)):
        out = ppre.transpose(torch.from_numpy(a), axes)
        assert out.is_contiguous()
        assert np.array_equal(out.numpy(), jpre.transpose(a, axes))
    with pytest.raises(ValueError):
        ppre.transpose(torch.zeros((2,) * 5), (0, 1, 2, 3, 4))
    b = np.array([-5.0, 0.5, 3.0, 0.1, np.nan, -1.0, 1.0], dtype=np.float32)
    t = torch.from_numpy(b)
    got = ppre.prefilter(t, (-1.0, 1.0), 9.0)
    assert np.array_equal(got.numpy(), jpre.prefilter(b, (-1.0, 1.0), 9.0), equal_nan=True)
    assert t[0] == -5.0                        # input untouched
    assert np.array_equal(ppre.prefilter(a, (-0.5, 0.5), 0.0, device="cpu").numpy(),
                          jpre.prefilter(a, (-0.5, 0.5), 0.0))


@pytest.mark.parametrize("n", [1, 3, 64, 1000, 4097])
def test_wavelet_matches_the_jax_package(n):
    x = np.random.default_rng(1).normal(0, 1, n)
    cj = jpre.wavelet_forward(x)
    cp = ppre.wavelet_forward(torch.from_numpy(x)).numpy()
    assert cp.shape == cj.shape
    assert np.abs(cp - cj).max() <= 1e-12 * max(1.0, np.abs(cj).max())
    back = ppre.wavelet_inverse(torch.from_numpy(cj), n).numpy()
    assert np.abs(back - jpre.wavelet_inverse(cj, n)).max() <= 1e-12 * max(1.0, np.abs(x).max())
    assert np.abs(back - x).max() < 1e-9


def test_preprocessors_put_arrays_on_the_card():
    _no_card()
    with pytest.raises(RuntimeError, match="cuda"):
        ppre.transpose(np.zeros((2, 3)), (1, 0))
    with pytest.raises(RuntimeError, match="cuda"):
        ppre.wavelet_forward(np.zeros(8))


def test_timer_gate(monkeypatch, capsys):
    monkeypatch.setenv("SZT_DEBUG_TIMINGS", "0")
    assert not putils.timings_enabled()
    t = putils.Timer(start=True)
    time.sleep(0.01)
    assert t.stop("quiet") >= 0.01
    assert capsys.readouterr().out == ""
    monkeypatch.setenv("SZT_DEBUG_TIMINGS", "1")
    assert putils.timings_enabled()
    with putils.timed("block") as t:
        pass
    assert capsys.readouterr().out.startswith("block time = ")
    with pytest.raises(RuntimeError):
        putils.Timer().stop()


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with putils.device_trace(tmp_path / "trace") as prof:
        torch.ones(1000).cumsum(0)
    assert prof is not None
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_profile_entropy_prints_every_stage(tmp_path, capsys):
    from sz3_tpu_torch.tools import profile_entropy

    res = profile_entropy.main(["--n", "32", "--device", "cpu", "--reps", "1", "--trace",
                                str(tmp_path)])
    err = capsys.readouterr().err
    for stage in ("S1", "S2", "S3", "B "):
        assert any(k.startswith(stage) for k in res["ms"]) and stage in err
    assert "CPU" in res["where"] and "Huffman tree" in err and "L1=12" in err
    assert res["tree"]["max_len"] >= 1 and (tmp_path / "trace.json").exists()


def test_scaling_bench_both_parts():
    from sz3_tpu_torch.tools import scaling_bench

    ranks = scaling_bench.rank_scaling((1, 2), 16, "cpu")
    assert [r["ranks"] for r in ranks] == [1, 2]
    assert all("on the CPU" in r["shared"] and r["devices"] == ["cpu"] for r in ranks)
    assert [r["chunk_rows"] for r in ranks] == [16, 8]
    chunks = scaling_bench.chunk_model(32, device="cpu")
    assert [r["n_way_split"] for r in chunks] == [1, 2, 4, 8]
    assert chunks[3]["chunk_shape"] == [4, 32, 32]
    assert chunks[0]["chunk_ms"] > 0 and "CPU" in chunks[0]["device"]


def test_scaling_bench_main_writes_both_parts(tmp_path, monkeypatch):
    """main takes the JAX tool's surface (--json, the base from
    SZT_SCALE_BASE) plus --device, and runs part 1 at its defaults."""
    from sz3_tpu_torch.tools import scaling_bench

    calls = []
    monkeypatch.setattr(scaling_bench, "rank_scaling",
                        lambda **kw: calls.append(("ranks", kw)) or [{"ranks": 1}])
    monkeypatch.setattr(scaling_bench, "chunk_model",
                        lambda base, device: calls.append(("chunks", base, device.type))
                        or [{"base": base}])
    monkeypatch.setenv("SZT_SCALE_BASE", "48")
    out = scaling_bench.main(["--device", "cpu", "--json", str(tmp_path / "s.json")])
    assert calls == [("ranks", {"device": "cpu"}), ("chunks", 48, "cpu")]
    assert json.loads((tmp_path / "s.json").read_text()) == out == {
        "rank_scaling": [{"ranks": 1}], "chunk_model": [{"base": 48}]}
    for flag in ("--edge", "--ranks", "--base"):
        with pytest.raises(SystemExit):
            scaling_bench.main(["--device", "cpu", flag, "8"])


def test_profiling_tools_default_to_the_card():
    from sz3_tpu_torch.tools import profile_entropy, scaling_bench

    _no_card()
    with pytest.raises(RuntimeError, match="cuda"):
        profile_entropy.main(["--n", "8", "--reps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        scaling_bench.chunk_model(8)


def _reader():
    sys.path.insert(0, str(ROOT))
    from sz3_tpu_torch.tools import paraview_reader
    return paraview_reader


def _archive(tmp_path, shape=(12, 10, 8), eb=1e-3):
    rng = np.random.default_rng(0)
    arr = np.cumsum(rng.standard_normal(shape), axis=0).astype(np.float32) * 0.1
    p = tmp_path / "field.sz"
    p.write_bytes(szt.compress(arr, szt.Config(dims=arr.shape, absErrorBound=eb)))
    return arr, p


def test_paraview_reader_importable_without_paraview():
    pv = _reader()
    assert not pv._HAVE_PARAVIEW
    assert pv.SZ3TpuReader is not None


@pytest.mark.parametrize("dims", [None, (8, 10, 12)])
def test_paraview_reader_reads_on_the_asked_device(tmp_path, dims):
    pv = _reader()
    arr, p = _archive(tmp_path)
    r = pv.SZ3TpuReader()
    r.SetFileName(str(p))
    r.SetDevice("cpu")
    if dims:
        r.SetDomainDimensions(*dims)
    got = r._read()
    assert isinstance(got, np.ndarray) and got.shape == (12, 10, 8)
    assert np.abs(got - arr).max() <= 1e-3
    # the JAX package's reader decodes the same bits
    sys.path.insert(0, str(ROOT / "tools"))
    import paraview_sz3_reader as jpv
    jr = jpv.SZ3TpuReader()
    jr.SetFileName(str(p))
    if dims:
        jr.SetDomainDimensions(*dims)
    assert np.array_equal(jr._read(), got)


def test_paraview_reader_defaults_to_the_card(tmp_path):
    _no_card()
    pv = _reader()
    _, p = _archive(tmp_path)
    r = pv.SZ3TpuReader()
    r.SetFileName(str(p))
    with pytest.raises(RuntimeError, match="cuda"):
        r._read()
