"""The port's HDF5 filter (sz3_tpu_torch.h5, filter id 32024, the plugin
built from sz3_tpu_torch/csrc/h5z_szt.cpp) and its tools
(sz3_tpu_torch.h5tools): tests/test_h5_filter.py's cases through the port,
files written through either package's filter read through the other's, and
the tools' round trips. The filter compresses each chunk with the host
engine inside libhdf5, in both packages.

Both packages register filter 32024 in a process and the last registration
serves it: each case here registers the port's filter before it runs and
gives the JAX package's back after it, and which package wrote a file is
shown in separate processes, each registering only its own filter."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

import sz3_tpu as szt
import sz3_tpu_torch as szp
import sz3_tpu_torch.h5 as szh5
from sz3_tpu_torch.config import EB

ROOT = Path(__file__).resolve().parents[1]


def _register_anew(mod):
    mod._registered = False
    mod.register()


@pytest.fixture(autouse=True)
def _the_port_filter_serves():
    """The last registration of filter 32024 serves the process, and each
    package's register() does nothing once it has registered. An xdist
    worker may run tests/test_h5_filter.py's cases between these, so each
    case here registers the port's plugin anew and, after it, hands the
    JAX package's plugin back if that one had been registered: neither
    package's cases run through the other's plugin."""
    import sz3_tpu.h5 as jh5

    jax_was_registered = jh5._registered
    _register_anew(szh5)
    assert h5py.h5z.filter_avail(szh5.FILTER_ID)
    yield
    if jax_was_registered:
        _register_anew(jh5)


def field(shape, dtype=np.float32):
    f = np.fromfunction(lambda *ix: sum(np.sin(g / (7 + 2 * k)) for k, g in enumerate(ix)), shape)
    return f.astype(dtype)


def _write(p, arr, chunks=None, **kw):
    with h5py.File(p, "w") as f:
        f.create_dataset("d", data=arr, chunks=chunks or arr.shape, compression=szh5.FILTER_ID,
                         compression_opts=szh5.cd_values(**kw))
    with h5py.File(p) as f:
        return f["d"][:]


@pytest.mark.parametrize("eb", [1e-1, 1e-2, 1e-3, 1e-4])
def test_f32_abs(tmp_path, eb):
    arr = field((30, 40, 50))
    out = _write(tmp_path / "f.h5", arr, absErrorBound=eb)
    assert np.abs(out - arr).max() <= eb * 1.2


@pytest.mark.parametrize("dtype", [np.float64, np.int16, np.uint8, np.int32, np.int64,
                                   np.uint32, np.uint64, np.int8, np.uint16])
def test_dtypes(tmp_path, dtype):
    f = field((24, 32, 16), np.float64) * 40
    if np.issubdtype(dtype, np.unsignedinteger):
        f = f - f.min()
    arr = f.astype(dtype)
    out = _write(tmp_path / "d.h5", arr, absErrorBound=1.0)
    assert out.dtype == arr.dtype
    assert np.abs(out.astype(np.float64) - arr.astype(np.float64)).max() <= 1.0


def test_rel_mode_and_multi_chunk(tmp_path):
    arr = field((40, 40, 40)) * 123.0
    out = _write(tmp_path / "r.h5", arr, errorBoundMode=EB.REL, relErrorBound=1e-3)
    assert np.abs(out - arr).max() <= 1e-3 * (arr.max() - arr.min()) * 1.2
    arr = field((64, 64, 64))
    out = _write(tmp_path / "c.h5", arr, chunks=(16, 64, 64), absErrorBound=1e-3)
    assert np.abs(out - arr).max() <= 1e-3


def test_tiny_dataset_passthrough(tmp_path):
    arr = np.arange(6, dtype=np.float32)
    assert np.array_equal(_write(tmp_path / "t.h5", arr, absErrorBound=1e-3), arr)


def test_chunks_are_the_port_archives(tmp_path):
    """A chunk is a standard container that the port decodes on the asked
    device; the port's own archive, written as a chunk, reads back."""
    arr = field((30, 40, 50))
    p = tmp_path / "x.h5"
    _write(p, arr, absErrorBound=1e-3)
    with h5py.File(p) as f:
        _, raw = f["d"].id.read_direct_chunk((0, 0, 0))
    out, _ = szp.decompress(bytes(raw), device="cpu")
    assert np.abs(out.numpy().reshape(arr.shape) - arr).max() <= 1e-3
    blob = szp.compress(arr, szp.Config(absErrorBound=1e-3), device="cpu", set_datatype=False)
    assert blob == szt.compress(arr, szt.Config(dims=arr.shape, absErrorBound=1e-3),
                                set_datatype=False)
    q = tmp_path / "w.h5"
    with h5py.File(q, "w") as f:
        ds = f.create_dataset("d", shape=arr.shape, dtype=np.float32, chunks=arr.shape,
                              compression=szh5.FILTER_ID,
                              compression_opts=szh5.cd_values(absErrorBound=1e-3))
        ds.id.write_direct_chunk((0, 0, 0), blob)
    with h5py.File(q) as f:
        assert np.abs(f["d"][:] - arr).max() <= 1e-3


def test_cd_values_and_plugin_path():
    import sz3_tpu.h5 as jh5

    for kw in ({}, {"absErrorBound": 1e-3}, {"errorBoundMode": EB.REL, "relErrorBound": 1e-4}):
        jkw = {k: (szt.EB(int(v)) if k == "errorBoundMode" else v) for k, v in kw.items()}
        assert szh5.cd_values(**kw) == jh5.cd_values(**jkw)
    with pytest.raises(TypeError):
        szh5.cd_values(noSuchField=1)
    path = Path(szh5.plugin_path())
    assert path.is_file() and path.parent == ROOT / "sz3_tpu_torch" / "_build"


_WRITER = """
import sys, numpy as np, h5py
import {pkg}.h5 as h5f
h5f.register()
arr = np.fromfunction(lambda a, b, c: np.sin(a / 7) + np.cos(b / 9) + c / 50,
                      (30, 40, 50)).astype(np.float32)
with h5py.File(sys.argv[1], "w") as f:
    f.create_dataset("d", data=arr, chunks=(10, 40, 50), compression=h5f.FILTER_ID,
                     compression_opts=h5f.cd_values(absErrorBound=1e-3))
if len(sys.argv) > 2:
    with h5py.File(sys.argv[2]) as f:
        other = f["d"][:]
    assert np.abs(other - arr).max() <= 1e-3, np.abs(other - arr).max()
    np.save(sys.argv[2] + ".npy", other)
"""


def _run(pkg, *args):
    env = {**os.environ, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_WRITER.format(pkg=pkg)),
                        *map(str, args)], capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr


def test_files_are_interchangeable_between_the_packages(tmp_path):
    """The port's filter reads the JAX package's file and the other way
    round, each in a process that registers only its own filter."""
    p, j = tmp_path / "port.h5", tmp_path / "jax.h5"
    _run("sz3_tpu_torch", p)
    _run("sz3_tpu", j, p)                     # the JAX filter reads the port's file
    _run("sz3_tpu_torch", tmp_path / "again.h5", j)   # the port's filter reads the JAX file
    with h5py.File(p) as fp, h5py.File(j) as fj:
        for k in range(3):
            assert fp["d"].id.read_direct_chunk((10 * k, 0, 0))[1] == \
                fj["d"].id.read_direct_chunk((10 * k, 0, 0))[1]
    assert np.array_equal(np.load(str(p) + ".npy"), np.load(str(j) + ".npy"))


def test_tools_round_trip(tmp_path, monkeypatch):
    from sz3_tpu_torch import h5tools

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(0)
    arr = np.cumsum(rng.standard_normal((20, 30, 40)).astype(np.float32), axis=0) * 0.1
    arr.tofile("x.dat")
    (tmp_path / "sz3.config").write_text(
        "[GlobalSettings]\nCmprAlgo = ALGO_INTERP_LORENZO\n"
        "ErrorBoundMode = ABS\nAbsErrorBound = 1e-5\n")
    assert h5tools.main(["sz3ToHDF5", "FLOAT", "x.dat", "40", "30", "20"]) == 0
    assert h5tools.main(["dsz3FromHDF5", "x.dat.sz3.h5"]) == 0
    out = np.fromfile("x.dat.sz3.h5.out", np.float32).reshape(arr.shape)
    assert np.abs(out - arr).max() <= 1e-5 * 1.0000001
    assert h5tools.main(["convertBinToHDF5", "FLOAT", "v", "x.dat", "40", "30", "20"]) == 0
    assert os.path.getsize("x.dat.sz3.h5") < os.path.getsize("x.dat.h5")
    # -M overrides the INI, as in the JAX tool
    assert h5tools.main(["sz3ToHDF5", "FLOAT", "x.dat", "40", "30", "20", "-M", "ABS",
                         "1e-2"]) == 0
    assert h5tools.main(["dsz3FromHDF5", "x.dat.sz3.h5"]) == 0
    out = np.fromfile("x.dat.sz3.h5.out", np.float32).reshape(arr.shape)
    assert 1e-5 < np.abs(out - arr).max() <= 1e-2 * 1.0000001


def test_tools_usage_errors(capsys):
    from sz3_tpu_torch import h5tools

    assert h5tools.main([]) == 1
    assert h5tools.main(["sz3ToHDF5"]) == 1
    assert h5tools.main(["dsz3FromHDF5"]) == 1
    assert h5tools.main(["convertBinToHDF5", "FLOAT"]) == 1
    assert "sz3t-torch-h5" in capsys.readouterr().err
