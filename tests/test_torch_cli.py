"""The port's command lines on the CPU (`--device cpu`): sz3_tpu_torch.cli
(sz3t-torch) against the JAX package's sz3_tpu.cli, which runs the host
engine, and sz3_tpu_torch.mdz.main (sz3t-torch-mdz) against sz3_tpu.mdz.main.
Archives must be byte-equal (to the JAX CLI, to sz3_tpu.compress and to the
port's compress, all with set_datatype=False, as the reference CLI writes
them) and decodes bit-equal; the printed distortion report (-a) must be the
JAX CLI's text. Mirrors tests/test_cli.py."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sz3_tpu as szt
import sz3_tpu.mdz as jmdz
import sz3_tpu_torch as szp
import sz3_tpu_torch.mdz as pmdz
from sz3_tpu.cli import main as jcli
from sz3_tpu_torch.cli import main as pcli

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


def _field(shape, dtype=np.float32, seed=1):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal(shape), axis=-1) * 0.1
    return (x * 1000).astype(dtype) if np.issubdtype(dtype, np.integer) else x.astype(dtype)


def _dims(x):
    return [f"-{x.ndim}", *map(str, reversed(x.shape))]


NOPRED_INI = ("[GlobalSettings]\nCmprAlgo = ALGO_NOPRED\nErrorBoundMode = ABS\n"
              "AbsErrorBound = 0.01\n")
OPENMP_INI = ("[GlobalSettings]\nCmprAlgo = ALGO_INTERP\nErrorBoundMode = REL\n"
              "RelErrorBound = 1e-3\nOpenMP = YES\n")

# name -> (shape, dtype flag, dtype, CLI bound arguments, INI text, --threads)
CASES = {
    "ABS": ((16, 16, 64), "-f", np.float32, ["-M", "ABS", "1e-3"], None, 0),
    "REL": ((16, 16, 64), "-f", np.float32, ["-M", "REL", "1e-3"], None, 0),
    "REL_via_R": ((12, 20, 30), "-f", np.float32, ["-M", "REL", "-R", "1e-2"], None, 0),
    "PSNR": ((16, 16, 64), "-f", np.float32, ["-M", "PSNR", "80"], None, 0),
    "f64_ABS": ((8, 24, 40), "-d", np.float64, ["-M", "ABS", "1e-4"], None, 0),
    "int32": ((10, 20, 30), "-I", np.int32, ["-M", "ABS", "4"], None, 0),
    "1D": ((5000,), "-f", np.float32, ["-M", "ABS", "1e-3"], None, 0),
    "NOPRED_ini": ((64, 64), "-f", np.float32, [], NOPRED_INI, 0),
    "OpenMP_ini_threads4": ((24, 16, 32), "-f", np.float32, [], OPENMP_INI, 4),
}


def _type_args(flag):
    return [flag, "32"] if flag == "-I" else [flag]


def _conf_of(args, ini_path, shape):
    """The Config the CLI builds, for the library calls."""
    conf = szt.Config(dims=shape)
    if ini_path:
        conf.loadcfg(str(ini_path))
    if args:
        mode = args[1]
        conf.errorBoundMode = {"ABS": szt.EB.ABS, "REL": szt.EB.REL, "PSNR": szt.EB.PSNR}[mode]
        field = {"ABS": "absErrorBound", "REL": "relErrorBound", "PSNR": "psnrErrorBound"}[mode]
        setattr(conf, field, float(args[-1]))
    return conf


@pytest.mark.parametrize("name", list(CASES))
def test_archives_equal_the_jax_cli_and_both_libraries(tmp_path, name):
    shape, flag, dtype, bound, ini, threads = CASES[name]
    x = _field(shape, dtype)
    src = tmp_path / "in.dat"
    x.tofile(src)
    extra = []
    ini_path = None
    if ini:
        ini_path = tmp_path / "sz.config"
        ini_path.write_text(ini)
        extra = ["-c", str(ini_path)]
    if threads:
        extra += ["--threads", str(threads)]
    common = [*_type_args(flag), "-i", str(src), *_dims(x), *bound, *extra]
    assert jcli([*common, "-z", str(tmp_path / "j.sz"), "-o", str(tmp_path / "j.out")]) == 0
    assert pcli([*common, *CPU, "-z", str(tmp_path / "p.sz"), "-o", str(tmp_path / "p.out")]) == 0
    assert pcli([*common, *CPU, "--backend", "native", "-z", str(tmp_path / "n.sz"),
                 "-o", str(tmp_path / "n.out")]) == 0
    blob = (tmp_path / "j.sz").read_bytes()
    assert (tmp_path / "p.sz").read_bytes() == blob
    assert (tmp_path / "n.sz").read_bytes() == blob
    # the library calls with the CLI's Config: the JAX package's native
    # route and the port's compress, neither recording the dtype
    cj = _conf_of(bound, ini_path, x.shape)
    assert szt.compress(x, cj, nthreads=threads, set_datatype=False) == blob
    cp = szp.Config.load(cj.save(), 0)[0]
    assert szp.compress(x, cp, device="cpu", nthreads=threads, set_datatype=False) == blob
    out = (tmp_path / "j.out").read_bytes()
    assert (tmp_path / "p.out").read_bytes() == out
    assert (tmp_path / "n.out").read_bytes() == out
    dec = np.frombuffer(out, dtype).reshape(shape).astype(np.float64)
    assert np.isfinite(dec).all()


def test_sz2_style_round_trip(tmp_path):
    x = _field((4096,), seed=2)
    x.tofile(tmp_path / "in.dat")
    for cli, tag, dev in ((jcli, "j", []), (pcli, "p", CPU)):
        assert cli(["-f", "-i", str(tmp_path / "in.dat"), "-z", str(tmp_path / f"{tag}.sz"),
                    "-1", "4096", "-M", "ABS", "1e-2", *dev]) == 0
        assert cli(["-f", "-s", str(tmp_path / f"{tag}.sz"), "-x", str(tmp_path / f"{tag}.out"),
                    "-1", "4096", *dev]) == 0
    assert (tmp_path / "p.sz").read_bytes() == (tmp_path / "j.sz").read_bytes()
    out = np.fromfile(tmp_path / "p.out", dtype=np.float32)
    assert out.tobytes() == (tmp_path / "j.out").read_bytes()
    assert np.abs(out - x).max() <= 1e-2 * 1.0000001


@pytest.mark.parametrize("flag,dtype", [("-d", np.float64), ("-I", np.int32), ("-I", np.int64)])
def test_typed_decode_of_a_cli_archive(tmp_path, flag, dtype):
    """-d and -I archives carry no dtype (the reference CLI never sets it):
    the decode takes the CLI's, here from the JAX CLI's archive."""
    x = _field((10, 12, 50), dtype, seed=3)
    x.tofile(tmp_path / "in.dat")
    t = [flag] + (["32" if dtype == np.int32 else "64"] if flag == "-I" else [])
    assert jcli([*t, "-i", str(tmp_path / "in.dat"), "-z", str(tmp_path / "a.sz"), *_dims(x),
                 "-M", "ABS", "2"]) == 0
    assert jcli([*t, "-z", str(tmp_path / "a.sz"), "-o", str(tmp_path / "j.out"), *_dims(x)]) == 0
    assert pcli([*t, "-z", str(tmp_path / "a.sz"), "-o", str(tmp_path / "p.out"), *_dims(x),
                 *CPU]) == 0
    out = np.fromfile(tmp_path / "p.out", dtype=dtype)
    assert out.tobytes() == (tmp_path / "j.out").read_bytes()
    assert np.abs(out.astype(np.float64) - x.reshape(-1)).max() <= 2


def _report_lines(text):
    return [ln for ln in text.splitlines() if "time" not in ln and "file" not in ln]


@pytest.mark.parametrize("values", ["smooth", "with_zeros", "constant"])
def test_distortion_report_is_the_jax_clis(tmp_path, capsys, values):
    x = _field((16, 16, 64), seed=4)
    if values == "with_zeros":
        x[::3] = 0
    elif values == "constant":
        x[:] = 2.5
    x.tofile(tmp_path / "in.dat")
    args = ["-f", "-i", str(tmp_path / "in.dat"), "-z", str(tmp_path / "a.sz"), "-o",
            str(tmp_path / "a.out"), "-3", "64", "16", "16", "-M", "ABS", "1e-3", "-a"]
    capsys.readouterr()
    assert jcli(args) == 0
    want = capsys.readouterr().out
    assert pcli(args + CPU) == 0
    got = capsys.readouterr().out
    assert "Max absolute error" in got and "PSNR" in got
    assert _report_lines(got) == _report_lines(want)


def test_version_and_help(capsys):
    capsys.readouterr()
    assert jcli(["-v"]) == 0
    want = capsys.readouterr().out
    assert pcli(["-v"]) == 0
    assert capsys.readouterr().out == want == "sz3-tpu Version: 0.1.0\nSZ3 Data Format Version: 3.3.2\n"
    assert pcli(["-h"]) == 0
    assert "--backend torch|native" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    [],                                                      # nothing to do
    ["-f", "-q"],                                            # unknown option
    ["-f", "-i", "x.dat", "-3", "4", "4"],                   # option missing its argument
    ["-f", "-i", "x.dat", "-1", "100", "-M", "REL", "0", "-z", "x.sz"],   # zero REL bound
    ["-f", "-i", "x.dat", "-1", "100", "-M", "PSNR", "-z", "x.sz"],       # no PSNR bound
    ["-f", "-i", "x.dat", "-o", "x.out", "-1", "100"],       # implicit archive, no bound
    ["-f", "-i", "x.dat", "-1", "100", "-M", "WRONG", "1", "-z", "x.sz"],  # wrong mode
    ["-I", "16", "-i", "x.dat", "-1", "100", "-M", "ABS", "1", "-z", "x.sz"],
    ["--backend", "jax", "-f", "-i", "x.dat", "-1", "100", "-M", "ABS", "1", "-z", "x.sz"],
])
def test_usage_errors_exit_1(tmp_path, monkeypatch, argv):
    monkeypatch.chdir(tmp_path)
    np.zeros(100, np.float32).tofile("x.dat")
    with pytest.raises(SystemExit) as e:
        pcli(CPU + argv if argv else argv)
    assert e.value.code == 1
    if "--backend" not in argv:           # the JAX CLI refuses the same lines
        with pytest.raises(SystemExit) as ej:
            jcli(argv)
        assert ej.value.code == 1


def test_stats_need_the_original(tmp_path, capsys):
    x = _field((2000,), seed=5)
    x.tofile(tmp_path / "in.dat")
    pcli(["-f", "-i", str(tmp_path / "in.dat"), "-z", str(tmp_path / "a.sz"), "-1", "2000",
          "-M", "ABS", "1e-3", *CPU])
    assert pcli(["-f", "-z", str(tmp_path / "a.sz"), "-o", str(tmp_path / "a.out"), "-1", "2000",
                 "-a", *CPU]) == 1


def test_cuda_is_the_default_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x = _field((2000,), seed=5)
    x.tofile(tmp_path / "in.dat")
    with pytest.raises(RuntimeError, match="cuda"):
        pcli(["-f", "-i", str(tmp_path / "in.dat"), "-z", str(tmp_path / "a.sz"), "-1", "2000",
              "-M", "ABS", "1e-3"])
    assert not (tmp_path / "a.sz").exists()


def test_pathless_z_implicit_archive_and_text_output(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    x = _field((20, 300), seed=6)
    x.tofile("in.dat")
    dims = ["-2", "300", "20"]
    # pathless -z writes <input>.sz
    assert pcli(["-f", "-i", "in.dat", "-z", *dims, "-M", "ABS", "1e-3", *CPU]) == 0
    assert Path("in.dat.sz").exists()
    # -i and -o without -z: a temporary archive, removed afterwards; text output
    for cli, tag, dev in ((jcli, "j", []), (pcli, "p", CPU)):
        assert cli(["-f", "-i", "in.dat", "-o", f"{tag}.txt", "-t", "-p", *dims, "-M", "ABS",
                    "1e-3", *dev]) == 0
        assert not Path("in.dat.sz.tmp").exists()
    assert Path("p.txt").read_text() == Path("j.txt").read_text()
    out = np.loadtxt("p.txt")
    assert out.size == x.size and np.abs(out - x.reshape(-1)).max() <= 1e-3 * 1.0000001
    assert "[GlobalSettings]" in capsys.readouterr().out


def test_the_module_runs_in_a_fresh_process(tmp_path):
    x = _field((16, 16, 64), seed=7)
    x.tofile(tmp_path / "in.dat")
    r = subprocess.run([sys.executable, "-m", "sz3_tpu_torch.cli", "-f", "-i", "in.dat", "-z",
                        "a.sz", "-o", "a.out", "-3", "64", "16", "16", "-M", "ABS", "1e-3", *CPU],
                       capture_output=True, text=True, cwd=tmp_path, timeout=300,
                       env={**__import__("os").environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0, r.stderr
    assert "compression ratio" in r.stdout and "decompressed file" in r.stdout
    conf = szt.Config(dims=x.shape, absErrorBound=1e-3)
    assert (tmp_path / "a.sz").read_bytes() == szt.compress(x, conf, set_datatype=False)


def _lattice(frames, atoms, seed=0):
    """A small solid-state-like trajectory (frames, atoms, 3): lattice sites
    plus a thermal random walk."""
    rng = np.random.default_rng(seed)
    sites = np.stack(np.meshgrid(*(np.arange(8.0),) * 3, indexing="ij"), -1).reshape(-1, 3)
    base = sites[:atoms] * 1.5
    walk = np.cumsum(rng.normal(0, 0.002, (frames, atoms, 3)), axis=0)
    return np.ascontiguousarray(base[None] + walk + rng.normal(0, 0.01, (frames, atoms, 3)),
                                dtype=np.float32)


@pytest.mark.parametrize("argv", [
    ["-3", "{F}", "{A}", "3", "-r", "1e-3", "-b", "10"],
    ["-2", "{F}", "{A3}", "-a", "1e-3", "-m", "VQT"],
    ["-3", "{F}", "{A}", "3", "-r", "1e-3", "10", "2"],       # reference tail: batch, method MT
])
def test_mdz_main_matches_the_jax_tool(tmp_path, capsys, argv):
    traj = _lattice(20, 200)
    f, a = traj.shape[:2]
    traj.tofile(tmp_path / "t.dat")
    args = [s.format(F=f, A=a, A3=a * 3) for s in argv]
    outs = {}
    for main, tag, dev in ((jmdz.main, "j", []), (pmdz.main, "p", CPU)):
        capsys.readouterr()
        main([str(tmp_path / "t.dat"), *args, "-z", str(tmp_path / f"{tag}.mdz"), "-o",
              str(tmp_path / f"{tag}.out"), *dev])
        outs[tag] = capsys.readouterr().out
    assert outs["p"] == outs["j"] and "Max error=" in outs["p"]
    assert (tmp_path / "p.mdz").read_bytes() == (tmp_path / "j.mdz").read_bytes()
    assert (tmp_path / "p.out").read_bytes() == (tmp_path / "j.out").read_bytes()
