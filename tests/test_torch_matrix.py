"""The port's whole surface held to the host engine on the CPU: every dtype
x rank x algorithm x bound mode, OpenMP-format archives, interpolation
bases, fields with NaN and +-Inf, size-1 axes and tiny fields, LORENZO_REG
rosters, and the integer dtypes through pysz, compress_batch and the CLI.

Each case compresses one field with sz3_tpu_torch.compress(..., device="cpu",
nthreads=2) and with sz3_tpu.compress(..., backend="native", nthreads=2):
the archives must be byte-equal, and the port's decompress(device="cpu")
must give the engine decode's bytes and dtype. Inputs are made with numpy
from fixed seeds: a random walk along every axis, for integer dtypes scaled
and clipped into the type's range."""

import numpy as np
import pytest
import torch

import sz3_tpu as szt
import sz3_tpu.config as J                      # the JAX package's Config classes
import sz3_tpu.pysz as jpysz
import sz3_tpu_torch as szp
import sz3_tpu_torch.config as P                # the port's own
import sz3_tpu_torch.pysz as ppysz
from sz3_tpu.cli import main as jcli
from sz3_tpu_torch.cli import main as pcli
from sz3_tpu_torch.config import ALGO
from sz3_tpu_torch.serving import compress_batch, decompress_batch

FLOATS = (np.float32, np.float64)
INTS = (np.int8, np.uint8, np.int16, np.uint16, np.int32, np.uint32, np.int64, np.uint64)
DTYPES = FLOATS + INTS
SHAPES = ((5000,), (60, 70), (24, 26, 28), (6, 7, 8, 9))
ALGOS = (ALGO.INTERP_LORENZO, ALGO.INTERP, ALGO.LORENZO_REG, ALGO.NOPRED)
CUBE = SHAPES[2]

# bound settings by name: each a dict of Config fields (the mode by name)
ABS_F = {"errorBoundMode": "ABS", "absErrorBound": 1e-2}
REL_F = {"errorBoundMode": "REL", "relErrorBound": 1e-3}
ABS_I = {"errorBoundMode": "ABS", "absErrorBound": 2}
MODES = {
    "PSNR60": {"errorBoundMode": "PSNR", "psnrErrorBound": 60.0},
    "L2NORM1e-1": {"errorBoundMode": "L2NORM", "l2normErrorBound": 1e-1},
    "ABS_AND_REL": {"errorBoundMode": "ABS_AND_REL", "absErrorBound": 1e-2,
                    "relErrorBound": 1e-3},
    "ABS_OR_REL": {"errorBoundMode": "ABS_OR_REL", "absErrorBound": 1e-2,
                   "relErrorBound": 1e-3},
}


def field(shape, dtype, seed=0):
    """A random walk along every axis, unit spread; for an integer dtype
    scaled over (at most 20,000 steps of) the type's range and clipped."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    for ax in range(x.ndim):
        x = np.cumsum(x, axis=ax)
    x = (x - x.mean()) / (x.std() or 1.0)
    if dtype in FLOATS:
        return x.astype(dtype)
    info = np.iinfo(dtype)
    span = min(float(info.max) - float(info.min), 20000.0)
    mid = 0.0 if info.min < 0 else span / 2
    return np.clip(np.rint(mid + x * span / 8), info.min, info.max).astype(dtype)


def make_conf(ns, kw):
    """A Config of the namespace `ns` (the JAX package's or the port's) from
    `kw`, whose enum fields are given by name."""
    enums = {"errorBoundMode": ns.EB, "cmprAlgo": ns.ALGO, "interpAlgo": ns.INTERP_ALGO}
    return ns.Config(**{k: enums[k][v] if k in enums else v for k, v in kw.items()})


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


def same_as_engine(x, kw):
    """The port's archive and decode of `x` under the Config `kw`, held to
    the engine's: byte-equal archives, the same decode bytes, dtype and
    shape. Returns the archive."""
    want = szt.compress(x, make_conf(J, kw), backend="native", nthreads=2)
    got = szp.compress(x, make_conf(P, kw), device="cpu", nthreads=2)
    assert got == want
    ref, ref_conf = szt.decompress(want)
    out, conf = szp.decompress(got, device="cpu")
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    out = out.numpy()
    assert out.dtype == ref.dtype == x.dtype and out.shape == ref.shape
    assert np.array_equal(_bits(out), _bits(ref))
    assert conf.save() == ref_conf.save()
    return got


def _ids(cases):
    return ["-".join(str(p) for p in c) for c in cases]


def _name(dt):
    return np.dtype(dt).name


# A: every dtype x rank x algorithm x openmp; floats at ABS and REL,
# integers at ABS 2
CASES_A = [(_name(dt), "x".join(map(str, shape)), algo.name, omp, bound)
           for dt in DTYPES for shape in SHAPES for algo in ALGOS for omp in ("plain", "openmp")
           for bound in (("ABS", "REL") if dt in FLOATS else ("ABS",))]


@pytest.mark.parametrize("dt,shape,algo,omp,bound", CASES_A, ids=_ids(CASES_A))
def test_a_dtype_rank_algorithm(dt, shape, algo, omp, bound):
    dtype = np.dtype(dt).type
    shape = tuple(int(n) for n in shape.split("x"))
    kw = dict(ABS_I if dtype in INTS else ABS_F if bound == "ABS" else REL_F,
              cmprAlgo=algo, openmp=omp == "openmp")
    same_as_engine(field(shape, dtype), kw)


# B: the other bound modes on the 3D field
CASES_B = [(mode, _name(dt), algo.name) for mode in MODES for dt in FLOATS for algo in ALGOS]


@pytest.mark.parametrize("mode,dt,algo", CASES_B, ids=_ids(CASES_B))
def test_b_bound_modes(mode, dt, algo):
    same_as_engine(field(CUBE, np.dtype(dt).type, seed=1), dict(MODES[mode], cmprAlgo=algo))


# C: INTERP's two bases at every rank
CASES_C = [(ia, _name(dt), "x".join(map(str, shape))) for ia in ("LINEAR", "CUBIC")
           for dt in FLOATS for shape in SHAPES]


@pytest.mark.parametrize("ia,dt,shape", CASES_C, ids=_ids(CASES_C))
def test_c_interp_bases(ia, dt, shape):
    shape = tuple(int(n) for n in shape.split("x"))
    same_as_engine(field(shape, np.dtype(dt).type, seed=2),
                   dict(ABS_F, cmprAlgo="INTERP", interpAlgo=ia))


# D: special values, size-1 axes and tiny fields, LORENZO_REG rosters
@pytest.mark.parametrize("algo", [a.name for a in ALGOS])
def test_d_nan_and_inf(algo):
    x = field(CUBE, np.float32, seed=3)
    x[3, 4, 5] = np.nan
    x[10, 0, 27] = np.inf
    x[23, 25, 0] = -np.inf
    x[7, 7, 7:9] = np.nan
    same_as_engine(x, dict(ABS_F, cmprAlgo=algo))


EDGE_SHAPES = ((1, 40, 50), (40, 1, 50), (1, 1, 3000), (3, 3, 3), (2, 2000))
CASES_D = [("x".join(map(str, s)), a) for s in EDGE_SHAPES
           for a in ("INTERP_LORENZO", "LORENZO_REG")]


@pytest.mark.parametrize("shape,algo", CASES_D, ids=_ids(CASES_D))
def test_d_size_one_axes_and_tiny_fields(shape, algo):
    shape = tuple(int(n) for n in shape.split("x"))
    same_as_engine(field(shape, np.float32, seed=4), dict(ABS_F, cmprAlgo=algo))


@pytest.mark.parametrize("roster", [(1, 1, 0), (0, 0, 1), (1, 0, 0), (1, 1, 1)],
                         ids=lambda r: "lorenzo%d-lorenzo2_%d-regression%d" % r)
def test_d_lorenzo_reg_rosters(roster):
    lorenzo, lorenzo2, regression = map(bool, roster)
    same_as_engine(field(CUBE, np.float32, seed=5),
                   dict(ABS_F, cmprAlgo="LORENZO_REG", lorenzo=lorenzo, lorenzo2=lorenzo2,
                        regression=regression))


# E: the integer dtypes through pysz, compress_batch and the CLI
@pytest.mark.parametrize("dt", [_name(dt) for dt in INTS])
def test_e_pysz_integer_dtypes(dt):
    """pysz takes the dtypes of the reference binding (int32 and int64 of
    the integers) and refuses the others, as the JAX package's pysz does;
    what it takes is the engine's archive."""
    x = field(CUBE, np.dtype(dt).type, seed=6)
    confs = []
    for mod in (jpysz, ppysz):
        c = mod.szConfig(x.shape)
        c.errorBoundMode = mod.szErrorBoundMode.ABS
        c.absErrorBound = 2
        confs.append(c)
    if x.dtype not in (np.int32, np.int64):
        for mod, c, kw in ((jpysz, confs[0], {}), (ppysz, confs[1], {"device": "cpu"})):
            with pytest.raises(TypeError, match="Unsupported dtype"):
                mod.sz.compress(x, c, **kw)
        return
    want, _ = jpysz.sz.compress(x, confs[0])
    got, ratio = ppysz.sz.compress(x, confs[1], device="cpu")
    assert np.array_equal(got, want) and ratio == x.nbytes / got.size
    assert got.tobytes() == szt.compress(x, szt.Config(absErrorBound=2), backend="native")
    out, _ = ppysz.sz.decompress(got, x.dtype, x.shape, device="cpu")
    assert out.dtype == x.dtype and np.array_equal(out, jpysz.sz.decompress(want, x.dtype,
                                                                            x.shape)[0])


@pytest.mark.parametrize("dt", [_name(dt) for dt in INTS])
def test_e_compress_batch_integer_dtypes(dt):
    """A stack of integer fields: each archive is single-field compress's
    with INTERP pinned (the batch pins it), and the engine's."""
    dtype = np.dtype(dt).type
    stack = np.stack([field((20, 22, 24), dtype, seed=s) for s in (7, 8, 9)])
    blobs = compress_batch(stack, P.Config(absErrorBound=2), device="cpu")
    for f, blob in zip(stack, blobs):
        assert blob == szp.compress(f, P.Config(cmprAlgo=ALGO.INTERP, absErrorBound=2),
                                    device="cpu")
        assert blob == szt.compress(f, szt.Config(cmprAlgo=szt.ALGO.INTERP, absErrorBound=2),
                                    backend="native")
    out = decompress_batch(blobs, device="cpu").numpy()
    assert out.dtype == stack.dtype
    assert np.array_equal(out, np.stack([szt.decompress(b)[0] for b in blobs]))


@pytest.mark.parametrize("width", ["32", "64"])
def test_e_cli_integer_types(tmp_path, width):
    """The CLI's integer types (-I 32 | 64) under the default Config: the
    port's archive and decoded file are the JAX CLI's, which runs the
    engine."""
    x = field(CUBE, {"32": np.int32, "64": np.int64}[width], seed=10)
    x.tofile(tmp_path / "in.dat")
    dims = ["-3", *map(str, reversed(x.shape))]
    for cli, tag, extra in ((jcli, "j", []), (pcli, "p", ["--device", "cpu"])):
        assert cli(["-I", width, "-i", str(tmp_path / "in.dat"), "-z", str(tmp_path / f"{tag}.sz"),
                    "-o", str(tmp_path / f"{tag}.out"), *dims, "-M", "ABS", "2", *extra]) == 0
    assert (tmp_path / "p.sz").read_bytes() == (tmp_path / "j.sz").read_bytes()
    assert (tmp_path / "p.out").read_bytes() == (tmp_path / "j.out").read_bytes()
