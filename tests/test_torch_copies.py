"""The port keeps its own copies of what it needs from the JAX package, and
imports nothing of it. A copy may differ from its original only where listed
here, with the reason; everything else is held equal."""

from pathlib import Path

import numpy as np
import pytest

import sz3_tpu.config as jconfig
import sz3_tpu.ops.interp_plan as jplan
import sz3_tpu.runtime as jruntime
import sz3_tpu.stats as jstats
import sz3_tpu_torch.config as pconfig
import sz3_tpu_torch.ops.interp_plan as pplan
import sz3_tpu_torch.runtime as pruntime
import sz3_tpu_torch.stats as pstats
from sz3_tpu.ops import interp_fast as jif
from sz3_tpu_torch.ops import interp_fast as pif

ROOT = Path(__file__).resolve().parents[1]
NATIVE = ROOT / "sz3_tpu" / "native"
ENGINE = ROOT / "sz3_tpu_torch" / "csrc" / "engine"

# engine sources that differ from their originals: why, and how many lines
# the copy may add (it may drop or reword at most MAX_REMOVED of the original's)
ENGINE_DIFFERS = {
    "szt_core.cpp": ("adds szt_open_packed64 (the code table exported as uint64) and "
                     "szt_zstd_head (a payload's first bytes, for BIOMD's header) at the end; "
                     "checks BIOMDXTC's archived bin count against the live points, and the "
                     "MDZ time series' against the frames, before either sizes the bins", 90),
    "szt/bridge.hpp": ("interp_open_packed and nopred_open_packed take the code width from "
                       "the caller's vector; the packed opens check the bitstream's byte count "
                       "against the bytes left before copying it, and every open passes the "
                       "bin count its decomposition reads", 24),
    "szt/huffman.hpp": ("export_loaded_codes is a template on the code width (32 or 64 bits); "
                        "an archived tree's node count is checked against the bytes left, its "
                        "children must follow their parent and have one parent each (so every "
                        "walk ends), and exported symbols must be non-negative, unrepeated and "
                        "within stateNum", 30),
    "szt/common.hpp": ("Source::take (a length checked against the bytes left) and "
                       "check_count, for the bounds checks on archive-given lengths", 16),
    "szt/quantizer.hpp": ("the literal count is checked against the bytes left, and a zero "
                          "bin past the last literal throws instead of reading past them", 12),
    "szt/huffman_v2.hpp": ("bit reads stop at the stream's end, the leaf count is checked "
                           "against the bytes left, and the load no longer builds the "
                           "encoder's code table, which the archive's maxval sized", 12),
    "szt/pipeline.hpp": ("open_payload checks the archived bin count against what the "
                         "decomposition reads before sizing the bins, BIOMD's and BIOMDXTC's "
                         "decodes likewise, and the chunked decode each chunk's Config "
                         "against its rows", 20),
    "szt/interp.hpp": ("the payload header's dims must be the Config's, its block size "
                       "non-zero and its direction one of the N! orders", 10),
    "szt/blockwise.hpp": ("the block size must be positive, the selection and coefficient "
                          "counts within the blocks, each selection a predictor of the "
                          "roster, and every read within both streams", 16),
    "szt/xtc.hpp": ("bit reads stop at the stream's end, and a run may not pass the last "
                    "triplet", 10),
    "szt/biomd.hpp": ("BioMDXtcCodec::live(), the stored bin count the decodes check", 8),
    "szt/mdz.hpp": ("the rank, each batch's and the first frame's byte count, the batches "
                    "tiling the frames and an MDZ3 series' dims are checked before use; the "
                    "opens pass the bin count they read", 16),
    "szt/zstd_wrap.hpp": ("the declared raw size is bounded by what the frame's bytes can "
                          "expand to before it is allocated", 4),
}
MAX_REMOVED = 12


def _configs(module):
    """A seeded set of configs built from `module`'s classes."""
    rng = np.random.default_rng(17)
    out = []
    for i in range(40):
        nd = int(rng.integers(1, 5))
        dims = tuple(int(d) for d in rng.integers(1, 300, nd))
        c = module.Config(dims=dims)
        c.cmprAlgo = module.ALGO(int(rng.choice([int(a) for a in module.ALGO])))
        c.errorBoundMode = module.EB(int(rng.choice([int(e) for e in module.EB])))
        c.absErrorBound = float(10.0 ** rng.integers(-8, 0))
        c.relErrorBound = float(10.0 ** rng.integers(-8, 0))
        c.psnrErrorBound = float(rng.uniform(20, 120))
        c.l2normErrorBound = float(rng.uniform(0, 5))
        c.interpAlgo = module.INTERP_ALGO(int(rng.integers(0, 2)))
        c.interpDirection = int(rng.integers(0, 6))
        c.quantbinCnt = int(2 ** rng.integers(4, 20))
        c.blockSize = int(rng.integers(2, 17))
        c.lorenzo, c.lorenzo2 = bool(rng.integers(0, 2)), bool(rng.integers(0, 2))
        c.regression, c.openmp = bool(rng.integers(0, 2)), bool(rng.integers(0, 2))
        c.dataType = module.DataType(int(rng.choice([int(d) for d in module.DataType])))
        out.append(c)
    return out


@pytest.mark.parametrize("i", range(40))
def test_config_bytes_and_fields_equal(i):
    cj, cp = _configs(jconfig)[i], _configs(pconfig)[i]
    blob = cj.save()
    assert cp.save() == blob
    assert cp.size_est() == cj.size_est() and cp.num == cj.num and cp.N == cj.N
    lj, nj = jconfig.Config.load(blob + b"tail")
    lp, np_ = pconfig.Config.load(blob + b"tail")
    assert nj == np_
    for name in vars(lj):
        a, b = getattr(lj, name), getattr(lp, name)
        assert (int(a) if hasattr(a, "name") else a) == (int(b) if hasattr(b, "name") else b), name
    assert lp.save() == lj.save()


def test_config_constants_equal():
    assert pconfig.SZ3_MAGIC_NUMBER == jconfig.SZ3_MAGIC_NUMBER
    assert pconfig.version_int((3, 3, 2)) == jconfig.version_int((3, 3, 2))
    assert pconfig.version_str(0x030302) == jconfig.version_str(0x030302)
    for enum in ("ALGO", "EB", "INTERP_ALGO", "DataType"):
        assert {m.name: int(m) for m in getattr(pconfig, enum)} == \
            {m.name: int(m) for m in getattr(jconfig, enum)}


@pytest.mark.parametrize("name", ["config.py", "ops/interp_plan.py"])
def test_python_copies_are_verbatim(name):
    assert (ROOT / "sz3_tpu_torch" / name).read_bytes() == (ROOT / "sz3_tpu" / name).read_bytes()


@pytest.mark.parametrize("dims,algo,direction", [((40, 33, 27), 1, 0), ((129, 129), 0, 1),
                                                 ((33, 34, 35, 20), 1, 5), ((4000,), 1, 0)])
def test_plan_constants_equal(dims, algo, direction):
    kw = dict(interp_algo=algo, direction=direction, anchor_stride=[4096, 128, 32, 16][len(dims) - 1],
              alpha=1.25, beta=2.0, eb=1e-3, quantbin_cnt=65536)
    pj, pp = jif.build_fast_plan(dims, **kw), pif.build_fast_plan(dims, **kw)
    assert (pj.dims, pj.anchor_stride, pj.base_eb, pj.radius) == \
        (pp.dims, pp.anchor_stride, pp.base_eb, pp.radius)
    assert len(pj.passes) == len(pp.passes) > 0
    for a, b in zip(pj.passes, pp.passes):
        assert (a.level, a.eb, a.dd, a.p, a.shape_in, a.shape_out) == \
            (b.level, b.eb, b.dd, b.p, b.shape_in, b.shape_out)
        assert np.array_equal(a.kind, b.kind)
    for args in ((dims[0], 2, 32, True, False), (dims[-1], 4, 32, False, True)):
        tj, tp = jplan.direction_table(*args), pplan.direction_table(*args)
        assert all(np.array_equal(a, b) for a, b in zip(tj, tp)) and len(tj) == len(tp)
    for level in range(1, 6):
        assert pplan.level_eb(1e-3, level, 1.25, 2.0) == jplan.level_eb(1e-3, level, 1.25, 2.0)


def _engine_files():
    return sorted(str(f.relative_to(ENGINE)) for f in ENGINE.rglob("*") if f.is_file())


def test_engine_copy_is_complete():
    want = ["szt_core.cpp"] + sorted(f"szt/{f.name}" for f in (NATIVE / "szt").glob("*.hpp"))
    assert _engine_files() == sorted(want)
    assert set(ENGINE_DIFFERS) <= set(want)


@pytest.mark.parametrize("name", ["szt_core.cpp"] + sorted(
    f"szt/{f.name}" for f in (NATIVE / "szt").glob("*.hpp")))
def test_engine_source_equals_original(name):
    import difflib

    mine, orig = (ENGINE / name).read_bytes(), (NATIVE / name).read_bytes()
    if name not in ENGINE_DIFFERS:
        assert mine == orig
        return
    reason, max_added = ENGINE_DIFFERS[name]
    assert reason and mine != orig, f"{name} no longer differs: take it off the list"
    a, b = orig.decode().splitlines(), mine.decode().splitlines()
    ops = difflib.SequenceMatcher(None, a, b, autojunk=False).get_opcodes()
    removed = sum(i2 - i1 for op, i1, i2, _, _ in ops if op in ("replace", "delete"))
    added = sum(j2 - j1 for op, _, _, j1, j2 in ops if op in ("replace", "insert"))
    assert 0 < removed + added and removed <= MAX_REMOVED and added <= max_added, \
        (name, removed, added)
    if name == "szt_core.cpp":                           # the additions at the end
        tail = b"\n".join(mine.splitlines()[-200:])
        for added_fn in (b"szt_open_packed64", b"szt_zstd_head"):
            assert added_fn in tail and added_fn not in orig


def test_runtime_binds_every_engine_function_of_the_original():
    import re
    pat = re.compile(r"szt_\w+")
    jnames = set(pat.findall((ROOT / "sz3_tpu" / "runtime.py").read_text()))
    pnames = set(pat.findall((ROOT / "sz3_tpu_torch" / "runtime.py").read_text()))
    assert jnames <= pnames and pnames - jnames == {"szt_open_packed64", "szt_zstd_head"}
    public = [n for n in dir(jruntime) if not n.startswith("_") and callable(getattr(jruntime, n))]
    assert all(hasattr(pruntime, n) for n in public)


@pytest.mark.parametrize("dtype,algo", [(np.float32, "INTERP"), (np.float64, "INTERP"),
                                        (np.float32, "INTERP_LORENZO"),
                                        (np.float32, "LORENZO_REG"), (np.int32, "INTERP")])
def test_engines_write_the_same_payload(dtype, algo):
    rng = np.random.default_rng(5)
    x = (np.cumsum(rng.standard_normal((30, 31, 32)), axis=-1) * 10).astype(dtype)
    payloads = []
    for cfg, rt in ((jconfig, jruntime), (pconfig, pruntime)):
        c = cfg.Config(dims=x.shape, cmprAlgo=cfg.ALGO[algo], absErrorBound=0.5)
        c.dataType = rt.np_dtype_id(x)
        payloads.append(rt.compress_payload(c, x, 4 * x.nbytes + 4096))
        out = rt.decompress_payload(c, payloads[-1])
        assert np.abs(out.astype(np.float64) - x).max() <= 0.5
    assert payloads[0] == payloads[1]


def test_open_packed_exports_64_bit_codes():
    """The port's open_packed gives uint64 codes equal to the original's
    uint32 ones where those exist."""
    rng = np.random.default_rng(6)
    x = (np.cumsum(rng.standard_normal((30, 31, 32)), axis=-1) * 0.1).astype(np.float32)
    outs = []
    for cfg, rt in ((jconfig, jruntime), (pconfig, pruntime)):
        c = cfg.Config(dims=x.shape, cmprAlgo=cfg.ALGO.INTERP, absErrorBound=1e-3)
        c.interpAnchorStride = 32
        payload = rt.compress_payload(c, x, 4 * x.nbytes)
        outs.append(rt.open_packed(c, payload, np.float32))
    (bj, nj, oj, cj, lj, kj, uj), (bp, np_, op, cp, lp, kp, up) = outs
    assert cj.dtype == np.uint32 and cp.dtype == np.uint64
    assert (bj, nj, oj, kj) == (bp, np_, op, kp)
    assert np.array_equal(cj.astype(np.uint64), cp) and np.array_equal(lj, lp)
    assert np.array_equal(uj, up)


def test_stats_copy():
    """The error-bound conversions agree; data_range differs where it is
    listed: over data holding NaN the port passes over it, as the host engine
    and the reference do (Statistic.hpp:11-20), unless it is the first
    element, where the JAX package's numpy max and min give NaN."""
    x = np.linspace(-3, 7, 1000).reshape(10, 10, 10)
    nan = x.copy()
    nan[3, 4, 5] = np.nan
    assert np.isnan(jstats.data_range(nan)) and pstats.data_range(nan) == 10.0
    nan[0, 0, 0] = np.nan
    assert np.isnan(pstats.data_range(nan))
    for mode in pconfig.EB:
        cj = jconfig.Config(dims=x.shape, errorBoundMode=jconfig.EB(int(mode)), absErrorBound=0.1,
                            relErrorBound=1e-3, psnrErrorBound=80.0, l2normErrorBound=0.5)
        cp = pconfig.Config(dims=x.shape, errorBoundMode=mode, absErrorBound=0.1,
                            relErrorBound=1e-3, psnrErrorBound=80.0, l2normErrorBound=0.5)
        jstats.cal_abs_error_bound(cj, x)
        pstats.cal_abs_error_bound(cp, x)
        assert cp.absErrorBound == cj.absErrorBound and int(cp.errorBoundMode) == 0


def test_blockwise_constants_equal():
    """The port's copies of the block size and the Lorenzo noise tables
    (ops/blockwise_layout.py) equal sz3_tpu/ops/blockwise_device.py's."""
    from sz3_tpu.ops import blockwise_device as jbd
    from sz3_tpu_torch.ops import blockwise_layout as pbl

    assert pbl.BS == jbd.BS and pbl.PAD == jbd.PAD
    for order in (1, 2):
        for n_dims in (1, 2, 3, 4):
            for eb in (1e-1, 1e-3, 3.7e-6):
                assert pbl._noise(order, n_dims, eb) == jbd._noise(order, n_dims, eb)


def test_blockwise_sweep_types_equal():
    from sz3_tpu.ops import blockwise_wavefront as jwf
    from sz3_tpu_torch.ops import blockwise_layout as pbl

    assert (pbl.T_L1, pbl.T_L2, pbl.T_KEEP) == (jwf.T_L1, jwf.T_L2, jwf.T_KEEP)


# the port's copies of the HDF5 filter plugin and the C API header
# (sz3_tpu_torch/csrc/), and why they differ where they do
PLUGIN_DIFFERS = {
    "include/sz3c.h": "its opening comment names the port's engine library and how to build it",
}


@pytest.mark.parametrize("name", ["h5z_szt.cpp", "include/sz3c.h"])
def test_plugin_and_header_copies(name):
    mine = (ROOT / "sz3_tpu_torch" / "csrc" / name).read_text().splitlines()
    orig = (NATIVE / name).read_text().splitlines()
    if name not in PLUGIN_DIFFERS:
        assert mine == orig
        return
    # only the comment before the include guard differs
    guard = next(i for i, ln in enumerate(orig) if ln.startswith("#ifndef"))
    mguard = next(i for i, ln in enumerate(mine) if ln.startswith("#ifndef"))
    assert mine[mguard:] == orig[guard:]
    assert mine[:mguard] != orig[:guard]
    assert all(ln.startswith(("/*", " *")) for ln in mine[:mguard])
