"""ALGO_BIOMD on the port, on the CPU: frame 0's atom chain and the
HuffmanV2 coder in the host engine, frames 1..last through the frame
recurrence's plain version (ops/biomd_device.py). Archives are byte-equal
to backend="native", decodes bit-equal to the engine's, and the plain
recurrence bit-equal to the JAX package's lax.scan (run on the CPU with
x64, as that package's own tests run it)."""

import numpy as np
import pytest
import torch

import sz3_tpu as szt
import sz3_tpu.config as J
import sz3_tpu_torch as szp
import sz3_tpu_torch.config as P
from sz3_tpu.ops import biomd_device as jbd
from sz3_tpu_torch import runtime
from sz3_tpu_torch.algos import device_decode as tdd
from sz3_tpu_torch.ops import biomd_device as tbd

from test_biomd_device import CASES, md_traj

CPU = torch.device("cpu")
RADIUS = 32768


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({4: np.int32, 8: np.int64}[a.dtype.itemsize])


def _roundtrip(x, eb=1e-3):
    """Port archive == native; both decodes of it bit-equal. Returns the
    archive."""
    bn = szt.compress(x, J.Config(cmprAlgo=J.ALGO.BIOMD, absErrorBound=eb))
    bp = szp.compress(x, P.Config(cmprAlgo=P.ALGO.BIOMD, absErrorBound=eb), device="cpu")
    assert bp == bn
    dn, cn = szt.decompress(bn)
    dp, cp = szp.decompress(bn, device="cpu")
    assert np.array_equal(_bits(np.asarray(dn)), _bits(dp.numpy()))
    assert cp.save() == cn.save()
    return bn


def _forbid(monkeypatch, *names):
    def refuse(*a, **k):
        raise AssertionError("a route that this case must not take")

    for mod, name in names:
        monkeypatch.setattr(mod, name, refuse)


@pytest.mark.parametrize("kw", CASES)
def test_device_route_matches_native(kw, monkeypatch):
    """tests/test_biomd_device.py's five cases: site 3 and 4, a tail of fill
    frames, 2 frames, atoms not a multiple of site."""
    traj = md_traj(**kw)
    calls = []
    for name in ("frames_encode", "frames_recover"):
        real = getattr(tbd, name)
        monkeypatch.setattr(tbd, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    _forbid(monkeypatch, (runtime, "compress_payload"), (runtime, "decompress_payload"))
    blob = _roundtrip(traj)
    assert calls == ["frames_encode", "frames_recover"]
    out, conf = szp.decompress(blob, device="cpu")
    assert conf.cmprAlgo == P.ALGO.BIOMD
    assert np.abs(out.numpy() - traj).max() <= 1e-3 * 1.2


@pytest.mark.parametrize("case", ["aperiodic", "f64", "one_frame", "one_live_frame", "2d",
                                  "1d"])
def test_engine_routes(case, monkeypatch):
    """The cases the JAX package hands to its host engine go there from the
    Config, the dtype and host checks, with no device work."""
    rng = np.random.default_rng(5)
    traj = {
        "aperiodic": lambda: np.cumsum(rng.normal(0, 1, (16, 100, 3)), axis=0),
        "f64": lambda: md_traj().astype(np.float64),
        "one_frame": lambda: md_traj(frames=1),
        "one_live_frame": lambda: md_traj(frames=6, fill_tail=5),
        "2d": lambda: md_traj(frames=3, atoms=64)[1],
        "1d": lambda: md_traj(frames=3, atoms=64)[1, :, 0],
    }[case]()
    traj = np.ascontiguousarray(traj, np.float64 if case == "f64" else np.float32)
    if case == "aperiodic":
        assert tbd.cal_site(traj[1]) == 0
    _forbid(monkeypatch, (tbd, "frames_encode"), (tbd, "frames_recover"),
            (runtime, "biomd_frame0"), (runtime, "biomd_seal"), (runtime, "biomd_open"))
    _roundtrip(traj, eb=1e-6 if case == "f64" else 1e-3)


def test_nonfinite_subnormal_and_huge_values():
    """NaN, Inf, subnormal and huge values become literals as in the engine,
    in frame 0 and after it."""
    traj = md_traj(frames=12, atoms=90, seed=3)
    flat = traj.reshape(-1)
    flat[400::97] = np.nan
    flat[405::131] = np.inf
    flat[407::137] = -np.inf
    flat[11::139] = np.float32(3e-39)
    flat[13::149] = np.float32(2.0 ** 40)
    _roundtrip(traj)


def _frames_case(kw, specials):
    traj = md_traj(**kw)
    site = tbd.cal_site(traj[1])
    assert site == kw.get("site_atoms", 3)
    first_fill, _ = tbd.find_fill(traj)
    last = min(traj.shape[0], first_fill)
    if specials:
        live = traj[1:last].reshape(-1)
        live[3::89] = np.nan
        live[5::131] = np.inf
        live[7::113] = -np.float32(2.0 ** 33)
    _, recon0, _ = runtime.biomd_frame0(1e-3, RADIUS, site, traj[0])
    return traj[1:last], recon0, site


@pytest.mark.parametrize("specials", [False, True])
@pytest.mark.parametrize("kw", CASES)
def test_plain_frames_match_jax(kw, specials):
    """frames_encode_plain / frames_recover_plain == the JAX package's
    encode_frames / decode_frames (its _encode_scan / _decode_scan), bit for
    bit, bins and reconstruction."""
    data, recon0, site = _frames_case(kw, specials)
    jbins, junpred = jbd.encode_frames(data, recon0, 1e-3, RADIUS, site)
    tb = tbd.frames_encode(torch.from_numpy(np.ascontiguousarray(data)),
                           torch.from_numpy(recon0), 1e-3, RADIUS, site)
    assert np.array_equal(jbins, tb.numpy())
    if specials:
        assert (jbins == 0).any()
    jrec = jbd.decode_frames(jbins, junpred, recon0, 1e-3, RADIUS, site)
    lits = np.zeros(data.shape, np.float32)
    lits[jbins == 0] = junpred
    trec = tbd.frames_recover(tb, torch.from_numpy(lits), torch.from_numpy(recon0), 1e-3,
                              RADIUS, site)
    assert np.array_equal(_bits(jrec), _bits(trec.numpy()))


def test_frames_argument_checks():
    x = torch.zeros((3, 7, 3))
    r0 = torch.zeros((7, 3))
    for bad in (dict(site=2), dict(site=11), dict(radius=0)):
        kw = dict(eb=1e-3, radius=RADIUS, site=3) | bad
        with pytest.raises(ValueError):
            tbd.frames_encode(x, r0, **kw)
    with pytest.raises(ValueError):
        tbd.frames_encode(x.double(), r0, 1e-3, RADIUS, 3)
    with pytest.raises(ValueError):
        tbd.frames_recover(torch.zeros((3, 7, 3), dtype=torch.int64), x, r0, 1e-3, RADIUS, 3)


def _payload(traj):
    conf = P.Config(dims=traj.shape, cmprAlgo=P.ALGO.BIOMD, absErrorBound=1e-3)
    payload = runtime.compress_payload(conf, traj.copy(), 2 * traj.nbytes + 4096)
    return conf, payload


@pytest.mark.parametrize("drop", [1, 40])
def test_truncated_literal_stream_raises(drop, monkeypatch):
    traj = md_traj(frames=10, atoms=60, seed=2)
    traj.reshape(-1)[200::50] = 1e6                      # literals after frame 0
    conf, payload = _payload(traj)
    real = runtime.biomd_open
    bins, unpred, site, first_fill, fill = real(conf.copy(), payload)
    assert unpred.size > drop
    monkeypatch.setattr(runtime, "biomd_open",
                        lambda c, p: (bins, unpred[:-drop], site, first_fill, fill))
    with pytest.raises(ValueError, match="literal stream"):
        tdd.decode_payload_device_biomd(conf, payload, CPU)


@pytest.mark.parametrize("kw", CASES + [dict(frames=6, fill_tail=5), dict(frames=1)])
def test_header_read_equals_the_open(kw):
    """runtime.biomd_header reads the site, first fill frame and fill value
    that the full open (zstd and HuffmanV2) returns."""
    traj = md_traj(**kw)
    conf, payload = _payload(traj)
    _, _, site, first_fill, fill = runtime.biomd_open(conf.copy(), payload)
    assert runtime.biomd_header(payload) == (site, first_fill, fill)
    with pytest.raises(RuntimeError, match="szt_zstd_head"):
        runtime.biomd_header(payload[:12])


def test_cal_site_and_find_fill_match_jax():
    for kw in CASES + [dict(atoms=50), dict(site_atoms=5, atoms=100)]:
        traj = md_traj(**kw)
        assert tbd.cal_site(traj[1]) == jbd.cal_site(traj[1])
        assert tbd.find_fill(traj) == jbd.find_fill(traj)
    rng = np.random.default_rng(5)
    frame = np.cumsum(rng.normal(0, 1, (100, 3)), axis=0).astype(np.float32)
    assert tbd.cal_site(frame) == jbd.cal_site(frame) == 0
