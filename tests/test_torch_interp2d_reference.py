"""The port's 2D interpolation held to the benchmark's plain reference of
SZ3's (szbench/reference/interp_plain.py), bit for bit, on the CPU: the
bins grid and reconstruction of encode_grid_fast, the engine's stream order,
and compress then decompress, at extents that no level divides by a power
of two, anchored and not, under both interpolators, both directions and the
tuner's three alpha/beta pairs (and a 1D field, which the reference takes
by the same code); the default path (tuner on) at the CPU size
of the CESM-ATM configuration. The reference imports nothing of JAX or of
either package, and a reference fed a bfloat16-rounded input or bound does
not pass the comparison."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sz3_tpu_torch as szp
from sz3_tpu_torch import runtime
from sz3_tpu_torch.ops import interp_fast as tif
from szbench.data import wave_field
from szbench.reference import interp_plain as ip

ROOT = Path(__file__).resolve().parents[1]
CESM = json.loads((ROOT / "szbench" / "configs" / "cesm-atm-1800x3600-f32-rel1e-4.json")
                  .read_text())
CESM_CPU_SHAPE = (117, 117)     # the configuration's shape at the benchmark's CPU test size
# each shape with the largest anchor stride a dimension exceeds (128 where one does)
ANCHORED = {(45, 90): 64, (117, 117): 64, (13, 7): 8, (130, 257): 128, (4000,): 1024}
PAIRS = [(1.25, 2.0), (1.0, 1.0), (1.5, 2.5), (2.0, 3.0)]   # the default, then the tuner's


def _field(shape, seed=3):
    return wave_field.wave_field(shape, seed, torch.device("cpu"))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _within(x: torch.Tensor, out: torch.Tensor, eb: float) -> bool:
    return float((out - x).abs().max()) <= eb


def _interp_conf(shape, eb, algo, direction, anchor, alpha, beta):
    c = szp.Config(dims=shape, cmprAlgo=szp.ALGO.INTERP, errorBoundMode=szp.EB.ABS,
                   absErrorBound=eb)
    c.interpAlgo, c.interpDirection, c.interpAnchorStride = algo, direction, anchor
    c.interpAlpha, c.interpBeta = alpha, beta
    return c


@pytest.mark.parametrize("algo", [0, 1])
@pytest.mark.parametrize("anchored", [False, True])
@pytest.mark.parametrize("shape,direction", [(s, d) for s in ANCHORED if len(s) == 2
                                             for d in (0, 1)] + [((4000,), 0)])
def test_passes_and_stream_order_match_reference(shape, direction, anchored, algo):
    x = _field(shape)
    eb = 1e-3 * float(x.max() - x.min())
    anchor = ANCHORED[shape] if anchored else 0
    for alpha, beta in PAIRS:
        ref = ip.encode(x, eb, interp_algo=algo, direction=direction, alpha=alpha, beta=beta,
                        anchor_stride=anchor)
        plan = tif.build_fast_plan(shape, interp_algo=algo, direction=direction,
                                   anchor_stride=anchor, alpha=alpha, beta=beta, eb=eb,
                                   quantbin_cnt=65536)
        bins, b0, rec = tif.encode_grid_fast(x, plan)
        assert torch.equal(tif.bins_to_grid(bins, plan, b0, "cpu"), ref.bins), (alpha, beta)
        assert torch.equal(_bits(rec), _bits(ref.recon)), (alpha, beta)
        order = runtime.interp_order(_interp_conf(shape, eb, algo, direction, anchor, alpha,
                                                  beta))
        assert np.array_equal(order, ref.order.numpy())
        assert torch.equal(ref.unpred, x.reshape(-1)[ref.order][ref.bins.reshape(-1)[ref.order]
                                                                == 0])
        assert _within(x, ref.recon, eb)
    if anchored:
        assert int((ref.bins[(slice(None, None, anchor),) * len(shape)] != 0).sum()) == 0


# (13, 7) is left out here: an archive of 91 values falls back to zstd alone
@pytest.mark.parametrize("direction", [0, 1])
@pytest.mark.parametrize("algo", [0, 1])
@pytest.mark.parametrize("anchored", [False, True])
@pytest.mark.parametrize("shape", [(45, 90), (117, 117), (130, 257)])
def test_round_trip_matches_reference(shape, anchored, algo, direction):
    x = _field(shape, seed=11)
    eb = 1e-3 * float(x.max() - x.min())
    anchor = ANCHORED[shape] if anchored else 0
    # one of the tuner's pairs a case, each pair in turn (the passes' test takes all
    # of them on every case): the CPU decode walks the Huffman stream in plain torch
    alpha, beta = PAIRS[1 + (2 * algo + direction + anchored) % 3]
    conf = _interp_conf(shape, eb, algo, direction, anchor, alpha, beta)
    out, carried = szp.decompress(szp.compress(x.numpy(), conf, device="cpu"), device="cpu")
    assert carried.cmprAlgo == szp.ALGO.INTERP
    assert (carried.interpAlpha, carried.interpBeta) == (alpha, beta)
    ref = ip.encode(x, **ip.settings(carried))
    assert torch.equal(_bits(out), _bits(ref.recon))
    assert _within(x, out, eb)


@pytest.mark.parametrize("v", [0, 1, 2])
def test_default_path_matches_reference(v):
    """The cell's own path at the configuration's CPU size: REL 1e-4, the
    default Config (the tuner picks the setting), one of the pool's fields."""
    x = wave_field.make(CESM_CPU_SHAPE, 3, CESM["data_seed"], "cpu")[v]
    conf = szp.Config(errorBoundMode=szp.EB.REL, relErrorBound=CESM["error_bound"]["rel"])
    out, carried = szp.decompress(szp.compress(x.numpy(), conf, device="cpu"), device="cpu")
    assert carried.cmprAlgo == szp.ALGO.INTERP
    ref = ip.encode(x, **ip.settings(carried))
    assert torch.equal(_bits(out), _bits(ref.recon))
    assert _within(x, out, carried.absErrorBound)
    plan = tif.build_fast_plan(CESM_CPU_SHAPE, interp_algo=carried.interpAlgo,
                               direction=carried.interpDirection,
                               anchor_stride=carried.interpAnchorStride,
                               alpha=carried.interpAlpha, beta=carried.interpBeta,
                               eb=carried.absErrorBound, quantbin_cnt=carried.quantbinCnt)
    bins, b0, _ = tif.encode_grid_fast(x, plan)
    assert torch.equal(tif.bins_to_grid(bins, plan, b0, "cpu"), ref.bins)


def test_reference_imports_no_package():
    code = ("import sys\n"
            "import szbench.reference.interp_plain\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'sz3_tpu', 'sz3_tpu_torch'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr


@pytest.mark.parametrize("lowered", ["input", "bound"])
def test_a_lower_precision_fails_the_comparison(lowered):
    """The reference fed the field or the bound rounded to bfloat16, the step
    below float32, does not match the port's archive: the comparison tells a
    lower precision."""
    x = _field((130, 257), seed=7)
    conf = szp.Config(errorBoundMode=szp.EB.REL, relErrorBound=1e-4)
    out, carried = szp.decompress(szp.compress(x.numpy(), conf, device="cpu"), device="cpu")
    kw = ip.settings(carried)
    assert torch.equal(_bits(out), _bits(ip.encode(x, **kw).recon))
    if lowered == "input":
        x = x.bfloat16().float()
    else:
        kw["eb"] = float(torch.tensor(kw["eb"]).bfloat16())
    low = ip.encode(x, **kw)
    assert not torch.equal(_bits(out), _bits(low.recon))
    assert not torch.equal(low.bins, ip.encode(_field((130, 257), seed=7), **ip.settings(
        carried)).bins)
