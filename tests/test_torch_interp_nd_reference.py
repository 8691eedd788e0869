"""The port's 3D and 4D interpolation held to the benchmark's plain reference
of SZ3's (szbench/reference/interp_plain_nd.py), bit for bit, on the CPU:
the bins grid and reconstruction of encode_grid_fast, the engine's stream
order, and compress then decompress, at extents that no level divides by a
power of two, anchored and not, under both interpolators, directions 0 and
5 in 3D and 0, 9 and 23 in 4D, the default and the tuner's three
alpha/beta pairs, in float32 and float64; the default path (tuner on) at
the CPU size of the QMCPACK configuration, with the archive's Config the
tuner's pick. The reference imports nothing of JAX or of either package, a
reference fed a bfloat16-rounded input or bound does not pass the
comparison, and the configuration's generator is deterministic from its
seed, with orbitals that differ."""

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
from sz3_tpu_torch.utils import trace
from szbench.data import einspline_like, wave_field
from szbench.reference import interp_plain_nd as ipn

ROOT = Path(__file__).resolve().parents[1]
QMC = json.loads((ROOT / "szbench" / "configs" / "qmcpack-288x115x69x69-f32-rel1e-4.json")
                 .read_text())
# the configuration's shape cut until each axis just exceeds the 4D anchor
# stride (16), so that the anchor grid is in force; the tuner samples blocks
# of edge 9 at this size (17 at the published shape)
QMC_CPU_SHAPE = (35, 23, 19, 19)
# each shape with the largest anchor stride a dimension exceeds
ANCHORED = {(19, 11, 13): 16, (19, 11, 13, 10): 16, (33, 9, 40): 32}
DIRECTIONS = {3: (0, 5), 4: (0, 9, 23)}
PAIRS = [(1.25, 2.0), (1.0, 1.0), (1.5, 2.5), (2.0, 3.0)]   # the default, then the tuner's


def _field(shape, seed=3, dtype=torch.float32):
    """A smooth field with noise and a few spikes, and its bound: 1e-3 of
    the range without the spikes, which 1e5 bounds away make unpredictable
    points at every level."""
    x = wave_field.wave_field(shape, seed, torch.device("cpu")).to(dtype)
    g = torch.Generator().manual_seed(seed)
    x = x + 0.2 * torch.rand(shape, generator=g, dtype=dtype)
    span = float(x.max() - x.min())
    spikes = torch.randperm(x.numel(), generator=g)[:max(4, x.numel() // 500)]
    x.view(-1)[spikes] += 100 * span
    return x, 1e-3 * span


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _within(x: torch.Tensor, out: torch.Tensor, eb: float) -> bool:
    return float((out - x).abs().max()) <= eb


def _interp_conf(shape, eb, algo, direction, anchor, alpha, beta):
    c = szp.Config(dims=shape, cmprAlgo=szp.ALGO.INTERP, errorBoundMode=szp.EB.ABS,
                   absErrorBound=eb)
    c.interpAlgo, c.interpDirection, c.interpAnchorStride = algo, direction, anchor
    c.interpAlpha, c.interpBeta = alpha, beta
    return c


def _plan(shape, kw):
    return tif.build_fast_plan(shape, interp_algo=kw["interp_algo"], direction=kw["direction"],
                               anchor_stride=kw["anchor_stride"], alpha=kw["alpha"],
                               beta=kw["beta"], eb=kw["eb"], quantbin_cnt=kw["quantbin_cnt"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("algo", [0, 1])
@pytest.mark.parametrize("anchored", [False, True])
@pytest.mark.parametrize("shape,direction", [(s, d) for s in ((19, 11, 13), (19, 11, 13, 10))
                                             for d in DIRECTIONS[len(s)]])
def test_passes_and_stream_order_match_reference(shape, direction, anchored, algo, dtype):
    x, eb = _field(shape, dtype=dtype)
    anchor = ANCHORED[shape] if anchored else 0
    order = runtime.interp_order(_interp_conf(shape, eb, algo, direction, anchor, 1.0, 1.0))
    for alpha, beta in PAIRS:
        kw = dict(eb=eb, interp_algo=algo, direction=direction, alpha=alpha, beta=beta,
                  anchor_stride=anchor, quantbin_cnt=65536)
        ref = ipn.encode(x, **kw)
        plan = _plan(shape, kw)
        bins, b0, rec = tif.encode_grid_fast(x, plan)
        assert torch.equal(tif.bins_to_grid(bins, plan, b0, "cpu"), ref.bins), (alpha, beta)
        assert torch.equal(_bits(rec), _bits(ref.recon)), (alpha, beta)
        # the stream order depends on the setting's traversal alone
        assert np.array_equal(order, ref.order.numpy())
        assert torch.equal(ref.unpred, x.reshape(-1)[ref.order][ref.bins.reshape(-1)[ref.order]
                                                                == 0])
        assert ref.unpred.numel() > 0 and _within(x, ref.recon, eb)
    if anchored:
        assert int((ref.bins[(slice(None, None, anchor),) * len(shape)] != 0).sum()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("algo", [0, 1])
@pytest.mark.parametrize("anchored", [False, True])
@pytest.mark.parametrize("shape", [(33, 9, 40), (19, 11, 13, 10)])
def test_round_trip_matches_reference(shape, anchored, algo, dtype):
    x, eb = _field(shape, seed=11, dtype=dtype)
    anchor = ANCHORED[shape] if anchored else 0
    # one direction and one of the tuner's pairs a case, each in turn (the
    # passes' test takes all of them): the CPU decode walks the Huffman
    # stream in plain torch
    k = 2 * algo + anchored + (dtype == torch.float64)
    direction = DIRECTIONS[len(shape)][k % len(DIRECTIONS[len(shape)])]
    alpha, beta = PAIRS[1 + k % 3]
    conf = _interp_conf(shape, eb, algo, direction, anchor, alpha, beta)
    out, carried = szp.decompress(szp.compress(x.numpy(), conf, device="cpu"), device="cpu")
    assert carried.cmprAlgo == szp.ALGO.INTERP and out.dtype == dtype
    assert (carried.interpDirection, carried.interpAlpha, carried.interpBeta) == \
        (direction, alpha, beta)
    ref = ipn.encode(x, **ipn.settings(carried))
    assert torch.equal(_bits(out), _bits(ref.recon))
    assert _within(x, out, eb)


@pytest.mark.parametrize("v", [0, 1])
def test_default_path_matches_reference(v):
    """The cell's own path at the configuration's CPU size: REL 1e-4, the
    default Config (the tuner on, its pick the archive's Config), one of the
    pool's tables."""
    x = einspline_like.make(QMC_CPU_SHAPE, 2, QMC["data_seed"], "cpu")[v]
    conf = szp.Config(errorBoundMode=szp.EB.REL, relErrorBound=QMC["error_bound"]["rel"])
    was = trace.enabled()
    trace.enable()
    trace.spans()
    try:
        blob = szp.compress(x.numpy(), conf, device="cpu")
        tune, = [s.attrs for s in trace.spans() if s.name == "dispatch.tune"]
    finally:
        if not was:
            trace.disable()
        trace.spans()
    out, carried = szp.decompress(blob, device="cpu")
    assert carried.cmprAlgo == szp.ALGO.INTERP and carried.interpAnchorStride == 16
    assert (tune["interp_algo"], tune["direction"], tune["alpha"], tune["beta"]) == \
        (int(carried.interpAlgo), carried.interpDirection, carried.interpAlpha, carried.interpBeta)
    assert tune["edge"] == 9 and tune["blocks"] > 0
    kw = ipn.settings(carried)
    ref = ipn.encode(x, **kw)
    assert torch.equal(_bits(out), _bits(ref.recon))
    assert _within(x, out, carried.absErrorBound)
    plan = _plan(QMC_CPU_SHAPE, kw)
    bins, b0, _ = tif.encode_grid_fast(x, plan)
    assert torch.equal(tif.bins_to_grid(bins, plan, b0, "cpu"), ref.bins)
    assert np.array_equal(runtime.interp_order(carried), ref.order.numpy())


def test_reference_imports_no_package():
    code = ("import sys, torch\n"
            "import szbench.reference.interp_plain_nd\n"
            "assert not torch.backends.cuda.matmul.allow_tf32\n"
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
    shape = (19, 11, 13, 10)
    x = einspline_like.table(shape, 7, torch.device("cpu"))
    conf = szp.Config(errorBoundMode=szp.EB.REL, relErrorBound=1e-4)
    out, carried = szp.decompress(szp.compress(x.numpy(), conf, device="cpu"), device="cpu")
    kw = ipn.settings(carried)
    right = ipn.encode(x, **kw)
    assert torch.equal(_bits(out), _bits(right.recon))
    if lowered == "input":
        x = x.bfloat16().float()
    else:
        kw["eb"] = float(torch.tensor(kw["eb"]).bfloat16())
    low = ipn.encode(x, **kw)
    assert not torch.equal(_bits(out), _bits(low.recon))
    assert not torch.equal(low.bins, right.bins)


def test_einspline_like_is_deterministic_and_its_orbitals_differ():
    shape = (12, 23, 19, 19)
    a = einspline_like.make(shape, 2, QMC["data_seed"], "cpu")
    assert a.dtype == torch.float32 and tuple(a.shape) == (2, *shape)
    assert torch.equal(a, einspline_like.make(shape, 2, QMC["data_seed"], "cpu"))
    assert not torch.equal(a, einspline_like.make(shape, 2, QMC["data_seed"] + 1, "cpu"))
    assert not torch.equal(a[0], a[1])              # the pool's tables differ
    t = a[0].double()
    # each orbital normalised, its grid smooth; neighbouring orbitals unrelated
    assert torch.allclose(t.square().mean(dim=(1, 2, 3)), torch.ones(shape[0], dtype=t.dtype),
                          atol=1e-3)
    along_grid = (t[:, :, :, 1:] - t[:, :, :, :-1]).abs().mean()
    along_orbitals = (t[1:] - t[:-1]).abs().mean()
    assert along_orbitals > 3 * along_grid
    for k in range(1, shape[0]):
        assert not torch.allclose(t[k], t[k - 1], atol=0.1)
