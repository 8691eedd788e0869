"""The INTERP encode's kernel route (csrc/interp_encode.cu) against its
plain route (encode_grid_plain).

On the CPU: the kernel's index arithmetic, evaluated in numpy from the pass
table the host hands it (interp_fast.pass_rows), selects for every point
of every pass the original, the five coarse neighbours and the point before
on the line that the plain route's _decimation_chain, _shifts and
_stage2_fix select; and the route is the plain one, with the bins grid
filled as bins_to_grid fills it.

On a CUDA card (marked cuda; they skip without one): the kernel route is bit
for bit the plain route run on the CPU (the bins grid, b0, the
reconstruction), and the archives of compress equal the plain route's.

Run on the card:  python -m pytest tests/test_torch_interp_kernel.py -q -m cuda
"""

import hashlib

import numpy as np
import pytest
import torch

import sz3_tpu_torch as szp
from sz3_tpu_torch import ALGO, Config
from sz3_tpu_torch.ops import interp_fast as tif
from sz3_tpu_torch.ops.interp_plan import K_LIN1_NEW

CPU = torch.device("cpu")


def _plan(dims, algo, direction, anchor, eb=1e-2, alpha=1.25, beta=2.0):
    return tif.build_fast_plan(tuple(dims), interp_algo=algo, direction=direction,
                               anchor_stride=anchor, alpha=alpha, beta=beta, eb=eb,
                               quantbin_cnt=65536)


def _kernel_index(row, trials, blocks, G):
    """The kernel's index arithmetic over every thread of one pass row, in
    numpy: (own offset, the five neighbours' offsets, the offset of the
    point before on the line, the index of the kind read), each (T*K*npts,),
    grid-major as the launch's blockIdx.y/z run over the grids."""
    n = [int(v) for v in row[:4]]
    e = [int(v) for v in row[4:8]]
    base, dd, cstep, C = (int(v) for v in row[8:12])
    kstride = int(row[13])
    r = np.arange(np.prod(n), dtype=np.uint32)
    i3 = (r % n[3]).astype(np.int64)
    r = r // n[3]
    i2 = (r % n[2]).astype(np.int64)
    r = r // n[2]
    i1 = (r % n[1]).astype(np.int64)
    i0 = (r // n[1]).astype(np.int64)
    j = (i0, i1, i2, i3)[dd]
    off = i0 * e[0] + i1 * e[1] + i2 * e[2] + i3 * e[3]
    line = off - j * e[dd]
    own = base + off
    nbs = [line + np.clip(j + d, 0, C - 1) * cstep for d in (-2, -1, 0, 1, 2)]
    prev = base + line + np.maximum(j - 1, 0) * e[dd]
    b = np.arange(trials * blocks, dtype=np.int64)
    t = b // blocks

    def per_grid(v):
        return (b[:, None] * G + v[None, :]).reshape(-1)
    return (per_grid(own), [per_grid(v) for v in nbs], per_grid(prev),
            (t[:, None] * kstride + j[None, :]).reshape(-1))


def _plain_index(plan, lead, batch):
    """What the plain route selects, over a grid of running numbers: per
    pass (the originals, the five shifts, the stage-2 point before, the
    kinds), each flattened in the pass's own order."""
    G = int(np.prod(plan.dims))
    x = torch.arange(int(np.prod(batch)) * G, dtype=torch.float64).reshape(batch + plan.dims)
    coarse, curs = tif._decimation_chain(x, plan, lead)
    out = []
    for spec, cur, (kind, _) in zip(plan.passes, curs, tif._consts(plan, CPU)):
        shifts = tif._shifts(coarse, spec, lead)
        kinds = tif._kindvec(kind, spec, x.ndim, lead).expand(cur.shape)
        every = torch.full(cur.shape, K_LIN1_NEW, dtype=torch.int32)
        # _stage2_fix's prediction -0.5 * prev + 1.5 * 0 gives prev back
        prev = -2 * tif._stage2_fix(spec, every, torch.zeros_like(cur), cur, cur, lead)
        out.append((cur.reshape(-1), [s.reshape(-1) for s in shifts], prev.reshape(-1),
                    kinds.reshape(-1)))
        coarse = tif._interleave(coarse, cur, spec.dd + lead, spec.shape_out[spec.dd])
    assert torch.equal(coarse, x)
    return out


_DESCRIPTOR_CASES = (
    [((33, 37, 41), algo, d, 32) for algo in (0, 1) for d in range(6)]
    + [((257, 515), algo, d, 128) for algo in (0, 1) for d in (0, 1)]
    + [((40, 33, 17), 0, 3, 64), ((9, 10, 11, 12), 1, 17, 16), ((1000,), 0, 0, 4096),
       ((1000,), 1, 0, 256), ((2, 1, 9), 1, 0, 32)])


@pytest.mark.parametrize("dims,algo,direction,anchor", _DESCRIPTOR_CASES)
def test_pass_rows_select_what_the_plain_passes_select(dims, algo, direction, anchor):
    plan = _plan(dims, algo, direction, anchor)
    rows, ebs = tif.pass_rows(plan, CPU, 1, 0)
    assert rows.shape == (len(plan.passes), 15)
    G = int(np.prod(dims))
    for k, (row, spec, want, (kind, _)) in enumerate(zip(rows, plan.passes,
                                                          _plain_index(plan, 0, ()),
                                                          tif._consts(plan, CPU))):
        own, nbs, prev, kix = _kernel_index(row, 1, 1, G)
        assert np.array_equal(own, want[0].numpy()), k
        for d in range(5):
            assert np.array_equal(nbs[d], want[1][d].numpy()), (k, d)
        assert np.array_equal(prev, want[2].numpy()), k
        assert np.array_equal(kind.reshape(-1).numpy()[kix], want[3].numpy()), k
        assert row[12] == kind.data_ptr() and row[13] == 0 and row[14] == 0
        assert ebs[k] == spec.eb


@pytest.mark.parametrize("dims,anchor,stage", [((33, 33, 33), 32, "kinds"),
                                               ((33, 33, 33), 32, "bounds"),
                                               ((129, 129), 128, "kinds"),
                                               ((17, 17, 17), 32, "bounds")])
def test_pass_rows_of_stacked_trials_select_each_trials_kinds_and_bounds(dims, anchor, stage):
    """The tuner's stacked lead=2 plans: each trial's kinds and bounds, and
    each grid of the (trials, blocks) batch at its own offset."""
    if stage == "kinds":
        plans = [_plan(dims, algo, 0, anchor) for algo in (0, 1)]
    else:
        plans = [_plan(dims, 0, 0, anchor, alpha=a, beta=b)
                 for a, b in ((1.0, 1.0), (1.5, 2.5), (2.0, 3.0))]
    plan = tif.stack_plans(plans)
    T, K = len(plans), 3
    rows, ebs = tif.pass_rows(plan, CPU, T, 2)
    G = int(np.prod(dims))
    consts = tif._consts(plan, CPU)
    for k, (row, spec, want, (kind, teb)) in enumerate(zip(rows, plan.passes,
                                                            _plain_index(plan, 2, (T, K)),
                                                            consts)):
        own, nbs, prev, kix = _kernel_index(row, T, K, G)
        assert np.array_equal(own, want[0].numpy()), k
        for d in range(5):
            assert np.array_equal(nbs[d], want[1][d].numpy()), (k, d)
        assert np.array_equal(prev, want[2].numpy()), k
        assert np.array_equal(kind.reshape(-1).numpy()[kix], want[3].numpy()), k
        if teb is None:
            assert row[14] == 0 and ebs[k] == spec.eb
        else:
            assert row[14] == teb.data_ptr() and ebs[k] == 0.0
            assert teb.tolist() == list(spec.eb)
    with pytest.raises(ValueError):
        tif.pass_rows(plan, CPU, T + 1, 2)


def test_the_cpu_takes_the_plain_route_and_fills_the_grid():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(np.cumsum(rng.standard_normal((20, 21, 22)), axis=-1).astype(np.float32))
    plan = _plan(x.shape, 0, 2, 64)            # no anchors: b0 goes into the grid
    assert tif.encode_route(x) == "plain" and tif.pass_launches(plan, x) == 0
    launches = tif.encode_grid_fast.launches
    grid = torch.zeros(plan.dims, dtype=torch.int32)
    bins, b0, rec = tif.encode_grid_fast(x, plan, grid=grid)
    pbins, pb0, prec = tif.encode_grid_plain(x, plan)
    assert torch.equal(grid, tif.bins_to_grid(pbins, plan, pb0, CPU))
    assert all(torch.equal(a, b) for a, b in zip(bins, pbins))
    assert torch.equal(b0, pb0) and torch.equal(rec, prec)
    assert tif.encode_grid_fast.launches == launches


# ---- on the card ------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _field(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    for a in range(len(shape)):
        x = np.cumsum(x, axis=a) * 0.3
    return x.astype(dtype)


def _bits(t):
    t = t.contiguous().cpu()
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _same_as_plain(x, plan, lead=0):
    """The kernel route on the card against the plain route on the CPU:
    the bins grid, b0 and the reconstruction, as bits."""
    dev = torch.device("cuda")
    xc = x.to(dev)
    before = _bits(xc)
    assert tif.encode_route(xc) == "kernel"
    batch = tuple(x.shape[:lead])
    launches = tif.encode_grid_fast.launches
    grid = torch.zeros(batch + plan.dims, dtype=torch.int32, device=dev)
    bins, b0, rec = tif.encode_grid_fast(xc, plan, lead, grid=grid)
    assert tif.encode_grid_fast.launches == launches + tif.pass_launches(plan, xc)
    pbins, pb0, prec = tif.encode_grid_plain(x, plan, lead)
    assert torch.equal(grid.cpu(), tif.bins_to_grid(pbins, plan, pb0, CPU, batch=batch))
    for a, b in zip(bins, pbins):
        assert torch.equal(a.cpu(), b)
    assert (b0 is None) == (pb0 is None)
    if b0 is not None:
        assert torch.equal(b0.cpu().reshape(-1), pb0.reshape(-1))
    assert torch.equal(_bits(rec), _bits(prec))
    assert torch.equal(_bits(xc), before)       # x is left as it was
    return grid


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(65, 65, 65), (33, 70, 129)])
@pytest.mark.parametrize("algo", [0, 1])
@pytest.mark.parametrize("direction", range(6))
def test_kernel_equals_plain_3d(dev, shape, algo, direction):
    x = torch.from_numpy(_field(shape, direction + 7 * algo))
    _same_as_plain(x, _plan(shape, algo, direction, 32, eb=0.05))


@pytest.mark.cuda
@pytest.mark.parametrize("algo", [0, 1])
@pytest.mark.parametrize("direction", [0, 1])
def test_kernel_equals_plain_2d_per_line(dev, algo, direction):
    """SZ3's 1D/2D per-line kinds (K_LIN1_OLD, K_COPY) and a partial block at
    every level."""
    x = torch.from_numpy(_field((257, 515), 11 + algo))
    _same_as_plain(x, _plan((257, 515), algo, direction, 128))


@pytest.mark.cuda
@pytest.mark.parametrize("dims,algo,direction,anchor", [((40, 33, 17), 0, 3, 64),
                                                        ((40, 33, 17), 1, 0, 64),
                                                        ((1000,), 1, 0, 4096),
                                                        ((9, 10, 11, 12), 0, 5, 16)])
def test_kernel_equals_plain_without_anchors_and_other_ranks(dev, dims, algo, direction, anchor):
    x = torch.from_numpy(_field(dims, 3))
    _same_as_plain(x, _plan(dims, algo, direction, anchor))


@pytest.mark.cuda
def test_kernel_equals_plain_on_a_strided_view(dev):
    """A field that is a strided view of a larger array is read in the
    working grid's layout."""
    x = torch.from_numpy(_field((40, 50, 66), 21))[:, 3:43, ::2]
    assert not x.is_contiguous()
    _same_as_plain(x, _plan(x.shape, 1, 2, 32))


@pytest.mark.cuda
@pytest.mark.parametrize("dims,anchor", [((33, 33, 33), 32), ((129, 129), 128),
                                         ((17, 17, 17), 32)])
@pytest.mark.parametrize("stage", ["kinds", "bounds"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_kernel_equals_plain_on_stacked_trials(dev, dims, anchor, stage, dtype):
    """The tuner's lead=2 batches: per-trial kinds (linear and cubic) and
    per-trial bounds (the alpha/beta pairs), over expanded blocks."""
    if stage == "kinds":
        plans = [_plan(dims, algo, 0, anchor) for algo in (0, 1)]
    else:
        plans = [_plan(dims, 1, 0, anchor, alpha=a, beta=b)
                 for a, b in ((1.0, 1.0), (1.5, 2.5), (2.0, 3.0))]
    blocks = torch.from_numpy(_field((5,) + dims, 4, dtype))
    _same_as_plain(blocks.expand((len(plans),) + blocks.shape), tif.stack_plans(plans), lead=2)


@pytest.mark.cuda
@pytest.mark.parametrize("algo,direction", [(0, 2), (1, 4)])
def test_kernel_equals_plain_float64(dev, algo, direction):
    x = torch.from_numpy(_field((65, 65, 65), 5, np.float64))
    _same_as_plain(x, _plan((65, 65, 65), algo, direction, 32, eb=1e-3))


@pytest.mark.cuda
@pytest.mark.parametrize("algo", [0, 1])
@pytest.mark.parametrize("eb", [1e-2, float("inf")])
def test_kernel_equals_plain_on_nan_inf_and_the_clamp(dev, algo, eb):
    """NaN and +-Inf originals, and quotients at and past the quantizer's
    clamp (2 * radius)."""
    x = _field((33, 34, 35), 8)
    x[3, 4, 5] = np.nan
    x[10, 11, 12] = np.inf
    x[20, 1, 7] = -np.inf
    x[5, 5, 5] = 1e30
    x[6, 7, 9] = -655.36      # 65,536 bounds from its neighbours
    x[0, 0, 1] = 655.34
    x[31, 33, 1] = np.nan
    _same_as_plain(torch.from_numpy(x), _plan(x.shape, algo, 0, 32, eb=eb))
    _same_as_plain(torch.from_numpy(x), _plan(x.shape, algo, 5, 64, eb=eb))


def _archive(data, device):
    conf = Config(cmprAlgo=ALGO.INTERP_LORENZO, errorBoundMode=szp.EB.REL, relErrorBound=1e-4)
    return hashlib.sha256(szp.compress(data, conf, device=device)).hexdigest()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(96, 100, 104), (450, 900)])
def test_compress_on_the_card_gives_the_plain_routes_archive(dev, monkeypatch, shape):
    """The default path (the tuner, then the passes) on the card gives the
    archive of the plain route, run on the card and on the CPU."""
    data = _field(shape, 13)
    launches = tif.encode_grid_fast.launches
    kernel = _archive(data, dev)
    assert tif.encode_grid_fast.launches > launches
    assert kernel == _archive(data, "cpu")
    monkeypatch.setattr(tif, "encode_route", lambda x: "plain")
    assert kernel == _archive(data, dev)
