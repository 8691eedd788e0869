"""ALGO_LORENZO_REG in the port, on the CPU (the kernels' plain versions),
held with a tolerance of zero: archives byte-equal to the host engine's
(backend="native"), decodes bit-equal to the engine's and to the JAX
package's wavefront decode, streams equal to the JAX package's wavefront
encode, the golden archives decoded to their recorded hash, and the
configurations the card does not run sent to the engine before any device
work."""

import hashlib
import json

import numpy as np
import pytest
import torch

import sz3_tpu as szt
import sz3_tpu.config as J
import sz3_tpu_torch as szp
import sz3_tpu_torch.config as P
from sz3_tpu import runtime as jrt
from sz3_tpu.ops import blockwise_device as jbd
from sz3_tpu.ops import blockwise_wavefront as jwf
from sz3_tpu.ops import blockwise_wavefront_encode as jwfe
from sz3_tpu_torch import runtime as prt
from sz3_tpu_torch.algos import device_decode, device_encode
from sz3_tpu_torch.algos.torch_backend import compress_payload_torch, decompress_payload_torch
from sz3_tpu_torch.ops import blockwise_layout as bl
from sz3_tpu_torch.ops import blockwise_wavefront as wf
from sz3_tpu_torch.ops import blockwise_wavefront_encode as wfe
from sz3_tpu_torch.ops import entropy_device as ted
from sz3_tpu_torch.ops import stream_order
from sz3_tpu_torch.utils import trace

from conftest import GOLDEN

RADIUS = 32768


def _field(shape, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(shape).astype(np.float32)
    return (np.cumsum(f, axis=0) * 0.1 + np.cumsum(f, axis=-1) * 0.05).astype(np.float32)


def _flip_field():
    """Smooth base plus a per-cell jitter of about eb: pads near selection
    margins (tests/test_blockwise_wavefront_encode.py:123-136)."""
    rng = np.random.default_rng(11)
    base = _field((24, 24, 24), seed=11)
    jitter = (rng.integers(0, 3, base.shape) - 1).astype(np.float32) * 9e-4
    return (base + jitter).astype(np.float32)


ROSTERS = {"default": (True, False, True), "lorenzo_only": (True, False, False),
           "reg_only": (False, False, True)}
DECODE_ROSTERS = dict(ROSTERS, lorenzo2_reg=(False, True, True), all_three=(True, True, True),
                      lorenzo2_only=(False, True, False))
SHAPES = [(18, 18, 18), (20, 19, 17), (11, 25, 9), (33, 6, 47)]
SHAPE_IDS = ["x".join(map(str, s)) for s in SHAPES]


def _conf(ns, shape, eb=1e-3, roster=(True, False, True)):
    c = ns.Config(dims=shape, cmprAlgo=ns.ALGO.LORENZO_REG, absErrorBound=eb)
    c.lorenzo, c.lorenzo2, c.regression = roster
    return c


def _seed(name, shape):
    return (sum(ord(c) for c in name) * 999983 + sum(shape)) % 2 ** 31


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


def _same_as_engine(x, make_conf, **kw):
    """Port archive == engine archive, port decode == engine decode; returns
    the archive."""
    bn = szt.compress(x, make_conf(J), backend="native", **kw)
    bp = szp.compress(x, make_conf(P), device="cpu", **kw)
    assert bp == bn
    dn, _ = szt.decompress(bn)
    dp, _ = szp.decompress(bn, device="cpu")
    assert np.array_equal(_bits(np.asarray(dn)), _bits(dp.numpy()))
    return bn


# ---- archives -------------------------------------------------------------------

@pytest.mark.parametrize("roster", ROSTERS, ids=ROSTERS.keys())
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_archive_parity(roster, shape):
    x = _field(shape, seed=_seed(roster, shape))
    _same_as_engine(x, lambda ns: _conf(ns, shape, roster=ROSTERS[roster]))


@pytest.mark.parametrize("eb", [1e-1, 1e-2, 1e-4, 1e-6])
def test_archive_parity_across_error_bounds(eb):
    """Fine bounds make literals (and, at the finest, a lossless archive),
    coarse ones saturate bins."""
    x = _field((20, 19, 17), seed=7)
    _same_as_engine(x, lambda ns: _conf(ns, x.shape, eb=eb))


def test_speculation_flip_field():
    x = _flip_field()
    _same_as_engine(x, lambda ns: _conf(ns, x.shape))


@pytest.mark.parametrize("shape,constant", [((13, 12, 7), True), ((13, 14, 8), False)],
                         ids=["constant", "thin_tails"])
def test_constant_field_and_thin_blocks(shape, constant):
    """Tail blocks of extent 1 and 2 (regression-invalid: the Lorenzo
    fallback) and a constant field (no literals, one Huffman symbol)."""
    x = np.full(shape, 2.5, np.float32) if constant else _field(shape, seed=4)
    blob = _same_as_engine(x, lambda ns: _conf(ns, shape, eb=1e-2))
    assert szp.open_archive(blob)[0].cmprAlgo == P.ALGO.LORENZO_REG


@pytest.mark.parametrize("chunk", [1, 5])
@pytest.mark.parametrize("roster", ["default", "reg_only"])
def test_regression_cells_placed_in_chunks(monkeypatch, chunk, roster):
    """Regression cells placed a few blocks at a time (a field of many
    regression blocks at full size) give the engine's archive and decode."""
    monkeypatch.setattr(wf, "REG_CHUNK", chunk)
    x = _field((20, 19, 17), seed=_seed(roster, (chunk,)))
    _same_as_engine(x, lambda ns: _conf(ns, x.shape, roster=ROSTERS[roster]))


def test_nonfinite_and_subnormal_values():
    """NaN, Inf and subnormal values, held to the engine (XLA on the CPU
    flushes subnormals, so the JAX package is not the reference here)."""
    x = _field((40, 36, 33), seed=11)
    flat = x.reshape(-1)
    flat[::97] = np.nan
    flat[5::131] = np.inf
    flat[7::137] = -np.inf
    flat[11::139] = np.float32(3e-39)
    blob = _same_as_engine(x, lambda ns: _conf(ns, x.shape))
    assert szp.open_archive(blob)[0].cmprAlgo == P.ALGO.LORENZO_REG


def test_a_block_without_a_selection():
    """An infinite value at the first sample of a regression-invalid block
    makes its invalid regression win; the host engine then emits no
    selection for it (ComposedPredictor's ok = false) and predicts it with
    Lorenzo-1. The port writes the same bytes. The archive holds one
    selection fewer than blocks, which the engine's own decode reads out of
    step: the port's decode raises instead."""
    rng = np.random.default_rng(30)
    f = rng.standard_normal((13, 12, 12)).astype(np.float32)
    x = (np.cumsum(f, axis=0) * 0.1 + np.cumsum(f, axis=-1) * 0.05).astype(np.float32)
    x[12, 0, 0] = np.inf                            # the base of block (2, 0, 0), extent 1
    bn = szt.compress(x, _conf(J, x.shape, eb=1e-2), backend="native")
    assert szp.compress(x, _conf(P, x.shape, eb=1e-2), device="cpu") == bn
    conf, payload = szp.open_archive(bn)
    assert conf.cmprAlgo == P.ALGO.LORENZO_REG
    assert prt.blockwise_open(conf, payload)[1].size == bl.geometry(x.shape).nblk - 1
    with pytest.raises(ValueError, match="selection stream of 11 entries for 12 blocks"):
        szp.decompress(bn, device="cpu")


def test_forced_certification_passes(monkeypatch):
    """The speculative selection replaced by its complement (wherever a
    regression is valid): the certification loop must still reach the
    engine's archive, after more passes than the JAX package's cap of 3."""
    select = wfe.select

    def complement(geo, orig_p, tap_p, *args):
        is_reg, ok = select(geo, orig_p, tap_p, *args)
        if tap_p is orig_p:                       # the speculative call
            return ~is_reg & bl.reg_valid(geo, orig_p.device), ok
        return is_reg, ok

    stats = {}
    encode = wfe.encode_blocks_wavefront

    def counted(*args):
        return encode(*args[:6], stats=stats)

    monkeypatch.setattr(wfe, "select", complement)
    monkeypatch.setattr(wfe, "encode_blocks_wavefront", counted)
    x = _field((20, 19, 17), seed=7)
    blob = _same_as_engine(x, lambda ns: _conf(ns, x.shape, eb=1e-1))
    assert szp.open_archive(blob)[0].cmprAlgo == P.ALGO.LORENZO_REG
    assert stats["passes"] > 3
    firsts = stats["first_differences"]
    assert firsts[-1] == -1 and firsts[:-1] == sorted(set(firsts[:-1]))


def test_the_loop_raises_without_progress(monkeypatch):
    """A certifying selection that never moves the first difference is an
    internal contradiction: the loop raises and hands nothing elsewhere."""
    select = wfe.select
    calls = []

    def stuck(geo, orig_p, tap_p, *args):
        is_reg, ok = select(geo, orig_p, tap_p, *args)
        if tap_p is orig_p:
            return is_reg, ok
        calls.append(1)
        flip = torch.zeros_like(is_reg)
        flip.view(-1)[0] = len(calls) % 2 == 1       # block 0 toggles from pass to pass
        return is_reg ^ flip, ok

    monkeypatch.setattr(wfe, "select", stuck)
    x = torch.from_numpy(_field((18, 18, 18), seed=3))
    with pytest.raises(RuntimeError, match="no progress"):
        wfe.encode_blocks_wavefront(x, 1e-3, RADIUS, True, False, True)


# ---- streams against the JAX package's wavefront encode ----------------------------

@pytest.mark.parametrize("roster", ROSTERS, ids=ROSTERS.keys())
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_streams_match_jax(roster, shape):
    """bins, selection, reg_bins, ql/qi_unpred and unpred equal the JAX
    package's encode_blocks_wavefront's."""
    x = _field(shape, seed=_seed(roster, shape) + 1)
    want = jwfe.encode_blocks_wavefront(x, 1e-3, RADIUS, *ROSTERS[roster])
    bins_g, g, sel, regb, qlu, qiu = wfe.encode_blocks_wavefront(
        torch.from_numpy(x), 1e-3, RADIUS, *ROSTERS[roster])
    perm = bl.perm_for(shape, "cpu")
    bins = bins_g.reshape(-1)[perm.long()]
    unpred = g.reshape(-1)[perm.long()][bins == 0]
    for name, a, b in zip(("bins", "selection", "reg_bins", "ql_unpred", "qi_unpred", "unpred"),
                          (bins.numpy(), sel, regb, qlu, qiu, unpred.numpy()), want):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b)), name


# ---- decodes -----------------------------------------------------------------------

@pytest.mark.parametrize("roster", DECODE_ROSTERS, ids=DECODE_ROSTERS.keys())
@pytest.mark.parametrize("shape", SHAPES[:2], ids=SHAPE_IDS[:2])
def test_decode_matches_engine_and_jax(roster, shape):
    """Engine-written payloads of every roster, second-order Lorenzo
    included, decode bit-equal to the engine and to the JAX package's
    decode_blocks_wavefront."""
    x = _field(shape, seed=_seed(roster, shape) + 2)
    conf = _conf(P, shape, eb=1e-2, roster=DECODE_ROSTERS[roster])
    payload = prt.compress_payload(conf, x, 2 * x.nbytes + 4096)
    assert conf.cmprAlgo == P.ALGO.LORENZO_REG
    host = prt.decompress_payload(conf.copy(), payload)
    got = decompress_payload_torch(conf.copy(), payload, None, torch.device("cpu"))
    assert np.array_equal(_bits(host.reshape(shape)), _bits(got.numpy()))
    jconf = J.Config.load(conf.save())[0]
    streams = jrt.blockwise_open(jconf, payload)
    want = jwf.decode_blocks_wavefront(shape, 1e-2, RADIUS, *DECODE_ROSTERS[roster], *streams)
    assert np.array_equal(_bits(want), _bits(got.numpy()))


_MANIFEST = json.loads((GOLDEN / "manifest.json").read_text())
_LORENZO = [c for c in _MANIFEST if "LORENZO_REG" in (c["ini"] or "")]


@pytest.mark.parametrize("case", _LORENZO, ids=[c["name"] for c in _LORENZO])
def test_golden_lorenzo_archives(case, monkeypatch):
    """Reference-binary archives decode on the device route to their
    recorded hash."""
    called = []
    decode = device_decode.decode_payload_device_blockwise
    monkeypatch.setattr(device_decode, "decode_payload_device_blockwise",
                        lambda *a, **k: called.append(1) or decode(*a, **k))
    ref = (GOLDEN / f"{case['name']}.sz").read_bytes()
    out, conf = szp.decompress(ref, device="cpu", dtype=np.float32)
    assert conf.cmprAlgo == P.ALGO.LORENZO_REG and called
    assert hashlib.sha256(out.numpy().tobytes()).hexdigest() == case["out_sha"]


def test_decode_rejects_a_literal_count_that_differs():
    x = _field((18, 18, 18), seed=5)
    conf = _conf(P, x.shape, eb=1e-2)
    payload = prt.compress_payload(conf, x, 2 * x.nbytes + 4096)
    assert conf.cmprAlgo == P.ALGO.LORENZO_REG
    real = prt.blockwise_open_packed
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(prt, "blockwise_open_packed",
                   lambda c, p: (*real(c, p)[:10], np.append(real(c, p)[10], np.float32(1))))
        with pytest.raises(ValueError, match="literal stream length"):
            device_decode.decode_payload_device_blockwise(conf.copy(), payload,
                                                          torch.device("cpu"))


# ---- the modules against the JAX package's pieces ---------------------------------

@pytest.mark.parametrize("shape", SHAPES + [(1 + 6, 2 + 12, 13)], ids=SHAPE_IDS + ["7x14x13"])
def test_layout_matches_jax(shape):
    """Block extents, the regression-valid blocks, the element masks and the
    block-major stream order equal the JAX package's."""
    geo = bl.geometry(shape)
    nb = tuple(geo.nb)
    assert geo.nb == tuple(-(-d // jbd.BS) for d in shape)
    assert np.array_equal(bl.reg_valid(geo, "cpu").reshape(-1).numpy(),
                          jbd._reg_valid_static(shape, nb))
    masks = bl.element_masks(geo, "cpu").numpy()
    assert np.array_equal(masks, jbd._element_masks(shape, nb))
    x = _field(shape, seed=9)
    grid = np.zeros(geo.grid, np.float32)
    grid[:shape[0], :shape[1], :shape[2]] = x
    stream = torch.from_numpy(grid).reshape(-1)[bl.perm_for(shape, "cpu").long()].numpy()
    want = np.concatenate([jbd._block_vals(x, nb, i)[masks[i]] for i in range(geo.nblk)])
    assert np.array_equal(_bits(stream), _bits(want))
    back = stream_order.from_stream(torch.from_numpy(stream), bl.perm_for(shape, "cpu"),
                                    geo.ncells)
    assert torch.equal(back.reshape(geo.grid), torch.from_numpy(grid))


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_fits_and_select_match_jax(shape):
    """The least-squares fits bit-equal to _fits, and the selection equal to
    _jit_select's, with taps that differ from the originals."""
    geo = bl.geometry(shape)
    x = _field(shape, seed=_seed("fits", shape))
    g = torch.zeros(geo.grid)
    g[:shape[0], :shape[1], :shape[2]] = torch.from_numpy(x)
    ex = bl.extents(geo, "cpu")
    inside = bl.valid_cells(geo, "cpu")
    raw = wfe.fits(bl.to_blocks(g, geo).t().contiguous(), bl.to_blocks(inside, geo).t().contiguous(),
                   ex.reshape(3, -1))
    want = np.asarray(jwfe._fits(jwfe._grid_to_blocks(g.numpy(), geo.nb).T.copy(),
                                 ex.reshape(3, -1).numpy()))
    assert np.array_equal(_bits(raw.numpy()), _bits(want))
    rng = np.random.default_rng(1)
    orig_p = wf.padded_grid(geo, g)
    tap_p = wf.padded_grid(geo, g + torch.from_numpy(
        rng.uniform(-2e-3, 2e-3, geo.grid).astype(np.float32)))
    coefs = raw.reshape(4, *geo.nb)
    is_reg, ok = wfe.select(geo, orig_p, tap_p, ex, coefs, 1e-3)
    want = np.asarray(jwfe._jit_select(shape, 1e-3)(
        orig_p.numpy(), tap_p.numpy(), ex.numpy(), ex.min(dim=0).values.numpy(), coefs.numpy()))
    assert np.array_equal(is_reg.numpy(), want) and bool(ok.all())


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_select_takes_the_plain_route_on_the_cpu(shape):
    """On CPU tensors select is select_plain, with no launch counted, and
    every lorenzo.select span of an encode names the plain route."""
    geo = bl.geometry(shape)
    x = _field(shape, seed=_seed("route", shape))
    g = torch.zeros(geo.grid)
    g[:shape[0], :shape[1], :shape[2]] = torch.from_numpy(x)
    ex = bl.extents(geo, "cpu")
    raw = wfe.fits(bl.to_blocks(g, geo).t().contiguous(),
                   bl.to_blocks(bl.valid_cells(geo, "cpu"), geo).t().contiguous(), ex.reshape(3, -1))
    orig_p = wf.padded_grid(geo, g)
    tap_p = wf.padded_grid(geo, g + torch.from_numpy(np.random.default_rng(2).uniform(
        -2e-3, 2e-3, geo.grid).astype(np.float32)))
    coefs = raw.reshape(4, *geo.nb)
    assert wfe.select_route(orig_p) == "plain"
    before = wfe.select.launches
    got = wfe.select(geo, orig_p, tap_p, ex, coefs, 1e-3)
    want = wfe.select_plain(geo, orig_p, tap_p, ex, coefs, 1e-3)
    assert wfe.select.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    stats = {}
    trace.spans()
    trace.enable()
    try:
        wfe.encode_blocks_wavefront(torch.from_numpy(x), 1e-3, RADIUS, True, False, True, stats)
    finally:
        trace.disable()
        spans = trace.spans()
    routes = [s.attrs["route"] for s in spans if s.name == "lorenzo.select"]
    assert routes == ["plain"] * (stats["passes"] + 1)
    assert wfe.select.launches == before


@pytest.mark.parametrize("roster", DECODE_ROSTERS, ids=DECODE_ROSTERS.keys())
def test_selection_info_matches_jax(roster):
    shape = (20, 19, 17)
    x = _field(shape, seed=_seed(roster, shape) + 3)
    conf = _conf(P, shape, eb=1e-2, roster=DECODE_ROSTERS[roster])
    payload = prt.compress_payload(conf, x, 2 * x.nbytes + 4096)
    assert conf.cmprAlgo == P.ALGO.LORENZO_REG
    _, sel, regb, qlu, qiu, _ = prt.blockwise_open(conf, payload)
    geo = bl.geometry(shape)
    names = wf.roster_of(*DECODE_ROSTERS[roster])
    types, coefs = wf.selection_info(geo, names, sel, regb, qlu, qiu, 1e-2)
    kinds, commit, want_coefs = jwf._selection_info(shape, geo.nb, names, sel, regb, qlu, qiu,
                                                    1e-2)
    kind_type = {"L1": bl.T_L1, "L2": bl.T_L2, "REG": bl.T_KEEP}
    assert np.array_equal(types, [kind_type[k] for k in kinds])
    assert np.array_equal(types == bl.T_KEEP, commit)
    assert np.array_equal(_bits(coefs), _bits(want_coefs))


def _sweep_inputs(gdims, seed):
    rng = np.random.default_rng(seed)
    types = rng.integers(0, 3, gdims).astype(np.uint8)
    bins = rng.integers(1, 2 * RADIUS, gdims).astype(np.int32)
    bins[rng.random(gdims) < 0.05] = 0
    vals = (np.cumsum(rng.standard_normal(gdims), axis=2) * 0.01).astype(np.float32)
    init = np.where(types == bl.T_KEEP, vals + 0.5, 0).astype(np.float32)
    return types, bins, vals, init


@pytest.mark.parametrize("gdims", [(12, 18, 6), (7, 5, 11)], ids=["12x18x6", "7x5x11"])
def test_plain_decode_sweep_matches_jax(gdims):
    """sweep_decode_plain on the unskewed grid == _jit_wavefront on the
    JAX package's skewed slab, bit for bit (random types, bins across the
    quantizer's range, literals, kept cells)."""
    types, bins, lits, init = _sweep_inputs(gdims, seed=sum(gdims))
    tot = jwf.LEAD + sum(gdims) - 2
    s0 = jwf.jit_skew(gdims, tot, jwf.LEAD, 2, "float32", 0.0)(init)
    bins_s = jwf.jit_skew(gdims, tot - jwf.LEAD, 0, 0, "int32", 0)(bins)
    lit_s = jwf.jit_skew(gdims, tot - jwf.LEAD, 0, 0, "float32", 0.0)(lits)
    type_s = jwf.jit_skew(gdims, tot - jwf.LEAD, 0, 0, "uint8", jwf.T_KEEP)(types)
    s = jwf._jit_wavefront(gdims, 1e-3, RADIUS)(s0, bins_s, lit_s, type_s)
    want = np.asarray(jwf._jit_unskew(gdims)(s))
    rec = wf.padded_grid(bl.Geometry(gdims, gdims, gdims), torch.from_numpy(init))
    wf.sweep_decode_plain(rec, torch.from_numpy(types), torch.from_numpy(bins),
                          torch.from_numpy(lits), 1e-3, RADIUS)
    assert np.array_equal(_bits(rec[2:, 2:, 2:].numpy()), _bits(want))
    assert not rec[:2].any() and not rec[:, :2].any() and not rec[:, :, :2].any()


@pytest.mark.parametrize("gdims", [(12, 18, 6), (7, 5, 11)], ids=["12x18x6", "7x5x11"])
def test_plain_encode_sweep_matches_jax(gdims):
    types, _, orig, init = _sweep_inputs(gdims, seed=sum(gdims) + 1)
    tot = jwf.LEAD + sum(gdims) - 2
    s0 = jwf.jit_skew(gdims, tot, jwf.LEAD, 2, "float32", 0.0)(init)
    orig_s = jwf.jit_skew(gdims, tot - jwf.LEAD, 0, 0, "float32", 0.0)(orig)
    type_s = jwf.jit_skew(gdims, tot - jwf.LEAD, 0, 0, "uint8", jwf.T_KEEP)(types)
    s, bins_s = jwfe._jit_wavefront_enc(gdims, 1e-3, RADIUS)(s0, orig_s, type_s)
    want_rec = np.asarray(jwf._jit_unskew(gdims)(s))
    want_bins = jwf._skew_view(np.asarray(bins_s), *gdims).copy()
    rec = wf.padded_grid(bl.Geometry(gdims, gdims, gdims), torch.from_numpy(init))
    bins = wfe.sweep_encode_plain(rec, torch.from_numpy(types), torch.from_numpy(orig), 1e-3,
                                  RADIUS)
    assert np.array_equal(_bits(rec[2:, 2:, 2:].numpy()), _bits(want_rec))
    assert np.array_equal(bins.numpy(), want_bins)
    # the wrapper on CPU tensors is the plain version
    rec2 = wf.padded_grid(bl.Geometry(gdims, gdims, gdims), torch.from_numpy(init))
    assert torch.equal(wfe.sweep_encode(rec2, torch.from_numpy(types), torch.from_numpy(orig),
                                        1e-3, RADIUS), bins)
    assert torch.equal(rec2, rec)


# ---- the sweep's plane-major layout ------------------------------------------------

PLANE_GRIDS = [(1, 1, 1), (6, 6, 6), (5, 7, 3), (6, 30, 12), (66, 6, 126), (126, 66, 6)]
PLANE_IDS = ["x".join(map(str, g)) for g in PLANE_GRIDS]


@pytest.mark.parametrize("grid", PLANE_GRIDS, ids=PLANE_IDS)
def test_plane_layout_holds_each_plane_in_row_order(grid):
    """plane_index is a permutation of the padded cells (the layout is their
    count, not the box of the planes), plane t = x + y + z is the slab
    [below3(t), below3(t + 1)) and holds exactly the cells of that plane, in
    (y, z) order."""
    p, r, q = (g + bl.PAD for g in grid)
    n = wf.plane_cells(grid)
    assert n == p * r * q < (p + r + q - 2) * r * q
    idx = wf.plane_index(grid).reshape(-1)
    assert torch.equal(torch.sort(idx).values, torch.arange(n))
    x, y, z = (a.reshape(-1) for a in torch.meshgrid(
        torch.arange(p), torch.arange(r), torch.arange(q), indexing="ij"))
    at = torch.empty(n, dtype=torch.int64)
    at[idx] = torch.arange(n)                   # the natural cell at each position
    t = (x + y + z)[at]
    starts = wf._below3(torch.arange(p + r + q - 1), p, r, q)
    assert int(starts[0]) == 0 and int(starts[-1]) == n
    slab = torch.searchsorted(starts, torch.arange(n), right=True) - 1
    assert torch.equal(t, slab)
    key = (t * r + y[at]) * q + z[at]
    assert bool((key[1:] > key[:-1]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.uint8],
                         ids=["f32", "i32", "u8"])
@pytest.mark.parametrize("grid", PLANE_GRIDS, ids=PLANE_IDS)
def test_plane_conversions_round_trip(grid, dtype):
    """The plain conversions (the twins of the sweep's convert<true> and
    convert<false>): into the plane-major layout and back is the identity,
    on the padded grid and on the rounded grid (whose pad cells stay zero in
    the layout)."""
    g = torch.Generator().manual_seed(sum(grid))
    padded = tuple(v + bl.PAD for v in grid)
    for shape, is_padded in ((padded, True), (grid, False)):
        nat = torch.randint(1, 250, shape, generator=g).to(dtype)
        pm = wf.to_planes_plain(nat, grid)
        assert pm.shape == (wf.plane_cells(grid),) and pm.dtype == dtype
        assert torch.equal(wf.from_planes_plain(pm, grid, is_padded), nat)
        assert int((pm != 0).sum()) == nat.numel()
    with pytest.raises(ValueError):
        wf.to_planes_plain(torch.zeros((2, 3, 4), dtype=dtype), grid)


def test_jax_device_entropy_route_gives_the_same_archive(monkeypatch):
    """The JAX package's device-entropy LORENZO_REG route (Pallas kernels in
    interpret mode) and the port write the same archive."""
    monkeypatch.setenv("SZT_DEVICE_ENTROPY", "1")
    x = _field((20, 19, 23), seed=13)
    bj = szt.compress(x, _conf(J, x.shape), backend="jax", set_datatype=False)
    bp = szp.compress(x, _conf(P, x.shape), device="cpu", set_datatype=False)
    assert bp == bj == szt.compress(x, _conf(J, x.shape), backend="native", set_datatype=False)


# ---- the configurations the card does not run ---------------------------------------

def _walk_field():
    rng = np.random.default_rng(0)
    return (np.cumsum(np.cumsum(rng.standard_normal(400_000))) * 1e-3).astype(np.float32)


STATIC = {
    "1d_default": (_walk_field, lambda ns: ns.Config(absErrorBound=1e-3)),
    "2d": (lambda: _field((96, 113), seed=21), lambda ns: _conf(ns, (96, 113))),
    "f64_3d": (lambda: _field((20, 19, 17), seed=22).astype(np.float64),
               lambda ns: _conf(ns, (20, 19, 17))),
    "lorenzo2_encode": (lambda: _field((18, 18, 18), seed=23),
                        lambda ns: _conf(ns, (18, 18, 18), roster=(True, True, True))),
}


def _forbid(monkeypatch, names):
    def boom(*a, **k):
        raise AssertionError("a port device function ran on a host-engine route")

    for mod, name in names:
        monkeypatch.setattr(mod, name, boom)


_ENCODE_FNS = [(device_encode, "encode_payload_device_blockwise"),
               (device_encode, "encode_payload_device"), (ted, "hist_and_literals"),
               (ted, "pack_bits")]
_DECODE_FNS = [(device_decode, "decode_payload_device_blockwise"),
               (device_decode, "decode_payload_device")]


@pytest.mark.parametrize("case", STATIC, ids=STATIC.keys())
def test_static_engine_routes(case, monkeypatch):
    """LORENZO_REG calls the card does not take give the engine's bytes and
    round-trip, with no port device function called (the second-order
    Lorenzo roster's decode is the card's, as in the JAX package)."""
    make_x, make_conf = STATIC[case]
    x = make_x()
    bn = szt.compress(x, make_conf(J), backend="native")
    with monkeypatch.context() as mp:
        _forbid(mp, _ENCODE_FNS)
        bp = szp.compress(x, make_conf(P), device="cpu")
    assert bp == bn
    conf = szp.open_archive(bp)[0]
    assert conf.cmprAlgo == P.ALGO.LORENZO_REG
    with monkeypatch.context() as mp:
        if case != "lorenzo2_encode":
            _forbid(mp, _DECODE_FNS)
        out, _ = szp.decompress(bp, device="cpu")
    dn, _ = szt.decompress(bn)
    assert np.array_equal(_bits(np.asarray(dn)), _bits(out.numpy()))
    assert float(np.abs(out.numpy().astype(np.float64) - x).max()) <= 1e-3


def test_block_size_8_rides_the_engine(monkeypatch):
    """blockSize is honoured by the engine (pipeline.hpp:185) and carried in
    the archive's Config tail; the sweep assumes 6, so other sizes go to the
    engine in both directions."""
    def conf8():                # Config.copy() re-derives blockSize from dims
        c = _conf(P, x.shape, eb=1e-2)
        c.blockSize = 8
        return c

    x = _field((30, 31, 32), seed=24)
    cap = 2 * x.nbytes + 4096
    want = prt.compress_payload(conf8(), x, cap)
    _forbid(monkeypatch, _ENCODE_FNS + _DECODE_FNS)
    c = conf8()
    got = compress_payload_torch(c, x, cap, torch.device("cpu"))
    assert got == want and c.blockSize == 8 and c.cmprAlgo == P.ALGO.LORENZO_REG
    assert got != prt.compress_payload(_conf(P, x.shape, eb=1e-2), x, cap)
    blob = szp.pack_archive(c, got)
    out, dconf = szp.decompress(blob, device="cpu")
    assert dconf.blockSize == 8
    assert np.array_equal(_bits(out.numpy()), _bits(prt.decompress_payload(conf8(), got)))
