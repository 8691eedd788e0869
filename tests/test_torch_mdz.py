"""The port's MDZ pipeline (sz3_tpu_torch.mdz, algos/mdz_torch.py,
ops/mdz_device.py) against the JAX package's (sz3_tpu.mdz with
backend="jax") and the host engine's (backend="native"), on the CPU with the
plain versions of the frame recurrence. Archives must be byte-equal and
decodes bit-equal, in both directions; the device pieces are held bit for
bit to sz3_tpu/ops/mdz_device.py's. Where XLA on the CPU flushes subnormal
floats, the port is held to the engine alone."""

import numpy as np
import pytest
import torch

import sz3_tpu.ops.mdz_device as jmd
from sz3_tpu.mdz import mdz_compress as j_compress
from sz3_tpu.mdz import mdz_decompress as j_decompress
from sz3_tpu_torch import mdz as pmdz
from sz3_tpu_torch.algos import mdz_torch
from sz3_tpu_torch.ops import mdz_device as pmd

from test_mdz import lattice_traj



def _port(data, **kw):
    return pmdz.mdz_compress(data, device="cpu", **kw)


def _decode(blob):
    return pmdz.mdz_decompress(blob, device="cpu").numpy()


def _three_way(data, jax=True, **kw):
    """The engine's archive, equal to the port's (and the JAX package's);
    each side decodes the other's archive bit-equal."""
    host = j_compress(data, backend="native", **kw)
    port = _port(data, **kw)
    assert port == host, (len(port), len(host))
    if jax:
        assert j_compress(data, backend="jax", **kw) == host
    ref = j_decompress(host, backend="native")
    out = _decode(host)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert out.tobytes() == ref.tobytes()
    assert j_decompress(port, backend="native").tobytes() == ref.tobytes()
    if jax:
        assert j_decompress(host, backend="jax").tobytes() == ref.tobytes()
    return host, out


def _bound(data, kw):
    if "abs_eb" in kw:
        return kw["abs_eb"]
    return kw["rel_eb"] * float(data.max() - data.min()) * 1.0000001


@pytest.mark.parametrize("method", ["VQ", "VQT", "MT", "LR", "TS"])
def test_pinned_methods(method):
    data = lattice_traj(frames=120, atoms=700, seed=3)
    _, out = _three_way(data, rel_eb=1e-3, method=method)
    assert np.abs(out - data).max() <= _bound(data, dict(rel_eb=1e-3))


@pytest.mark.parametrize("kw", [dict(rel_eb=1e-3), dict(abs_eb=2e-3)])
def test_adaptive_with_batches(kw):
    data = lattice_traj(frames=260, atoms=500, seed=9)
    blob, out = _three_way(data, batch_size=40, **kw)
    assert np.abs(out.astype(np.float64) - data).max() <= _bound(data, kw)


def test_smooth_data_selects_mt_or_lr():
    rng = np.random.default_rng(4)
    data = np.cumsum(rng.normal(0, 0.01, (80, 600)), axis=0).astype(np.float32)
    _three_way(data, rel_eb=1e-3)


@pytest.mark.parametrize("method", ["ADP", "VQT", "MT"])
def test_3d_per_axis(method):
    rng = np.random.default_rng(5)
    levels = rng.integers(0, 10, (300, 3)) * 1.2
    data = (levels[None] + rng.normal(0, 0.04, (60, 300, 3))).astype(np.float32)
    blob, out = _three_way(data, rel_eb=1e-3, batch_size=25, method=method)
    assert blob[:4] == b"MDZ3" and out.shape == data.shape


def test_1d():
    _three_way(lattice_traj(frames=1, atoms=4000, seed=7)[0], rel_eb=1e-3)


@pytest.mark.parametrize("method", ["ADP", "VQT", "MT"])
def test_single_frame_batches(method):
    _three_way(lattice_traj(frames=6, atoms=300, seed=11), rel_eb=1e-3, batch_size=1,
               method=method)


def test_constant_batch_zero_range():
    data = lattice_traj(frames=60, atoms=200, seed=13)
    data[30:] = 2.5
    _three_way(data, rel_eb=1e-3, batch_size=30)


@pytest.mark.parametrize("quantbin", [4096, 64])
def test_quantbin_override(quantbin):
    _three_way(lattice_traj(frames=50, atoms=400, seed=2), abs_eb=5e-4, quantbin=quantbin)


@pytest.mark.parametrize("quantbin", [0, 1, 3, -7])
def test_quantbin_without_bins(quantbin):
    """A quantbin under 2 makes every cell a literal, as in the engine; an
    odd or negative one halves towards zero as C++ does."""
    data = lattice_traj(frames=12, atoms=150, seed=6)
    for method in ("VQ", "VQT", "MT"):
        _three_way(data, rel_eb=1e-3, method=method, quantbin=quantbin, jax=False)


def test_tensor_input_and_device_output():
    data = lattice_traj(frames=30, atoms=200, seed=21)
    blob = _port(torch.from_numpy(data), rel_eb=1e-3)
    assert blob == j_compress(data, backend="native", rel_eb=1e-3)
    out = pmdz.mdz_decompress(blob, device="cpu")
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"


def _forbid_device(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("device work on an engine route")

    for name in ("mdz_compress_torch", "mdz_decompress_torch"):
        monkeypatch.setattr(mdz_torch, name, boom)
    for name in ("exaalt_encode", "mt_encode", "exaalt_decode", "mt_decode"):
        monkeypatch.setattr(pmd, name, boom)


def test_f64_takes_the_engine_route(monkeypatch):
    data = lattice_traj(frames=20, atoms=100, seed=1, dtype=np.float64)
    host = j_compress(data, backend="native", rel_eb=1e-3)
    _forbid_device(monkeypatch)
    assert _port(data, rel_eb=1e-3) == host
    out = _decode(host)
    assert out.dtype == np.float64
    assert out.tobytes() == j_decompress(host, backend="native").tobytes()


def test_more_than_3d_raises_as_the_engine(monkeypatch):
    _forbid_device(monkeypatch)
    with pytest.raises(ValueError, match="1D-3D"):
        _port(np.zeros((2, 2, 2, 2), np.float32), rel_eb=1e-3)
    with pytest.raises(TypeError, match="float32/float64"):
        _port(np.zeros((4, 8), np.int32), rel_eb=1e-3)


def test_every_trial_failing_raises_the_engines_error():
    """Bins spread so wide that every trial's stream outgrows its capacity:
    the engine's selection falls back to method 0 and its run raises, with
    no level grid; the port raises the same error (the JAX package hands
    the call to the engine)."""
    rng = np.random.default_rng(0)
    data = rng.uniform(-1e5, 1e5, size=(30, 64)).astype(np.float32)
    kw = dict(abs_eb=1.0, quantbin=1 << 22)
    with pytest.raises(RuntimeError) as host:
        j_compress(data, backend="native", **kw)
    with pytest.raises(RuntimeError) as port:
        _port(data, **kw)
    assert str(port.value) == str(host.value)
    assert "no level grid" in str(port.value)
    with pytest.raises(RuntimeError) as pinned:
        _port(data, method="MT", **kw)
    assert str(pinned.value) == "mdz_compress: compressed buffer too small"


def test_no_level_grid_for_pinned_vq_raises_as_the_engine():
    rng = np.random.default_rng(3)
    data = rng.normal(size=(30, 64)).astype(np.float32)
    with pytest.raises(RuntimeError) as host:
        j_compress(data, backend="native", rel_eb=1e-3, method="VQ")
    with pytest.raises(RuntimeError) as port:
        _port(data, rel_eb=1e-3, method="VQ")
    assert str(port.value) == str(host.value)


def _specials(data, wild):
    """Subnormal and large values in frames 1.. (frame 0 keeps the level grid
    that VQ needs); with `wild`, NaN, Inf and values past int32 levels too.
    Those make the engine's VQ Huffman tree span 2^32 level symbols, so only
    methods that level no frame but the clean first take them."""
    flat = data[1:].reshape(-1)
    flat[5::97] = np.float32(3e-39)            # subnormal
    flat[7::131] = -np.float32(1e-41)
    flat[11::139] = np.float32(2.0 ** 40 if wild else 1e5)
    if wild:
        flat[13::149] = np.nan
        flat[17::151] = np.inf
        flat[19::157] = -np.inf
    return data


@pytest.mark.parametrize("method,batch,wild", [("VQT", 0, True), ("MT", 0, True),
                                               ("MT", 20, True), ("ADP", 20, False),
                                               ("VQ", 20, False)])
@pytest.mark.parametrize("kw", [dict(abs_eb=1e-3), dict(rel_eb=1e-3)])
def test_specials_held_to_the_engine(method, batch, wild, kw):
    """NaN, Inf, subnormal and huge values against the engine (XLA on the
    CPU flushes subnormals): literals, the batch range that passes over
    NaNs, and an infinite REL bound, under which the engine's int64 cast
    keeps +Inf data at bin radius."""
    data = _specials(lattice_traj(frames=40, atoms=300, seed=8), wild)
    _three_way(data, method=method, batch_size=batch, jax=False, **kw)


def test_nan_first_value_sets_the_batch_range():
    data = lattice_traj(frames=20, atoms=100, seed=12)
    data[0, 0] = np.nan
    _three_way(data, rel_eb=1e-3, jax=False)


# ---- the device pieces against sz3_tpu/ops/mdz_device.py --------------------------

def _frames(frames, atoms, seed, specials=False):
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 1, atoms)[None] + np.cumsum(rng.normal(0, 0.01, (frames, atoms)),
                                                   axis=0)).astype(np.float32)
    if specials:
        flat = x.reshape(-1)
        flat[13::149] = np.nan
        flat[17::151] = np.inf
        flat[11::139] = np.float32(2.0 ** 40)
    return x


@pytest.mark.parametrize("frames,atoms", [(2, 1), (9, 33), (64, 500)])
@pytest.mark.parametrize("eb", [1e-3, 1e-1])
def test_frames_encode_and_recover_equal_the_jax_scan(frames, atoms, eb):
    """Bit-equal to _jit_frames_encode / _jit_frames_decode: the bins in the
    archive's (atom, frame) order, the literals, the reconstruction."""
    radius = 512
    x = _frames(frames, atoms, seed=frames + atoms, specials=frames > 8)
    r0 = x[0] + np.float32(eb / 3)
    jb, ju = jmd.frames_encode(x[1:], r0, eb, radius)
    xt, r0t = torch.from_numpy(x), torch.from_numpy(r0)
    pb = pmd.frames_encode(xt[1:].contiguous(), r0t, eb, radius)
    assert pb.shape == (atoms, frames - 1) and torch.equal(pb, torch.from_numpy(jb.T.copy()))
    bins, lits = pmd._rest_encode(xt[1:].contiguous(), r0t, eb, radius)
    assert np.array_equal(lits.numpy().view(np.int32), ju.view(np.int32))
    rec_j = jmd.frames_decode(jb, ju, r0, eb, radius)
    rec_p = pmd._rest_decode(bins, lits, r0t, frames, eb, radius)
    assert rec_p.shape == (frames - 1, atoms)
    assert np.array_equal(rec_p.numpy().view(np.int32), rec_j.view(np.int32))


@pytest.mark.parametrize("method", [0, 1])
def test_exaalt_encode_and_decode_equal_the_jax_pieces(method):
    data = lattice_traj(frames=17, atoms=230, seed=4)
    ls, lo, ln = mdz_torch.mdz_levels(data[0])
    eb, radius = 1e-3, 512
    jq, jp, ju = jmd.exaalt_encode(data, method, eb, radius, ls, lo, ln + jmd.MARGIN)
    pq, pp, pu = pmd.exaalt_encode(torch.from_numpy(data), method, eb, radius, ls, lo,
                                   ln + pmd.MARGIN)
    assert np.array_equal(pq.numpy(), jq) and np.array_equal(pp.numpy(), jp)
    assert np.array_equal(pu.numpy().view(np.int32), ju.view(np.int32))
    jout = jmd.exaalt_decode(jq, jp, ju, method, 17, 230, eb, radius, ls, lo, ln + jmd.MARGIN)
    pout = pmd.exaalt_decode(pq, pp, pu, method, 17, 230, eb, radius, ls, lo, ln + pmd.MARGIN)
    assert np.array_equal(pout.numpy().view(np.int32), jout.view(np.int32))


def test_mt_encode_and_decode_equal_the_jax_pieces():
    data = lattice_traj(frames=11, atoms=190, seed=5)
    ts0 = data[0] + np.float32(1e-4)
    jb, ju = jmd.mt_encode(data, ts0, 1e-3, 512)
    pb, pu = pmd.mt_encode(torch.from_numpy(data), torch.from_numpy(ts0), 1e-3, 512)
    assert np.array_equal(pb.numpy(), jb)
    assert np.array_equal(pu.numpy().view(np.int32), ju.view(np.int32))
    jout = jmd.mt_decode(jb, ju, ts0, 11, 190, 1e-3, 512)
    pout = pmd.mt_decode(pb, pu, torch.from_numpy(ts0), 11, 190, 1e-3, 512)
    assert np.array_equal(pout.numpy().view(np.int32), jout.view(np.int32))


def test_level_index_rounds_half_away_and_casts_as_x86():
    y = torch.tensor([0.5, -0.5, 1.5, -2.5, 0.49999997, 2.0 ** 31, -2.0 ** 31, -2.0 ** 32,
                      float("nan"), float("inf"), -float("inf"), 3.0e9], dtype=torch.float32)
    want = [1, -1, 2, -3, 0, -2 ** 31, -2 ** 31, -2 ** 31, -2 ** 31, -2 ** 31, -2 ** 31,
            -2 ** 31]
    assert pmd._round_half_away(y).tolist() == want


def test_recurrence_wrappers_check_their_arguments():
    x = torch.zeros((4, 6))
    r0 = torch.zeros(6)
    with pytest.raises(ValueError):
        pmd.frames_encode(x.double(), r0, 1e-3, 8)
    with pytest.raises(ValueError):
        pmd.frames_encode(x, torch.zeros(5), 1e-3, 8)
    with pytest.raises(ValueError):
        pmd.frames_recover(torch.zeros((6, 4), dtype=torch.int32), torch.zeros(24),
                           torch.zeros(6, dtype=torch.int32), r0, 1e-3, 8)
    with pytest.raises(ValueError):
        pmd.frames_recover(torch.zeros((6, 4), dtype=torch.int32), torch.zeros((4, 6)),
                           torch.zeros(6, dtype=torch.int64), r0, 1e-3, 8)
    with pytest.raises(ValueError):
        pmd.literal_starts(torch.zeros((6, 4), dtype=torch.int32), 23)
    with pytest.raises(ValueError):
        pmd.frames_encode(x, r0, 1e-3, 1 << 30)


def test_wrappers_use_the_plain_versions_only_on_the_cpu(monkeypatch):
    calls = []
    monkeypatch.setattr(pmd, "mdz_frames", lambda *a, **k: calls.append(1))
    x = torch.from_numpy(_frames(5, 40, seed=2))
    b = pmd.frames_encode(x[1:].contiguous(), x[0].contiguous(), 1e-3, 64)
    n = int((b == 0).sum())
    pmd.frames_recover(b, torch.zeros(n), pmd.literal_starts(b, n), x[0].contiguous(), 1e-3, 64)
    assert calls == []
