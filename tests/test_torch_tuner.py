"""The port's INTERP_LORENZO tuner (sz3_tpu_torch/algos/tuner.py): the same
decisions as the JAX package's vectorised tuner and the host engine's
tune_interp on tests/test_tuner.py's field matrix, the same archives through
the default Config, the sampling copied exactly, and the batched trial
passes equal to the one-grid passes block by block. On the CPU, with the
passes' plain PyTorch versions."""

import numpy as np
import pytest
import torch

import sz3_tpu as szt
import sz3_tpu.algos.tuner as jtuner
import sz3_tpu.config as jconfig
import sz3_tpu_torch as szp
from sz3_tpu_torch import runtime
from sz3_tpu_torch.algos import tuner
from sz3_tpu_torch.config import ALGO, EB, Config
from sz3_tpu_torch.ops.interp_fast import (bins_to_grid, build_fast_plan, encode_grid_fast,
                                           stack_plans)

from test_tuner import FIELDS

CPU = torch.device("cpu")
FIELDS_OF = ("cmprAlgo", "interpAlgo", "interpDirection", "interpAlpha", "interpBeta",
             "absErrorBound", "quantbinCnt", "errorBoundMode")


def _int(v):
    return int(v) if hasattr(v, "name") else v


@pytest.mark.parametrize("name", list(FIELDS))
@pytest.mark.parametrize("eb", [1e-2, 1e-4])
def test_decisions_match_the_jax_tuner_and_the_engine(name, eb):
    data = FIELDS[name]
    c_port = Config(dims=data.shape, cmprAlgo=ALGO.INTERP_LORENZO, absErrorBound=eb)
    c_eng = Config(dims=data.shape, cmprAlgo=ALGO.INTERP_LORENZO, absErrorBound=eb)
    c_jax = jconfig.Config(dims=data.shape, cmprAlgo=jconfig.ALGO.INTERP_LORENZO,
                           absErrorBound=eb)
    assert tuner.tune(c_port, data.copy(), CPU)
    assert jtuner.tune(c_jax, data.copy())
    runtime.tune_interp(c_eng, data.copy())
    for f in FIELDS_OF:
        assert _int(getattr(c_port, f)) == _int(getattr(c_eng, f)), f
        assert _int(getattr(c_port, f)) == _int(getattr(c_jax, f)), f


def test_outside_the_profile_returns_false():
    rng = np.random.default_rng(1)
    for data in (rng.standard_normal(5000).astype(np.float32),
                 rng.integers(0, 9, (20, 20, 20)).astype(np.int32)):
        c = Config(dims=data.shape, cmprAlgo=ALGO.INTERP_LORENZO, absErrorBound=1e-3)
        assert not tuner.tune(c, data, CPU)
        assert c.cmprAlgo == ALGO.INTERP_LORENZO


@pytest.mark.parametrize("mode", [EB.ABS, EB.REL])
@pytest.mark.parametrize("name", ["smooth3d", "wave3d", "smooth2d"])
def test_default_archives_unchanged(name, mode, monkeypatch):
    """The default Config's archive through szp.compress, with the device
    tuner on the main path (the engine's tuner forbidden), equals the host
    engine's."""
    data = FIELDS[name]
    kw = dict(errorBoundMode=mode)
    kw["absErrorBound" if mode == EB.ABS else "relErrorBound"] = 1e-3 if mode == EB.ABS \
        else 1e-4
    want = szt.compress(data, szt.Config(**{k: (szt.EB(int(v)) if k == "errorBoundMode"
                                                else v) for k, v in kw.items()}),
                        backend="native")

    def engine_tuner(*a):
        raise AssertionError("the engine's tuner ran for a float field of 2+ dimensions")

    monkeypatch.setattr(runtime, "tune_interp", engine_tuner)
    assert szp.compress(data, Config(**kw), device="cpu") == want


def test_dispatcher_keeps_the_engines_tuner_for_1d_and_integer_fields(monkeypatch):
    """A 1D float field takes the engine's tuner from the port's dispatcher;
    an integer field goes whole to the engine's dispatcher, which tunes it
    inside, before any device work."""
    seen, whole = [], []
    real_tune, real_compress, real_device = runtime.tune_interp, runtime.compress_payload, \
        tuner.tune
    monkeypatch.setattr(runtime, "tune_interp",
                        lambda c, d: (seen.append(d.dtype), real_tune(c, d)))
    monkeypatch.setattr(runtime, "compress_payload", lambda c, d, *a: (
        whole.append((d.dtype, c.cmprAlgo)), real_compress(c, d, *a))[1])
    monkeypatch.setattr(tuner, "tune",
                        lambda c, d, dev: (seen.append("device"), real_device(c, d, dev))[1])
    rng = np.random.default_rng(2)
    x1 = np.cumsum(rng.standard_normal(6000)).astype(np.float32)
    xi = rng.integers(0, 50, (24, 24, 24)).astype(np.int32)
    for x in (x1, xi):
        blob = szp.compress(x, Config(absErrorBound=1e-3), device="cpu")
        assert blob == szt.compress(x, szt.Config(absErrorBound=1e-3), backend="native")
    assert seen == ["device", np.float32]
    assert whole[-1] == (np.int32, ALGO.INTERP_LORENZO)


def test_chunks_tune_on_the_device(monkeypatch):
    """An OpenMP-format archive tunes each chunk through the dispatcher."""
    calls = []
    real = tuner.tune
    monkeypatch.setattr(tuner, "tune",
                        lambda c, d, dev: (calls.append(d.shape), real(c, d, dev))[1])
    data = FIELDS["smooth3d"]
    blob = szp.compress(data, Config(absErrorBound=1e-3, openmp=True), device="cpu",
                        nthreads=3)
    assert blob == szt.compress(data, szt.Config(absErrorBound=1e-3, openmp=True),
                                backend="native", nthreads=3)
    assert calls == [(20, 50, 40)] * 3


def test_profiling_range_arithmetic_matches_scalar_walk():
    """The block range is a T-typed subtraction promoted to double, and
    non-origin NaNs are passed over (an origin NaN keeps the block out)."""
    bs, stride = 4, 4
    mn = np.float32(2.0 ** -26)
    mx = np.float32(1.0)
    abseb = 1.0 - 2.0 ** -27
    assert float(mx) - float(mn) <= abseb < float(np.float32(mx - mn))
    data = np.full((8, 8), mn, np.float32)
    data[0, 4] = mx
    starts = tuner._profiling_starts(data, bs, abseb, stride)
    assert starts.shape[0] == 1 and tuple(starts[0]) == (0, 0)
    data2 = np.full((8, 8), 0.0, np.float32)
    data2[0, 4] = 5.0
    data2[4, 0] = np.nan
    assert tuner._profiling_starts(data2, bs, 1.0, stride).shape[0] == 1
    data3 = np.full((8, 8), 0.0, np.float32)
    data3[0, 0] = np.nan
    data3[0, 4] = 5.0
    assert tuner._profiling_starts(data3, bs, 1.0, stride).shape[0] == 0


@pytest.mark.parametrize("shape,sbs", [((70, 66, 65), 16), ((300, 257), 128), ((40, 40, 40), 8),
                                       ((17, 33), 16)])
@pytest.mark.parametrize("profiling", [True, False])
def test_sampling_equals_the_jax_copy(shape, sbs, profiling):
    rng = np.random.default_rng(len(shape) + sbs)
    data = np.cumsum(rng.standard_normal(shape), axis=0).astype(np.float32)
    data.reshape(-1)[::53] = np.nan
    for abseb in (1e-3, 5.0):
        s_p = tuner._profiling_starts(data, sbs, abseb, sbs // 4)
        s_j = jtuner._profiling_starts(data, sbs, abseb, sbs // 4)
        assert np.array_equal(s_p, s_j)
        b_p = tuner._sample_blocks(data, sbs, 0.005, profiling, s_p)
        b_j = jtuner._sample_blocks(data, sbs, 0.005, profiling, s_j)
        assert b_p.shape == b_j.shape and b_p.tobytes() == b_j.tobytes()


def _blocks(k, edge, n, dtype, seed):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((k,) + (edge,) * n), axis=1) * 0.1
    x.reshape(-1)[::41] *= 50.0
    return x.astype(dtype)


_PASS_CASES = [(n, edge, anchor, algo, direction)
               for n, edge, anchor in ((3, 17, 32), (3, 33, 32), (2, 33, 128), (2, 129, 128),
                                       (3, 9, 4))
               for algo, direction in ((0, 0), (1, 0), (0, 5 if n == 3 else 1), (1, 1))]


@pytest.mark.parametrize("n,edge,anchor,algo,direction", _PASS_CASES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_batched_passes_equal_one_grid_at_a_time(n, edge, anchor, algo, direction, dtype):
    blocks = torch.from_numpy(_blocks(3, edge, n, dtype, seed=edge + algo + direction))
    plan = build_fast_plan((edge,) * n, interp_algo=algo, direction=direction,
                           anchor_stride=anchor, alpha=1.25, beta=2.0, eb=1e-2,
                           quantbin_cnt=65536)
    bl, b0, rec = encode_grid_fast(blocks, plan, lead=1)
    grid = bins_to_grid(bl, plan, b0, CPU, batch=(3,))
    for k in range(3):
        bk, b0k, reck = encode_grid_fast(blocks[k], plan)
        assert torch.equal(grid[k], bins_to_grid(bk, plan, b0k, CPU))
        assert torch.equal(rec[k], reck)


_STAGES = {"linear and cubic": [(0, 0, 1.25, 2.0), (1, 0, 1.25, 2.0)],
           "alpha and beta": [(1, 5, 1.0, 1.0), (1, 5, 1.5, 2.5), (1, 5, 2.0, 3.0)],
           "alpha and beta, linear": [(0, 0, 1.0, 1.0), (0, 0, 1.5, 2.5), (0, 0, 2.0, 3.0)]}


@pytest.mark.parametrize("stage", list(_STAGES))
@pytest.mark.parametrize("n,edge,anchor", [(3, 17, 32), (3, 9, 4), (2, 33, 128)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stacked_trials_equal_one_trial_at_a_time(stage, n, edge, anchor, dtype):
    """A stage's trials stacked into one batch of passes give each trial's
    bins and reconstruction of the unstacked batch, and each trial's stream
    and literals."""
    trials = [(a, d if n == 3 else min(d, 1), al, be) for a, d, al, be in _STAGES[stage]]
    blocks = torch.from_numpy(_blocks(3, edge, n, dtype, seed=edge + len(trials)))
    plans = [build_fast_plan((edge,) * n, interp_algo=a, direction=d, anchor_stride=anchor,
                             alpha=al, beta=be, eb=1e-2, quantbin_cnt=65536)
             for a, d, al, be in trials]
    plan = stack_plans(plans)
    batch = (len(trials), 3)
    bl, b0, rec = encode_grid_fast(blocks.expand(batch + blocks.shape[1:]), plan, lead=2)
    grid = bins_to_grid(bl, plan, b0, CPU, batch=batch)
    for i, p in enumerate(plans):
        one, b0i, reci = encode_grid_fast(blocks, p, lead=1)
        assert torch.equal(grid[i], bins_to_grid(one, p, b0i, CPU, batch=(3,)))
        assert torch.equal(rec[i], reci)
    conf = Config(dims=(64,) * n, absErrorBound=1e-2)
    conf.interpAnchorStride = anchor
    ts = [tuner._trial_conf(conf, edge, *t) for t in trials]
    for t, got in zip(ts, tuner.trial_streams(blocks, ts)):
        (want_s, want_u), = tuner.trial_streams(blocks, [t])
        assert torch.equal(got[0], want_s) and got[1].numpy().tobytes() == want_u.numpy().tobytes()


def test_stacked_plans_must_share_their_passes():
    kw = dict(anchor_stride=32, alpha=1.25, beta=2.0, eb=1e-2, quantbin_cnt=65536)
    with pytest.raises(ValueError):
        stack_plans([build_fast_plan((17,) * 3, interp_algo=0, direction=0, **kw),
                     build_fast_plan((17,) * 3, interp_algo=0, direction=5, **kw)])


@pytest.mark.parametrize("n,edge", [(3, 33), (3, 17), (2, 129)])
def test_trial_streams_equal_the_engines_emit_block_by_block(n, edge):
    blocks = _blocks(4, edge, n, np.float32, seed=n * edge)
    conf = Config(dims=(64,) * n, absErrorBound=1e-2)
    tuner._default_anchor_stride(conf)
    for algo, direction in ((0, 0), (1, 1)):
        t = tuner._trial_conf(conf, edge, algo, direction, 1.5, 2.5)
        (stream, unpred), = tuner.trial_streams(torch.from_numpy(blocks), [t])
        perm = runtime.interp_order(t)
        plan = build_fast_plan((edge,) * n, interp_algo=algo, direction=direction,
                               anchor_stride=t.interpAnchorStride, alpha=1.5, beta=2.5,
                               eb=1e-2, quantbin_cnt=t.quantbinCnt)
        want_s, want_u = [], []
        for blk in blocks:
            bl, b0, _ = encode_grid_fast(torch.from_numpy(blk), plan)
            g = bins_to_grid(bl, plan, b0, CPU).numpy()
            s, u = runtime.perm_emit(perm, g.ravel(), np.ascontiguousarray(blk).ravel())
            want_s.append(s)
            want_u.append(u)
        assert np.array_equal(stream.numpy(), np.concatenate(want_s))
        assert np.concatenate(want_u).tobytes() == unpred.numpy().tobytes()
        sealed = runtime.interp_seal(t, stream.numpy(), unpred.numpy(), 1 << 30)
        assert sealed == runtime.interp_seal(t, np.concatenate(want_s), np.concatenate(want_u),
                                             1 << 30)
