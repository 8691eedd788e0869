"""Multi-device OpenMP-format archives on the port
(sz3_tpu_torch.parallel.sharded), on the CPU: ranks spawned with
torch.multiprocessing over a gloo group and a FileStore under tmp_path (the
ranks' code is tests/torch_sharded_worker.py, which imports no jax). Each
rank's bins and bound are held to the JAX package's sharded_encode on a CPU
mesh of the same size, the payloads to its sharded_encode_payload, to the
port's compress_chunked and to the host engine at as many threads, and the
sharded decode to the port's decompress, bit for bit."""

import pickle

import numpy as np
import pytest
import torch

import sz3_tpu.config as J
from sz3_tpu import runtime as jruntime
import sz3_tpu_torch.config as P
from sz3_tpu_torch.parallel import chunked, sharded

import torch_sharded_worker as worker


def _spawn(world, tmp_path):
    import torch.multiprocessing as mp

    mp.spawn(worker.run, args=(world, str(tmp_path / "store"), str(tmp_path)), nprocs=world,
             join=True)
    return [pickle.loads((tmp_path / f"rank{r}.pkl").read_bytes()) for r in range(world)]


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _spawn(2, tmp_path_factory.mktemp("sharded2"))


def _mesh(n):
    import jax
    from sz3_tpu.parallel.sharded import make_mesh

    return make_mesh(jax.devices("cpu")[:n])


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


@pytest.mark.parametrize("name", ["ABS", "REL", "ABS_OR_REL"])
def test_encode_step_matches_the_jax_mesh(two, name):
    """sharded_encode: each rank's bins and first-point bin are the JAX
    mesh's for its chunk, and every rank's bound is the JAX one, bit for bit
    (for REL the global range over both ranks, test_parallel.py:56)."""
    from sz3_tpu.parallel.sharded import sharded_encode

    data, kw = worker.step_cases(2)[name]
    jkw = dict(kw, eb_mode=J.EB(int(kw["eb_mode"])))
    _, bins, b0, eb = sharded_encode(data, _mesh(2), **jkw)
    for r, seen in enumerate(two):
        pb, pb0, peb = seen["step"][name]
        assert np.array_equal(pb, bins[r]) and pb0 == int(b0[r])
        assert peb == eb
    if name == "REL":
        assert eb == 1e-3 * float(data.max() - data.min())


def _engine(data, make, world):
    c = make(J)
    c.set_dims(data.shape)
    return jruntime.compress_payload(c, data, 2 * data.nbytes + 4096, nthreads=world)


def _check_payloads(seen_ranks, world, jax_too):
    for name, (data, make) in worker.payload_cases(world).items():
        payloads = {seen["payload"][name] for seen in seen_ranks}
        assert len(payloads) == 1, f"{name}: ranks returned different payloads"
        payload = payloads.pop()
        assert payload == _engine(data, make, world), name
        assert payload == chunked.compress_chunked(make(P), data, world, torch.device("cpu"))
        if jax_too and name in ("ABS", "REL"):
            from sz3_tpu.parallel.sharded import sharded_encode_payload

            assert payload == sharded_encode_payload(make(J), data, _mesh(world)), name
        # the sharded decode: every rank the whole field, bit-equal to the
        # port's decompress and to the engine
        c = make(P)
        c.set_dims(data.shape)
        want = chunked.decompress_chunked(c, payload, np.float32, torch.device("cpu")).numpy()
        cj = make(J)
        cj.set_dims(data.shape)
        assert np.array_equal(_bits(want), _bits(jruntime.decompress_payload(cj, payload)))
        for seen in seen_ranks:
            assert np.array_equal(_bits(seen["decode"][name]), _bits(want)), name


def test_payloads_match_jax_chunked_and_engine(two):
    """sharded_encode_payload over 2 ranks (chunk heights 10 and 11) at ABS
    and REL: the JAX mesh's payload, compress_chunked's and the engine's;
    with a NaN in the last rank's rows, at the first element, and on a
    constant field (range 0: lossless chunks), compress_chunked's and the
    engine's (the JAX package's numpy range is NaN for any NaN)."""
    _check_payloads(two, 2, jax_too=True)


def test_nan_bound_is_the_engines(two):
    """A NaN in one rank's rows never reaches a reduction: the bound is the
    range of the other values, as the engine resolves it; a NaN first
    element gives NaN, on every rank alike."""
    data = worker.payload_cases(2)["REL, NaN"][0]
    for name, nan in (("REL, NaN", False), ("REL, first NaN", True)):
        for seen in two:
            c, _ = P.Config.load(seen["payload"][name], 4)
            assert np.isnan(c.absErrorBound) == nan
            if not nan:
                assert c.absErrorBound == 1e-3 * float(np.nanmax(data) - np.nanmin(data))


def test_value_errors(two):
    """Fewer rows than ranks, rows not divisible for the step, an algorithm
    other than INTERP, and a decode of non-INTERP chunks raise ValueError
    (sharded.py:187-193, :319-323)."""
    for seen in two:
        for key in ("fewer rows", "not divisible", "not INTERP", "decode NOPRED"):
            assert seen[key] is not None, key


def test_three_ranks_ragged(tmp_path):
    """Three ranks (chunk heights 10, 10 and 11): the same payloads and
    decodes, the ValueErrors, and each rank's step bins."""
    seen = _spawn(3, tmp_path)
    _check_payloads(seen, 3, jax_too=False)
    data, kw = worker.step_cases(3)["REL"]
    from sz3_tpu.parallel.sharded import sharded_encode

    _, bins, b0, eb = sharded_encode(data, _mesh(3), **dict(kw, eb_mode=J.EB.REL))
    for r, s in enumerate(seen):
        assert np.array_equal(s["step"]["REL"][0], bins[r]) and s["step"]["REL"][2] == eb
        assert s["fewer rows"] is not None


def test_dryrun_multichip():
    sharded.dryrun_multichip(2, device="cpu")
