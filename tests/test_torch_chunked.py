"""OpenMP-format (chunked) archives on the port, on the CPU: each chunk
through the port's dispatcher and its device path, one after the other.
Archives are byte-equal to the host engine's threaded path at the same chunk
count (tests/test_parallel.py:70, :80 hold the JAX package to the same), and
decodes bit-equal to the engine's, both ways across the two."""

import struct

import numpy as np
import pytest
import torch

import sz3_tpu as szt
import sz3_tpu.config as J
import sz3_tpu_torch as szp
import sz3_tpu_torch.config as P
from sz3_tpu_torch.ops import entropy_device as ted
from sz3_tpu_torch.parallel import chunked

from test_biomd_device import md_traj


def field(shape, seed=3, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return np.ascontiguousarray(np.cumsum(rng.standard_normal(shape), axis=-1) * 0.1,
                                dtype=dtype)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({4: np.int32, 8: np.int64}[a.dtype.itemsize])


def _chunk_confs(blob):
    """(chunk count, the chunks' Configs) of a chunked archive."""
    _, payload = szp.open_archive(blob)
    n = struct.unpack_from("<i", payload, 0)[0]
    pos, confs = 4, []
    for _ in range(n):
        c, used = P.Config.load(payload, pos)
        confs.append(c)
        pos += used
    return n, confs


def _parity(x, make_conf, nthreads, **kw):
    """Port == engine archive; port and engine decodes of it bit-equal, and
    of each other's archive. Returns the archive."""
    bn = szt.compress(x, make_conf(J), nthreads=nthreads, **kw)
    bp = szp.compress(x, make_conf(P), device="cpu", nthreads=nthreads, **kw)
    assert bp == bn
    dn, cn = szt.decompress(bn)
    dp, cp = szp.decompress(bn, device="cpu")
    assert cp.openmp and cp.save() == cn.save()
    assert tuple(dp.shape) == tuple(np.asarray(dn).shape)
    assert np.array_equal(_bits(np.asarray(dn)), _bits(dp.numpy()))
    return bn


def test_chunked_matches_native_omp(monkeypatch):
    """tests/test_parallel.py:70 on the port: the OpenMP wire format, byte
    for byte, every chunk on the device route."""
    data = field((64, 24, 24))
    seen = []
    real = ted.hist_and_literals
    monkeypatch.setattr(ted, "hist_and_literals", lambda b, r: seen.append(1) or real(b, r))
    blob = _parity(data, lambda ns: ns.Config(dims=data.shape, absErrorBound=1e-3, openmp=True),
                   4, set_datatype=False)
    n, confs = _chunk_confs(blob)
    assert n == 4 and len(seen) == 4
    assert all(c.openmp and c.dims == (16, 24, 24) for c in confs)


def test_chunked_cross_decode():
    """tests/test_parallel.py:80 on the port: an engine archive decodes on
    the port, and the port's archive in the engine, within the bound."""
    data = field((40, 20, 20))
    conf = J.Config(dims=data.shape, absErrorBound=1e-3, openmp=True)
    blob_n = szt.compress(data, conf, nthreads=4)
    out, _ = szp.decompress(blob_n, device="cpu")
    assert np.abs(out.numpy() - data).max() <= 1e-3
    blob_p = szp.compress(data, P.Config(absErrorBound=1e-3, openmp=True), device="cpu",
                          nthreads=4)
    out_n, _ = szt.decompress(blob_p)
    assert np.abs(out_n - data).max() <= 1e-3
    assert np.array_equal(_bits(out_n), _bits(szp.decompress(blob_p, device="cpu")[0].numpy()))


@pytest.mark.parametrize("mode", ["ABS", "REL", "PSNR", "ABS_AND_REL"])
@pytest.mark.parametrize("dims,nthreads", [((52, 12, 10), 8), ((30, 17, 9), 4),
                                            ((5, 40, 41), 4), ((3, 30, 31), 8)])
def test_bounds_and_ragged_chunks(dims, nthreads, mode):
    """Ragged chunks (dims[0] not a multiple of the count), chunks of one row
    (squeezed to 2D), dims[0] < nthreads (fewer chunks), and bounds taken
    from one global range before chunking."""
    data = field(dims, seed=sum(dims))
    data[0, 0, 0] = 50.0                 # the global maximum lives in chunk 0

    def conf(ns):
        c = ns.Config(dims=dims, errorBoundMode=getattr(ns.EB, mode), absErrorBound=1e-2,
                      relErrorBound=1e-3, psnrErrorBound=60.0, openmp=True)
        return c

    blob = _parity(data, conf, nthreads)
    n, confs = _chunk_confs(blob)
    assert n == min(nthreads, dims[0])
    ebs = {c.absErrorBound for c in confs}
    assert len(ebs) == 1 and all(c.errorBoundMode == P.EB.ABS for c in confs)
    heights = [hi - lo for lo, hi in chunked._chunk_bounds(dims[0], n)]
    assert [c.dims[0] if c.N == 3 else 1 for c in confs] == heights


def test_chunk_downgrades_to_lossless_alone():
    """A chunk of noise goes to zstd on its own; the others stay INTERP."""
    data = field((32, 20, 20), seed=8)
    rng = np.random.default_rng(8)
    data[8:16] = rng.standard_normal((8, 20, 20)).astype(np.float32) * 1e3
    blob = _parity(data, lambda ns: ns.Config(cmprAlgo=ns.ALGO.INTERP, absErrorBound=1e-3,
                                              openmp=True), 4)
    _, confs = _chunk_confs(blob)
    algos = [c.cmprAlgo for c in confs]
    assert algos[1] == P.ALGO.LOSSLESS and P.ALGO.INTERP in algos


@pytest.mark.parametrize("algo", ["NOPRED", "LORENZO_REG", "INTERP", "BIOMD", "BIOMDXTC"])
def test_chunked_algorithms(algo):
    """Each algorithm's device route inside the chunks: the chunk's Config
    header carries the chunk's dims and decisions."""
    data = md_traj(frames=24, atoms=120) if algo.startswith("BIOMD") else field((36, 19, 18))
    blob = _parity(data, lambda ns: ns.Config(cmprAlgo=getattr(ns.ALGO, algo), absErrorBound=1e-3,
                                              openmp=True), 3)
    _, confs = _chunk_confs(blob)
    assert all(c.cmprAlgo == getattr(P.ALGO, algo) for c in confs)


def test_double_and_default_thread_count():
    """float64 chunks, and nthreads=0: the machine's CPU count, at most
    dims[0], on both sides."""
    data = field((12, 30, 31), seed=4, dtype=np.float64)
    _parity(data, lambda ns: ns.Config(cmprAlgo=ns.ALGO.INTERP, absErrorBound=1e-4,
                                       openmp=True), 0)


def test_decode_writes_one_tensor(monkeypatch):
    """The decode fills one output tensor, chunk by chunk, through the
    port's own dispatcher."""
    data = field((20, 16, 15), seed=6)
    blob = szt.compress(data, J.Config(absErrorBound=1e-3, openmp=True), nthreads=3)
    calls = []
    real = chunked.decompress_chunked
    monkeypatch.setattr(chunked, "decompress_chunked",
                        lambda *a: calls.append(a[3]) or real(*a))
    out, conf = szp.decompress(blob, device="cpu")
    assert calls == [torch.device("cpu")] and out.is_contiguous()
    assert out.shape == data.shape and out.dtype == torch.float32


def test_bad_chunk_count_raises():
    data = field((10, 16, 15), seed=7)
    blob = bytearray(szt.compress(data, J.Config(absErrorBound=1e-3, openmp=True), nthreads=2))
    struct.pack_into("<i", blob, 16, 11)          # more chunks than rows
    with pytest.raises(ValueError, match="chunk count"):
        szp.decompress(bytes(blob), device="cpu")
