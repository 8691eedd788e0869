"""The seam between the device and the host on the three Huffman routes
(INTERP, LORENZO_REG, NOPRED), on the CPU: each encode reads its stream and
its literals back through ``utils.copies.to_host`` and seals once through
``device_encode.seal_packed``, each decode starts at
``device_decode.huffman_head``, and the archives and decodes equal the host
engine's. A payload whose symbol count or literal count disagrees raises
the ValueError of its route.
"""

import numpy as np
import pytest
import torch

import sz3_tpu_torch as szp
from sz3_tpu_torch import ALGO, Config, runtime
from sz3_tpu_torch.algos import device_decode as dd
from sz3_tpu_torch.algos import device_encode as de
from sz3_tpu_torch.api import archive_conf, open_archive, pack_archive

ROUTES = {"interp": (ALGO.INTERP, np.float32), "lorenzo": (ALGO.LORENZO_REG, np.float32),
          "nopred_f32": (ALGO.NOPRED, np.float32), "nopred_f64": (ALGO.NOPRED, np.float64)}
# the engine's open a route's decode calls, and the noun of its count check
OPENS = {ALGO.INTERP: ("open_packed", "grid points"),
         ALGO.LORENZO_REG: ("blockwise_open_packed", "grid points"),
         ALGO.NOPRED: ("open_packed", "points")}


def _case(route, shape=(22, 19, 17)):
    """(field, Config) of a route: a smooth field with a spike every 211th
    point, so that every route has literals. LORENZO_REG keeps the default
    roster {L1, REG} and blockSize 6."""
    algo, dtype = ROUTES[route]
    rng = np.random.default_rng(11)
    x = np.cumsum(rng.standard_normal(shape), axis=-1) * 0.05
    x = x.astype(dtype)
    x.reshape(-1)[::211] = 1e5
    eb = 1e-1 if algo == ALGO.NOPRED else 1e-3
    return x, Config(cmprAlgo=algo, absErrorBound=eb)


def _archive(route):
    x, conf = _case(route)
    blob = szp.compress(x, conf.copy(), device="cpu")
    assert open_archive(blob)[0].cmprAlgo == conf.cmprAlgo      # not the lossless fallback
    return x, conf, blob


@pytest.mark.parametrize("route", list(ROUTES))
def test_encode_reads_back_through_the_copies_and_seals_once(route, monkeypatch):
    x, conf = _case(route)
    c, cap = archive_conf(x, conf.copy())
    engine = pack_archive(c, runtime.compress_payload(c, x, cap))
    copied, sealed = [], []
    to_host, seal_packed = de.to_host, de.seal_packed
    monkeypatch.setattr(de, "to_host", lambda t: copied.append(t) or to_host(t))
    monkeypatch.setattr(de, "seal_packed",
                        lambda *a: sealed.append(a[1]) or seal_packed(*a))
    blob = szp.compress(x, conf.copy(), device="cpu")
    assert blob == engine
    packed, = sealed
    stream, literals = copied
    assert packed.bits is stream and packed.unpred is literals     # what the seal takes
    assert stream.dtype == torch.uint8 and stream.numel() == (packed.total_bits + 7) // 8
    assert literals.dtype == torch.from_numpy(x[:0]).dtype and literals.numel() > 0
    assert packed.done is None and packed.num == x.size
    assert packed.seal == {ALGO.INTERP: "interp_seal_packed",
                           ALGO.LORENZO_REG: "blockwise_seal_packed",
                           ALGO.NOPRED: "nopred_seal_packed"}[conf.cmprAlgo]
    assert len(packed.side) == (4 if conf.cmprAlgo == ALGO.LORENZO_REG else 0)


@pytest.mark.parametrize("route", list(ROUTES))
def test_decode_starts_at_the_one_head(route, monkeypatch):
    x, conf, blob = _archive(route)
    heads = []
    head = dd.huffman_head
    monkeypatch.setattr(dd, "huffman_head", lambda *a, **k: heads.append(a[2]) or head(*a, **k))
    out, _ = szp.decompress(blob, device="cpu")
    assert heads == [x.size]
    c, payload = open_archive(blob)
    want = runtime.decompress_payload(c, payload)
    assert out.numpy().dtype == want.dtype and out.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("damage", ["count", "literals"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_damaged_counts_raise(route, damage, monkeypatch):
    x, conf, blob = _archive(route)
    name, points = OPENS[conf.cmprAlgo]
    real = getattr(runtime, name)
    seen = {}

    def damaged(*a, **k):
        out = list(real(*a, **k))
        if damage == "count":
            seen["count"] = out[1]
            out[1] += 1
        else:
            assert out[-1].size > 1
            seen["zeros"] = out[-1].size
            out[-1] = out[-1][:-1]
        return tuple(out)

    monkeypatch.setattr(runtime, name, damaged)
    with pytest.raises(ValueError) as got:
        szp.decompress(blob, device="cpu")
    if damage == "count":
        assert str(got.value) == (f"archived symbol count {seen['count'] + 1} != "
                                  f"{seen['count']} {points}")
    else:
        n = seen["zeros"]
        assert str(got.value) == f"literal stream length {n - 1} != zero bins {n}"
