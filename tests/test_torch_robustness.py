"""Damaged archives on the port (the counterpart of tests/test_robustness.py,
whose contract it holds: "Bit-flipped payloads may decode to garbage or
raise — never crash").

- The defensive checks and the integration matrix of tests/test_robustness.py
  on the port, each held to the JAX package's outcome on the same input.
- One crafted archive per guarded field: the payload's inner buffer
  rewritten with that field out of range, then zstd-packed again through the
  port's engine copy. Each raises.
- The archives that ended the process before these checks (NOPRED flips at
  bytes 103 and 1357, an OpenMP-format flip at byte 344, five BIOMDXTC
  flips), as fixed cases.
- The seeded sweep of sz3_tpu_torch/tools/damage_sweep.py, one test a
  route, each in a subprocess, so that a signal fails that test and not the
  test runner. On the routes the engine's own decode also opens, every array
  the port returns is held bit for bit to the JAX package's
  backend="native" decode of the same damaged archive, which runs in a
  subprocess of its own (the reference engine may abort on some of them).
"""

import json
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import sz3_tpu as szt
import sz3_tpu.config as J
import sz3_tpu_torch as szp
import sz3_tpu_torch.config as P
from sz3_tpu_torch import runtime as prt
from sz3_tpu_torch.api import open_archive, pack_archive
from sz3_tpu_torch.parallel import chunked
from sz3_tpu_torch.tools import damage_sweep as ds

ROOT = Path(__file__).resolve().parents[1]
CASE_SECONDS = 5.0          # the longest a damaged archive's decode may take on the CPU
# the integration matrix's field: tests/test_robustness.py's (40, 44, 48) costs the port's plain
# CPU Huffman decode some 5 s a case; at 32^3 every bound still takes a lossy route
MATRIX_SHAPE = (32, 32, 32)
SWEEP_FLIPS = 30            # a route's flips here (chip_smoke.py's phase 13 takes 60 on the card)


def _native(blob):
    out, _ = szt.decompress(blob, backend="native")
    return out


# ---- tests/test_robustness.py on the port ---------------------------------------------

def _archive(shape=(20, 20, 20)):
    x = ds.field(shape)
    return szp.compress(x, P.Config(absErrorBound=1e-2), device="cpu")


def test_bad_magic():
    bad = b"\x00\x00\x00\x00" + _archive()[4:]
    with pytest.raises(ValueError, match="magic"):
        szp.decompress(bad, device="cpu")
    with pytest.raises(ValueError, match="magic"):
        _native(bad)


def test_bad_version():
    blob = _archive()
    bad = blob[:4] + b"\xff\xff\xff\x00" + blob[8:]
    with pytest.raises(ValueError, match="version"):
        szp.decompress(bad, device="cpu")
    with pytest.raises(ValueError, match="version"):
        _native(bad)


@pytest.mark.parametrize("keep", [0.25, 0.5, 0.9])
def test_truncated_archive(keep):
    blob = _archive()
    cut = blob[:int(len(blob) * keep)]
    with pytest.raises(Exception):
        szp.decompress(cut, device="cpu")
    with pytest.raises(Exception):
        _native(cut)


def test_corrupt_payload_no_crash():
    """tests/test_robustness.py's twenty flips, on the port: each raises or
    decodes to the archive's dims, and where the engine decodes too, to its
    bits."""
    arr = ds.field((24, 24, 24))
    blob = szp.compress(arr, P.Config(absErrorBound=1e-2), device="cpu")
    assert blob == szt.compress(arr, J.Config(dims=arr.shape, absErrorBound=1e-2))
    rng = np.random.default_rng(0)
    for _ in range(20):
        i = int(rng.integers(16, len(blob) - 40))
        bad = ds.flip(blob, i)
        try:
            got = szp.decompress(bad, device="cpu")[0].numpy()
        except Exception:
            continue
        assert got.shape == arr.shape and got.dtype == arr.dtype
        try:
            want = _native(bad)
        except Exception:
            continue
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), i


def test_ndim_limit():
    arr = np.zeros((2, 2, 2, 2, 2), dtype=np.float32)
    with pytest.raises(ValueError, match="4"):
        szp.compress(arr, P.Config(absErrorBound=1e-2), device="cpu")
    with pytest.raises(ValueError, match="4"):
        szt.compress(arr, J.Config(dims=arr.shape, absErrorBound=1e-2))


def _held(x, algo, eb, mult):
    """The port's archive equals the engine's and its decode is bit-equal,
    within eb * mult."""
    blob = szp.compress(x, P.Config(cmprAlgo=P.ALGO[algo], absErrorBound=eb), device="cpu")
    assert blob == szt.compress(x, J.Config(dims=x.shape, cmprAlgo=J.ALGO[algo],
                                            absErrorBound=eb), backend="native")
    out = szp.decompress(blob, device="cpu")[0].numpy()
    assert np.array_equal(out.view(np.uint32), _native(blob).view(np.uint32))
    assert np.abs(out - x).max() <= eb * mult


@pytest.mark.parametrize("eb", [1e-1, 1e-2, 1e-3, 1e-4])
@pytest.mark.parametrize("algo", ["INTERP_LORENZO", "LORENZO_REG", "INTERP", "NOPRED"])
def test_field_algos(algo, eb):
    _held(ds.field(MATRIX_SHAPE), algo, eb, 1.2)


@pytest.mark.parametrize("eb", [1e-1, 1e-2, 1e-3, 1e-4])
@pytest.mark.parametrize("algo,mult", [("BIOMD", 1.2), ("BIOMDXTC", 3.0)])
def test_md_algos(algo, mult, eb):
    rng = np.random.default_rng(7)
    traj = (rng.uniform(-5, 5, (1, 300, 3)) +
            np.cumsum(rng.normal(0, 0.01, (20, 300, 3)), axis=0)).astype(np.float32)
    _held(traj, algo, eb, mult)


@pytest.mark.parametrize("mode,name,value", [("REL", "relErrorBound", 1e-3),
                                             ("PSNR", "psnrErrorBound", 80.0),
                                             ("L2NORM", "l2normErrorBound", 1.0)])
def test_eb_modes_bound_holds(mode, name, value):
    arr = ds.field(MATRIX_SHAPE)
    confs = []
    for cfg in (P, J):
        c = cfg.Config(dims=arr.shape, errorBoundMode=cfg.EB[mode])
        setattr(c, name, value)
        confs.append(c)
    blob = szp.compress(arr, confs[0], device="cpu")
    assert blob == szt.compress(arr, confs[1], backend="native")
    out, used = szp.decompress(blob, device="cpu")
    assert used.errorBoundMode == P.EB.ABS
    assert np.array_equal(out.numpy().view(np.uint32), _native(blob).view(np.uint32))
    assert np.abs(out.numpy() - arr).max() <= used.absErrorBound * 1.2


# ---- crafted archives: one guarded field at a time ------------------------------------

class Inner:
    """A zstd-framed payload's inner buffer, walked field by field as the
    engine's loaders read it (pipeline.hpp open_payload: the decomposition,
    then the bins' Huffman tree, count, byte count and bits)."""

    def __init__(self, raw: bytes):
        self.raw, self.pos, self.at = bytearray(raw), 0, {}

    def take(self, name, fmt):
        self.at[name] = self.pos
        (v,) = struct.unpack_from(fmt, self.raw, self.pos)
        self.pos += struct.calcsize(fmt)
        return v

    def skip(self, name):
        """A byte count, and the bytes it counts."""
        n = self.take(name, "<Q")
        self.pos += n

    def put(self, name, fmt, value):
        struct.pack_into(fmt, self.raw, self.at[name], value)

    def quantizer(self, prefix, width):
        self.take(prefix + "uid", "<B")
        self.take(prefix + "eb", "<d")
        self.take(prefix + "radius", "<i")
        n = self.take(prefix + "unpred", "<Q")
        self.pos += n * width

    def huffman(self, prefix):
        self.take(prefix + "offset", "<i")
        nodes = self.take(prefix + "nodes", ">I")
        self.take(prefix + "states", ">I")
        self.pos += 1
        idx = 1 if nodes <= 256 else 2 if nodes <= 65536 else 4
        self.at[prefix + "L"] = self.pos
        self.pos += nodes * (2 * idx + 4 + 1)

    def bins(self):
        self.huffman("tree.")
        self.take("count", "<Q")
        self.skip("nbytes")


def _inner(blob: bytes) -> Inner:
    _, payload = open_archive(blob)
    return Inner(prt.zstd_decompress(payload))


def _repack(blob: bytes, raw: bytes) -> bytes:
    conf, _ = open_archive(blob)
    return pack_archive(conf, prt.zstd_compress(bytes(raw)))


def _interp_inner(blob):
    """A 3D 4-byte field's INTERP payload: its dims, header and quantizer,
    then the bins."""
    inner = _inner(blob)
    for k in range(3):
        inner.take(f"dim{k}", "<Q")
    for name, fmt in (("blocksize", "<I"), ("interp_id", "<i"), ("direction", "<i"),
                      ("anchor", "<Q"), ("alpha", "<d"), ("beta", "<d")):
        inner.take(name, fmt)
    inner.quantizer("", 4)
    inner.bins()
    return inner


@pytest.fixture(scope="module")
def interp_blob():
    x = ds.field((24, 24, 24))
    return szp.compress(x, P.Config(cmprAlgo=P.ALGO.INTERP, absErrorBound=1e-2), device="cpu")


INTERP_FIELDS = {
    "nbytes": ("<Q", 1 << 40, "truncated"),          # the bits' byte count (bridge.hpp)
    "unpred": ("<Q", 1 << 60, "truncated literals"),  # the literal count (quantizer.hpp)
    "dim0": ("<Q", 25, "dims differ"),                # the payload's dims (interp.hpp)
    "direction": ("<i", 6, "direction"),
    "blocksize": ("<I", 0, "block size"),
    "tree.nodes": (">I", 1 << 31, "node count"),      # the tree's node count (huffman.hpp)
    "count": ("<Q", 24 ** 3 + 1, "symbol count"),     # the symbol count (device_decode.py)
}


@pytest.mark.parametrize("field", sorted(INTERP_FIELDS))
def test_crafted_interp_field_raises(interp_blob, field):
    fmt, value, match = INTERP_FIELDS[field]
    inner = _interp_inner(interp_blob)
    inner.put(field, fmt, value)
    with pytest.raises(Exception, match=match):
        szp.decompress(_repack(interp_blob, inner.raw), device="cpu")


def test_crafted_tree_cycle_raises(interp_blob):
    """A node with two parents (here the root's two children one node) made
    the code table a graph whose walk repeats symbols; a tree whose children
    do not follow their parent, or share one, is refused before any walk."""
    inner = _interp_inner(interp_blob)
    nodes = struct.unpack_from(">I", inner.raw, inner.at["tree.nodes"])[0]
    w = 1 if nodes <= 256 else 2 if nodes <= 65536 else 4
    fmt = "<" + {1: "B", 2: "H", 4: "I"}[w]
    left = struct.unpack_from(fmt, inner.raw, inner.at["tree.L"])[0]
    struct.pack_into(fmt, inner.raw, inner.at["tree.L"] + nodes * w, left)    # R[0] = L[0]
    with pytest.raises(RuntimeError, match="malformed serialized tree"):
        szp.decompress(_repack(interp_blob, inner.raw), device="cpu")


def test_crafted_missing_literals_raise_on_the_engine_route():
    """An INTERP payload whose anchor points have no literals (Queue 3's
    engine crash): an int32 field, which the engine's own decode opens; the
    literal stream emptied."""
    x = np.round(ds.field((24, 24, 24)) * 1000).astype(np.int32)
    blob = szp.compress(x, P.Config(cmprAlgo=P.ALGO.INTERP, absErrorBound=2), device="cpu")
    inner = _interp_inner(blob)
    n = struct.unpack_from("<Q", inner.raw, inner.at["unpred"])[0]
    assert n > 0
    start = inner.at["unpred"] + 8
    del inner.raw[start:start + 4 * n]
    inner.put("unpred", "<Q", 0)
    with pytest.raises(RuntimeError, match="more zero bins than literals"):
        szp.decompress(_repack(blob, inner.raw), device="cpu")


def test_crafted_nopred_byte_count_raises():
    x = ds.field((24, 24, 24))
    blob = szp.compress(x, P.Config(cmprAlgo=P.ALGO.NOPRED, absErrorBound=1e-2), device="cpu")
    inner = _inner(blob)
    inner.quantizer("", 4)
    inner.bins()
    inner.put("nbytes", "<Q", 1 << 40)
    with pytest.raises(RuntimeError, match="truncated"):
        szp.decompress(_repack(blob, inner.raw), device="cpu")


def _blockwise_inner(blob):
    """LORENZO_REG's inner buffer (roster Lorenzo-1 + regression): the
    regression block (its bin count, two quantizers, tree and bits), the
    selection (count, tree and bits), the quantizer, the bins."""
    inner = _inner(blob)
    if inner.take("reg.count", "<Q"):
        inner.quantizer("qi.", 4)
        inner.quantizer("ql.", 4)
        inner.huffman("reg.tree.")
        inner.skip("reg.bytes")
    if inner.take("sel.count", "<Q"):
        inner.huffman("sel.tree.")
        inner.skip("sel.bytes")
    inner.quantizer("", 4)
    inner.bins()
    return inner


@pytest.fixture(scope="module")
def blockwise_blob():
    x = ds.field((24, 24, 24))
    return szp.compress(x, P.Config(cmprAlgo=P.ALGO.LORENZO_REG, absErrorBound=1e-2),
                        device="cpu")


BLOCKWISE_FIELDS = {
    "reg.count": ("<Q", 1 << 40, "coefficients past the blocks"),
    "sel.count": ("<Q", 1 << 40, "selection past the blocks"),
    "nbytes": ("<Q", 1 << 40, "truncated"),
}


@pytest.mark.parametrize("field", sorted(BLOCKWISE_FIELDS))
def test_crafted_blockwise_field_raises(blockwise_blob, field):
    fmt, value, match = BLOCKWISE_FIELDS[field]
    inner = _blockwise_inner(blockwise_blob)
    inner.put(field, fmt, value)
    with pytest.raises(RuntimeError, match=match):
        szp.decompress(_repack(blockwise_blob, inner.raw), device="cpu")


def test_crafted_block_size_raises(blockwise_blob):
    """A Config tail whose blockSize is 0 sends LORENZO_REG to the engine,
    which refuses it (it divided by it)."""
    conf, payload = open_archive(blockwise_blob)
    conf.blockSize = 0
    with pytest.raises(RuntimeError, match="block size"):
        szp.decompress(pack_archive(conf, payload), device="cpu")


@pytest.fixture(scope="module")
def traj():
    return ds.md_traj()


def test_crafted_biomd_fields_raise(traj):
    blob = szp.compress(traj, P.Config(cmprAlgo=P.ALGO.BIOMD, absErrorBound=1e-3), device="cpu")
    raw = _inner(blob).raw
    # [site i32][first fill u64][fill f32][quantizer][HuffmanV2: flags u8, offset i32,
    # distinct BE u64, maxval BE u64, tree bits][count u64][bits]
    site = bytearray(raw)
    struct.pack_into("<i", site, 0, 11)                   # past the recurrence's site range
    n = struct.unpack_from("<Q", raw, 4 + 8 + 4 + 13)[0]
    hv2 = 4 + 8 + 4 + 13 + 8 + 4 * n
    distinct = bytearray(raw)
    struct.pack_into(">Q", distinct, hv2 + 5, 1 << 40)    # more leaves than tree bits
    for bad, match in ((site, "site"), (distinct, "symbol count")):
        with pytest.raises(Exception, match=match):
            szp.decompress(_repack(blob, bad), device="cpu")


def test_crafted_biomdxtc_count_raises(traj):
    """BIOMDXTC's payload is the XTC stream unframed: a bin count other than
    the live points' is refused before the bins are sized."""
    blob = szp.compress(traj, P.Config(cmprAlgo=P.ALGO.BIOMDXTC, absErrorBound=1e-3),
                        device="cpu")
    conf, payload = open_archive(blob)
    raw = bytearray(payload)
    # [first fill u64][fill f32][quantizer][reminders 2 x i32][count u64][xtc stream]
    n = struct.unpack_from("<Q", raw, 8 + 4 + 13)[0]
    at = 8 + 4 + 21 + 4 * n + 8
    assert struct.unpack_from("<Q", raw, at)[0] == traj.size
    struct.pack_into("<Q", raw, at, traj.size + 3)
    with pytest.raises(RuntimeError, match="archived bin count"):
        szp.decompress(pack_archive(conf, bytes(raw)), device="cpu")


def test_crafted_chunk_dims_raise():
    x = ds.field((24, 24, 24))
    blob = szp.compress(x, P.Config(absErrorBound=1e-2, openmp=True), device="cpu", nthreads=3)
    conf, payload = open_archive(blob)
    n = struct.unpack_from("<i", payload, 0)[0]
    pos, confs = 4, []
    for _ in range(n):
        c, used = P.Config.load(payload, pos)
        confs.append(c)
        pos += used
    sizes = struct.unpack_from(f"<{n}Q", payload, pos)
    pos += 8 * n
    streams = []
    for s in sizes:
        streams.append(payload[pos:pos + s])
        pos += s
    confs[1].set_dims((9, 24, 24))                     # chunk 1 holds 8 rows
    with pytest.raises(ValueError, match="do not hold"):
        szp.decompress(pack_archive(conf, chunked.assemble(list(zip(confs, streams)))),
                       device="cpu")


def test_crafted_mdz_fields_raise():
    from sz3_tpu_torch.mdz import mdz_compress, mdz_decompress

    x = ds.md_traj(frames=24)
    blob = bytearray(mdz_compress(x, abs_eb=1e-3, device="cpu"))
    assert blob[:4] == b"MDZ3"
    series = 5 + 24 + 8                   # the first series: "MDZ1", dtype, rank, dims...
    rank = bytearray(blob)
    rank[series + 5] = 200
    dims = bytearray(blob)
    struct.pack_into("<Q", dims, series + 6, 25)
    frames = bytearray(blob)
    struct.pack_into("<Q", frames, 5, 1 << 40)
    for bad, match in ((rank, "rank"), (dims, "dims"), (frames, "dims")):
        with pytest.raises(ValueError, match=match):
            mdz_decompress(bytes(bad), device="cpu")


# ---- the seeded sweep, one subprocess a route ------------------------------------------

def _run(cmd, timeout):
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=ROOT)
    recs = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    return proc, recs


def _sweep(route, tmp_path, flips):
    """The port's sweep of `route` in a subprocess: its records, and the
    clean archive it wrote."""
    cmd = [sys.executable, "-m", "sz3_tpu_torch.tools.damage_sweep", "--device", "cpu",
           "--flips", str(flips), "--save", str(tmp_path), route]
    proc, recs = _run(cmd, timeout=240)
    started = [r for r in recs if r.get("outcome") == "started"]
    done = [r for r in recs if r.get("outcome") in ("array", "raised")]
    assert proc.returncode >= 0, (
        f"{route}: the sweep ended by signal {-proc.returncode} in case "
        f"{started[-1]['case'] if started else None}\n{proc.stderr[-2000:]}")
    assert len(done) == len(started) and recs and "cases" in recs[-1], proc.stderr[-2000:]
    return done, (tmp_path / f"{route}.bin").read_bytes()


NATIVE = """
import json, sys
import sz3_tpu as szt
from sz3_tpu_torch.tools import damage_sweep as ds
blob = open(sys.argv[1], "rb").read()
labels = json.loads(sys.argv[2])
for label in labels:
    print(json.dumps({"case": label, "outcome": "started"}), flush=True)
    kind, at = label.split("@")
    bad = ds.flip(blob, int(at)) if kind == "flip" else blob[:int(at)]
    try:
        out, _ = szt.decompress(bad, backend="native")
        rec = {"outcome": "array", "shape": list(out.shape), "dtype": str(out.dtype),
               "sha": ds.digest(out)}
    except Exception as e:
        rec = {"outcome": "raised", "error": type(e).__name__}
    rec["case"] = label
    print(json.dumps(rec), flush=True)
"""


def _native_sweep(blob_path, labels):
    """The JAX package's native decode of each case, in subprocesses: a case
    that ends its process is recorded as "ended" and the rest go on in a
    new one."""
    out, todo = {}, list(labels)
    while todo:
        proc, recs = _run([sys.executable, "-c", NATIVE, str(blob_path), json.dumps(todo)],
                          timeout=240)
        for r in recs:
            if r["outcome"] != "started":
                out[r["case"]] = r
        pending = [c for c in todo if c not in out]
        if pending:
            out[pending[0]] = {"case": pending[0], "outcome": "ended",
                               "signal": -proc.returncode}
        todo = pending[1:]
    return out


@pytest.mark.parametrize("route", ds.ROUTES)
def test_sweep_raises_or_decodes(route, tmp_path):
    """Every damaged archive of the route decodes to the archive's dims and
    dtype or raises, within CASE_SECONDS, in a process that ends normally;
    on the engine's routes every array equals the native decode's where that
    decodes too."""
    recs, blob = _sweep(route, tmp_path, flips=SWEEP_FLIPS)
    assert len(recs) == len(ds.KNOWN.get(route, ())) + SWEEP_FLIPS + 3
    bad = [r for r in recs if not r["conforms"] or r["seconds"] > CASE_SECONDS]
    assert bad == []
    assert any(r["outcome"] == "array" for r in recs) and any(
        r["outcome"] == "raised" for r in recs)
    if route not in ds.ENGINE_ROUTES:
        return
    native = _native_sweep(tmp_path / f"{route}.bin", [r["case"] for r in recs])
    both = [(r, native[r["case"]]) for r in recs
            if r["outcome"] == "array" and native[r["case"]]["outcome"] == "array"]
    assert both
    differ = [r["case"] for r, n in both
              if (r["shape"], r["dtype"], r["sha"]) != (n["shape"], n["dtype"], n["sha"])]
    assert differ == []


@pytest.mark.parametrize("route", sorted(ds.KNOWN))
def test_reproductions_raise(route, tmp_path):
    """The flips that ended the process before the decode routes checked
    what they read (damage_sweep.KNOWN) now raise."""
    recs, blob = _sweep(route, tmp_path, flips=0)
    flips = [r for r in recs if r["case"].startswith("flip")]
    assert [r["case"] for r in flips] == [f"flip@{p}" for p in ds.KNOWN[route]]
    assert all(r["outcome"] == "raised" for r in flips), flips
    assert len(blob) == {"nopred": 16481, "openmp": 15578, "biomdxtc": 9648}[route]
