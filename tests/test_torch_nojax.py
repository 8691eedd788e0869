"""The port runs without jax and without the JAX package, as on a machine
that has neither, and never falls back to the CPU when a CUDA device is
asked for."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sz3_tpu_torch as szp
from sz3_tpu_torch import Config

ROOT = Path(__file__).resolve().parents[1]

_ROUNDTRIP = r"""
import sys
sys.modules["jax"] = None        # any import of jax now raises ImportError
sys.modules["sz3_tpu"] = None    # and so does any import of the JAX package
import numpy as np
import sz3_tpu_torch as szp
rng = np.random.default_rng(0)
x = (np.cumsum(rng.standard_normal((40, 36, 33)).astype(np.float32), axis=-1) * 0.1)
blob = szp.compress(x, szp.Config(absErrorBound=1e-3), device="cpu")
out, conf = szp.decompress(blob, device="cpu")
assert float(np.abs(out.numpy() - x).max()) <= 1e-3
x64 = x.astype(np.float64)
blob64 = szp.compress(x64, szp.Config(cmprAlgo=szp.ALGO.INTERP, absErrorBound=1e-3), device="cpu")
out64, _ = szp.decompress(blob64, device="cpu")
assert out64.numpy().dtype == np.float64 and float(np.abs(out64.numpy() - x64).max()) <= 1e-3
blob_lr = szp.compress(x, szp.Config(cmprAlgo=szp.ALGO.LORENZO_REG, absErrorBound=1e-3),
                       device="cpu")
out_lr, conf_lr = szp.decompress(blob_lr, device="cpu")
assert conf_lr.cmprAlgo == szp.ALGO.LORENZO_REG
assert float(np.abs(out_lr.numpy() - x).max()) <= 1e-3
for algo, omp in ((szp.ALGO.NOPRED, False), (szp.ALGO.INTERP_LORENZO, True)):
    b = szp.compress(x, szp.Config(cmprAlgo=algo, absErrorBound=1e-3, openmp=omp),
                     device="cpu", nthreads=3)
    o, c = szp.decompress(b, device="cpu")
    assert c.openmp == omp and float(np.abs(o.numpy() - x).max()) <= 1e-3
g = 40
traj = np.repeat(rng.uniform(-5, 5, (g, 1, 3)), 3, axis=1).reshape(-1, 3)
traj = (traj[None] + np.cumsum(rng.normal(0, 0.01, (12, 3 * g, 3)), axis=0)).astype(np.float32)
for algo in (szp.ALGO.BIOMD, szp.ALGO.BIOMDXTC):
    b = szp.compress(traj, szp.Config(cmprAlgo=algo, absErrorBound=1e-3), device="cpu")
    o, c = szp.decompress(b, device="cpu")
    assert c.cmprAlgo == algo and float(np.abs(o.numpy() - traj).max()) <= 1.2e-3
from sz3_tpu_torch import mdz
lat = (rng.integers(0, 12, 150) * 1.5 + rng.normal(0, 0.05, (30, 150))).astype(np.float32)
for method in ("ADP", "VQT", "MT"):
    mb = mdz.mdz_compress(lat, rel_eb=1e-3, batch_size=10, method=method, device="cpu")
    mo = mdz.mdz_decompress(mb, device="cpu").numpy()
    assert mb == mdz.engine_compress(lat, None, 1e-3, 10, mdz.METHODS[method], 1024)
    assert mo.tobytes() == mdz.engine_decompress(mb).tobytes()
from sz3_tpu_torch import serving
from sz3_tpu_torch.parallel import sharded
st = np.stack([x, x * 2])
bb = serving.compress_batch(st, szp.Config(absErrorBound=1e-3), device="cpu")
assert bb[1] == szp.compress(st[1], szp.Config(cmprAlgo=szp.ALGO.INTERP, absErrorBound=1e-3),
                             device="cpu")
assert tuple(serving.decompress_batch(bb, device="cpu").shape) == st.shape
import os, tempfile
with tempfile.TemporaryDirectory() as td:
    sharded.init_file_group(os.path.join(td, "store"), 0, 1)
    pc = szp.Config(cmprAlgo=szp.ALGO.INTERP, absErrorBound=1e-3, openmp=True)
    pl = sharded.sharded_encode_payload(pc, x, device="cpu")
    po = sharded.sharded_decode_payload(szp.Config(dims=x.shape, openmp=True), pl, device="cpu")
    assert float(np.abs(po.numpy() - x).max()) <= 1e-3
    sharded.dist.destroy_process_group()
from sz3_tpu_torch.algos import tuner
tuned = []
real_tune = tuner.tune
tuner.tune = lambda c, d, dev: tuned.append(d.shape) or real_tune(c, d, dev)
tb = szp.compress(x, szp.Config(absErrorBound=1e-3), device="cpu")
assert tuned == [x.shape] and szp.decompress(tb, device="cpu")[1].cmprAlgo == szp.ALGO.INTERP
assert sys.modules["jax"] is None and sys.modules["sz3_tpu"] is None
assert not [m for m in sys.modules if m.startswith("sz3_tpu.")]
print("ok", len(blob))
"""


def test_roundtrip_without_jax():
    proc = subprocess.run([sys.executable, "-c", _ROUNDTRIP], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok ")


def test_import_leaves_jax_alone_when_installed():
    """Importing the port imports neither jax nor the JAX package, even where
    both are installed, and leaves the environment as it was."""
    code = ("import sys, os; import sz3_tpu_torch; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'sz3_tpu' not in sys.modules, 'sz3_tpu imported'; "
            "assert 'SZT_COMP_CACHE' not in os.environ")
    env = {k: v for k, v in __import__("os").environ.items() if k != "SZT_COMP_CACHE"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr


def test_no_jax_import_in_the_port():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    files = sorted((ROOT / "sz3_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 5
    for f in files:
        assert not pat.search(f.read_text()), f"{f} imports jax"


def test_smoke_names_no_module_of_the_jax_package():
    """Neither chip_smoke.py nor any file of the port imports the JAX
    package; the environment trick that once hid its jax import is gone."""
    pat = re.compile(r"^\s*(import|from)\s+sz3_tpu(\.|\s|$)", re.M)
    files = sorted((ROOT / "sz3_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        text = f.read_text()
        assert not pat.search(text), f"{f} imports sz3_tpu"
        assert "SZT_COMP_CACHE" not in text, f


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x = np.ones((8, 8, 8), np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        szp.compress(x, Config(absErrorBound=1e-3), device="cuda")
    blob = szp.compress(x, Config(absErrorBound=1e-3), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        szp.decompress(blob, device="cuda")
