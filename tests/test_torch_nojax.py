"""The port runs without jax, as on a machine that has none, and never
falls back to the CPU when a CUDA device is asked for."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sz3_tpu_torch as szp
from sz3_tpu.config import Config

ROOT = Path(__file__).resolve().parents[1]

_ROUNDTRIP = r"""
import sys
sys.modules["jax"] = None        # any import of jax now raises ImportError
import numpy as np
import sz3_tpu_torch as szp
rng = np.random.default_rng(0)
x = (np.cumsum(rng.standard_normal((40, 36, 33)).astype(np.float32), axis=-1) * 0.1)
blob = szp.compress(x, szp.Config(absErrorBound=1e-3), device="cpu")
out, conf = szp.decompress(blob, device="cpu")
assert float(np.abs(out.numpy() - x).max()) <= 1e-3
assert sys.modules["jax"] is None
print("ok", len(blob))
"""


def test_roundtrip_without_jax():
    proc = subprocess.run([sys.executable, "-c", _ROUNDTRIP], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok ")


def test_import_leaves_jax_alone_when_installed():
    """Importing the port first does not import jax, even where jax is
    installed (sz3_tpu's compile-cache setup is opted out for that import)."""
    code = ("import sys, os; import sz3_tpu_torch; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
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
    """chip_smoke.py reaches the host engine and the container only through
    the port."""
    pat = re.compile(r"^\s*(import|from)\s+sz3_tpu(\.|\s|$)", re.M)
    assert not pat.search((ROOT / "chip_smoke.py").read_text())


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x = np.ones((8, 8, 8), np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        szp.compress(x, Config(absErrorBound=1e-3), device="cuda")
    blob = szp.compress(x, Config(absErrorBound=1e-3), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        szp.decompress(blob, device="cuda")
