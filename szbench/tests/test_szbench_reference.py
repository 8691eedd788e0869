"""The reference's bound conversion and error on small fields."""

import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from szbench.harness import imports
from szbench.reference import errbound

from .conftest import ROOT


def test_rel_bound_takes_the_range_in_the_data_type():
    x = torch.tensor([0.1, 5.9, 2.0, -0.3], dtype=torch.float32)
    rng = float(np.float32(5.9) - np.float32(-0.3))
    assert errbound.abs_bound(x, {"mode": "REL", "rel": 1e-4}) == 1e-4 * rng


def test_other_modes():
    x = torch.linspace(-1, 3, 100)
    assert errbound.abs_bound(x, {"mode": "ABS", "abs": 0.01}) == 0.01
    assert errbound.abs_bound(x, {"mode": "ABS_AND_REL", "abs": 0.01, "rel": 1e-3}) == \
        pytest.approx(4e-3)
    assert errbound.abs_bound(x, {"mode": "ABS_OR_REL", "abs": 0.01, "rel": 1e-3}) == 0.01
    assert errbound.abs_bound(x, {"mode": "L2NORM", "l2norm": 1.0}) == math.sqrt(3 / 100)
    psnr = errbound.abs_bound(x, {"mode": "PSNR", "psnr": 60.0})
    assert psnr == pytest.approx(4 * 10 ** (-(60 + 10 * math.log10(1 - 2 / 3 * 0.99)) / 20))
    with pytest.raises(ValueError):
        errbound.abs_bound(x, {"mode": "NONE"})


def test_max_abs_error():
    x = torch.zeros(10, 7)
    d = x.clone()
    d[3, 4] = -0.25
    assert errbound.max_abs_error(x, d) == 0.25
    d[0, 0] = float("nan")
    assert errbound.max_abs_error(x, d) == math.inf
    with pytest.raises(ValueError):
        errbound.max_abs_error(x, torch.zeros(70))
    with pytest.raises(ValueError):
        errbound.max_abs_error(x, torch.zeros(10, 7, dtype=torch.float64))


def test_blocks_cover_the_whole_field(monkeypatch):
    monkeypatch.setattr(errbound, "BLOCK", 16)
    x = torch.zeros(100)
    d = x.clone()
    d[99] = 1.5
    assert errbound.max_abs_error(x, d) == 1.5


def test_import_check_compares_whole_top_level_names():
    assert imports.found(modules=["sz3_tpu_torch.api", "numpy", "jaxtyping"]) == []
    assert imports.found(modules=["sz3_tpu.api", "jaxlib.xla", "flax"]) == \
        ["flax", "jaxlib", "sz3_tpu"]


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_reference_imports_nothing_of_the_program():
    tops = _modules_after("import szbench.reference.errbound, szbench.reference.control")
    assert not tops & {"jax", "jaxlib", "flax", "sz3_tpu", "sz3_tpu_torch"}


def test_harness_and_port_import_no_jax():
    tops = _modules_after("import szbench.harness.cell, szbench.harness.trace\n"
                          "from szbench.harness import manifest, port\n"
                          "port.Port('cpu')\n"
                          "for n in ('nyx_like', 'wave_field'): manifest.generator(n)\n"
                          "for n in ('roundtrip', 'batch'): manifest.entry(n)")
    assert "sz3_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "sz3_tpu"}
