"""The port's customized demo (sz3_tpu_torch/examples/customized_demo.py)
against the JAX package, pattern for pattern, on the CPU with the same numpy
inputs: archives, bins, payloads and blobs byte-equal, decodes bit-equal.
The JAX side is replicated here from examples/customized_demo.py, whose
functions return nothing. Both run forms of the port's demo run from a clean
checkout (PYTHONPATH unset) and import neither jax nor the JAX package."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp

import sz3_tpu as szt
from sz3_tpu import runtime as jruntime
from sz3_tpu.config import ALGO as JALGO
from sz3_tpu.config import Config as JConfig
from sz3_tpu.config import INTERP_ALGO as JINTERP_ALGO
from sz3_tpu.encoders import truncate_compress as j_truncate_compress
from sz3_tpu.ops.quantize import quantize as j_quantize
from sz3_tpu.ops.quantize import recover as j_recover
from sz3_tpu_torch.examples import customized_demo as demo

ROOT = Path(__file__).resolve().parents[1]
EB, RADIUS = 1e-3, 32768


def _jax_seal(bins) -> bytes:
    return jruntime.zstd_compress(jruntime.huff_encode(np.asarray(bins).ravel()))


def test_make_data_is_the_jax_demos_field():
    g = np.meshgrid(*[np.linspace(0, 1, 64)] * 3, indexing="ij")
    want = (np.sin(6 * g[0]) + np.cos(9 * g[1]) * g[2]).astype(np.float32)
    assert demo.make_data().tobytes() == want.tobytes()


@pytest.mark.parametrize("backend", ["native", "jax"])
def test_pattern1_archive_equals_the_jax_packages(backend):
    blob, out = demo.pattern1_highlevel_api("cpu")
    data = demo.make_data()
    conf = JConfig(dims=data.shape, cmprAlgo=JALGO.INTERP, interpAlgo=JINTERP_ALGO.LINEAR,
                   absErrorBound=EB)
    want = szt.compress(data, conf, backend=backend)
    assert blob == want
    ref, used = szt.decompress(want, backend=backend)
    assert out.device.type == "cpu" and out.numpy().tobytes() == ref.tobytes()
    assert used.cmprAlgo == JALGO.INTERP


def test_pattern2_bins_payload_and_recovery_equal_the_jax_packages():
    bins, payload, out = demo.pattern2_assemble_modules("cpu")
    data = demo.make_data()
    jbins, _ = j_quantize(jnp.asarray(data), jnp.zeros_like(data), EB, RADIUS)
    jbins = np.asarray(jbins)
    assert bins.numpy().tobytes() == jbins.tobytes()
    jpayload = _jax_seal(jbins)
    assert payload == jpayload
    decoded = jruntime.huff_decode(jruntime.zstd_decompress(jpayload), data.size)
    jout = np.asarray(j_recover(jnp.zeros_like(data), jnp.asarray(decoded.reshape(data.shape)),
                                jnp.asarray(data), EB, RADIUS))
    assert out.numpy().tobytes() == jout.tobytes()
    assert int((jbins == 0).sum()) > 0        # the zero prediction leaves literals


def test_pattern3_bins_and_payload_equal_the_jax_toy_predictors():
    bins, payload = demo.pattern3_custom_decomposition("cpu")
    x = jnp.asarray(demo.make_data())
    pred = (jnp.pad(x, ((1, 0), (0, 0), (0, 0)))[:-1] +
            jnp.pad(x, ((0, 0), (1, 0), (0, 0)))[:, :-1]) * 0.5
    jbins, _ = j_quantize(x, pred.astype(x.dtype), EB, RADIUS)
    assert bins.numpy().tobytes() == np.asarray(jbins).tobytes()
    assert payload == _jax_seal(jbins)


def test_pattern4_blob_equals_the_jax_packages():
    blob, out = demo.pattern4_custom_compressor()
    data = demo.make_data()
    assert blob == j_truncate_compress(data, byte_len=2)
    assert out.shape == data.shape and out.dtype == np.float32
    # the top two bytes of each float32 kept: 7 mantissa bits
    assert np.abs(out - data).max() <= np.abs(data).max() * 2.0 ** -7


_IMPORTED = re.compile(r"^import time:\s+\d+ \|\s+\d+ \|\s*(\S+)\s*$", re.M)


@pytest.mark.parametrize("form", ["module", "path"])
def test_demo_runs_from_a_clean_checkout_without_jax(form, tmp_path):
    """`python -m sz3_tpu_torch.examples.customized_demo` from the repository
    root, and the script by its path from elsewhere, with PYTHONPATH unset:
    exit 0, the four lines, and (-X importtime) no jax or sz3_tpu module."""
    if form == "module":
        cmd, cwd = ["-m", "sz3_tpu_torch.examples.customized_demo"], ROOT
    else:
        cmd, cwd = [str(ROOT / "sz3_tpu_torch" / "examples" / "customized_demo.py")], tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "-X", "importtime", *cmd, "--device", "cpu"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "1. high-level API", "2. assembled modules", "3. custom decomposition",
        "4. custom compressor (truncate)"]
    modules = set(_IMPORTED.findall(proc.stderr))
    assert {"torch", "sz3_tpu_torch", "sz3_tpu_torch.ops.quantize"} <= modules
    leaked = sorted(m for m in modules if m in ("jax", "sz3_tpu")
                    or m.startswith(("jax.", "sz3_tpu.")))
    assert leaked == []


def test_demo_without_a_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        demo.main([])
